"""The port's SymDualOp (the gather-free SOS-dual tensor operator, kernels
K7 / K8 through their plain twins on the CPU) against the JAX package's
on the same numpy inputs, at q = 5 and q = 7: the built fields, apply
outside the don't-care slots (0 inside), adjoint, the fused scaled and
residual adjoints, y_step, scale_idAAt, dot_b, the duplicate-copy
projections, compress and lift_vecs; and both packages' SymDualOp against
the expanded sparse route (bqpsos_expanded_sparse through DualOp), as
tests/test_symdual.py anchors the JAX one."""

import jax.numpy as jnp
import numpy as np
import pytest
import threadpoolctl
import torch

from manisdp_tpu.ops import symdual as jsd
from manisdp_tpu.ops.dualops import DualOp as JDualOp
from manisdp_tpu_torch.convert import symdual_op_from_jax
from manisdp_tpu_torch.ops import symdual as tsd
from manisdp_tpu_torch.ops.dualops import DualOp


@pytest.fixture(autouse=True, scope="module")
def _one_cpu_thread():
    """Torch and BLAS on one thread for this module: the parallel test run
    puts several workers on the CPU, and their thread pools then
    oversubscribe it, so the solvers' many small ops and LAPACK calls spin
    (a 1 s multiblock solve took minutes)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpoolctl.threadpool_limits(1):
        yield
    torch.set_num_threads(n)


QS = [5, 7]


def _rel(got, ref):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    return np.max(np.abs(got - ref)) / max(np.max(np.abs(ref)), 1e-300)


def _bqp(q, seed=7):
    rng = np.random.default_rng(seed)
    Q = rng.standard_normal((q, q))
    return (Q + Q.T) / 2, rng.standard_normal(q)


@pytest.fixture(scope="module", params=QS)
def ops(request):
    q = request.param
    Q, e = _bqp(q)
    return q, jsd.SymDualOp.build_bqpsos(Q, e, q), \
        tsd.SymDualOp.build_bqpsos(Q, e, q, device="cpu")


def test_build_fields_match_jax(ops):
    q, jop, top = ops
    for k in ("b", "cf", "C", "idAAt", "bA", "Ac", "dup0", "dup1"):
        np.testing.assert_array_equal(getattr(top, k).numpy(),
                                      np.asarray(getattr(jop, k)))
    for k in ("q", "m", "n", "f", "m_true", "n_orig"):
        assert getattr(top, k) == getattr(jop, k)
    conv = symdual_op_from_jax(
        {k: np.asarray(getattr(jop, k)) for k in
         ("b", "cf", "C", "idAAt", "bA", "Ac", "dup0", "dup1", "q", "m",
          "n", "f", "m_true", "n_orig")}, "cpu")
    np.testing.assert_array_equal(conv.bA.numpy(), top.bA.numpy())


def test_apply_matches_jax_outside_the_dontcare_slots(ops):
    q, jop, top = ops
    M = np.random.default_rng(3).standard_normal((top.n, top.n))
    dc = tsd._dontcare_mask(q)
    np.testing.assert_array_equal(dc, jsd._dontcare_mask(q))
    for dt, tol in ((np.float64, 1e-12), (np.float32, 1e-5)):
        got = top.astype(getattr(torch, dt.__name__)).apply_flat(
            torch.as_tensor(M.astype(dt))).numpy()
        ref = np.asarray(jop.apply_flat(jnp.asarray(M.astype(dt))))
        assert got.dtype == dt
        assert _rel(got[~dc], ref[~dc]) <= tol
        assert not np.any(got[dc])


def test_adjoint_family_and_y_step_match_jax(ops):
    q, jop, top = ops
    rng = np.random.default_rng(4)
    n = top.n
    y = rng.standard_normal(top.m)
    S, Xm = rng.standard_normal((n, n)), rng.standard_normal((n, n))
    sigma = 0.37
    jy = jop._tup(jnp.asarray(y))
    ty = top._tup(torch.as_tensor(y))
    assert _rel(top.adjoint(ty).numpy(), jop.adjoint(jy)) <= 1e-12
    assert _rel(top.adjoint_scaled(ty).numpy(),
                jop.adjoint(jop.scale_idAAt(jy))) <= 1e-12
    ref = jop.adjoint(jy) - (jnp.asarray(S) - jop.C) - jnp.asarray(Xm) / sigma
    got = top.residual(ty, torch.as_tensor(S), torch.as_tensor(Xm), sigma)
    assert _rel(got.numpy(), ref) <= 1e-12
    assert _rel(top.residual(ty, torch.as_tensor(S)).numpy(),
                jop.adjoint(jy) - (jnp.asarray(S) - jop.C)) <= 1e-12
    for a, b in zip(top.scale_idAAt(ty), jop.scale_idAAt(jy)):
        assert _rel(a.numpy(), b) <= 1e-15
    assert float(top.dot_b(ty)) == pytest.approx(float(jop.dot_b(jy)),
                                                 rel=1e-12)
    dc = tsd._dontcare_mask(q)
    got = top.flatten_y(top.y_step(torch.as_tensor(S + S.T))).numpy()
    ref = np.asarray(jop.flatten_y(jop.y_step(jnp.asarray(S + S.T))))
    assert _rel(got[~dc], ref[~dc]) <= 1e-12


def test_projections_compress_and_lift_match_jax(ops):
    q, jop, top = ops
    rng = np.random.default_rng(5)
    n = top.n
    Y = rng.standard_normal((6, n))
    Y[4:] = 0.0                                  # padding rows stay 0
    for renorm in (True, False):
        got = top.symmetrize(torch.as_tensor(Y), renorm).numpy()
        assert _rel(got[:4], jop.symmetrize(jnp.asarray(Y), renorm)[:4]) \
            <= 1e-14
        assert not np.any(got[4:])
    M = rng.standard_normal((n, n))
    assert _rel(top.symmetrize_mat(torch.as_tensor(M)).numpy(),
                jop.symmetrize_mat(jnp.asarray(M))) <= 1e-15
    assert _rel(top.compress(torch.as_tensor(M)).numpy(),
                jop.compress(jnp.asarray(M))) == 0.0
    V = rng.standard_normal((top.n_orig, 3))
    np.testing.assert_array_equal(top.lift_vecs(V), jop.lift_vecs(V))


@pytest.mark.parametrize("q", QS)
def test_apply_adjoint_match_the_expanded_sparse_route(q):
    """Both packages' expanded sparse data are equal, and the port's
    SymDualOp reproduces the port's DualOp on them (class rows mapped to
    canonical flat slots as tests/test_symdual.py does)."""
    from test_symdual import _canon_slots, _row_of_mask
    Q, e = _bqp(q)
    t_data = tsd.bqpsos_expanded_sparse(Q, e, q)
    j_data = jsd.bqpsos_expanded_sparse(Q, e, q)
    assert abs(t_data[0] - j_data[0]).max() == 0
    for a, b in zip(t_data[1:], j_data[1:]):
        np.testing.assert_array_equal(a, b)
    A_full, b, c, nn, f, dAAt = t_data
    sop = DualOp.build(A_full, b, c, nn, f, dAAt, device="cpu")
    top = tsd.SymDualOp.build_bqpsos(Q, e, q, device="cpu")
    rng = np.random.default_rng(3)
    M = torch.as_tensor(rng.standard_normal((nn, nn)))
    slots, masks = _canon_slots(q)
    rows = _row_of_mask(q)(masks)
    assert _rel(top.apply_flat(M).numpy()[slots],
                sop.apply(M).numpy()[rows]) <= 1e-12
    # adjoint: the flat y holds each slot's class value, poison at the
    # don't-care slots (never read)
    yclass = rng.standard_normal(len(dAAt))
    ref = np.asarray(JDualOp.build(A_full, b, c, nn, f, dAAt).adjoint(
        jnp.asarray(yclass)))
    got = sop.adjoint(torch.as_tensor(yclass)).numpy()
    assert _rel(got, ref) <= 1e-12
    yflat = yclass[_row_of_mask(q)(_flat_masks(q))]
    yflat[tsd._dontcare_mask(q)] = 1e9
    assert _rel(top.adjoint(torch.as_tensor(yflat)).numpy(), got) <= 1e-12


def _flat_masks(q):
    """Monomial bitmask of every slot of the flat per-degree layout."""
    a = [np.arange(q, dtype=np.uint64)]
    bit = lambda g: np.uint64(1) << g  # noqa: E731
    parts = [np.zeros(1, dtype=np.uint64), bit(a[0])]
    for d in (2, 3, 4):
        grids = np.meshgrid(*(a * d), indexing="ij")
        m = bit(grids[0])
        for g in grids[1:]:
            m = m ^ bit(g)
        parts.append(m.reshape(-1))
    return np.concatenate(parts)


def test_limits_raise():
    with pytest.raises(ValueError, match="int32"):
        tsd.SymDualOp.build_bqpsos(np.zeros((216, 216)), np.zeros(216), 216,
                                   device="cpu")


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    with pytest.raises(RuntimeError, match="CUDA"):
        tsd.SymDualOp.build_bqpsos(*_bqp(3), 3)


def _k7_split(M, q):
    """K7's decomposition (csrc/symdual_apply.cu) as plain tensor ops: P2
    from row-pair sums S and the (k, l) swap, stored for the pairs i < j,
    P3 = P2 + P2^T, then Y4 from three reads of P3 along l, Y2 from
    P3[a, c, c, b], Y3 from S3 and y0 from per-row partial sums;
    repeated-index slots 0 (selected, so the unwritten rows' NaN stays
    out)."""
    o, q2 = 2 + q, q * q
    A = M[o:, o:].reshape(q, q, q, q)
    S = A + A.transpose(0, 1)                             # rows r + r~
    P2 = (S + S.transpose(2, 3)).reshape(q2, q2)          # the (k, l) swap
    # the workspace keeps P2's rows (i, j), i < j, only: the rows (i, i)
    # are never written (NaN here), the rows (j, i) read as (i, j)
    ii, jj = np.divmod(np.arange(q2), q)
    P2 = P2[torch.as_tensor(np.minimum(ii, jj) * q + np.maximum(ii, jj))]
    P2[torch.as_tensor(ii == jj)] = float("nan")
    P3 = (P2 + P2.T).reshape(q, q, q, q)
    Y4 = (P3 + P3.permute(0, 2, 1, 3)                     # P3[i, k, j, l]
          + torch.einsum("jkil->ijkl", P3))               # P3[j, k, i, l]
    H = M[2:o, o:].reshape(q, q, q)
    Kb = M[o:, 2:o].reshape(q, q, q)
    Td = torch.einsum("eefg->efg", A)                     # T[e, e, f, g]
    Tc = torch.einsum("fgee->efg", A)                     # T[f, g, e, e]
    hk = H + Td + Kb.permute(2, 0, 1) + Tc                # hk[e, f, g]
    S3 = hk + hk.transpose(1, 2)
    Y3 = S3 + S3.transpose(0, 1) + S3.permute(1, 2, 0)       # S3[c, a, b]
    E = M[:2, o:].reshape(2, q, q)
    F = M[o:, :2].reshape(q, q, 2)
    G = M[2:o, 2:o]
    eye = torch.eye(q, dtype=torch.bool)
    a = torch.arange(q)
    cs = torch.einsum("acbc->acb", P3.permute(0, 1, 3, 2))  # P3[a,c,c,b]
    cs = torch.where((a[:, None, None] != a[None, :, None]) &
                     (a[None, :, None] != a[None, None, :]), cs, 0.0)
    Y2 = (cs.sum(1) + G + G.T + E.sum(0) + E.sum(0).T + F.sum(2)
          + F.sum(2).T + torch.einsum("abb->ab", H)
          + torch.einsum("baa->ab", H) + torch.einsum("bba->ab", Kb)
          + torch.einsum("aab->ab", Kb) + torch.einsum("aabb->ab", A)
          + torch.einsum("bbaa->ab", A))
    part = torch.where(eye, torch.diagonal(G)[:, None]
                       + torch.einsum("iii->i", H)[:, None]
                       + torch.einsum("iii->i", Kb)[:, None]
                       + torch.einsum("iiii->i", A)[:, None],
                       torch.einsum("ijij->ij", A)
                       + torch.einsum("ijji->ij", A)).sum(1)
    y0 = part.sum() + M[:2, :2].sum()
    Hn = torch.where(~eye[None], H, 0.0)
    Kn = torch.where(~eye[:, :, None], Kb, 0.0)
    y1 = (M[:2, 2:o].sum(0) + M[2:o, :2].sum(1)
          + torch.einsum("sii->i", E) + torch.einsum("iis->i", F)
          + torch.einsum("iia->a", Hn) + torch.einsum("jaj->a", Hn)
          + torch.einsum("iai->a", Kn) + torch.einsum("ajj->a", Kn)
          + torch.einsum("ccca->a", A) + torch.einsum("ccac->a", A)
          + torch.einsum("cacc->a", A) + torch.einsum("accc->a", A)
          - 4.0 * torch.einsum("aaaa->a", A))
    return tsd.zero_dontcare((y0, y1, Y2, Y3, Y4), q)


@pytest.mark.parametrize("q", [5, 8])
def test_k7_decomposition_matches_jax(q):
    """The index algebra K7 relies on, against the JAX _apply_tensor on a
    non-symmetric M, outside the don't-care slots (0 inside)."""
    n = 2 + q + q * q
    M = np.random.default_rng(11 + q).standard_normal((n, n))
    got = tsd._flatten(*_k7_split(torch.as_tensor(M), q)).numpy()
    ref = np.asarray(jsd._flatten(*jsd._apply_tensor(jnp.asarray(M), q)))
    dc = tsd._dontcare_mask(q)
    assert not np.any(got[dc])
    assert _rel(got[~dc], ref[~dc]) <= 1e-12
