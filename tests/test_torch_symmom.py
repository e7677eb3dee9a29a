"""The port's SymMomOp (the BQP moment operator on the expanded basis,
kernels K9 / K10 through their plain twins on the CPU) against the JAX
package's on the same numpy inputs, at q = 4, 5 and 7: apply and adjoint
on every slot, adjointness, don't-care slots never read, the host build,
the duplicate-copy hooks, the JAX converter, and chip_smoke.py's copy of
the slot map that ties the flat layout to the reference's rows."""

import jax.numpy as jnp
import numpy as np
import pytest
import threadpoolctl
import torch

import chip_smoke
from manisdp_tpu.frontends.moments import bqpmom
from manisdp_tpu.ops import symmom as jsm
from manisdp_tpu_torch.convert import symmom_op_from_jax
from manisdp_tpu_torch.ops import symmom as tsm


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


QS = [4, 5, 7]
TOL = {np.float64: 1e-12, np.float32: 1e-5}


def _rel(got, ref):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    return np.max(np.abs(got - ref)) / max(np.max(np.abs(ref)), 1e-300)


def _bqp(q, seed=5):
    rng = np.random.default_rng(seed)
    Q = rng.standard_normal((q, q))
    return (Q + Q.T) / 2, rng.standard_normal(q)


@pytest.fixture(scope="module", params=QS)
def ops(request):
    q = request.param
    Q, e = _bqp(q)
    return q, jsm.SymMomOp.build_bqpmom(Q, e, q), \
        tsm.SymMomOp.build_bqpmom(Q, e, q, device="cpu")


@pytest.mark.parametrize("dt", [np.float64, np.float32])
def test_apply_matches_jax_on_every_slot(ops, dt):
    q, jop, top = ops
    M = np.random.default_rng(q).standard_normal((top.n, top.n)).astype(dt)
    got = top.apply_from_e(torch.as_tensor(M)).numpy()
    ref = np.asarray(jsm._apply_jit(jnp.asarray(M), q))
    assert got.dtype == dt and got.shape == (top.m,)
    assert _rel(got, ref) <= TOL[dt]
    dc = tsm.dontcare_mask(q)
    assert not np.any(got[dc]) and not np.any(ref[dc])


@pytest.mark.parametrize("dt", [np.float64, np.float32])
def test_adjoint_and_fused_base_match_jax(ops, dt):
    q, jop, top = ops
    rng = np.random.default_rng(q + 1)
    y = rng.standard_normal(top.m).astype(dt)
    got = top.adjoint_on_pattern(torch.as_tensor(y)).numpy()
    ref = np.asarray(jsm._adjoint_jit(jnp.asarray(y), q))
    assert got.dtype == dt and _rel(got, ref) <= TOL[dt]
    t32 = top.astype(torch.float32) if dt == np.float32 else top
    jC = np.asarray(jop.C).astype(dt)
    for sigma in (0.37, -1.0):
        fused = (t32.es_vals(torch.as_tensor(y), sigma) if sigma > 0 else
                 t32.s_vals(torch.as_tensor(y))).numpy()
        assert _rel(fused, jC + sigma * ref) <= TOL[dt]


def test_adjointness(ops):
    q, _, top = ops
    rng = np.random.default_rng(2 * q)
    M = torch.as_tensor(rng.standard_normal((top.n, top.n)))
    y = torch.as_tensor(rng.standard_normal(top.m))
    y = torch.where(torch.as_tensor(tsm.dontcare_mask(q)),
                    torch.zeros_like(y), y)
    lhs = float(torch.sum(top.adjoint_on_pattern(y) * M))
    rhs = float(torch.dot(y, top.apply_from_e(M)))
    assert abs(lhs - rhs) <= 1e-12 * max(abs(lhs), 1.0)


def test_dontcare_slots_are_never_read(ops):
    q, _, top = ops
    rng = np.random.default_rng(3 * q)
    y = torch.as_tensor(rng.standard_normal(top.m))
    dc = torch.as_tensor(tsm.dontcare_mask(q))
    garbage = torch.where(dc, 1e6 * torch.as_tensor(
        rng.standard_normal(top.m)), y)
    np.testing.assert_array_equal(
        top.adjoint_on_pattern(garbage).numpy(),
        top.adjoint_on_pattern(torch.where(dc, 0.0, y)).numpy())


def test_build_matches_jax(ops):
    q, jop, top = ops
    for k in ("C", "dup0", "dup1"):
        np.testing.assert_array_equal(getattr(top, k).numpy(),
                                      np.asarray(getattr(jop, k)))
    np.testing.assert_array_equal(top.b.numpy(), np.asarray(jop.b))
    for k in ("q", "m", "n", "m_true", "n_orig"):
        assert getattr(top, k) == getattr(jop, k)
    assert top.m == tsm.symmom_flat_length(q)
    conv = symmom_op_from_jax(
        {k: np.asarray(getattr(jop, k)) for k in
         ("C", "dup0", "dup1", "q", "m", "n", "m_true", "n_orig")}, "cpu")
    for k in ("C", "b", "dup0", "dup1"):
        np.testing.assert_array_equal(getattr(conv, k).numpy(),
                                      getattr(top, k).numpy())
    assert (conv.q, conv.m, conv.n_orig) == (top.q, top.m, top.n_orig)


def test_expanded_basis_hooks_match_jax(ops):
    q, jop, top = ops
    rng = np.random.default_rng(4 * q)
    Y = rng.standard_normal((5, top.n))
    for renorm in (True, False):
        np.testing.assert_allclose(
            top.symmetrize(torch.as_tensor(Y), renorm).numpy(),
            np.asarray(jop.symmetrize(jnp.asarray(Y), renorm)),
            rtol=1e-13, atol=1e-15)
    M = rng.standard_normal((top.n, top.n))
    np.testing.assert_array_equal(top.compress(torch.as_tensor(M)).numpy(),
                                  np.asarray(jop.compress(jnp.asarray(M))))
    np.testing.assert_array_equal(
        top.compress_coef(torch.as_tensor(M)).numpy(),
        np.asarray(jop.compress_coef(jnp.asarray(M))))
    V = rng.standard_normal((top.n_orig, 3))
    np.testing.assert_array_equal(top.lift_vecs(torch.as_tensor(V)).numpy(),
                                  jop.lift_vecs(V))


@pytest.mark.parametrize("q", [4, 6, 9])
def test_chip_smoke_slot_map_ties_the_rows_to_bqpmom(q):
    """chip_smoke.py's slot map (built without the monomial-basis loop)
    equals tests/test_symmom.py's, and through it the port's apply gives
    the reference's rows A(X) of frontends/moments.bqpmom on a duplicated
    X."""
    from test_symmom import _expand_values, _flat_slot_map
    smap = chip_smoke.flat_slot_map(q)
    np.testing.assert_array_equal(smap, _flat_slot_map(q))
    Q, e = _bqp(q, seed=9)
    data = bqpmom(q, Q, e)
    top = tsm.SymMomOp.build_bqpmom(Q, e, q, device="cpu")
    rng = np.random.default_rng(q)
    Xo = rng.standard_normal((top.n_orig, top.n_orig))
    Xo = Xo + Xo.T
    rows = data.At.T @ Xo.flatten(order="F")
    got = top.apply_from_e(torch.as_tensor(
        _expand_values(Xo, top))).numpy()
    np.testing.assert_allclose(got[smap], rows, rtol=1e-12, atol=1e-12)
    np.testing.assert_array_equal(data.b, top.b.numpy()[smap])


def _k10_t_block(y, q):
    """K10's decomposition of the T block (csrc/symmom_adjoint.cu) as plain
    tensor ops: every read of y a select on its family's mask, the E6 reads
    in the last-axis-preserving forms, V = wT + wT[b, a], the workspace
    rows W[ab] = (V + V^T over (c, d)) / 4, stored for a < b, and W[aa] =
    wHs[a] plus the wG and wD diagonals, then (W + W^T) / 2 over the
    q^2 x q^2 block."""
    q2, q3 = q * q, q ** 3
    offs = np.cumsum([1, q, q2, q2, q3, q2, q3])
    a = torch.arange(q)
    i2, j2 = a[:, None], a[None, :]
    i3, j3, k3 = a[:, None, None], a[None, :, None], a[None, None, :]
    i4, j4, k4, l4 = (a[:, None, None, None], a[None, :, None, None],
                      a[None, None, :, None], a[None, None, None, :])
    zero = torch.zeros((), dtype=y.dtype)
    D1 = y[1:1 + q]
    D2 = torch.where(i2 != j2, y[offs[1]:offs[2]].reshape(q, q), zero)
    Sv = torch.where(i2 != j2, y[offs[2]:offs[3]].reshape(q, q), zero)
    Sp = torch.where((j3 < k3) & (i3 != j3) & (i3 != k3),
                     y[offs[3]:offs[4]].reshape(q, q, q), zero)
    E2 = torch.where(i2 < j2, y[offs[4]:offs[5]].reshape(q, q), zero)
    E4 = torch.where((i3 != j3) & (k3 > i3) & (k3 > j3),
                     y[offs[5]:offs[6]].reshape(q, q, q), zero)
    y6 = y[offs[6]:].reshape(q, q, q, q)
    y6a = torch.where((i4 < j4) & (j4 < k4) & (k4 < l4), y6, zero)
    y6b = torch.where((j4 < i4) & (i4 < k4) & (k4 < l4), y6, zero)
    eye = (i2 == j2).to(y.dtype)
    dik = eye[:, None, :, None]
    wT = (-0.5 * D2[:, :, None, None] * dik * eye[None, :, None, :]
          + 2.0 * Sp[:, :, None, :] * dik
          + torch.einsum("cabd->abcd", y6a - y6b) - y6a
          + torch.einsum("acbd->abcd", y6b))
    wT = torch.where((i4 != j4) & (k4 != l4), wT, zero)
    V = wT + wT.transpose(0, 1)
    W = 0.25 * (V + V.transpose(2, 3))
    wH = torch.where(j3 != k3, 2.0 * Sv[:, None, :] * eye[:, :, None]
                     + E4.permute(2, 0, 1) - E4, zero)
    wG = torch.where(i2 != j2, E2 - Sp.sum(0), zero)
    wD = -0.5 * D1 + 0.5 * D2.sum(1)
    Wd = (0.25 * (wH + wH.transpose(1, 2))
          + 0.25 * torch.diag_embed(wG) + 0.25 * torch.diag_embed(
              torch.diag_embed(wD)))
    W = W + eye[:, :, None, None] * Wd[:, None, :, :]
    # the workspace keeps the rows (a, b), a <= b: (b, a) reads as (a, b)
    ii, jj = np.divmod(np.arange(q2), q)
    Wm = W.reshape(q2, q2)[torch.as_tensor(np.minimum(ii, jj) * q +
                                           np.maximum(ii, jj))]
    return 0.5 * (Wm + Wm.T)


@pytest.mark.parametrize("q", [5, 8])
def test_k10_decomposition_matches_jax(q):
    """The index algebra K10 relies on, against the JAX _adjoint_jit's T
    block, with NaN in every don't-care slot of y (the selects keep it
    out)."""
    m = 1 + q + 3 * q * q + 2 * q ** 3 + q ** 4
    y = np.random.default_rng(17 + q).standard_normal(m)
    dc = tsm.dontcare_mask(q)
    dirty = np.where(dc, np.nan, y)
    o = 2 + q
    got = _k10_t_block(torch.as_tensor(dirty), q).numpy()
    ref = np.asarray(jsm._adjoint_jit(jnp.asarray(np.where(dc, 0.0, y)),
                                      q))[o:, o:]
    assert not np.any(np.isnan(got))
    assert _rel(got, ref) <= 1e-12


def _pidx(a, b, q):
    """K9's row-major number of the unordered pair a < b."""
    return a * (2 * q - a - 1) // 2 + (b - a - 1)


def _k9_rows(M, q):
    """K9's decomposition (csrc/symmom_apply.cu) as plain tensor ops: the
    border rows of Ms (rows 0 .. o - 1 and the diagonal-pair rows), V over
    the unordered pairs from rows ab + ba of the T block and the (c, d)
    swap, cT = (V + V^T) / 8 kept once per unordered pair of pairs (at
    (R, C) when R comes first in (max, min) order; the other half NaN),
    then every family read through those arrays only, EQ6 at (pi(x, y),
    pi(z, l))."""
    o, n = 2 + q, 2 + q + q * q
    P = q * (q - 1) // 2
    u = np.concatenate([np.arange(o), o + np.arange(q) * (q + 1)])
    Bs = 0.5 * (M[u, :] + M[:, u].T)
    pa, pb = (torch.as_tensor(x) for x in np.triu_indices(q, 1))
    Z = (M[o + pa * q + pb, o:] + M[o + pb * q + pa, o:]).reshape(P, q, q)
    V = Z[:, pa, pb] + Z[:, pb, pa]
    key = pb * q + pa
    ct = torch.where(key[:, None] <= key[None, :], 0.125 * (V + V.T),
                     torch.full_like(V, float("nan")))

    def cT(a, b, c, d):
        a0, b0 = np.minimum(a, b), np.maximum(a, b)
        c0, d0 = np.minimum(c, d), np.maximum(c, d)
        R, C = _pidx(a0, b0, q), _pidx(c0, d0, q)
        swap = b0 * q + a0 > d0 * q + c0
        return ct[np.where(swap, C, R), np.where(swap, R, C)]

    G = lambda a, b: Bs[2 + a, 2 + b]                        # noqa: E731
    H = lambda a, i, j: Bs[2 + a, o + i * q + j]             # noqa: E731
    T4 = lambda a, c, d: Bs[o + a, o + c * q + d]            # noqa: E731
    E = lambda s, i, j: Bs[s, o + i * q + j]                 # noqa: E731
    c00 = 0.25 * (Bs[0, 0] + Bs[0, 1] + Bs[1, 0] + Bs[1, 1])
    cA = lambda a: 0.25 * (Bs[0, 2 + a] + Bs[1, 2 + a]       # noqa: E731
                           + E(0, a, a) + E(1, a, a))
    cD = lambda a: 0.25 * (G(a, a) + 2.0 * H(a, a, a)        # noqa: E731
                           + T4(a, a, a))
    cG = lambda a, b: 0.25 * (G(a, b) + H(a, b, b)           # noqa: E731
                              + H(b, a, a) + T4(a, b, b))
    cP0 = lambda a, b: 0.25 * (E(0, a, b) + E(0, b, a)       # noqa: E731
                               + E(1, a, b) + E(1, b, a))
    cH = lambda a, b, c: 0.25 * (H(a, b, c) + H(a, c, b)     # noqa: E731
                                 + T4(a, b, c) + T4(a, c, b))

    def family(shape, valid, fn):
        idx = np.indices(shape).reshape(len(shape), -1)
        ok = valid(*idx)
        out = torch.zeros(idx.shape[1], dtype=M.dtype)
        out[torch.as_tensor(ok)] = fn(*idx[:, ok])
        return out

    a = np.arange(q)
    D1 = 0.5 * c00 - 0.5 * cD(a)
    D2 = family((q, q), lambda a, b: a != b,
                lambda a, b: 0.5 * cD(a) - 0.5 * cT(a, b, a, b))
    SUBv = family((q, q), lambda k, b: k != b,
                  lambda k, b: 2.0 * cH(k, k, b) - 2.0 * cA(b))
    SUBp = family((q, q, q), lambda k, b, c: (b < c) & (k != b) & (k != c),
                  lambda k, b, c: 2.0 * cT(k, b, k, c)
                  - (cP0(b, c) + cG(b, c)))
    EQ2 = family((q, q), lambda a, b: a < b,
                 lambda a, b: cG(a, b) - cP0(a, b))
    EQ4 = family((q, q, q), lambda i, j, k: (i != j) & (k > i) & (k > j),
                 lambda i, j, k: cH(k, i, j) - cH(i, j, k))

    def eq6(i, j, k, m):
        one = i < j
        w1 = ct[_pidx(j, k, q), _pidx(i, m, q)]
        other = ct[np.where(one, _pidx(i, j, q), _pidx(i, k, q)),
                   np.where(one, _pidx(k, m, q), _pidx(j, m, q))]
        return torch.where(torch.as_tensor(one), w1 - other, other - w1)

    EQ6 = family((q,) * 4, lambda i, j, k, m: (((i < j) & (j < k)) |
                                               ((j < i) & (i < k))) & (k < m),
                 eq6)
    return torch.cat([c00.reshape(1), D1, D2, SUBv, SUBp, EQ2, EQ4, EQ6])


@pytest.mark.parametrize("q", [4, 5, 8])
def test_k9_decomposition_matches_jax(q):
    """The staging K9 relies on (border copy, V / (V + V^T) / 8 over the
    unordered pairs, cT stored once per unordered pair of pairs), on a
    non-symmetric M, against the JAX _apply_jit on every slot; no read
    lands in the unstored half, every don't-care slot is 0."""
    n = 2 + q + q * q
    M = np.random.default_rng(29 + q).standard_normal((n, n))
    got = _k9_rows(torch.as_tensor(M), q).numpy()
    ref = np.asarray(jsm._apply_jit(jnp.asarray(M), q))
    assert got.shape == ref.shape and not np.any(np.isnan(got))
    assert _rel(got, ref) <= 1e-12
    assert not np.any(got[tsm.dontcare_mask(q)])


def test_k9_workspace_size():
    """K9's workspace (P^2 + (2 + 2q) n~ entries) at the sizes its source
    note states: q = 60 and q = 100."""
    from manisdp_tpu_torch import kernels as K
    assert K.symmom_apply_workspace(60) == 1770 ** 2 + 122 * 3662
    assert K.symmom_apply_workspace(100) == 4950 ** 2 + 202 * 10102
    assert K.symmom_apply_workspace(60) < 60 ** 4 // 3
