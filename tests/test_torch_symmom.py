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
