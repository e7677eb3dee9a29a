"""The port's multiblock drivers against the JAX package's on the same
numpy inputs: MaskedProduct (kernel K2's masked mode through its plain
twin) and the masked Hessian epilogue, ConstraintOp.build_multiblock,
solve_multiblock and solve_dual_multiblock on the JAX tests' instances,
and solve_sedumi on data with an LP cone or two PSD blocks."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import threadpoolctl
import torch

from manisdp_tpu import solve_sedumi as jax_solve_sedumi
from manisdp_tpu.frontends.moments import bqpmom
from manisdp_tpu.frontends.sos import assemble_bqpsos
from manisdp_tpu.frontends.sparse_moments import (qsmom_sparse, qssos_sparse,
                                                  sparse_quartic_basis)
from manisdp_tpu.manifolds.product import MaskedProduct as JMasked
from manisdp_tpu.ops.sparse import ConstraintOp as JOp
from manisdp_tpu.solvers.dual_multiblock import \
    solve_dual_multiblock as jax_dual_multiblock
from manisdp_tpu.solvers.multiblock import solve_multiblock as jax_multiblock
from manisdp_tpu_torch import kernels as K
from manisdp_tpu_torch import solve_sedumi
from manisdp_tpu_torch.frontends.sedumi import Cone, SedumiData
from manisdp_tpu_torch.manifolds.product import MaskedProduct
from manisdp_tpu_torch.ops.sparse import ConstraintOp
from manisdp_tpu_torch.solvers.dual_multiblock import solve_dual_multiblock
from manisdp_tpu_torch.solvers.multiblock import solve_multiblock


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


TOL = {torch.float64: 1e-12, torch.float32: 1e-5}
ARRAYS = ("k", "i", "j", "v", "a2p", "b", "kp", "vp", "a2p_sorted")


def _rel(got, ref):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    return np.max(np.abs(got - ref)) / max(np.max(np.abs(ref)), 1e-300)


def _agree(tr, jr, tol=1e-6):
    assert jr.status == 0 and tr.status == 0
    assert tr.eta <= 1e-8
    assert abs(tr.obj - jr.obj) <= tol * max(1.0, abs(jr.obj))


# ------------------------------------------------------------ geometry --

@pytest.fixture(scope="module")
def masked():
    rng = np.random.default_rng(7)
    p, n = 6, 40
    mask = (rng.random(n) < 0.5).astype(np.float64)
    Y, U, V = (rng.standard_normal((p, n)) for _ in range(3))
    return mask, Y, U, V, rng.standard_normal(n)


@pytest.mark.parametrize("dt", [torch.float64, torch.float32])
def test_masked_product_matches_jax(masked, dt):
    mask, Y, U, _, _ = masked
    jm = JMasked(mask)
    tm = MaskedProduct(mask, "cpu")
    t = lambda a: torch.as_tensor(a).to(dt)  # noqa: E731
    j = lambda a: jnp.asarray(a, dtype=jnp.float64 if dt == torch.float64  # noqa: E731
                              else jnp.float32)
    for name, got, ref in (
            ("proj", tm.proj(t(Y), t(U)), jm.proj(j(Y), j(U))),
            ("tangent", tm.tangent(t(Y), t(U)), jm.tangent(j(Y), j(U))),
            ("transp", tm.transp(None, t(Y), t(U)),
             jm.transp(None, j(Y), j(U))),
            ("retr", tm.retr(t(Y), t(U)), jm.retr(j(Y), j(U))),
            ("renormalize", tm.renormalize(t(Y)), jm.renormalize(j(Y)))):
        assert got.dtype == dt, name
        assert _rel(got.numpy(), np.asarray(ref)) <= TOL[dt], name
    ns, ps = [5, 7, 9, 19], [1, 3, 2, 4]
    assert tm.typicaldist(ns, ps, 2) == JMasked.typicaldist(ns, ps, 2)


@pytest.mark.parametrize("dt", [torch.float64, torch.float32])
def test_k2_masked_twin_is_the_masked_hessian_epilogue(masked, dt):
    """proj with the eG term and the mask is multiblock.py:59-63's
    eH - Y o (colsum(Y o eH) o mask) - U o YeG; columns with mask 0 keep
    eH - U o YeG in proj and are left unnormalized in retr."""
    mask, Y, H, U, g = masked
    ref = H - Y * (np.sum(Y * H, axis=0) * mask)[None, :] - U * g[None, :]
    t = lambda a: torch.as_tensor(a).to(dt)  # noqa: E731
    got = K.oblique_cols(t(Y), t(H), "proj", v=t(U), g=t(g), mask=t(mask))
    assert _rel(got.numpy(), ref) <= TOL[dt]
    off = mask == 0
    np.testing.assert_array_equal(
        K.oblique_cols(t(Y), t(H), "proj", mask=t(mask))[:, off].numpy(),
        t(H)[:, off].numpy())
    np.testing.assert_array_equal(
        K.oblique_cols(t(Y), None, "renormalize", mask=t(mask))[:, off]
        .numpy(), t(Y)[:, off].numpy())


def test_k2_all_ones_mask_is_the_oblique_mode(masked):
    _, Y, H, U, g = masked
    t = torch.as_tensor
    ones = torch.ones(Y.shape[1], dtype=torch.float64)
    for mode, u, kw in (("proj", t(H), {}), ("proj", t(H), dict(v=t(U),
                                                                g=t(g))),
                        ("retr", t(H), {}), ("renormalize", None, {})):
        torch.testing.assert_close(
            K.oblique_cols(t(Y), u, mode, mask=ones, **kw),
            K.oblique_cols(t(Y), u, mode, **kw), rtol=0, atol=0)


# ------------------------------------------------------------ operator --

def _two_bqp_blocks():
    """test_multiblock.py::test_two_oblique_blocks's data."""
    n1, n2 = 5, 4
    rs = np.random.RandomState(0)
    Q1 = rs.randn(n1, n1)
    Q1 = 0.5 * (Q1 + Q1.T)
    e1 = rs.randn(n1)
    Q2 = rs.randn(n2, n2)
    Q2 = 0.5 * (Q2 + Q2.T)
    e2 = rs.randn(n2)
    d1, d2 = bqpmom(n1, Q1, e1), bqpmom(n2, Q2, e2)
    At = sp.block_diag([d1.At, d2.At]).tocsc()
    return (At, np.concatenate([d1.b, d2.b]), np.concatenate([d1.c, d2.c]),
            [d1.K.s, d2.K.s])


def _quartic():
    N, cliques = 7, [[0, 1, 2, 3], [3, 4, 5, 6]]
    coe = np.random.RandomState(0).randn(
        sparse_quartic_basis(N, cliques).shape[1])
    return N, cliques, coe


@pytest.mark.parametrize("which", ["two_bqp_blocks", "quartic"])
def test_build_multiblock_matches_jax(which):
    if which == "quartic":
        data = qsmom_sparse(*_quartic())
        At, b, c, ns = data.At, data.b, data.c, list(data.K.s)
    else:
        At, b, c, ns = _two_bqp_blocks()
    jop = JOp.build_multiblock(At, b, c, ns)
    top = ConstraintOp.build_multiblock(At, b, c, ns, "cpu")
    assert (top.m, top.n) == (jop.m, jop.n) == (len(b), sum(ns))
    for f in ARRAYS:
        np.testing.assert_array_equal(getattr(top, f).numpy(),
                                      np.asarray(getattr(jop, f)))
    for f in ("i", "j", "v"):
        np.testing.assert_array_equal(getattr(top.pat, f).numpy(),
                                      np.asarray(getattr(jop.pat, f)))


# -------------------------------------------------------------- solves --

def test_two_oblique_blocks_match_jax():
    At, b, c, ns = _two_bqp_blocks()
    kw = dict(verbose=False, sigma0=1e-3, sigma_min=1e-2, tau1=1, tau2=1)
    jr = jax_multiblock(At, b, c, ns=ns, nob=2, **kw)
    tr = solve_multiblock(At, b, c, ns=ns, nob=2, device="cpu", **kw)
    _agree(tr, jr)
    assert len(tr.X) == 2 and [x.shape[0] for x in tr.X] == ns


QUARTIC_PRIMAL_KW = dict(verbose=False, theta=1e-2, tau1=0.02, tau2=0.1,
                         sigma0=1e-2, sigma_min=1e-1, line_search=True,
                         max_outer=1000)


@pytest.fixture(scope="module")
def quartic_primal():
    data = qsmom_sparse(*_quartic())
    return (jax_multiblock(data.At, data.b, data.c, ns=data.K.s, nob=0,
                           **QUARTIC_PRIMAL_KW),
            solve_multiblock(data.At, data.b, data.c, ns=data.K.s, nob=0,
                             device="cpu", **QUARTIC_PRIMAL_KW))


def test_sparse_quartic_primal_matches_jax(quartic_primal):
    _agree(quartic_primal[1], quartic_primal[0])


def test_single_block_dual_matches_jax():
    """test_dual_multiblock.py::test_single_block_matches_dual_unitdiag."""
    rs = np.random.RandomState(0)
    Q = rs.randn(6, 6)
    Q = 0.5 * (Q + Q.T)
    A, b, c, mb, f, dAAt = assemble_bqpsos(Q, rs.randn(6), 6)
    maxb = np.max(np.abs(b))
    kw = dict(verbose=False, sigma0=1e-3, sigma_min=1e-3, tau1=1e1,
              tau2=1e2, theta=1e-3, alpha=0.1)
    jr = jax_dual_multiblock(A, b / maxb, c, ns=[mb], nob=1, f=f, dAAt=dAAt,
                             **kw)
    tr = solve_dual_multiblock(A, b / maxb, c, ns=[mb], nob=1, f=f,
                               dAAt=dAAt, device="cpu", **kw)
    _agree(tr, jr)


def test_sparse_quartic_dual_matches_jax_and_the_primal(quartic_primal):
    A, b, c, mbs, f, dAAt = qssos_sparse(*_quartic())
    maxb = np.max(np.abs(b))
    kw = dict(verbose=False, gama=2.0, alpha=0.01, sigma0=1e-2, theta=1e-2,
              delta=6, max_outer=1000)
    jr = jax_dual_multiblock(A, b / maxb, c, ns=mbs, nob=0, f=f, dAAt=dAAt,
                             **kw)
    tr = solve_dual_multiblock(A, b / maxb, c, ns=mbs, nob=0, f=f,
                               dAAt=dAAt, device="cpu", **kw)
    _agree(tr, jr)
    rp = quartic_primal[1]
    assert abs(tr.obj * maxb - rp.obj) <= 1e-6 * max(1.0, abs(rp.obj))


def _lp_and_psd():
    """min x1 + 2 x2 + <C, X> s.t. diag(X) = 1, x1 + x2 = 1 and
    x2 - X_01 = 0.2 (one row couples the cones): K.l = 2, K.s = [4]."""
    n = 4
    rs = np.random.RandomState(3)
    C = rs.randn(n, n)
    C = 0.5 * (C + C.T)
    rows, cols, vals = [], [], []
    for a in range(n):
        rows.append(2 + a * n + a)
        cols.append(a)
        vals.append(1.0)
    rows += [0, 1]
    cols += [n, n]
    vals += [1.0, 1.0]
    rows += [1, 2 + 0 * n + 1, 2 + 1 * n + 0]
    cols += [n + 1] * 3
    vals += [1.0, -0.5, -0.5]
    At = sp.csc_matrix((vals, (rows, cols)), shape=(2 + n * n, n + 2))
    b = np.r_[np.ones(n), 1.0, 0.2]
    c = np.r_[1.0, 2.0, C.flatten(order="F")]
    return SedumiData(At=At, b=b, c=c, K=Cone(l=2, s=[n]))


def test_solve_sedumi_routes_an_lp_cone_like_jax():
    """K.l > 0: solve_sedumi solves the data with the multiblock driver
    (the LP part as leading 1x1 blocks, nob = 0), reaching the JAX
    dispatcher's optimum."""
    data = _lp_and_psd()
    kw = dict(verbose=False, max_outer=500)
    jr = jax_solve_sedumi(dataclasses.replace(data), **kw)
    tr = solve_sedumi(data, device="cpu", **kw)
    _agree(tr, jr)
    assert len(tr.X) == 3


def test_solve_sedumi_routes_two_blocks_like_jax(quartic_primal):
    """Two PSD blocks: solve_sedumi on the sparse quartic's data is the
    multiblock driver with nob = 0, which is the JAX dispatcher's route:
    the same optimum as the JAX package's solve_multiblock (the
    quartic_primal fixture) and the port's own."""
    data = qsmom_sparse(*_quartic())
    data = SedumiData(At=data.At, b=data.b, c=data.c, K=Cone(s=data.K.s))
    tr = solve_sedumi(data, device="cpu", **QUARTIC_PRIMAL_KW)
    _agree(tr, quartic_primal[0])
    assert tr.obj == quartic_primal[1].obj
    assert len(tr.X) == 2


@pytest.mark.parametrize("driver", ["primal", "dual"])
def test_mixed_inner_dtype_is_not_ported_yet(driver):
    """inner_dtype="mixed" raised NotImplementedError before the port had
    it (the name is kept); it now runs on test_two_oblique_blocks's data
    and reaches the JAX package's optimum (the dual driver on the SOS dual
    of a BQP of size 5, as test_single_block_dual_matches_jax)."""
    if driver == "primal":
        At, b, c, ns = _two_bqp_blocks()
        kw = dict(verbose=False, sigma0=1e-3, sigma_min=1e-2, tau1=1, tau2=1,
                  inner_dtype="mixed")
        jr = jax_multiblock(At, b, c, ns=ns, nob=2, **kw)
        tr = solve_multiblock(At, b, c, ns=ns, nob=2, device="cpu", **kw)
    else:
        rs = np.random.RandomState(2)
        Q = rs.randn(5, 5)
        A, b, c, mb, f, dAAt = assemble_bqpsos(0.5 * (Q + Q.T), rs.randn(5),
                                               5)
        kw = dict(ns=[mb], nob=1, f=f, dAAt=dAAt, verbose=False,
                  inner_dtype="mixed")
        b = b / np.max(np.abs(b))
        jr = jax_dual_multiblock(A, b, c, **kw)
        tr = solve_dual_multiblock(A, b, c, device="cpu", **kw)
    _agree(tr, jr)


def test_checkpoint_and_resume_match_jax(tmp_path):
    """test_checkpoint.py::test_multiblock_checkpoint_resume on the port:
    the snapshot carries the factor, multipliers, sigma and the per-block
    ranks, and the resumed solve ends at the JAX package's optimum."""
    from manisdp_tpu.frontends.sparse_moments import (
        bqpmom_sparse, clique_chain, sparse_objective_basis)
    from manisdp_tpu_torch.utils.checkpoint import load_state

    n, cliques = clique_chain(3, 4)
    nsp = sparse_objective_basis(n, cliques)
    nsp = nsp[:, ~np.all(nsp == 0, axis=0)]
    coe = np.random.RandomState(5).randn(nsp.shape[1])
    data = bqpmom_sparse(n, cliques, coe)
    args = (data.At, data.b, data.c, data.K.s, data.K.nob)
    jr = jax_multiblock(*args, verbose=False)
    path = str(tmp_path / "mb.npz")
    full = solve_multiblock(*args, device="cpu", verbose=False,
                            checkpoint_every=2, checkpoint_path=path)
    _agree(full, jr)
    assert "extra_ps" in load_state(path)
    resumed = solve_multiblock(*args, device="cpu", verbose=False,
                               resume=path)
    _agree(resumed, jr)
    assert resumed.iterations <= full.iterations
