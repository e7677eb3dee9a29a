"""The port's dual Riemannian-ADMM drivers against the JAX package's on
the CPU (plain twins): the cost / grad / Hessian and stats closures of
both variants on both operators at the same (Y, U, Xm, w, sigma), f32
Hessians under tcg32 casting, end-to-end solves from the same explicit
Y0 (the cases of tests/test_dual.py and tests/test_symdual.py), a
checkpoint / resume round trip, and the options the port does not have."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import threadpoolctl
import torch

from manisdp_tpu import solve_dual_sdp as j_dual_sdp
from manisdp_tpu import solve_dual_unitdiag as j_dual_unitdiag
from manisdp_tpu.frontends.moments import bqpmom, qsmom
from manisdp_tpu.ops.dualops import DualOp as JDualOp
from manisdp_tpu.ops.symdual import SymDualOp as JSymDualOp
from manisdp_tpu.solvers import dual_al as jal
from manisdp_tpu.solvers.dual_general import build_iab as j_build_iab
from manisdp_tpu.solvers.general import solve_sdp as j_sdp
from manisdp_tpu.solvers.unitdiag import solve_unitdiag as j_unitdiag
from manisdp_tpu_torch import solve_dual_sdp, solve_dual_unitdiag
from manisdp_tpu_torch.core.trustregions import cast_floats
from manisdp_tpu_torch.frontends.monomials import monomial_basis
from manisdp_tpu_torch.frontends.sos import assemble_bqpsos, qssos
from manisdp_tpu_torch.ops.dualops import DualOp
from manisdp_tpu_torch.ops.symdual import SymDualOp
from manisdp_tpu_torch.solvers import dual_al as tal
from manisdp_tpu_torch.solvers.dual_general import build_iab
from manisdp_tpu_torch.solvers.dual_unitdiag import solve_bqp_sos_dual
from manisdp_tpu_torch.utils.checkpoint import load_state


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


CPU = dict(device="cpu", verbose=False)


def _rel(got, ref):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    if not ref.size:
        return 0.0
    return np.max(np.abs(got - ref)) / max(np.max(np.abs(ref)), 1e-300)


def _bqp(q, seed):
    rng = np.random.default_rng(seed)
    Q = rng.standard_normal((q, q))
    return (Q + Q.T) / 2, rng.standard_normal(q)


def _unit_cols(Y):
    return Y / np.linalg.norm(Y, axis=0)


# ------------------------------------------------ problem / stats parity --

def _ops(kind):
    """(variant, JAX op, port op, JAX iAB, port iAB)."""
    if kind == "sym":
        q = 5
        Q, e = _bqp(q, 7)
        j0 = JSymDualOp.build_bqpsos(Q, e, q)
        t0 = SymDualOp.build_bqpsos(Q, e, q, device="cpu")
        maxb = float(np.max(np.abs(np.asarray(j0.b))))
        return ("dual_unitdiag",
                dataclasses.replace(j0, b=j0.b / maxb, bA=j0.bA / maxb),
                t0.scaled(maxb), None, None)
    if kind == "bqp":
        Q, e = _bqp(6, 1)
        A, b, c, mb, f, dAAt = assemble_bqpsos(Q, e, 6)
        b = b / np.max(np.abs(b))
        return ("dual_unitdiag", JDualOp.build(A, b, c, mb, f, dAAt),
                DualOp.build(A, b, c, mb, f, dAAt, device="cpu"), None, None)
    coe = np.random.RandomState(2).randn(monomial_basis(4, 4).shape[1])
    A, b, c, mb, f, dAAt = qssos(4, coe)
    b = b / np.max(np.abs(b))
    return ("dual_general", JDualOp.build(A, b, c, mb, f, dAAt),
            DualOp.build(A, b, c, mb, f, dAAt, device="cpu"),
            j_build_iab(A, mb, f, dAAt), build_iab(A, mb, f, dAAt, "cpu"))


@pytest.mark.parametrize("kind", ["bqp", "sym", "qs"])
def test_problem_and_stats_match_jax(kind):
    variant, jop, top, jiab, tiab = _ops(kind)
    rs = np.random.RandomState(3)
    n, f = top.n, top.f
    Y = rs.randn(8, n)
    Y[5:] = 0.0
    U = rs.randn(8, n)
    U[5:] = 0.0
    if variant == "dual_unitdiag":
        Y[:5] = _unit_cols(Y[:5])
        U = U - Y * np.sum(Y * U, axis=0)
    Xm = rs.randn(n, n)
    Xm = 0.5 * (Xm + Xm.T)
    w = rs.randn(f)
    sigma = 0.37
    jprob, _ = jal._make_problem(jal.DUAL_VARIANTS[variant], jiab)
    tprob, tcost = tal._make_problem(tal.DUAL_VARIANTS[variant])
    jp = dict(op=jop, Xm=jnp.asarray(Xm), w=jnp.asarray(w),
              sigma=jnp.float64(sigma))
    tp = dict(op=top, Xm=torch.as_tensor(Xm), w=torch.as_tensor(w),
              sigma=sigma, iAB=tiab)
    jY, jU = jnp.asarray(Y), jnp.asarray(U)
    tY, tU = torch.as_tensor(Y), torch.as_tensor(U)

    jf, jaux = jprob.cost(jY, jp)
    tf, taux = tprob.cost(tY, tp)
    assert float(tf) == pytest.approx(float(jf), rel=1e-10)
    assert float(tcost(tY, tp)) == float(tf)
    jg, jgaux = jprob.grad(jY, jp, jaux)
    tg, tgaux = tprob.grad(tY, tp, taux)
    assert _rel(tg.numpy(), jg) <= 1e-10
    jh = jprob.hess(jY, jU, jp, jaux, jgaux)
    th = tprob.hess(tY, tU, tp, taux, tgaux)
    assert _rel(th.numpy(), jh) <= 1e-10

    # the f32 Hessian of the tcg32 inner loop, params cast as the RTR does
    cast32 = lambda x: x.astype(jnp.float32) \
        if jnp.issubdtype(x.dtype, jnp.floating) else x  # noqa: E731
    j32 = dict(jp, op=jax.tree_util.tree_map(cast32, jop),
               Xm=jp["Xm"].astype(jnp.float32), w=jp["w"].astype(jnp.float32),
               sigma=jnp.float32(sigma))
    if jiab is not None:
        jprob32, _ = jal._make_problem(jal.DUAL_VARIANTS[variant],
                                       jax.tree_util.tree_map(cast32, jiab))
    else:
        jprob32 = jprob
    jh32 = jprob32.hess(jY.astype(jnp.float32), jU.astype(jnp.float32), j32,
                        jax.tree_util.tree_map(cast32, jaux),
                        jax.tree_util.tree_map(cast32, jgaux))
    f32 = lambda t: cast_floats(t, torch.float32)  # noqa: E731
    th32 = tprob.hess(tY.float(), tU.float(), f32(tp), f32(taux), f32(tgaux))
    assert th32.dtype == torch.float32
    assert _rel(th32.numpy(), jh32) <= 1e-5

    normc = 1.7
    jst = jal._make_stats(jal.DUAL_VARIANTS[variant], jiab)(
        jY, jop, jp["Xm"], jp["w"], jp["sigma"], normc)
    tst = tal._make_stats(tal.DUAL_VARIANTS[variant])(
        tY, top, tp["Xm"], tp["w"], sigma, normc, tiab)
    for a, b in zip(tst, jst):
        assert _rel(a.numpy(), b) <= 1e-10


# ------------------------------------------------------- end to end -------

def test_bqp_original_basis_matches_jax_and_the_primal():
    """tests/test_dual.py:15-32 from one Y0: the port's dual bound equals
    the JAX package's primal moment value and its dual value."""
    n = 8
    rs = np.random.RandomState(1)
    Q = rs.randn(n, n)
    Q = 0.5 * (Q + Q.T)
    e = rs.randn(n)
    data = bqpmom(n, Q, e)
    res_p = j_unitdiag(data.At, data.b, data.c, data.K.s, verbose=False)
    assert res_p.status == 0
    A, b, c, mb, f, dAAt = assemble_bqpsos(Q, e, n)
    maxb = np.max(np.abs(b))
    p0 = int(np.ceil(np.log(A.shape[0])))
    Y0 = _unit_cols(np.random.RandomState(5).randn(p0, mb))
    kw = dict(f=f, dAAt=dAAt, line_search=True, Y0=Y0)
    res_j = j_dual_unitdiag(A, b / maxb, c, mb, verbose=False, **kw)
    res_t = solve_dual_unitdiag(A, b / maxb, c, mb, **CPU, **kw)
    assert res_t.status == 0 and res_t.eta <= 1e-8
    np.testing.assert_allclose(res_t.obj * maxb, res_p.obj, rtol=1e-7)
    np.testing.assert_allclose(res_t.obj, res_j.obj, rtol=1e-7)
    assert res_t.X.shape == (mb, mb) and res_t.y.shape == (A.shape[0],)


def test_qs_general_variant_matches_jax_and_the_primal():
    """tests/test_dual.py:35-50 from one Y0 (dual_general with iAB)."""
    n = 4
    coe = np.random.RandomState(2).randn(monomial_basis(n, 4).shape[1])
    data = qsmom(n, coe)
    res_p = j_sdp(data.At, data.b, data.c, data.K.s, verbose=False,
                  theta=1e-2, tau1=0.02)
    assert res_p.status == 0
    A, b, c, mb, f, dAAt = qssos(n, coe)
    maxb = np.max(np.abs(b))
    Y0 = np.random.RandomState(6).randn(1, mb)
    kw = dict(f=f, dAAt=dAAt, theta=1e-1, tau2=0.5, Y0=Y0)
    res_j = j_dual_sdp(A, b / maxb, c, mb, verbose=False, **kw)
    res_t = solve_dual_sdp(A, b / maxb, c, mb, **CPU, **kw)
    assert res_t.status == 0 and res_t.eta <= 1e-8
    np.testing.assert_allclose(res_t.obj * maxb, res_p.obj, rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(res_t.obj, res_j.obj, rtol=1e-6)


def test_expanded_basis_matches_the_original_basis():
    """tests/test_symdual.py:188-206 in the port, from seeded Y0s: the
    SymDualOp (K7 / K8 twins) and the DualOp (K4 twin) reach one optimum;
    solve_bqp_sos_dual (the parameter mapping, tcg32) reaches it too."""
    q = 8
    Q, e = _bqp(q, 11)
    A, b, c, mb, f, dAAt = assemble_bqpsos(Q, e, q)
    maxb = np.max(np.abs(b))
    p0 = int(np.ceil(np.log(A.shape[0])))
    Y0 = _unit_cols(np.random.RandomState(7).randn(p0, mb))
    res_orig = solve_dual_unitdiag(A, b / maxb, c, mb, f=f, dAAt=dAAt,
                                   line_search=True, tol=1e-8, Y0=Y0, **CPU)
    top = SymDualOp.build_bqpsos(Q, e, q, device="cpu").scaled(maxb)
    Y0e = np.random.RandomState(8).randn(4, top.n)
    res_exp = solve_dual_unitdiag(top, None, None, top.n, line_search=True,
                                  tol=1e-8, Y0=_unit_cols(Y0e), **CPU)
    res_map = solve_bqp_sos_dual(Q, e, q, line_search=True,
                                 inner_dtype="tcg32", **CPU)
    for res in (res_orig, res_exp, res_map):
        assert res.status == 0 and res.eta <= 1e-8
    np.testing.assert_allclose(res_exp.obj, res_orig.obj, rtol=1e-8)
    np.testing.assert_allclose(res_map.obj, res_orig.obj * maxb, rtol=1e-8)
    assert res_exp.y.shape == (top.m,) and res_exp.X.shape == (top.n,) * 2


def test_checkpoint_and_resume_round_trip(tmp_path):
    Q, e = _bqp(6, 3)
    A, b, c, mb, f, dAAt = assemble_bqpsos(Q, e, 6)
    b = b / np.max(np.abs(b))
    Y0 = _unit_cols(np.random.RandomState(9).randn(4, mb))
    kw = dict(f=f, dAAt=dAAt, line_search=True, Y0=Y0, **CPU)
    full = solve_dual_unitdiag(A, b, c, mb, **kw)
    path = str(tmp_path / "dual.npz")
    part = solve_dual_unitdiag(A, b, c, mb, max_outer=3, checkpoint_every=3,
                               checkpoint_path=path, **kw)
    assert part.status == 1 and part.iterations == 3
    st = load_state(path)
    assert {"Y", "Xm", "w", "sigma", "iteration"} <= set(st)
    assert st["Xm"].shape == (mb, mb) and st["w"].shape == (f,)
    assert float(st["sigma"]) == part.sigma
    rest = solve_dual_unitdiag(A, b, c, mb, resume=path,
                               **dict(kw, Y0=None))
    assert full.status == 0 and rest.status == 0
    np.testing.assert_allclose(rest.obj, full.obj, rtol=1e-7)


def test_unported_options_raise():
    """The three options that raised NotImplementedError before the port
    had them (the name is kept) now run and reach the JAX package's
    optimum from the same Y0; a CUDA solve without a card and an operator
    on another device still raise.  At q = 9 (n = 46): the JAX lobpcg
    routine needs n > 5 times its block of 9."""
    Q, e = _bqp(9, 5)
    A, b, c, mb, f, dAAt = assemble_bqpsos(Q, e, 9)
    kw = dict(f=f, dAAt=dAAt, **CPU)
    b = b / np.max(np.abs(b))
    Y0 = _unit_cols(np.random.RandomState(5).randn(3, mb))
    for opts in (dict(inner_dtype="mixed"),
                 dict(eig_method="lobpcg", cert_method="lobpcg"),
                 dict(eig_method="lobpcg", cert_method="rowrr",
                      cert_pre_dtype="float32")):
        tr = solve_dual_unitdiag(A, b, c, mb, Y0=Y0, **kw, **opts)
        jr = j_dual_unitdiag(A, b, c, mb, f=f, dAAt=dAAt, Y0=Y0,
                             verbose=False, **opts)
        assert tr.status == 0 and jr.status == 0 and tr.eta < 1e-8, opts
        np.testing.assert_allclose(tr.obj, jr.obj, rtol=1e-6)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            solve_dual_unitdiag(A, b, c, mb, f=f, dAAt=dAAt, verbose=False)
    op = DualOp.build(A, b, c, mb, f, dAAt, device="cpu")
    with pytest.raises(ValueError, match="lives on"):
        solve_dual_unitdiag(op, None, None, mb, device="meta")
