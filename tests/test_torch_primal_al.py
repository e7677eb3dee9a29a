"""The port's primal AL drivers against the JAX package's on the CPU (plain
twins): the sphere / Euclidean manifolds, the cost / grad / Hessian and
stats closures of all three variants at the same (Y, U, y, sigma), end to
end solves from the same explicit Y0 (the cases of tests/test_primal_al.py
plus matrix completion under recipe("mc") and tcg32), the operator ladder
against the JAX package's, and the options the port does not have."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from manisdp_tpu import manifolds as jman
from manisdp_tpu import solve_sdp as j_sdp
from manisdp_tpu import solve_unitdiag as j_unitdiag
from manisdp_tpu import solve_unittrace as j_unittrace
from manisdp_tpu.ops.sparse import ConstraintOp as JOp
from manisdp_tpu.solvers import primal_al as jal
from manisdp_tpu_torch import (recipes, solve_maxcut_unitdiag, solve_sdp,
                               solve_unitdiag, solve_unittrace)
from manisdp_tpu_torch import manifolds as tman
from manisdp_tpu_torch.frontends.workloads import matrix_completion
from manisdp_tpu_torch.ops.sparse import ConstraintOp
from manisdp_tpu_torch.solvers import primal_al as tal
from manisdp_tpu_torch.utils.checkpoint import resume_kwargs
from test_primal_al import diag_constraints, kkt_oracle, random_sym_cost
from test_torch_constraint_op import random_sdp

SPARSE = dict(al_op_mode="sparse", verbose=False)


def _rel(got, ref):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    return np.max(np.abs(got - ref)) / max(np.max(np.abs(ref)), 1e-300)


def _y0(p, n, seed, norm=None):
    Y = np.random.RandomState(seed).randn(p, n)
    if norm == "cols":
        Y /= np.linalg.norm(Y, axis=0)
    elif norm == "frob":
        Y /= np.linalg.norm(Y)
    return Y


# ------------------------------------------------------------- manifolds --

@pytest.mark.parametrize("name", ["Sphere", "Euclidean"])
def test_manifold_ops_match_jax(name):
    jM, tM = getattr(jman, name), getattr(tman, name)
    rs = np.random.RandomState(4)
    x, u, d = (rs.randn(6, 9) for _ in range(3))
    x[4:] = 0.0
    x /= np.linalg.norm(x)
    t = lambda a: torch.as_tensor(a)  # noqa: E731
    j = jnp.asarray
    for op, args in (("proj", (x, u)), ("retr", (x, d)),
                     ("transp", (x, x + d, u)), ("renormalize", (x + d,))):
        got = getattr(tM, op)(*map(t, args)).numpy()
        ref = np.asarray(getattr(jM, op)(*map(j, args)))
        np.testing.assert_allclose(got, ref, rtol=1e-13, atol=1e-15)
    assert float(tM.inner(t(x), t(u), t(d))) == pytest.approx(
        float(jM.inner(j(x), j(u), j(d))), rel=1e-13)
    assert tM.typicaldist(3, 9) == pytest.approx(
        float(jM.typicaldist(3, 9)), rel=1e-15)
    gen = torch.Generator().manual_seed(0)
    Y = tM.rand(gen, 3, 9, 8)
    assert Y.shape == (8, 9) and not Y[3:].any()
    if name == "Sphere":
        assert float(torch.linalg.norm(Y)) == pytest.approx(1.0, rel=1e-14)


# ------------------------------------------------ problem / stats parity --

@pytest.fixture(scope="module")
def ops():
    n, m = 12, 30
    At, b, c = random_sdp(n, m, seed=6)
    return JOp.build(At, b, c, n), ConstraintOp.build(At, b, c, n, "cpu")


def _state(variant, jop, seed=2):
    rs = np.random.RandomState(seed)
    n, m = jop.n, jop.m
    Y = rs.randn(8, n)
    Y[5:] = 0.0
    U = rs.randn(8, n)
    U[5:] = 0.0
    if variant == "unitdiag":
        Y /= np.linalg.norm(Y, axis=0)
        U = U - Y * np.sum(Y * U, axis=0)
    elif variant == "unittrace":
        Y /= np.linalg.norm(Y)
        U = U - Y * np.sum(Y * U)
    return Y, U, rs.randn(m), 0.37


@pytest.mark.parametrize("variant", sorted(tal.VARIANTS))
def test_problem_and_stats_match_jax(ops, variant):
    jop, top = ops
    Y, U, y, sigma = _state(variant, jop)
    jprob, jcost = jal._make_problem(jal.VARIANTS[variant])
    tprob, tcost = tal._make_problem(tal.VARIANTS[variant])
    jp = dict(op=jop, y=jnp.asarray(y), sigma=jnp.float64(sigma))
    tp = dict(op=top, y=torch.as_tensor(y), sigma=sigma)
    jY, jU, tY, tU = jnp.asarray(Y), jnp.asarray(U), torch.as_tensor(Y), \
        torch.as_tensor(U)

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

    # the f32 Hessian of the tcg32 inner loop (params / aux cast)
    from manisdp_tpu_torch.core.trustregions import cast_floats
    c32 = lambda t: jax.tree_util.tree_map(  # noqa: E731
        lambda a: a.astype(jnp.float32)
        if jnp.issubdtype(a.dtype, jnp.floating) else a, t)
    jh32 = jprob.hess(*c32((jY, jU, jp, jaux, jgaux)))
    th32 = tprob.hess(*cast_floats((tY, tU, tp, taux, tgaux),
                                   torch.float32))
    assert th32.dtype == torch.float32
    assert _rel(th32.numpy(), jh32) <= 1e-5

    js = jal._make_stats(jal.VARIANTS[variant])(jY, jop, jnp.asarray(y),
                                                jnp.float64(sigma))
    ts = tal._make_stats(tal.VARIANTS[variant])(tY, top, torch.as_tensor(y),
                                                sigma)
    for name, got, ref in zip(("obj", "pinf", "y", "sv", "z", "by", "gap"),
                              ts, js):
        assert _rel(got.numpy(), ref) <= 1e-10, name


# -------------------------------------------------------- end to end ----

def _check(res, ref, C, At, b, tol=1e-7):
    assert res.status == 0 and ref.status == 0
    eta, obj = kkt_oracle(C, At, b, res)
    assert eta < tol
    np.testing.assert_allclose(obj, res.obj, rtol=1e-8)
    np.testing.assert_allclose(res.obj, ref.obj, rtol=1e-6)


def test_general_matches_jax_and_maxcut_driver():
    """test_primal_al.py:44 — diag(X)=1 as explicit constraints on the
    general driver equals the oblique MaxCut driver."""
    n = 25
    C = random_sym_cost(n, seed=1)
    At, b = diag_constraints(n)
    c = C.flatten(order="F")
    Y0 = _y0(1, n, 0)
    res = solve_sdp(At, b, c, n, Y0=Y0, device="cpu", max_outer=300,
                    **SPARSE)
    ref = j_sdp(At, b, c, n, Y0=Y0, max_outer=300, **SPARSE)
    _check(res, ref, C, At, b)
    res_m = solve_maxcut_unitdiag(C, device="cpu", verbose=False)
    np.testing.assert_allclose(res.obj, res_m.obj, rtol=1e-6)


def test_unitdiag_with_extra_constraint_matches_jax():
    """test_primal_al.py:60 — one extra affine constraint on the oblique
    driver."""
    n = 20
    C = random_sym_cost(n, seed=2)
    res0 = solve_maxcut_unitdiag(C, device="cpu", verbose=False)
    t = 0.5 * res0.X[0, 1]
    At = sp.coo_matrix(([1.0, 1.0], ([1, n], [0, 0])),
                       shape=(n * n, 1)).tocsc()
    b = np.array([2 * t])
    c = C.flatten(order="F")
    Y0 = _y0(2, n, 1, norm="cols")
    kw = dict(SPARSE, sigma0=1e-1)
    res = solve_unitdiag(At, b, c, n, Y0=Y0, device="cpu", **kw)
    ref = j_unitdiag(At, b, c, n, Y0=Y0, **kw)
    _check(res, ref, C, At, b)
    assert abs(res.X[0, 1] - t) < 1e-6
    np.testing.assert_allclose(np.diag(res.X), 1.0, atol=1e-10)
    assert res.obj >= res0.obj - 1e-6


def test_unittrace_rayleigh_matches_jax():
    """test_primal_al.py:85 — tr(X)=1 with a consistent extra constraint:
    the optimum is lambda_min(C)."""
    n = 15
    C = random_sym_cost(n, seed=3)
    wmin, V = np.linalg.eigh(C)
    At = sp.coo_matrix(([1.0], ([0], [0])), shape=(n * n, 1)).tocsc()
    b = np.array([V[0, 0] ** 2])
    c = C.flatten(order="F")
    Y0 = _y0(1, n, 2, norm="frob")
    kw = dict(SPARSE, sigma0=1e1, sigma_min=1e0)
    res = solve_unittrace(At, b, c, n, Y0=Y0, device="cpu", **kw)
    ref = j_unittrace(At, b, c, n, Y0=Y0, **kw)
    _check(res, ref, C, At, b)
    np.testing.assert_allclose(res.obj, wmin[0], rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(np.trace(res.X), 1.0, atol=1e-8)


def test_general_warm_start_matches_jax():
    """test_primal_al.py:104 — a warm start from the first optimum takes
    no more iterations."""
    n = 15
    C = random_sym_cost(n, seed=4)
    At, b = diag_constraints(n)
    c = C.flatten(order="F")
    kw = dict(SPARSE, max_outer=300)
    res1 = solve_sdp(At, b, c, n, Y0=_y0(1, n, 3), device="cpu", **kw)
    res2 = solve_sdp(At, b, c, n, Y0=res1.Y, device="cpu", **kw)
    ref = j_sdp(At, b, c, n, Y0=res1.Y, **kw)
    _check(res2, ref, C, At, b)
    assert res2.iterations <= res1.iterations


def test_matrix_completion_tcg32_matches_jax():
    """The mc workload at p = q = 20 (the reference construction, bench.py's
    overrides on recipe("mc")): f32 tCG on the factored operator."""
    data, _ = matrix_completion(20, 20, rank=10, m_samples=400 * 40, seed=3)
    n = data.K.s
    _, kw = recipes.recipe("mc")
    kw = dict(kw, delta=10, tr_maxinner=6, tr_maxiter=8, theta=1e-2,
              inner_dtype="tcg32", **SPARSE)
    Y0 = _y0(1, n, 5)
    res = solve_sdp(data.At, data.b, data.c, n, Y0=Y0, device="cpu", **kw)
    ref = j_sdp(data.At, data.b, data.c, n, Y0=Y0, **kw)
    C = data.c.reshape(n, n, order="F")
    _check(res, ref, C, data.At, data.b)
    assert res.eta <= 1e-8


# ------------------------------------------------- port-only behaviour --

def _small_general(n=10, seed=6):
    C = random_sym_cost(n, seed=seed)
    At, b = diag_constraints(n)
    return At, b, C.flatten(order="F"), n


def test_checkpoint_and_resume(tmp_path):
    At, b, c, n = _small_general()
    path = str(tmp_path / "al.npz")
    kw = dict(SPARSE, max_outer=300)
    first = solve_sdp(At, b, c, n, Y0=_y0(1, n, 0), device="cpu",
                      checkpoint_every=2, checkpoint_path=path, **dict(
                          kw, max_outer=2))
    assert first.status == 1 and first.iterations == 2
    rk = resume_kwargs(path)
    assert rk["y0"].shape == (n,) and rk["sigma0"] == first.sigma
    res = solve_sdp(At, b, c, n, resume=path, device="cpu", **kw)
    full = solve_sdp(At, b, c, n, Y0=_y0(1, n, 0), device="cpu", **kw)
    assert res.status == 0 and full.status == 0
    np.testing.assert_allclose(res.obj, full.obj, rtol=1e-7)


def test_device_certificate_paths_certify():
    """The devrr (Kato-Temple, cheap / warm budgets) and rowrr (linear
    bound) certificates on the factored operator's K1 matvecs, checked by
    the dense oracle."""
    n = 80
    C = random_sym_cost(n, seed=7)
    At, b = diag_constraints(n)
    c = C.flatten(order="F")
    for cert in ("devrr", "rowrr"):
        res = solve_unitdiag(At, b, c, n, Y0=_y0(2, n, 8, norm="cols"),
                             device="cpu", eig_method="lobpcg",
                             cert_method=cert, **SPARSE)
        assert res.status == 0
        assert kkt_oracle(C, At, b, res)[0] < 1e-7


def test_cuda_without_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    At, b, c, n = _small_general()
    for solve in (solve_sdp, solve_unitdiag, solve_unittrace):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            solve(At, b, c, n, verbose=False)


def test_constraint_op_given_on_another_device_raises():
    At, b, c, n = _small_general()
    op = ConstraintOp.build(At, b, c, n, "cpu")
    with pytest.raises(ValueError, match="lives on"):
        solve_sdp(op, b, c, n, device="meta", verbose=False)


class _Picked(Exception):
    """Stops a solve once its operator is known."""


def _picked_operators(monkeypatch, At, b, c, n, **kw):
    """The class names of the operators the JAX ladder and the port's pick
    for the same data and options."""
    picked = {}

    def jcert(variant, op, n, k, use_eigh, opt, op_dev=None, **_):
        picked["jax"] = type(op_dev).__name__
        raise _Picked

    select = tal._select_operator

    def tselect(opt, op):
        picked["torch"] = type(select(opt, op)).__name__
        raise _Picked

    monkeypatch.setattr(jal, "_make_certificate", jcert)
    monkeypatch.setattr(tal, "_select_operator", tselect)
    with pytest.raises(_Picked):
        j_sdp(At, b, c, n, verbose=False, **kw)
    with pytest.raises(_Picked):
        solve_sdp(At, b, c, n, device="cpu", verbose=False, **kw)
    return picked


@pytest.mark.parametrize("mode,which", [
    ("auto", "entrywise"), ("entrywise", "entrywise"), ("dense", "dense"),
    ("auto_dense", "dense")])
def test_unported_carriers_raise(mode, which, monkeypatch):
    """The four selections that raised before the dense and entrywise
    carriers were ported: the port's ladder now picks the carrier the JAX
    package's picks."""
    At, b, c, n = _small_general()
    if mode == "auto_dense":
        # a constraint on two diagonal entries is not entrywise
        At = sp.coo_matrix(([1.0, 1.0], ([0, n + 1], [0, 0])),
                           shape=(n * n, 1)).tocsc()
        b, mode = np.array([1.0]), "auto"
    picked = _picked_operators(monkeypatch, At, b, c, n, al_op_mode=mode)
    cls = {"entrywise": "EntrywiseConstraintOp",
           "dense": "DenseConstraintOp"}[which]
    assert picked == {"jax": cls, "torch": cls}


@pytest.mark.parametrize("kw,cls", [
    (dict(al_op_mode="sparse"), "ConstraintOp"),
    (dict(al_op_mode="auto", entrywise_al_max_n=5), "DenseConstraintOp"),
    (dict(al_op_mode="auto", entrywise_al_max_n=5, dense_al_max_n=5),
     "ConstraintOp"),
    (dict(al_op_mode="entrywise", entrywise_al_max_n=5), "ConstraintOp")])
def test_ladder_limits_match_jax(kw, cls, monkeypatch):
    """Above each carrier's limit of n both ladders fall through to the
    next rung (al_op_mode="entrywise" above its limit: the factored
    operator)."""
    At, b, c, n = _small_general()
    picked = _picked_operators(monkeypatch, At, b, c, n, **kw)
    assert picked == {"jax": cls, "torch": cls}


def test_entrywise_mode_on_a_non_entrywise_set_raises():
    At, b, c, n = _small_general()
    At = sp.coo_matrix(([1.0, 1.0], ([0, n + 1], [0, 0])),
                       shape=(n * n, 1)).tocsc()
    for solve, kw in ((j_sdp, {}), (solve_sdp, dict(device="cpu"))):
        with pytest.raises(ValueError, match="not entrywise"):
            solve(At, np.array([1.0]), c, n, verbose=False,
                  al_op_mode="entrywise", **kw)


@pytest.mark.parametrize("kw,name", [
    (dict(inner_dtype="mixed"), "inner_dtype='mixed'"),
    (dict(eig_method="lobpcg", cert_method="lobpcg"), "cert_method='lobpcg'"),
    (dict(eig_method="lobpcg", cert_method="dense_eigh"), "dense_eigh"),
    (dict(eig_method="lobpcg", cert_pre_dtype="float32"),
     "cert_pre_dtype='float32'"),
])
def test_unported_options_raise(kw, name):
    """Options the port does not have yet raise and name themselves;
    cert_method="dense_eigh" on the factored operator falls through to the
    legacy lobpcg certificate, as in the JAX package, and names it."""
    At, b, c, n = _small_general()
    with pytest.raises(NotImplementedError, match=name) as err:
        solve_sdp(At, b, c, n, device="cpu", **dict(SPARSE, **kw))
    if name == "dense_eigh":
        assert "lobpcg" in str(err.value)


def test_entry_points_keep_the_jax_signatures():
    import inspect
    from manisdp_tpu import solve_sdp as js, solve_unitdiag as ju
    from manisdp_tpu import solve_unittrace as jt
    for jfn, tfn in ((js, solve_sdp), (ju, solve_unitdiag),
                     (jt, solve_unittrace)):
        jp = [p for p in inspect.signature(jfn).parameters if p != "mesh"]
        tp = list(inspect.signature(tfn).parameters)
        assert tp == jp[:-1] + ["device"] + jp[-1:]
    for name, jv in jal.VARIANTS.items():
        tv = dataclasses.asdict(tal.VARIANTS[name])
        jv = dataclasses.asdict(jv)
        assert tv.pop("manifold").name == jv.pop("manifold").name
        assert tv == jv
    assert set(tal.VARIANTS) == set(jal.VARIANTS)
