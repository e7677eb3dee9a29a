"""The port's device LOBPCG certificate against the JAX package's
DeviceCertSolver (warm call, Kato-Temple bound) and RowCertSolver
(big-block retry, linear bound), and both against a dense eigh of S, for
a fixed (C, z, Y) and the same start block."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import threadpoolctl
import torch

from manisdp_tpu.ops.eigs_rr import DeviceCertSolver as JDeviceCert
from manisdp_tpu.ops.eigs_rr import RowCertSolver as JRowCert
from manisdp_tpu.ops.sparse import SymCOO as JSymCOO
import chip_smoke
from manisdp_tpu_torch import kernels as K
from manisdp_tpu_torch.convert import symcoo_from_arrays
from manisdp_tpu_torch.ops.eigs import lanczos_bounds
from manisdp_tpu_torch.ops.eigs_rr import DeviceCertSolver
from test_maxcut import random_graph_cost

N, K_CERT, P, DR = 300, 9, 6, 48
# converged Ritz values agree to ~1e-12 of the spectral scale; 1e-9
# relative leaves room for the LOBPCG stopping at a different iteration


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


RTOL = 1e-9


@pytest.fixture(scope="module")
def case():
    C = random_graph_cost(N, 1500, seed=5)
    jC = JSymCOO.from_scipy(0.5 * (C + C.T))
    tC = symcoo_from_arrays(np.asarray(jC.i), np.asarray(jC.j),
                            np.asarray(jC.v), N, "cpu")
    rs = np.random.RandomState(1)
    Y = np.zeros((DR, N))
    Y[:P] = rs.randn(P, N)
    Y /= np.linalg.norm(Y, axis=0)
    z = np.array(jC.quad_cols(jnp.asarray(Y)))
    S = C.toarray() - np.diag(z)
    X0 = rs.randn(K_CERT, N)
    return dict(jC=jC, tC=tC, Y=Y, z=z, X0=X0,
                eigs=np.linalg.eigvalsh(S))


def _mv(case):
    tz = torch.from_numpy(case["z"])
    return lambda V: K.symcoo_spmm(V, case["tC"], "shift", z=tz)


def _j_mv(V, ctx):
    return ctx["C"].matmat(V) - ctx["z"][None, :] * V


def test_lanczos_bounds_bracket_spectrum(case):
    gen = torch.Generator().manual_seed(0)
    v0 = torch.randn((1, N), generator=gen, dtype=torch.float64)
    lo, hi = lanczos_bounds(_mv(case), v0, iters=32)
    ev = case["eigs"]
    assert float(hi) >= ev[-1] - 1e-6 * abs(ev[-1])
    assert float(lo) <= ev[0] + 1e-6 * abs(ev[0])


def test_warm_cert_matches_jax_device_solver(case):
    ctx = dict(C=case["jC"], z=jnp.asarray(case["z"]))
    jres = JDeviceCert(_j_mv, N, K_CERT, deflate_rows=DR).solve(
        ctx, jax.random.PRNGKey(0), X0=jnp.asarray(case["X0"]),
        Ypad=jnp.asarray(case["Y"]), maxiter=400, tol=1e-12)
    solver = DeviceCertSolver(N, K_CERT, deflate_rows=DR)
    assert solver.b == 24 and solver.b == K_CERT + JDeviceCert(
        _j_mv, N, K_CERT, deflate_rows=DR).aug
    gen = torch.Generator().manual_seed(0)
    tres = solver.solve(_mv(case), gen, X0=torch.from_numpy(case["X0"]),
                        Ydefl=torch.from_numpy(case["Y"]), maxiter=400,
                        tol=1e-12)
    ev = case["eigs"]
    np.testing.assert_allclose(tres.neg_vals.numpy(),
                               np.asarray(jres.neg_vals), rtol=RTOL)
    np.testing.assert_allclose(tres.neg_vals.numpy(), ev[:K_CERT],
                               rtol=RTOL)
    np.testing.assert_allclose(float(tres.lam_min), float(jres.lam_min),
                               rtol=RTOL)
    assert float(tres.lam_min) <= ev[0] + 1e-12 * abs(ev[0])   # sound
    # num_neg counts negative Ritz values, so it saturates at the block
    assert tres.num_neg == int(jres.num_neg) == min(
        int(np.sum(ev < 0)), solver.b)
    assert tres.neg_vecs.shape == (N, K_CERT)


def test_big_block_retry_matches_jax_row_solver(case):
    """The accuracy-deciding retry: block cap 96, the active rows of Y as
    deflation, the linear bound (JAX: RowCertSolver with host RR)."""
    ctx = dict(C=case["jC"], z=jnp.asarray(case["z"]))
    Yact = case["Y"][:P]
    jres = JRowCert(_j_mv, N).solve(
        ctx, jax.random.PRNGKey(0), K_CERT,
        X0=jnp.asarray(case["X0"].T), deflate=jnp.asarray(Yact),
        maxiter=400, tol=1e-12, block_cap=96)
    solver = DeviceCertSolver(N, K_CERT, deflate_rows=P, block_cap=96,
                              bound="linear")
    assert solver.b == K_CERT + P
    gen = torch.Generator().manual_seed(0)
    tres = solver.solve(_mv(case), gen, X0=torch.from_numpy(case["X0"].T),
                        Ydefl=torch.from_numpy(Yact), maxiter=400,
                        tol=1e-12)
    ev = case["eigs"]
    np.testing.assert_allclose(tres.neg_vals.numpy(),
                               np.asarray(jres.neg_vals), rtol=RTOL)
    np.testing.assert_allclose(tres.neg_vals.numpy(), ev[:K_CERT],
                               rtol=RTOL)
    # linear bound: ritz_0 - ||r_0||, a lower bound within the residual
    assert float(tres.lam_min) <= ev[0] + 1e-12 * abs(ev[0])
    np.testing.assert_allclose(float(tres.lam_min), float(jres.lam_min),
                               rtol=RTOL)
    assert tres.num_neg == int(jres.num_neg)


def test_unconverged_cert_stays_sound(case):
    """A starved budget may not certify: the bound stays below the true
    lambda_min."""
    for bound in ("kato", "linear"):
        solver = DeviceCertSolver(N, K_CERT, deflate_rows=DR, bound=bound)
        gen = torch.Generator().manual_seed(1)
        res = solver.solve(_mv(case), gen, Ydefl=torch.from_numpy(
            case["Y"]), maxiter=3, tol=1e-12)
        assert float(res.lam_min) <= case["eigs"][0] + 1e-12


# -- the AL certificate at a converged matrix-completion point ------------
# (ROADMAP Queue C: the devrr certificate stalls at converged points of
# matrix completion.)  A CPU solve of trace-min matrix completion at
# n = 600 on the factored operator reaches gap, pinf <= 4e-7 at its 8th
# outer iteration; there the warm certificate call (80 LOBPCG iterations
# from the previous call's vectors) ends with residual ~0.7 and no
# negative Ritz value, although S = mat(sv) has a 10-fold null cluster.
# Both packages' DeviceCertSolvers, fed the same S, start block and
# deflation rows, agree step for step while the block converges (to
# residual ~4e-6 by iteration 10) and then both lose the cluster.

MC_ITER = 8


@pytest.fixture(scope="module")
def mc_stall():
    from manisdp_tpu_torch import recipes
    from manisdp_tpu_torch.frontends.workloads import matrix_completion
    from manisdp_tpu_torch.ops.sparse import ConstraintOp
    from manisdp_tpu_torch.solvers.general import solve_sdp

    data, _ = matrix_completion(300, 300, rank=10, m_samples=24_000, seed=3)
    n = int(data.K.s)
    op = ConstraintOp.build(data.At, data.b, data.c, n, "cpu")
    # chip_smoke.py's recorder of the certificate calls (--capture-stall);
    # its point: the first warm call that ran out of budget near the
    # optimum (here the retry then certifies)
    spy = chip_smoke.CertSpy(capture=lambda h, opt: max(
        h["gap"], h["pinf"]) <= 1e-6 and h["lobpcg"][0]["resid"] > 1e-2)
    _, kw = recipes.recipe("mc")
    kw.update(delta=10, tr_maxinner=6, tr_maxiter=8, theta=1e-2,
              inner_dtype="tcg32", al_op_mode="sparse", eig_method="lobpcg",
              max_outer=MC_ITER)
    spy.install()
    try:
        res = solve_sdp(op, data.b, data.c, n, device="cpu", **kw)
    finally:
        spy.remove()
    h = res.history[-1]
    # the last outer iteration's warm call: from the previous vectors, the
    # driver's warm budget
    c = [c for c in spy.calls if c["maxiter"] == 80][-1]
    warm = dict(c, iters=c["last"]["iters"], resid=float(c["last"]["resid"]))
    S = warm["mvr"](torch.eye(n, dtype=torch.float64)).numpy()
    S = 0.5 * (S + S.T)
    Yd = warm["Ydefl"].numpy().copy()
    # the deflation rows fill the block's 13 augmentation rows (10 active
    # rows of Y, then 3 seeded rows), so neither package draws random rows
    act = int(np.sum(np.abs(Yd).sum(axis=1) > 0))
    Yd[act:13] = 1e-3 * np.random.RandomState(0).randn(13 - act, n)
    return dict(n=n, k=warm["X0"].shape[1], S=S, X0=warm["X0"].numpy(),
                Yd=Yd, gap=h["gap"], pinf=h["pinf"], warm=warm,
                eigs=np.linalg.eigvalsh(S), spy=spy, op=op)


def _both_certs(case, maxiter):
    n, k, dr = case["n"], case["k"], case["Yd"].shape[0]
    S = case["S"]
    jsol = JDeviceCert(lambda V, ctx: V @ ctx["S"], n, k, deflate_rows=dr)
    jres = jsol.solve(dict(S=jnp.asarray(S)), jax.random.PRNGKey(0),
                      X0=jnp.asarray(case["X0"]),
                      Ypad=jnp.asarray(case["Yd"]), maxiter=maxiter,
                      tol=1e-9)
    St = torch.from_numpy(S)
    tsol = DeviceCertSolver(n, k, deflate_rows=dr)
    assert tsol.b == jsol.b == 24
    tres = tsol.solve(lambda V: V @ St, torch.Generator().manual_seed(0),
                      X0=torch.from_numpy(case["X0"]),
                      Ydefl=torch.from_numpy(case["Yd"]), maxiter=maxiter,
                      tol=1e-9)
    return (jres, dict(iters=int(jsol.last["iters"]),
                       resid=float(jsol.last["resid"]))), \
        (tres, dict(iters=tsol.last["iters"],
                    resid=float(tsol.last["resid"])))


def test_mc_point_stalls_in_the_driver(mc_stall):
    """The captured point: converged primal side, a certifiable S (its
    exact lambda_min is ~0), and a warm call that ran out of budget with
    no negative Ritz value."""
    c = mc_stall
    assert max(c["gap"], c["pinf"]) < 1e-6
    ev = c["eigs"]
    assert abs(ev[0]) < 1e-8 and np.sum(np.abs(ev) < 1e-8) == 10
    w = c["warm"]
    assert w["iters"] == 80 and w["resid"] > 1e-2 and w["num_neg"] == 0


def test_mc_cert_matches_jax_while_converging(mc_stall, monkeypatch):
    """The start block's warm vectors lie in the span of its deflation
    rows, so the first Rayleigh-Ritz steps whiten a Gram conditioned at
    ~1e12, just inside the 1e-12 drop tolerance: each amplifies rounding
    to ~1e-4 relative.  The two packages' residuals (the largest of the
    block's) then agree to rounding for two iterations and part as the
    machine's BLAS decides; the Ritz values, the bound and the negative
    count are held at five."""
    import manisdp_tpu_torch.ops.eigs_rr as er
    conds, rr = [], er._rayleigh_ritz

    def spy(G, H, drop, nkeep, big):
        w = torch.linalg.eigvalsh(0.5 * (G + G.T))
        conds.append(float(w[-1] / w[w > drop * w[-1]][0]))
        return rr(G, H, drop, nkeep, big)

    monkeypatch.setattr(er, "_rayleigh_ritz", spy)
    for it in (1, 2):
        (_, jl), (_, tl) = _both_certs(mc_stall, it)
        assert tl["iters"] == jl["iters"] == it
        np.testing.assert_allclose(tl["resid"], jl["resid"], rtol=1e-3)
    print(f"margin: the first Gram's condition {conds[0]:.2e} (rounding "
          f"amplified to ~{conds[0] * 2.2e-16:.1e})")
    assert conds[0] > 1e11
    (jres, jl), (tres, tl) = _both_certs(mc_stall, 5)
    assert tl["iters"] == jl["iters"] == 5
    print(f"residuals at five: {tl['resid']:.4e} / {jl['resid']:.4e}")
    # the cluster's Ritz values sit at ~1e-10: held absolutely; the 11th
    # (3.6e-2) to 1e-8 relative, its accuracy at residual 8e-5
    np.testing.assert_allclose(tres.neg_vals.numpy(),
                               np.asarray(jres.neg_vals), rtol=1e-8,
                               atol=1e-13)
    np.testing.assert_allclose(float(tres.lam_min), float(jres.lam_min),
                               rtol=1e-4)
    assert tres.num_neg == int(jres.num_neg)


def test_mc_cert_stalls_in_both_packages(mc_stall):
    """The driver's warm budget from the same inputs: both solvers lose
    the null cluster (bottom Ritz value far above the exact lambda_min ~ 0),
    report no negative Ritz value and a lower bound below -1e-3, so dinf
    stays above the 1e-8 target in both.  Their residuals grow from the
    converging phase's ~1e-6 by orders of magnitude."""
    lam0 = mc_stall["eigs"][0]
    for res, last in _both_certs(mc_stall, 80):
        assert last["iters"] == 80 and last["resid"] > 1e-2
        assert int(res.num_neg) == 0
        assert float(res.neg_vals[0]) > 1e-2
        assert float(res.lam_min) < -1e-3
        assert float(res.lam_min) <= lam0            # still a sound bound


def test_stall_study_at_the_cpu_point(mc_stall, tmp_path):
    """chip_smoke.py's stall study (--capture-stall) at the CPU point: the
    8th outer iteration's warm call, out of budget; the study saves the
    point and re-runs the certificate under the driver's budgets (which
    certify here, through the retry, as the driver did), a single longer
    call and a block of 48, and every lower bound stays below the dense
    eigvalsh's lambda_min."""
    spy, op = mc_stall["spy"], mc_stall["op"]
    out = chip_smoke.stall_study(spy, op, str(tmp_path), long_maxiter=40)
    assert out["captured"] and out["iteration"] == MC_ITER
    saved = np.load(tmp_path / "mc12000_stall.npz")
    assert saved["Y"].shape[1] == saved["X0"].shape[0] == mc_stall["n"]
    warm = out["calls"][0]
    assert warm["iters"] == 80 and warm["resid"] > 1e-2
    assert warm["num_neg"] == 0
    assert out["dinf_exact"] < 1e-8 and out["below_1e_8_scaled"] == 10
    assert [r["label"] for r in out["reruns"]] == [
        "driver", "maxiter_40", "block_cap_48", "block_cap_48_maxiter_40"]
    assert [r["block"] for r in out["reruns"]] == [24, 24, 48, 48]
    assert out["reruns"][0]["certified"]
    lam0 = out["lam_min_exact"]
    for r in out["reruns"]:
        assert all(st["lam_min"] <= lam0 + 1e-12 for st in r["steps"])
