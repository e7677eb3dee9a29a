"""The port's lobpcg certificate (``ops/eigs.py:lobpcg_certificate``) and
the f32 stage of its LOBPCG class (``ops/eigs_rr.DeviceCertSolver``)
beside the JAX package's and ``np.linalg.eigvalsh`` on the symmetric
matrix of tests/test_eigs_rr.py: bottom Ritz values within 1e-8 of the
exact ones, a sound lower bound (lam_min <= lambda_min + 1e-9) and an
upper estimate of lambda_max (>= lambda_max - 1e-6), with and without the
f32 stage, with a deflation factor and warm-started."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import threadpoolctl
import torch

from manisdp_tpu.ops.eigs import lobpcg_certificate as j_lobpcg
from manisdp_tpu.ops.eigs_rr import RowCertSolver
from manisdp_tpu_torch.ops.eigs import lobpcg_certificate
from manisdp_tpu_torch.ops.eigs_rr import DeviceCertSolver


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


K = 5


@pytest.fixture(scope="module")
def sym():
    """tests/test_eigs_rr.py's fixture."""
    rs = np.random.RandomState(7)
    n = 300
    A = rs.randn(n, n)
    S = (A + A.T) / 2
    return n, S, np.linalg.eigvalsh(S)


def _gen(seed):
    g = torch.Generator()
    g.manual_seed(seed)
    return g


def _sound(res, ref, atol=1e-8):
    np.testing.assert_allclose(np.asarray(res.neg_vals), ref[:K], atol=atol)
    assert float(res.lam_min) <= ref[0] + 1e-9
    assert float(res.lam_max) >= ref[-1] - 1e-6
    assert int(res.num_neg) <= np.sum(ref < 0)


@pytest.mark.parametrize("f32", [False, True], ids=["f64", "f32_stage"])
@pytest.mark.parametrize("deflate", [False, True], ids=["plain", "deflate"])
def test_lobpcg_certificate_matches_jax_and_eigvalsh(sym, f32, deflate):
    n, S, ref = sym
    St, S32 = torch.from_numpy(S), torch.from_numpy(S).float()
    Sd = jnp.asarray(S)
    Y = np.random.RandomState(3).randn(6, n) if deflate else None
    res = lobpcg_certificate(
        lambda V: V @ St, n, K, _gen(0), deflate=(
            None if Y is None else torch.from_numpy(Y)),
        matvec32=(lambda V: V @ S32) if f32 else None)
    _sound(res, ref)
    jres = j_lobpcg(
        lambda V: Sd @ V, n, K, jax.random.PRNGKey(0),
        deflate=None if Y is None else jnp.asarray(Y),
        matvec32=(lambda V: Sd.astype(jnp.float32) @ V) if f32 else None)
    # the JAX routine's f32 stage stops at its own, looser test, so after
    # its 16 f64 iterations its values can sit ~3e-6 off eigvalsh: the two
    # packages agree to within the JAX values' own error
    j_err = np.max(np.abs(np.asarray(jres.neg_vals) - ref[:K]))
    np.testing.assert_allclose(np.asarray(res.neg_vals),
                               np.asarray(jres.neg_vals),
                               atol=1e-8 + j_err)
    assert float(jres.lam_min) <= ref[0] + 1e-9
    assert int(res.num_neg) == int(jres.num_neg)
    V = res.neg_vecs.numpy()
    assert np.linalg.norm(S @ V[:, 0] - ref[0] * V[:, 0]) < 1e-7


@pytest.mark.parametrize("f32", [False, True], ids=["f64", "f32_stage"])
def test_lobpcg_certificate_warm_start_stays_sound(sym, f32):
    """Warm-started from the previous shift's vectors (with the JAX
    routine's 1e-9 noise) on a short budget."""
    n, S, ref = sym
    X0 = None
    for shift in (0.0, 0.3):
        St = torch.from_numpy(S - shift * np.eye(n))
        S32 = St.float()
        res = lobpcg_certificate(
            lambda V: V @ St, n, K, _gen(1), X0=X0,
            maxiter=400 if X0 is None else 80,
            matvec32=(lambda V: V @ S32) if f32 else None)
        _sound(res, ref - shift)
        X0 = res.neg_vecs


def test_device_solver_f32_stage_stays_sound(sym):
    """The counterpart of test_eigs_rr.py's f32-stage test: the port's
    LOBPCG class with its f32 stage beside RowCertSolver's (held to each
    other at that test's 1e-7), cold and warm."""
    n, S, ref = sym
    Sd = jnp.asarray(S)
    jsolver = RowCertSolver(lambda V, ctx: V @ ctx, n, lambda V, ctx: V @ ctx)
    solver = DeviceCertSolver(n, K, bound="linear")
    X0 = jX0 = None
    for shift in (0.0, 0.3):
        St = torch.from_numpy(S - shift * np.eye(n))
        S32 = St.float()
        res = solver.solve(lambda V: V @ St, _gen(2), X0=X0, maxiter=200,
                           tol=1e-10, matvec32_rows=lambda V: V @ S32)
        ref_t = ref - shift
        _sound(res, ref_t)
        # cold, the f32 stage takes iterations; warm, the start block may
        # already sit below its exit tolerance
        assert solver.last["iters32"] > 0 or X0 is not None
        assert solver.last["iters"] == solver.last["iters32"] + \
            solver.last["iters64"] <= 200
        jres = jsolver.solve(Sd - shift * jnp.eye(n), jax.random.PRNGKey(1),
                             K, X0=jX0, maxiter=200, tol=1e-10)
        np.testing.assert_allclose(np.asarray(res.neg_vals),
                                   np.asarray(jres.neg_vals), atol=1e-7)
        X0, jX0 = res.neg_vecs, jres.neg_vecs


def test_f32_stage_budget_is_shared_or_split(sym):
    """Without refine_iters the stages share maxiter; with it the f64
    stage has a budget of its own, after all of maxiter in f32."""
    n, S, ref = sym
    St = torch.from_numpy(S)
    S32 = St.float()
    solver = DeviceCertSolver(n, K, bound="linear")
    solver.solve(lambda V: V @ St, _gen(3), maxiter=6, tol=1e-10,
                 matvec32_rows=lambda V: V @ S32)
    assert (solver.last["iters32"], solver.last["iters64"]) == (6, 0)
    res = solver.solve(lambda V: V @ St, _gen(3), maxiter=6, tol=1e-10,
                       matvec32_rows=lambda V: V @ S32, refine_iters=4)
    assert (solver.last["iters32"], solver.last["iters64"]) == (6, 4)
    # an unconverged run is reported with the f64 residual bound
    assert float(res.lam_min) <= ref[0] + 1e-9


def test_non_finite_f32_step_drops_into_f64(sym):
    """An f32 operator that returns NaN ends the f32 stage at once (the
    guard keeps the seeded block); the f64 stage still converges."""
    n, S, ref = sym
    St = torch.from_numpy(S)
    solver = DeviceCertSolver(n, K, bound="linear")
    res = solver.solve(lambda V: V @ St, _gen(4), maxiter=300, tol=1e-10,
                       matvec32_rows=lambda V: torch.full_like(V, np.nan))
    assert solver.last["iters32"] == 0 and solver.last["iters64"] > 0
    _sound(res, ref)


@pytest.mark.parametrize("bound", ["linear", "kato"])
def test_breakdown_does_not_certify(monkeypatch, bound):
    """A block that loses the bottom of the spectrum mid-run (the carried
    products drift once the residuals fall below their rounding; exact
    LOBPCG's Ritz values never rise) must not certify a point the start
    block already showed to be uncertified.  Here the iteration is replaced
    by one that ends on the top of the spectrum: its linear bound would
    claim lambda_min > 0 (the dense-carrier lobpcg certificate's false
    status 0, ROADMAP Queue C); the start block's bounds are reported."""
    rs = np.random.RandomState(3)
    n, k = 40, 3
    Q, _ = np.linalg.qr(rs.randn(n, n))
    w = np.concatenate([[-1e-3], np.linspace(0.5, 10.0, n - 1)])
    S = torch.from_numpy((Q * w) @ Q.T)
    X0 = torch.from_numpy(Q[:, :k] + 1e-3 * rs.randn(n, k))

    def lost(self, mv, X, AX, P, AP, theta, rn, j, last, *args, **kw):
        top = torch.from_numpy(Q[:, n - self.b:].T.copy())
        return top, mv(top), P, AP, theta, rn, last

    solver = DeviceCertSolver(n, k, bound=bound)
    healthy = solver.solve(lambda V: V @ S, _gen(0), X0=X0, maxiter=50,
                           tol=1e-10)
    assert abs(float(healthy.neg_vals[0]) - w[0]) < 1e-10
    assert not solver.last.get("breakdown")
    monkeypatch.setattr(DeviceCertSolver, "_iterate", lost)
    res = solver.solve(lambda V: V @ S, _gen(0), X0=X0, maxiter=5,
                       tol=1e-10)
    assert float(res.lam_min) <= w[0]
    assert float(res.neg_vals[0]) < 0
    assert solver.last["breakdown"]
