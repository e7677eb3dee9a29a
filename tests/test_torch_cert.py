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
