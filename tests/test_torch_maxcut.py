"""End-to-end MaxCut solves of the port on the CPU (plain twins), checked
by the external KKT oracle of tests/test_maxcut.py and against the JAX
package's optimum from the same explicit Y0."""

import numpy as np
import pytest
import threadpoolctl
import torch

from manisdp_tpu import solve_maxcut_unitdiag as j_solve
from manisdp_tpu_torch import SolverOptions, solve_maxcut_unitdiag
from manisdp_tpu_torch.utils.checkpoint import resume_kwargs
from test_maxcut import kkt_oracle, random_graph_cost


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


def _y0(p, n, seed):
    Y = np.random.RandomState(seed).randn(p, n)
    return Y / np.linalg.norm(Y, axis=0)


def _solve(C, **kw):
    return solve_maxcut_unitdiag(C, device="cpu", verbose=False, **kw)


@pytest.mark.parametrize("n,m,seed,kw", [
    (60, 300, 0, dict(eig_method="eigh")),          # test_maxcut_small_eigh
    (80, 400, 1, dict(eig_method="lobpcg")),        # ..._lobpcg_matches_eigh
    (50, 200, 2, dict(line_search=True)),           # ..._line_search_path
], ids=["small_eigh", "lobpcg_devrr", "line_search"])
def test_maxcut_matches_jax(n, m, seed, kw):
    C = random_graph_cost(n, m, seed=seed)
    Y0 = _y0(2, n, seed)
    res = _solve(C, Y0=Y0, **kw)
    eta, obj = kkt_oracle(C.toarray(), res, 1e-8)
    assert res.status == 0
    assert eta < 1e-8
    np.testing.assert_allclose(obj, res.obj, rtol=1e-10)
    ref = j_solve(C, verbose=False, Y0=Y0, eig_method="eigh")
    np.testing.assert_allclose(res.obj, ref.obj, rtol=1e-7)


def test_maxcut_warm_start():
    C = random_graph_cost(40, 150, seed=3)
    Y0 = _y0(2, 40, 3)
    res1 = _solve(C, Y0=Y0)
    res2 = _solve(C, Y0=res1.Y)
    assert res2.iterations <= res1.iterations
    assert res2.status == 0
    ref = j_solve(C, verbose=False, Y0=Y0)
    np.testing.assert_allclose(res2.obj, ref.obj, rtol=1e-7)


def test_forced_sparse_path_runs_the_slice(monkeypatch):
    """The G67 path at small n: sparse cost through K1's twin, f32 tCG,
    the device LOBPCG certificate.  The warm call's bound is weakened by
    1e-3, which makes accuracy decide convergence, so the driver must run
    the big-block linear-bound retry and certify with it."""
    from manisdp_tpu_torch.ops import eigs_rr
    calls = []
    real = eigs_rr.DeviceCertSolver.solve

    def spy(self, *a, **k):
        res = real(self, *a, **k)
        calls.append((self.bound, self.b))
        if self.bound == "kato":
            res = res._replace(lam_min=res.lam_min - 1e-3)
        return res

    monkeypatch.setattr(eigs_rr.DeviceCertSolver, "solve", spy)
    n = 300
    C = random_graph_cost(n, 1200, seed=6)
    opts = dict(dense_cost_max_n=0, dense_cost_nnz_factor=0, eig_switch_n=0)
    res = _solve(C, Y0=_y0(8, n, 6), **opts)
    eta, obj = kkt_oracle(C.toarray(), res, 1e-8)
    assert res.status == 0 and eta < 1e-8
    # warm call (k + 15 deflation rows), then the retry: block k + p_act
    assert calls[:2] == [("kato", 24), ("linear", 9 + res.fac_size[-1])]
    ref = _solve(C, Y0=_y0(8, n, 6), eig_method="eigh",
                 inner_dtype="float64")
    np.testing.assert_allclose(res.obj, ref.obj, rtol=1e-7)


def test_checkpoint_and_resume(tmp_path):
    C = random_graph_cost(40, 150, seed=7)
    path = str(tmp_path / "ck.npz")
    first = _solve(C, Y0=_y0(2, 40, 7), checkpoint_every=1,
                   checkpoint_path=path, max_outer=1)
    assert first.status == 1                 # stopped by max_outer
    Yck = resume_kwargs(path)["Y0"]
    assert Yck.shape[1] == 40
    res = _solve(C, resume=path)
    assert res.status == 0
    full = _solve(C, Y0=_y0(2, 40, 7))
    np.testing.assert_allclose(res.obj, full.obj, rtol=1e-7)


def test_cuda_without_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        solve_maxcut_unitdiag(random_graph_cost(20, 40, seed=0),
                              verbose=False)


@pytest.mark.parametrize("kw,name", [
    (dict(inner_dtype="mixed"), "inner_dtype='mixed'"),
    (dict(eig_method="lobpcg", cert_method="lobpcg"), "cert_method='lobpcg'"),
    (dict(eig_method="lobpcg", cert_pre_dtype="float32"),
     "cert_pre_dtype='float32'"),
])
def test_unported_options_raise(kw, name):
    """These options raised NotImplementedError before the port had them
    (the name is kept); each now runs, certifies by the external oracle and
    reaches the JAX package's optimum from the same Y0."""
    C = random_graph_cost(80, 400, seed=1)
    Y0 = _y0(2, 80, 1)
    res = _solve(C, Y0=Y0, **kw)
    assert res.status == 0 and kkt_oracle(C.toarray(), res, 1e-8)[0] < 1e-8
    ref = j_solve(C, verbose=False, Y0=Y0, **kw)
    assert ref.status == 0
    np.testing.assert_allclose(res.obj, ref.obj, rtol=1e-7)


@pytest.mark.parametrize("kw", [
    dict(cert_method="lobpcg", cert_pre_dtype="float32"),
    dict(cert_method="rowrr"),
    dict(cert_method="rowrr", cert_pre_dtype="float64"),
    dict(cert_method="lobpcg", dense_cost_max_n=0, dense_cost_nnz_factor=0),
    dict(cert_method="lobpcg", cert_pre_dtype="float32", dense_cost_max_n=0,
         dense_cost_nnz_factor=0),
    dict(inner_dtype="mixed", dense_cost_max_n=0, dense_cost_nnz_factor=0),
], ids=["lobpcg_f32", "rowrr_auto_f32", "rowrr_f64", "sparse_lobpcg",
        "sparse_lobpcg_f32", "sparse_mixed"])
def test_certificate_options_match_jax(kw):
    """cert_method="lobpcg" (f64, or f32 bulk iterations at
    cert_pre_dtype="float32") and rowrr with and without its f32 stage, on
    the dense cost and on K1's twin (the sparse cost), and the mixed
    pre-stage on the sparse cost, against the JAX package from the same
    Y0."""
    C = random_graph_cost(90, 450, seed=4)
    Y0 = _y0(3, 90, 4)
    kw = dict(kw, eig_method="lobpcg")
    res = _solve(C, Y0=Y0, **kw)
    assert res.status == 0 and kkt_oracle(C.toarray(), res, 1e-8)[0] < 1e-8
    ref = j_solve(C, verbose=False, Y0=Y0, **kw)
    assert ref.status == 0
    np.testing.assert_allclose(res.obj, ref.obj, rtol=1e-7)


def test_options_object_is_used_as_given():
    C = random_graph_cost(30, 100, seed=8)
    opt = SolverOptions(p0=3, max_outer=1, verbose=False)
    res = solve_maxcut_unitdiag(C, options=opt, device="cpu")
    assert res.fac_size == [3] and res.iterations == 1
