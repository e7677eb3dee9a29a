"""inner_dtype="mixed" (an f32 RTR pre-stage down to mixed_tolgradnorm,
then the f64 solve) in the port's five single-card drivers against the
JAX package's, on the cases of tests/test_mixed_precision.py: both
packages from the same explicit Y0 (the dual multiblock driver takes none
in either package, so each draws its own), the port on the CPU (the
kernels' plain twins).  Both must certify to 1e-8, and the objectives
agree to 1e-7 relative for MaxCut and 1e-6 for the others."""

import numpy as np
import pytest
import scipy.sparse as sp
import threadpoolctl
import torch

import manisdp_tpu as J
from manisdp_tpu.solvers.dual_multiblock import \
    solve_dual_multiblock as j_dual_multiblock
from manisdp_tpu.solvers.multiblock import solve_multiblock as j_multiblock
import manisdp_tpu_torch as T
from manisdp_tpu_torch.frontends.monomials import monomial_basis
from manisdp_tpu_torch.frontends.moments import bqpmom
from manisdp_tpu_torch.frontends.sos import assemble_bqpsos, qssos
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


def _laplacian_cost(n=60, seed=0):
    rs = np.random.RandomState(seed)
    W = np.triu((rs.rand(n, n) < 0.2).astype(np.float64), 1)
    W = W + W.T
    return -(np.diag(W.sum(axis=1)) - W) / 4.0


def _y0(p, n, seed, unit_cols=True):
    Y = np.random.RandomState(seed).randn(p, n)
    return Y / np.linalg.norm(Y, axis=0) if unit_cols else Y


def _bqp(n, seed):
    rs = np.random.RandomState(seed)
    Q = rs.randn(n, n)
    return 0.5 * (Q + Q.T), rs.randn(n)


def _bqp_sos(n, seed):
    return assemble_bqpsos(*_bqp(n, seed), n)


def _agree(tr, jr, rtol):
    assert jr.status == 0 and tr.status == 0
    assert jr.eta < 1e-8 and tr.eta < 1e-8
    assert abs(tr.obj - jr.obj) <= rtol * (1.0 + abs(jr.obj))
    # the f32 stage's iterations count in hess_calls
    assert tr.hess_calls > 0


def _maxcut():
    C = _laplacian_cost()
    Y0 = _y0(8, 60, 1)
    return (J.solve_maxcut_unitdiag(C, Y0=Y0, verbose=False,
                                    inner_dtype="mixed"),
            T.solve_maxcut_unitdiag(C, Y0=Y0, verbose=False, device="cpu",
                                    inner_dtype="mixed"), 1e-7)


def _al():
    d = bqpmom(6, *_bqp(6, 1))
    Y0 = _y0(4, d.K.s, 2)
    kw = dict(Y0=Y0, verbose=False, inner_dtype="mixed")
    return (J.solve_unitdiag(d.At, d.b, d.c, d.K.s, **kw),
            T.solve_unitdiag(d.At, d.b, d.c, d.K.s, device="cpu", **kw),
            1e-6)


def _dual_unitdiag():
    A, b, c, mb, f, dAAt = _bqp_sos(6, 3)
    b = b / np.max(np.abs(b))
    kw = dict(f=f, dAAt=dAAt, line_search=True, verbose=False,
              inner_dtype="mixed", Y0=_y0(3, mb, 4))
    return (J.solve_dual_unitdiag(A, b, c, mb, **kw),
            T.solve_dual_unitdiag(A, b, c, mb, device="cpu", **kw), 1e-6)


def _dual_general():
    rs = np.random.RandomState(4)
    A, b, c, mb, f, dAAt = qssos(4, rs.randn(monomial_basis(4, 4).shape[1]))
    kw = dict(f=f, dAAt=dAAt, verbose=False, inner_dtype="mixed",
              Y0=_y0(3, mb, 5, unit_cols=False))
    return (J.solve_dual_sdp(A, b, c, mb, **kw),
            T.solve_dual_sdp(A, b, c, mb, device="cpu", **kw), 1e-6)


def _multiblock():
    rs = np.random.RandomState(5)
    blocks = []
    for n in (5, 4):
        Q = rs.randn(n, n)
        blocks.append(bqpmom(n, 0.5 * (Q + Q.T), rs.randn(n)))
    At = sp.block_diag([d.At for d in blocks]).tocsc()
    b = np.concatenate([d.b for d in blocks])
    c = np.concatenate([d.c for d in blocks])
    ns = [d.K.s for d in blocks]
    kw = dict(nob=2, verbose=False, sigma0=1e-3, sigma_min=1e-2, tau1=1,
              tau2=1, inner_dtype="mixed", Y0=_y0(2, sum(ns), 6))
    return (j_multiblock(At, b, c, ns=ns, **kw),
            solve_multiblock(At, b, c, ns=ns, device="cpu", **kw), 1e-6)


def _dual_multiblock():
    A, b, c, mb, f, dAAt = _bqp_sos(6, 6)
    kw = dict(ns=[mb], nob=1, f=f, dAAt=dAAt, verbose=False, sigma0=1e-3,
              sigma_min=1e-3, tau1=1e1, tau2=1e2, theta=1e-3, alpha=0.1,
              inner_dtype="mixed")
    b = b / np.max(np.abs(b))
    return (j_dual_multiblock(A, b, c, **kw),
            solve_dual_multiblock(A, b, c, device="cpu", **kw), 1e-6)


@pytest.mark.parametrize("case", [_maxcut, _al, _dual_unitdiag,
                                  _dual_general, _multiblock,
                                  _dual_multiblock],
                         ids=["maxcut", "al_unitdiag", "dual_unitdiag",
                              "dual_general", "multiblock",
                              "dual_multiblock"])
def test_mixed_matches_jax(case):
    jr, tr, rtol = case()
    _agree(tr, jr, rtol)


def test_mixed_runs_the_f32_stage(monkeypatch):
    """The pre-stage takes an f32 factor and its iterations are counted:
    the mixed MaxCut solve's tCG count is its f32 stages' and more."""
    from manisdp_tpu_torch.solvers import common
    seen = []
    real = common.make_trustregions

    def spy(problem, opts):
        solve = real(problem, opts)

        def run(Y0, *a, **k):
            res = solve(Y0, *a, **k)
            seen.append((Y0.dtype, res.inner_iters))
            return res
        return run

    monkeypatch.setattr(common, "make_trustregions", spy)
    _, tr, _ = _maxcut()
    assert seen and all(dt == torch.float32 for dt, _ in seen)
    assert tr.hess_calls > sum(h for _, h in seen) > 0
