"""The rank-1 stall of the BQP SOS dual in the original basis (ROADMAP
Queue C), pinned on the CPU in both packages.

A truncation that leaves the factor at p = 1 without renormalizing its
columns puts them ~1e-7 off the unit sphere.  The p = 1 oblique manifold
has no tangent directions, so the RTR cannot move, pinf stays near 1e-7
and the solve never certifies.  The state is built from a small SOS
dual's own multipliers and sigma at its last checkpoint before
convergence, with a p = 1 factor (the signs of the factor's principal row)
whose columns are off the sphere by up to 1e-7.  Both packages'
``solve_dual_unitdiag`` resume from it and stay stuck above tol: the fault
is inherited from the JAX driver (its truncation and escape floor), whose
repair lies outside the port."""

import numpy as np
import pytest
import threadpoolctl
import torch

from manisdp_tpu import solve_dual_unitdiag as j_dual_unitdiag
from manisdp_tpu_torch import solve_dual_unitdiag
from manisdp_tpu_torch.frontends.sos import assemble_bqpsos
from manisdp_tpu_torch.utils.checkpoint import load_state, save_state


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


def test_rank_one_stall_is_inherited(tmp_path):
    q = 6
    rs = np.random.RandomState(1)
    Q = rs.randn(q, q)
    A, b, c, n, f, dAAt = assemble_bqpsos(0.5 * (Q + Q.T), rs.randn(q), q)
    b = b / np.max(np.abs(b))
    kw = dict(f=f, dAAt=dAAt, line_search=True, verbose=False)
    ck = str(tmp_path / "run.npz")
    full = solve_dual_unitdiag(A, b, c, n, device="cpu", checkpoint_every=1,
                               checkpoint_path=ck, **kw)
    assert full.status == 0
    st = load_state(ck)
    # the p = 1 factor: the principal row's signs, columns off the sphere
    # by up to 1e-7
    vt = np.linalg.svd(st["Y"], full_matrices=False)[2]
    off = 1e-7 * np.random.RandomState(0).uniform(-1.0, 1.0, n)
    stalled = str(tmp_path / "stalled.npz")
    save_state(stalled, Y=np.sign(vt[:1]) * (1.0 + off), Xm=st["Xm"],
               w=st["w"], sigma=st["sigma"], iteration=st["iteration"])
    tol = 1e-8
    rt = solve_dual_unitdiag(A, b, c, n, device="cpu", resume=stalled,
                             max_outer=8, tol=tol, **kw)
    rj = j_dual_unitdiag(A, b, c, n, resume=stalled, max_outer=8, tol=tol,
                         **kw)
    for res in (rt, rj):
        assert res.status != 0
        assert res.fac_size == [1] * 8           # the rank never grows
        assert res.pinf > 10 * tol               # pinf stuck above tol
        assert res.gap < tol and res.dinf < tol  # pinf the lone blocker
    np.testing.assert_allclose(rt.pinf, rj.pinf, rtol=1e-6)
