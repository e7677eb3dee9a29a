"""The port's drivers on the CPU against the in-repo interior-point method
(the port's copy of utils/ipm.py), an oracle independent of both
packages: the three IPM cross-checks of tests/test_cross_validation.py
(MaxCut, the BQP moment relaxation, the Lovasz theta of C5) at their
tolerances."""

import numpy as np
import pytest
import scipy.sparse as sp
import threadpoolctl
import torch

from manisdp_tpu_torch import (solve_maxcut_unitdiag, solve_unitdiag,
                               solve_unittrace)
from manisdp_tpu_torch.frontends.moments import bqpmom
from manisdp_tpu_torch.utils.ipm import solve_sdp_ipm


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


def _diag_constraints(n):
    rows = np.arange(n) * n + np.arange(n)
    At = sp.coo_matrix((np.ones(n), (rows, np.arange(n))),
                       shape=(n * n, n)).tocsc()
    return At, np.ones(n)


@pytest.mark.parametrize("kw", [{}, dict(inner_dtype="mixed")],
                         ids=["default", "mixed"])
def test_maxcut_vs_ipm(kw):
    n = 12
    rs = np.random.RandomState(2)
    B = rs.randn(n, n)
    C = 0.5 * (B + B.T)
    np.fill_diagonal(C, 0.0)
    At, b = _diag_constraints(n)

    res = solve_maxcut_unitdiag(C, **CPU, **kw)
    ipm = solve_sdp_ipm(At, b, C.reshape(-1, order="F"), n)
    assert res.status == 0 and ipm.gap < 1e-9
    np.testing.assert_allclose(res.obj, ipm.obj, rtol=1e-7, atol=1e-7)


@pytest.mark.parametrize("kw", [{}, dict(inner_dtype="mixed")],
                         ids=["default", "mixed"])
def test_bqp_moment_vs_ipm(kw):
    n = 5
    rs = np.random.RandomState(4)
    Q = rs.randn(n, n)
    Q = 0.5 * (Q + Q.T)
    e = rs.randn(n)
    d = bqpmom(n, Q, e)

    res = solve_unitdiag(d.At, d.b, d.c, d.K.s, **CPU, **kw)
    ipm = solve_sdp_ipm(d.At, d.b, d.c, d.K.s, tol=1e-10)
    assert res.status == 0 and ipm.gap < 1e-9
    np.testing.assert_allclose(res.obj, ipm.obj, rtol=1e-6, atol=1e-7)
    # and the duals agree through the common KKT metric
    assert ipm.pinf < 1e-9 and res.pinf < 1e-8


def test_theta_vs_ipm():
    """Lovasz theta of C5 through three independent routes: the port's
    sphere-manifold driver, the IPM, and the closed form sqrt(5)."""
    n, edges = 5, [(0, 1), (1, 2), (2, 3), (3, 4), (0, 4)]
    m = len(edges)
    ei = np.array([e[0] for e in edges])
    ej = np.array([e[1] for e in edges])
    rows = np.concatenate([ei * n + ej, ej * n + ei,
                           np.arange(n) * n + np.arange(n)])
    cols = np.concatenate([np.arange(m), np.arange(m), np.full(n, m)])
    At = sp.coo_matrix(
        (np.concatenate([np.ones(2 * m), np.ones(n)]), (rows, cols)),
        shape=(n * n, m + 1)).tocsc()
    b = np.zeros(m + 1)
    b[m] = 1.0
    c = -np.ones(n * n)

    ipm = solve_sdp_ipm(At, b, c, n)
    np.testing.assert_allclose(-ipm.obj, np.sqrt(5.0), rtol=1e-8)

    res = solve_unittrace(At[:, :m], b[:m], c, n, max_outer=500, **CPU)
    assert res.status == 0
    np.testing.assert_allclose(res.obj, ipm.obj, rtol=1e-7)
