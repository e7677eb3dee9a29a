"""The port's twin of tests/test_sanitizers.py: one outer iteration of each
driver family is finite, and a repeated solve is bitwise repeatable
(every reduction the drivers reach sums in a fixed order: on the card no
float atomics, here the CPU twins).  The card halves of the determinism
checks are the ``cuda`` tests at the end.

    python -m pytest --noconftest -m cuda tests/test_torch_sanitizers.py
"""

import contextlib

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from manisdp_tpu_torch import (solve_dual_unitdiag, solve_maxcut_batch,
                               solve_maxcut_unitdiag, solve_unitdiag)
from manisdp_tpu_torch.frontends.moments import bqpmom
from manisdp_tpu_torch.frontends.sos import assemble_bqpsos
from manisdp_tpu_torch.solvers.multiblock import solve_multiblock


@pytest.fixture(autouse=True, scope="module")
def _one_cpu_thread():
    """Torch and BLAS on one thread for this module: the parallel test run
    puts several workers on the CPU, and their thread pools then
    oversubscribe it, so the solvers' many small ops and LAPACK calls spin
    (a 1 s multiblock solve took minutes).  The card's machine may lack
    threadpoolctl; the torch setting then suffices there."""
    try:
        import threadpoolctl
        limits = threadpoolctl.threadpool_limits(1)
    except ImportError:
        limits = contextlib.nullcontext()
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with limits:
        yield
    torch.set_num_threads(n)


def _bqp(n=6, seed=0):
    rs = np.random.RandomState(seed)
    Q = rs.randn(n, n)
    Q = 0.5 * (Q + Q.T)
    return Q, rs.randn(n)


def _maxcut_C(n=20, seed=1):
    rs = np.random.RandomState(seed)
    W = sp.random(n, n, density=0.3, random_state=rs)
    W = W + W.T
    L = sp.diags(np.asarray(W.sum(axis=1)).ravel()) - W
    return (-L / 4).tocoo()


def _two_blocks():
    """Two BQP moment blocks (tests/test_multiblock.py's data)."""
    rs = np.random.RandomState(0)
    data = []
    for n in (5, 4):
        Q = rs.randn(n, n)
        data.append(bqpmom(n, 0.5 * (Q + Q.T), rs.randn(n)))
    At = sp.block_diag([d.At for d in data]).tocsc()
    return (At, np.concatenate([d.b for d in data]),
            np.concatenate([d.c for d in data]), [d.K.s for d in data])


def _maxcut(device="cpu", **kw):
    return solve_maxcut_unitdiag(_maxcut_C(24, 2), verbose=False,
                                 device=device, **kw)


def _primal_al(device="cpu", **kw):
    d = bqpmom(6, *_bqp())
    return solve_unitdiag(d.At, d.b, d.c, d.K.s, verbose=False,
                          device=device, **kw)


def _dual_al(device="cpu", **kw):
    A, b, c, mb, f, dAAt = assemble_bqpsos(*_bqp(), 6)
    return solve_dual_unitdiag(A, b / np.max(np.abs(b)), c, mb, f=f,
                               dAAt=dAAt, verbose=False, device=device, **kw)


def _multiblock(device="cpu", **kw):
    At, b, c, ns = _two_blocks()
    return solve_multiblock(At, b, c, ns=ns, nob=2, verbose=False,
                            sigma0=1e-3, sigma_min=1e-2, tau1=1, tau2=1,
                            device=device, **kw)


def _batch(device="cpu", **kw):
    Cs = [_maxcut_C(20, 3), _maxcut_C(26, 4).toarray()]
    return solve_maxcut_batch(Cs, n_bucket=32, verbose=False, device=device,
                              **kw)


FAMILIES = [_maxcut, _primal_al, _dual_al, _multiblock, _batch]
IDS = ["maxcut", "primal_al", "dual_al", "multiblock", "batch"]


def _results(res):
    return res if isinstance(res, list) else [res]


@pytest.mark.parametrize("run", FAMILIES, ids=IDS)
def test_one_iteration_finite(run):
    for res in _results(run(max_outer=1)):
        assert np.isfinite(res.obj)
        Ys = res.Y if isinstance(res.Y, list) else [res.Y]
        assert all(np.all(np.isfinite(Y)) for Y in Ys)


def _assert_same(r1, r2):
    for a, b in zip(_results(r1), _results(r2)):
        assert a.obj == b.obj
        assert a.iterations == b.iterations
        assert a.hess_calls == b.hess_calls
        assert len(a.history) == len(b.history)
        for h1, h2 in zip(a.history, b.history):
            assert h1 == h2


@pytest.mark.parametrize("run", FAMILIES, ids=IDS)
def test_full_solve_deterministic(run):
    """Same seed, same input: bitwise the same trajectory."""
    _assert_same(run(), run())


# ---------------------------------------------------------------- card --

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_multiblock_solve_repeats_on_card(cuda_device):
    """A clique-chain multiblock solve, twice on one card: equal histories
    (z from K1's cost epilogue, no atomics)."""
    from manisdp_tpu_torch.frontends.sparse_moments import (
        bqpmom_sparse, clique_chain, sparse_objective_basis)
    n, cliques = clique_chain(4, 6)
    nsp = sparse_objective_basis(n, cliques)
    coe = np.random.RandomState(1).randn((~np.all(nsp == 0, 0)).sum())
    data = bqpmom_sparse(n, cliques, coe)

    def run():
        return solve_multiblock(data.At, data.b, data.c, ns=data.K.s,
                                nob=data.K.nob, line_search=True, tau1=1.0,
                                verbose=False, device=cuda_device)
    r1, r2 = run(), run()
    assert r1.status == 0
    _assert_same(r1, r2)


@pytest.mark.cuda
@pytest.mark.parametrize("run", [_maxcut, _batch], ids=["maxcut", "batch"])
def test_maxcut_solves_repeat_on_card(cuda_device, run):
    r1, r2 = run(cuda_device), run(cuda_device)
    assert all(r.status == 0 for r in _results(r1))
    _assert_same(r1, r2)
