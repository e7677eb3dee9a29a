"""RTR + tCG of the port against the JAX package's, on the MaxCut problem
with the same (Y0, C, typicaldist), through the sparse (K1 twin) and the
dense cost."""

import jax
import numpy as np
import pytest
import torch

from manisdp_tpu.core import TROptions as JTROptions
from manisdp_tpu.core import make_trustregions as j_make
from manisdp_tpu.ops.sparse import SymCOO as JSymCOO
from manisdp_tpu.solvers.maxcut import make_maxcut_problem as j_problem
from manisdp_tpu_torch.convert import symcoo_from_arrays
from manisdp_tpu_torch.core import TROptions, make_trustregions
from manisdp_tpu_torch.solvers.maxcut import make_maxcut_problem
from test_maxcut import random_graph_cost

N = 80


@pytest.fixture(scope="module")
def case():
    C = random_graph_cost(N, 400, seed=4)
    jC = JSymCOO.from_scipy(0.5 * (C + C.T))
    tC = symcoo_from_arrays(np.asarray(jC.i), np.asarray(jC.j),
                            np.asarray(jC.v), N, "cpu")
    rs = np.random.RandomState(0)
    Y0 = rs.randn(8, N)
    Y0[6:] = 0.0                       # two zero padding rows
    Y0 /= np.linalg.norm(Y0, axis=0)
    return jC, tC, Y0, float(np.pi * np.sqrt(N))


def _solve_both(case, dense, tcg_dtype):
    jC, tC, Y0, td = case
    kw = dict(maxiter=40, maxinner=100, tolgradnorm=1e-8,
              tcg_dtype=tcg_dtype)
    jsolve = jax.jit(j_make(j_problem(dense), JTROptions(**kw)))
    jres = jsolve(jax.numpy.asarray(Y0), jC.to_dense() if dense else jC, td)
    tsolve = make_trustregions(make_maxcut_problem(dense), TROptions(**kw))
    tres = tsolve(torch.from_numpy(Y0.copy()),
                  tC.to_dense() if dense else tC, td)
    return jres, tres


@pytest.mark.parametrize("dense", [False, True])
def test_f64_solve_matches_jax(case, dense):
    """Same arithmetic up to summation order: identical TR and tCG
    iteration counts, Y to 1e-10."""
    jres, tres = _solve_both(case, dense, None)
    assert tres.iters == int(jres.iters)
    assert tres.inner_iters == int(jres.inner_iters)
    np.testing.assert_allclose(tres.Y.numpy(), np.asarray(jres.Y),
                               atol=1e-10)
    np.testing.assert_allclose(float(tres.fx), float(jres.fx), rtol=1e-12)
    assert float(tres.norm_grad) < 1e-8
    assert torch.all(tres.Y[6:] == 0)


def test_tcg32_solve_matches_jax(case):
    """f32 tCG: the Hessian products sum in another order in f32, which
    moves the tCG's stopping iteration by a few (measured 163 vs 166
    Hessian calls), so the trajectories part at f32 noise.  The f64 outer
    loop still drives both to the same critical point: cost to 1e-10
    relative, Y to 1e-5 (measured 8e-7), both below tolgradnorm."""
    jres, tres = _solve_both(case, False, "float32")
    assert tres.Y.dtype == torch.float64
    assert float(tres.norm_grad) < 1e-8 and float(jres.norm_grad) < 1e-8
    np.testing.assert_allclose(float(tres.fx), float(jres.fx), rtol=1e-10)
    np.testing.assert_allclose(tres.Y.numpy(), np.asarray(jres.Y),
                               atol=1e-5)
    assert abs(tres.inner_iters - int(jres.inner_iters)) <= \
        0.1 * int(jres.inner_iters)


class _TimedOutPeer:
    """A peer-mode stand-in: the twin's sum over one rank, and the message
    of a time-out."""
    plain = staticmethod(lambda t: t)

    @staticmethod
    def timeout_message():
        return "K11 peer mode: rank 1 of 2 waited for rank 0 at epoch 7"


@pytest.mark.parametrize("maxinner, peer, where", [
    (10, False, "chunk"), (10, True, "chunk"), (3, True, "end")])
def test_tcg_raises_on_the_peer_time_out_code(case, monkeypatch, maxinner,
                                              peer, where):
    """A step that returns K11's peer-mode time-out code (a peer's flag
    never came) makes the tCG loop raise where it reads the stop codes on
    the host: at the chunk read (iteration _TCG_CHUNK), and in peer mode
    after the loop when it ends first; with a peer the message is the
    peer's (rank and epoch).  No extra read per step."""
    import dataclasses

    from manisdp_tpu_torch import kernels as K
    from manisdp_tpu_torch.core import trustregions as T
    from manisdp_tpu_torch.manifolds import Oblique
    _, tC, Y0, td = case
    steps = []

    def timed_out(*args, **kw):
        steps.append(kw.get("peer"))
        out = list(K.tcg_step(*args, **kw))
        out[5] = out[5].clone()
        out[5][:, 1] = K.TCG_TIMEOUT_STOP
        return tuple(out)

    monkeypatch.setattr(T, "tcg_step", timed_out)
    problem = make_maxcut_problem(True)
    if peer:
        manifold = type("PeerOblique", (Oblique,),
                        {"peer": _TimedOutPeer()})
        problem = dataclasses.replace(problem, manifold=manifold)
    solve = make_trustregions(problem, TROptions(maxiter=2,
                                                 maxinner=maxinner))
    match = "epoch 7" if peer else f"stop code {K.TCG_TIMEOUT_STOP}"
    with pytest.raises(RuntimeError, match=match):
        solve(torch.from_numpy(Y0.copy()), tC.to_dense(), td)
    assert len(steps) == (T._TCG_CHUNK if where == "chunk" else maxinner)
    assert all((s is not None) == peer for s in steps)
