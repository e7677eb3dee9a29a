"""The port's SeDuMi dispatcher against the JAX package's: one PSD block goes
to the general driver (the same answer as solve_sdp, and STLS through the
dispatcher reaches the JAX optimum); an LP cone or several blocks raise,
naming the multiblock driver the port does not have yet."""

import dataclasses
import inspect

import numpy as np
import pytest

from manisdp_tpu.solvers.dispatch import solve_sedumi as j_sedumi
from manisdp_tpu_torch import recipes, solve_sdp, solve_sedumi
from manisdp_tpu_torch.frontends.sedumi import Cone
from manisdp_tpu_torch.frontends.stls import (extract_solution,
                                              nearest_hankel_sdp,
                                              stls_objective)
from manisdp_tpu_torch.frontends.workloads import matrix_completion


def test_signature_is_the_jax_one_plus_device():
    jp = list(inspect.signature(j_sedumi).parameters)
    tp = list(inspect.signature(solve_sedumi).parameters)
    assert tp == jp[:-1] + ["device"] + jp[-1:]


def test_one_block_equals_solve_sdp():
    data, _ = matrix_completion(15, 15, rank=2, m_samples=200, seed=1)
    n = data.K.s
    Y0 = np.random.RandomState(3).randn(1, n)
    kw = dict(verbose=False, max_outer=200)
    res = solve_sedumi(data, Y0=Y0, device="cpu", **kw)
    ref = solve_sdp(data.At, data.b, data.c, n, Y0=Y0, device="cpu", **kw)
    assert res.status == 0 and res.obj == ref.obj
    assert res.iterations == ref.iterations
    np.testing.assert_array_equal(res.y, ref.y)
    # K.s given as a one-element list is the same single block
    data_l = dataclasses.replace(data, K=Cone(s=[n]))
    assert solve_sedumi(data_l, Y0=Y0, device="cpu", **kw).obj == ref.obj


@pytest.mark.parametrize("K", [Cone(l=2, s=[4]), Cone(s=[3, 4]),
                               Cone(l=1, s=[2, 3])])
def test_lp_cone_or_multiblock_raises(K):
    data, _ = matrix_completion(2, 2, rank=1, m_samples=4, seed=0)
    data = dataclasses.replace(data, K=K)
    with pytest.raises(NotImplementedError, match="multiblock driver"):
        solve_sedumi(data, device="cpu", verbose=False)


def test_stls_through_the_dispatcher_matches_jax():
    """tests/test_stls.py's instance (n1 = n2 = 4) through solve_sedumi on
    both packages from the same Y0: the same optimum, and a rank-one point
    extracted from the port's X that is feasible."""
    n1 = n2 = 4
    u1 = np.random.RandomState(1).randn(n1 + n2 - 1)
    data = nearest_hankel_sdp(u1, n1, n2)
    _, kw = recipes.recipe("stls")
    kw = dict(kw, verbose=False, max_outer=500)
    Y0 = np.random.RandomState(2).randn(1, data.K.s)
    res = solve_sedumi(data, Y0=Y0, device="cpu", **kw)
    ref = j_sedumi(data, Y0=Y0, **kw)
    assert res.status == 0 and ref.status == 0 and res.eta < 1e-8
    assert res.iterations == ref.iterations
    np.testing.assert_allclose(res.obj, ref.obj, rtol=1e-6)
    val = stls_objective(res.obj, u1)
    u, _, resid = extract_solution(res.X, n1, n2)
    assert resid < 1e-5
    np.testing.assert_allclose(np.sum((u - u1) ** 2), val, rtol=1e-5,
                               atol=1e-7)
