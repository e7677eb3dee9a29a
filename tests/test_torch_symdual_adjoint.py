"""K8's adjoint as a gather: every entry of W = adjoint(y) is one element
of the flat y = (y0, y1, Y2, Y3, Y4), so torch.take(y_flat, cls) with the
class-index map cls (the twin run on y_flat = arange) is W exactly, and
neither the twin nor the JAX where-chain reads a don't-care slot of y
(NaN there leaves W finite and unchanged).  chip_smoke.py times the same
torch.take on the card as K8's library yardstick."""

import jax.numpy as jnp
import numpy as np
import pytest
import threadpoolctl
import torch

from manisdp_tpu.ops import symdual as jsd
from manisdp_tpu_torch import kernels as K
from manisdp_tpu_torch.ops import symdual as tsd


@pytest.fixture(autouse=True, scope="module")
def _one_cpu_thread():
    """Torch and BLAS on one thread for this module: the parallel test run
    puts several workers on the CPU, and their thread pools then
    oversubscribe it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpoolctl.threadpool_limits(1):
        yield
    torch.set_num_threads(n)


def _flat_length(q):
    return 1 + q + q * q + q ** 3 + q ** 4


def _flat_y(q, seed):
    y = np.random.default_rng(seed).standard_normal(_flat_length(q))
    y[tsd._dontcare_mask(q)] = np.nan
    return y


def _class_map(q):
    """The int64 (n~, n~) map from an entry of W to its slot of y_flat:
    the twin on y_flat = arange, exact in f64 (the length is < 2^53)."""
    idx = torch.arange(_flat_length(q), dtype=torch.float64)
    return K.symdual_adjoint_plain(tsd._split(idx, q), q).long()


@pytest.mark.parametrize("q", [3, 7, 12])
def test_take_of_the_class_map_is_the_adjoint(q):
    y = _flat_y(q, q)
    cls = _class_map(q)
    n = 2 + q + q * q
    assert cls.shape == (n, n)
    assert not bool(torch.any(torch.as_tensor(
        tsd._dontcare_mask(q))[cls.view(-1)]))
    taken = torch.take(torch.as_tensor(y), cls)
    twin = K.symdual_adjoint_plain(tsd._split(torch.as_tensor(y), q), q)
    jax_w = np.asarray(jsd._adjoint_tensor(*jsd._split(jnp.asarray(y), q),
                                           q))
    assert torch.equal(taken, twin)
    np.testing.assert_array_equal(taken.numpy(), jax_w)
    assert bool(torch.all(torch.isfinite(taken)))


@pytest.mark.parametrize("q", [3, 7, 12])
def test_the_adjoint_never_reads_a_dontcare_slot(q):
    y = _flat_y(q, 100 + q)
    clean = np.where(tsd._dontcare_mask(q), 0.0, y)
    n = 2 + q + q * q
    rng = np.random.default_rng(q)
    B1, B2 = (torch.as_tensor(rng.standard_normal((n, n))) for _ in "12")
    scale = torch.as_tensor(rng.uniform(0.5, 2.0, 5))
    for kw in ({}, dict(scale=scale),
               dict(B1=B1, c1=-1.0, B2=B2, c2=-1.0 / 0.37)):
        got = K.symdual_adjoint(tsd._split(torch.as_tensor(y), q), q, **kw)
        ref = K.symdual_adjoint(tsd._split(torch.as_tensor(clean), q), q,
                                **kw)
        assert bool(torch.all(torch.isfinite(got)))
        assert torch.equal(got, ref)
    jax_nan = np.asarray(jsd._adjoint_tensor(*jsd._split(jnp.asarray(y), q),
                                             q))
    jax_clean = np.asarray(jsd._adjoint_tensor(
        *jsd._split(jnp.asarray(clean), q), q))
    assert np.all(np.isfinite(jax_nan))
    np.testing.assert_array_equal(jax_nan, jax_clean)
