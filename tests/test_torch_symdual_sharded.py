"""The port's row-sharded SOS-dual operator (manisdp_tpu_torch/parallel/
symdual_sharded.py) against tests/test_symdual_sharded.py's checks: the
JAX ShardedSymDualOp on the first D devices of the virtual CPU mesh and
the single-device operator (ops/symdual.py _apply_tensor /
_adjoint_tensor) of the JAX package, on the same numpy inputs.

Four ranks on gloo (``parallel.spawn_ranks``, one thread each) run every
rank-side job in one spawn (``tests/_torch_rank_workers.py``): q = 12 and
8 on the model axis of all four ranks (D = 4), q = 6 on the model axis of
a (2, 2) (batch, model) mesh (D = 2).  On CPU tensors the operator runs
the row-block kernels' plain twins, with the same collectives."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import threadpoolctl
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

import _torch_rank_workers as W
from manisdp_tpu.ops import symdual as jsymdual
from manisdp_tpu.parallel.symdual_sharded import ShardedSymDualOp as JOp
from manisdp_tpu_torch.parallel import spawn_ranks

WORLD = 4
# (q, D, the mesh the ranks put D on)
CASES = {(12, 4): "model", (8, 4): "model", (6, 2): "2d"}


@pytest.fixture(autouse=True, scope="module")
def _one_cpu_thread():
    """Torch and BLAS on one thread for this module (the ranks get one
    thread each from spawn_ranks)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpoolctl.threadpool_limits(1):
        yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def inputs(q):
    """test_symdual_sharded.py's inputs: a symmetric M (seed 0) and a
    per-degree tuple y (seed 1)."""
    n = 2 + q + q * q
    rng = np.random.default_rng(0)
    M = rng.standard_normal((n, n))
    M = M + M.T
    rng = np.random.default_rng(1)
    y = (np.asarray(rng.standard_normal()), rng.standard_normal(q),
         rng.standard_normal((q, q)), rng.standard_normal((q, q, q)),
         rng.standard_normal((q, q, q, q)))
    return M, y


@pytest.fixture(scope="module")
def ranks():
    jobs = []
    for mesh in ("model", "2d"):
        cases = [(q, *inputs(q)) for (q, _), m in CASES.items() if m == mesh]
        jobs.append((mesh, "symdual_sharded", dict(cases=cases, mesh=mesh)))
    return spawn_ranks(W.run_jobs, WORLD, "gloo", "cpu", args=(jobs,),
                       threads=1)


def case(ranks, q, D):
    """Rank 0's result for q and the D ranks of its model axis (the
    first D ranks on either mesh), in axis order."""
    mesh = CASES[(q, D)]
    per = [next(c for c in r[mesh]["result"] if isinstance(c, dict) and
                c["q"] == q) for r in ranks[:D]]
    assert [p["rows"] for p in per] == [(k * q // D, (k + 1) * q // D)
                                        for k in range(D)]
    return per


def _mesh(D):
    devs = jax.devices()
    if len(devs) < D:
        pytest.skip(f"needs {D} virtual devices")
    return Mesh(np.array(devs[:D]), ("model",))


def _distinct_masks(q):
    ii = np.arange(q)
    m2 = ii[:, None] != ii[None, :]
    i3, j3, k3 = np.meshgrid(ii, ii, ii, indexing="ij")
    m3 = (i3 != j3) & (i3 != k3) & (j3 != k3)
    i4, j4, k4, l4 = np.meshgrid(ii, ii, ii, ii, indexing="ij")
    m4 = ((i4 != j4) & (i4 != k4) & (i4 != l4)
          & (j4 != k4) & (j4 != l4) & (k4 != l4))
    return m2, m3, m4


def _check_distinct(got, ref, q, rtol):
    """test_symdual_sharded.py's comparison: y0, y1 entirely, Y2 .. Y4 on
    their distinct-index slots."""
    m2, m3, m4 = _distinct_masks(q)
    np.testing.assert_allclose(float(got[0]), float(ref[0]), rtol=rtol)
    np.testing.assert_allclose(np.asarray(got[1]), np.asarray(ref[1]),
                               rtol=rtol, atol=rtol)
    for g, r, m in [(got[2], ref[2], m2), (got[3], ref[3], m3),
                    (got[4], ref[4], m4)]:
        np.testing.assert_allclose(np.asarray(g)[m], np.asarray(r)[m],
                                   rtol=rtol, atol=rtol)


def _assembled_apply(per):
    """y0 .. Y3 of the first rank and Y4 joined over the axis's ranks."""
    a = per[0]["apply"]
    return a[:4] + [np.concatenate([p["apply"][4] for p in per])]


@pytest.mark.parametrize("q,D", list(CASES))
def test_apply_matches_jax(ranks, q, D):
    """The port's sharded apply over D ranks against the JAX sharded apply
    on D virtual devices and against the JAX single-device operator, on
    every distinct-index slot (1e-12); the port's repeated-index slots are
    0."""
    M, _ = inputs(q)
    got = _assembled_apply(case(ranks, q, D))
    op = JOp(q, _mesh(D))
    jgot = [np.asarray(t) for t in op.apply(*op.split_matrix(M))]
    ref = [np.asarray(t) for t in jsymdual._apply_tensor(jnp.asarray(M), q)]
    _check_distinct(got, jgot, q, 1e-12)
    _check_distinct(got, ref, q, 1e-12)
    m2, m3, m4 = _distinct_masks(q)
    for g, m in ((got[2], m2), (got[3], m3), (got[4], m4)):
        assert not np.any(g[~m])


@pytest.mark.parametrize("q,D", [(8, 4), (12, 4)])
def test_adjoint_matches_jax(ranks, q, D):
    """The port's sharded adjoint of y (each rank given its Y4 rows),
    merged, against the JAX sharded adjoint and the single-device one:
    every entry to 1e-12."""
    _, y = inputs(q)
    got = case(ranks, q, D)[0]["adjoint"]
    ref = np.asarray(jsymdual._adjoint_tensor(
        *(jnp.asarray(t) for t in y), q))
    mesh = _mesh(D)
    op = JOp(q, mesh)
    Y4s = jax.device_put(jnp.asarray(y[4]), NamedSharding(mesh, P("model")))
    jgot = op.merge_matrix(*op.adjoint(tuple(jnp.asarray(t) for t in y[:4])
                                       + (Y4s,)))
    np.testing.assert_allclose(got, jgot, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-12)


def test_roundtrip_matches_jax(ranks):
    """apply -> adjoint (one AL cost step's operator work) sharded over 4
    ranks against the JAX single-device chain, 1e-11."""
    q, D = 8, 4
    M, _ = inputs(q)
    ref = np.asarray(jsymdual._adjoint_tensor(
        *jsymdual._apply_tensor(jnp.asarray(M), q), q))
    got = case(ranks, q, D)[0]["roundtrip"]
    np.testing.assert_allclose(got, ref, rtol=1e-11, atol=1e-11)


@pytest.mark.parametrize("mesh,D", [("model", 4), ("2d", 2)])
def test_uneven_q_raises(ranks, mesh, D):
    """A q that the model axis does not divide raises ValueError, as the
    JAX constructor does."""
    msg = ranks[0][mesh]["result"][-1]
    assert isinstance(msg, str)
    assert f"q={D + 1} not divisible by mesh axis 'model' size {D}" in msg


@pytest.mark.parametrize("q,D", list(CASES))
def test_replicated_outputs_bit_equal_across_ranks(ranks, q, D):
    """y0 .. Y3 and every merged adjoint are the same bits on every rank
    (both batch rows of the (2, 2) mesh too)."""
    mesh = CASES[(q, D)]
    per = [next(c for c in r[mesh]["result"] if isinstance(c, dict) and
                c["q"] == q) for r in ranks]
    for p in per[1:]:
        for a, b in zip(p["apply"][:4], per[0]["apply"][:4]):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(p["adjoint"], per[0]["adjoint"])
        np.testing.assert_array_equal(p["roundtrip"], per[0]["roundtrip"])


@pytest.mark.parametrize("q,D", list(CASES))
def test_collectives_per_call(ranks, q, D):
    """One apply: two all-to-alls and one all-reduce; one adjoint: no
    collective at all."""
    for p in case(ranks, q, D):
        ca, cj = p["collectives_apply"], p["collectives_adjoint"]
        assert (ca["all_to_all"], ca["all_reduce"], ca["broadcast"],
                ca["all_gather"]) == (2, 1, 0, 0)
        assert ca["all_to_all_bytes"] == 2 * (q // D) * q ** 3 * 8
        assert not any(v for v in cj.values())
