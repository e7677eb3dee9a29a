"""The port's meshes, its data-parallel MaxCut batch and the (dcn, model)
host mesh under the sharded AL (PyTorch port of manisdp_tpu/parallel/
{mesh,distributed}.py), against tests/test_parallel.py's checks, the
unsharded port and the JAX package's sharded functions on the same
inputs.

Four ranks on gloo (``parallel.spawn_ranks``, one thread each) run every
rank-side job in one spawn (``tests/_torch_rank_workers.py``); JAX runs
on the first four devices of the virtual CPU mesh (tests/conftest.py)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import threadpoolctl
import torch
import torch.distributed as dist
from jax.sharding import Mesh

import _torch_rank_workers as W
from manisdp_tpu import solve_maxcut_batch as j_batch
from manisdp_tpu import solve_unitdiag as j_unitdiag
from manisdp_tpu.core import TROptions as JTROptions
from manisdp_tpu.parallel.distributed import _device_grid
from manisdp_tpu.parallel.distributed import make_host_mesh as jhost_mesh
from manisdp_tpu.parallel.mesh import batched_maxcut_solve as jbatched
from manisdp_tpu.parallel.mesh import \
    batched_sharded_maxcut_solve as jbatched_sharded
from manisdp_tpu.parallel.mesh import make_mesh as jmake_mesh
from manisdp_tpu.parallel.mesh import make_mesh_2d as jmake_mesh_2d
from manisdp_tpu.parallel.mesh import sharded_maxcut_solve as jsharded
from manisdp_tpu_torch import solve_maxcut_batch, solve_unitdiag
from manisdp_tpu_torch.core import (TROptions, make_batched_trustregions,
                                    make_trustregions)
from manisdp_tpu_torch.parallel import init_distributed, spawn_ranks
from manisdp_tpu_torch.parallel.distributed import make_host_mesh, rank_grid
from manisdp_tpu_torch.parallel.mesh import _maxcut_problem, make_mesh
from test_batch import random_sparse_cost, random_sym_cost

WORLD = 4
N_HOST = 12
BATCH_N, BATCH_P = 32, 4
BATCH_TR = dict(maxiter=2, maxinner=6, tolgradnorm=1e-10)
BATCH_KW = dict(p0=4, max_outer=30, verbose=False)
# test_parallel.py:test_model_sharded_matches_single's instance and options
SHARD_N, SHARD_P = 64, 4
SHARD_TR = dict(maxiter=3, maxinner=8, tolgradnorm=1e-10)
# the host-mesh solves' explicit start, the same for both packages
HOST_Y0 = np.random.RandomState(21).randn(3, N_HOST)
HOST_Y0 /= np.sqrt((HOST_Y0 ** 2).sum(axis=0))
HOST_KW = dict(verbose=False, max_outer=4, Y0=HOST_Y0)


@pytest.fixture(autouse=True, scope="module")
def _one_cpu_thread():
    """Torch and BLAS on one thread for this module (the ranks get one
    thread each from spawn_ranks)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpoolctl.threadpool_limits(1):
        yield
    torch.set_num_threads(n)


def host_problem():
    """test_parallel.py:test_host_mesh_layout's instance: diag(X) = 1 at
    n = 12 with a random zero-diagonal cost."""
    n = N_HOST
    rows = np.arange(n) * n + np.arange(n)
    At = sp.coo_matrix((np.ones(n), (rows, np.arange(n))),
                       shape=(n * n, n)).tocsc()
    rs = np.random.RandomState(0)
    Cb = rs.randn(n, n)
    C = 0.5 * (Cb + Cb.T)
    np.fill_diagonal(C, 0.0)
    return At, np.ones(n), C.reshape(-1, order="F")


def rtr_batch():
    """test_parallel.py:_tiny's factors and costs, one instance per seed."""
    Ys, Cs = [], []
    for s in range(WORLD):
        rs = np.random.RandomState(s)
        B = rs.randn(BATCH_N, BATCH_N)
        C = 0.5 * (B + B.T)
        np.fill_diagonal(C, 0.0)
        Y = rs.randn(BATCH_P, BATCH_N)
        Ys.append(Y / np.sqrt((Y ** 2).sum(axis=0)))
        Cs.append(C)
    return np.stack(Ys), np.stack(Cs)


def sharded_instance():
    """test_parallel.py:_tiny(64, 4, 0): a zero-diagonal symmetric cost and
    a unit-column start."""
    rs = np.random.RandomState(0)
    B = rs.randn(SHARD_N, SHARD_N)
    C = 0.5 * (B + B.T)
    np.fill_diagonal(C, 0.0)
    Y = rs.randn(SHARD_P, SHARD_N)
    return Y / np.sqrt((Y ** 2).sum(axis=0)), C


def maxcut_instances():
    """A bucket of 4 dense costs (split over the batch axis) and a bucket
    of 3 scipy-sparse ones (which 4 ranks do not divide: solved whole)."""
    dense = [random_sym_cost(20, s) for s in range(4)]
    sparse = [random_sparse_cost(300, 10 + s) for s in range(3)]
    return dense + sparse


@pytest.fixture(scope="module")
def ranks():
    At, b, c = host_problem()
    solve = dict(entry="solve_unitdiag", At=At, b=b, c=c, n=N_HOST,
                 kw=HOST_KW)
    Ys, Cs = rtr_batch()
    jobs = [("meshes", "meshes", {}),
            ("model", "al_solve", solve),
            ("host", "al_solve", dict(solve, mesh="host")),
            ("host22", "al_solve", dict(solve, mesh="host", nodes=2)),
            ("rtr", "batched_rtr", dict(Ys=Ys, Cs=Cs,
                                        typdist=float(np.pi *
                                                      np.sqrt(BATCH_N)),
                                        tr=BATCH_TR)),
            ("batch", "maxcut_batch", dict(Cs=maxcut_instances(),
                                           kw=BATCH_KW)),
            ("batch2d", "maxcut_batch", dict(Cs=maxcut_instances(),
                                             kw=BATCH_KW, mesh="2d")),
            ("batch_model", "maxcut_batch", dict(Cs=maxcut_instances()[:4],
                                                 kw=BATCH_KW,
                                                 mesh="model")),
            ("sharded", "sharded_rtr", _sharded_job()),
            ("sharded_peer", "sharded_rtr", _sharded_job("peer")),
            ("sharded2d", "batched_sharded_rtr",
             dict(Ys=Ys, Cs=Cs, typdist=float(np.pi * np.sqrt(BATCH_N)),
                  tr=BATCH_TR)),
            ("sharded2d_peer", "batched_sharded_rtr",
             dict(Ys=Ys, Cs=Cs, typdist=float(np.pi * np.sqrt(BATCH_N)),
                  tr=BATCH_TR, tcg_mode="peer"))]
    return spawn_ranks(W.run_jobs, WORLD, "gloo", "cpu", args=(jobs,),
                       threads=1)


def _sharded_job(tcg_mode=None):
    return dict(zip(("Y", "C"), sharded_instance()),
                typdist=float(np.pi * np.sqrt(SHARD_N)), tr=SHARD_TR,
                tcg_mode=tcg_mode)


@pytest.fixture(scope="module")
def ranks2():
    """Two gloo ranks: the sharded solve with K11's split and peer twins."""
    jobs = [(mode, "sharded_rtr", _sharded_job(mode))
            for mode in ("split", "peer")]
    return spawn_ranks(W.run_jobs, 2, "gloo", "cpu", args=(jobs,), threads=1)


def test_rank_grid_puts_nodes_outermost():
    """rank_grid (the JAX _device_grid): row k holds node k's ranks."""
    assert rank_grid(8, 2).shape == (2, 4)
    np.testing.assert_array_equal(rank_grid(8, 2)[1], [4, 5, 6, 7])
    assert rank_grid(4, 1).shape == (1, 4)


def test_init_distributed_is_a_noop_for_one_process(monkeypatch):
    """One process (no WORLD_SIZE, or 1): init_distributed returns False
    and starts no group, as the JAX function does."""
    for var in ("WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    assert init_distributed() is False
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert init_distributed(device="cpu") is False
    assert not dist.is_initialized()


def test_mesh_without_a_group_joins_the_torchrun_ranks(monkeypatch):
    """A process that torchrun's variables name one of several
    (WORLD_SIZE=2) and that has no group joins them through
    init_distributed when a mesh is asked for, and never takes a mesh of
    one place: without a rendezvous address that raises, and no group is
    left behind."""
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("LOCAL_RANK", "0")
    for var in ("MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    assert not dist.is_initialized()
    for mk in (lambda: make_mesh(device_type="cpu"),
               lambda: make_mesh(2, "batch", "cpu"),
               lambda: make_host_mesh(device_type="cpu")):
        with pytest.raises(ValueError, match="MASTER_ADDR"):
            mk()
        assert not dist.is_initialized()


def test_mesh_shapes_and_axis_names(ranks):
    """test_parallel.py:64-80 on 4 ranks: make_mesh, make_mesh_2d, the
    host meshes (node axis outermost; one node by default, a simulated
    two-node grid), each rank's coordinates; a mesh of another size than
    the world raises (one rank per place); init_distributed inside a group
    returns True."""
    per = [r["meshes"]["result"] for r in ranks]
    m0 = per[0]
    assert m0["model"][:2] == ((WORLD,), ("model",))
    assert m0["model_n"][:2] == ((WORLD,), ("model",))
    assert m0["batch"][:2] == ((WORLD,), ("batch",))
    assert m0["2d"][:2] == ((2, WORLD // 2), ("batch", "model"))
    assert m0["host"][:2] == ((1, WORLD), ("dcn", "model"))
    assert m0["host2"][:2] == ((2, WORLD // 2), ("dcn", "model"))
    assert m0["batch_host"][:2] == ((2, WORLD // 2), ("batch", "model"))
    for r, m in enumerate(per):
        assert m["model"][2] == (r,)
        assert m["host2"][2] == divmod(r, WORLD // 2)
        assert "one rank per place" in m["wrong_count"]
        assert m["init_again"] is True


def test_host_mesh_solve_matches_model_only(ranks):
    """test_parallel.py:101-110: the sharded unitdiag solve on the (1, 4)
    host mesh and on a (2, 2) (dcn, model) grid (sharded over model,
    replicated over dcn) reproduces the model-only solve over 4 ranks, and
    the port's single solve."""
    At, b, c = host_problem()
    single = solve_unitdiag(At, b, c, N_HOST, device="cpu", **HOST_KW)
    objs = {k: ranks[0][k]["result"]["obj"]
            for k in ("model", "host", "host22")}
    assert np.isfinite(objs["model"])
    for k in ("host", "host22"):
        np.testing.assert_allclose(objs[k], objs["model"], rtol=1e-9)
    np.testing.assert_allclose(objs["model"], single.obj, rtol=1e-9)
    # the (2, 2) grid: both dcn replicas hold the same result
    for r in ranks[1:]:
        assert r["host22"]["result"]["obj"] == objs["host22"]


def test_batched_maxcut_solve_matches_unsharded(ranks):
    """batched_maxcut_solve on the 4-rank batch axis (one instance a rank)
    against the unsharded batched RTR on the whole batch: every field to
    1e-6 (test_parallel.py:46), assembled alike on every rank."""
    Ys, Cs = rtr_batch()
    base = make_batched_trustregions(_maxcut_problem(), TROptions(**BATCH_TR))
    ref = base(torch.as_tensor(Ys), torch.as_tensor(Cs),
               float(np.pi * np.sqrt(BATCH_N)))
    got = ranks[0]["rtr"]["result"]
    np.testing.assert_allclose(got["fx"], ref.fx.numpy(), rtol=1e-6)
    np.testing.assert_allclose(got["Y"], ref.Y.numpy(), atol=1e-6)
    np.testing.assert_array_equal(got["iters"], ref.iters)
    assert len(np.unique(np.round(got["fx"], 6))) > 1
    for r in ranks[1:]:
        np.testing.assert_array_equal(r["rtr"]["result"]["Y"], got["Y"])


@pytest.mark.parametrize("job", ["batch", "batch2d", "batch_model"])
def test_solve_maxcut_batch_mesh_matches_unsharded(ranks, job):
    """solve_maxcut_batch(mesh=) over a 4-rank batch axis, a (2, 2)
    (batch, model) mesh and a mesh without a batch axis (every rank solves
    the whole batch), against the unsharded call: every instance's
    objective within 1e-6 and certified; all ranks agree."""
    Cs = maxcut_instances()[:4] if job == "batch_model" else \
        maxcut_instances()
    ref = solve_maxcut_batch(Cs, device="cpu", **BATCH_KW)
    got = ranks[0][job]["result"]
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert g["status"] == r.status == 0
        np.testing.assert_allclose(g["obj"], r.obj, rtol=1e-6, atol=1e-6)
    for other in ranks[1:]:
        for g, o in zip(got, other[job]["result"]):
            assert g["obj"] == o["obj"]
            np.testing.assert_array_equal(g["Y"], o["Y"])


# ------------------------------------------------- against the JAX package --

@functools.lru_cache(maxsize=None)
def _jax_host_solves():
    """JAX's sharded unitdiag solve on make_host_mesh over 4 devices (1, 4)
    and on a simulated two-host (2, 2) (dcn, model) grid."""
    devs = jax.devices()[:WORLD]
    At, b, c = host_problem()
    return {k: j_unitdiag(At, b, c, N_HOST, mesh=mesh, **HOST_KW)
            for k, mesh in (("host", jhost_mesh(devs)),
                            ("host22", Mesh(_device_grid(devs, 2),
                                            ("dcn", "model"))))}


@pytest.mark.parametrize("job", ["host", "host22"])
def test_host_mesh_solve_matches_jax(ranks, job):
    """The port's unitdiag solve on the (1, 4) host mesh and the (2, 2)
    (dcn, model) grid against JAX's solve_unitdiag under make_host_mesh /
    the same grid from the same Y0: equal outer iterations, objective to
    1e-9, the factor to 1e-8, both certified."""
    if len(jax.devices()) < WORLD:
        pytest.skip(f"needs {WORLD} virtual devices")
    ref = _jax_host_solves()[job]
    got = ranks[0][job]["result"]
    assert got["status"] == ref.status == 0
    assert got["iterations"] == ref.iterations
    np.testing.assert_allclose(got["obj"], ref.obj, rtol=1e-9)
    np.testing.assert_allclose(got["Y"], ref.Y, atol=1e-8)


def test_batched_maxcut_solve_matches_jax(ranks):
    """batched_maxcut_solve on the 4-rank batch axis against JAX's
    batched_maxcut_solve on a 4-device batch mesh from the same factors
    and costs: fx and Y to 1e-9, equal TR and tCG iteration counts."""
    if len(jax.devices()) < WORLD:
        pytest.skip(f"needs {WORLD} virtual devices")
    Ys, Cs = rtr_batch()
    solve, shard = jbatched(jmake_mesh(WORLD, "batch"),
                            JTROptions(**BATCH_TR))
    ref = solve(*shard(jnp.asarray(Ys), jnp.asarray(Cs)),
                float(np.pi * np.sqrt(BATCH_N)))
    got = ranks[0]["rtr"]["result"]
    np.testing.assert_allclose(got["fx"], np.asarray(ref.fx), rtol=1e-9)
    np.testing.assert_allclose(got["Y"], np.asarray(ref.Y), atol=1e-9)
    np.testing.assert_array_equal(got["iters"], np.asarray(ref.iters))
    np.testing.assert_array_equal(got["inner_iters"],
                                  np.asarray(ref.inner_iters))


@pytest.mark.parametrize("job", ["batch", "batch2d", "batch_model"])
def test_solve_maxcut_batch_mesh_matches_jax(ranks, job):
    """solve_maxcut_batch(mesh=) against JAX's on the matching virtual
    mesh (a 4-device batch axis, a (2, 2) (batch, model) mesh, a 4-device
    model-only mesh that leaves the batch unsharded): every instance
    certified with JAX's outer iterations and its objective within
    1e-6."""
    if len(jax.devices()) < WORLD:
        pytest.skip(f"needs {WORLD} virtual devices")
    mesh = {"batch": lambda: jmake_mesh(WORLD, "batch"),
            "batch2d": lambda: jmake_mesh_2d(2, WORLD // 2),
            "batch_model": lambda: jmake_mesh(WORLD, "model")}[job]()
    Cs = maxcut_instances()[:4] if job == "batch_model" else \
        maxcut_instances()
    ref = j_batch(Cs, mesh=mesh, **BATCH_KW)
    got = ranks[0][job]["result"]
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert g["status"] == r.status == 0
        assert g["iterations"] == r.iterations
        np.testing.assert_allclose(g["obj"], r.obj, rtol=1e-6, atol=1e-6)


def test_sharded_maxcut_solve_matches_single_and_jax(ranks):
    """sharded_maxcut_solve with Y and C column-sharded over 4 ranks (16
    columns a rank) against the port's single make_trustregions and JAX's
    sharded_maxcut_solve on make_mesh(4) (test_parallel.py:25's instance
    and options): fx to 1e-12 (relative), Y to 1e-12, equal TR and tCG
    counts; the whole Y on every rank, bit-equal; K11's split mode ran
    (the twin's collectives: per tCG step two all-reduces of the
    partials); D not dividing n raises ValueError."""
    Y, C = sharded_instance()
    typ = float(np.pi * np.sqrt(SHARD_N))
    got = ranks[0]["sharded"]["result"]
    assert got["local_shape"] == (SHARD_P, SHARD_N // WORLD)
    assert got["cost_shape"] == (SHARD_N, SHARD_N // WORLD)
    single = make_trustregions(_maxcut_problem(), TROptions(**SHARD_TR))(
        torch.as_tensor(Y), torch.as_tensor(C), typ)
    np.testing.assert_allclose(got["fx"], float(single.fx), rtol=1e-12)
    np.testing.assert_allclose(got["Y"], single.Y.numpy(), atol=1e-12)
    assert (got["iters"], got["inner_iters"]) == (single.iters,
                                                  single.inner_iters)
    if len(jax.devices()) >= WORLD:
        solve, shard = jsharded(jmake_mesh(WORLD, "model"),
                                JTROptions(**SHARD_TR))
        ref = solve(*shard(jnp.asarray(Y), jnp.asarray(C)), typ)
        np.testing.assert_allclose(got["fx"], float(ref.fx), rtol=1e-12)
        np.testing.assert_allclose(got["Y"], np.asarray(ref.Y), atol=1e-12)
        assert (got["iters"], got["inner_iters"]) == (int(ref.iters),
                                                      int(ref.inner_iters))
    assert "do not split over 4 ranks" in got["uneven"]
    coll = ranks[0]["sharded"]["collectives"]
    assert coll["all_gather"] > 0 and coll["all_reduce"] >= \
        2 * got["inner_iters"]
    for r in ranks[1:]:
        o = r["sharded"]["result"]
        np.testing.assert_array_equal(o["Y"], got["Y"])
        assert o["fx"] == got["fx"]


def test_batched_sharded_maxcut_solve_matches_jax(ranks):
    """batched_sharded_maxcut_solve on a (2, 2) (batch, model) mesh (two
    instances and 16 columns a rank) against JAX's on make_mesh_2d(2, 2)
    and the port's unsharded batched RTR, rtr_batch()'s instances: fx and
    Y to 1e-9, equal TR and tCG counts, the whole batch on every rank."""
    Ys, Cs = rtr_batch()
    typ = float(np.pi * np.sqrt(BATCH_N))
    got = ranks[0]["sharded2d"]["result"]
    assert got["local_shape"] == (WORLD // 2, BATCH_P, BATCH_N // 2)
    base = make_batched_trustregions(_maxcut_problem(), TROptions(**BATCH_TR))
    single = base(torch.as_tensor(Ys), torch.as_tensor(Cs), typ)
    np.testing.assert_allclose(got["fx"], single.fx.numpy(), rtol=1e-9)
    np.testing.assert_allclose(got["Y"], single.Y.numpy(), atol=1e-9)
    np.testing.assert_array_equal(got["iters"], single.iters)
    np.testing.assert_array_equal(got["inner_iters"], single.inner_iters)
    if len(jax.devices()) >= WORLD:
        solve, shard = jbatched_sharded(jmake_mesh_2d(2, WORLD // 2),
                                        JTROptions(**BATCH_TR))
        ref = solve(*shard(jnp.asarray(Ys), jnp.asarray(Cs)), typ)
        np.testing.assert_allclose(got["fx"], np.asarray(ref.fx), rtol=1e-9)
        np.testing.assert_allclose(got["Y"], np.asarray(ref.Y), atol=1e-9)
        np.testing.assert_array_equal(got["iters"], np.asarray(ref.iters))
        np.testing.assert_array_equal(got["inner_iters"],
                                      np.asarray(ref.inner_iters))
    for r in ranks[1:]:
        np.testing.assert_array_equal(r["sharded2d"]["result"]["Y"],
                                      got["Y"])


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_maxcut_peer_twin_matches_jax(request, world):
    """sharded_maxcut_solve with K11's peer mode asked for, on gloo CPU
    ranks (its twin: the partials summed by distributed.ordered_sum, in
    rank order, the device's order): fx to 1e-12 and Y to 1e-10 against
    JAX's sharded_maxcut_solve on make_mesh(world), equal TR and tCG
    counts, every rank bit-equal; at world 2 bit-equal to the split
    mode's all_reduce twin (a + b either way).  Per tCG step the two
    all-reduces of the partials become two all-gathers."""
    ranks = request.getfixturevalue("ranks2" if world == 2 else "ranks")
    split, peer = ("split", "peer") if world == 2 else \
        ("sharded", "sharded_peer")
    got, ref = ranks[0][peer]["result"], ranks[0][split]["result"]
    assert (got["tcg_mode"], ref["tcg_mode"]) == ("peer", "split")
    Y, C = sharded_instance()
    typ = float(np.pi * np.sqrt(SHARD_N))
    assert len(jax.devices()) >= world
    solve, shard = jsharded(jmake_mesh(world, "model"),
                            JTROptions(**SHARD_TR))
    jres = solve(*shard(jnp.asarray(Y), jnp.asarray(C)), typ)
    np.testing.assert_allclose(got["fx"], float(jres.fx), rtol=1e-12)
    np.testing.assert_allclose(got["Y"], np.asarray(jres.Y), atol=1e-10)
    assert (got["iters"], got["inner_iters"]) == (int(jres.iters),
                                                  int(jres.inner_iters))
    if world == 2:
        np.testing.assert_array_equal(got["Y"], ref["Y"])
        assert got["fx"] == ref["fx"]
    for r in ranks[1:]:
        np.testing.assert_array_equal(r[peer]["result"]["Y"], got["Y"])
        assert r[peer]["result"]["fx"] == got["fx"]
    cp, cs = ranks[0][peer]["collectives"], ranks[0][split]["collectives"]
    fewer = cs["all_reduce"] - cp["all_reduce"]
    assert fewer == cp["all_gather"] - cs["all_gather"]
    assert fewer % 2 == 0 and fewer >= 2 * got["inner_iters"] > 0


def test_batched_sharded_peer_twin_is_bit_equal_to_split(ranks):
    """batched_sharded_maxcut_solve on the (2, 2) mesh with K11's peer
    mode asked for: its model subgroup of 2 ranks sums a + b as the split
    mode's all-reduce does, so every instance's Y and fx are bit-equal,
    with the same counts."""
    got = ranks[0]["sharded2d_peer"]["result"]
    ref = ranks[0]["sharded2d"]["result"]
    for k in ("Y", "fx", "iters", "inner_iters"):
        np.testing.assert_array_equal(got[k], ref[k])


@pytest.mark.parametrize("backend, places, pairs, want", [
    ("nccl", [(7, 0), (7, 1), (7, 2), (7, 3)], "all", "peer"),
    ("nccl", [(7, 0)], "all", "peer"),
    ("gloo", [(7, 0), (7, 1)], "all", "split"),
    ("nccl", [(7, 0), (7, 0)], "all", "split"),
    ("nccl", [(7, 0), (7, 1), (7, 2)], "no 1-2", "split"),
    ("nccl", [(7, 0), (8, 0)], "all", "split")])
def test_tcg_mode_choice(monkeypatch, backend, places, pairs, want):
    """K11's mode on a group, with the backend and
    torch.cuda.can_device_access_peer faked: NCCL with peer access
    between every pair of distinct cards on one host gives "peer"
    (world 1 too: no pair); gloo, a shared card, a missing peer pair or
    two hosts give "split"."""
    from manisdp_tpu_torch.parallel.peer import tcg_mode
    asked = []

    def can_access(a, b):
        asked.append((a, b))
        return pairs == "all" or {a, b} != {1, 2}

    monkeypatch.setattr(torch.cuda, "can_device_access_peer", can_access)
    assert tcg_mode(backend, places) == want
    assert tcg_mode(backend, places, lambda a, b: pairs == "all" or
                    {a, b} != {1, 2}) == want
    if want == "peer" and len(places) > 1:
        assert len(asked) == len(places) * (len(places) - 1)


def test_sharded_oblique_rejects_an_unknown_mode():
    from manisdp_tpu_torch.parallel.mesh import ShardedOblique
    with pytest.raises(ValueError, match="tcg_mode"):
        ShardedOblique(None, "ring")
