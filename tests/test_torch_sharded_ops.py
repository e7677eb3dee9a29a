"""The port's sharded constraint operator and the primal AL drivers'
``mesh=`` against the unsharded port and the JAX package's
ShardedConstraintOp (manisdp_tpu/parallel/sharded_ops.py,
solvers/primal_al.py:521-553), on the same numpy inputs.

The port's ranks are processes on gloo (``parallel.spawn_ranks``, one
thread each); JAX runs its sharded op under shard_map on the virtual CPU
mesh (tests/conftest.py).  One spawn per world size runs every rank-side
job (``tests/_torch_rank_workers.py``)."""

import dataclasses
import functools

import jax
import numpy as np
import pytest
import scipy.sparse as sp
import threadpoolctl
import torch
from jax.sharding import PartitionSpec as P

import _torch_rank_workers as W
from manisdp_tpu.ops.sparse import ConstraintOp as JOp
from manisdp_tpu.parallel.mesh import make_mesh as jmake_mesh
from manisdp_tpu.parallel.sharded_ops import ShardedConstraintOp as JSOp
from manisdp_tpu_torch import kernels as K
from manisdp_tpu_torch import solve_unitdiag
from manisdp_tpu_torch.convert import sharded_op_from_jax
from manisdp_tpu_torch.frontends.workloads import matrix_completion
from manisdp_tpu_torch.ops.sparse import ConstraintOp
from manisdp_tpu_torch.parallel import spawn_ranks
from manisdp_tpu_torch.parallel.sharded_ops import (ShardedConstraintOp,
                                                    partition)

SHARD_FIELDS = ("pat_i", "pat_j", "pat_c", "kp", "vp", "locp", "ks", "vs",
                "locps")
OP_ARRAYS = ("k", "i", "j", "v", "a2p", "b", "kp", "vp", "a2p_sorted")
SIGMA = 2.5


@pytest.fixture(autouse=True, scope="module")
def _one_cpu_thread():
    """Torch and BLAS on one thread for this module (the ranks get one
    thread each from spawn_ranks)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpoolctl.threadpool_limits(1):
        yield
    torch.set_num_threads(n)


def _rel(got, ref):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    return np.max(np.abs(got - ref)) / max(np.max(np.abs(ref)), 1e-300)


def random_problem(n=24, m=30, seed=3, density=0.15):
    """tests/test_sharded_ops.py's random symmetric constraint set and
    cost in SeDuMi layout."""
    rs = np.random.RandomState(seed)
    rows, cols, vals, ks = [], [], [], []
    for k in range(m):
        B = sp.random(n, n, density=density, random_state=rs).toarray()
        A = 0.5 * (B + B.T)
        i, j = np.nonzero(A)
        rows.append(i)
        cols.append(j)
        vals.append(A[i, j])
        ks.append(np.full(i.shape, k))
    lin = np.concatenate(rows) + n * np.concatenate(cols)
    At = sp.coo_matrix((np.concatenate(vals), (lin, np.concatenate(ks))),
                       shape=(n * n, m)).tocsc()
    Cb = rs.randn(n, n)
    C = 0.5 * (Cb + Cb.T)
    return At, rs.randn(m), C.reshape(-1, order="F"), n, m


def diag_problem(n, seed):
    """diag(X) = 1 constraints and a random symmetric cost with a zero
    diagonal (test_sharded_ops.py's unitdiag instances)."""
    rows = np.arange(n) * n + np.arange(n)
    At = sp.coo_matrix((np.ones(n), (rows, np.arange(n))),
                       shape=(n * n, n)).tocsc()
    rs = np.random.RandomState(seed)
    Cb = rs.randn(n, n)
    C = 0.5 * (Cb + Cb.T)
    np.fill_diagonal(C, 0.0)
    return At, np.ones(n), C.reshape(-1, order="F")


def general_problem(n=12, m=8):
    """test_sharded_ops.py's random feasible SDP (b = A(X0)) with trace
    minimization."""
    rs = np.random.RandomState(0)
    W_ = rs.randn(n, 3)
    X0 = W_ @ W_.T
    rows, cols, vals, ks = [], [], [], []
    for k in range(m):
        B = rs.randn(n, n)
        A = 0.5 * (B + B.T)
        i, j = np.nonzero(A)
        rows.append(i)
        cols.append(j)
        vals.append(A[i, j])
        ks.append(np.full(i.shape, k))
    lin = np.concatenate(rows) + n * np.concatenate(cols)
    At = sp.coo_matrix((np.concatenate(vals), (lin, np.concatenate(ks))),
                       shape=(n * n, m)).tocsc()
    b = np.asarray(At.T @ X0.reshape(-1, order="F")).ravel()
    return At, b, np.eye(n).reshape(-1, order="F")


def _factor(n, p, seed, norm=True):
    Y = np.random.RandomState(seed).randn(p, n)
    return Y / np.sqrt((Y ** 2).sum(axis=0)) if norm else Y


def _jax_op_arrays(jop):
    a = {f: np.asarray(getattr(jop, f)) for f in OP_ARRAYS}
    a.update({"pat.i": np.asarray(jop.pat.i), "pat.j": np.asarray(jop.pat.j),
              "pat.v": np.asarray(jop.pat.v), "m": jop.m, "n": jop.n})
    return a


def _jax_sharded_arrays(jop, world):
    sop = JSOp.build(jop, world)
    return sop, {f: np.asarray(getattr(sop, f)) for f in SHARD_FIELDS}


def _inputs(n, m):
    Y = _factor(n, 4, 0)
    return dict(Y=Y, U=_factor(n, 4, 1) - Y,
                w=np.random.RandomState(2).randn(m),
                V=np.random.RandomState(4).randn(n, 3),
                eG=np.random.RandomState(6).randn(n), sigma=SIGMA)


# the solves every rank runs at world 4: (name, entry, problem, options)
N_LOB = 96
SOLVES = (
    ("unitdiag", "solve_unitdiag", lambda: diag_problem(16, 11),
     dict(verbose=False, max_outer=6, seed=5)),
    ("lobpcg", "solve_unitdiag", lambda: diag_problem(N_LOB, 3),
     dict(verbose=False, max_outer=25, eig_method="lobpcg",
          cert_method="lobpcg", Y0=_factor(N_LOB, 2, 7))),
    ("devrr", "solve_unitdiag", lambda: diag_problem(N_LOB, 3),
     dict(verbose=False, max_outer=25, eig_method="lobpcg",
          Y0=_factor(N_LOB, 2, 7))),
    ("general", "solve_sdp", lambda: general_problem(),
     dict(verbose=False, max_outer=60, Y0=_factor(12, 2, 8, norm=False))),
    ("mixed", "solve_unitdiag", lambda: diag_problem(24, 5),
     dict(verbose=False, max_outer=30, inner_dtype="mixed",
          Y0=_factor(24, 3, 9))),
)


@pytest.fixture(scope="module")
def problem():
    At, b, c, n, m = random_problem()
    jop = JOp.build(At, b, c, n)
    return jop, _jax_op_arrays(jop), ConstraintOp.build(At, b, c, n, "cpu")


@pytest.fixture(scope="module")
def mc():
    """A small matrix completion (n = 24): the JAX and the port operator.
    Its pattern's cuts into 2 and 4 slices fall inside columns."""
    data, _ = matrix_completion(10, 14, rank=2, m_samples=80, seed=1)
    n = int(data.K.s)
    return (JOp.build(data.At, data.b, data.c, n),
            ConstraintOp.build(data.At, data.b, data.c, n, "cpu"))


@pytest.fixture(scope="module")
def ranks(problem, mc):
    """Each of 4 ranks' job results: the protocol on shards over 2 of them
    (``protocol2``) and over all 4, the column blocks of the matrix
    completion's shards over 2 (``blocks2``), and the solves at world 4."""
    jop, arrays, _ = problem
    inputs = _inputs(jop.n, jop.m)
    jobs = [(f"protocol{world}", "protocol",
             dict(sharded=_jax_sharded_arrays(jop, world)[1], arrays=arrays,
                  inputs=inputs)) for world in (2, 4)]
    top = mc[1]
    jobs.append(("blocks2", "column_blocks", dict(
        arrays=top.host_arrays(full=True), inputs=_inputs(top.n, top.m),
        world=2)))
    for name, entry, make, kw in SOLVES:
        At, b, c = make()
        jobs.append((name, "al_solve", dict(
            entry=entry, At=At, b=b, c=c,
            n=int(round(np.sqrt(At.shape[0]))), kw=kw)))
    return spawn_ranks(W.run_jobs, 4, "gloo", "cpu", args=(jobs,),
                       threads=1)


@pytest.mark.parametrize("world", [1, 2, 3, 4])
def test_partition_matches_jax_build(problem, world):
    """partition() and sharded_op_from_jax() give, rank by rank, the
    unpadded slices of the JAX ShardedConstraintOp.build, element for
    element, and the same shard."""
    jop, arrays, top = problem
    _, jsh = _jax_sharded_arrays(jop, world)
    pieces = partition(top.host_arrays(full=True), world)
    assert len(pieces) == world
    total_pat = total_ent = 0
    for r, piece in enumerate(pieces):
        npat, nent = piece["pat_i"].shape[0], piece["kp"].shape[0]
        total_pat += npat
        total_ent += nent
        for ours, theirs in (("pat_i", "pat_i"), ("pat_j", "pat_j"),
                             ("pat_v", "pat_c")):
            np.testing.assert_array_equal(piece[ours], jsh[theirs][r, :npat])
        for f in ("kp", "vp", "locp", "ks", "vs", "locps"):
            np.testing.assert_array_equal(piece[f], jsh[f][r, :nent])
        # the padding JAX adds is what the unpadded slice leaves out
        assert not np.any(jsh["vp"][r, nent:]) and \
            not np.any(jsh["pat_c"][r, npat:])
        conv = sharded_op_from_jax(jsh, arrays, r, "cpu")
        own = ShardedConstraintOp.build(top.host_arrays(full=True), r,
                                        world, "cpu")
        assert conv.lo == own.lo == r * (-(-top.pat.nnz // world))
        for f in ("k", "i", "j", "v", "a2p", "kp", "vp", "a2p_sorted",
                  "krow_ptr", "pat_ptr"):
            assert torch.equal(getattr(conv.local, f), getattr(own.local, f))
        for f in ("i", "j", "v", "colptr"):
            assert torch.equal(getattr(conv.local.pat, f),
                               getattr(own.local.pat, f))
    assert (total_pat, total_ent) == (top.pat.nnz, top.nnz)


def _unsharded(top, inputs, dt):
    op = top.astype(dt)
    t = {k: torch.as_tensor(v).to(dt) for k, v in inputs.items()
         if k != "sigma"}
    Y, U, w, V, eG = t["Y"], t["U"], t["w"], t["V"], t["eG"]
    es, sv = op.es_vals(w, SIGMA), op.s_vals(w)
    ayu = op.normal_factored(Y, U)
    r = dict(
        pair_dots=op.pattern_pair_dots(Y, U),
        apply_factored=op.apply_factored(Y, U),
        apply_factored_yy=op.apply_factored(Y),
        adjoint=op.adjoint_on_pattern(w), es_vals=es, s_vals=sv,
        normal=ayu, matmat=op.matmat_pattern(Y, es),
        matvec=op.matvec_pattern(V, sv),
        colsum=op.colsum_pattern(op.c_pattern *
                                 op.pattern_pair_dots(Y, U)),
        dot=op.dot_pattern(op.c_pattern, op.pattern_pair_dots(Y)),
        al_hess=op.al_hess(U, Y, es, ayu, (2.0, 4.0 * SIGMA)),
        al_hess_diag=op.al_hess(U, Y, es, ayu, (2.0, 4.0 * SIGMA), eG=eG),
        quad_cols=op.quad_cols(Y, sv))
    return {k: v.numpy() for k, v in r.items()}


@pytest.mark.parametrize("world", [2, 4])
def test_protocol_matches_unsharded(problem, ranks, world):
    """Every protocol method, the sharded AL Hessian (epilogue once) and
    the stats' z at world 2 and 4 against the unsharded port operator:
    1e-12 in f64, 1e-5 in f32; every rank holds the same values."""
    _, _, top = problem
    inputs = _inputs(top.n, top.m)
    results = [r[f"protocol{world}"]["result"] for r in ranks[:world]]
    assert all(r[f"protocol{world}"]["result"] is None
               for r in ranks[world:])
    for dt, tol in ((torch.float64, 1e-12), (torch.float32, 1e-5)):
        ref = _unsharded(top, inputs, dt)
        for name, want in ref.items():
            got = results[0][str(dt)[6:]][name]
            assert _rel(got, want) <= tol, (world, dt, name)
            for other in results[1:]:
                np.testing.assert_array_equal(other[str(dt)[6:]][name], got)
    # every rank ran its own slice, and the A-entries were all dealt out
    nnz = [r["local_nnz"] for r in results]
    assert sum(p for p, _ in nnz) == top.pat.nnz
    assert sum(a for _, a in nnz) == top.nnz


@pytest.mark.parametrize("world", [2, 4])
def test_protocol_matches_jax_shard_map(problem, ranks, world):
    """The same methods of JAX's ShardedConstraintOp under shard_map on a
    virtual mesh of ``world`` devices, on the same partition (f64)."""
    jop, _, _ = problem
    if len(jax.devices()) < world:
        pytest.skip(f"needs {world} virtual devices")
    inputs = _inputs(jop.n, jop.m)
    got = ranks[0][f"protocol{world}"]["result"]["float64"]
    mesh = jmake_mesh(world, "model")
    sop_h, _ = _jax_sharded_arrays(jop, world)
    sop = jax.device_put(sop_h, sop_h.shardings(mesh))
    specs = sop_h.specs()
    Y, U, w, V = (jax.numpy.asarray(inputs[k]) for k in "YUwV")

    def run(fn, in_specs, out_specs=P()):
        return jax.jit(jax.shard_map(fn, mesh=mesh, in_specs=in_specs,
                                     out_specs=out_specs, check_vma=False))

    nnzP = jop.pat.nnz
    Lp = -(-nnzP // world)

    def unpad(a):
        a = np.asarray(a).reshape(world, Lp)
        return np.concatenate([a[d, :min(Lp, nnzP - d * Lp)]
                               for d in range(world)])

    checks = {
        "apply_factored": run(lambda o, a, u: o.apply_factored(a, u),
                              (specs, P(), P()))(sop, Y, U),
        "adjoint": unpad(run(lambda o, w_: o.adjoint_on_pattern(w_),
                             (specs, P()), P("model"))(sop, w)),
        "matmat": run(lambda o, y_, w_: o.matmat_pattern(
            y_, o.es_vals(w_, SIGMA)), (specs, P(), P()))(sop, Y, w),
        "matvec": run(lambda o, v_, w_: o.matvec_pattern(v_, o.s_vals(w_)),
                      (specs, P(), P()))(sop, V, w),
        "colsum": run(lambda o, y_, u_: o.colsum_pattern(
            o.c_pattern * o.pattern_pair_dots(y_, u_)),
            (specs, P(), P()))(sop, Y, U),
        "dot": run(lambda o, y_: o.dot_pattern(
            o.c_pattern, o.pattern_pair_dots(y_)), (specs, P()))(sop, Y),
    }
    for name, want in checks.items():
        assert _rel(got[name], want) <= 1e-12, (world, name)


@pytest.mark.parametrize("world", [2, 4])
def test_column_range_twins_match_full_width_and_jax(mc, world):
    """K1 (``plain``, ``al_hess``, ``cost``) and K3 on each rank's slice of
    a matrix-completion pattern whose cuts split columns: the slice's
    span gives the columns c0 .. c1-1 only, equal to those columns of the
    full-width twins; the blocks placed at their columns and summed, and
    the slices' pair dots, against the JAX ShardedConstraintOp under
    shard_map on the same partition (1e-12, f64)."""
    jop, top = mc
    if len(jax.devices()) < world:
        pytest.skip(f"needs {world} virtual devices")
    n, arrays = top.n, top.host_arrays(full=True)
    inputs = _inputs(n, top.m)
    t = {k: torch.as_tensor(v) for k, v in inputs.items() if k != "sigma"}
    Y, U, w, w2 = t["Y"], t["U"], t["w"], t["w"].flip(0)
    coefs = (2.0, 4.0 * SIGMA)
    p = Y.shape[0]
    f64 = dict(dtype=torch.float64)
    joined = dict(plain=torch.zeros(p, n, **f64),
                  al_hess=torch.zeros(p, n, **f64), cost=torch.zeros(n, **f64))
    dots, spans = [], []
    for r in range(world):
        loc = ShardedConstraintOp.build(arrays, r, world, "cpu").local
        pat = loc.pat
        c0, c1, r0, r1 = pat.span
        spans.append((c0, c1))
        assert c1 - c0 < n
        whole = dataclasses.replace(pat, span=None)
        es, ayu = loc.es_vals(w, SIGMA), loc.adjoint_on_pattern(w2)
        for mode, A, kw in (
                ("plain", Y, dict(vals=es)),
                ("al_hess", U, dict(vals=es, B=Y, vals2=ayu, coefs=coefs)),
                ("cost", Y, dict(vals=es))):
            got = K.symcoo_spmm(A, pat, mode, **kw)
            full = K.symcoo_spmm_plain(A, whole, mode, **kw)
            if mode == "cost":
                got, full = got[1], full[1][c0:c1]
            else:
                full = full[:, c0:c1]
            assert got.shape[-1] == c1 - c0
            assert torch.equal(got, full), (r, mode)
            joined[mode][..., c0:c1] += got
        got = K.pattern_dots(Y, U, pat)
        assert torch.equal(got, K.pattern_dots_plain(Y, U, whole))
        assert int(pat.i.min()) >= r0 and int(pat.i.max()) < r1
        dots.append(got)
    # the cuts fall inside columns: neighbouring ranks share one
    assert any(a[1] - 1 == b[0] for a, b in zip(spans, spans[1:]))

    mesh = jmake_mesh(world, "model")
    sop_h, _ = _jax_sharded_arrays(jop, world)
    sop = jax.device_put(sop_h, sop_h.shardings(mesh))
    specs = sop_h.specs()
    jY, jU, jw = (jax.numpy.asarray(inputs[k]) for k in "YUw")
    jw2 = jax.numpy.asarray(inputs["w"][::-1].copy())

    def run(fn, in_specs, out_specs=P()):
        return jax.jit(jax.shard_map(fn, mesh=mesh, in_specs=in_specs,
                                     out_specs=out_specs, check_vma=False))

    def hess(o, y_, u_, w_, w2_):
        return coefs[0] * o.matmat_pattern(u_, o.es_vals(w_, SIGMA)) + \
            coefs[1] * o.matmat_pattern(y_, o.adjoint_on_pattern(w2_))

    def cost(o, y_, w_):
        return jax.numpy.sum(
            y_ * o.matmat_pattern(y_, o.es_vals(w_, SIGMA)), axis=0)

    nnzP = jop.pat.nnz
    Lp = -(-nnzP // world)
    jdots = np.asarray(run(lambda o, y_, u_: o.pattern_pair_dots(y_, u_),
                           (specs, P(), P()), P("model"))(sop, jY, jU))
    jdots = np.concatenate([jdots.reshape(world, Lp)[d, :min(
        Lp, nnzP - d * Lp)] for d in range(world)])
    for name, got, want in (
            ("plain", joined["plain"], run(
                lambda o, y_, w_: o.matmat_pattern(y_, o.es_vals(w_, SIGMA)),
                (specs, P(), P()))(sop, jY, jw)),
            ("al_hess", joined["al_hess"],
             run(hess, (specs, P(), P(), P(), P()))(sop, jY, jU, jw, jw2)),
            ("cost", joined["cost"], run(cost, (specs, P(), P()))(sop, jY,
                                                                  jw)),
            ("pair_dots", torch.cat(dots), jdots)):
        assert _rel(got.numpy(), want) <= 1e-12, (world, name)


def test_column_blocks_join_like_the_all_reduce(ranks):
    """The sharded operator's column-block methods on the matrix
    completion at world 2 (gloo): each rank's block joined by one
    all-gather equals the path it replaces (the block in zeros at its
    columns, all-reduced), bit for bit, in f64 and f32 (a column both ranks
    share is a + b either way); both ranks hold the same bits."""
    per = [r["blocks2"] for r in ranks]
    assert all(p["result"] is None for p in per[2:])
    res = [p["result"] for p in per[:2]]
    spans = res[0]["spans"]
    assert spans[0][1] - 1 == spans[1][0]
    for r, out in enumerate(res):
        assert tuple(out["span"][:2]) == tuple(spans[r])
        for dt in ("float64", "float32"):
            for name, (joined, reduced) in out[dt].items():
                np.testing.assert_array_equal(joined, reduced,
                                              err_msg=f"{dt} {name}")
                np.testing.assert_array_equal(joined, res[0][dt][name][0])
    for p in per[:2]:
        assert p["collectives"]["all_gather"] > 0


def _solve(name):
    return next(s for s in SOLVES if s[0] == name)


@functools.lru_cache(maxsize=None)
def _jax_sharded_solve(name, world=4):
    """The JAX sharded solve of SOLVES' ``name``; under a mesh the JAX
    package takes its lobpcg certificate whatever cert_method says, so
    "devrr" shares "lobpcg"'s run."""
    from manisdp_tpu import solve_sdp as jsdp, solve_unitdiag as jud
    if name == "devrr":
        return _jax_sharded_solve("lobpcg", world)
    _, entry, make, kw = _solve(name)
    At, b, c = make()
    n = int(round(np.sqrt(At.shape[0])))
    fn = jud if entry == "solve_unitdiag" else jsdp
    return fn(At, b, c, n, mesh=jmake_mesh(world, "model"), **kw)


def test_sharded_unitdiag_matches_single(ranks):
    """tests/test_sharded_ops.py:122 on the port: the sharded unitdiag
    solve at world 4 against the port's single solve (which takes the
    operator ladder and the device rank update): equal outer iterations,
    objective within 1e-9."""
    _, _, make, kw = _solve("unitdiag")
    At, b, c = make()
    single = solve_unitdiag(At, b, c, 16, device="cpu", **kw)
    got = ranks[0]["unitdiag"]["result"]
    assert got["iterations"] == single.iterations
    np.testing.assert_allclose(got["obj"], single.obj, rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(got["X"], single.X, rtol=1e-7, atol=1e-8)
    for h, h1 in zip(got["history"], single.history):
        np.testing.assert_allclose(h["pinf"], h1["pinf"], rtol=1e-7,
                                   atol=1e-10)


@pytest.mark.parametrize("name", ["lobpcg", "devrr", "general", "mixed"])
def test_sharded_solve_matches_jax_sharded(ranks, name):
    """The LOBPCG certificate path at n = 96 (test_sharded_ops.py:151; the
    JAX sharded path's certificate, and the port's default devrr on the
    all-reduced matvec), the general variant at n = 12 (:175) and
    inner_dtype="mixed", each at world 4 against the JAX sharded solve on
    a 4-device mesh from the same explicit Y0: objective within 1e-6, both
    certified."""
    got = ranks[0][name]["result"]
    ref = _jax_sharded_solve(name)
    np.testing.assert_allclose(got["obj"], ref.obj, rtol=1e-6, atol=1e-6)
    assert got["status"] == ref.status == 0
    assert got["eta"] < 1e-6 and ref.eta < 1e-6


def test_ranks_return_bit_equal_results(ranks):
    """Every rank returns the same result, bit for bit (all but the
    wall-clock fields), and each ran its kernels' twins and all-reduces."""
    for name, *_ in SOLVES:
        per = [r[name] for r in ranks]
        first = per[0]["result"]
        for other in per[1:]:
            for f in W.RESULT_FIELDS:
                a, b = first[f], other["result"][f]
                if isinstance(a, np.ndarray):
                    np.testing.assert_array_equal(a, b)
                else:
                    assert a == b, (name, f)
        for p in per:
            assert p["collectives"]["all_reduce"] > 0
            assert p["launches"]["tcg_step"] == 0  # twins on the CPU


def test_shard_build_refuses_an_empty_slice():
    """A pattern with fewer entries than its slices leaves a rank nothing;
    the build says so instead of launching on an empty shard."""
    rows = np.array([0, 3])
    At = sp.coo_matrix((np.ones(2), (rows, [0, 1])), shape=(4, 2)).tocsc()
    arrays = ConstraintOp.assemble(At, np.ones(2), np.zeros(4), 2)
    with pytest.raises(ValueError, match="empty"):
        ShardedConstraintOp.build(arrays, 3, 4, "cpu")


def test_sharded_op_without_its_mesh_is_refused():
    """A ShardedConstraintOp given to a driver without mesh= is refused at
    entry (it holds one rank's slice, not the operator)."""
    At, b, c = diag_problem(8, 0)
    arrays = ConstraintOp.assemble(At, b, c, 8)
    sop = ShardedConstraintOp.build(arrays, 0, 2, "cpu")
    with pytest.raises(ValueError, match="mesh"):
        solve_unitdiag(sop, None, None, 8, device="cpu", verbose=False)
