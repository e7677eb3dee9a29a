"""What the sharded-path tests run on each rank.

``manisdp_tpu_torch.parallel.spawn_ranks`` pickles these functions by
name into spawned processes, so they live in a module of their own that
imports neither jax nor the JAX package (a rank needs only torch).
``run_jobs`` runs a list of jobs on one set of ranks, so a test module
pays for one spawn.
"""

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from manisdp_tpu_torch import kernels as K

RESULT_FIELDS = ("X", "obj", "Y", "y", "S", "z", "gap", "pinf", "dinf",
                 "eta", "gradnorm", "status", "iterations", "fac_size",
                 "rtr_iters", "hess_calls", "history", "sigma", "tier")


def result_dict(res) -> dict:
    """An SDPResult's fields but the wall-clock ``time`` and ``timers``."""
    d = dataclasses.asdict(res)
    return {k: d[k] for k in RESULT_FIELDS}


def run_jobs(jobs):
    """``jobs``: a list of (name, function name in this module, kwargs).
    Returns {name: result}, each job's kernel launches and collectives
    counted from 0 (``counts``)."""
    out = {}
    for name, fn, kw in jobs:
        K.reset_launches()
        res = globals()[fn](**kw)
        out[name] = dict(result=res, launches=dict(K.LAUNCHES),
                         collectives=dict(K.COLLECTIVES))
    return out


def _mesh(kind, nodes=None):
    """A CPU mesh over all ranks: 1-D "model" or "batch", "2d" (batch 2,
    model the rest) or "host" (make_host_mesh over ``nodes``)."""
    from manisdp_tpu_torch.parallel.distributed import make_host_mesh
    from manisdp_tpu_torch.parallel.mesh import make_mesh, make_mesh_2d
    if kind in ("model", "batch"):
        return make_mesh(None, kind, "cpu")
    if kind == "2d":
        return make_mesh_2d(2, dist.get_world_size() // 2, "cpu")
    return make_host_mesh(nodes, device_type="cpu")


def protocol(sharded, arrays, inputs):
    """Every protocol method of this rank's shard (built from the JAX
    ShardedConstraintOp's padded arrays), in f64 and f32; per-shard values
    are assembled into the whole pattern's.  The shards live on the first
    D ranks (D = the arrays' leading size, a group of its own); the other
    ranks return None."""
    from manisdp_tpu_torch.convert import sharded_op_from_jax
    world = sharded["pat_i"].shape[0]
    group = dist.new_group(list(range(world)))
    if dist.get_rank() >= world:
        return None
    sop64 = sharded_op_from_jax(sharded, arrays, dist.get_rank(), "cpu",
                                group)
    out = {}
    for dt in (torch.float64, torch.float32):
        sop = sop64.astype(dt)
        t = {k: torch.as_tensor(v).to(dt) for k, v in inputs.items()
             if k != "sigma"}
        Y, U, w, V, eG = t["Y"], t["U"], t["w"], t["V"], t["eG"]
        sigma = inputs["sigma"]
        es, sv = sop.es_vals(w, sigma), sop.s_vals(w)
        ayu = sop.normal_factored(Y, U)
        whole = sop.global_values
        r = dict(
            pair_dots=whole(sop.pattern_pair_dots(Y, U)),
            apply_factored=sop.apply_factored(Y, U),
            apply_factored_yy=sop.apply_factored(Y),
            adjoint=whole(sop.adjoint_on_pattern(w)),
            es_vals=whole(es), s_vals=whole(sv),
            normal=whole(ayu),
            matmat=sop.matmat_pattern(Y, es),
            matvec=sop.matvec_pattern(V, sv),
            colsum=sop.colsum_pattern(sop.c_pattern *
                                      sop.pattern_pair_dots(Y, U)),
            dot=sop.dot_pattern(sop.c_pattern, sop.pattern_pair_dots(Y)),
            al_hess=sop.al_hess(U, Y, es, ayu, (2.0, 4.0 * sigma)),
            al_hess_diag=sop.al_hess(U, Y, es, ayu, (2.0, 4.0 * sigma),
                                     eG=eG),
            quad_cols=sop.quad_cols(Y, sv))
        out[str(dt)[6:]] = {k: v.numpy() for k, v in r.items()}
    out["local_nnz"] = (sop64.local.pat.nnz, sop64.local.nnz)
    return out


def column_blocks(arrays, inputs, world):
    """The sharded operator's column-block methods (each rank's block of
    its columns, joined by one all-gather) beside the path they replace:
    the rank's block placed in zeros at its columns and all-reduced.  On
    the first ``world`` ranks (a group of their own; the others return
    None), f64 and f32."""
    from manisdp_tpu_torch.parallel.distributed import all_reduce
    from manisdp_tpu_torch.parallel.sharded_ops import ShardedConstraintOp
    group = dist.new_group(list(range(world)))
    if dist.get_rank() >= world:
        return None
    sop64 = ShardedConstraintOp.build(arrays, dist.get_rank(), world, "cpu",
                                      group)
    c0, c1 = sop64.spans[sop64.rank]
    out = dict(spans=sop64.spans, span=sop64.local.pat.span)
    for dt in (torch.float64, torch.float32):
        sop = sop64.astype(dt)
        loc = sop.local
        Y, U, w, V, eG = (torch.as_tensor(inputs[k]).to(dt)
                          for k in ("Y", "U", "w", "V", "eG"))
        es, sv = sop.es_vals(w, inputs["sigma"]), sop.s_vals(w)
        ayu = sop.normal_factored(Y, U)
        coefs = (2.0, 4.0 * inputs["sigma"])
        vals = sop.c_pattern * sop.pattern_pair_dots(Y, U)

        def reduced(block):
            full = torch.zeros(block.shape[:-1] + (sop.n,), dtype=dt)
            full[..., c0:c1] = block
            return all_reduce(full, group)

        pairs = dict(
            matmat=(sop.matmat_pattern(Y, es),
                    reduced(loc.matmat_pattern(Y, es))),
            matvec=(sop.matvec_pattern(V, sv),
                    reduced(loc.matvec_pattern(V, sv).T).T),
            al_hess=(sop.al_hess(U, Y, es, ayu, coefs),
                     reduced(loc.al_hess(U, Y, es, ayu, coefs))),
            al_hess_diag=(sop.al_hess(U, Y, es, ayu, coefs, eG=eG),
                          K.oblique_cols(Y, reduced(loc.al_hess(
                              U, Y, es, ayu, coefs)), "proj", v=U, g=eG)),
            quad_cols=(sop.quad_cols(Y, sv), reduced(loc.quad_cols(Y, sv))),
            colsum=(sop.colsum_pattern(vals),
                    reduced(loc.colsum_pattern(vals)[c0:c1])))
        out[str(dt)[6:]] = {k: (a.numpy(), b.numpy())
                            for k, (a, b) in pairs.items()}
    return out


def al_solve(entry, At, b, c, n, kw, mesh="model", nodes=None):
    """One AL entry point (solve_sdp / solve_unitdiag / solve_unittrace) on
    the CPU under a mesh."""
    import manisdp_tpu_torch
    res = getattr(manisdp_tpu_torch, entry)(
        At, b, c, n, mesh=_mesh(mesh, nodes), device="cpu", **kw)
    return result_dict(res)


def meshes():
    """Shapes and axis names of the port's meshes at this world size, and
    the errors of the meshes it cannot build."""
    from manisdp_tpu_torch.parallel.distributed import (init_distributed,
                                                        make_batch_host_mesh,
                                                        make_host_mesh)
    from manisdp_tpu_torch.parallel.mesh import make_mesh, make_mesh_2d
    world = dist.get_world_size()
    out = {}
    for name, mk in (
            ("model", lambda: make_mesh(None, "model", "cpu")),
            ("model_n", lambda: make_mesh(world, "model", "cpu")),
            ("batch", lambda: make_mesh(world, "batch", "cpu")),
            ("2d", lambda: make_mesh_2d(2, world // 2, "cpu")),
            ("host", lambda: make_host_mesh(device_type="cpu")),
            ("host2", lambda: make_host_mesh(2, device_type="cpu")),
            ("batch_host", lambda: make_batch_host_mesh(2, "cpu"))):
        m = mk()
        out[name] = (tuple(m.shape), tuple(m.mesh_dim_names),
                     tuple(m.get_local_rank(a) for a in m.mesh_dim_names))
    try:
        make_mesh(world - 1, "model", "cpu")
    except ValueError as e:
        out["wrong_count"] = str(e)
    out["init_again"] = init_distributed()
    return out


def batched_rtr(Ys, Cs, typdist, tr):
    """parallel.batched_maxcut_solve on the batch axis of all ranks."""
    from manisdp_tpu_torch.core import TROptions
    from manisdp_tpu_torch.parallel import batched_maxcut_solve
    solve, shard = batched_maxcut_solve(_mesh("batch"), TROptions(**tr))
    res = solve(*shard(Ys, Cs), typdist)
    return dict(Y=res.Y.numpy(), fx=res.fx.numpy(),
                norm_grad=res.norm_grad.numpy(), iters=res.iters,
                inner_iters=res.inner_iters)


def maxcut_batch(Cs, kw, mesh="batch"):
    """solve_maxcut_batch under a mesh (its batch axis, or none)."""
    from manisdp_tpu_torch import solve_maxcut_batch
    res = solve_maxcut_batch(Cs, mesh=_mesh(mesh), device="cpu", **kw)
    return [dict(obj=r.obj, dinf=r.dinf, status=r.status, Y=r.Y,
                 iterations=r.iterations, history=r.history) for r in res]


def sharded_rtr(Y, C, typdist, tr, tcg_mode=None):
    """parallel.sharded_maxcut_solve on the model axis of all ranks (K11's
    mode ``tcg_mode``; on the CPU its twin, the peer mode's summing in
    rank order)."""
    from manisdp_tpu_torch.core import TROptions
    from manisdp_tpu_torch.parallel import sharded_maxcut_solve
    solve, shard = sharded_maxcut_solve(_mesh("model"), TROptions(**tr),
                                        tcg_mode)
    Yl, Cl = shard(Y, C)
    res = solve(Yl, Cl, typdist)
    out = dict(Y=res.Y.numpy(), fx=float(res.fx),
               norm_grad=float(res.norm_grad), iters=res.iters,
               inner_iters=res.inner_iters, local_shape=tuple(Yl.shape),
               cost_shape=tuple(Cl.shape),
               tcg_mode=solve.manifold.tcg_mode)
    try:
        shard(Y[:, :-1], C[:, :-1])
    except ValueError as e:
        out["uneven"] = str(e)
    return out


def batched_sharded_rtr(Ys, Cs, typdist, tr, tcg_mode=None):
    """parallel.batched_sharded_maxcut_solve on a (2, world / 2) (batch,
    model) mesh (K11's mode ``tcg_mode``)."""
    from manisdp_tpu_torch.core import TROptions
    from manisdp_tpu_torch.parallel.mesh import batched_sharded_maxcut_solve
    solve, shard = batched_sharded_maxcut_solve(_mesh("2d"),
                                                TROptions(**tr), tcg_mode)
    Yl, Cl = shard(Ys, Cs)
    res = solve(Yl, Cl, typdist)
    return dict(Y=res.Y.numpy(), fx=res.fx.numpy(),
                norm_grad=res.norm_grad.numpy(), iters=res.iters,
                inner_iters=res.inner_iters, local_shape=tuple(Yl.shape))


def symdual_sharded(cases, mesh):
    """ShardedSymDualOp on the model axis of a CPU mesh ("model": all ranks;
    "2d": the (2, world / 2) mesh's model axis): for each (q, M, y) of
    ``cases``, apply of M, the adjoint of y (its Y4 rows on this rank) and
    the roundtrip apply -> adjoint of M, merged; the collectives of one
    apply and of one adjoint; and the ValueError of a q that the axis does
    not divide."""
    from manisdp_tpu_torch.parallel.symdual_sharded import ShardedSymDualOp
    m = _mesh(mesh)
    out = []
    for q, M, y in cases:
        op = ShardedSymDualOp(q, m)
        K.reset_launches()
        got = op.apply(*op.split_matrix(M))
        coll_apply = dict(K.COLLECTIVES)
        K.reset_launches()
        yt = tuple(torch.as_tensor(t) for t in y)
        W = op.adjoint(yt[:4] + (yt[4][op.rows],))
        coll_adjoint = dict(K.COLLECTIVES)
        out.append(dict(
            q=q, rows=(op.rows.start, op.rows.stop),
            apply=[t.numpy() for t in got],
            adjoint=op.merge_matrix(*W),
            roundtrip=op.merge_matrix(*op.adjoint(got)),
            collectives_apply=coll_apply, collectives_adjoint=coll_adjoint))
    D = int(m.shape[m.mesh_dim_names.index("model")])
    try:
        ShardedSymDualOp(D + 1, m)
    except ValueError as e:
        out.append(str(e))
    return out
