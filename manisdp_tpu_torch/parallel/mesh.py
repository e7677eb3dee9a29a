"""Device meshes and the data-parallel batch (PyTorch port of
manisdp_tpu/parallel/mesh.py).

A mesh is a ``torch.distributed.device_mesh.DeviceMesh``, PyTorch's
counterpart of ``jax.sharding.Mesh``: named axes over ranks, one rank
per place (one process per card, or per CPU rank under gloo).  Two axes
are used:

  - ``model``: the constraint pattern of the primal AL, sharded by
    pattern id (``sharded_ops.ShardedConstraintOp``; ``mesh=`` of
    ``solve_sdp`` / ``solve_unitdiag`` / ``solve_unittrace``);
  - ``batch``: independent MaxCut instances, a contiguous block of the
    batch per rank (``batched_maxcut_solve``; ``solve_maxcut_batch``'s
    ``mesh=``), with no communication until the results are assembled.

Where the JAX ``make_mesh(n)`` takes the first n local devices, a mesh
here needs exactly as many ranks as it has places (ROADMAP Queue C).
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..core import TROptions, make_batched_trustregions
from .distributed import _set_device, gather_objects, init_distributed


def _require_group(n: Optional[int], device_type: str = "cuda") -> int:
    """The world size of the default process group, which must equal ``n``
    (when given).  Without a group, a process that torchrun started as one
    of several (WORLD_SIZE > 1) joins them (``init_distributed``); one
    process alone gets a one-rank group (a mesh of one place), as the JAX
    ``make_mesh(1)`` needs no runtime."""
    if not dist.is_initialized() and \
            int(os.environ.get("WORLD_SIZE", "1")) > 1:
        init_distributed(device=device_type)
    if not dist.is_initialized():
        if n not in (None, 1):
            raise ValueError(
                f"a mesh of {n} places needs {n} ranks: start them with "
                "torchrun or parallel.spawn_ranks and call "
                "init_distributed() first")
        device = _set_device(torch.device(device_type))
        dist.init_process_group(
            "nccl" if device.type == "cuda" else "gloo",
            store=dist.HashStore(), rank=0, world_size=1)
    world = dist.get_world_size()
    if n is not None and n != world:
        raise ValueError(
            f"a mesh of {n} places needs {n} ranks, the process group has "
            f"{world}: one rank per place (the JAX make_mesh takes the "
            "first n devices; here run n ranks)")
    return world


def make_mesh(n_devices: Optional[int] = None, axis_name: str = "model",
              device_type: str = "cuda"):
    """A 1-D mesh over all ranks with the axis ``axis_name``.
    ``n_devices`` must equal the world size when given."""
    from torch.distributed.device_mesh import init_device_mesh
    world = _require_group(n_devices, device_type)
    return init_device_mesh(device_type, (world,),
                            mesh_dim_names=(axis_name,))


def make_mesh_2d(batch: int, model: int, device_type: str = "cuda"):
    """A (batch, model) mesh over batch * model ranks."""
    from torch.distributed.device_mesh import init_device_mesh
    _require_group(batch * model, device_type)
    return init_device_mesh(device_type, (batch, model),
                            mesh_dim_names=("batch", "model"))


def mesh_axis(mesh, name: str):
    """(size, this rank's index, process group) of ``mesh``'s axis
    ``name``."""
    names = tuple(mesh.mesh_dim_names or ())
    if name not in names:
        raise ValueError(f"the mesh has axes {names}, not {name!r}")
    return (int(mesh.shape[names.index(name)]), mesh.get_local_rank(name),
            mesh.get_group(name))


def _maxcut_problem():
    """The production MaxCut subproblem on the dense cost (the single-card
    driver's, so the batch cannot drift from it)."""
    from ..solvers.maxcut import make_maxcut_problem
    return make_maxcut_problem(dense=True)


def batch_rows(B: int, D: int, me: int) -> slice:
    """Rank ``me``'s contiguous rows of a batch of B instances split over
    D ranks of a batch axis (D divides B)."""
    if B % D:
        raise ValueError(f"a batch of {B} instances does not split over "
                         f"{D} ranks")
    return slice(me * (B // D), (me + 1) * (B // D))


def gather_rows(part, group, device):
    """Each rank's rows of the batch (``batch_rows``) joined in rank order,
    on every rank of the batch axis ``group``: a list of per-instance
    results, or a tuple of arrays with the batch first (each joined into
    one host tensor)."""
    parts = gather_objects(part, group, device)
    if isinstance(part, list):
        return [r for p in parts for r in p]
    return tuple(torch.cat([torch.as_tensor(p[f]) for p in parts])
                 for f in range(len(part)))


def batched_maxcut_solve(mesh, tr_opts: Optional[TROptions] = None):
    """The batched RTR solve over an instance batch sharded over the mesh
    axis ``batch`` (data parallelism over independent SDP instances).

    Returns (solve, shard_fn): ``shard_fn(Ys, Cs)`` takes the whole batch,
    (B, p, n) factors and (B, n, n) dense costs (numpy or tensors), and
    returns this rank's contiguous B / D rows on its device;
    ``solve(Ys, Cs, typicaldist)`` runs the port's batched RTR on them and
    returns the whole batch's BatchedTRResult, assembled on every rank
    (``gather_rows``)."""
    tr_opts = tr_opts or TROptions(maxiter=4, maxinner=10,
                                   tolgradnorm=1e-8)
    base = make_batched_trustregions(_maxcut_problem(), tr_opts)
    D, me, group = mesh_axis(mesh, "batch")
    device = torch.device(mesh.device_type)
    if device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())

    def shard_fn(Ys, Cs):
        if len(Cs) != len(Ys):
            raise ValueError(f"{len(Ys)} factors and {len(Cs)} costs")
        rows = batch_rows(len(Ys), D, me)
        put = lambda a: torch.as_tensor(  # noqa: E731
            np.asarray(a[rows]) if not isinstance(a, torch.Tensor)
            else a[rows], dtype=torch.float64, device=device).contiguous()
        return put(Ys), put(Cs)

    def solve(Ys, Cs, typicaldist):
        res = base(Ys, Cs, typicaldist)
        Y, fx, ng, it, inner = gather_rows(
            (res.Y.cpu(), res.fx.cpu(), res.norm_grad.cpu(),
             np.asarray(res.iters), np.asarray(res.inner_iters)),
            group, device)
        return type(res)(Y=Y.to(device), fx=fx.to(device),
                         norm_grad=ng.to(device), iters=it.numpy(),
                         inner_iters=inner.numpy())

    return solve, shard_fn
