"""Device meshes, the model-sharded MaxCut RTR and the data-parallel
batch (PyTorch port of manisdp_tpu/parallel/mesh.py).

A mesh is a ``torch.distributed.device_mesh.DeviceMesh``, PyTorch's
counterpart of ``jax.sharding.Mesh``: named axes over ranks, one rank
per place (one process per card, or per CPU rank under gloo).  Two axes
are used:

  - ``model``: the matrix dimension n, or the constraint pattern.  In
    ``sharded_maxcut_solve`` the factor Y (p, n) and the dense cost C are
    column-sharded, a contiguous block of n / D columns a rank: Y and the
    tCG's direction are all-gathered before Y·C_local and U·C_local
    (``torch.matmul``, as the JAX package leaves the products to XLA),
    the oblique column ops (K2, and K11 in its peer or split mode) run on
    the local columns, and every inner product, norm and the cost are
    all-reduced (``ShardedOblique``), so every rank takes the same host
    branches.  In the primal AL the constraint pattern is sharded by
    pattern id (``sharded_ops.ShardedConstraintOp``; ``mesh=`` of
    ``solve_sdp`` / ``solve_unitdiag`` / ``solve_unittrace``);
  - ``batch``: independent MaxCut instances, a contiguous block of the
    batch per rank (``batched_maxcut_solve``; ``solve_maxcut_batch``'s
    ``mesh=``), with no communication until the results are assembled;
    on a (batch, model) mesh ``batched_sharded_maxcut_solve`` composes
    both.

Where the JAX ``make_mesh(n)`` takes the first n local devices, a mesh
here needs exactly as many ranks as it has places (ROADMAP Queue C).
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..core import (Problem, TROptions, make_batched_trustregions,
                    make_trustregions)
from ..manifolds import Oblique
from .distributed import (_set_device, all_gather, all_reduce,
                          gather_objects, init_distributed)
from .peer import TCG_MODES, PeerSums, choose_tcg_mode


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


def _mesh_device(mesh) -> torch.device:
    """This rank's device on ``mesh``: the current card, or the CPU."""
    device = torch.device(mesh.device_type)
    if device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def _put(a, index, device) -> torch.Tensor:
    """``a[index]`` (numpy or a tensor) as a contiguous float64 tensor on
    ``device``."""
    part = a[index] if isinstance(a, torch.Tensor) else np.asarray(a)[index]
    return torch.as_tensor(part, dtype=torch.float64,
                           device=device).contiguous()


class ShardedOblique(Oblique):
    """The oblique manifold on this rank's contiguous block of columns of
    a factor sharded over the ranks of ``group``: the column ops are
    Oblique's on the local columns (K2; K11 projects), ``inner`` /
    ``norm`` sum over the local columns and all-reduce, and ``reduce`` is
    the sum over the ranks (the tCG's ||r||^2, and K11's partials in its
    split mode, core/trustregions.py).  ``tcg_mode``: K11's mode, "peer"
    (``peer`` is then the group's PeerSums and K11 sums its partials on
    the device), "split", or None to choose once for the group
    (``peer.choose_tcg_mode``: peer on NCCL with peer access between
    every pair of the ranks' cards).  At one rank every value has the
    bits of Oblique's."""

    def __init__(self, group, tcg_mode: Optional[str] = None):
        if tcg_mode not in (None,) + TCG_MODES:
            raise ValueError(f"tcg_mode must be one of {TCG_MODES} or None, "
                             f"got {tcg_mode!r}")
        self.group = group
        self.tcg_mode = tcg_mode or choose_tcg_mode(group)
        self.peer = PeerSums(group) if self.tcg_mode == "peer" else None

    def close(self):
        """Free the peer mode's receive buffers (on every rank)."""
        if self.peer is not None:
            self.peer.close()

    def reduce(self, t):
        return all_reduce(t, self.group)

    def inner(self, x, u, v):
        return self.reduce(torch.sum(u * v, dim=(-2, -1)))

    def norm(self, x, u):
        return torch.sqrt(self.reduce(torch.sum(u * u, dim=(-2, -1))))


def sharded_maxcut_problem(group, tcg_mode: Optional[str] = None
                           ) -> Problem:
    """make_maxcut_problem(dense=True) of solvers/maxcut.py on column
    shards: Y, U (..., p, n/D) and C (..., n, n/D) this rank's columns.
    Y (or U) is all-gathered before the product with C's columns; eG and
    the Hessian's column sums are local, f is all-reduced.  ``tcg_mode``:
    K11's (ShardedOblique)."""
    M = ShardedOblique(group, tcg_mode)

    def cost(Y, C):
        YC = all_gather(Y, group) @ C
        eG = torch.sum(YC * Y, dim=-2)
        return 0.5 * M.reduce(torch.sum(eG, dim=-1)), (YC, eG)

    def grad(Y, C, aux):
        YC, eG = aux
        return YC - Y * eG[..., None, :], ()

    def hess(Y, U, C, aux, gaux):
        _, eG = aux
        UC = all_gather(U, group) @ C
        return UC - Y * torch.sum(Y * UC, dim=-2, keepdim=True) \
            - U * eG[..., None, :]

    return Problem(manifold=M, cost=cost, grad=grad, hess=hess)


def model_cols(n: int, D: int, me: int) -> slice:
    """Rank ``me``'s contiguous columns of n split over D ranks of a model
    axis (D divides n)."""
    if n % D:
        raise ValueError(f"n = {n} columns do not split over {D} ranks of "
                         "the model axis")
    return slice(me * (n // D), (me + 1) * (n // D))


def sharded_maxcut_solve(mesh, tr_opts: Optional[TROptions] = None,
                         tcg_mode: Optional[str] = None):
    """The RTR solve with Y and the dense C column-sharded over the mesh
    axis ``model``.

    Returns (solve, shard_fn): ``shard_fn(Y, C)`` takes the whole (p, n)
    factor and (n, n) cost (numpy or tensors) and returns this rank's
    column blocks, (p, n/D) and (n, n/D), on its device (ValueError when D
    does not divide n); ``solve(Y, C, typicaldist)`` runs the RTR on them
    and returns its TRResult with the whole Y on every rank, as the JAX
    solve returns a global array.  ``tcg_mode``: K11's mode
    (ShardedOblique; None chooses for the group); ``solve.manifold`` is
    the ShardedOblique (``solve.manifold.close()`` frees the peer mode's
    buffers; ``spawn_ranks`` and the process's exit close them too)."""
    tr_opts = tr_opts or TROptions(maxiter=4, maxinner=10,
                                   tolgradnorm=1e-8)
    D, me, group = mesh_axis(mesh, "model")
    problem = sharded_maxcut_problem(group, tcg_mode)
    base = make_trustregions(problem, tr_opts)
    device = _mesh_device(mesh)

    def shard_fn(Y, C):
        cols = model_cols(Y.shape[-1], D, me)
        return (_put(Y, (slice(None), cols), device),
                _put(C, (slice(None), cols), device))

    def solve(Y, C, typicaldist):
        res = base(Y, C, typicaldist)
        return res._replace(Y=all_gather(res.Y, group))

    solve.manifold = problem.manifold
    return solve, shard_fn


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
    device = _mesh_device(mesh)

    def shard_fn(Ys, Cs):
        if len(Cs) != len(Ys):
            raise ValueError(f"{len(Ys)} factors and {len(Cs)} costs")
        rows = batch_rows(len(Ys), D, me)
        return _put(Ys, rows, device), _put(Cs, rows, device)

    def solve(Ys, Cs, typicaldist):
        return _gather_batch(base(Ys, Cs, typicaldist), group, device)

    return solve, shard_fn


def _gather_batch(res, group, device):
    """A BatchedTRResult of this rank's rows of the batch, assembled over
    the batch axis ``group`` on every rank."""
    Y, fx, ng, it, inner = gather_rows(
        (res.Y.cpu(), res.fx.cpu(), res.norm_grad.cpu(),
         np.asarray(res.iters), np.asarray(res.inner_iters)), group, device)
    return type(res)(Y=Y.to(device), fx=fx.to(device),
                     norm_grad=ng.to(device), iters=it.numpy(),
                     inner_iters=inner.numpy())


def batched_sharded_maxcut_solve(mesh, tr_opts: Optional[TROptions] = None,
                                 tcg_mode: Optional[str] = None):
    """2-D (batch x model) parallelism on a ``make_mesh_2d`` mesh: the
    instance batch split over ``batch`` and each instance's factor and
    cost column-sharded over ``model`` (sharded_maxcut_solve's algebra on
    the port's batched RTR); only the model axis communicates during the
    solve, K11's peer mode (``tcg_mode``, as sharded_maxcut_solve's) on
    the model subgroup with the rank's B instances in one launch.

    Returns (solve, shard_fn): ``shard_fn(Ys, Cs)`` takes the whole batch,
    (B, p, n) factors and (B, n, n) dense costs, and returns this rank's
    rows (``batch_rows``) and columns (``model_cols``), (B/Db, p, n/Dm)
    and (B/Db, n, n/Dm); ``solve(Ys, Cs, typicaldist)`` returns the whole
    batch's BatchedTRResult on every rank."""
    tr_opts = tr_opts or TROptions(maxiter=4, maxinner=10,
                                   tolgradnorm=1e-8)
    Db, mb, bgroup = mesh_axis(mesh, "batch")
    Dm, mm, mgroup = mesh_axis(mesh, "model")
    problem = sharded_maxcut_problem(mgroup, tcg_mode)
    base = make_batched_trustregions(problem, tr_opts)
    device = _mesh_device(mesh)

    def shard_fn(Ys, Cs):
        if len(Cs) != len(Ys):
            raise ValueError(f"{len(Ys)} factors and {len(Cs)} costs")
        rows = batch_rows(len(Ys), Db, mb)
        cols = model_cols(Ys.shape[-1], Dm, mm)
        return (_put(Ys, (rows, slice(None), cols), device),
                _put(Cs, (rows, slice(None), cols), device))

    def solve(Ys, Cs, typicaldist):
        res = base(Ys, Cs, typicaldist)
        return _gather_batch(res._replace(Y=all_gather(res.Y, mgroup)),
                             bgroup, device)

    solve.manifold = problem.manifold
    return solve, shard_fn
