"""Multi-process execution on ``torch.distributed`` (PyTorch port of
manisdp_tpu/parallel/distributed.py).

The port runs SPMD with one process per rank: every rank calls the same
entry point with the same inputs, holds its shard of the work on its own
device and meets the others only in four collectives, ``all_reduce``
(SUM), ``broadcast``, ``all_to_all`` (equal splits) and ``all_gather``
(column blocks joined; the functions below, which count their calls and
bytes in ``kernels.COLLECTIVES``).  All run on NCCL and on gloo, on CUDA
and on CPU tensors:

  - NCCL needs one card per rank (it refuses two ranks on one device);
  - gloo runs the CPU tests, and ranks that share one card (it stages
    CUDA all-reduces through the host itself; ``all_to_all`` and
    ``all_gather`` copy CUDA tensors to the host and back here, counted
    as ``host_staged``).

  - ``init_distributed()`` reads torchrun's variables (MASTER_ADDR,
    MASTER_PORT, WORLD_SIZE, RANK, LOCAL_RANK) or explicit arguments; a
    no-op for one process, as the JAX function is;
  - ``make_host_mesh()`` / ``make_batch_host_mesh()`` build a 2-D
    ``DeviceMesh`` whose outer axis is the node (WORLD_SIZE //
    LOCAL_WORLD_SIZE nodes), so the inner axis's all-reduces stay inside
    a node;
  - ``spawn_ranks(fn, world, ...)`` runs ``fn`` on ``world`` spawned
    ranks with a FileStore rendezvous in a temporary directory (no TCP
    port) and returns each rank's result: the tests' and
    ``chip_smoke.py``'s counterpart of the JAX tests' virtual CPU mesh;
  - ``ordered_sum`` is the sum over ranks in rank order of K11's peer
    mode (parallel/peer.py), for its plain twin.
"""

from __future__ import annotations

import datetime
import os
import pickle
import shutil
import tempfile
from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..kernels import COLLECTIVES

# a collective that waits longer than this raises instead of hanging
TIMEOUT = datetime.timedelta(seconds=600)


def _backend_for(device: torch.device, backend: Optional[str]) -> str:
    if backend is None:
        return "nccl" if device.type == "cuda" else "gloo"
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend must be 'nccl' or 'gloo', got {backend!r}")
    if backend == "nccl" and device.type != "cuda":
        raise ValueError("NCCL runs on CUDA devices only")
    return backend


def _set_device(device: torch.device) -> torch.device:
    """Make ``device`` this process's current CUDA device (a no-op on the
    CPU); returns it with its index."""
    if device.type != "cuda":
        return device
    if not torch.cuda.is_available():
        raise RuntimeError("device='cuda' but torch finds no CUDA device")
    index = device.index if device.index is not None else \
        int(os.environ.get("LOCAL_RANK", "0"))
    if index >= torch.cuda.device_count():
        raise ValueError(f"rank wants cuda:{index}, the node has "
                         f"{torch.cuda.device_count()} card(s)")
    torch.cuda.set_device(index)
    return torch.device("cuda", index)


def _init_group(backend: str, rank: int, world: int,
                init_method: Optional[str] = None, store=None):
    """init_process_group on an explicit rendezvous (``store`` or
    ``init_method``); the rank's CUDA device is already current."""
    kw = dict(backend=backend, rank=rank, world_size=world, timeout=TIMEOUT)
    if store is not None:
        kw["store"] = store
    else:
        kw["init_method"] = init_method
    dist.init_process_group(**kw)


def init_distributed(init_method: Optional[str] = None,
                     world_size: Optional[int] = None,
                     rank: Optional[int] = None,
                     local_rank: Optional[int] = None,
                     backend: Optional[str] = None,
                     device="cuda") -> bool:
    """Initialize the default process group when running multi-process.

    Returns True if a group was initialized here or already existed,
    False for one process (a no-op).  The arguments default to torchrun's
    variables: ``init_method`` to ``env://`` (MASTER_ADDR / MASTER_PORT),
    ``world_size`` to WORLD_SIZE, ``rank`` to RANK and ``local_rank`` to
    LOCAL_RANK.  On ``device="cuda"`` the current card becomes
    cuda:``local_rank`` and the backend NCCL; on the CPU it is gloo.
    ``backend="gloo"`` on CUDA runs ranks that share a card (pass
    ``device="cuda:0"``)."""
    if dist.is_available() and dist.is_initialized():
        return True
    if world_size is None:
        world_size = int(os.environ.get("WORLD_SIZE", "1"))
    if world_size <= 1:
        return False
    if not dist.is_available():
        raise RuntimeError("this torch build has no torch.distributed")
    if rank is None:
        rank = int(os.environ["RANK"])
    if local_rank is None:
        local_rank = int(os.environ.get("LOCAL_RANK", "0"))
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", local_rank)
    device = _set_device(device)
    _init_group(_backend_for(device, backend), rank, world_size,
                init_method=init_method or "env://")
    return True


def _node_count(world: int, nodes: Optional[int]) -> int:
    if nodes is None:
        per = int(os.environ.get("LOCAL_WORLD_SIZE", str(world)))
        nodes = max(world // max(per, 1), 1)
    if world % nodes:
        raise ValueError(f"{world} ranks do not split into {nodes} nodes")
    return nodes


def rank_grid(world: int, nodes: int) -> np.ndarray:
    """Ranks reshaped (nodes, per_node), node-major: torchrun numbers the
    ranks of one node consecutively, so row k holds node k's ranks and
    axis-1 collectives stay inside a node (the JAX ``_device_grid``)."""
    return np.arange(world).reshape(nodes, world // nodes)


def make_host_mesh(nodes: Optional[int] = None,
                   axis_names=("dcn", "model"), device_type="cuda"):
    """2-D ``DeviceMesh`` over all ranks with the node axis outermost:
    (nodes, world // nodes).  ``nodes`` defaults to WORLD_SIZE //
    LOCAL_WORLD_SIZE; on one node the mesh is (1, world)."""
    from .mesh import _require_group
    world = _require_group(None, device_type)
    nodes = _node_count(world, nodes)
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type, tuple(rank_grid(world, nodes).shape),
                            mesh_dim_names=tuple(axis_names))


def make_batch_host_mesh(nodes: Optional[int] = None, device_type="cuda"):
    """(batch, model) mesh with one instance group per node: the instance
    axis never communicates during a solve, so it is the axis to put
    between nodes."""
    return make_host_mesh(nodes, ("batch", "model"), device_type)


# --------------------------------------------------------- collectives --

def all_reduce(t: torch.Tensor, group=None) -> torch.Tensor:
    """The SUM of ``t`` over ``group``'s ranks, in place (``t`` is
    returned); counted in COLLECTIVES."""
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    COLLECTIVES["all_reduce"] += 1
    COLLECTIVES["all_reduce_bytes"] += t.numel() * t.element_size()
    return t


def broadcast(t: torch.Tensor, group=None, src_index: int = 0
              ) -> torch.Tensor:
    """``t`` from the group's rank ``src_index`` to every rank of
    ``group``, in place; counted in COLLECTIVES."""
    src = dist.get_global_rank(group, src_index) if group is not None \
        else src_index
    dist.broadcast(t, src=src, group=group)
    COLLECTIVES["broadcast"] += 1
    COLLECTIVES["broadcast_bytes"] += t.numel() * t.element_size()
    return t


def _host_staged(t: torch.Tensor, group) -> bool:
    """Whether a collective on ``t`` runs through host copies made here:
    gloo given CUDA tensors (NCCL, and gloo on CPU tensors, take them as
    they are)."""
    return t.device.type == "cuda" and dist.get_backend(group) == "gloo"


def all_to_all(send: torch.Tensor, recv: torch.Tensor, group=None
               ) -> torch.Tensor:
    """Equal-split all-to-all over ``group``: block g of ``send`` (along
    dim 0, one block per group rank) goes to rank g, and ``recv``'s block
    g (same shape as ``send``) comes from rank g.  Both contiguous;
    ``recv`` is returned.  Counted in COLLECTIVES (bytes: ``send``'s)."""
    if send.shape != recv.shape or not (send.is_contiguous() and
                                        recv.is_contiguous()):
        raise ValueError("all_to_all takes contiguous send / recv tensors "
                         "of one shape")
    if _host_staged(send, group):
        COLLECTIVES["host_staged"] += 1
        staged = torch.empty(recv.shape, dtype=recv.dtype)
        dist.all_to_all_single(staged, send.cpu(), group=group)
        recv.copy_(staged)
    else:
        dist.all_to_all_single(recv, send, group=group)
    COLLECTIVES["all_to_all"] += 1
    COLLECTIVES["all_to_all_bytes"] += send.numel() * send.element_size()
    return recv


# torch's name for the flat all-gather (all_gather_into_tensor before 2.13)
_gather_single = getattr(dist, "all_gather_single", None) or \
    dist.all_gather_into_tensor


def all_gather(t: torch.Tensor, group=None) -> torch.Tensor:
    """Every group rank's ``t`` (..., k) joined along the last axis in group
    rank order: (..., D k), a new tensor on ``t``'s device (the column
    blocks of a factor back into the whole factor).  Counted in
    COLLECTIVES (bytes: ``t``'s)."""
    D = dist.get_world_size(group)
    t = t.contiguous()
    # the blocks stacked along a leading axis (gloo wants them flat)
    flat = (D * t.numel(),)
    if _host_staged(t, group):
        COLLECTIVES["host_staged"] += 1
        out = torch.empty(flat, dtype=t.dtype)
        _gather_single(out, t.cpu().reshape(-1), group=group)
        out = out.to(t.device)
    else:
        out = torch.empty(flat, dtype=t.dtype, device=t.device)
        _gather_single(out, t.reshape(-1), group=group)
    COLLECTIVES["all_gather"] += 1
    COLLECTIVES["all_gather_bytes"] += t.numel() * t.element_size()
    out = out.view((D,) + tuple(t.shape))
    return torch.movedim(out, 0, -2).reshape(tuple(t.shape[:-1]) +
                                             (D * t.shape[-1],))


def ordered_sum(t: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of ``t`` over ``group``'s ranks, entry by entry in rank
    order, ((t_0 + t_1) + t_2) + ..., in place (``t`` is returned): the
    order of K11's peer mode, which sums on the device, and the sum of its
    plain twin (the CPU tests; nothing on the card's path calls it).  One
    all-gather (counted in COLLECTIVES)."""
    parts = all_gather(t.unsqueeze(-1), group)
    s = parts[..., 0].clone()
    for q in range(1, parts.shape[-1]):
        s += parts[..., q]
    return t.copy_(s)


def gather_objects(obj, group, device: torch.device) -> list:
    """Each rank's ``obj`` (picklable) on every rank of ``group``, in group
    rank order: one object broadcast from each rank."""
    out = []
    me = dist.get_rank(group)
    for q in range(dist.get_world_size(group)):
        box = [obj if q == me else None]
        dist.broadcast_object_list(box, src=dist.get_global_rank(group, q),
                                   group=group,
                                   device=device if device.type == "cuda"
                                   else None)
        COLLECTIVES["broadcast"] += 1
        out.append(box[0])
    return out


# ------------------------------------------------------------ launcher --

def _rank_main(rank, fn, world, backend, device, tmp, args, threads):
    if threads is not None:
        torch.set_num_threads(threads)
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", rank % torch.cuda.device_count())
    os.environ["LOCAL_RANK"] = str(rank if dev.index is None else dev.index)
    dev = _set_device(dev)
    store = dist.FileStore(os.path.join(tmp, "store"), world)
    _init_group(backend, rank, world, store=store)
    try:
        out = fn(*args)
        dist.barrier()
    finally:
        from .peer import close_all
        close_all(wait=dist.is_initialized())
        dist.destroy_process_group()
    with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def spawn_ranks(fn: Callable, world: int, backend: str = "gloo",
                device="cuda", args: tuple = (),
                threads: Optional[int] = None) -> list:
    """Run ``fn(*args)`` on ``world`` ranks, each a spawned process with the
    default process group initialized (``backend``) and its device set,
    and return the ranks' return values in rank order.

    ``device``: "cuda" (the default) puts rank r on cuda:(r % cards) and
    raises without a card, before any rank starts; "cuda:0" puts every
    rank on card 0 (gloo only: NCCL refuses two ranks on one card); "cpu"
    runs the ranks on the CPU, only when asked.  The rendezvous is a FileStore in a temporary directory.
    ``threads``: torch and BLAS threads per rank (the BLAS variables are
    set for the children only).  ``fn`` and ``args`` must pickle: ``fn``
    a function defined at a module's top level.  A rank that raises makes
    this raise, with its traceback."""
    import torch.multiprocessing as mp
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device={device!r} but torch finds no CUDA "
                           "device; pass device='cpu' to run the ranks on "
                           "the CPU")
    backend = _backend_for(dev, backend)
    if backend == "nccl":
        cards = torch.cuda.device_count()
        if dev.index is not None and world > 1:
            raise ValueError("NCCL needs one card per rank; pass "
                             "device='cuda' (rank r on cuda:r)")
        if world > cards:
            raise ValueError(f"NCCL needs one card per rank: {world} ranks, "
                             f"{cards} card(s)")
    tmp = tempfile.mkdtemp(prefix="manisdp_ranks_")
    saved = {}
    if threads is not None:
        for var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS",
                    "MKL_NUM_THREADS"):
            saved[var] = os.environ.get(var)
            os.environ[var] = str(threads)
    try:
        mp.spawn(_rank_main, args=(fn, world, backend, str(dev), tmp, args,
                                   threads), nprocs=world, join=True)
        out = []
        for r in range(world):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out
    finally:
        for var, val in saved.items():
            if val is None:
                os.environ.pop(var, None)
            else:
                os.environ[var] = val
        shutil.rmtree(tmp, ignore_errors=True)
