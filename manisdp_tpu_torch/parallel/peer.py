"""K11's peer mode: the receive buffers through which the ranks of a
model axis sum the tCG step's partials on the device (csrc/tcg_step.cu),
and the choice between it and the split mode.

The column-sharded MaxCut RTR (``mesh.sharded_maxcut_solve``) needs two
sums over the ranks in every tCG step.  In split mode K11 runs as three
launches with an ``all_reduce`` of the partials between them; in peer
mode it stays one cooperative launch and each rank writes its partials
into every rank's receive buffer through memory mapped from the peers
(CUDA IPC), then meets them at a flag barrier on the device.

``tcg_mode`` picks the mode once per group: peer where the group's
backend is NCCL, every rank has a card of its own on one host and every
pair of those cards reaches the other's memory
(``torch.cuda.can_device_access_peer``); split elsewhere (gloo, ranks
that share a card, cards without peer access).  Asking for a mode is
explicit (``sharded_maxcut_solve(..., tcg_mode=)``): no error of the peer
mode falls back to the split mode.

``PeerSums(group)`` holds one receive buffer a rank for each (B, nblk,
dtype) that K11 is called with, allocated on first use with the kernel
library's ``cudaMalloc`` (a persistent communication buffer), its IPC
handle exchanged once through ``distributed.all_gather`` (counted in
``kernels.COLLECTIVES``) and the peers' buffers opened with
``cudaIpcOpenMemHandle``.  Every rank must make the same calls, as the
SPMD tCG loop does.  ``close()`` (or ``close_all()``, which
``spawn_ranks`` calls before it destroys the group; an ``atexit`` hook is
the backstop) unmaps the peers' buffers, waits for the group and frees
this rank's.  On CPU tensors K11 runs its twin with ``plain`` =
``distributed.ordered_sum``, the peer mode's order of the sum.
"""

from __future__ import annotations

import atexit
import ctypes
import socket
import zlib
from typing import Callable, Optional

import torch
import torch.distributed as dist

from ..kernels import TCG_TIMEOUT_STOP
from ..kernels.build import build
from .distributed import all_gather, ordered_sum

TCG_MODES = ("split", "peer")
# the size of a cudaIpcMemHandle_t
_HANDLE_BYTES = 64
# every PeerSums not yet closed (close_all, and the atexit backstop)
_OPEN: list = []


def tcg_mode(backend: str, places, can_access: Optional[Callable] = None
             ) -> str:
    """K11's mode on a group: "peer" when ``backend`` is NCCL and the
    ranks' ``places`` ((host, card index) each, in rank order) are
    distinct cards of one host every pair of which reaches the other's
    memory (``can_access(a, b)``, by default
    ``torch.cuda.can_device_access_peer``); else "split"."""
    places = [tuple(p) for p in places]
    if backend != "nccl" or len(set(places)) < len(places) or \
            len({h for h, _ in places}) > 1:
        return "split"
    can_access = can_access or torch.cuda.can_device_access_peer
    cards = [c for _, c in places]
    if all(can_access(a, b) for a in cards for b in cards if a != b):
        return "peer"
    return "split"


def _host_id() -> int:
    return zlib.crc32(socket.gethostname().encode())


def choose_tcg_mode(group) -> str:
    """``tcg_mode`` of ``group``'s backend and ranks: on NCCL each rank's
    (host, card) is all-gathered (counted); elsewhere no communication."""
    backend = dist.get_backend(group)
    if backend != "nccl":
        return "split"
    card = torch.cuda.current_device()
    mine = torch.tensor([[_host_id()], [card]], dtype=torch.int64,
                        device=torch.device("cuda", card))
    places = all_gather(mine, group).T.tolist()
    return tcg_mode(backend, places)


def _check(err: int, what: str):
    if err != 0:
        raise RuntimeError(f"K11 peer mode: {what} failed: CUDA error {err}")


class PeerBuffers:
    """One receive buffer a rank for one (B, nblk, dtype): ``ptrs`` the D
    buffers as this rank maps them (a device int64 array, K11's
    ``bufs``), ``part`` / ``part2`` the addresses of this rank's own
    slots 0, and the epoch of the next step (``next_epoch``)."""

    def __init__(self, lib, group, D: int, me: int, B: int, nblk: int,
                 dtype, device: torch.device):
        self.me, self.world, self.epoch = me, D, 1
        layout = (ctypes.c_int64 * 3)()
        esize = torch.empty((), dtype=dtype).element_size()
        lib.tcg_peer_layout(D, B, nblk, esize, layout)
        nbytes, off1, off2 = layout
        own = ctypes.c_void_p()
        handle = (ctypes.c_uint8 * _HANDLE_BYTES)()
        with torch.cuda.device(device):
            _check(lib.tcg_peer_alloc(nbytes, ctypes.byref(own), handle),
                   "cudaMalloc / cudaIpcGetMemHandle of a receive buffer")
        self.own, self.opened = own.value, []
        if D > 1:
            # the handles of every rank, (64, D) in rank order
            mine = torch.tensor(list(handle), dtype=torch.uint8,
                                device=device)[:, None]
            handles = all_gather(mine, group).T.cpu()
        addrs = []
        for q in range(D):
            if q == me:
                addrs.append(self.own)
                continue
            h = (ctypes.c_uint8 * _HANDLE_BYTES)(*handles[q].tolist())
            ptr = ctypes.c_void_p()
            with torch.cuda.device(device):
                _check(lib.tcg_peer_open(h, ctypes.byref(ptr)),
                       f"cudaIpcOpenMemHandle of rank {q}'s buffer")
            self.opened.append(ptr.value)
            addrs.append(ptr.value)
        self.ptrs = torch.tensor(addrs, dtype=torch.int64, device=device)
        self.part, self.part2 = self.own + off1, self.own + off2

    def next_epoch(self) -> int:
        """This step's epoch (its two barriers use it and it + 1)."""
        e = self.epoch
        self.epoch += 2
        return e

    def fault(self, lib):
        """(epoch, peer) of this rank's last time-out, (0, 0) if none."""
        rec = (ctypes.c_uint64 * 2)()
        _check(lib.tcg_peer_read(self.own + 8 * self.world, rec, 16),
               "reading the fault record")
        return tuple(rec)


class PeerSums:
    """K11's peer mode on the ranks of ``group`` (None: one rank, no
    communication): receive buffers per (B, nblk, dtype), made on first
    use; ``plain`` the CPU twin's sum."""

    def __init__(self, group=None):
        self.group = group
        self.world = 1 if group is None else dist.get_world_size(group)
        self.me = 0 if group is None else dist.get_rank(group)
        self._sets: dict = {}
        self._closed = False
        _OPEN.append(self)

    def plain(self, t: torch.Tensor) -> torch.Tensor:
        return t if self.group is None else ordered_sum(t, self.group)

    def buffers(self, B: int, nblk: int, dtype, device) -> PeerBuffers:
        if self._closed:
            raise RuntimeError("K11 peer mode: the receive buffers are "
                               "closed")
        key = (B, nblk, dtype)
        if key not in self._sets:
            self._sets[key] = PeerBuffers(build(), self.group, self.world,
                                          self.me, B, nblk, dtype,
                                          torch.device(device))
        return self._sets[key]

    def timeout_message(self) -> str:
        """What the tCG loop raises with on the time-out stop code."""
        lib = build()
        faults = [s.fault(lib) for s in self._sets.values()]
        epoch, peer = max(faults) if faults else (0, 0)
        return (f"K11 peer mode: rank {self.me} of {self.world} waited "
                f"more than 10 s for rank {peer}'s flag at epoch {epoch} "
                f"(stop code {TCG_TIMEOUT_STOP}); a peer stopped or lags")

    def close(self, wait: bool = True):
        """Unmap the peers' buffers, then (``wait``: after every rank of
        the group has unmapped ours) free this rank's.  Call it on every
        rank, after the ranks' last collective of the solve."""
        if self._closed:
            return
        self._closed = True
        if self in _OPEN:
            _OPEN.remove(self)
        if not self._sets:
            return
        lib = build()
        torch.cuda.synchronize()
        for s in self._sets.values():
            for ptr in s.opened:
                _check(lib.tcg_peer_close(ctypes.c_void_p(ptr)),
                       "cudaIpcCloseMemHandle")
        if wait and self.world > 1 and dist.is_initialized():
            dist.barrier(group=self.group)
        for s in self._sets.values():
            _check(lib.tcg_peer_free(ctypes.c_void_p(s.own)), "cudaFree")
        self._sets.clear()


def close_all(wait: bool = True):
    """Close every open PeerSums of this process (``PeerSums.close``)."""
    for p in list(_OPEN):
        p.close(wait)


@atexit.register
def _close_at_exit():
    # the backstop: the group may be gone, so no barrier
    close_all(wait=False)
