"""Row-sharded expanded-pair-basis SOS-dual operator (PyTorch port of
manisdp_tpu/parallel/symdual_sharded.py).

The q^4 tensors are the memory wall of the large-q SOS dual
(ops/symdual.py): at q = 120 every f64 (q, q, q, q) array is 1.66 GB.
Here every q^4 object is sharded over the ranks of one mesh axis
(``model``, D ranks, D dividing q) on its leading grid index:

  matrix   : the expanded (n~, n~) matrix M (n~ = 2 + q + q^2) splits into
             ``top`` = its first 2 + q rows (replicated, O(q^3)) and
             ``rowsQ`` = the q x q grid rows, (q, q, n~), of which a rank
             holds the block (q/D, q, n~) at rows [off, off + q/D);
  m-space  : the per-degree tuple (y0, y1, Y2, Y3, Y4) keeps y0 .. Y3
             whole on every rank and shards Y4 on its leading index.

``apply`` (the class sums) is kernel K7's row-block mode
(``kernels.symdual_apply_rows``): the pair swap (1, 0, 2, 3) and the
swap of the pairs (2, 3, 0, 1) of the degree-4 symmetrization cross the
shards, one ``all_to_all`` each (``distributed.all_to_all``; none at
D = 1, where every row is local); the partial sums of degrees 0-3 are
all-reduced once.  ``adjoint`` (the
masked broadcast) is K8's row-block mode
(``kernels.symdual_adjoint_rows``): a rank's output rows depend only on
y0 .. Y3 and its own Y4 rows, so it needs no communication.  On CPU
tensors both run their plain twins, the torch ports of the JAX
functions (ops/symdual.py ``_apply_sharded_tensor``,
``_adjoint_sharded_tensor``), with the same collectives.

Per-rank memory is about 4 q^4 / D + O(q^3) during an apply at D > 1
(the local Q block, the two all-to-all buffers, which hold P2's own rows
and the received columns in turn, and Y4's rows), 3 q^4 + O(q^3) at
D = 1 (one q^4 workspace).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ..kernels import symdual_adjoint_rows, symdual_apply_rows
from .distributed import all_gather, all_reduce, all_to_all
from .mesh import _mesh_device, mesh_axis


def _offset(q, ql, group):
    return dist.get_rank(group) * ql


def apply_sharded(top, rowsQ, q: int, group=None):
    """Per-degree class sums of the row-sharded expanded matrix on this
    rank of ``group``: ``top`` (2 + q, n~) replicated, ``rowsQ`` (q/D, q,
    n~) this rank's Q-grid rows (the group rank r holds rows [r q/D, (r +
    1) q/D)).  Returns (y0, y1, Y2, Y3, Y4_local), y0 .. Y3 the same on
    every rank, Y4_local (q/D, q, q, q); repeated-index slots 0 (the JAX
    function leaves them unspecified)."""
    ql = rowsQ.shape[0]
    return symdual_apply_rows(
        top, rowsQ, q, _offset(q, ql, group),
        a2a=lambda send, recv: all_to_all(send, recv, group),
        reduce=lambda t: all_reduce(t, group))


def adjoint_sharded(y0, y1, Y2, Y3, Y4, q: int, group=None):
    """Masked-broadcast adjoint of the sharded tuple: y0 .. Y3 whole, Y4
    (q/D, q, q, q) this rank's rows.  Returns (top (2 + q, n~), rowsQ
    (q/D q, n~)) with no communication."""
    return symdual_adjoint_rows((y0, y1, Y2, Y3, Y4), q,
                                _offset(q, Y4.shape[0], group))


class ShardedSymDualOp:
    """The SOS-dual tensor operator with its q^4 objects sharded by rows
    over the mesh axis ``axis`` (D ranks, D dividing q; one process per
    rank, SPMD).  ``rows`` is this rank's slice of the Q-grid rows (and of
    Y4's leading index); the arrays live on this rank's device.

    split_matrix / merge_matrix convert the dense single-card layout at
    the host boundary (for validation; a driver would keep the sharded
    form), so one numpy M goes to both packages."""

    def __init__(self, q: int, mesh, axis: str = "model"):
        ndev, me, group = mesh_axis(mesh, axis)
        if q % ndev:
            raise ValueError(f"q={q} not divisible by mesh axis "
                             f"'{axis}' size {ndev}")
        self.q, self.mesh, self.axis, self.group = q, mesh, axis, group
        self.n = 2 + q + q * q
        self.ql = q // ndev
        self.rows = slice(me * self.ql, (me + 1) * self.ql)
        self.device = _mesh_device(mesh)

    # -- host-boundary layout helpers ------------------------------------
    def split_matrix(self, M):
        """(n~, n~) dense (numpy or a tensor) -> (top (2 + q, n~), rowsQ
        (q/D, q, n~) this rank's rows) on this rank's device."""
        o = 2 + self.q
        M = M if isinstance(M, torch.Tensor) else torch.as_tensor(
            np.asarray(M))
        top = M[:o].to(self.device).contiguous()
        rowsQ = M[o:].reshape(self.q, self.q, self.n)[self.rows]
        return top, rowsQ.to(self.device).contiguous()

    def merge_matrix(self, top, rowsQ):
        """The dense (n~, n~) matrix (numpy, on every rank) from ``top`` and
        every rank's ``rowsQ`` (joined in rank order)."""
        rows = all_gather(rowsQ.reshape(1, -1), self.group)
        return np.concatenate([top.cpu().numpy(),
                               rows.reshape(-1, self.n).cpu().numpy()])

    def apply(self, top, rowsQ):
        return apply_sharded(top, rowsQ, self.q, self.group)

    def adjoint(self, y):
        return adjoint_sharded(*y, self.q, self.group)
