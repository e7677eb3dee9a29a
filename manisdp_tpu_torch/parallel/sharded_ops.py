"""The constraint operator sharded over ranks: the sparse AL hot path on
several cards (PyTorch port of ``ShardedConstraintOp`` in
manisdp_tpu/parallel/sharded_ops.py).

Layout, as in the JAX package: the union pattern P is cut into
contiguous slices of Lp = ceil(nnzP / world) pattern ids, one per rank of
the mesh axis, and each rank owns the A-entries that touch its slice
(cut from the a2p-sorted entries by ``searchsorted``).  The factor Y and
the m-space multipliers are replicated.  Each rank holds its slice as a
valid ``ConstraintOp`` of its own entries (a local pattern sorted by
(j, i), the k-sorted entries with krow_ptr over all m rows, the
a2p-sorted entries with pat_ptr over the local pattern), so kernels K3,
K4 and K1 run on it unchanged; ranks are ragged and nothing is padded.

  - local, no communication: the pair dots (K3), the adjoint on P and
    es / s values (K4 over the a2p order);
  - one all-reduce each, where a value is a sum over ranks: ``dot_pattern``
    (a scalar) and ``apply_from_e`` (K4 over the k order, (m,));
  - column blocks: a slice of P sorted by (j, i) holds the entries of a
    contiguous run of columns, c0 .. c1-1 (only its first and last column
    may be shared with the neighbouring ranks), so a rank's pattern carries
    that span and K1 / K3 run over those columns only.  ``matmat_pattern``
    (K1 ``plain``, (p, n)), ``matvec_pattern`` (K1 on the Vᵀ view,
    (n, k)), ``colsum_pattern`` (n,), ``quad_cols`` (K1 ``cost``, the
    stats' z = colsum(Y ∘ Y·mat(vals)), (n,)) and the AL Hessian's
    products (K1 ``al_hess`` without its epilogue) each give the rank's
    block of columns; one all-gather of the blocks (padded to the widest)
    and the blocks placed in rank order give the whole result, a column two
    ranks share summed in rank order, the same bits on every rank
    (``_join``).  ``al_hess`` then applies the unit-diagonal epilogue once
    (K2 ``proj`` with the eG term; applied per shard, its − U·eG term would
    count ``world`` times); ``matmat_shift`` (the certificate's
    V·(mat(vals) − diag(z))) is the joined ``matmat_pattern``, then the
    shift;
  - ``pattern_dense`` (the dense S): the slices' values summed into the
    whole pattern's (one (nnzP,) all-reduce), then placed on the device.

The residual-space protocol stays local on the replicated (m,) vectors.
Every rank computes the same replicated values from the same all-reduced
sums, so every host decision of a driver comes out alike on all ranks.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..kernels import oblique_cols
from ..ops.sparse import ConstraintOp, _MVecResiduals
from .distributed import all_gather, all_reduce


def partition(arrays: dict, world: int) -> list:
    """The JAX package's partition of a ConstraintOp's host arrays (as
    ``ConstraintOp.host_arrays(full=True)`` gives them) into ``world``
    slices, unpadded: for each rank a dict with the pattern slice
    (pat_i, pat_j, pat_v), its offset ``lo``, and its A-entries in a2p
    order (kp, vp, locp: local pattern ids) and stably k-sorted (ks, vs,
    locps)."""
    pat_i, pat_j = np.asarray(arrays["pat_i"]), np.asarray(arrays["pat_j"])
    pat_v = np.asarray(arrays["pat_v"])
    a2ps = np.asarray(arrays["a2p_sorted"])
    kp, vp = np.asarray(arrays["kp"]), np.asarray(arrays["vp"])
    nnzP = pat_i.shape[0]
    Lp = -(-nnzP // world)
    cuts = np.searchsorted(a2ps, np.arange(1, world) * Lp)
    starts = np.concatenate([[0], cuts]).astype(np.int64)
    ends = np.concatenate([cuts, [a2ps.shape[0]]]).astype(np.int64)
    out = []
    for d in range(world):
        lo, hi = d * Lp, min((d + 1) * Lp, nnzP)
        s, e = starts[d], ends[d]
        k_d = kp[s:e].astype(np.int32)
        loc = (a2ps[s:e] - lo).astype(np.int32)
        ordk = np.argsort(k_d, kind="stable")
        out.append(dict(
            lo=lo, pat_i=pat_i[lo:hi], pat_j=pat_j[lo:hi],
            pat_v=pat_v[lo:hi], kp=k_d, vp=vp[s:e], locp=loc,
            ks=k_d[ordk], vs=vp[s:e][ordk], locps=loc[ordk]))
    return out


def column_spans(pat_j: np.ndarray, world: int, n: int) -> tuple:
    """Each rank's columns (c0, c1) under ``partition``: the columns of its
    slice of the (j, i)-sorted pattern (the whole n at one rank)."""
    if world == 1:
        return ((0, n),)
    nnzP = pat_j.shape[0]
    Lp = -(-nnzP // world)
    return tuple((int(pat_j[d * Lp]), int(pat_j[min((d + 1) * Lp, nnzP) - 1])
                  + 1) if d * Lp < nnzP else (0, 0) for d in range(world))


@dataclasses.dataclass(frozen=True)
class ShardedConstraintOp(_MVecResiduals):
    """A ConstraintOp partitioned by pattern id over the ranks of
    ``group``: this rank's ``local`` shard, the replicated b, and the
    global pattern's host indices (for the dense S)."""
    local: ConstraintOp
    b: torch.Tensor          # (m,) replicated
    group: object            # the mesh axis's process group
    world: int
    rank: int                # this rank's index on the axis
    lo: int                  # offset of the local slice in P
    nnzP: int                # global pattern size
    pat_i_host: np.ndarray   # global pattern, host int32
    pat_j_host: np.ndarray
    m: int
    n: int
    spans: tuple             # each rank's columns (c0, c1), in rank order

    @staticmethod
    def build(arrays: dict, rank: int, world: int, device, group=None
              ) -> "ShardedConstraintOp":
        """This rank's shard from the full operator's host arrays (keys of
        ``ConstraintOp.host_arrays(full=True)``); uploads only the shard."""
        return ShardedConstraintOp.from_piece(
            partition(arrays, world)[rank], arrays, rank, world, device,
            group)

    @staticmethod
    def from_piece(piece: dict, arrays: dict, rank: int, world: int, device,
                   group=None) -> "ShardedConstraintOp":
        """The shard of one ``partition`` piece, a ConstraintOp of the
        piece's own entries; ``arrays`` supplies the global pattern
        (pat_i, pat_j), b, m and n."""
        pat_i, pat_j, loc = piece["pat_i"], piece["pat_j"], piece["locps"]
        if pat_i.shape[0] == 0:
            raise ValueError(
                "a rank's pattern slice is empty: the pattern has too few "
                "entries for this many ranks")
        n = int(arrays["n"])
        local = ConstraintOp.from_arrays(dict(
            k=piece["ks"], i=pat_i[loc], j=pat_j[loc], v=piece["vs"],
            a2p=loc, pat_i=pat_i, pat_j=pat_j, pat_v=piece["pat_v"],
            b=np.asarray(arrays["b"]), kp=piece["kp"], vp=piece["vp"],
            a2p_sorted=piece["locp"], m=int(arrays["m"]), n=n), device)
        if world > 1:
            # the slice's columns and the rows its entries read (at one
            # rank the whole n x n, as on one card)
            local = dataclasses.replace(local, pat=dataclasses.replace(
                local.pat, span=(int(pat_j[0]), int(pat_j[-1]) + 1,
                                 int(pat_i.min()), int(pat_i.max()) + 1)))
        glob_j = np.asarray(arrays["pat_j"])
        return ShardedConstraintOp(
            local=local, b=local.b, group=group, world=world, rank=rank,
            lo=int(piece["lo"]), nnzP=int(glob_j.size),
            pat_i_host=np.asarray(arrays["pat_i"]), pat_j_host=glob_j,
            m=int(arrays["m"]), n=n, spans=column_spans(glob_j, world, n))

    @property
    def device(self) -> torch.device:
        return self.local.device

    def astype(self, dtype) -> "ShardedConstraintOp":
        local = self.local.astype(dtype)
        return dataclasses.replace(self, local=local, b=local.b)

    def _sum(self, t):
        return all_reduce(t.contiguous(), self.group)

    # -- operator protocol -----------------------------------------------
    @property
    def c_pattern(self):
        return self.local.pat.v

    def pattern_pair_dots(self, Y, U=None):
        return self.local.pattern_pair_dots(Y, U)

    def dot_pattern(self, u, v):
        return self._sum(torch.dot(u, v).reshape(1))[0]

    def apply_from_e(self, e):
        return self._sum(self.local.apply_from_e(e))

    def apply_factored(self, Y, U=None):
        return self.apply_from_e(self.pattern_pair_dots(Y, U))

    def adjoint_on_pattern(self, w):
        return self.local.adjoint_on_pattern(w)

    def es_vals(self, w, sigma: float):
        return self.local.es_vals(w, sigma)

    def s_vals(self, y):
        return self.local.s_vals(y)

    def normal_factored(self, Y, U):
        return self.adjoint_on_pattern(self.apply_factored(Y, U))

    def _join(self, block):
        """The whole (..., n) result from every rank's (..., c1 − c0) block
        of its columns (``spans``): one all-gather of the blocks, padded to
        the widest, then each rank's block added into zeros in rank order,
        so a column two ranks share is their sum in rank order, the same
        bits on every rank.  At one rank the block is the whole result."""
        if self.world == 1:
            return block
        wide = max(c1 - c0 for c0, c1 in self.spans)
        pad = wide - block.shape[-1]
        if pad:
            block = torch.nn.functional.pad(block, (0, pad))
        got = all_gather(block, self.group)
        out = torch.zeros(block.shape[:-1] + (self.n,), dtype=block.dtype,
                          device=block.device)
        for r, (c0, c1) in enumerate(self.spans):
            out[..., c0:c1] += got[..., r * wide:r * wide + c1 - c0]
        return out

    def colsum_pattern(self, vals):
        c0, c1 = self.spans[self.rank]
        return self._join(self.local.colsum_pattern(vals)[c0:c1])

    def matmat_pattern(self, Y, vals):
        return self._join(self.local.matmat_pattern(Y, vals))

    def matvec_pattern(self, V, vals):
        return self._join(self.local.matvec_pattern(V, vals).T).T

    def al_hess(self, U, Y, es, ayu, coefs,
                eG: Optional[torch.Tensor] = None):
        """coefs[0]·U·mat(es) + coefs[1]·Y·mat(ayu), and with ``eG`` the
        unit-diagonal epilogue H − Y ∘ colsum(Y ∘ H) − U ∘ eG, applied once
        after the blocks are joined."""
        H = self._join(self.local.al_hess(U, Y, es, ayu, coefs))
        if eG is None:
            return H
        return oblique_cols(Y.contiguous(), H, "proj", v=U.contiguous(),
                            g=eG.contiguous())

    def matmat_shift(self, V, vals, z):
        """V·(mat(vals) − diag(z)): the all-reduced K1 ``plain``, then the
        shift once."""
        return self.matmat_pattern(V, vals) - z[None, :] * V

    def quad_cols(self, Y, vals):
        """colsum(Y ∘ Y·mat(vals)) -> (n,)."""
        return self._join(self.local.quad_cols(Y, vals))

    # -- the global pattern ------------------------------------------------
    def global_values(self, vals):
        """This rank's values on its slice -> the whole pattern's (nnzP,),
        the same on every rank (zero-padded slices summed: exact)."""
        out = torch.zeros((self.nnzP,), dtype=vals.dtype, device=vals.device)
        out[self.lo:self.lo + vals.shape[0]] = vals
        return self._sum(out)

    def pattern_dense(self, vals):
        """mat(vals) of the whole pattern as a dense (n, n) array on this
        rank's device, the same on every rank (the global pattern's
        positions are distinct, so a plain assignment)."""
        dev = vals.device
        out = torch.zeros((self.n, self.n), dtype=vals.dtype, device=dev)
        idx = (torch.as_tensor(self.pat_i_host, device=dev).long(),
               torch.as_tensor(self.pat_j_host, device=dev).long())
        return out.index_put_(idx, self.global_values(vals))


def model_axis(mesh) -> str:
    """The axis the operator shards over: the one named ``model``, else
    the last; every other axis replicates (so a (dcn, model) host mesh
    composes)."""
    names = tuple(mesh.mesh_dim_names or ())
    if not names:
        raise ValueError("the mesh needs named axes (mesh_dim_names)")
    return "model" if "model" in names else names[-1]


def build_on_mesh(arrays: dict, mesh, device) -> ShardedConstraintOp:
    """This rank's shard of the operator whose host arrays are ``arrays``,
    over ``mesh``'s model axis."""
    from .mesh import mesh_axis
    world, rank, group = mesh_axis(mesh, model_axis(mesh))
    return ShardedConstraintOp.build(arrays, rank, world, device, group)
