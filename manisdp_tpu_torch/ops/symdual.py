"""Gather-free SOS-dual operator on the expanded pair basis (PyTorch port of
manisdp_tpu/ops/symdual.py).

The BQP SOS constraint matrix is a partition: each matrix entry (u, v)
belongs to exactly one constraint row, the squarefree monomial class
mask(u) XOR mask(v), with unit weights, so AA' is diagonal.  On the
expanded basis

    [ 1, 1',  x_a (a < q),  q x q grid: slot(i, j) = x_i x_j (i != j),
      slot(a, a) = x_a'  (second copies) ]

(n~ = 2 + q + q^2 columns, every original basis column exactly twice, so
every class has exactly 4x the original's entries) the class of every
entry is an index-coincidence pattern: ``apply`` is the per-degree class
sums of the (q, q, q, q) Q-block tensor and the small blocks (kernel K7,
``kernels.symdual_apply``), ``adjoint`` a masked broadcast of per-degree
tensors back into (n~, n~) (kernel K8, ``kernels.symdual_adjoint``).
The duplicate-copy projections of a factor and of a matrix are K8's
``sym_factor`` and ``sym_mat`` modes.  The expanded ADMM tracks the
original-basis trajectory under a (sigma/4, 2*sqrt(2)*tau,
tolgradnorm/sqrt(2)) parameter mapping (solvers/dual_unitdiag.py).

m-space layout ("flat"): the per-class multiplier is the concatenation of
dense per-degree tensors [y0 (1,), y1 (q,), Y2 (q,q), Y3 (q,q,q),
Y4 (q,q,q,q)] holding the class value at every permutation of distinct
indices.  Repeated-index slots are don't-care: never read by ``adjoint``
and zero in ``b``; the port writes them as 0 (the JAX package leaves
them unspecified).  Between operators m-space values travel as the
per-degree tuple.

The torch formulas below (``_apply_tensor``, ``_adjoint_tensor``,
``_symmetrize``) are the JAX package's, and serve as the kernels' plain
twins on CPU tensors.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..kernels import (symdual_adjoint, symdual_apply, symdual_sym_factor,
                       symdual_sym_mat)
from ..solvers.common import resolve_device


def _blocks(M, q):
    """Split an (n~, n~) matrix into the basis blocks (cols 0, 1 = the two
    copies of the constant; 2 .. 2+q = x_a; then the q x q grid)."""
    o = 2 + q
    s = M[:2, :2]
    u = M[:2, 2:o]                          # (2, q)
    uT = M[2:o, :2]                         # (q, 2)
    E = M[:2, o:].reshape(2, q, q)          # E[s, i, j]
    F = M[o:, :2].reshape(q, q, 2)          # F[i, j, s]
    G = M[2:o, 2:o]
    H = M[2:o, o:].reshape(q, q, q)         # H[b, i, j]
    K = M[o:, 2:o].reshape(q, q, q)         # K[i, j, b]
    T = M[o:, o:].reshape(q, q, q, q)       # T[i, j, k, l]
    return s, u, uT, E, F, G, H, K, T


def _apply_tensor(M, q):
    """Per-degree class sums (y0, y1, Y2, Y3, Y4) of an (n~, n~) matrix;
    repeated-index entries of Y2..Y4 unspecified (JAX formulas)."""
    s, u, uT, E, F, G, H, K, T = _blocks(M, q)
    dt, dev = M.dtype, M.device
    moff = 1.0 - torch.eye(q, dtype=dt, device=dev)
    Tn = T * moff[:, :, None, None] * moff[None, None, :, :]
    Hn = H * moff[None, :, :]
    Kn = K * moff[:, :, None]
    es = torch.einsum

    y0 = (torch.sum(s) + torch.trace(G)
          + es('aaa->', H) + es('aaa->', K)
          + es('iiii->', T)
          + es('ijij->', Tn) + es('ijji->', Tn))

    y1 = (torch.sum(u, dim=0) + torch.sum(uT, dim=1)
          + es('sii->i', E) + es('iis->i', F)
          + es('iia->a', Hn) + es('jaj->a', Hn)
          + es('iai->a', Kn) + es('ajj->a', Kn)
          + es('ccca->a', T) + es('ccac->a', T)
          + es('cacc->a', T) + es('accc->a', T)
          - 4.0 * es('aaaa->a', T))

    A4 = (es('acbc->ab', Tn) + es('accb->ab', Tn)
          + es('cabc->ab', Tn) + es('cacb->ab', Tn))
    Es = torch.sum(E, dim=0)
    Fs = torch.sum(F, dim=2)
    HD = es('abb->ab', H)
    KD = es('ccb->bc', K)
    DD = es('iikk->ik', T)
    Y2 = (G + G.T + Es + Es.T + Fs + Fs.T + A4 + A4.T
          + HD + HD.T + KD + KD.T + DD + DD.T)

    D1n = es('eefg->efg', T) * moff[None, :, :]
    D2n = es('fgee->fge', T) * moff[:, :, None]
    Hp = Hn + D1n
    Kp = Kn + D2n
    HH = Hp + torch.swapaxes(Hp, 1, 2)
    Ka = torch.permute(Kp, (2, 0, 1))
    KK = Ka + torch.swapaxes(Ka, 1, 2)
    S3 = HH + KK
    Y3 = S3 + torch.permute(S3, (1, 0, 2)) + torch.permute(S3, (2, 1, 0))

    P1 = Tn + torch.permute(Tn, (1, 0, 2, 3))
    P2 = P1 + torch.permute(P1, (0, 1, 3, 2))
    P3 = P2 + torch.permute(P2, (2, 3, 0, 1))
    Y4 = P3 + torch.permute(P3, (0, 2, 1, 3)) + torch.permute(P3, (0, 3, 2, 1))
    return y0, y1, Y2, Y3, Y4


def _repeat_masks(q, device):
    """Boolean repeated-index masks of Y2, Y3 and Y4."""
    a = torch.arange(q, device=device)
    i2, j2 = a[:, None], a[None, :]
    m2 = i2 == j2
    i3, j3, k3 = a[:, None, None], a[None, :, None], a[None, None, :]
    m3 = (i3 == j3) | (i3 == k3) | (j3 == k3)
    i4, j4 = a[:, None, None, None], a[None, :, None, None]
    k4, l4 = a[None, None, :, None], a[None, None, None, :]
    m4 = ((i4 == j4) | (i4 == k4) | (i4 == l4) | (j4 == k4) | (j4 == l4)
          | (k4 == l4))
    return m2, m3, m4


def zero_dontcare(y, q):
    """The tuple ``y`` with its repeated-index slots set to 0."""
    m2, m3, m4 = _repeat_masks(q, y[4].device)
    zero = torch.zeros((), dtype=y[4].dtype, device=y[4].device)
    return (y[0], y[1], torch.where(m2, zero, y[2]),
            torch.where(m3, zero, y[3]), torch.where(m4, zero, y[4]))


def _adjoint_tensor(y0, y1, Y2, Y3, Y4, q):
    """(n~, n~) matrix W with W[u, v] = class value of (u, v), by
    index-coincidence selection (JAX formulas)."""
    dev = Y4.device
    y0 = y0.reshape(())
    eye = torch.eye(q, dtype=torch.bool, device=dev)

    E_w = torch.where(eye, y1[:, None], Y2)
    G_w = torch.where(eye, y0, Y2)

    a = torch.arange(q, device=dev)
    b3, i3, j3 = a[:, None, None], a[None, :, None], a[None, None, :]
    H_w = torch.where(i3 == j3,
                      torch.where(b3 == i3, y0, Y2[:, :, None]),
                      torch.where(b3 == i3, y1[None, None, :],
                                  torch.where(b3 == j3, y1[None, :, None],
                                              Y3)))

    i4, j4 = a[:, None, None, None], a[None, :, None, None]
    k4, l4 = a[None, None, :, None], a[None, None, None, :]
    Y2_ik = Y2[:, None, :, None]
    Y2_il = Y2[:, None, None, :]
    Y2_jk = Y2[None, :, :, None]
    Y2_jl = Y2[None, :, None, :]
    fd = i4 == j4
    sd = k4 == l4
    same = ((i4 == k4) & (j4 == l4)) | ((i4 == l4) & (j4 == k4))
    w = torch.where
    T_w = w(fd & sd,
            w(i4 == k4, y0, Y2_ik),
            w(fd,
              w(i4 == k4, y1[None, None, None, :],
                w(i4 == l4, y1[None, None, :, None], Y3[:, None, :, :])),
              w(sd,
                w(k4 == i4, y1[None, :, None, None],
                  w(k4 == j4, y1[:, None, None, None], Y3[:, :, :, None])),
                w(same, y0,
                  w(i4 == k4, Y2_jl,
                    w(i4 == l4, Y2_jk,
                      w(j4 == k4, Y2_il,
                        w(j4 == l4, Y2_ik, Y4))))))))

    two = torch.ones((2,), dtype=Y4.dtype, device=dev)
    rowsC = torch.cat([y0 * torch.ones((2, 2), dtype=Y4.dtype, device=dev),
                       two[:, None] * y1[None, :],
                       two[:, None] * E_w.reshape(1, -1)], dim=1)
    rowsL = torch.cat([y1[:, None] * two[None, :], G_w,
                       H_w.reshape(q, q * q)], dim=1)
    rowsQ = torch.cat([E_w.reshape(-1, 1) * two[None, :],
                       torch.permute(H_w, (1, 2, 0)).reshape(q * q, q),
                       T_w.reshape(q * q, q * q)], dim=1)
    return torch.cat([rowsC, rowsL, rowsQ], dim=0)


def _pad_rows(block, q, off):
    """A (ql, ...) row block at row offset ``off`` of a zeros (q, ...)
    tensor (with the all-reduce this assembles the whole)."""
    out = block.new_zeros((q,) + tuple(block.shape[1:]))
    out[off:off + block.shape[0]] = block
    return out


def _pad_cols(block, q, off):
    out = block.new_zeros(block.shape[:1] + (q,) + tuple(block.shape[2:]))
    out[:, off:off + block.shape[1]] = block
    return out


def _zero_dontcare_rows(y, q, off):
    """(y0, y1, Y2, Y3, Y4_local) with the repeated-index slots 0 (Y4's
    masks at its rows)."""
    ql = y[4].shape[0]
    m2, m3, m4 = _repeat_masks(q, y[4].device)
    zero = torch.zeros((), dtype=y[4].dtype, device=y[4].device)
    return (y[0], y[1], torch.where(m2, zero, y[2]),
            torch.where(m3, zero, y[3]),
            torch.where(m4[off:off + ql], zero, y[4]))


def _apply_sharded_tensor(top, rowsQ, q, off, a2a, reduce):
    """The JAX apply_sharded in torch on this rank's rows: ``top`` (2 + q,
    n~), ``rowsQ`` (ql, q, n~) at row offset ``off``; ``a2a(send, recv)``
    the equal-split all-to-all, ``reduce(t)`` the in-place sum over the
    ranks.  The JAX function's six psums are one all-reduce of their
    concatenation.  Returns (y0, y1, Y2, Y3, Y4_local), repeated-index
    slots 0."""
    o = 2 + q
    ql = rowsQ.shape[0]
    D = q // ql
    dt, dev = rowsQ.dtype, rowsQ.device
    es = torch.einsum

    def sl(x, axis):
        return x.narrow(axis, off, ql)

    s = top[:2, :2]
    u = top[:2, 2:o]
    E = top[:2, o:].reshape(2, q, q)
    uT = top[2:o, :2]
    G = top[2:o, 2:o]
    H = top[2:o, o:].reshape(q, q, q)
    F = rowsQ[:, :, :2]                       # (ql, q, 2)
    K = rowsQ[:, :, 2:o]                      # (ql, q, q)   [i, j, b]
    T = rowsQ[:, :, o:].reshape(ql, q, q, q)  # (ql, q, q, q)

    moff = 1.0 - torch.eye(q, dtype=dt, device=dev)
    moff_l = sl(moff, 0)                      # (ql, q)
    Tn = T * moff_l[:, :, None, None] * moff[None, None, :, :]
    Hn = H * moff[None, :, :]
    Kn = K * moff_l[:, :, None]

    # -- degree 0 --
    y0_rep = torch.sum(s) + torch.trace(G) + es('aaa->', H)
    K_dd = sl(sl(K, 1), 2)
    T_dd = sl(sl(sl(T, 1), 2), 3)
    y0_loc = (es('aaa->', K_dd) + es('aaaa->', T_dd)
              + es('ajaj->', sl(Tn, 2)) + es('ajja->', sl(Tn, 3)))

    # -- degree 1 --
    y1_rep = (torch.sum(u, dim=0) + torch.sum(uT, dim=1)
              + es('sii->i', E) + es('iia->a', Hn) + es('jaj->a', Hn))
    y1_loc = (es('bab->a', sl(Kn, 2))
              + es('ccca->a', sl(sl(T, 1), 2))
              + es('ccac->a', sl(sl(T, 1), 3))
              + es('cacc->a', sl(sl(T, 2), 3)))
    y1_blk = (es('aas->a', sl(F, 1)) + es('ajj->a', Kn)
              + es('accc->a', T) - 4.0 * es('aaaa->a', T_dd))
    y1_part = y1_loc + _pad_rows(y1_blk, q, off)

    # -- degree 2 --
    Es = torch.sum(E, dim=0)
    HD = es('abb->ab', H)
    A4_blk = es('acbc->ab', Tn) + es('accb->ab', Tn)
    A4_part = (es('cabc->ab', sl(Tn, 3)) + es('cacb->ab', sl(Tn, 2))
               + _pad_rows(A4_blk, q, off))
    Fs_blk = torch.sum(F, dim=2)                       # (ql, q)
    KD_blk = es('ccb->bc', sl(K, 1))                   # (q, ql)
    DD_blk = es('aakk->ak', sl(T, 1))                  # (ql, q)
    FKD_part = _pad_rows(Fs_blk + DD_blk, q, off) + _pad_cols(KD_blk, q, off)

    # -- degree 3 --
    D1n_part = _pad_rows(es('eefg->efg', sl(T, 1)), q, off)
    Kp_part = _pad_rows(Kn + es('agee->age', T) * moff_l[:, :, None], q, off)

    sizes = [1, q, q * q, q * q, q ** 3, q ** 3]
    flat = torch.cat([y0_loc.reshape(1), y1_part, A4_part.reshape(-1),
                      FKD_part.reshape(-1), D1n_part.reshape(-1),
                      Kp_part.reshape(-1)])
    reduce(flat)
    y0_s, y1_s, A4, FKD, D1n, Kp = torch.split(flat, sizes)
    y0 = y0_rep + y0_s.reshape(())
    y1 = y1_rep + y1_s
    half2 = G + Es + HD + A4.view(q, q) + FKD.view(q, q)
    Y2 = half2 + half2.T
    Hp = Hn + D1n.view(q, q, q) * moff[None, :, :]
    HH = Hp + torch.swapaxes(Hp, 1, 2)
    Ka = torch.permute(Kp.view(q, q, q), (2, 0, 1))
    KK = Ka + torch.swapaxes(Ka, 1, 2)
    S3 = HH + KK
    Y3 = S3 + torch.permute(S3, (1, 0, 2)) + torch.permute(S3, (2, 1, 0))

    # -- degree 4: the two cross-shard transposes --
    # all_to_all #1 (split axis 1, concat axis 0): x1[i, b] = Tn[i, off + b]
    send = Tn.reshape(ql, D, ql, q, q).transpose(0, 1).contiguous()
    recv = torch.empty_like(send)
    a2a(send.view(D, -1), recv.view(D, -1))
    x1 = recv.reshape(q, ql, q, q)
    P1 = Tn + torch.permute(x1, (1, 0, 2, 3))
    P2 = P1 + torch.permute(P1, (0, 1, 3, 2))
    # all_to_all #2 (split axis 2, concat axis 0): x2[i, j, c] = P2[i, j,
    # off + c]
    send = P2.reshape(ql, q, D, ql, q).permute(2, 0, 1, 3, 4).contiguous()
    recv = torch.empty_like(send)
    a2a(send.view(D, -1), recv.view(D, -1))
    x2 = recv.reshape(q, q, ql, q)
    P3 = P2 + torch.permute(x2, (2, 3, 0, 1))
    Y4 = P3 + torch.permute(P3, (0, 2, 1, 3)) + torch.permute(P3, (0, 3, 2, 1))
    return _zero_dontcare_rows((y0, y1, Y2, Y3, Y4), q, off)


def _adjoint_sharded_tensor(y0, y1, Y2, Y3, Y4, q, off):
    """The JAX adjoint_sharded in torch: y0 .. Y3 whole, Y4 (ql, q, q, q)
    the rows at ``off``.  Returns (top (2 + q, n~), rowsQ (ql q, n~))."""
    ql = Y4.shape[0]
    dt, dev = Y4.dtype, Y4.device
    y0 = y0.reshape(())
    eye = torch.eye(q, dtype=torch.bool, device=dev)
    w = torch.where

    E_w = w(eye, y1[:, None], Y2)
    G_w = w(eye, y0, Y2)

    a = torch.arange(q, device=dev)
    b3, i3, j3 = a[:, None, None], a[None, :, None], a[None, None, :]
    H_w = w(i3 == j3,
            w(b3 == i3, y0, Y2[:, :, None]),
            w(b3 == i3, y1[None, None, :],
              w(b3 == j3, y1[None, :, None], Y3)))

    # the local rows' leading index: off + a local iota
    i4 = off + torch.arange(ql, device=dev)[:, None, None, None]
    j4, k4, l4 = a[None, :, None, None], a[None, None, :, None], \
        a[None, None, None, :]
    Y2_l, Y3_l, y1_l = Y2[off:off + ql], Y3[off:off + ql], y1[off:off + ql]
    Y2_ik = Y2_l[:, None, :, None]
    Y2_il = Y2_l[:, None, None, :]
    Y2_jk = Y2[None, :, :, None]
    Y2_jl = Y2[None, :, None, :]
    fd = i4 == j4
    sd = k4 == l4
    same = ((i4 == k4) & (j4 == l4)) | ((i4 == l4) & (j4 == k4))
    T_w = w(fd & sd,
            w(i4 == k4, y0, Y2_ik),
            w(fd,
              w(i4 == k4, y1[None, None, None, :],
                w(i4 == l4, y1[None, None, :, None], Y3_l[:, None, :, :])),
              w(sd,
                w(k4 == i4, y1[None, :, None, None],
                  w(k4 == j4, y1_l[:, None, None, None],
                    Y3_l[:, :, :, None])),
                w(same, y0,
                  w(i4 == k4, Y2_jl,
                    w(i4 == l4, Y2_jk,
                      w(j4 == k4, Y2_il,
                        w(j4 == l4, Y2_ik, Y4))))))))

    two = torch.ones((2,), dtype=dt, device=dev)
    rowsC = torch.cat([y0 * torch.ones((2, 2), dtype=dt, device=dev),
                       two[:, None] * y1[None, :],
                       two[:, None] * E_w.reshape(1, -1)], dim=1)
    rowsL = torch.cat([y1[:, None] * two[None, :], G_w,
                       H_w.reshape(q, q * q)], dim=1)
    top = torch.cat([rowsC, rowsL], dim=0)
    E_w_l = E_w[off:off + ql].reshape(ql * q, 1)
    H_wT_l = torch.permute(H_w, (1, 2, 0))[off:off + ql].reshape(ql * q, q)
    rowsQ = torch.cat([E_w_l * two[None, :], H_wT_l,
                       T_w.reshape(ql * q, q * q)], dim=1)
    return top, rowsQ


def _flatten(y0, y1, Y2, Y3, Y4):
    return torch.cat([y0.reshape(1), y1, Y2.reshape(-1), Y3.reshape(-1),
                      Y4.reshape(-1)])


def _split(y, q):
    o1 = 1 + q
    o2 = o1 + q * q
    o3 = o2 + q ** 3
    return (y[0], y[1:o1], y[o1:o2].reshape(q, q),
            y[o2:o3].reshape(q, q, q), y[o3:].reshape(q, q, q, q))


def _symmetrize(Y, q: int, renorm: bool):
    """Duplicate-copy average of a (p, n~) factor's columns, optionally
    renormalized (the JAX package's _symmetrize_jit)."""
    o = 2 + q
    c = 0.5 * (Y[:, 0] + Y[:, 1])
    L = Y[:, 2:o]
    Qb = Y[:, o:].reshape(-1, q, q)
    d = torch.diagonal(Qb, dim1=1, dim2=2)
    La = 0.5 * (L + d)
    Qs = 0.5 * (Qb + torch.swapaxes(Qb, 1, 2))
    eye = torch.eye(q, dtype=Y.dtype, device=Y.device)
    Qs = Qs * (1.0 - eye)[None] + La[:, :, None] * eye[None]
    out = torch.cat([c[:, None], c[:, None], La,
                     Qs.reshape(Y.shape[0], q * q)], dim=1)
    if renorm:
        nrm = torch.linalg.norm(out, dim=0, keepdim=True)
        out = out / torch.clamp(nrm, min=1e-30)
    return out


@dataclasses.dataclass(frozen=True)
class SymDualOp:
    """Gather-free drop-in for DualOp on BQP-SOS expanded data.

    ``n`` is the expanded basis size n~ = 2 + q + q^2; ``m`` the flat
    per-degree multiplier length 1 + q + q^2 + q^3 + q^4 (``m_true`` the
    number of distinct monomial classes).  There is no free block
    (``f`` = 0, ``B`` None).
    """
    b: torch.Tensor            # (1+q+q^2,) dual-weighted deg<=2 prefix
    cf: torch.Tensor           # (0,)
    C: torch.Tensor            # 0-d zero (the PSD-part cost is zero)
    idAAt: torch.Tensor        # (5,) per-degree 1/class-size scalars
    bA: torch.Tensor           # (n, n) dense mat(A' D^{-1} b)
    Ac: torch.Tensor           # 0-d zero (A @ vec(C))
    dup0: torch.Tensor         # (n_orig,) int32 first copy of each column
    dup1: torch.Tensor         # (n_orig,) int32 second copy
    q: int
    m: int
    n: int
    f: int
    m_true: int
    n_orig: int
    B: Optional[object] = None

    @property
    def device(self) -> torch.device:
        return self.bA.device

    def astype(self, dtype) -> "SymDualOp":
        """Float arrays cast to ``dtype``; index arrays shared."""
        return dataclasses.replace(
            self, **{k: getattr(self, k).to(dtype)
                     for k in ("b", "cf", "C", "idAAt", "bA", "Ac")})

    # ---- DualOp-compatible surface (m-space values as per-degree tuples)
    def apply(self, M):
        return symdual_apply(M, self.q)

    def apply_flat(self, M):
        """Flat (m,) layout of apply() (host / test convenience)."""
        return _flatten(*self.apply(M))

    def _tup(self, y):
        return y if isinstance(y, tuple) else _split(y, self.q)

    def flatten_y(self, y):
        return _flatten(*self._tup(y))

    def adjoint(self, y):
        return symdual_adjoint(self._tup(y), self.q)

    def adjoint_scaled(self, v):
        """adjoint(scale_idAAt(v)) in one K8 pass."""
        return symdual_adjoint(self._tup(v), self.q, scale=self.idAAt)

    def residual(self, y, S, Xm=None, sigma=None):
        """adjoint(y) - (S - C) [- Xm / sigma] in one K8 pass (C = 0)."""
        if Xm is None:
            return symdual_adjoint(self._tup(y), self.q, B1=S, c1=-1.0)
        return symdual_adjoint(self._tup(y), self.q, B1=S, c1=-1.0, B2=Xm,
                               c2=-1.0 / float(sigma))

    def y_step(self, S):
        """scale_idAAt(apply(S) - Ac): K7 with its epilogue."""
        return symdual_apply(S, self.q, scale=self.idAAt, shift=self.Ac)

    def dot_b(self, y):
        """<b, y>: b is supported on the degree <= 2 prefix only."""
        y0, y1, Y2, _, _ = self._tup(y)
        nb = self.b.shape[0]
        return (self.b[0] * y0 + torch.dot(self.b[1:1 + self.q], y1)
                + torch.dot(self.b[1 + self.q:nb], Y2.reshape(-1)))

    def scale_idAAt(self, v):
        """(AA')^{-1} v with the constant per-degree class sizes."""
        s = self.idAAt
        return tuple(t * s[d] for d, t in enumerate(self._tup(v)))

    def symmetrize(self, Y, renorm: bool = True):
        """Project a (p, n~) factor onto the duplicate-symmetric subspace
        (copies averaged), optionally renormalizing columns (K8)."""
        return symdual_sym_factor(Y.contiguous(), self.q, renorm)

    def compress(self, M_dev):
        """Original-basis (n_orig, n_orig) matrix from an expanded one:
        the representative slots, times 4 (two index_selects, once per
        outer iteration)."""
        d0 = self.dup0
        return 4.0 * M_dev.index_select(0, d0).index_select(1, d0)

    def lift_vecs(self, V: np.ndarray) -> np.ndarray:
        """Host lift of original-basis (n_orig, k) eigenvectors into unit
        expanded vectors (each copy slot gets v/sqrt(2))."""
        out = np.zeros((self.n, V.shape[1]), dtype=V.dtype)
        s = np.asarray(V) / np.sqrt(2.0)
        out[self.dup0.cpu().numpy()] = s
        out[self.dup1.cpu().numpy()] = s
        return out

    def symmetrize_mat(self, M):
        """Average every entry of an (n~, n~) matrix over its 4-element
        copy orbit (K8)."""
        return symdual_sym_mat(M.contiguous(), self.q)

    # ---- construction ---------------------------------------------------
    @staticmethod
    def build_bqpsos(Q: np.ndarray, e: np.ndarray, q: int,
                     device="cuda") -> "SymDualOp":
        """Expanded-basis operator for min x'Qx + e'x, x in {-1,1}^q, on
        ``device`` (host numpy assembly as in the JAX package).  b is NOT
        normalized: callers divide by max|b| as the reference examples
        do."""
        device = resolve_device(device)
        Q = np.asarray(Q, dtype=np.float64)
        e = np.asarray(e, dtype=np.float64).ravel()
        nn = 2 + q + q * q
        flat_m = 1 + q + q ** 2 + q ** 3 + q ** 4
        if flat_m >= 2 ** 31:
            raise ValueError(f"q = {q}: the flat multiplier length {flat_m} "
                             "exceeds int32")
        m_true = _num_classes(q)

        b1 = e
        B2 = np.asarray(Q, dtype=np.float64).copy()
        np.fill_diagonal(B2, 0.0)
        b_flat = np.concatenate([[np.trace(Q)], b1, B2.reshape(-1)])

        # every class size is exactly 4x the original basis's: mb (deg 0),
        # 2q (deg 1 and 2) and 6 (deg 3 and 4), bqpsos.m:17-31
        d0 = 4.0 * (1 + q + q * (q - 1) // 2)
        d1 = 8.0 * q
        d2 = 8.0 * q
        idAAt = 1.0 / np.array([d0, d1, d2, 24.0, 24.0])
        bA = _adjoint_np_deg2(np.trace(Q) / d0, e / d1, 2.0 * B2 / d2, q)

        # original <-> expanded column maps: original basis order
        # [1, x_a, x_{ab} (a<b, column-major)] as frontends/sos.bqpsos
        o = 2 + q
        iu, ju = np.triu_indices(q, k=1)
        order = np.lexsort((iu, ju))
        pa, pb = iu[order], ju[order]
        rep = np.concatenate([[0], 2 + np.arange(q), o + pa * q + pb])
        dup = np.concatenate([[1], o + np.arange(q) * (q + 1),
                              o + pb * q + pa])
        f64 = dict(dtype=torch.float64, device=device)
        i32 = dict(dtype=torch.int32, device=device)
        return SymDualOp(
            b=torch.as_tensor(b_flat, **f64),
            cf=torch.zeros(0, **f64), C=torch.zeros((), **f64),
            idAAt=torch.as_tensor(idAAt, **f64),
            bA=torch.as_tensor(bA, **f64), Ac=torch.zeros((), **f64),
            dup0=torch.as_tensor(rep, **i32),
            dup1=torch.as_tensor(dup, **i32),
            q=q, m=flat_m, n=nn, f=0, m_true=m_true, n_orig=rep.shape[0])

    def scaled(self, maxb: float) -> "SymDualOp":
        """b and bA divided by ``maxb`` (the reference's normalization)."""
        return dataclasses.replace(self, b=self.b / maxb, bA=self.bA / maxb)


def _num_classes(q: int) -> int:
    from math import comb
    return 1 + q + comb(q, 2) + comb(q, 3) + comb(q, 4)


def _adjoint_np_deg2(y0: float, y1: np.ndarray, Y2: np.ndarray,
                     q: int) -> np.ndarray:
    """Host-numpy adjoint for multipliers supported on degree <= 2
    (Y3 = Y4 = 0), the bA precompute.  Same class map as _adjoint_tensor;
    patterns are written lowest-priority first so later writes win."""
    Y2 = np.asarray(Y2, dtype=np.float64)
    y1 = np.asarray(y1, dtype=np.float64)
    eye = np.eye(q, dtype=bool)
    E_w = np.where(eye, y1[:, None], Y2)
    G_w = np.where(eye, y0, Y2)

    H_w = np.zeros((q, q, q))
    for c in range(q):
        H_w[c, :, c] = y1              # b == j  -> y1[i]
    for c in range(q):
        H_w[c, c, :] = y1              # b == i  -> y1[j]
    for c in range(q):
        H_w[:, c, c] = Y2[:, c]        # i == j  -> (x_b, x_i copy)
    ii = np.arange(q)
    H_w[ii, ii, ii] = y0

    T_w = np.zeros((q, q, q, q))
    for c in range(q):
        T_w[:, c, :, c] = Y2           # j == l -> Y2[i, k]
    for c in range(q):
        T_w[:, c, c, :] = Y2           # j == k -> Y2[i, l]
    for c in range(q):
        T_w[c, :, :, c] = Y2           # i == l -> Y2[j, k]
    for c in range(q):
        T_w[c, :, c, :] = Y2           # i == k -> Y2[j, l]
    i2, j2 = np.meshgrid(ii, ii, indexing="ij")
    T_w[i2, j2, i2, j2] = y0           # same pair
    T_w[i2, j2, j2, i2] = y0
    for c in range(q):
        T_w[:, :, c, c] = 0.0          # (x_i x_j, x_k copy): Y3 = 0
        T_w[c, c, :, :] = 0.0          # (x_i copy, x_k x_l): Y3 = 0
    for c in range(q):
        T_w[:, c, c, c] = y1           # sd, k == j -> y1[i]
        T_w[c, :, c, c] = y1           # sd, k == i -> y1[j]
        T_w[c, c, :, c] = y1           # fd, i == l -> y1[k]
        T_w[c, c, c, :] = y1           # fd, i == k -> y1[l]
    T_w[i2, i2, j2, j2] = Y2           # (x_i copy, x_k copy)
    T_w[ii, ii, ii, ii] = y0

    rowsC = np.concatenate([np.full((2, 2), y0),
                            np.broadcast_to(y1, (2, q)),
                            np.broadcast_to(E_w.reshape(-1), (2, q * q))],
                           axis=1)
    rowsL = np.concatenate([np.broadcast_to(y1[:, None], (q, 2)), G_w,
                            H_w.reshape(q, q * q)], axis=1)
    rowsQ = np.concatenate([np.broadcast_to(E_w.reshape(-1, 1),
                                            (q * q, 2)),
                            np.transpose(H_w, (1, 2, 0)).reshape(q * q, q),
                            T_w.reshape(q * q, q * q)], axis=1)
    return np.concatenate([rowsC, rowsL, rowsQ], axis=0)


def _dontcare_mask(q: int) -> np.ndarray:
    """Boolean mask over the flat layout marking repeated-index slots."""
    m2 = np.eye(q, dtype=bool).reshape(-1)
    i3, j3, k3 = np.meshgrid(*([np.arange(q)] * 3), indexing="ij")
    m3 = ((i3 == j3) | (i3 == k3) | (j3 == k3)).reshape(-1)
    i4, j4, k4, l4 = np.meshgrid(*([np.arange(q)] * 4), indexing="ij")
    m4 = ((i4 == j4) | (i4 == k4) | (i4 == l4) |
          (j4 == k4) | (j4 == l4) | (k4 == l4)).reshape(-1)
    return np.concatenate([np.zeros(1 + q, dtype=bool), m2, m3, m4])


def expanded_masks(q: int) -> np.ndarray:
    """Monomial bitmask of every expanded basis column."""
    assert q <= 62
    masks = np.zeros(2 + q + q * q, dtype=np.uint64)
    masks[2:2 + q] = 1 << np.arange(q, dtype=np.uint64)
    ii, jj = np.meshgrid(np.arange(q), np.arange(q), indexing="ij")
    qm = (1 << ii.astype(np.uint64)) ^ (1 << jj.astype(np.uint64))
    qm[np.arange(q), np.arange(q)] = 1 << np.arange(q, dtype=np.uint64)
    masks[2 + q:] = qm.reshape(-1)
    return masks


def bqpsos_expanded_sparse(Q: np.ndarray, e: np.ndarray, q: int):
    """Expanded-basis BQP-SOS data as sparse SeDuMi-style arrays, for
    small-q validation of SymDualOp through the generic DualOp.  Returns
    (A_full, b, c, nn, f=1, dAAt) as frontends.sos.assemble_bqpsos does
    for the original basis."""
    import scipy.sparse as sp
    from ..frontends.monomials import monomial_basis

    Q = np.asarray(Q, dtype=np.float64)
    e = np.asarray(e, dtype=np.float64).ravel()
    nn = 2 + q + q * q
    sp4 = monomial_basis(q, 4, max_power=1)
    lsp = sp4.shape[1]
    pow2 = (1 << np.arange(q, dtype=np.uint64))
    masks4 = (sp4.astype(np.uint64).T * pow2).sum(axis=1)
    order4 = np.argsort(masks4, kind="stable")
    sorted4 = masks4[order4]

    em = expanded_masks(q)
    iu, ju = np.meshgrid(np.arange(nn), np.arange(nn), indexing="ij")
    xm = np.bitwise_xor(em[iu.reshape(-1)], em[ju.reshape(-1)])
    rows = order4[np.searchsorted(sorted4, xm)]
    cols = ju.reshape(-1) * nn + iu.reshape(-1)   # column-major like _ent
    vals = np.ones(rows.shape[0])
    dAAt = np.bincount(rows, minlength=lsp).astype(np.float64)
    A = sp.coo_matrix((vals, (rows, cols)), shape=(lsp, nn * nn)).tocsr()

    b = np.zeros(lsp)
    b[0] = np.trace(Q)
    mask1 = 1 << np.arange(q, dtype=np.uint64)
    b[order4[np.searchsorted(sorted4, mask1)]] = e
    i2, j2 = np.triu_indices(q, k=1)
    b[order4[np.searchsorted(
        sorted4, (1 << i2.astype(np.uint64)) ^ (1 << j2.astype(np.uint64)))]] \
        = 2.0 * Q[i2, j2]

    v = sp.coo_matrix(([1.0], ([0], [0])), shape=(lsp, 1))
    A_full = sp.hstack([v, A]).tocsr()
    c = np.zeros(1 + nn * nn)
    c[0] = 1.0
    return A_full, b, c, nn, 1, dAAt
