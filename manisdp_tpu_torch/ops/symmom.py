"""Gather-free BQP moment-SDP constraint operator on the expanded pair
basis (PyTorch port of manisdp_tpu/ops/symmom.py).

The order-2 moment relaxation of  min x'Qx + e'x over {-1,1}^q (the
reference's bqpmom.m, rebuilt in frontends/moments.py) feeds the primal
unit-diagonal AL driver with a sparse constraint matrix of m ~ mb^2/2 rows
over the moment basis [1, x_a, x_{ab}] (mb = 1 + q + C(q,2)).  As
ops/symdual.py does for the SOS dual, this operator works on the expanded
basis

    [ 1, 1', x_a (a < q), q x q grid slot(i, j) = x_i x_j (i != j),
      slot(a, a) = x_a' ]                      (n~ = 2 + q + q^2)

in which every original column has two copies.  ``apply`` reads the
copy-average of each original entry and reproduces the reference's rows
exactly (kernel K9, ``kernels.symmom_apply``); ``adjoint`` is its exact
linear adjoint (kernel K10, ``kernels.symmom_adjoint``).  The residual
quantities equal the reference's; the solver's only remapping is
geometric (tau -> sqrt(2) tau, tolgradnorm -> tolgradnorm / sqrt(2),
solvers/primal_mom.py).

Flat multiplier ("m-space") layout, don't-care slots exactly 0 in apply()
and b:

  [ r0 (1,), D1 (q,), D2 (q,q | a != b), SUBv (q,q | k != b),
    SUBp (q,q,q | b < c, k not in {b,c}), EQ2 (q,q | a < b),
    EQ4 (q,q,q | i != j, k > max(i,j)),
    EQ6 (q,q,q,q | i<j<k<l row 1, i<j<l<k row 2 at slot [j,i,k,l]) ]

The torch formulas below (``_compress_entries``, ``_rows_from_entries``,
``_entries_from_rows``, ``_spread_entries``) are the JAX package's, and
serve as the kernels' plain twins on CPU tensors.
"""

from __future__ import annotations

import dataclasses
from math import comb

import numpy as np
import torch

from ..kernels import (symdual_sym_factor, symmom_adjoint, symmom_apply,
                       symmom_flat_length)
from ..solvers.common import resolve_device
from .sparse import _DenseCarrier, _MVecResiduals


def _iotas(q, dim, device):
    a = torch.arange(q, device=device)
    return [a.reshape([q if d == k else 1 for d in range(dim)])
            for k in range(dim)]


# ---------------------------------------------------------------------------
# compression: expanded SYMMETRIC (n~, n~) matrix -> original-entry tensors
# ---------------------------------------------------------------------------

def _compress_entries(M, q):
    """Copy-averaged original-entry tensors (c00, cA, cD, cG, cP0, cH, cT)
    of a SYMMETRIC M; slots violating the index conditions are
    unspecified (the JAX package's formulas)."""
    es = torch.einsum
    o = 2 + q
    s = M[:2, :2]
    u = M[:2, 2:o]
    E = M[:2, o:].reshape(2, q, q)
    G = M[2:o, 2:o]
    H = M[2:o, o:].reshape(q, q, q)
    T = M[o:, o:].reshape(q, q, q, q)

    c00 = 0.25 * (s[0, 0] + s[0, 1] + s[1, 0] + s[1, 1])
    dE = es('sii->si', E)
    cA = 0.25 * (u[0] + u[1] + dE[0] + dE[1])
    cD = 0.25 * (torch.diagonal(G) + 2.0 * es('aaa->a', H)
                 + es('aaaa->a', T))
    cG = 0.25 * (G + es('abb->ab', H) + es('baa->ab', H)
                 + es('aabb->ab', T))
    cP0 = 0.25 * (E[0] + E[0].T + E[1] + E[1].T)
    Td = es('aabc->abc', T)
    cH = 0.25 * (H + torch.swapaxes(H, 1, 2) + Td + torch.swapaxes(Td, 1, 2))
    P = T + torch.swapaxes(T, 2, 3)
    cT = 0.25 * (P + torch.swapaxes(P, 0, 1))
    return c00, cA, cD, cG, cP0, cH, cT


def _spread_entries(q, w00, wA, wD, wG, wP0, wH, wT, dtype):
    """Exact adjoint of _compress_entries: masked coefficient tensors ->
    dense (n~, n~), then symmetrized (the adjoint of Sym(M))."""
    o = 2 + q
    nn = o + q * q
    dev = wT.device
    eye = torch.eye(q, dtype=dtype, device=dev)
    M = torch.zeros((nn, nn), dtype=dtype, device=dev)

    M[:2, :2] += 0.25 * w00
    M[0, 2:o] += 0.25 * wA
    M[1, 2:o] += 0.25 * wA
    Eacc = 0.25 * wA[:, None] * eye + 0.25 * (wP0 + wP0.T)
    M[0, o:] += Eacc.reshape(-1)
    M[1, o:] += Eacc.reshape(-1)

    M[2:o, 2:o] += 0.25 * (torch.diag(wD) + wG)

    wHs = 0.25 * (wH + torch.swapaxes(wH, 1, 2))
    Hacc = (0.5 * wD[:, None, None] * (eye[:, :, None] * eye[:, None, :])
            + 0.25 * wG[:, :, None] * eye[None, :, :]
            + 0.25 * wG.T[:, :, None] * eye[None, :, :]
            + wHs)
    M[2:o, o:] += Hacc.reshape(q, -1)

    wTs = 0.25 * (wT + torch.swapaxes(wT, 2, 3))
    wTs = wTs + torch.swapaxes(wTs, 0, 1)
    d2 = eye[:, :, None, None] * eye[None, None, :, :]
    i4, j4, k4, l4 = _iotas(q, 4, dev)
    Tacc = torch.where((i4 == j4) & (j4 == k4) & (k4 == l4),
                       0.25 * wD[:, None, None, None],
                       torch.zeros((), dtype=dtype, device=dev))
    Tacc = Tacc + 0.25 * wG[:, None, :, None] * d2
    Tacc = Tacc + eye[:, :, None, None] * wHs[:, None, :, :]
    Tacc = Tacc + wTs
    M[o:, o:] += Tacc.reshape(q * q, q * q)
    return 0.5 * (M + M.T)


# ---------------------------------------------------------------------------
# row assembly and its adjoint
# ---------------------------------------------------------------------------

def _masks(q, device="cpu"):
    """Boolean masks of the valid slots: off2, lt2, SUBp, EQ4, EQ6 rows 1
    and 2."""
    i2, j2 = _iotas(q, 2, device)
    off2 = i2 != j2
    lt2 = i2 < j2
    i3, j3, k3 = _iotas(q, 3, device)
    m_subp = (j3 < k3) & (i3 != j3) & (i3 != k3)
    m_eq4 = (i3 != j3) & (k3 > i3) & (k3 > j3)
    i4, j4, k4, l4 = _iotas(q, 4, device)
    m_eq6a = (i4 < j4) & (j4 < k4) & (k4 < l4)
    m_eq6b = (j4 < i4) & (i4 < k4) & (k4 < l4)
    return off2, lt2, m_subp, m_eq4, m_eq6a, m_eq6b


def _rows_from_entries(q, c00, cA, cD, cG, cP0, cH, cT):
    dt, dev = cT.dtype, cT.device
    es = torch.einsum
    off2, lt2, m_subp, m_eq4, m_eq6a, m_eq6b = _masks(q, dev)
    zero = torch.zeros((), dtype=dt, device=dev)

    r0 = c00
    D1 = 0.5 * c00 - 0.5 * cD
    cPD = es('abab->ab', cT)
    D2 = torch.where(off2, 0.5 * cD[:, None] - 0.5 * cPD, zero)
    cHkk = es('kkb->kb', cH)
    SUBv = torch.where(off2, 2.0 * cHkk - 2.0 * cA[None, :], zero)
    cTkk = es('kbkc->kbc', cT)
    SUBp = torch.where(m_subp, 2.0 * cTkk - (cP0 + cG)[None, :, :], zero)
    EQ2 = torch.where(lt2, cG - cP0, zero)
    tH = es('kij->ijk', cH)
    EQ4 = torch.where(m_eq4, tH - cH, zero)
    W1 = es('jkil->ijkl', cT)
    U6 = es('ikjl->ijkl', cT)
    EQ6 = torch.where(m_eq6a, W1 - cT, zero) + \
        torch.where(m_eq6b, U6 - W1, zero)
    return torch.cat([
        r0.reshape(1), D1, D2.reshape(-1), SUBv.reshape(-1),
        SUBp.reshape(-1), EQ2.reshape(-1), EQ4.reshape(-1), EQ6.reshape(-1)])


def _split_rows(y, q):
    q2, q3 = q * q, q ** 3
    offs = np.cumsum([1, q, q2, q2, q3, q2, q3])
    return (y[0], y[1:1 + q], y[offs[1]:offs[2]].reshape(q, q),
            y[offs[2]:offs[3]].reshape(q, q),
            y[offs[3]:offs[4]].reshape(q, q, q),
            y[offs[4]:offs[5]].reshape(q, q),
            y[offs[5]:offs[6]].reshape(q, q, q),
            y[offs[6]:].reshape(q, q, q, q))


def _entries_from_rows(q, y, dtype):
    """Adjoint of _rows_from_entries: flat multipliers -> masked
    coefficient tensors on the original entries (only valid slots of y
    are read)."""
    dev = y.device
    es = torch.einsum
    off2, lt2, m_subp, m_eq4, m_eq6a, m_eq6b = _masks(q, dev)
    y0, yD1, yD2, ySv, ySp, yE2, yE4, yE6 = _split_rows(y, q)
    zero = torch.zeros((), dtype=dtype, device=dev)
    yD2 = torch.where(off2, yD2, zero)
    ySv = torch.where(off2, ySv, zero)
    ySp = torch.where(m_subp, ySp, zero)
    yE2 = torch.where(lt2, yE2, zero)
    yE4 = torch.where(m_eq4, yE4, zero)
    y6a = torch.where(m_eq6a, yE6, zero)
    y6b = torch.where(m_eq6b, yE6, zero)
    eye = torch.eye(q, dtype=dtype, device=dev)

    w00 = y0 + 0.5 * torch.sum(yD1)
    wD = -0.5 * yD1 + 0.5 * torch.sum(yD2, dim=1)
    wA = -2.0 * torch.sum(ySv, dim=0)
    wG = yE2 - torch.sum(ySp, dim=0)
    wP0 = -yE2 - torch.sum(ySp, dim=0)
    wH = (2.0 * ySv[:, None, :] * eye[:, :, None]
          + es('ijk->kij', yE4) - yE4)
    dik = eye[:, None, :, None]
    djl = eye[None, :, None, :]
    wT = (-0.5 * yD2[:, :, None, None] * dik * djl
          + 2.0 * ySp[:, :, None, :] * dik
          + es('cabd->abcd', y6a - y6b) - y6a
          + es('acbd->abcd', y6b))
    wG = torch.where(off2, wG, zero)
    wP0 = torch.where(off2, wP0, zero)
    i3, j3, k3 = _iotas(q, 3, dev)
    wH = torch.where(j3 != k3, wH, zero)
    i4, j4, k4, l4 = _iotas(q, 4, dev)
    wT = torch.where((i4 != j4) & (k4 != l4), wT, zero)
    return w00, wA, wD, wG, wP0, wH, wT


def apply_plain(M, q: int):
    """Plain twin of K9: the JAX package's _apply_jit on (n~, n~) M."""
    Ms = 0.5 * (M + M.T)
    return _rows_from_entries(q, *_compress_entries(Ms, q))


def adjoint_plain(y, q: int):
    """Plain twin of K10: the JAX package's _adjoint_jit on flat (m,) y."""
    dt = y.dtype
    return _spread_entries(q, *_entries_from_rows(q, y, dt), dt)


def dontcare_mask(q: int) -> np.ndarray:
    """Boolean mask over the flat layout marking the don't-care slots."""
    off2, lt2, m_subp, m_eq4, m_eq6a, m_eq6b = (
        m.numpy() for m in _masks(q))
    return ~np.concatenate([
        np.ones(1 + q, dtype=bool), off2.ravel(), off2.ravel(),
        m_subp.ravel(), lt2.ravel(), m_eq4.ravel(),
        (m_eq6a | m_eq6b).ravel()])


@dataclasses.dataclass(frozen=True)
class SymMomOp(_DenseCarrier, _MVecResiduals):
    """Dense-tensor drop-in for ConstraintOp on the bqpmom relaxation (the
    JAX package's SymMomOp).

    The primal AL operator protocol with dense (n~, n~) pattern carriers,
    as DenseConstraintOp: the pattern values are the dense matrix and the
    residual space is the flat per-family layout above.  ``n`` is the
    expanded basis size n~ = 2 + q + q^2, ``n_orig`` = 1 + q + C(q, 2) the
    reference's mb, ``m`` the flat residual length, ``m_true`` the
    reference's constraint count (for logging)."""
    C: torch.Tensor            # (n~, n~) dense expanded cost
    b: torch.Tensor            # (m,) flat right-hand side: slot 0 is 1
    dup0: torch.Tensor         # (n_orig,) int32 first copy of each column
    dup1: torch.Tensor         # (n_orig,) int32 second copy
    q: int
    m: int
    n: int
    m_true: int
    n_orig: int

    @property
    def device(self) -> torch.device:
        return self.C.device

    def astype(self, dtype) -> "SymMomOp":
        """C and b cast to ``dtype``; the index arrays shared."""
        return dataclasses.replace(self, C=self.C.to(dtype),
                                   b=self.b.to(dtype))

    # -- operator protocol (dense carriers; the rest in _DenseCarrier) ----
    def apply_from_e(self, e):
        return symmom_apply(e.contiguous(), self.q)

    def adjoint_on_pattern(self, w):
        return symmom_adjoint(w.contiguous(), self.q)

    def normal_factored(self, Y, U):
        return self.adjoint_on_pattern(self.apply_factored(Y, U))

    def es_vals(self, w, sigma: float):
        """C + sigma * A'(w), the base fused into K10."""
        return symmom_adjoint(w.contiguous(), self.q, base=self.C,
                              alpha=sigma)

    def s_vals(self, y):
        """C - A'(y) (the dual slack carrier)."""
        return symmom_adjoint(y.contiguous(), self.q, base=self.C,
                              alpha=-1.0)

    # -- expanded-basis hooks (as SymDualOp) -------------------------------
    def symmetrize(self, Y, renorm: bool = True):
        """Project a (p, n~) factor onto the duplicate-symmetric subspace,
        optionally renormalizing columns (K8 ``sym_factor``)."""
        return symdual_sym_factor(Y.contiguous(), self.q, renorm)

    def compress(self, M_dev):
        """Original-basis (n_orig, n_orig) VALUE matrix: the representative
        slots (copy values are equal on the symmetric subspace)."""
        d0 = self.dup0
        return M_dev.index_select(0, d0).index_select(1, d0)

    def compress_coef(self, M_dev):
        """Original-basis COEFFICIENT matrix of a spread operator matrix
        (e.g. s_vals' output): 4x the representative slots."""
        return 4.0 * self.compress(M_dev)

    def lift_vecs(self, V: torch.Tensor) -> torch.Tensor:
        """Lift original-basis (n_orig, k) vectors into unit expanded
        vectors on V's device (each copy slot gets v / sqrt(2))."""
        s = V / np.sqrt(2.0)
        out = torch.zeros((self.n, V.shape[1]), dtype=V.dtype,
                          device=V.device)
        out[self.dup0.long().to(V.device)] = s
        out[self.dup1.long().to(V.device)] = s
        return out

    # -- host build --------------------------------------------------------
    @staticmethod
    def build_bqpmom(Q, e, q: int, device="cuda") -> "SymMomOp":
        """Expanded operator for the bqpmom relaxation of
        min x'Qx + e'x over {-1,1}^q on ``device`` (host numpy build, the
        JAX package's)."""
        device = resolve_device(device)
        C, rep, dup, m_true, m_flat, nn, mb = _build_host(Q, e, q)
        if m_flat >= 2 ** 31:
            raise ValueError(f"q = {q}: the flat residual length {m_flat} "
                             "exceeds int32")
        f64 = dict(dtype=torch.float64, device=device)
        i32 = dict(dtype=torch.int32, device=device)
        b = torch.zeros(m_flat, **f64)
        b[0] = 1.0
        return SymMomOp(C=torch.as_tensor(C, **f64), b=b,
                        dup0=torch.as_tensor(rep, **i32),
                        dup1=torch.as_tensor(dup, **i32), q=q, m=m_flat,
                        n=nn, m_true=m_true, n_orig=mb)


def _build_host(Q, e, q: int):
    """The expanded cost, the copy maps and the sizes (numpy), as
    SymMomOp.build_bqpmom of the JAX package computes them."""
    Q = np.asarray(Q, dtype=np.float64)
    e = np.asarray(e, dtype=np.float64).ravel()
    o = 2 + q
    nn = o + q * q

    def grid(i, j):
        return o + i * q + j

    # expanded cost: spread of the reference C (bqpmom.m:93-114):
    # W[(x_i, x_i)] = Q_ii;  W[(1, x_i)] = W[(x_i, 1)] = e_i / 2;
    # W[(1, x_ij)] = W[(x_i, x_j)] = Q_ij / 2 (+ transposes);
    # every ordered copy pair receives W/4.
    Cx = np.zeros((nn, nn))
    const = (0, 1)
    for i in range(q):
        ci = (2 + i, grid(i, i))
        for a in ci:
            for bcol in ci:
                Cx[a, bcol] += Q[i, i] / 4.0
        for a in const:
            for bcol in ci:
                Cx[a, bcol] += e[i] / 8.0
                Cx[bcol, a] += e[i] / 8.0
    for i in range(q):
        for j in range(i + 1, q):
            cij = (grid(i, j), grid(j, i))
            for a in const:
                for bcol in cij:
                    Cx[a, bcol] += Q[i, j] / 8.0
                    Cx[bcol, a] += Q[i, j] / 8.0
            ci = (2 + i, grid(i, i))
            cj = (2 + j, grid(j, j))
            for a in ci:
                for bcol in cj:
                    Cx[a, bcol] += Q[i, j] / 8.0
                    Cx[bcol, a] += Q[i, j] / 8.0

    iu, ju = np.triu_indices(q, k=1)
    order = np.lexsort((iu, ju))        # colex: (v major, u minor)
    pa, pb = iu[order], ju[order]
    rep = np.concatenate([[0], 2 + np.arange(q), grid(pa, pb)])
    dup = np.concatenate([[1], grid(np.arange(q), np.arange(q)),
                          grid(pb, pa)])
    mb = 1 + q + comb(q, 2)
    lsp = (q + comb(q, 2) + q * (q - 1)        # {a},{ab},{k2 b}
           + comb(q, 3) + q * comb(q - 1, 2) + comb(q, 4))
    m_true = mb * (mb + 1) // 2 - lsp + q * (mb - 1) - mb + 1
    return Cx, rep, dup, m_true, symmom_flat_length(q), nn, mb
