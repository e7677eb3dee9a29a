"""Operators of the dual (Riemannian-ADMM) drivers (PyTorch port of
manisdp_tpu/ops/dualops.py).

The dual drivers factor the slack S = Y'Y and recover the primal X from
multipliers; the ADMM multiplier and the gradient matrix are dense n x n
and their products with Y are GEMMs.  The constraint operator A (m x n^2)
and the free block B stay sparse: host numpy assembly as in the JAX
package, int32 index arrays with CSR pointers built in numpy, and every
product on kernel K4 (``kernels.csr_gather``): A(M) is a gather by
constraint row, mat(A'y) a ``scatter_pos`` over the distinct flat
positions i*n + j, B'y and iAB's products gathers.

Invariant inherited from the reference: A A' is diagonal (true for the
SOS bases of frontends/sos.py), so the y-step is the closed form
y = (AA')^{-1} (A(S) - A(C)) (ManiDSDP_unitdiag.m:39-41,74).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..kernels import csr_gather
from ..solvers.common import resolve_device

# n^2 must index an int32 flat position
MAX_N = 46340


def _ptr(sorted_keys: np.ndarray, nseg: int) -> np.ndarray:
    """int32 CSR pointer (nseg + 1,) over ascending segment keys."""
    if sorted_keys.size >= 2 ** 31:
        raise ValueError(f"{sorted_keys.size} entries exceed int32")
    return np.searchsorted(sorted_keys, np.arange(nseg + 1)).astype(np.int32)


def _i32(a: np.ndarray, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, dtype=np.int32), device=device)


def _f64(a, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, dtype=np.float64), device=device)


@dataclasses.dataclass(frozen=True)
class SparseMat:
    """General sparse matrix (rows x cols) with both orderings: ``*_r``
    sorted by row with ``row_ptr`` (for M @ v), ``*_c`` sorted by column
    with ``col_ptr`` (for M.T @ u)."""
    row_r: torch.Tensor
    col_r: torch.Tensor
    val_r: torch.Tensor
    row_c: torch.Tensor
    col_c: torch.Tensor
    val_c: torch.Tensor
    row_ptr: torch.Tensor      # (nrows + 1,) int32
    col_ptr: torch.Tensor      # (ncols + 1,) int32
    nrows: int
    ncols: int

    @staticmethod
    def from_scipy(M, device="cuda") -> "SparseMat":
        import scipy.sparse as sp
        device = resolve_device(device)
        coo = sp.coo_matrix(M)
        nrows, ncols = int(M.shape[0]), int(M.shape[1])
        if max(nrows, ncols) >= 2 ** 31:
            raise ValueError(f"shape {M.shape} exceeds int32 indices")
        orow = np.lexsort((coo.col, coo.row))
        ocol = np.lexsort((coo.row, coo.col))
        return SparseMat(
            row_r=_i32(coo.row[orow], device),
            col_r=_i32(coo.col[orow], device),
            val_r=_f64(coo.data[orow], device),
            row_c=_i32(coo.row[ocol], device),
            col_c=_i32(coo.col[ocol], device),
            val_c=_f64(coo.data[ocol], device),
            row_ptr=_i32(_ptr(coo.row[orow], nrows), device),
            col_ptr=_i32(_ptr(coo.col[ocol], ncols), device),
            nrows=nrows, ncols=ncols)

    def astype(self, dtype) -> "SparseMat":
        return dataclasses.replace(self, val_r=self.val_r.to(dtype),
                                   val_c=self.val_c.to(dtype))

    def matvec(self, v):
        """M @ v (K4 gather by row)."""
        return csr_gather(v.contiguous(), self.row_ptr, self.col_r,
                          self.val_r)

    def rmatvec(self, u):
        """M' @ u (K4 gather by column)."""
        return csr_gather(u.contiguous(), self.col_ptr, self.row_c,
                          self.val_c)


@dataclasses.dataclass(frozen=True)
class DualOp:
    """Dual-form data: sup <C,X>+<c,w> s.t. A(X)+B(w)=b, X psd, w free.

    A is the PSD-block operator (m x n^2), B the free block (m x f).
    Entries of A are (k, lin) with lin = i*n + j row-major into a dense
    n x n matrix; the k-sorted order (with ``krow_ptr``) carries A(M), the
    lin-sorted order (with the distinct positions ``pos`` and ``pos_ptr``)
    carries mat(A'y).
    """
    k_r: torch.Tensor
    lin_r: torch.Tensor
    v_r: torch.Tensor
    k_c: torch.Tensor
    lin_c: torch.Tensor
    v_c: torch.Tensor
    B: SparseMat
    b: torch.Tensor            # (m,)
    cf: torch.Tensor           # (f,) free-part cost
    C: torch.Tensor            # (n, n) dense PSD-part cost
    idAAt: torch.Tensor        # (m,) 1 / diag(A A')
    bA: torch.Tensor           # (n, n) dense mat(A' D^{-1} b)
    Ac: torch.Tensor           # (m,)  A @ vec(C)
    krow_ptr: torch.Tensor     # (m + 1,) int32 over the k-sorted entries
    pos: torch.Tensor          # (npos,) int32 distinct lin, ascending
    pos_ptr: torch.Tensor      # (npos + 1,) int32 over the lin-sorted ones
    m: int
    n: int
    f: int

    @staticmethod
    def build(A, b, c, n: int, f: int = 0, dAAt=None, ns=None,
              device="cuda") -> "DualOp":
        """A: (m, f + n^2) scipy sparse, SeDuMi dual layout (free block
        first, ManiDSDP_unitdiag.m:34-37); c likewise; vec is column-major
        (MATLAB).  ``ns`` (multiblock): the PSD columns hold the stacked
        per-block vecs, remapped into the flat N = sum(n_i) column space;
        ``n`` is then ignored in favor of N."""
        import scipy.sparse as sp
        device = resolve_device(device)
        if ns is None and n > MAX_N:
            raise ValueError(f"n = {n} > {MAX_N}: flat positions i*n + j "
                             "would overflow int32")
        A = sp.csr_matrix(A)
        m = A.shape[0]
        c = np.asarray(c, dtype=np.float64).ravel()
        cf = c[:f]
        cs = c[f:]
        B = A[:, :f].tocoo()
        Ap = A[:, f:].tocoo()

        kk = Ap.row.astype(np.int64)
        lin_cm = Ap.col.astype(np.int64)          # column-major stacked
        if ns is not None:
            nsa = np.asarray(ns, dtype=np.int64)
            off = np.concatenate([[0], np.cumsum(nsa)])
            off2 = np.concatenate([[0], np.cumsum(nsa ** 2)])
            n = int(off[-1])
            if n > MAX_N:
                raise ValueError(f"N = {n} > {MAX_N}: flat positions "
                                 "i*N + j would overflow int32")

            def to_ij(lin_idx):
                bl = np.searchsorted(off2, lin_idx, side="right") - 1
                loc = lin_idx - off2[bl]
                return loc % nsa[bl] + off[bl], loc // nsa[bl] + off[bl]

            ii, jj = to_ij(lin_cm)
            cs_full = np.zeros((n, n))
            cl = np.nonzero(cs)[0].astype(np.int64)
            ci, cjj = to_ij(cl)
            np.add.at(cs_full, (ci, cjj), cs[cl])
            cs = cs_full.flatten(order="F")
        else:
            ii = lin_cm % n
            jj = lin_cm // n
        lin = ii * n + jj                          # row-major for device
        vv = Ap.data.astype(np.float64)

        if dAAt is None:
            dAAt = np.zeros(m)
            np.add.at(dAAt, kk, vv * vv)
        else:
            dAAt = np.asarray(dAAt, dtype=np.float64).ravel()
        idAAt = 1.0 / dAAt

        orow = np.argsort(kk, kind="stable")
        ocol = np.argsort(lin, kind="stable")

        C = cs.reshape(n, n, order="F")
        bAv = vv * (b.ravel()[kk] * idAAt[kk])
        bA = np.zeros(n * n)
        np.add.at(bA, lin, bAv)
        Ac = np.zeros(m)
        np.add.at(Ac, kk, vv * C.reshape(-1)[lin])

        lin_sorted = lin[ocol]
        pos, seg = np.unique(lin_sorted, return_inverse=True)
        return DualOp(
            k_r=_i32(kk[orow], device), lin_r=_i32(lin[orow], device),
            v_r=_f64(vv[orow], device),
            k_c=_i32(kk[ocol], device), lin_c=_i32(lin_sorted, device),
            v_c=_f64(vv[ocol], device),
            B=SparseMat.from_scipy(B, device),
            b=_f64(np.asarray(b, dtype=np.float64).ravel(), device),
            cf=_f64(cf, device), C=_f64(C, device),
            idAAt=_f64(idAAt, device), bA=_f64(bA.reshape(n, n), device),
            Ac=_f64(Ac, device),
            krow_ptr=_i32(_ptr(kk[orow], m), device),
            pos=_i32(pos, device),
            pos_ptr=_i32(_ptr(seg, pos.shape[0]), device),
            m=m, n=n, f=int(f))

    @property
    def device(self) -> torch.device:
        return self.C.device

    def astype(self, dtype) -> "DualOp":
        """Float arrays cast to ``dtype``; index arrays shared."""
        return dataclasses.replace(
            self, B=self.B.astype(dtype),
            **{k: getattr(self, k).to(dtype)
               for k in ("v_r", "v_c", "b", "cf", "C", "idAAt", "bA",
                         "Ac")})

    # ---- operators on dense n x n matrices -----------------------------
    def apply(self, M, base=None):
        """A(vec(M)) -> (m,) for dense M [+ base] (K4 gather by row)."""
        return csr_gather(M.contiguous().view(-1), self.krow_ptr,
                          self.lin_r, self.v_r, base=base)

    def adjoint(self, y, base=None):
        """mat(A'y) [+ base (n, n)] -> dense (n, n) (K4 scatter_pos)."""
        flat = csr_gather(
            y.contiguous(), self.pos_ptr, self.k_c, self.v_c,
            base=None if base is None else base.contiguous().view(-1),
            pos=self.pos, size=self.n * self.n)
        return flat.view(self.n, self.n)

    def adjoint_scaled(self, v):
        """mat(A' (AA')^{-1} v)."""
        return self.adjoint(self.idAAt * v)

    def residual(self, y, S, Xm=None, sigma=None):
        """mat(A'y) - (S - C) [- Xm / sigma]: the base goes into the
        scatter."""
        base = self.C - S
        if Xm is not None:
            base = base - Xm / sigma
        return self.adjoint(y, base=base)

    def y_step(self, S):
        """Closed-form y = (AA')^{-1} (A(S) - A(C))  (ManiDSDP_unitdiag.m:74)."""
        return self.idAAt * self.apply(S, base=-self.Ac)
