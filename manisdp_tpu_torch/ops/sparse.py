"""Sparse operators on Burer-Monteiro factors (PyTorch port of
manisdp_tpu/ops/sparse.py: SymCOO, the factored constraint operator and
its two dense carriers).

The factor Y is (p, n); X = YᵀY is never formed.  ``gather_cols``,
``pair_dots`` and ``scatter_cols`` are the plain formulas the JAX package
runs as gather / segment-sum chains; ``SymCOO``'s products go through
kernel K1 (``kernels.symcoo_spmm``) on CUDA tensors and through its plain
twin, built from these formulas, on CPU tensors.  ``ConstraintOp``'s pair
dots are kernel K3 (``kernels.pattern_dots``) and its operator and
adjoint are kernel K4 (``kernels.csr_gather``), again with plain twins.
``DenseConstraintOp`` carries the pattern values as dense (n, n) arrays
(GEMMs, K4's gather and ``scatter_pos`` modes); ``EntrywiseConstraintOp``
does so for entrywise constraint sets (GEMMs and kernel K5,
``kernels.masked_sym``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..kernels import csr_gather, masked_sym, pattern_dots, symcoo_spmm


def gather_cols(Y, idx):
    """Columns of Y (p, n) at idx (nnz,) -> (nnz, p)."""
    return Y.T[idx.long()]


def pair_dots(Y, U, i, j):
    """<Y[:,i_e], U[:,j_e]> for each entry e -> (nnz,)."""
    return torch.sum(gather_cols(Y, i) * gather_cols(U, j), dim=1)


def scatter_cols(vals, src_idx, out_idx, Y, n):
    """sum_e vals_e * Y[:, src_idx_e] scattered into column out_idx_e:
    the (p, n) factored form of ``Y @ M`` with M[src, out] = vals."""
    contrib = gather_cols(Y, src_idx) * vals[:, None]           # (nnz, p)
    out = torch.zeros((n, Y.shape[0]), dtype=contrib.dtype,
                      device=contrib.device)
    out.index_add_(0, out_idx.long(), contrib)                  # (n, p)
    return out.T


@dataclasses.dataclass(frozen=True)
class SymCOO:
    """Symmetric n-by-n sparse matrix, full (both-triangles) COO pattern,
    sorted by (column, row).  ``colptr`` (n+1, int32) delimits each
    column's entries: the CSR row pointer of C, since C is symmetric."""
    i: torch.Tensor        # (nnz,) int32 row
    j: torch.Tensor        # (nnz,) int32 column, ascending
    v: torch.Tensor        # (nnz,) values
    n: int
    colptr: torch.Tensor   # (n+1,) int32
    # a slice of a larger pattern (a sharded operator's): (c0, c1, r0,
    # r1), its entries lie in columns c0 .. c1-1 and rows r0 .. r1-1; its
    # products are then the (p, c1 - c0) column block of those columns
    # (None: the whole n x n)
    span: Optional[tuple] = None

    @staticmethod
    def from_arrays(i, j, v, n: int, device, dtype=torch.float64
                    ) -> "SymCOO":
        """Build from host arrays: sort by (column, row) and derive
        ``colptr``."""
        order = np.lexsort((np.asarray(i), np.asarray(j)))
        i = np.asarray(i, dtype=np.int64)[order]
        j = np.asarray(j, dtype=np.int64)[order]
        v = np.asarray(v, dtype=np.float64)[order]
        if i.size and (min(i.min(), j.min()) < 0 or
                       max(i.max(), j.max()) >= n):
            raise ValueError(f"entry index out of range for n={n}")
        colptr = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(np.bincount(j, minlength=n), out=colptr[1:])
        as_t = lambda a, dt: torch.tensor(a, dtype=dt, device=device)  # noqa: E731
        return SymCOO(i=as_t(i, torch.int32), j=as_t(j, torch.int32),
                      v=as_t(v, dtype), n=int(n),
                      colptr=as_t(colptr, torch.int32))

    @staticmethod
    def from_scipy(mat, device, dtype=torch.float64) -> "SymCOO":
        import scipy.sparse as sp
        coo = sp.coo_matrix(mat)
        return SymCOO.from_arrays(coo.row, coo.col, coo.data,
                                  int(mat.shape[0]), device, dtype)

    @property
    def nnz(self) -> int:
        return int(self.v.shape[0])

    def astype(self, dtype) -> "SymCOO":
        """The same pattern with values cast to ``dtype``."""
        return dataclasses.replace(self, v=self.v.to(dtype))

    def matmat(self, Y):
        """Y @ C for Y (p, n)."""
        return symcoo_spmm(Y, self, "plain")

    def matmat_vals(self, Y, vals):
        """Y @ M where M has this pattern but values ``vals``."""
        return symcoo_spmm(Y, self, "plain", vals=vals)

    def matvec_block(self, V, vals=None):
        """C @ V for a dense (n, k) block V — K1 on the Vᵀ view."""
        return symcoo_spmm(V.T, self, "plain", vals=vals).T

    def quad_cols(self, Y, U=None):
        """Column sums of (YᵀU) ∘ C -> z_j = sum_i C[i,j] <Y:,i, U:,j>."""
        if U is None:
            return symcoo_spmm(Y, self, "cost")[1]
        return torch.sum(U * self.matmat(Y), dim=0)

    def quad_form(self, Y, U=None):
        """<C, YᵀU> (a 0-d tensor)."""
        return torch.sum(self.quad_cols(Y, U))

    def to_dense(self):
        """The dense (n, n) C.  On the card it is K1 against the
        identity, so duplicate entries sum in entry order (an accumulating
        index_put_ would use atomics there)."""
        dt, dev = self.v.dtype, self.v.device
        if dev.type != "cpu":
            return symcoo_spmm(torch.eye(self.n, dtype=dt, device=dev), self)
        out = torch.zeros((self.n, self.n), dtype=dt, device=dev)
        out.index_put_((self.i.long(), self.j.long()), self.v,
                       accumulate=True)
        return out


@dataclasses.dataclass(frozen=True)
class BatchedSymCOO:
    """nb symmetric sparse matrices of one padded size n (the batched
    MaxCut driver's ragged instances).  Each instance's full COO pattern is
    sorted by (column, row) as in SymCOO, and the instances' entries are
    concatenated: instance b owns entries eoff[b] .. eoff[b] + nnz_b, and
    row b of ``colptr`` (nb, n+1) delimits its columns within them.
    Columns past an instance's own n have empty segments, so its products
    there are exactly 0.  (The JAX package pads every instance to a common
    nnz with (0, 0) entries of value 0; a column pointer built from those
    would put them all in column 0's segment.)"""
    i: torch.Tensor        # (nnz,) int32 row within the instance
    j: torch.Tensor        # (nnz,) int32 column
    v: torch.Tensor        # (nnz,) values
    colptr: torch.Tensor   # (nb, n+1) int32, local to each instance
    eoff: torch.Tensor     # (nb,) int64 first entry of each instance
    n: int

    @staticmethod
    def from_scipy(Cs, n_pad: int, device, dtype=torch.float64
                   ) -> "BatchedSymCOO":
        """From nb matrices (scipy sparse or dense) of size <= n_pad:
        each symmetrized as 0.5 (C + Cᵀ) and sorted by (column, row), as
        the JAX package's _pad_sym_coo does."""
        import scipy.sparse as sp
        ii, jj, vv, ptrs = [], [], [], []
        for C in Cs:
            if C.shape[0] > n_pad:
                raise ValueError(f"instance of n = {C.shape[0]} does not "
                                 f"fit n_pad = {n_pad}")
            coo = sp.coo_matrix(C)
            coo = sp.coo_matrix(0.5 * (coo + coo.T))
            order = np.lexsort((coo.row, coo.col))
            ii.append(coo.row[order])
            jj.append(coo.col[order])
            vv.append(coo.data[order])
            ptrs.append(_ptr(jj[-1].astype(np.int64), n_pad))
        nnz = np.array([a.size for a in ii], dtype=np.int64)
        eoff = np.concatenate([[0], np.cumsum(nnz)[:-1]])
        as_t = lambda a, dt: torch.tensor(a, dtype=dt, device=device)  # noqa: E731
        return BatchedSymCOO(
            i=as_t(np.concatenate(ii), torch.int32),
            j=as_t(np.concatenate(jj), torch.int32),
            v=as_t(np.concatenate(vv).astype(np.float64), dtype),
            colptr=as_t(np.stack(ptrs), torch.int32),
            eoff=as_t(eoff, torch.int64), n=int(n_pad))

    @property
    def nb(self) -> int:
        return int(self.colptr.shape[0])

    def _span(self, b: int) -> slice:
        e0 = int(self.eoff[b])
        return slice(e0, e0 + int(self.colptr[b, -1]))

    def entries(self, vals, b: int):
        """Instance b's part of a per-entry array (None passes)."""
        return None if vals is None else vals[self._span(b)]

    def instance(self, b: int) -> SymCOO:
        """Instance b as a SymCOO of size n (views of the arrays)."""
        at = self._span(b)
        return SymCOO(i=self.i[at], j=self.j[at], v=self.v[at], n=self.n,
                      colptr=self.colptr[b])

    def select(self, keep) -> "BatchedSymCOO":
        """The instances ``keep`` (host indices), in that order, as a batch
        of their own: each keeps its entries in their order and its column
        pointer, and the entry arrays hold only theirs (so K1's choice of
        walk, which reads the mean entries a column, sees the kept
        instances alone)."""
        keep = np.asarray(keep, dtype=np.int64)
        e0 = self.eoff.cpu().numpy()[keep]
        nnz = self.colptr[:, -1].cpu().numpy().astype(np.int64)[keep]
        eoff = np.cumsum(nnz) - nnz
        dev = self.v.device
        at = torch.as_tensor(np.arange(int(nnz.sum())) +
                             np.repeat(e0 - eoff, nnz), device=dev)
        return BatchedSymCOO(
            i=self.i[at], j=self.j[at], v=self.v[at],
            colptr=self.colptr[torch.as_tensor(keep, device=dev)],
            eoff=torch.as_tensor(eoff, device=dev), n=self.n)


def _ptr(seg, nseg: int) -> np.ndarray:
    """CSR pointer (nseg+1,) of ascending segment ids ``seg``."""
    ptr = np.zeros(nseg + 1, dtype=np.int64)
    np.cumsum(np.bincount(seg, minlength=nseg), out=ptr[1:])
    return ptr


class _MVecResiduals:
    """Residual-space protocol of the operators whose multipliers and
    residuals are (m,) vectors (needs ``m``, ``b`` and ``device``)."""

    def res_zeros(self):
        return torch.zeros((self.m,), dtype=self.b.dtype, device=self.device)

    def res_from_mvec(self, y):
        """Host (m,) multipliers -> device residual-space repr."""
        return torch.as_tensor(np.asarray(y, dtype=np.float64).ravel(),
                               dtype=self.b.dtype, device=self.device)

    def res_to_mvec(self, y_dev):
        """Device residual-space repr -> host (m,) multipliers."""
        return y_dev.cpu().numpy()

    def dot_res(self, u, v):
        """<u, v> in residual (constraint) space."""
        return torch.dot(u, v)

    def norm_res(self, u):
        return torch.linalg.norm(u)


@dataclasses.dataclass(frozen=True)
class ConstraintOp(_MVecResiduals):
    """The affine operator A : S^n -> R^m in factored-entry form (the JAX
    package's ConstraintOp).

    Every nonzero of the m-by-n^2 SeDuMi constraint matrix is stored as
    (k, i, j, v), sorted by constraint row k, with:

    - ``pat``: the union sparsity pattern P of {c} U {rows of A}, a SymCOO
      sorted by (j, i) whose values are c restricted to P;
    - ``a2p``: A-entry -> index in P;
    - the a2p-sorted second ordering (``kp``, ``vp``, ``a2p_sorted``) that
      the adjoint reads;
    - ``krow_ptr`` (m+1) over the k-sorted entries and ``pat_ptr``
      (nnzP+1) over ``a2p_sorted``: the CSR pointers of kernel K4 in
      both orderings (a pattern entry only C touches has an empty
      segment).

    Assembly runs once per problem in numpy on the host; the arrays then
    live on one device, indices as int32.
    """
    k: torch.Tensor          # (nnzA,) int32, ascending
    i: torch.Tensor
    j: torch.Tensor
    v: torch.Tensor          # (nnzA,) values
    a2p: torch.Tensor        # (nnzA,) int32 index into P
    pat: SymCOO              # pattern P with v = c restricted to P
    b: torch.Tensor          # (m,) right-hand side
    kp: torch.Tensor         # (nnzA,) int32 constraint row, a2p-sorted
    vp: torch.Tensor         # (nnzA,) values, a2p-sorted
    a2p_sorted: torch.Tensor  # (nnzA,) int32, ascending
    krow_ptr: torch.Tensor   # (m+1,) int32
    pat_ptr: torch.Tensor    # (nnzP+1,) int32
    m: int
    n: int

    @staticmethod
    def build(At, b, c, n: int, device) -> "ConstraintOp":
        """From SeDuMi data: At (n^2, m) sparse, b (m,), c (n^2,)."""
        return ConstraintOp.from_arrays(ConstraintOp.assemble(At, b, c, n),
                                        device)

    @staticmethod
    def assemble(At, b, c, n: int) -> dict:
        """The host arrays of ``build`` (as ``_assemble`` returns them),
        nothing uploaded."""
        import scipy.sparse as sp
        A = sp.csr_matrix(At.T) if not sp.issparse(At) else At.T.tocsr()
        m = A.shape[0]
        coo = A.tocoo()
        kk = coo.row.astype(np.int64)
        lin = coo.col.astype(np.int64)          # index into vec(X), col-major
        ii = (lin % n).astype(np.int64)
        jj = (lin // n).astype(np.int64)
        vv = coo.data.astype(np.float64)

        c = np.asarray(c).ravel().astype(np.float64)
        c_sp = sp.coo_matrix(c.reshape(n, n, order="F"))
        return ConstraintOp._assemble(
            kk, ii, jj, vv,
            c_sp.row.astype(np.int64), c_sp.col.astype(np.int64),
            c_sp.data.astype(np.float64), b, n, m)

    @staticmethod
    def build_multiblock(At, b, c, ns, device) -> "ConstraintOp":
        """Multi-block SeDuMi data: At (sum n_i^2, m) with blockwise
        column-major vec stacking (ManiSDP_multiblock.m:67-72).  The blocks
        collapse into one (sum n_i)-column space: entry L of block bl at
        local (i, j) maps to global (off_bl + i, off_bl + j), so X stays
        block-diagonal (no constraint couples two blocks)."""
        import scipy.sparse as sp
        ns = np.asarray(ns, dtype=np.int64)
        off = np.concatenate([[0], np.cumsum(ns)])
        off2 = np.concatenate([[0], np.cumsum(ns ** 2)])
        N = int(off[-1])

        def to_global(lin):
            bl = np.searchsorted(off2, lin, side="right") - 1
            loc = lin - off2[bl]
            return loc % ns[bl] + off[bl], loc // ns[bl] + off[bl]

        A = sp.csr_matrix(At.T) if not sp.issparse(At) else At.T.tocsr()
        m = A.shape[0]
        coo = A.tocoo()
        kk = coo.row.astype(np.int64)
        ii, jj = to_global(coo.col.astype(np.int64))
        vv = coo.data.astype(np.float64)

        c = np.asarray(c).ravel().astype(np.float64)
        cl = np.nonzero(c)[0].astype(np.int64)
        ci, cj = to_global(cl)
        arrays = ConstraintOp._assemble(kk, ii, jj, vv, ci, cj, c[cl], b, N,
                                        m)
        return ConstraintOp.from_arrays(arrays, device)

    @staticmethod
    def _assemble(kk, ii, jj, vv, ci, cj, cv, b, n, m) -> dict:
        """Host arrays of the operator (the JAX package's ``_assemble``):
        entries sorted by k, the union pattern sorted by (j, i), both
        maps."""
        order = np.argsort(kk, kind="stable")
        kk, ii, jj, vv = kk[order], ii[order], jj[order], vv[order]

        # union pattern P, sorted by (j, i)
        keys_a = jj * n + ii
        keys_c = cj * n + ci
        pat_keys = np.unique(np.concatenate([keys_a, keys_c]))
        a2p = np.searchsorted(pat_keys, keys_a).astype(np.int32)
        c2p = np.searchsorted(pat_keys, keys_c)
        c_on_p = np.zeros(pat_keys.shape[0], dtype=np.float64)
        np.add.at(c_on_p, c2p, cv)
        perm = np.argsort(a2p, kind="stable")
        return dict(
            k=kk.astype(np.int32), i=ii.astype(np.int32),
            j=jj.astype(np.int32), v=vv, a2p=a2p,
            pat_i=(pat_keys % n).astype(np.int32),
            pat_j=(pat_keys // n).astype(np.int32), pat_v=c_on_p,
            b=np.asarray(b, dtype=np.float64).ravel(),
            kp=kk[perm].astype(np.int32), vp=vv[perm],
            a2p_sorted=a2p[perm], m=int(m), n=int(n))

    @staticmethod
    def from_arrays(a: dict, device, dtype=torch.float64) -> "ConstraintOp":
        """The operator on ``device`` from host arrays as ``_assemble``
        returns them (keys k, i, j, v, a2p, pat_i, pat_j, pat_v, b, kp, vp,
        a2p_sorted, m, n); derives colptr, krow_ptr and pat_ptr."""
        m, n = int(a["m"]), int(a["n"])
        k = np.asarray(a["k"])
        pat_i, pat_j = np.asarray(a["pat_i"]), np.asarray(a["pat_j"])
        a2p_sorted = np.asarray(a["a2p_sorted"])
        nnzp = pat_i.shape[0]
        keys = pat_j.astype(np.int64) * n + pat_i
        if np.any(np.diff(keys) <= 0) or np.any(np.diff(k) < 0) or \
                np.any(np.diff(a2p_sorted) < 0):
            raise ValueError("operator arrays are not in the sorted order "
                             "_assemble gives them")
        for name, arr, hi in (("k", k, m), ("a2p_sorted", a2p_sorted, nnzp),
                              ("pat_i", pat_i, n), ("pat_j", pat_j, n)):
            if arr.size and (arr.min() < 0 or arr.max() >= hi):
                raise ValueError(f"{name} out of range [0, {hi})")
        idx = lambda x: torch.tensor(np.asarray(x), dtype=torch.int32,  # noqa: E731
                                     device=device)
        val = lambda x: torch.tensor(np.asarray(x), dtype=dtype,  # noqa: E731
                                     device=device)
        pat = SymCOO(i=idx(pat_i), j=idx(pat_j), v=val(a["pat_v"]), n=n,
                     colptr=idx(_ptr(pat_j, n)))
        return ConstraintOp(
            k=idx(k), i=idx(a["i"]), j=idx(a["j"]), v=val(a["v"]),
            a2p=idx(a["a2p"]), pat=pat, b=val(a["b"]), kp=idx(a["kp"]),
            vp=val(a["vp"]), a2p_sorted=idx(a2p_sorted),
            krow_ptr=idx(_ptr(k, m)), pat_ptr=idx(_ptr(a2p_sorted, nnzp)),
            m=m, n=n)

    @property
    def nnz(self) -> int:
        return int(self.v.shape[0])

    @property
    def device(self) -> torch.device:
        return self.v.device

    def astype(self, dtype) -> "ConstraintOp":
        """The same operator with its float arrays (v, vp, b, pat.v) cast
        to ``dtype``; the int32 arrays are shared."""
        return dataclasses.replace(self, v=self.v.to(dtype),
                                   vp=self.vp.to(dtype), b=self.b.to(dtype),
                                   pat=self.pat.astype(dtype))

    # -- forward operator ------------------------------------------------
    def pattern_pair_dots(self, Y, U=None):
        """e_P = <Y[:,i], U[:,j]> on the union pattern P -> (nnzP,)."""
        return pattern_dots(Y, Y if U is None else U, self.pat)

    def apply_from_e(self, e):
        """A(vec(M)) given M's values e on pattern P (via the a2p map)."""
        return csr_gather(e, self.krow_ptr, self.a2p, self.v)

    def apply_factored(self, Y, U=None):
        """A(vec(YᵀU)) -> (m,); U defaults to Y (then it is A(X))."""
        return self.apply_from_e(self.pattern_pair_dots(Y, U))

    def apply_vec(self, x):
        """A @ x for a dense vec(X) (n^2,), off the hot path: the gathered
        entries summed per constraint row by K4 (no atomics)."""
        e = x[self.i.long() + self.j.long() * self.n]
        at = torch.arange(e.shape[0], dtype=torch.int32, device=e.device)
        return csr_gather(e, self.krow_ptr, at, self.v)

    # -- adjoint on the pattern ------------------------------------------
    def adjoint_on_pattern(self, w):
        """Values of mat(Aᵀw) restricted to pattern P -> (nnzP,)."""
        return csr_gather(w, self.pat_ptr, self.kp, self.vp)

    def es_vals(self, w, sigma: float):
        """Values on P of eS = mat(c + sigma * Aᵀw)."""
        return csr_gather(w, self.pat_ptr, self.kp, self.vp,
                          base=self.pat.v, alpha=sigma)

    def s_vals(self, y):
        """Values on P of mat(c - Aᵀy) (the dual slack matrix)."""
        return csr_gather(y, self.pat_ptr, self.kp, self.vp,
                          base=self.pat.v, alpha=-1.0)

    def normal_factored(self, Y, U):
        """Values on P of mat(AᵀA vec(YᵀU)): the AL Hessian's penalty
        term."""
        return self.adjoint_on_pattern(self.apply_factored(Y, U))

    def pattern_dense(self, vals):
        """mat(vals) as a dense (n, n) array.  Pattern positions are
        distinct (``from_arrays`` checks it), so a plain assignment puts
        each value in place, without atomics."""
        out = torch.zeros((self.n, self.n), dtype=vals.dtype,
                          device=vals.device)
        return out.index_put_((self.pat.i.long(), self.pat.j.long()), vals)

    def host_arrays(self, full: bool = False) -> dict:
        """The entries (k, i, j, v), b and c on P as host numpy arrays: what
        the carriers are built from; ``full`` adds a2p and the a2p-sorted
        ordering (kp, vp, a2p_sorted), the keys ``_assemble`` returns."""
        names = ("k", "i", "j", "v", "b") + \
            (("a2p", "kp", "vp", "a2p_sorted") if full else ())
        out = {name: getattr(self, name).cpu().numpy() for name in names}
        out.update(pat_i=self.pat.i.cpu().numpy(),
                   pat_j=self.pat.j.cpu().numpy(),
                   pat_v=self.pat.v.cpu().numpy(), m=self.m, n=self.n)
        return out

    def to_dense_op(self) -> "DenseConstraintOp":
        return DenseConstraintOp.from_op(self)

    # -- operator protocol -----------------------------------------------
    # The AL drivers see the operator only through these, the methods
    # above and the residual-space protocol (multipliers / residuals in
    # R^m, _MVecResiduals).
    @property
    def c_pattern(self):
        """Values of the cost vector c restricted to the pattern P."""
        return self.pat.v

    def dot_pattern(self, u, v):
        """<u, v> over pattern entries."""
        return torch.dot(u, v)

    def colsum_pattern(self, vals):
        """Column sums of mat(vals) on P -> (n,): K4's segment sums over
        the column pointer (no atomics)."""
        ones = torch.ones((self.n,), dtype=vals.dtype, device=vals.device)
        return csr_gather(ones, self.pat.colptr, self.pat.i, vals)

    def matmat_pattern(self, Y, vals):
        """Y @ mat(vals) for vals on P -> (p, n)."""
        return self.pat.matmat_vals(Y, vals)

    def matvec_pattern(self, V, vals):
        """mat(vals) @ V for a dense (n, k) block (certificate matvec)."""
        return self.pat.matvec_block(V, vals)

    def matmat_shift(self, V, vals, z):
        """V·(mat(vals) − diag(z)) -> (rows, n): K1's ``shift`` epilogue
        (the certificate's matvec)."""
        return symcoo_spmm(V, self.pat, "shift", vals=vals, z=z)

    def al_hess(self, U, Y, es, ayu, coefs, eG=None):
        """The AL Hessian's products coefs[0]·U·mat(es) +
        coefs[1]·Y·mat(ayu), K1's ``al_hess``; with ``eG`` its fused
        unit-diagonal epilogue H − Y ∘ colsum(Y ∘ H) − U ∘ eG."""
        return symcoo_spmm(U, self.pat, "al_hess", vals=es, B=Y, vals2=ayu,
                           coefs=coefs, eG=eG)

    def quad_cols(self, Y, vals):
        """colsum(Y ∘ Y·mat(vals)) -> (n,), K1's ``cost`` epilogue (the
        stats' z = colsum_pattern(vals ∘ e_P))."""
        return symcoo_spmm(Y, self.pat, "cost", vals=vals)[1]


class _DenseCarrier:
    """The operator-protocol methods both dense carriers share: pattern
    values are dense (n, n) arrays (needs ``C``, ``apply_from_e``)."""

    @property
    def c_pattern(self):
        return self.C

    def pattern_pair_dots(self, Y, U=None):
        """The dense Gram YᵀU stands in for the pattern dots."""
        return Y.T @ (Y if U is None else U)

    def dot_pattern(self, u, v):
        return torch.sum(u * v)

    def apply_factored(self, Y, U=None):
        return self.apply_from_e(self.pattern_pair_dots(Y, U))

    def colsum_pattern(self, vals):
        return torch.sum(vals, dim=0)

    def matmat_pattern(self, Y, vals):
        return Y @ vals

    def matvec_pattern(self, V, vals):
        return vals @ V

    def matmat_shift(self, V, vals, z):
        return V @ vals - z[None, :] * V


@dataclasses.dataclass(frozen=True)
class DenseConstraintOp(_DenseCarrier, _MVecResiduals):
    """The constraint operator with dense (n, n) pattern carriers (the JAX
    package's DenseConstraintOp), for moderate n.

    "Pattern values" are dense row-major (n, n) arrays here: the pattern
    dots are the Gram YᵀU and the pattern products Y·M are GEMMs.  A(·)
    gathers each A entry from the flat dense e at i·n + j (kernel K4 over
    ``krow_ptr``, col = ``ij``).  The adjoint and es_vals / s_vals scatter
    into a dense (n, n) array through K4's ``scatter_pos`` mode: the
    entries are grouped by flat position (``pos``, ``pos_ptr``, ``kq``,
    ``vq``), so each position is written by one thread, without atomics.
    Every value array (C, the adjoint's scatters) is supported on P, so
    dense products against them vanish off the pattern exactly.
    Multipliers and residuals are (m,) vectors, as for ConstraintOp.
    """
    k: torch.Tensor          # (nnzA,) int32 constraint row, ascending
    ij: torch.Tensor         # (nnzA,) int32 flat position i*n + j, k order
    v: torch.Tensor          # (nnzA,) values, k order
    krow_ptr: torch.Tensor   # (m+1,) int32
    pos: torch.Tensor        # (npos,) int32 distinct flat positions
    pos_ptr: torch.Tensor    # (npos+1,) int32 over the position order
    kq: torch.Tensor         # (nnzA,) int32 constraint row, position order
    vq: torch.Tensor         # (nnzA,) values, position order
    C: torch.Tensor          # (n, n) dense cost
    b: torch.Tensor          # (m,) right-hand side
    m: int
    n: int

    @staticmethod
    def from_op(op: ConstraintOp) -> "DenseConstraintOp":
        a = op.host_arrays()
        a["C"] = op.pattern_dense(op.pat.v)
        return DenseConstraintOp.from_arrays(a, op.device, op.b.dtype)

    @staticmethod
    def from_arrays(a: dict, device, dtype=torch.float64
                    ) -> "DenseConstraintOp":
        """From host arrays k, i, j, v (sorted by k), C (n, n), b, m, n (the
        fields of the JAX package's DenseConstraintOp); derives the flat
        positions and both CSR pointers."""
        m, n = int(a["m"]), int(a["n"])
        if n * n > np.iinfo(np.int32).max:
            raise ValueError(f"n = {n}: flat positions i*n + j overflow int32")
        k, i, j = (np.asarray(a[x], dtype=np.int64) for x in "kij")
        v = np.asarray(a["v"], dtype=np.float64)
        if np.any(np.diff(k) < 0):
            raise ValueError("entries must be sorted by constraint row k")
        for name, arr, hi in (("k", k, m), ("i", i, n), ("j", j, n)):
            if arr.size and (arr.min() < 0 or arr.max() >= hi):
                raise ValueError(f"{name} out of range [0, {hi})")
        ij = i * n + j
        order = np.argsort(ij, kind="stable")
        pos, counts = np.unique(ij[order], return_counts=True)
        pos_ptr = np.zeros(pos.shape[0] + 1, dtype=np.int64)
        np.cumsum(counts, out=pos_ptr[1:])
        idx = lambda x: torch.tensor(x, dtype=torch.int32,  # noqa: E731
                                     device=device)
        val = lambda x: torch.tensor(x, dtype=dtype,  # noqa: E731
                                     device=device)
        C = a["C"]
        C = C.to(device=device, dtype=dtype) if isinstance(C, torch.Tensor) \
            else val(np.asarray(C, dtype=np.float64))
        return DenseConstraintOp(
            k=idx(k), ij=idx(ij), v=val(v), krow_ptr=idx(_ptr(k, m)),
            pos=idx(pos), pos_ptr=idx(pos_ptr), kq=idx(k[order]),
            vq=val(v[order]), C=C.reshape(n, n).contiguous(),
            b=val(np.asarray(a["b"], dtype=np.float64).ravel()), m=m, n=n)

    @property
    def nnz(self) -> int:
        return int(self.v.shape[0])

    @property
    def device(self) -> torch.device:
        return self.v.device

    def astype(self, dtype) -> "DenseConstraintOp":
        """The same operator with v, vq, C and b cast to ``dtype``."""
        return dataclasses.replace(self, v=self.v.to(dtype),
                                   vq=self.vq.to(dtype), C=self.C.to(dtype),
                                   b=self.b.to(dtype))

    # -- operator protocol (dense carriers; the rest in _DenseCarrier) -----
    def apply_from_e(self, e):
        return csr_gather(e.reshape(-1), self.krow_ptr, self.ij, self.v)

    def _scatter(self, w, base, alpha):
        """base + alpha·mat(Aᵀw) as a dense (n, n) array (base None: 0)."""
        out = csr_gather(w, self.pos_ptr, self.kq, self.vq, base=base,
                         alpha=alpha, pos=self.pos, size=self.n * self.n)
        return out.view(self.n, self.n)

    def adjoint_on_pattern(self, w):
        return self._scatter(w, None, 1.0)

    def normal_factored(self, Y, U):
        return self.adjoint_on_pattern(self.apply_factored(Y, U))

    def es_vals(self, w, sigma: float):
        return self._scatter(w, self.C.view(-1), sigma)

    def s_vals(self, y):
        return self._scatter(y, self.C.view(-1), -1.0)


@dataclasses.dataclass(frozen=True)
class EntrywiseConstraintOp(_DenseCarrier):
    """The constraint operator of entrywise-sample constraint sets, the
    matrix-completion class (the JAX package's EntrywiseConstraintOp).

    Every constraint touches one matrix entry: one diagonal position
    (i, i), or a symmetric off-diagonal pair (i, j), (j, i) with equal
    coefficients.  Then AᵀA is diagonal and the AL algebra is dense masked
    elementwise work (kernel K5) plus GEMMs:

      A(M)   (dense rep) = dfac ∘ (aval ∘ M + (aval ∘ M)ᵀ)
      mat(Aᵀw)           = aval ∘ W        (W the dense rep of w)
      mat(AᵀA vec(M))    = aval ∘ A(M)

    Residual space: multipliers y and residuals A(X) − b are dense (n, n)
    symmetric representatives D with D[i, j] = w_k at each position of
    constraint k.  Inner products weight the positions by 1/mult
    (``minv``), so they equal the R^m inner products exactly.
    """
    aval: torch.Tensor   # (n, n) constraint coefficient at each position
    C: torch.Tensor      # (n, n) dense symmetric cost
    b: torch.Tensor      # (n, n) dense rep of the right-hand side
    minv: torch.Tensor   # (n, n) 1/mult on the sample mask, 0 elsewhere
    dfac: torch.Tensor   # (n, n) 0.5/minv on the mask (1 off-diag, 0.5 diag)
    ki: torch.Tensor     # (m,) int32 row of constraint k's entry
    kj: torch.Tensor     # (m,) int32 column (ki <= kj)
    m: int
    n: int

    @staticmethod
    def detect(op: ConstraintOp) -> Optional["EntrywiseConstraintOp"]:
        """Build from a ConstraintOp iff every constraint is entrywise (one
        diagonal entry, or a symmetric off-diagonal pair with equal values)
        and no two constraints share a position; None otherwise."""
        a = op.host_arrays()
        k, i, j, v = (a[x] for x in "kijv")    # sorted by k
        m, n = op.m, op.n
        counts = np.bincount(k, minlength=m)
        if counts.size == 0 or counts.max() > 2 or counts.min() < 1:
            return None
        first = np.concatenate([[0], np.cumsum(counts)[:-1]])
        two = first[counts == 2]
        if two.size and not (np.array_equal(i[two], j[two + 1]) and
                             np.array_equal(j[two], i[two + 1]) and
                             np.allclose(v[two], v[two + 1]) and
                             np.all(i[two] != j[two])):
            return None
        one = first[counts == 1]
        if np.any(i[one] != j[one]):
            return None            # lone off-diagonal entry: asymmetric A_k
        if np.unique(i.astype(np.int64) * n + j).shape[0] != k.shape[0]:
            return None            # two constraints share a position

        aval, brep, minv, dfac, C = (np.zeros((n, n)) for _ in range(5))
        aval[i, j] = v
        brep[i, j] = a["b"][k]
        # a constraint occupies 2 positions off the diagonal, 1 on it
        offd = i != j
        minv[i, j] = np.where(offd, 0.5, 1.0)
        dfac[i, j] = np.where(offd, 1.0, 0.5)
        C[a["pat_i"], a["pat_j"]] = a["pat_v"]
        return EntrywiseConstraintOp.from_arrays(
            dict(aval=aval, C=C, b=brep, minv=minv, dfac=dfac,
                 ki=np.minimum(i[first], j[first]),
                 kj=np.maximum(i[first], j[first]), m=m, n=n),
            op.device, op.b.dtype)

    @staticmethod
    def from_arrays(a: dict, device, dtype=torch.float64
                    ) -> "EntrywiseConstraintOp":
        """From host arrays aval, C, b, minv, dfac (n, n), ki, kj (m,), m, n
        (the fields of the JAX package's EntrywiseConstraintOp)."""
        m, n = int(a["m"]), int(a["n"])
        val = lambda x: torch.tensor(  # noqa: E731
            np.asarray(x, dtype=np.float64).reshape(n, n), dtype=dtype,
            device=device)
        idx = lambda x: torch.tensor(  # noqa: E731
            np.asarray(x).reshape(m), dtype=torch.int32, device=device)
        return EntrywiseConstraintOp(
            aval=val(a["aval"]), C=val(a["C"]), b=val(a["b"]),
            minv=val(a["minv"]), dfac=val(a["dfac"]), ki=idx(a["ki"]),
            kj=idx(a["kj"]), m=m, n=n)

    @property
    def nnz(self) -> int:
        return self.m

    @property
    def device(self) -> torch.device:
        return self.aval.device

    def astype(self, dtype) -> "EntrywiseConstraintOp":
        """The same operator with its (n, n) float arrays cast to
        ``dtype``; ki / kj are shared."""
        return dataclasses.replace(
            self, **{f: getattr(self, f).to(dtype)
                     for f in ("aval", "C", "b", "minv", "dfac")})

    # -- operator protocol (masked carriers; the rest in _DenseCarrier) ----
    def apply_from_e(self, e):
        return masked_sym(e, self.aval, self.dfac, "apply")

    def adjoint_on_pattern(self, w):
        return masked_sym(w, self.aval, mode="axpy")

    def normal_factored(self, Y, U):
        """adjoint_on_pattern(apply_factored(Y, U)) in one K5 pass."""
        return masked_sym(self.pattern_pair_dots(Y, U), self.aval, self.dfac,
                          "aat")

    def es_vals(self, w, sigma: float):
        return masked_sym(w, self.aval, mode="axpy", C=self.C, alpha=sigma)

    def s_vals(self, y):
        return masked_sym(y, self.aval, mode="axpy", C=self.C, alpha=-1.0)

    # -- residual space (dense (n, n) representatives) ---------------------
    def res_zeros(self):
        return torch.zeros((self.n, self.n), dtype=self.b.dtype,
                           device=self.device)

    def res_from_mvec(self, y):
        y = torch.as_tensor(np.asarray(y, dtype=np.float64).ravel(),
                            dtype=self.b.dtype, device=self.device)
        ki, kj = self.ki.long(), self.kj.long()
        out = self.res_zeros()
        out[ki, kj] = y
        out[kj, ki] = y
        return out

    def res_to_mvec(self, y_dev):
        return y_dev[self.ki.long(), self.kj.long()].cpu().numpy()

    def dot_res(self, u, v):
        return torch.sum(u * v * self.minv)

    def norm_res(self, u):
        return torch.sqrt(self.dot_res(u, u))
