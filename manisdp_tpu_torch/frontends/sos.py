"""Order-2 SOS relaxation generators (dual form, SeDuMi output).

Equivalents of:
  - ``bqpsos`` (src/basicfunction/bqpsos.m): SOS dual of the binary
    quadratic program — feeds solve_dual_unitdiag with a single free
    variable prepended (reference README.md:261-271);
  - ``qssos``  (src/basicfunction/qssos.m): SOS dual of the quartic
    sphere program with mb+1 free variables (lower bound + sphere
    multiplier) — feeds solve_dual_sdp.

Both emit a constraint matrix A whose PSD block satisfies the
diagonal-AA' invariant the dual drivers' closed-form y-step needs, and
return dAAt in closed form (bqpsos.m:17-31).
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from .monomials import basis_index, monomial_basis


def _ent(r, c, mb):
    return c * mb + r


def bqpsos(Q: np.ndarray, e: np.ndarray, n: int):
    """Returns (A, b, dAAt, mb): A (lsp, mb^2), labels are squarefree
    monomials of degree <= 4 with products reduced mod x_i^2 = 1.

    Vectorized via support bitmasks: squarefree monomials are subsets
    of {1..n}, and the mod-2 product is the XOR of the masks, so the
    O(mb^2) pair labels come from one outer XOR + searchsorted instead
    of per-pair dict lookups (63 s -> ~1 s host time at q = 60).
    """
    assert n <= 62, "bitmask encoding supports n <= 62"
    Q = np.asarray(Q, dtype=np.float64)
    e = np.asarray(e, dtype=np.float64).ravel()
    sp4 = monomial_basis(n, 4, max_power=1)
    lsp = sp4.shape[1]
    mb = 1 + n + n * (n - 1) // 2      # squarefree deg<=2 prefix of sp4

    pow2 = (1 << np.arange(n, dtype=np.uint64))
    masks4 = (sp4.astype(np.uint64).T * pow2).sum(axis=1)   # (lsp,)
    order4 = np.argsort(masks4, kind="stable")
    sorted4 = masks4[order4]

    iu, ju = np.triu_indices(mb, k=1)
    xormask = np.bitwise_xor(masks4[iu], masks4[ju])
    locb = order4[np.searchsorted(sorted4, xormask)]

    diag_cols = np.arange(mb) * (mb + 1)
    rows = np.concatenate([np.zeros(mb, dtype=np.int64), locb, locb])
    cols = np.concatenate([diag_cols,
                           _ent(ju, iu, mb), _ent(iu, ju, mb)])
    vals = np.ones(rows.shape[0])
    dAAt = np.bincount(locb, minlength=lsp).astype(np.float64) * 2.0
    dAAt[0] += mb
    A = sp.coo_matrix((vals, (rows, cols)), shape=(lsp, mb * mb)).tocsr()

    b = np.zeros(lsp)
    b[0] = np.trace(Q)
    b[1:n + 1] = e
    iu, ju = np.triu_indices(n, k=1)    # row-major (i<j) pairs
    order = np.lexsort((iu, ju))        # column-major order to match labels
    b[n + 1:n + 1 + len(iu)] = 2.0 * Q[iu[order], ju[order]]
    return A, b, dAAt, mb


def assemble_bqpsos(Q, e, n: int):
    """Prepend the free lower-bound variable (README.md:261-271):
    returns (A_full, b, c, mb, f=1, dAAt) ready for solve_dual_unitdiag.
    """
    A, b, dAAt, mb = bqpsos(Q, e, n)
    v = sp.coo_matrix(([1.0], ([0], [0])), shape=(A.shape[0], 1))
    A_full = sp.hstack([v, A]).tocsr()
    c = np.zeros(1 + mb * mb)
    c[0] = 1.0
    return A_full, b, c, mb, 1, dAAt


def qssos(n: int, coe: np.ndarray):
    """Returns (A, b, c, mb, f, dAAt): A (lsp, f + mb^2) with
    f = mb + 1 free variables (lower bound + sphere-multiplier SOS
    coefficients), b = coe (qssos.m)."""
    coe = np.asarray(coe, dtype=np.float64).ravel()
    sp2 = monomial_basis(n, 2)
    sp4 = monomial_basis(n, 4)
    mb = sp2.shape[1]
    lsp = sp4.shape[1]
    spidx = basis_index(sp4)
    assert coe.shape[0] == lsp
    f = mb + 1

    rows, cols, vals = [0], [0], [1.0]
    # multiplier block: lambda_i * (x_j^2 ... - 1) (qssos.m:19-33)
    for i in range(mb):
        for j in range(n + 1):
            temp = np.zeros(n, dtype=np.int64)
            val = 1.0
            if j < n:
                temp[j] = 2
            else:
                val = -1.0
            locb = spidx[tuple(sp2[:, i] + temp)]
            rows.append(locb)
            cols.append(i + 1)
            vals.append(val)
    dAAt = np.zeros(lsp)
    # PSD block (qssos.m:35-52)
    for i in range(mb):
        for j in range(i, mb):
            locb = spidx[tuple(sp2[:, i] + sp2[:, j])]
            rows.append(locb)
            cols.append(f + _ent(j, i, mb))
            vals.append(1.0)
            if j > i:
                rows.append(locb)
                cols.append(f + _ent(i, j, mb))
                vals.append(1.0)
                dAAt[locb] += 2.0
            else:
                dAAt[locb] += 1.0
    A = sp.coo_matrix((vals, (rows, cols)),
                      shape=(lsp, f + mb * mb)).tocsr()
    b = coe.copy()
    c = np.zeros(f + mb * mb)
    c[0] = 1.0
    return A, b, c, mb, f, dAAt
