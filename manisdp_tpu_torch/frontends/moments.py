"""Order-2 moment relaxation generators (SeDuMi output).

Equivalents of the reference front-ends:
  - ``bqpmom``  (src/basicfunction/bqpmom.m): moment SDP of the binary
    quadratic program  min x'Qx + e'x  s.t. x_i^2 = 1 — feeds the
    unit-diagonal driver;
  - ``qsmom``   (src/basicfunction/qsmom.m): moment SDP of the quartic
    sphere program  min coe'[x]_4  s.t. ||x||^2 = 1 — feeds the
    unit-trace driver.

Both build the same constraint classes as the reference so the emitted
SDP data (constraint count, sparsity, conditioning) matches the
benchmark suite: an anchor y_1 = 1, structural consistency constraints
between repeated monomial positions, and substitution constraints from
the equality constraint of the POP (x_i^2 = 1 resp. sum x_i^2 = 1).
Host-side numpy/scipy; runs once per problem.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from .monomials import basis_index, monomial_basis
from .sedumi import Cone, SedumiData


def _ent(r, c, mb):
    """0-based column-major flat index into vec(X), X mb-by-mb."""
    return c * mb + r


def bqpmom(n: int, Q: np.ndarray, e: np.ndarray) -> SedumiData:
    """Moment relaxation of min x'Qx + e'x s.t. x_i^2 = 1."""
    Q = np.asarray(Q, dtype=np.float64)
    e = np.asarray(e, dtype=np.float64).ravel()
    basis = monomial_basis(n, 2, max_power=1)
    mb = basis.shape[1]
    spm = monomial_basis(n, 4, max_power=2, drop_all_even=True)
    lsp = spm.shape[1]
    spidx = basis_index(spm)

    # mm[t]: list of basis-index pairs (i<j) whose exponent sum is label t
    mm = [[] for _ in range(lsp)]
    for i in range(mb):
        for j in range(i + 1, mb):
            t = spidx[tuple(basis[:, i] + basis[:, j])]
            mm[t].append((i, j))
    loa = [np.array([[_ent(i, j, mb), _ent(j, i, mb)] for (i, j) in pairs],
                    dtype=np.int64).ravel() for pairs in mm]

    rows, cols, vals = [0], [0], [1.0]
    l = 1
    # X[0,0] = X[i,i] consistency for each variable (bqpmom.m:39-43)
    for i in range(1, n + 1):
        rows += [_ent(0, 0, mb), _ent(i, i, mb)]
        cols += [l, l]
        vals += [0.5, -0.5]
        l += 1
    # X[a,a] = X[ib,ib] = X[b,b] for pair monomials (bqpmom.m:45-52)
    for ib in range(n + 1, mb):
        a, b_ = (np.nonzero(basis[:, ib] == 1)[0] + 1)
        for pos in (a, b_):
            rows += [_ent(pos, pos, mb), _ent(ib, ib, mb)]
            cols += [l, l]
            vals += [0.5, -0.5]
            l += 1
    # substitution x_k^2 = 1: mean of entries labeled a+2e_k equals mean
    # of entries labeled a (bqpmom.m:60-78)
    for k in range(n):
        ek2 = np.zeros(n, dtype=np.int64)
        ek2[k] = 2
        for ib in range(1, mb):
            if basis[k, ib] != 0:
                continue
            t1 = spidx[tuple(basis[:, ib] + ek2)]
            t2 = spidx[tuple(basis[:, ib])]
            l1, l2 = loa[t1], loa[t2]
            rows += list(l1) + list(l2)
            cols += [l] * (len(l1) + len(l2))
            if len(l1) < len(l2):
                vals += [1.0] * len(l1) + [-len(l1) / len(l2)] * len(l2)
            else:
                vals += [len(l2) / len(l1)] * len(l1) + [-1.0] * len(l2)
            l += 1
    # equality of repeated monomial positions within a label class
    # (bqpmom.m:80-90)
    for t in range(lsp):
        firsts = [p[0] for p in mm[t]]
        idx = int(np.argmax(firsts))
        for j in range(len(mm[t])):
            if j == idx:
                continue
            rows += [loa[t][2 * idx], loa[t][2 * idx + 1],
                     loa[t][2 * j], loa[t][2 * j + 1]]
            cols += [l] * 4
            vals += [0.5, 0.5, -0.5, -0.5]
            l += 1

    ncons = mb * (mb + 1) // 2 - lsp + n * (mb - 1) - mb + 1
    assert l == ncons, (l, ncons)
    At = sp.coo_matrix((vals, (rows, cols)), shape=(mb * mb, ncons)).tocsc()
    b = np.zeros(ncons)
    b[0] = 1.0

    # cost matrix (bqpmom.m:93-114)
    crow, ccol, cval = [], [], []
    for i in range(n):
        crow.append(i + 1)
        ccol.append(i + 1)
        cval.append(Q[i, i])
    for i in range(n):          # linear terms: label of x_{i+1} is index i
        sz = len(mm[i])
        for (a, b_) in mm[i]:
            crow += [a, b_]
            ccol += [b_, a]
            cval += [e[i] / (2 * sz)] * 2
    ind = n
    for i in range(1, n):
        for j in range(i):
            sz = len(mm[ind])
            for (a, b_) in mm[ind]:
                crow += [a, b_]
                ccol += [b_, a]
                cval += [Q[j, i] / sz] * 2
            ind += 1
    C = sp.coo_matrix((cval, (crow, ccol)), shape=(mb, mb))
    c = np.asarray(C.todense()).flatten(order="F")
    return SedumiData(At=At, b=b, c=c, K=Cone(s=mb))


def qsmom(n: int, coe: np.ndarray) -> SedumiData:
    """Moment relaxation of min coe'[x]_4 s.t. ||x||^2 = 1."""
    coe = np.asarray(coe, dtype=np.float64).ravel()
    basis = monomial_basis(n, 2)
    mb = basis.shape[1]
    spm = monomial_basis(n, 4)
    lsp = spm.shape[1]
    spidx = basis_index(spm)
    assert coe.shape[0] == lsp

    mm = [[] for _ in range(lsp)]
    for i in range(mb):
        for j in range(i, mb):
            t = spidx[tuple(basis[:, i] + basis[:, j])]
            mm[t].append((i, j))
    loa = [np.array([[_ent(i, j, mb), _ent(j, i, mb)] for (i, j) in pairs],
                    dtype=np.int64).ravel() for pairs in mm]

    rows, cols, vals = [0], [0], [1.0]
    l = 1

    def class_entries(t):
        """(entry_indices, count) honoring diagonal pairs (qsmom.m:33-57)."""
        ent_idx = []
        for jj, (a, b_) in enumerate(mm[t]):
            if a == b_:
                ent_idx.append(loa[t][2 * jj + 1])
            else:
                ent_idx += [loa[t][2 * jj], loa[t][2 * jj + 1]]
        return ent_idx, len(ent_idx)

    # localization of sum_k x_k^2 = 1 at each basis monomial
    # (qsmom.m:36-63): sum_k y_{a+2e_k} = y_a
    for i in range(mb):
        for k in range(n):
            ek2 = np.zeros(n, dtype=np.int64)
            ek2[k] = 2
            t1 = spidx[tuple(basis[:, i] + ek2)]
            idxs, s1 = class_entries(t1)
            rows += idxs
            cols += [l] * s1
            vals += [1.0 / s1] * s1
        t2 = spidx[tuple(basis[:, i])]
        idxs, s2 = class_entries(t2)
        rows += idxs
        cols += [l] * s2
        vals += [-1.0 / s2] * s2
        l += 1
    # repeated-position equality within a label class (qsmom.m:66-92)
    for t in range(lsp):
        firsts = [p[0] for p in mm[t]]
        idx = int(np.argmax(firsts))
        for j in range(len(mm[t])):
            if j == idx:
                continue
            for which, sign in ((idx, 1.0), (j, -1.0)):
                a, b_ = mm[t][which]
                if a == b_:
                    rows += [loa[t][2 * which + 1]]
                    cols += [l]
                    vals += [sign]
                else:
                    rows += [loa[t][2 * which], loa[t][2 * which + 1]]
                    cols += [l, l]
                    vals += [0.5 * sign, 0.5 * sign]
            l += 1

    ncons = mb * (mb + 1) // 2 - lsp + mb + 1
    assert l == ncons, (l, ncons)
    At = sp.coo_matrix((vals, (rows, cols)), shape=(mb * mb, ncons)).tocsc()
    b = np.zeros(ncons)
    b[0] = 1.0

    # cost (qsmom.m:97-113)
    crow, ccol, cval = [], [], []
    for t in range(lsp):
        s = sum(1 if a == b_ else 2 for (a, b_) in mm[t])
        for (a, b_) in mm[t]:
            if a == b_:
                crow.append(a)
                ccol.append(b_)
                cval.append(coe[t] / s)
            else:
                crow += [a, b_]
                ccol += [b_, a]
                cval += [coe[t] / s] * 2
    C = sp.coo_matrix((cval, (crow, ccol)), shape=(mb, mb))
    c = np.asarray(C.todense()).flatten(order="F")
    return SedumiData(At=At, b=b, c=c, K=Cone(s=mb))
