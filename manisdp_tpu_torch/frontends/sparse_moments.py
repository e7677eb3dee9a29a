"""Clique-sparse (term-sparsity) moment/SOS relaxation generators.

Equivalents of src/basicfunction/{bqpmom_sparse,bqpsos_sparse}.m: the
POP objective decomposes over variable cliques I_1..I_t; each clique
gets its own moment block (unit-diagonal), and repeated monomials tie
blocks together through shared label classes.  Output is multiblock
SeDuMi data for solve_multiblock / solve_dual_multiblock with
K.nob = t (example/example_bqp_sparse.m:21-31).

Label ordering is plain lexicographic over exponent rows (MATLAB
unique/sortrows; nbfind/ncomp), which also fixes the coefficient
ordering of the objective ``coe``.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import scipy.sparse as sp

from .monomials import monomial_basis
from .sedumi import Cone, SedumiData


def clique_chain(t: int, q: int):
    """The example's chain cliques: t cliques of size q overlapping by 2
    (example_bqp_sparse.m:5-9). Returns (n, cliques 0-based)."""
    n = q + (q - 2) * (t - 1)
    return n, [list(range((q - 2) * i, (q - 2) * i + q)) for i in range(t)]


def _clique_basis(n: int, clique: Sequence[int], d: int, max_power: int,
                  drop_all_even: bool) -> np.ndarray:
    """Graded basis over a subset of variables, embedded in n vars."""
    sub = monomial_basis(len(clique), d, max_power=max_power,
                        drop_all_even=drop_all_even)
    out = np.zeros((n, sub.shape[1]), dtype=np.int64)
    out[np.asarray(clique)] = sub
    return out


def sparse_objective_basis(n: int, cliques) -> np.ndarray:
    """The label set indexing ``coe``: union of squarefree deg<=2
    monomials over all cliques, lexicographically sorted rows,
    INCLUDING the constant (example_bqp_sparse.m:10-18)."""
    cols = []
    for I in cliques:
        cols.append(_clique_basis(n, I, 2, 1, False))
    allb = np.concatenate(cols, axis=1).T
    return np.unique(allb, axis=0).T


def bqpsos_sparse(n: int, cliques, coe: np.ndarray):
    """Sparse SOS relaxation of the clique BQP (bqpsos_sparse.m).

    ``coe`` indexes the deg<=2 squarefree label set of
    ``sparse_objective_basis`` (constant dropped); it is expanded into
    the full squarefree deg<=4 label vector b the way
    example_bqp_sparse.m:36-48 does.  Returns (A, b, c, mbs, f, dAAt)
    for solve_dual_multiblock with nob = t.
    """
    coe = np.asarray(coe, dtype=np.float64).ravel()
    t = len(cliques)
    cliques = [list(map(int, I)) for I in cliques]
    bases, label_cols = [], []
    for I in cliques:
        bases.append(_clique_basis(n, I, 2, 1, False))
        label_cols.append(_clique_basis(n, I, 4, 1, False))
    mb = np.array([bb.shape[1] for bb in bases])
    spm = np.unique(np.concatenate(label_cols, axis=1).T, axis=0).T
    lsp = spm.shape[1]
    spidx = {tuple(spm[:, i]): i for i in range(lsp)}

    ss = np.concatenate([[0], np.cumsum(mb ** 2)]) + 1  # +1: free column
    rows, cols, vals = [0], [0], [1.0]
    dAAt = np.zeros(lsp)
    dAAt[0] = mb.sum()
    for k in range(t):
        bk = bases[k]
        for i in range(mb[k]):
            rows.append(0)
            cols.append(int(ss[k] + i * mb[k] + i))
            vals.append(1.0)
        for i in range(mb[k]):
            for j in range(i + 1, mb[k]):
                lab = spidx[tuple((bk[:, i] + bk[:, j]) % 2)]
                rows += [lab, lab]
                cols += [int(ss[k] + i * mb[k] + j),
                         int(ss[k] + j * mb[k] + i)]
                vals += [1.0, 1.0]
                dAAt[lab] += 2.0
    nz = int((mb ** 2).sum()) + 1
    A = sp.coo_matrix((vals, (rows, cols)), shape=(lsp, nz)).tocsr()

    # expand objective into the label vector (example_bqp_sparse.m:44-47)
    b = np.zeros(lsp)
    deg = spm.sum(axis=0)
    obj_slots = np.nonzero((deg <= 2) & (deg > 0))[0]
    assert coe.shape[0] == len(obj_slots), (coe.shape, len(obj_slots))
    b[obj_slots] = coe
    c = np.zeros(nz)
    c[0] = 1.0
    return A, b, c, [int(x) for x in mb], 1, dAAt


def sparse_quartic_basis(n: int, cliques) -> np.ndarray:
    """Full deg<=4 label union over cliques, lexicographic rows —
    indexes ``coe`` for the sparse quartic programs
    (example_qsphere_sparse.m:8-14)."""
    cols = [_clique_basis(n, I, 4, None, False) for I in cliques]
    return np.unique(np.concatenate(cols, axis=1).T, axis=0).T


def qsmom_sparse(n: int, cliques, coe: np.ndarray) -> SedumiData:
    """Sparse moment relaxation of
    min sum_k coe_k'[x_{I_k}]_4 s.t. ||x_{I_k}||^2 = 1 (qsmom_sparse.m)."""
    coe = np.asarray(coe, dtype=np.float64).ravel()
    t = len(cliques)
    cliques = [list(map(int, I)) for I in cliques]
    bases = [_clique_basis(n, I, 2, None, False) for I in cliques]
    mb = np.array([bb.shape[1] for bb in bases])
    spm = sparse_quartic_basis(n, cliques)
    lsp = spm.shape[1]
    spidx = {tuple(spm[:, i]): i for i in range(lsp)}
    assert coe.shape[0] == lsp

    ss = np.concatenate([[0], np.cumsum(mb ** 2)])

    def ent(k, r, c):
        return int(ss[k] + c * mb[k] + r)

    mm = [[] for _ in range(lsp)]
    for k in range(t):
        bk = bases[k]
        for i in range(mb[k]):
            for j in range(i, mb[k]):
                lab = spidx[tuple(bk[:, i] + bk[:, j])]
                mm[lab].append((i, j, k))
    loa = [np.array([[ent(k, i, j), ent(k, j, i)] for (i, j, k) in pairs],
                    dtype=np.int64).ravel() for pairs in mm]

    def class_entries(lab):
        ent_idx = []
        for jj, (a, b_, k) in enumerate(mm[lab]):
            if a == b_:
                ent_idx.append(loa[lab][2 * jj + 1])
            else:
                ent_idx += [loa[lab][2 * jj], loa[lab][2 * jj + 1]]
        return ent_idx, len(ent_idx)

    rows, cols, vals = [0], [0], [1.0]
    l = 1
    # per-clique sphere localization (qsmom_sparse.m:43-77)
    for k in range(t):
        bk = bases[k]
        for i in range(mb[k]):
            for v in cliques[k]:
                ek2 = np.zeros(n, dtype=np.int64)
                ek2[v] = 2
                idxs, s1 = class_entries(spidx[tuple(bk[:, i] + ek2)])
                rows += idxs
                cols += [l] * s1
                vals += [1.0 / s1] * s1
            idxs, s2 = class_entries(spidx[tuple(bk[:, i])])
            rows += idxs
            cols += [l] * s2
            vals += [-1.0 / s2] * s2
            l += 1
    # repeated-position equality (:79-105)
    for lab in range(lsp):
        firsts = [pq[0] for pq in mm[lab]]
        idx = int(np.argmax(firsts))
        for j in range(len(mm[lab])):
            if j == idx:
                continue
            for which, sign in ((idx, 1.0), (j, -1.0)):
                a, b_, k = mm[lab][which]
                if a == b_:
                    rows += [loa[lab][2 * which + 1]]
                    cols += [l]
                    vals += [sign]
                else:
                    rows += [loa[lab][2 * which], loa[lab][2 * which + 1]]
                    cols += [l, l]
                    vals += [0.5 * sign, 0.5 * sign]
            l += 1

    ncons = int((mb * (mb + 1) // 2).sum() - lsp + mb.sum() + 1)
    assert l == ncons, (l, ncons)
    At = sp.coo_matrix((vals, (rows, cols)),
                       shape=(int((mb ** 2).sum()), ncons)).tocsc()
    b = np.zeros(ncons)
    b[0] = 1.0

    c = np.zeros(int((mb ** 2).sum()))
    for lab in range(lsp):
        idxs, s = class_entries(lab)
        if s:
            c[idxs] = coe[lab] / s
    return SedumiData(At=At, b=b, c=c,
                      K=Cone(s=[int(x) for x in mb], nob=0))


def qssos_sparse(n: int, cliques, coe: np.ndarray):
    """Sparse SOS relaxation of the clique quartic-sphere program
    (qssos_sparse.m).  Returns (A, b, c, mbs, f, dAAt) for
    solve_dual_multiblock with nob=0."""
    coe = np.asarray(coe, dtype=np.float64).ravel()
    t = len(cliques)
    cliques = [list(map(int, I)) for I in cliques]
    bases = [_clique_basis(n, I, 2, None, False) for I in cliques]
    mb = np.array([bb.shape[1] for bb in bases])
    cql = np.array([len(I) for I in cliques])
    spm = sparse_quartic_basis(n, cliques)
    lsp = spm.shape[1]
    spidx = {tuple(spm[:, i]): i for i in range(lsp)}
    assert coe.shape[0] == lsp

    f = int(mb.sum()) + 1
    ssb = np.concatenate([[0], np.cumsum(mb)]) + 1      # free offsets
    ssp = np.concatenate([[0], np.cumsum(mb ** 2)]) + f  # psd offsets
    rows, cols, vals = [0], [0], [1.0]
    dAAt = np.zeros(lsp)
    for k in range(t):
        bk = bases[k]
        for i in range(mb[k]):
            for j in range(cql[k] + 1):
                temp = np.zeros(n, dtype=np.int64)
                v = 1.0
                if j < cql[k]:
                    temp[cliques[k][j]] = 2
                else:
                    v = -1.0
                rows.append(spidx[tuple(bk[:, i] + temp)])
                cols.append(int(ssb[k] + i))
                vals.append(v)
    for k in range(t):
        bk = bases[k]
        for i in range(mb[k]):
            for j in range(i, mb[k]):
                lab = spidx[tuple(bk[:, i] + bk[:, j])]
                rows.append(lab)
                cols.append(int(ssp[k] + i * mb[k] + j))
                vals.append(1.0)
                if j > i:
                    rows.append(lab)
                    cols.append(int(ssp[k] + j * mb[k] + i))
                    vals.append(1.0)
                    dAAt[lab] += 2.0
                else:
                    dAAt[lab] += 1.0
    nvar = f + int((mb ** 2).sum())
    A = sp.coo_matrix((vals, (rows, cols)), shape=(lsp, nvar)).tocsr()
    b = coe.copy()
    c = np.zeros(nvar)
    c[0] = 1.0
    return A, b, c, [int(x) for x in mb], f, dAAt


def bqpmom_sparse(n: int, cliques, coe: np.ndarray) -> SedumiData:
    """Sparse moment relaxation of
    min sum_k coe_k' [x_{I_k}]_2  s.t. x_i^2 = 1  (bqpmom_sparse.m)."""
    coe = np.asarray(coe, dtype=np.float64).ravel()
    t = len(cliques)
    cliques = [list(map(int, I)) for I in cliques]
    bases: List[np.ndarray] = []
    label_cols = []
    for I in cliques:
        bases.append(_clique_basis(n, I, 2, 1, False))
        label_cols.append(_clique_basis(n, I, 4, 2, True))
    mb = np.array([bb.shape[1] for bb in bases])
    mc = np.array([len(I) for I in cliques])
    spm = np.unique(np.concatenate(label_cols, axis=1).T, axis=0).T
    lsp = spm.shape[1]
    spidx = {tuple(spm[:, i]): i for i in range(lsp)}

    ss = np.concatenate([[0], np.cumsum(mb ** 2)])

    def ent(k, r, c):
        return int(ss[k] + c * mb[k] + r)

    # mm[label] = list of (i, j, k): pair positions within block k
    mm = [[] for _ in range(lsp)]
    for k in range(t):
        bk = bases[k]
        for i in range(mb[k]):
            for j in range(i + 1, mb[k]):
                lab = spidx[tuple(bk[:, i] + bk[:, j])]
                mm[lab].append((i, j, k))
    loa = [np.array([[ent(k, i, j), ent(k, j, i)] for (i, j, k) in pairs],
                    dtype=np.int64).ravel() for pairs in mm]

    rows, cols, vals = [0], [0], [1.0]
    l = 1
    # diag ties to block-1 (0,0) (bqpmom_sparse.m:52-66)
    for k in range(t):
        start = 1 if k == 0 else 0
        for i in range(start, mc[k] + 1):
            rows += [0, ent(k, i, i)]
            cols += [l, l]
            vals += [0.5, -0.5]
            l += 1
    # pair-monomial diag ties within blocks (:68-79)
    for k in range(t):
        bk = bases[k]
        for i in range(mc[k] + 1, mb[k]):
            sup = np.nonzero(bk[:, i] == 1)[0]
            cc = [cliques[k].index(int(v)) + 1 for v in sup]
            for pos in cc:
                rows += [ent(k, pos, pos), ent(k, i, i)]
                cols += [l, l]
                vals += [0.5, -0.5]
                l += 1
    # substitution x_v^2 = 1 per clique (:88-107)
    for k in range(t):
        bk = bases[k]
        for v in cliques[k]:
            for i in range(1, mb[k]):
                if bk[v, i] != 0:
                    continue
                bi = bk[:, i].copy()
                bi[v] = 2
                l1 = loa[spidx[tuple(bi)]]
                l2 = loa[spidx[tuple(bk[:, i])]]
                rows += list(l1) + list(l2)
                cols += [l] * (len(l1) + len(l2))
                if len(l1) < len(l2):
                    vals += [1.0] * len(l1) + [-len(l1) / len(l2)] * len(l2)
                else:
                    vals += [len(l2) / len(l1)] * len(l1) + [-1.0] * len(l2)
                l += 1
    # cross-block label-class equality (:110-121)
    for lab in range(lsp):
        firsts = [p[0] for p in mm[lab]]
        idx = int(np.argmax(firsts))
        for j in range(len(mm[lab])):
            if j == idx:
                continue
            rows += [loa[lab][2 * idx], loa[lab][2 * idx + 1],
                     loa[lab][2 * j], loa[lab][2 * j + 1]]
            cols += [l] * 4
            vals += [0.5, 0.5, -0.5, -0.5]
            l += 1

    ncons = int((mb * (mb + 1) // 2).sum() - lsp + (mc * (mb - 1)).sum()
                - mb.sum() + t)
    assert l == ncons, (l, ncons)
    At = sp.coo_matrix((vals, (rows, cols)),
                       shape=(int((mb ** 2).sum()), ncons)).tocsc()
    b = np.zeros(ncons)
    b[0] = 1.0

    # objective: coe over deg<=2 squarefree labels (:124-137)
    nsp = sparse_objective_basis(n, cliques)
    # drop the constant column (all-zero exponents)
    keep = ~np.all(nsp == 0, axis=0)
    nsp = nsp[:, keep]
    assert coe.shape[0] == nsp.shape[1], (coe.shape, nsp.shape)
    c = np.zeros(int((mb ** 2).sum()))
    for i in range(nsp.shape[1]):
        lab = spidx[tuple(nsp[:, i])]
        c[loa[lab]] = coe[i] / len(loa[lab])
    return SedumiData(At=At, b=b, c=c,
                      K=Cone(s=[int(x) for x in mb], nob=t))
