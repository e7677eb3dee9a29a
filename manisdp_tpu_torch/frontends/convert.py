"""Problem-format converters.

Equivalents of the reference's interop utilities:
  - sedumi_to_sdpt3 / sdpt3_to_sedumi: SeDuMi <-> SDPT3 cell format
    with svec scaling (read_sedumi.m, SDPT3data_SEDUMIdata.m);
  - svec / smat: scaled symmetric vectorization (sparsevec.m,
    sparsesvec.m; off-diagonals x sqrt(2));
  - sedumi_to_mosek: structural conversion to a MOSEK-task-shaped dict
    (convert_sedumi2mosek.m) — usable by a MOSEK runtime when present;
  - sedumi_to_copt: COPT-shaped dict (sedumi2copt.m).

All host-side numpy/scipy.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np
import scipy.sparse as sp

from .sedumi import Cone, SedumiData

_SQRT2 = np.sqrt(2.0)


def triangle_number(n):
    """n(n+1)/2 (triangle_number.m)."""
    return (np.asarray(n) * (np.asarray(n) + 1)) // 2


def svec_indices(n: int):
    """(rows, cols) of the lower-triangle traversal used by svec:
    column-major upper triangle j>=i -> position i + j(j+1)/2."""
    ii, jj = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    keep = ii <= jj
    return ii[keep], jj[keep]


def svec(M, n: int) -> np.ndarray:
    """Scaled symmetric vectorization: diag as-is, off-diag * sqrt(2)
    (sparsesvec.m); M may be dense or sparse (n, n)."""
    Md = M.toarray() if sp.issparse(M) else np.asarray(M)
    i, j = svec_indices(n)
    v = Md[i, j].copy()
    v[i != j] *= _SQRT2
    return v


def smat(v: np.ndarray, n: int) -> np.ndarray:
    """Inverse of svec."""
    out = np.zeros((n, n))
    i, j = svec_indices(n)
    vals = np.asarray(v, dtype=np.float64).copy()
    off = i != j
    vals[off] /= _SQRT2
    out[i, j] = vals
    out[j, i] = vals
    return out


def _split_blocks(K: Cone) -> List[int]:
    return [int(K.s)] if np.ndim(K.s) == 0 else [int(x) for x in K.s]


def sedumi_to_sdpt3(data: SedumiData) -> Dict:
    """SeDuMi -> SDPT3: per-block svec-scaled constraint matrices
    (read_sedumi.m).  Free/LP parts become 'u'/'l' blocks.  Constraint
    matrices are symmetrized (read_sedumi warns and symmetrizes;
    read_sedumi.m:150-230)."""
    At = sp.csc_matrix(data.At)
    c = np.asarray(data.c, dtype=np.float64).ravel()
    K = data.K
    m = At.shape[1]
    blk, Ats, Cs = [], [], []
    off = 0
    if K.f:
        blk.append(("u", K.f))
        Ats.append(At[off:off + K.f, :])
        Cs.append(c[off:off + K.f])
        off += K.f
    if K.l:
        blk.append(("l", K.l))
        Ats.append(At[off:off + K.l, :])
        Cs.append(c[off:off + K.l])
        off += K.l
    for nb in _split_blocks(K):
        blk.append(("s", nb))
        i, j = svec_indices(nb)
        rows_block = At[off:off + nb * nb, :].tocsr()
        # svec of each constraint column, symmetrized
        lin_up = i + j * nb
        lin_lo = j + i * nb
        Aup = rows_block[lin_up, :]
        Alo = rows_block[lin_lo, :]
        Asym = 0.5 * (Aup + Alo)
        scale = np.where(i == j, 1.0, _SQRT2)
        Ats.append(sp.diags(scale) @ Asym)
        Cb = c[off:off + nb * nb].reshape(nb, nb, order="F")
        Cs.append(0.5 * (Cb + Cb.T))
        off += nb * nb
    return dict(blk=blk, At=Ats, C=Cs, b=np.asarray(data.b).ravel())


def sdpt3_to_sedumi(blk, At, C, b) -> SedumiData:
    """SDPT3 -> SeDuMi (SDPT3data_SEDUMIdata.m): un-svec each 's'
    block back to full column-major vecs."""
    cols_At, cols_c = [], []
    K = Cone(s=[], f=0, l=0)
    for (typ, nb), Ab, Cb in zip(blk, At, C):
        nb = int(nb)
        if typ == "u":
            K.f += nb
            cols_At.append(sp.csc_matrix(Ab))
            cols_c.append(np.asarray(Cb).ravel())
        elif typ == "l":
            K.l += nb
            cols_At.append(sp.csc_matrix(Ab))
            cols_c.append(np.asarray(Cb).ravel())
        elif typ == "s":
            K.s.append(nb)
            i, j = svec_indices(nb)
            scale = np.where(i == j, 1.0, 1.0 / _SQRT2)
            Asc = (sp.diags(scale) @ sp.csc_matrix(Ab)).tocoo()
            m = Ab.shape[1]
            lin_up = i + j * nb
            lin_lo = j + i * nb
            rows = np.concatenate([lin_up[Asc.row], lin_lo[Asc.row]])
            cols = np.concatenate([Asc.col, Asc.col])
            vals = np.concatenate([Asc.data, Asc.data])
            # diagonal entries appear twice with half weight each
            diag_dup = np.concatenate([i[Asc.row] == j[Asc.row]] * 2)
            vals = np.where(diag_dup, 0.5 * vals, vals)
            full = sp.coo_matrix((vals, (rows, cols)),
                                 shape=(nb * nb, m))
            cols_At.append(full.tocsc())
            cols_c.append(np.asarray(Cb).flatten(order="F"))
        else:
            raise ValueError(f"unknown block type {typ!r}")
    Atf = sp.vstack(cols_At).tocsc()
    cf = np.concatenate(cols_c)
    return SedumiData(At=Atf, b=np.asarray(b).ravel(), c=cf, K=K)


def sedumi_to_mosek(data: SedumiData) -> Dict:
    """Structural MOSEK conversion (convert_sedumi2mosek.m): bara/barc
    triplet arrays over the lower triangle of each PSD block, linear
    part for K.f/K.l.  Returns a plain dict mirroring the MOSEK task
    fields (usable with the mosek python API when installed)."""
    At = sp.csc_matrix(data.At)
    c = np.asarray(data.c, dtype=np.float64).ravel()
    K = data.K
    m = At.shape[1]
    blocks = _split_blocks(K)
    off = K.f + K.l

    barc = dict(subj=[], subk=[], subl=[], val=[])
    bara = dict(subi=[], subj=[], subk=[], subl=[], val=[])
    for bj, nb in enumerate(blocks):
        Cb = c[off:off + nb * nb].reshape(nb, nb, order="F")
        Cb = 0.5 * (Cb + Cb.T)
        kk, ll = np.nonzero(np.tril(Cb))
        barc["subj"] += [bj] * len(kk)
        barc["subk"] += list(kk)
        barc["subl"] += list(ll)
        barc["val"] += list(Cb[kk, ll])
        Ab = At[off:off + nb * nb, :].tocoo()
        ii = Ab.row % nb
        jj = Ab.row // nb
        lower = ii >= jj
        for r, cc, v in zip(
                np.stack([ii[lower], jj[lower]], axis=1),
                Ab.col[lower], Ab.data[lower]):
            bara["subi"].append(int(cc))
            bara["subj"].append(bj)
            bara["subk"].append(int(r[0]))
            bara["subl"].append(int(r[1]))
            bara["val"].append(float(v))
        off += nb * nb
    lin = At[:K.f + K.l, :]
    return dict(
        numcon=m, dim_bars=blocks,
        barc=barc, bara=bara,
        a=sp.csc_matrix(lin.T),
        c_lin=c[:K.f + K.l],
        blc=np.asarray(data.b).ravel(),
        buc=np.asarray(data.b).ravel(),
        num_free=K.f, num_lin=K.l)


def sedumi_to_copt(data: SedumiData) -> Dict:
    """COPT-shaped conversion (sedumi2copt.m): returns the SDP in
    triplet form grouped per block."""
    out = sedumi_to_mosek(data)
    out["format"] = "copt"
    return out


def recover_mosek_sol_blk(res: Dict, K: Cone):
    """Recover (X blocks, y, S blocks, [pobj, dobj]) from a MOSEK-style
    solution dict (src/basicfunction/recover_mosek_sol_blk.m).

    ``res`` follows MOSEK's layout: res["sol"]["itr"] holds "barx" /
    "bars" (stacked per-block LOWER-triangle column-major vectors), "xx"
    (linear/free part), "y", "pobjval", "dobjval".
    """
    itr = res["sol"]["itr"]
    ks = [K.s] if np.isscalar(K.s) else list(K.s)

    def unpack(v, cid, n):
        tril_r, tril_c = np.tril_indices(n)
        M = np.zeros((n, n))
        M[tril_r, tril_c] = np.asarray(v)[cid:cid + triangle_number(n)]
        M = M + M.T
        M[np.arange(n), np.arange(n)] *= 0.5
        return M

    X_blocks, S_blocks = [], []
    if K.f:
        X_blocks.append(np.asarray(itr["xx"], dtype=np.float64).ravel())
    cid = 0
    for n in ks:
        X_blocks.append(unpack(itr["barx"], cid, n))
        S_blocks.append(unpack(itr["bars"], cid, n))
        cid += triangle_number(n)
    y = np.asarray(itr["y"], dtype=np.float64).ravel()
    obj = np.array([itr["pobjval"], itr["dobjval"]], dtype=np.float64)
    return X_blocks, y, S_blocks, obj


def mosek_task_objective(task: Dict, X_blocks, x_lin=None) -> float:
    """<C, X> evaluated from a sedumi_to_mosek task dict — validates
    that the emitted barc/bara triplets reproduce the SeDuMi objective
    (the cross-check the reference gets for free by running MOSEK)."""
    barc = task["barc"]
    val = 0.0
    for bj, kk, ll, v in zip(barc["subj"], barc["subk"], barc["subl"],
                             barc["val"]):
        Xb = X_blocks[bj]
        val += v * Xb[kk, ll] * (1.0 if kk == ll else 2.0)
    if x_lin is not None and len(task["c_lin"]):
        val += float(np.dot(task["c_lin"], x_lin))
    return float(val)


def mosek_task_constraints(task: Dict, X_blocks, x_lin=None) -> np.ndarray:
    """A(X) evaluated from the bara triplets (lower-triangle scaled),
    for validating the emitted task against the SeDuMi constraints."""
    bara = task["bara"]
    out = np.zeros(task["numcon"])
    for ci, bj, kk, ll, v in zip(bara["subi"], bara["subj"],
                                 bara["subk"], bara["subl"],
                                 bara["val"]):
        Xb = X_blocks[bj]
        out[ci] += v * Xb[kk, ll] * (1.0 if kk == ll else 2.0)
    if x_lin is not None and task["a"].shape[1]:
        out += np.asarray(task["a"] @ x_lin).ravel()
    return out
