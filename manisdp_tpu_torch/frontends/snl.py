"""Sensor-network localization: clique-sparse second-order moment SDP.

Capability equivalent of src/basicfunction/snl_mom_sparse.m:1-87 and the
problem construction of example/Sensor_Network_Localization.m, without
the SPOTLESS msspoly dependency (polynomials are Poly dicts, see
frontends/lasserre.py).

``sparse_moment_relax`` is the generic machinery: an order-2 moment
matrix per variable clique, entries of equal monomials chained equal
across blocks, the constant monomial anchored to 1, and the objective
spread uniformly over each monomial's representative entries — exactly
the reference's construction.  With one clique covering all variables it
reduces to the dense order-2 relaxation.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import scipy.sparse as sp

from .lasserre import Poly
from .monomials import monomial_basis
from .sedumi import Cone, SedumiData


def sparse_moment_relax(objective: Poly, n: int,
                        cliques: Sequence[Sequence[int]]) -> SedumiData:
    """Order-2 clique-sparse moment relaxation of min f(x)
    (snl_mom_sparse.m).  Returns multiblock SeDuMi data with
    K.s = [mb_1, ..., mb_t]; solve with solve_multiblock(nob=0), or
    solve_sdp for a single clique."""
    cliques = [np.asarray(sorted(cl), dtype=np.int64) for cl in cliques]
    t = len(cliques)

    # per-clique degree<=2 bases, embedded in the full exponent space
    bases: List[np.ndarray] = []
    for cl in cliques:
        loc = monomial_basis(len(cl), 2)             # (|cl|, mb_k)
        full = np.zeros((n, loc.shape[1]), dtype=np.int64)
        full[cl, :] = loc
        bases.append(full)
    mbs = [B.shape[1] for B in bases]
    off2 = np.concatenate([[0], np.cumsum(np.square(mbs))]).astype(int)

    # group moment-matrix positions by monomial (upper triangle per block)
    groups: Dict[Tuple[int, ...], List[Tuple[int, int, int]]] = {}
    for k, B in enumerate(bases):
        mb = mbs[k]
        for i in range(mb):
            for j in range(i, mb):
                key = tuple(B[:, i] + B[:, j])
                groups.setdefault(key, []).append((i, j, k))

    def lin_entries(i, j, k):
        """Column-major linear indices of the symmetrized (i, j) entry
        of block k, with weights."""
        base = off2[k]
        mb = mbs[k]
        if i == j:
            return [base + j * mb + i], [1.0]
        return ([base + j * mb + i, base + i * mb + j], [0.5, 0.5])

    rows: List[int] = [0]
    cols: List[int] = [0]
    vals: List[float] = [1.0]        # anchor: X_1[0, 0] = 1
    l = 1
    for key, ents in groups.items():
        if len(ents) == 1:
            continue
        rep = ents[0]
        ri, rw = lin_entries(*rep)
        for ent in ents[1:]:
            ei, ew = lin_entries(*ent)
            rows += ri + ei
            cols += [l] * (len(ri) + len(ei))
            vals += rw + [-w for w in ew]
            l += 1
    m = l
    b = np.zeros(m)
    b[0] = 1.0
    At = sp.coo_matrix((vals, (rows, cols)),
                       shape=(off2[-1], m)).tocsc()

    # objective: spread each coefficient uniformly over the monomial's
    # entries (snl_mom_sparse.m:73-86)
    c = np.zeros(off2[-1])
    for key, cv in objective.items():
        ents = groups.get(tuple(key))
        if ents is None:
            raise ValueError(
                f"objective monomial {key} not covered by any clique")
        lin_all: List[int] = []
        w_all: List[float] = []
        for ent in ents:
            li, lw = lin_entries(*ent)
            lin_all += li
            w_all += lw
        # the reference assigns coe/len(ss) to each of the ss entries,
        # where off-diagonal monomial instances contribute TWO entries
        share = float(cv) / len(lin_all)
        for li, lw in zip(lin_all, w_all):
            # lw=0.5 entries come in symmetric pairs summing to 1
            c[li] += share
    return SedumiData(At=At, b=b, c=c, K=Cone(s=list(mbs)))


def snl_problem(n_sensors: int, seed: int = 1, dim: int = 2,
                radius2: float = 0.5, noise: float = 0.0,
                anchors: np.ndarray = None):
    """The reference's planted SNL instance
    (example/Sensor_Network_Localization.m:1-27): sensors uniform in the
    unit square, squared-distance residuals to in-range neighbor pairs
    and sensor-anchor pairs.  Returns (objective Poly, nvar, positions).

    The objective is a sum of SQUARED residuals that vanishes at the
    planted positions, so for noise=0 the SDP relaxation value is
    exactly 0 (sandwiched between 0 and f(planted) = 0) — a free
    external oracle."""
    rs = np.random.RandomState(seed)
    loc = rs.rand(dim, n_sensors)
    if anchors is None:
        anchors = np.array([[0.25, 0.75, 0.3, 0.8],
                            [0.75, 0.25, 0.8, 0.3]])[:dim]
    nvar = dim * n_sensors

    def var(i, k):
        # variable x_{i + k*n_sensors}: coordinate k of sensor i
        e = np.zeros(nvar, dtype=np.int64)
        e[i + k * n_sensors] = 1
        return e

    obj: Poly = {}

    def add_poly(p: Poly, scale=1.0):
        for e, cv in p.items():
            obj[e] = obj.get(e, 0.0) + scale * cv

    def residual_sq(terms):
        """terms: list of (exponent, coeff); adds (sum terms)^2."""
        acc: Poly = {}
        for e1, c1 in terms:
            for e2, c2 in terms:
                key = tuple(np.asarray(e1) + np.asarray(e2))
                acc[key] = acc.get(key, 0.0) + c1 * c2
        add_poly(acc)

    zero = tuple(np.zeros(nvar, dtype=np.int64))
    # sensor-sensor pairs within range
    for i in range(n_sensors - 1):
        for j in range(i + 1, n_sensors):
            d2 = float(np.sum((loc[:, i] - loc[:, j]) ** 2))
            if d2 <= radius2:
                d2n = d2 + noise * rs.randn()
                terms = []
                for k in range(dim):
                    terms += [(var(i, k) * 2, 1.0), (var(j, k) * 2, 1.0),
                              (tuple(var(i, k) + var(j, k)), -2.0)]
                terms.append((zero, -d2n))
                terms = [(tuple(np.asarray(e)), cv) for e, cv in terms]
                residual_sq(terms)
    # last sensor to anchors (the reference's Bset)
    i = n_sensors - 1
    for a_idx in range(anchors.shape[1]):
        a = anchors[:, a_idx]
        d2 = float(np.sum((loc[:, i] - a) ** 2))
        if d2 <= radius2:
            d2n = d2 + noise * rs.randn()
            terms = []
            for k in range(dim):
                terms += [(tuple(var(i, k) * 2), 1.0),
                          (tuple(var(i, k)), -2.0 * a[k])]
            terms.append((zero, float(a @ a) - d2n))
            residual_sq(terms)
    return obj, nvar, loc


def snl_mom_sparse(n_sensors: int, cliques: Sequence[Sequence[int]] = None,
                   seed: int = 1, noise: float = 0.0) -> SedumiData:
    """Reference-equivalent front door: planted SNL -> clique-sparse
    order-2 moment SDP (default: one clique over all variables, as in
    Sensor_Network_Localization.m:33)."""
    obj, nvar, _ = snl_problem(n_sensors, seed=seed, noise=noise)
    if cliques is None:
        cliques = [list(range(nvar))]
    return sparse_moment_relax(obj, nvar, cliques)
