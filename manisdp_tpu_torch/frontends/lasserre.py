"""Generic dense Lasserre-hierarchy relaxation for polynomial
optimization problems.

Capability equivalent of src/basicfunction/dense_sdp_relax.m (credit
Heng Yang in the reference) and dense_sdp_relax_binary.m, without the
SPOTLESS msspoly dependency: polynomials are dicts from exponent
tuples to coefficients.

    min  f(x)   s.t.  h_i(x) = 0

order-kappa relaxation: moment matrix over the monomial basis [x]_kappa
(size C(n+kappa, kappa)), with
  - the anchor y_0 = 1,
  - equality of repeated monomial positions,
  - localizing constraints  sum_beta h_beta * y_{beta+alpha} = 0 for
    every monomial alpha with deg(alpha) <= 2 kappa - deg(h).

The binary variant reduces exponents mod 2 first (x_i^2 = 1), dropping
squared monomials from the basis (dense_sdp_relax_binary.m:17-24).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import scipy.sparse as sp

from .monomials import basis_index, monomial_basis
from .sedumi import Cone, SedumiData

Poly = Dict[Tuple[int, ...], float]


def poly_from_arrays(exponents: np.ndarray, coeffs) -> Poly:
    """exponents (n, nterms) columns + coefficients -> Poly dict."""
    out: Poly = {}
    for t, cv in zip(exponents.T, np.asarray(coeffs, dtype=np.float64)):
        key = tuple(int(x) for x in t)
        out[key] = out.get(key, 0.0) + float(cv)
    return out


def poly_eval(p: Poly, x: np.ndarray) -> float:
    return float(sum(cv * np.prod(x ** np.asarray(e))
                     for e, cv in p.items()))


def poly_degree(p: Poly) -> int:
    return max((sum(e) for e in p.keys()), default=0)


def dense_sdp_relax(objective: Poly, equalities: Sequence[Poly],
                    n: int, kappa: int,
                    binary: bool = False) -> SedumiData:
    """Order-kappa dense moment relaxation -> single-block SeDuMi data
    for solve_sdp (or solve_unitdiag when binary, whose moment matrix
    has unit diagonal)."""
    max_power = 1 if binary else None
    basis = monomial_basis(n, kappa, max_power=max_power)
    mb = basis.shape[1]

    def reduce_e(e):
        e = np.asarray(e, dtype=np.int64)
        return tuple(e % 2) if binary else tuple(e)

    # label set: all reduced pair sums + shifted equality monomials
    labels: Dict[Tuple[int, ...], int] = {}

    def lab_id(key):
        if key not in labels:
            labels[key] = len(labels)
        return labels[key]

    # moment-matrix positions per label
    pos: List[List[Tuple[int, int]]] = []
    for i in range(mb):
        for j in range(i, mb):
            key = reduce_e(basis[:, i] + basis[:, j])
            t = lab_id(key)
            if t == len(pos):
                pos.append([])
            pos[t].append((i, j))

    def ent(r, c):
        return c * mb + r

    def class_entries(t):
        ent_idx = []
        for (a, b_) in pos[t]:
            if a == b_:
                ent_idx.append(ent(a, a))
            else:
                ent_idx += [ent(a, b_), ent(b_, a)]
        return ent_idx

    rows, cols, vals, bvals = [ent(0, 0)], [0], [1.0], [1.0]
    l = 1
    # repeated-position equality within each label class
    for t in range(len(pos)):
        if len(pos[t]) < 2:
            continue
        a0, b0 = pos[t][0]
        rep = ([ent(a0, a0)], [1.0]) if a0 == b0 else \
            ([ent(a0, b0), ent(b0, a0)], [0.5, 0.5])
        for (a, b_) in pos[t][1:]:
            oth = ([ent(a, a)], [-1.0]) if a == b_ else \
                ([ent(a, b_), ent(b_, a)], [-0.5, -0.5])
            rows += rep[0] + oth[0]
            cols += [l] * (len(rep[0]) + len(oth[0]))
            vals += rep[1] + oth[1]
            bvals.append(0.0)
            l += 1
    # localizing constraints for equalities
    twok = 2 * kappa
    shift_basis = monomial_basis(n, twok, max_power=max_power)
    for h in equalities:
        degh = max(sum(e) for e in h.keys())
        for col in range(shift_basis.shape[1]):
            alpha = shift_basis[:, col]
            if alpha.sum() > twok - degh:
                continue
            entry_rows, entry_vals = [], []
            ok = True
            for e_h, cv in h.items():
                key = reduce_e(np.asarray(e_h) + alpha)
                if key not in labels or not pos[labels[key]]:
                    ok = False
                    break
                idxs = class_entries(labels[key])
                entry_rows += idxs
                entry_vals += [cv / len(idxs)] * len(idxs)
            if not ok or not entry_rows:
                continue
            rows += entry_rows
            cols += [l] * len(entry_rows)
            vals += entry_vals
            bvals.append(0.0)
            l += 1

    At = sp.coo_matrix((vals, (rows, cols)), shape=(mb * mb, l)).tocsc()
    b = np.asarray(bvals)

    # objective spread over label classes
    c = np.zeros(mb * mb)
    for e_f, cv in objective.items():
        key = reduce_e(e_f)
        if key not in labels:
            raise ValueError(
                f"objective monomial {key} outside relaxation order")
        idxs = class_entries(labels[key])
        for idx in idxs:
            c[idx] += cv / len(idxs)
    return SedumiData(At=At, b=b, c=c, K=Cone(s=mb))
