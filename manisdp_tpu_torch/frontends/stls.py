"""Structured total least squares: nearest rank-deficient Hankel matrix.

Capability equivalent of example/example_stls.m (which builds its SDP
with STRIDE's hankel_struct/nearest_hankel_sdp):

    min_{u, z}  ||u - u1||^2   s.t.  z' H(u) = 0,  ||z|| = 1

with H(u) the n1 x n2 Hankel matrix of the k = n1+n2-1 parameters u.
Lifted through x = kron([u; 1], z) in R^{(k+1) n1}:  X = x x' has
blocks X_{ij} = u_i u_j z z' (u_{k+1} := 1), so

  objective    sum_i tr(X_{ii}) - 2 sum_i u1_i tr(X_{i,k+1})   (+ ||u1||^2)
  norm         tr(X_{k+1,k+1}) = 1
  kernel       (z' H(u))_c z_s = 0   and   (z' H(u))_c u_t z_s = 0
  consistency  X entries of equal monomials u_i u_j z_a z_b are chained
               equal (the monomial depends only on {i,j} x {a,b})

— a Shor-type relaxation that is tight on generic instances (the
reference's experiment certifies eta <= 1e-8 and extracts the rank-one
solution).  All constraints are linear in X; SeDuMi layout, solve with
solve_sdp and the "stls" recipe.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import scipy.sparse as sp

from .sedumi import Cone, SedumiData


def hankel_matrix(u: np.ndarray, n1: int, n2: int) -> np.ndarray:
    """H[r, c] = u[r + c] (0-based), r < n1, c < n2, len(u) = n1+n2-1."""
    r = np.arange(n1)[:, None]
    c = np.arange(n2)[None, :]
    return np.asarray(u)[r + c]


def nearest_hankel_sdp(u1: np.ndarray, n1: int, n2: int) -> SedumiData:
    """SDP relaxation of the nearest rank-deficient Hankel problem.

    Returns SeDuMi data with K.s = (k+1)*n1, k = n1+n2-1.  The solved
    objective <c, x> omits the constant ||u1||^2; add it back for the
    distance value (see stls_objective).
    """
    u1 = np.asarray(u1, dtype=np.float64).ravel()
    k = n1 + n2 - 1
    assert u1.shape[0] == k
    nb = k + 1                      # u blocks + the "1" block
    n = nb * n1

    def pos(i, a):
        """Row index of u_i z_a (i = k means the bare z block)."""
        return i * n1 + a

    rows: List[int] = []
    cols: List[int] = []
    vals: List[float] = []
    b: List[float] = []
    m = 0

    def add_entry(p, q, w, con):
        """w * sym entry (p, q) of X into constraint ``con``."""
        if p == q:
            rows.append(q * n + p)
            cols.append(con)
            vals.append(w)
        else:
            rows.extend([q * n + p, p * n + q])
            cols.extend([con, con])
            vals.extend([0.5 * w, 0.5 * w])

    # ---- norm constraint: tr(X_{k,k}) = 1 ------------------------------
    for a in range(n1):
        add_entry(pos(k, a), pos(k, a), 1.0, m)
    b.append(1.0)
    m += 1

    # ---- kernel constraints (z' H(u))_c * z_s = 0 ----------------------
    # and the u-multiplied versions (z' H(u))_c * u_t z_s = 0
    for c in range(n2):
        for s in range(n1):
            for t in range(k + 1):          # t = k is the z-multiplied one
                for r in range(n1):
                    # monomial u_{r+c} u_t z_r z_s  ->  X[pos(r+c, r), pos(t, s)]
                    add_entry(pos(r + c, r), pos(t, s), 1.0, m)
                b.append(0.0)
                m += 1

    # ---- moment consistency: same monomial => equal entries ------------
    # entry (p=pos(i,a), q=pos(j,b)) carries monomial ({i,j}, {a,b});
    # chain every instance to the group's first
    groups = {}
    for i in range(nb):
        for j in range(i, nb):
            for a in range(n1):
                b_lo = a if i == j else 0
                for bb in range(b_lo, n1):
                    key = (i, j, min(a, bb), max(a, bb))
                    ent = (pos(i, a), pos(j, bb))
                    groups.setdefault(key, []).append(ent)
    for key, ents in groups.items():
        rep = ents[0]
        for ent in ents[1:]:
            add_entry(rep[0], rep[1], 1.0, m)
            add_entry(ent[0], ent[1], -1.0, m)
            b.append(0.0)
            m += 1

    At = sp.coo_matrix((vals, (rows, cols)), shape=(n * n, m)).tocsc()

    # ---- objective ------------------------------------------------------
    cvec = np.zeros(n * n)
    for i in range(k):
        for a in range(n1):
            p = pos(i, a)
            cvec[p * n + p] += 1.0                  # u_i^2 z_a^2
            q = pos(k, a)
            cvec[q * n + p] += -u1[i]               # -2 u1_i u_i z_a^2
            cvec[p * n + q] += -u1[i]
    return SedumiData(At=At, b=np.asarray(b), c=cvec, K=Cone(s=n))


def stls_objective(obj_solved: float, u1: np.ndarray) -> float:
    """||u - u1||^2 from the solved <c, x> (adds the dropped constant)."""
    return float(obj_solved + np.dot(u1, u1))


def extract_solution(X: np.ndarray, n1: int, n2: int
                     ) -> Tuple[np.ndarray, np.ndarray, float]:
    """Rank-one extraction: (u, z, residual ||z'H(u)||).

    x = top eigenvector scaled so the z block has unit norm;
    u_i = tr(X_{i,k}) directly from the moments.
    """
    k = n1 + n2 - 1
    n = (k + 1) * n1
    u = np.array([np.trace(X[i * n1:(i + 1) * n1, k * n1:(k + 1) * n1])
                  for i in range(k)])
    w, V = np.linalg.eigh(X)
    x = V[:, -1] * np.sqrt(max(w[-1], 0.0))
    z = x[k * n1:]
    zn = np.linalg.norm(z)
    if zn > 0:
        z = z / zn
    resid = float(np.linalg.norm(z @ hankel_matrix(u, n1, n2)))
    return u, z, resid
