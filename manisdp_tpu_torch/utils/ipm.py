"""Small dense primal-dual interior-point SDP solver (cross-check oracle).

The reference's strongest correctness evidence is cross-solving the same
SeDuMi data with MOSEK/SDPLR/SDPNAL+ and comparing the common KKT
metric (example_maxcut.m:38-85, SURVEY §4.2).  No external solver ships
in this environment, so this module provides an INDEPENDENT in-repo
baseline: a classical HKM-direction path-following interior-point
method, dense numpy, O(m^2 n^2 + m n^3) per iteration — a completely
different algorithm family from the Burer-Monteiro manifold drivers, so
agreement between the two is genuine cross-validation.

Scope: small instances (n <= ~60, m <= ~500), the regime used by the
cross-check tests.  Not a production path — the manifold drivers are.

    min <C, X>  s.t.  <A_k, X> = b_k,  X >= 0
    max b'y     s.t.  S = C - sum_k y_k A_k >= 0
"""

from __future__ import annotations

from typing import List, NamedTuple

import numpy as np
import scipy.sparse as sp


class IPMResult(NamedTuple):
    X: np.ndarray
    y: np.ndarray
    S: np.ndarray
    obj: float
    gap: float
    pinf: float
    dinf: float
    iterations: int


def _as_mats(At, n: int) -> List[np.ndarray]:
    """SeDuMi At (n^2, m) columns -> dense symmetric A_k matrices."""
    At = sp.csc_matrix(At)
    mats = []
    for k in range(At.shape[1]):
        A = np.asarray(At[:, k].todense()).reshape(n, n, order="F")
        mats.append(0.5 * (A + A.T))
    return mats


def solve_sdp_ipm(At, b, c, n: int, tol: float = 1e-9,
                  max_iter: int = 200) -> IPMResult:
    """HKM path-following IPM on dense SeDuMi data.

    Newton system (HKM / XZ linearization, right-multiplied by S^{-1}):
        dX = sigma*mu*Si - X - X dS Si        (symmetrized after solve)
        dS = Rd - A*(dy)
        M dy = rp - A(sigma*mu*Si - X) + A(X Rd Si),
        M[i,j] = tr(A_i X A_j Si)   (PD for independent A_k)
    """
    A = _as_mats(At, n)
    m = len(A)
    b = np.asarray(b, dtype=np.float64).ravel()
    C = np.asarray(c, dtype=np.float64).reshape(n, n, order="F")
    C = 0.5 * (C + C.T)

    # start well inside the cone, scaled to the data
    scale = max(1.0, np.abs(C).max(), np.abs(b).max())
    X = scale * np.eye(n)
    S = scale * np.eye(n)
    y = np.zeros(m)

    def Aop(M):
        return np.array([np.sum(Ak * M) for Ak in A])

    def Atop(v):
        out = np.zeros((n, n))
        for vk, Ak in zip(v, A):
            out += vk * Ak
        return out

    def step_len(M, dM):
        """Largest alpha <= 1 keeping M + alpha*dM PD (0.98 to boundary)."""
        L = np.linalg.cholesky(M)
        Li = np.linalg.inv(L)
        w = np.linalg.eigvalsh(Li @ dM @ Li.T)
        wmin = w[0]
        return 1.0 if wmin >= -1e-14 else min(1.0, -0.98 / wmin)

    normb = 1.0 + np.linalg.norm(b)
    normC = 1.0 + np.linalg.norm(C)
    it = 0
    for it in range(1, max_iter + 1):
        rp = b - Aop(X)
        Rd = C - S - Atop(y)
        mu = np.sum(X * S) / n
        obj = np.sum(C * X)
        gap = abs(obj - b @ y) / (1.0 + abs(obj) + abs(b @ y))
        pinf = np.linalg.norm(rp) / normb
        dinf = np.linalg.norm(Rd) / normC
        if max(gap, pinf, dinf) < tol:
            break

        sigma = 0.2 if max(pinf, dinf) < 1e-8 else 0.5
        Si = np.linalg.inv(S)
        Si = 0.5 * (Si + Si.T)

        XAS = [X @ Ak @ Si for Ak in A]           # X A_j Si
        M = np.empty((m, m))
        for i in range(m):
            for j in range(m):
                M[i, j] = np.sum(A[i] * XAS[j])
        M = 0.5 * (M + M.T)
        M += (1e-13 * np.trace(M) / m) * np.eye(m)

        W = sigma * mu * Si - X
        rhs = rp - Aop(W) + Aop(X @ Rd @ Si)
        dy = np.linalg.solve(M, rhs)
        dS = Rd - Atop(dy)
        dX = W - X @ dS @ Si
        dX = 0.5 * (dX + dX.T)

        ap = step_len(X, dX)
        ad = step_len(S, dS)
        X = 0.5 * ((X + ap * dX) + (X + ap * dX).T)
        S = 0.5 * ((S + ad * dS) + (S + ad * dS).T)
        y = y + ad * dy

    obj = float(np.sum(C * X))
    rp = b - Aop(X)
    Rd = C - S - Atop(y)
    return IPMResult(
        X=X, y=y, S=S, obj=obj,
        gap=float(abs(obj - b @ y) / (1.0 + abs(obj) + abs(b @ y))),
        pinf=float(np.linalg.norm(rp) / normb),
        dinf=float(np.linalg.norm(Rd) / normC),
        iterations=it)
