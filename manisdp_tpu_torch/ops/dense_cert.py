"""Dense eigen-certificate on the device: an f32 eigh, then f64
Ogita-Aishima refinement with a Gershgorin bound (PyTorch port of
manisdp_tpu/ops/dense_cert.py).

Two tiers:

- ``far`` (max(gap, pinf) above the cheap threshold): the f32 spectrum and
  escape directions only; nothing here decides termination.
- ``near``: a certified f64 lower bound on lam_min (and an enclosure of
  lam_max).  The f32 eigenbasis V is refined in f64 (T = X V, S = VᵀX V,
  B = VᵀV; E_ij = (S_ij + mu_j R_ij) / (mu_j - mu_i) for separated pairs,
  E = R/2 on near-degenerate pairs, V <- V + V E), then certified by
  Gershgorin on the congruence S - mu_min B:

      lam_min(X) - mu_min >= min(0, gersh_min(S - mu_min B)) / lam_min(B)

  with lam_min(B) >= 1 - max row sum of |B - I|.

The products (X V, VᵀT, VᵀV, V E) are cuBLAS GEMMs and the f32 eigh is
``torch.linalg.eigh``, as the JAX package leaves them to XLA; the
elementwise pass between them is kernel K6 (``kernels.oa_refine``).
``certify`` adds the driver's rules around the two tiers: a Ritz value
that alone proves dinf > tol is accepted, and a bound that never
certifies falls back to an exact f64 ``torch.linalg.eigh`` on the same
device (the JAX package falls back to a host ``np.linalg.eigh``).
``COUNTS`` records which tier decided each call, summed over every call
and thread; inside a recorded solver call the tiers are also spans of
its ``cert`` (utils/timers.py): ``cert.far``, ``cert.near`` (the f32
eigh, the refinement GEMMs and K6) and ``cert.eigh64``, each ending on
the host read its tier makes.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..kernels import oa_refine
from ..utils.timers import span

# tier of every certify() call: the far tier, the near tier certified by
# its bound, accepted on the Ritz value, or decided by the f64 eigh
COUNTS = {"far": 0, "near": 0, "ritz": 0, "eigh64": 0}


def reset_counts():
    for key in COUNTS:
        COUNTS[key] = 0


@dataclasses.dataclass
class DenseCertResult:
    lam_min: float          # certified lower bound (near) / f32 est (far)
    lam_max: float          # Rayleigh lower est; |err| <= slack
    num_neg: int
    neg_vecs: torch.Tensor  # (n, k) float64 on the matrix's device
    slack: float            # certified bound slack (0.0 for far tier)
    certified: bool
    # Ritz value of the lowest refined direction: an upper bound on
    # lam_min up to f64 roundoff, independent of the Gershgorin slack
    lam_min_ritz: float = np.nan


def _oa_refine(X64, V):
    """One Ogita-Aishima refinement step in f64.  Returns the updated basis
    and the current basis's certificate quantities (mu, mu_min, mu_max,
    gersh_min, gersh2_min, bmin)."""
    T = X64 @ V
    S = V.T @ T
    S = 0.5 * (S + S.T)
    B = V.T @ V
    mu = torch.diagonal(S) / torch.diagonal(B)
    mu_min, mu_max = torch.min(mu), torch.max(mu)
    E, bsum, g1, g2 = oa_refine(S, B, mu, mu_min, mu_max)
    V_new = V + V @ E
    return (V_new, mu, mu_min, mu_max, torch.min(g1), torch.min(g2),
            1.0 - torch.max(bsum))


def _order_cols(V, mu, k: int):
    idx = torch.argsort(mu)[:k]
    Vk = V[:, idx]
    return Vk / torch.linalg.norm(Vk, dim=0), int(torch.sum(mu < 0))


class DenseEighCert:
    """The two tiers for (n, n) matrices and k escape directions."""

    def __init__(self, n: int, k: int, refine_max: int = 3):
        self.n = n
        self.k = k
        self.refine_max = refine_max

    def far(self, X32) -> DenseCertResult:
        w, V = torch.linalg.eigh(X32)
        return DenseCertResult(
            lam_min=float(w[0]), lam_max=float(w[-1]),
            num_neg=int(torch.sum(w < 0)),
            neg_vecs=V[:, :self.k].to(torch.float64), slack=0.0,
            certified=False)

    def near(self, X64, X32, target_rel: float) -> DenseCertResult:
        """Certified lam_min lower bound with slack <= target (attempted).

        ``target_rel`` is a relative slack goal: the absolute target is
        target_rel * (1 + |lam_max|) with lam_max from the f32 spectrum.
        Returns certified=False if the Gershgorin bound never reached it
        (the caller then takes an exact eigh)."""
        w32, V32 = torch.linalg.eigh(X32)
        target = target_rel * (1.0 + abs(float(w32[-1])))
        V = V32.to(X64.dtype)
        best = None
        for _ in range(self.refine_max):
            V_new, mu, mu_min, mu_max, gmin, g2min, bmin = _oa_refine(X64, V)
            bmin_f = float(bmin)
            if bmin_f <= 0.0:
                break
            slack = max(0.0, -float(gmin)) / bmin_f
            slack2 = max(0.0, -float(g2min)) / bmin_f
            cur = (max(slack, slack2), float(mu_min), float(mu_max), mu, V)
            if best is None or cur[0] < best[0]:
                best = cur
            if best[0] <= target:
                break
            V = V_new
        if best is None:
            return DenseCertResult(
                np.nan, np.nan, 0,
                torch.zeros((self.n, self.k), dtype=X64.dtype,
                            device=X64.device), np.inf, False)
        slack, mu_min, mu_max, mu, Vb = best
        Vk, num_neg = _order_cols(Vb, mu, self.k)
        return DenseCertResult(
            lam_min=mu_min - slack, lam_max=mu_max, num_neg=num_neg,
            neg_vecs=Vk, slack=slack, certified=slack <= target,
            lam_min_ritz=mu_min)

    def certify(self, S64, far: bool, tol: float) -> DenseCertResult:
        """The AL driver's certificate of the symmetric f64 ``S64``
        (manisdp_tpu/solvers/primal_al.py:241-261): the far tier, or the
        near tier with target 0.1 * tol; an uncertified near bound stands
        when its Ritz value alone puts dinf above 2 * tol, else an exact
        f64 eigh decides."""
        if far:
            COUNTS["far"] += 1
            with span("cert.far"):
                return self.far(S64.to(torch.float32))
        with span("cert.near"):
            res = self.near(S64, S64.to(torch.float32), target_rel=0.1 * tol)
        if res.certified:
            COUNTS["near"] += 1
            return res
        if np.isfinite(res.lam_min_ritz) and max(0.0, -res.lam_min_ritz) > \
                2.0 * tol * (1.0 + abs(res.lam_max)):
            COUNTS["ritz"] += 1
            return dataclasses.replace(res, certified=True,
                                       lam_min=res.lam_min_ritz)
        COUNTS["eigh64"] += 1
        with span("cert.eigh64"):
            vals, vecs = torch.linalg.eigh(S64)
            lam_min, lam_max = float(vals[0]), float(vals[-1])
            num_neg = int(torch.sum(vals < 0))
        return DenseCertResult(
            lam_min=lam_min, lam_max=lam_max, num_neg=num_neg,
            neg_vecs=vecs[:, :self.k], slack=0.0, certified=True,
            lam_min_ritz=lam_min)
