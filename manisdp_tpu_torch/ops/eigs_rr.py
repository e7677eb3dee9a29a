"""Row-layout LOBPCG dual certificate on the device (PyTorch port of
manisdp_tpu/ops/eigs_rr.py DeviceCertSolver, MaxCut slice).

One class serves every LOBPCG certificate of the drivers:

  - the warm call (block cap 24, Kato-Temple witness bound),
  - the accuracy-deciding big-block retry (cap ``cert_big_block`` = 96,
    linear bound; the JAX package runs it as RowCertSolver with a host
    Rayleigh-Ritz),
  - the rowrr path and the small-n fallback of devrr (cap 24, linear
    bound; RowCertSolver there), with its optional f32 stage,
  - ``cert_method="lobpcg"`` (``ops/eigs.lobpcg_certificate``; the JAX
    package's ``lobpcg_standard`` path).

The f32 stage (``matvec32_rows``) follows RowCertSolver's: f32 products
and contractions down to residuals of max(tol, 1e-5) times the spectral
scale, its Rayleigh-Ritz in f64 as the JAX host one is, then the f64
stage from the f32 block with A X recomputed in f64 and the search
directions restarted.  The port also ends the f32 stage when its largest
residual has not halved in 10 iterations (the f32 floor can sit above
the exit tolerance) or a step is not finite.

Every (block, n) array is kept in row layout and S = C - diag(z) is
applied as ``matvec_rows(V) = V S`` (kernel K1's ``shift`` mode for a
sparse C).  The Grams and contractions are ``torch.matmul`` and the
3b x 3b Rayleigh-Ritz is ``torch.linalg.eigh`` on the device.  The JAX
package's TPU workarounds are gone: no block cap of 42, no 1e-30 floor
(the f64 ``finfo.tiny`` guards instead), no three-program split.

Soundness contract: the reported lam_min is an f64 residual-backed lower
bound of the eigenvalue nearest the bottom Ritz value — ritz_0 - ||r_0||
(linear), sharpened to the Kato-Temple ritz_0 - ||r_0||^2/gap only when
another Ritz pair's certified interval witnesses the gap (see
``_finish``).  As in the JAX package, an eigenvalue the block never
found is not bounded: the assumption, standard for converged Krylov
blocks, is that no eigenvalue hides below the block's Ritz values.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from .eigs import CertResult, lanczos_bounds


def _rayleigh_ritz(G, H, drop_tol: float, nkeep: int, big: float):
    """Eigenpairs of H restricted to the span with Gram G.  Dropped
    (near-dependent) directions get Ritz value ``big`` so they sort past
    the wanted bottom block; their coefficient columns are zero."""
    tiny = torch.finfo(G.dtype).tiny
    G = (G + G.T) * 0.5
    H = (H + H.T) * 0.5
    w, V = torch.linalg.eigh(G)
    keep = w > drop_tol * torch.clamp(w[-1], min=tiny)
    s = torch.where(keep, 1.0 / torch.sqrt(torch.clamp(w, min=tiny)),
                    torch.zeros_like(w))
    W = V * s[None, :]
    Hs = W.T @ H @ W
    Hs = (Hs + Hs.T) * 0.5 + torch.diag(
        torch.where(keep, torch.zeros_like(w), torch.full_like(w, big)))
    th, U = torch.linalg.eigh(Hs)
    C = W @ U
    return th[:nkeep], C[:, :nkeep]


class DeviceCertSolver:
    """Bottom-k eigenpairs of a symmetric S (n x n) by row-layout LOBPCG.

    ``block_cap``: working-block budget b = k + aug, where the ``aug``
    augmentation rows are Y's strongest directions (whitened), so the
    Rayleigh-Ritz resolves the near-null cluster of S at a MaxCut optimum
    internally; aug = min(min((n-1)//5, block_cap) - k, deflate_rows).
    ``bound``: "kato" (witnessed Kato-Temple, num_neg counts th + corr
    < 0) or "linear" (ritz - resid, num_neg counts th < 0).
    """

    BIG = 1e30       # Ritz value given to dropped basis directions
    F32_PATIENCE = 10  # f32 iterations allowed without halving the residual
    RISE_TOL = 1e-10   # rise of the bottom Ritz value (x scale) = breakdown

    def __init__(self, n: int, k: int, deflate_rows: int = 0,
                 block_cap: int = 24, bound: str = "kato",
                 lanczos_iters: int = 32):
        if bound not in ("kato", "linear"):
            raise ValueError(f"bound must be 'kato' or 'linear', "
                             f"got {bound!r}")
        self.n, self.k = n, k
        self.aug = min(max(min((n - 1) // 5, block_cap) - k, 0),
                       deflate_rows)
        self.b = k + self.aug
        self.bound = bound
        self.lanczos_iters = lanczos_iters
        # the last solve's iterations, residual and spectral scale, for
        # reading a certificate's convergence after the fact
        self.last: dict = {}

    def solve(self, matvec_rows: Callable, gen: torch.Generator,
              X0: Optional[torch.Tensor] = None,
              Ydefl: Optional[torch.Tensor] = None,
              maxiter: int = 200, tol: float = 1e-10,
              matvec32_rows: Optional[Callable] = None,
              switch_tol: float = 1e-5,
              refine_iters: Optional[int] = None,
              jitter: float = 0.0) -> CertResult:
        """``matvec_rows(V) = V S`` for (rows, n) V.  ``X0``: start block,
        (k, n) rows or (n, k) columns; random when None.  ``Ydefl``:
        (rows, n) deflation factor (needed when ``aug`` > 0).  Random
        draws come from ``gen``, which must live on the solve's device.

        ``matvec32_rows``: the same product in float32.  Given it, an f32
        stage runs first, until the first k residuals fall below
        max(tol, switch_tol) * scale (its Rayleigh-Ritz drops directions
        at 1e-6; a start block whose bottom pair is already below that
        skips it), then the f64 stage from the f32 block, with A X
        recomputed in f64 and the search directions restarted.  The two stages share the budget
        ``maxiter``, unless ``refine_iters`` gives the f64 stage a budget
        of its own (the f32 stage then has all of ``maxiter``).  A
        non-finite f32 step ends the f32 stage with the last good block.
        ``jitter``: scale of the Gaussian noise added to a given X0.  The
        reported bounds always come from f64 residuals (``_finish``), so a
        weak f32 stage can only make them more conservative."""
        n, k, b, aug = self.n, self.k, self.b, self.aug
        dev, dt = gen.device, torch.float64
        tiny = torch.finfo(dt).tiny
        randn = lambda rows: torch.randn(  # noqa: E731
            (rows, n), generator=gen, dtype=dt, device=dev)

        # -- Lanczos spectral-interval bounds --
        lo, hi = lanczos_bounds(matvec_rows, randn(1), self.lanczos_iters)
        scale = torch.clamp(torch.maximum(torch.abs(lo), torch.abs(hi)),
                            min=tiny)

        # -- block assembly: X0 rows + whitened deflation rows --
        if X0 is None:
            X0 = randn(k)
        else:
            X0 = X0.to(dtype=dt, device=dev)
            if X0.shape[0] == n and (X0.dim() == 1 or X0.shape[1] != n):
                X0 = X0.T
            X0 = X0[:k]
            if jitter:
                X0 = X0 + jitter * randn(X0.shape[0])
        blocks = [X0]
        if aug:
            if Ydefl is None or Ydefl.shape[0] < aug:
                raise ValueError(f"need a deflation factor of >= {aug} "
                                 "rows")
            Yd = Ydefl.to(dt)
            w, V = torch.linalg.eigh(Yd @ Yd.T)
            w_top = torch.flip(w, (0,))[:aug]
            V_top = torch.flip(V, (1,))[:, :aug]
            good = w_top > 1e-12 * torch.clamp(w_top[0], min=tiny)
            sc = torch.where(good, 1.0 / torch.sqrt(
                torch.clamp(w_top, min=tiny)), torch.zeros_like(w_top))
            Q = (V_top * sc[None, :]).T @ Yd
            blocks.append(torch.where(good[:, None], Q, randn(aug)))
        X = torch.cat(blocks)                                 # (b, n)
        X = X / torch.clamp(torch.linalg.norm(X, dim=1, keepdim=True),
                            min=tiny)

        # -- Rayleigh-quotient seeding (the first Rayleigh-Ritz of the
        #    loop orthonormalizes the block) --
        AX = matvec_rows(X)
        theta = torch.sum(X * AX, dim=1)
        rn = torch.linalg.norm(AX - theta[:, None] * X, dim=1)
        X_start, q_start = X, float(torch.min(theta))
        P = torch.zeros_like(X)
        AP = torch.zeros_like(AX)

        # -- LOBPCG, stage by stage: (matvec, dtype, exit tolerance,
        #    Rayleigh-Ritz drop tolerance, last iteration) --
        stages = []
        if matvec32_rows is not None:
            stages.append((matvec32_rows, torch.float32,
                           max(tol, switch_tol), 1e-6, maxiter))
        stages.append((matvec_rows, dt, tol, 1e-12, maxiter))
        j = 0
        counts = []
        for mv, sdt, stol, drop, last in stages:
            thresh = stol * float(scale)
            if sdt != dt:
                if float(rn[0]) < thresh:
                    # a warm start whose bottom pair is already past the
                    # f32 exit keeps its f64 accuracy: rounding it to f32
                    # would cost the bound more than f32 iterations give
                    counts.append(0)
                    continue
                X, AX, P, AP, theta, rn = (t.to(sdt) for t in
                                           (X, AX, P, AP, theta, rn))
            elif X.dtype != dt:
                # entering f64 from f32: the carried products hold f32
                # error, so recompute A X and the residuals; the f64 stage
                # restarts its search directions from the f32 block
                X, theta = X.to(sdt), theta.to(sdt)
                AX = mv(X)
                P, AP = torch.zeros_like(X), torch.zeros_like(AX)
                rn = torch.linalg.norm(AX - theta[:, None] * X, dim=1)
            if sdt == dt and refine_iters is not None and counts:
                last = j + refine_iters
            j0 = j
            X, AX, P, AP, theta, rn, j = self._iterate(
                mv, X, AX, P, AP, theta, rn, j, last, thresh, drop,
                patience=self.F32_PATIENCE if sdt != dt else None)
            counts.append(j - j0)

        lam_min, num_neg, Xk, th_k, resid_k = self._finish(
            matvec_rows, X.to(dt))
        # LOBPCG's Ritz values never rise in exact arithmetic (each step's
        # subspace holds the last block), so a final bottom Ritz value above
        # the start block's smallest Rayleigh quotient marks a breakdown
        # (the carried products drifted and the block lost the bottom of the
        # spectrum) or an f32 stage that lost the start block's accuracy.
        # Its bound can then exceed a value the start block already showed
        # (a false certificate), so the start block's own bounds, as valid,
        # are reported where their lam_min is the lower.
        broke = float(th_k[0]) > q_start + self.RISE_TOL * float(scale)
        if broke:
            start = self._finish(matvec_rows, X_start)
            if float(start[0]) < float(lam_min):
                lam_min, num_neg, Xk, th_k, resid_k = start
        self.last = dict(iters=j, resid=resid_k, scale=scale, lo=lo, hi=hi,
                         breakdown=broke)
        if matvec32_rows is not None:
            self.last.update(iters32=counts[0], iters64=counts[1])
        return CertResult(lam_min=lam_min, lam_max=hi, num_neg=num_neg,
                          neg_vecs=Xk.T, neg_vals=th_k)

    def _iterate(self, mv, X, AX, P, AP, theta, rn, j, last, thresh,
                 drop, patience=None):
        """LOBPCG iterations in X's dtype, counted on from ``j``, until
        the first k residuals fall below ``thresh`` or ``j`` reaches
        ``last``; with ``patience``, also once the largest of them has not
        halved for that many iterations (the f32 stage: its residuals can
        stall above the exit tolerance at the f32 floor).  A step whose
        Rayleigh-Ritz fails or whose block, Ritz values or residuals are
        not finite is not taken and ends the stage: once the residuals
        grind past the dtype's floor the whitened basis can go
        non-finite."""
        k, b = self.k, self.b
        dt, dev = X.dtype, X.device
        f64 = torch.float64
        tiny = torch.finfo(dt).tiny
        pmask = torch.cat([torch.zeros((b, b), dtype=f64, device=dev),
                           torch.ones((b, 2 * b), dtype=f64, device=dev)],
                          dim=1)
        best, j_best = float("inf"), j
        while j < last:
            cur = float(torch.max(rn[:k]))
            if cur < thresh:
                break
            if cur < 0.5 * best:
                best, j_best = cur, j
            elif patience is not None and j - j_best >= patience:
                break
            R = AX - theta[:, None] * X
            R = R / torch.clamp(rn, min=tiny)[:, None]
            AR = mv(R)
            Z = torch.cat([X, R, P])
            AZ = torch.cat([AX, AR, AP])
            # the Rayleigh-Ritz runs in f64 in either stage (the JAX
            # package's f32 stage takes its Grams to a host f64 one): an f32
            # eigh of Grams conditioned up to 1/drop loses the whitening
            G = (Z @ Z.T).to(f64)
            try:
                th, C = _rayleigh_ritz(G, (Z @ AZ.T).to(f64), drop, b,
                                       self.BIG)
            except torch.linalg.LinAlgError:
                break          # an eigh of non-finite or degenerate input
            Cx = C.T                                           # (b, 3b)
            Cp = Cx * pmask
            pn = torch.sqrt(torch.clamp(torch.sum((Cp @ G) * Cp, dim=1),
                                        min=torch.finfo(f64).tiny))
            Cp = (Cp / pn[:, None]).to(dt)
            Cx, th = Cx.to(dt), th.to(dt)
            Xn, AXn = Cx @ Z, Cx @ AZ
            rn_n = torch.linalg.norm(AXn - th[:, None] * Xn, dim=1)
            if not bool(torch.isfinite(torch.sum(Xn) + torch.sum(th)
                                       + torch.sum(rn_n))):
                break
            X, AX, P, AP = Xn, AXn, Cp @ Z, Cp @ AZ
            theta, rn = th, rn_n
            j += 1
        return X, AX, P, AP, theta, rn, j

    def _finish(self, matvec_rows, X):
        """Honest epilogue: recompute A X (the loop's AX is a linear
        combination of earlier products and carries drift) and derive
        the bounds from exact f64 residuals.

        Two corrections per Ritz pair (th_i, r_i):
          linear   : |lambda - th_i| <= r_i           (always valid)
          quadratic: r_i^2 / gap_i (Kato-Temple), only when another pair
                     j witnesses the gap: th_j - r_j > th_i + r_i, with
                     gap_i = min over such j of (th_j - r_j) - th_i.
        The linear bound alone stalls on the clustered spectrum of S at
        a MaxCut optimum (the cluster's spread floors every residual);
        because the block covers the cluster, the first pair above it
        witnesses the gap.  A stagnated solve whose neighbours are as
        unconverged gets no witness and keeps the linear bound.
        """
        k, b = self.k, self.b
        tiny = torch.finfo(X.dtype).tiny
        AX = matvec_rows(X)
        th, C = _rayleigh_ritz(X @ X.T, X @ AX.T, 1e-12, b, self.BIG)
        X = C.T @ X
        AX = C.T @ AX
        resid = torch.linalg.norm(AX - th[:, None] * X, dim=1)
        if self.bound == "kato":
            up = th - resid                       # certified lower ends
            cand = torch.where(up[None, :] > (th + resid)[:, None],
                               up[None, :], torch.full_like(up, self.BIG))
            wit = torch.min(cand, dim=1).values   # closest witness per i
            gap = torch.clamp(wit - th, min=tiny)
            corr = torch.where(wit < self.BIG,
                               torch.minimum(resid, resid * resid / gap),
                               resid)
            # only meaningfully negative Ritz values count as escape
            # directions: raw sign noise at the optimum would append
            # junk directions forever
            num_neg = int(torch.sum(th + corr < 0))
        else:
            corr = resid
            num_neg = int(torch.sum(th < 0))
        s_lower = th - corr
        return (s_lower[0], num_neg, X[:k], th[:k],
                torch.max(resid[:k]))


def lobpcg_rows(matvec_rows: Callable, n: int, k: int, gen: torch.Generator,
                maxiter: int = 200, tol: float = 1e-9, deflate=None,
                X0=None, matvec32: Optional[Callable] = None,
                switch_tol: float = 1e-5) -> CertResult:
    """One-shot wrapper (tests / ad-hoc use), the JAX package's
    ``lobpcg_rows``: the rowrr solve on ``DeviceCertSolver`` (linear
    bound, block cap 24, ``deflate`` the factor whose strong directions
    augment the block) with ``matvec_rows(V) = V S``, random draws from
    ``gen``."""
    rows = 0 if deflate is None else deflate.shape[0]
    solver = DeviceCertSolver(n, k, deflate_rows=rows, bound="linear")
    return solver.solve(matvec_rows, gen, X0=X0, Ydefl=deflate,
                        maxiter=maxiter, tol=tol, matvec32_rows=matvec32,
                        switch_tol=switch_tol)
