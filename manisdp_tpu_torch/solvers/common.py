"""Outer-loop machinery shared by the drivers (PyTorch port of the part
of manisdp_tpu/solvers/common.py that the MaxCut and primal AL drivers
use).

Rank policy: the factor is a (p_pad, n) buffer with zero padding rows,
p_pad = the active rank p rounded up to a multiple of ``p_bucket``.
Rank edits (truncate / append escape rows) happen on the host in numpy,
once per outer iteration, off the hot path.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import numpy as np
import torch

from ..core import TROptions, make_trustregions
from ..core.trustregions import cast_floats
# the span recorder lives in utils/timers.py, where the RTR reaches it
# too; the drivers import it from here
from ..utils.timers import PhaseTimers, current, recorded, span  # noqa: F401


@dataclasses.dataclass
class SDPResult:
    """Solver output mirroring the reference's ``[X, obj, data]``."""
    X: Any                     # primal matrix (np.ndarray)
    obj: float
    Y: np.ndarray              # final factor (active rows only)
    y: Optional[np.ndarray] = None     # multipliers
    S: Optional[np.ndarray] = None     # dual slack matrix (dense, if formed)
    z: Optional[np.ndarray] = None
    gap: float = np.nan
    pinf: float = np.nan
    dinf: float = np.nan
    eta: float = np.nan        # max KKT residual
    gradnorm: float = np.nan
    time: float = 0.0          # the call's wall, entry to return
    status: int = 0            # 0 optimal, 1 iter max, 2 slow progress
    iterations: int = 0
    fac_size: Optional[list] = None
    rtr_iters: int = 0         # total accepted/rejected TR iterations
    hess_calls: int = 0        # total tCG inner iterations (Hv products)
    history: Optional[list] = None
    timers: Optional[dict] = None  # seconds per span (utils/timers.py)
    sigma: Optional[float] = None
    tier: int = 0


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; "cuda" without a card raises — the
    solvers never move to the CPU on their own."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device='cuda' but torch finds no CUDA device; "
                           "pass device='cpu' to run the plain twins")
    return device


def bucketed(p: int, bucket: int) -> int:
    return ((p + bucket - 1) // bucket) * bucket


def pad_rows(Y: np.ndarray, p_pad: int) -> np.ndarray:
    """Zero-pad a (p, n) factor to (p_pad, n)."""
    p, n = Y.shape
    if p == p_pad:
        return np.ascontiguousarray(Y)
    out = np.zeros((p_pad, n), dtype=Y.dtype)
    out[:p] = Y
    return out


def gram_svd(Y_dev: torch.Tensor, p: int):
    """Singular values (descending, length p) and left singular vectors
    (p_pad, p) of the active factor, from the p_pad x p_pad Gram formed
    on the device and eigendecomposed on the host; the truncated factor
    is U[:, :r].T @ Y."""
    G = (Y_dev @ Y_dev.T).cpu().numpy()
    w, V = np.linalg.eigh(G)            # ascending
    w = np.maximum(w, 0.0)
    order = np.argsort(w)[::-1][:p]
    return np.sqrt(w[order]), V[:, order]


class RankController:
    """Rank truncation + escape append for single-block drivers."""

    def __init__(self, theta: float, delta: int, alpha: float,
                 nne_floor: bool, bucket: int):
        self.theta = theta
        self.delta = delta
        self.alpha = alpha
        self.nne_floor = nne_floor   # max(..., 1) floor, oblique drivers
        self.bucket = bucket

    def truncation(self, Y_dev, p: int):
        """Detect over-parameterized rank; return (r, e, U)."""
        e, U = gram_svd(Y_dev, p)
        r = int(np.sum(e >= self.theta * e[0]))
        return max(r, 1), e, U

    def num_escape(self, num_neg: int) -> int:
        nne = min(int(num_neg), self.delta)
        if self.nne_floor:
            nne = max(nne, 1)
        return nne


def sigma_update(sigma: float, pinf: float, gradnorm: float, opt) -> float:
    """Self-adaptive penalty schedule (ManiSDP_unitdiag.m:108-112):
    ``opt`` a SolverOptions (tau1, tau2, gama, sigma_min, sigma_max)."""
    if pinf < opt.tau1 * gradnorm:
        return max(sigma / opt.gama, opt.sigma_min)
    elif pinf > opt.tau2 * gradnorm:
        return min(sigma * opt.gama, opt.sigma_max)
    return sigma


class SlowProgress:
    """Every ``period`` iterations: if none of the tracked residuals
    improved since the previous checkpoint (and iter > warmup), flag
    status 2 (ManiSDP_unitdiag.m:82-92)."""

    def __init__(self, period: int, warmup: int):
        self.period = period
        self.warmup = warmup
        self.prev: Optional[tuple] = None

    def check(self, it: int, *residuals: float) -> bool:
        if it % self.period != 0:
            return False
        if it > self.warmup and self.prev is not None and \
                all(r > r0 for r, r0 in zip(residuals, self.prev)):
            return True
        self.prev = tuple(residuals)
        return False


def mixed_prestage(problem, budget: TROptions, opt, gradnorm: float, Y,
                   params32, typicaldist: float):
    """``inner_dtype="mixed"``: an f32 RTR of ``budget``'s schedule on the
    f32 cost (``params32``), down to the looser of ``mixed_tolgradnorm``
    and ``budget``'s tolerance, then the problem manifold's renormalize of
    the upcast factor.  Returns (Y in f64, TR iterations, tCG iterations);
    the stage is skipped (Y, 0, 0) once the previous f64 ``gradnorm`` sits
    at or below its target: below the f32 noise floor it would burn its
    budget without progress."""
    if np.isfinite(gradnorm) and gradnorm <= opt.mixed_tolgradnorm:
        return Y, 0, 0
    solve32 = make_trustregions(problem, TROptions(
        maxiter=budget.maxiter, maxinner=budget.maxinner,
        tolgradnorm=max(opt.mixed_tolgradnorm, budget.tolgradnorm)))
    res = solve32(Y.to(torch.float32), params32, typicaldist)
    return (problem.manifold.renormalize(res.Y.to(torch.float64)),
            res.iters, res.inner_iters)


def make_line_search(cost_fn: Callable, renorm: Callable,
                     max_extra: int = 45, ls_dtype=None):
    """Backtracking saddle-escape line search (ManiSDP_unitdiag.m:138-150).

    alpha starts at 1 and shrinks by 0.8 up to 15 times; a step is
    accepted when the cost drops by at least 1e-3, as in the reference.
    Where the reference then force-accepts the 15-times-shrunk step even
    if it raises the cost, this keeps shrinking for up to ``max_extra``
    more steps until the cost strictly decreases, and stays put if none
    does.  ``cost_fn(Y, params) -> f`` (0-d tensor); ``renorm`` maps an
    ambient point back to the manifold.

    ``ls_dtype`` ("float32"): the first 15 trial costs are evaluated in
    that dtype (params and trial point cast; the accepted point stays in
    the ambient dtype).  Their 1e-3 accept test sits far above f32 noise;
    the strict-decrease tail and the final stay-put guard compare
    full-precision costs.
    """
    i_max = 15 + max_extra
    ls_dt = getattr(torch, ls_dtype) if ls_dtype else None

    def read(f):
        with span("rtr.wait"):
            return float(f)

    def line_search(Y, U, params):
        f_full = lambda P: read(cost_fn(P, params))  # noqa: E731
        if ls_dt is None:
            f_of = f_full
        else:
            params_c = cast_floats(params, ls_dt)
            f_of = lambda P: read(cost_fn(P.to(ls_dt), params_c))  # noqa: E731
        f0 = f_of(Y)
        alpha, i = 1.0, 1
        nY = renorm(Y + alpha * U)
        fa = f_of(nY)
        while i <= 15 and fa - f0 > -1e-3:
            alpha *= 0.8
            nY = renorm(Y + alpha * U)
            fa = f_of(nY)
            i += 1
        if fa - f0 <= -1e-3:
            return nY
        if ls_dt is not None:
            f0, fa = f_full(Y), f_full(nY)
        while i <= i_max and fa >= f0:
            alpha *= 0.8
            nY = renorm(Y + alpha * U)
            fa = f_full(nY)
            i += 1
        # if even the smallest step failed to decrease, stay put
        return nY if fa < f0 else Y

    return line_search


def make_batched_line_search(cost_fn: Callable, renorm: Callable,
                             max_extra: int = 45):
    """The line search of ``make_line_search`` for B instances at once (the
    JAX package's jax.vmap of it, solvers/batch.py:85-87).

    ``cost_fn(Y, params) -> (B,)`` costs of a (B, p, n) stack; ``renorm``
    maps a stack back onto the manifold.  Each instance keeps its own
    alpha, trial count and accepted point on the device; a trial evaluates
    every instance and keeps the result where the instance is still
    searching.  The host reads "any instance still searching" once per
    trial (the span ``rtr.wait``), at most 15 + ``max_extra`` times."""
    i_max = 15 + max_extra

    def line_search(Y, U, params):
        B = Y.shape[0]
        per = lambda m: m.view(B, 1, 1)  # noqa: E731

        def search(alpha, i, nY, fa, going, cond):
            """Shrink alpha by 0.8 for every instance in ``going`` while
            cond(i, fa) holds for it."""
            going = going & cond(i, fa)
            while True:
                more = torch.any(going)
                with span("rtr.wait"):
                    more = bool(more)
                if not more:
                    break
                alpha = torch.where(going, 0.8 * alpha, alpha)
                trial = renorm(Y + per(alpha) * U)
                nY = torch.where(per(going), trial, nY)
                fa = torch.where(going, cost_fn(trial, params), fa)
                i = i + going.to(i.dtype)
                going = going & cond(i, fa)
            return alpha, i, nY, fa

        f0 = cost_fn(Y, params)
        alpha = torch.ones((B,), dtype=Y.dtype, device=Y.device)
        i = torch.ones((B,), dtype=torch.int32, device=Y.device)
        nY = renorm(Y + per(alpha) * U)
        fa = cost_fn(nY, params)
        alpha, i, nY, fa = search(
            alpha, i, nY, fa, torch.ones_like(i, dtype=torch.bool),
            lambda i, fa: (i <= 15) & (fa - f0 > -1e-3))
        # no 1e-3 decrease in 15 trials: keep shrinking until the cost
        # strictly decreases
        done = fa - f0 <= -1e-3
        alpha, i, nY, fa = search(alpha, i, nY, fa, ~done,
                                  lambda i, fa: (i <= i_max) & (fa >= f0))
        # if even the smallest step failed to decrease, stay put
        return torch.where(per(done | (fa < f0)), nY, Y)

    return line_search


def log_iter(verbose: bool, it: int, obj: float, *, gap=None, pinf=None,
             dinf: float, gradnorm=None, r=None, p: int, sigma=None,
             wall: float):
    if not verbose:
        return
    parts = [f"Iter {it}, obj:{obj:0.8f}"]
    if gap is not None:
        parts.append(f"gap:{gap:0.1e}")
    if pinf is not None:
        parts.append(f"pinf:{pinf:0.1e}")
    parts.append(f"dinf:{dinf:0.1e}")
    if gradnorm is not None:
        parts.append(f"gradnorm:{gradnorm:0.1e}")
    if r is not None:
        parts.append(f"r:{r}")
    parts.append(f"p:{p}")
    if sigma is not None:
        parts.append(f"sigma:{sigma:0.3f}")
    parts.append(f"time:{wall:0.2f}s")
    print(", ".join(parts), flush=True)
