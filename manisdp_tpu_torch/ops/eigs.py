"""Dual-certificate result, the exact (dense eigh) certificate, the
Lanczos spectral bound, the LOBPCG certificate of ``cert_method="lobpcg"``
and the ``dual_certificate`` dispatch over them (PyTorch port of
manisdp_tpu/ops/eigs.py).

The JAX package carries four copies of the Lanczos pass (ops/eigs.py:65,
ops/eigs_rr.py:105, :285 and :439); the port has this one, in the row
layout of the certificate.  The JAX ``lobpcg_certificate`` runs the
library routine ``lobpcg_standard`` in the (n, k) column layout; the port
gives the same certificate from its one LOBPCG class
(``eigs_rr.DeviceCertSolver``) in the row layout.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import torch


class CertResult(NamedTuple):
    """Partial eigendecomposition summary for the dual certificate.

    ``num_neg`` counts negative Ritz values of the block, so it saturates
    at the block size; drivers pass k = delta + 1, so min(num_neg, delta)
    escape directions are the same as with a full eig.  Certification
    (dinf) never uses num_neg.
    """
    lam_min: Any       # smallest eigenvalue of S (residual-backed bound)
    lam_max: Any       # largest eigenvalue of S (upper estimate)
    num_neg: Any       # negative Ritz-value count (see docstring)
    neg_vecs: Any      # (n, k) Ritz vectors of the k smallest Ritz values
    neg_vals: Any      # (k,) the k smallest Ritz values, ascending


def eigh_certificate(S_dense, k: int) -> CertResult:
    """Exact certificate from a dense symmetric S (``torch.linalg.eigh``
    on S's device): the extreme eigenvalues, the count of negative ones,
    and the bottom k eigenpairs (vectors (n, k))."""
    vals, vecs = torch.linalg.eigh(S_dense)
    return CertResult(lam_min=vals[0], lam_max=vals[-1],
                      num_neg=torch.sum(vals < 0), neg_vecs=vecs[:, :k],
                      neg_vals=vals[:k])


def lanczos_bounds(matvec_rows: Callable, v0: torch.Tensor,
                   iters: int = 32):
    """Spectral-interval estimate (lo, hi) of a symmetric S by plain
    Lanczos (no reorthogonalization) on (1, n) row vectors;
    ``matvec_rows(V) = V S``.  The Ritz extremes are padded by the last
    beta.  Returns two 0-d tensors; nothing is read on the host."""
    tiny = torch.finfo(v0.dtype).tiny
    v = v0 / torch.linalg.norm(v0)
    v_prev = torch.zeros_like(v)
    beta = torch.zeros((), dtype=v.dtype, device=v.device)
    alphas, betas = [], []
    for _ in range(iters):
        w = matvec_rows(v) - beta * v_prev
        alpha = torch.sum(v * w)
        w = w - alpha * v
        beta = torch.linalg.norm(w)
        v_prev, v = v, w / torch.clamp(beta, min=tiny)
        alphas.append(alpha)
        betas.append(beta)
    a = torch.stack(alphas)
    b = torch.stack(betas)[:-1]
    T = torch.diag(a) + torch.diag(b, 1) + torch.diag(b, -1)
    ritz = torch.linalg.eigvalsh(T)
    slack = torch.abs(b[-1]) if iters > 1 else torch.zeros_like(a[0])
    return ritz[0] - slack, ritz[-1] + slack


def lobpcg_certificate(matvec_rows: Callable, n: int, k: int,
                       gen: torch.Generator, maxiter: int = 400,
                       tol: float = 1e-10, deflate=None, X0=None,
                       matvec32: Callable = None,
                       refine_iters: int = 16,
                       info: Optional[dict] = None) -> CertResult:
    """Bottom-k eigenpairs of a symmetric S from ``matvec_rows(V) = V S``
    on (rows, n) V, with the semantics of the JAX package's
    ``lobpcg_certificate`` (ops/eigs.py:94):

    - Lanczos bounds of 48 iterations; ``lam_max`` is their upper end;
    - a block of k rows, random (from ``gen``) or ``X0`` (rows or (n, k)
      columns) with 1e-9 noise, augmented with ``deflate``'s (the factor
      Y, (p, n)) whitened strong directions under the budget
      min((n-1)//5 - k, 24 - k); the factor only seeds the block, nothing
      is projected out;
    - with ``matvec32`` (the same product in float32) the bulk of the
      iterations, up to ``maxiter``, run in f32, then up to
      ``refine_iters`` in f64; otherwise up to ``maxiter`` in f64.  The
      f32 stage ends once the first k residuals fall below 1e-5 of the
      spectral scale, near the f32 floor (the JAX routine's own test,
      relative to 10 n |A x|, ends it sooner);
    - ``lam_min`` = ritz_0 - ||r_0|| from f64 residuals (the linear
      bound), ``num_neg`` counts the block's negative Ritz values, and
      the bottom-k Ritz vectors and values.

    The bound holds for the eigenvalue nearest the bottom Ritz value: an
    eigenvalue the block never found is not bounded, so an unconverged run
    can miss the true lambda_min.  ``info``, when given, receives the
    solve's iteration counts (``iters``, and ``iters32`` / ``iters64``
    with the f32 stage), residual and spectral scale."""
    from .eigs_rr import DeviceCertSolver
    rows = 0 if deflate is None else deflate.shape[0]
    solver = DeviceCertSolver(n, k, deflate_rows=rows, bound="linear",
                              lanczos_iters=48)
    res = solver.solve(
        matvec_rows, gen, X0=X0, Ydefl=deflate, maxiter=maxiter, tol=tol,
        matvec32_rows=matvec32,
        refine_iters=refine_iters if matvec32 is not None else None,
        jitter=1e-9 if X0 is not None else 0.0)
    if info is not None:
        info.update(solver.last)
    return res


def dual_certificate(method: str, n: int, k: int, *, S_dense=None,
                     matvec_rows: Callable = None,
                     gen: Optional[torch.Generator] = None,
                     lobpcg_tol: float = 1e-9,
                     eig_switch_n: int = 2049) -> CertResult:
    """Dispatch of the JAX package's ``dual_certificate``: ``"eigh"`` (the
    dense S), ``"lobpcg"`` (``matvec_rows(V) = V S`` on (rows, n) V, the
    random draws from ``gen`` in place of the key) or ``"auto"`` (eigh
    below ``eig_switch_n``, else lobpcg)."""
    if method == "auto":
        method = "eigh" if n < eig_switch_n else "lobpcg"
    if method == "eigh":
        if S_dense is None:
            raise ValueError("eigh certificate needs S_dense")
        return eigh_certificate(S_dense, k)
    if method == "lobpcg":
        if matvec_rows is None or gen is None:
            raise ValueError("lobpcg certificate needs matvec_rows and gen")
        return lobpcg_certificate(matvec_rows, n, k, gen, tol=lobpcg_tol)
    raise ValueError(f"unknown eig method {method!r}")
