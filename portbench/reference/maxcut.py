"""Plain reference for the MaxCut SDP: min <C, X> s.t. diag(X) = 1, X >= 0.

``judge`` recomputes, in float64 from the raw cost C the benchmark made,
the residuals of the primal-dual pair the solver returned (the factor Y
and the multipliers z of diag(X) = 1) and of its objective:

    X = Y'Y,  S = C - diag(z),  cx = <C, X>,
    pinf = max |diag(X) - 1|,
    dinf = max(0, -lambda_min(S)) / (1 + lambda_max(S)),
    gap  = max(|cx - sum(z)|, |obj - cx|) / (1 + |cx|),

eta = max(pinf, dinf, gap) (the batch driver's dinf and the KKT oracle of
chip_smoke.py:392-410, written again here).  A pair with eta <= tol
certifies obj: X is feasible, z is dual feasible to dinf, and their
objectives meet.  ``z_rel`` (not compared) is the distance of the
returned z from diag(C X) of the returned Y, relative to 1 + max |z|.
``solve_plain`` is a plain Riemannian gradient descent on the oblique
manifold: the reference's own solver, for the tests and the control.
Plain torch only: nothing of the program is imported.
"""

from __future__ import annotations

import numpy as np
import torch

# the numbers compared: the largest reading over the instances judged
NUMBERS = {"eta_max": "eta"}


def _dense(C, device):
    C = torch.as_tensor(C.toarray() if hasattr(C, "toarray") else
                        np.asarray(C), dtype=torch.float64, device=device)
    return 0.5 * (C + C.T)


def judge(instance, result, device) -> dict:
    """Readings of one returned answer (``result.Y`` (p, n), ``result.z``
    (n,), ``result.obj``) against the raw cost ``instance``."""
    C = _dense(instance, device)
    n = C.shape[0]
    Y = torch.as_tensor(np.asarray(result.Y, dtype=np.float64),
                        device=device)
    zr = np.asarray(result.z if result.z is not None else [],
                    dtype=np.float64).ravel()
    if Y.dim() != 2 or Y.shape[1] != n or zr.shape != (n,):
        inf = float("inf")
        return dict(eta=inf, pinf=inf, dinf=inf, gap=inf, z_rel=inf)
    X = Y.T @ Y
    pinf = float(torch.max(torch.abs(torch.diagonal(X) - 1.0)))
    zx = torch.sum(C * X, dim=0)
    del X
    cx = float(torch.sum(zx))
    z = torch.as_tensor(zr, dtype=torch.float64, device=device)
    w = torch.linalg.eigvalsh(C - torch.diag(z))
    dinf = max(0.0, -float(w[0])) / (1.0 + float(w[-1]))
    gap = max(abs(cx - float(torch.sum(z))),
              abs(float(result.obj) - cx)) / (1.0 + abs(cx))
    z_rel = float(torch.max(torch.abs(z - zx))) / \
        (1.0 + float(torch.max(torch.abs(zx))))
    return dict(eta=max(pinf, dinf, gap), pinf=pinf, dinf=dinf, gap=gap,
                z_rel=z_rel)


class Answer:
    """An answer in the solver's result layout (Y, z, obj)."""

    def __init__(self, Y, z, obj, status=0, eta=0.0):
        self.Y, self.z, self.obj = Y, z, obj
        self.status, self.eta = status, eta


def rounded_f32(result) -> Answer:
    """The answer as a float32 computation would hold it at best: every
    returned number rounded to float32."""
    f32 = lambda a: np.asarray(a, dtype=np.float32).astype(np.float64)  # noqa: E731
    return Answer(f32(result.Y), f32(result.z),
                  float(np.float32(result.obj)), result.status, result.eta)


def solve_plain(Cs, p: int, dtype, iters: int, seed: int, device,
                tol: float = 1e-8):
    """Plain Burer-Monteiro on the oblique manifold for a batch of costs:
    fixed-step Riemannian gradient descent (step 1 / (2 Gershgorin bound
    of C)), columns renormalised each step, in ``dtype`` (TF32 off).
    Returns one Answer per cost, in float64 arrays, with the status its
    own certificate in ``dtype`` gives: 0 when max(pinf, dinf) <= tol."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    C = torch.stack([_dense(c, device) for c in Cs]).to(dtype)
    B, n, _ = C.shape
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    Y = torch.randn((B, p, n), generator=gen, dtype=torch.float64,
                    device=device).to(dtype)
    Y = Y / torch.linalg.norm(Y, dim=1, keepdim=True)
    step = 1.0 / (2.0 * torch.amax(torch.sum(torch.abs(C), dim=2), dim=1))
    step = step[:, None, None]
    for _ in range(iters):
        G = 2.0 * (Y @ C)
        Y = Y - step * (G - Y * torch.sum(Y * G, dim=1, keepdim=True))
        Y = Y / torch.linalg.norm(Y, dim=1, keepdim=True)
    z = torch.sum(Y * (Y @ C), dim=1)
    pinf = torch.amax(torch.abs(torch.sum(Y * Y, dim=1) - 1.0), dim=1)
    w = torch.linalg.eigvalsh(C - torch.diag_embed(z))
    dinf = torch.clamp(-w[:, 0], min=0.0) / (1.0 + w[:, -1])
    eta = torch.maximum(pinf, dinf).double().cpu().numpy()
    out = []
    for b in range(B):
        zb = z[b].double().cpu().numpy()
        out.append(Answer(Y[b].double().cpu().numpy(), zb, float(zb.sum()),
                          status=int(not eta[b] <= tol), eta=float(eta[b])))
    return out
