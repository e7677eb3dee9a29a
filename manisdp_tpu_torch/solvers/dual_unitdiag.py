"""sup <C,X>+<c,w> s.t. A(X)+B(w)=b, X>=0, diag(S)=1 (PyTorch port of
manisdp_tpu/solvers/dual_unitdiag.py; src/dual/ManiDSDP_unitdiag.m:
oblique slack factor + Riemannian ADMM).  Requires AA' diagonal (SOS
bases); pass ``dAAt`` to skip recomputing it.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..config import VARIANT_DEFAULTS, SolverOptions
from ..ops.dualops import DualOp
from ..ops.symdual import SymDualOp
from .common import SDPResult, current, recorded, resolve_device
from .dual_al import solve_dual_al


def _resume(resume, Y0, overrides):
    """Y0 and the multiplier keyword arguments from a checkpoint."""
    kw = {}
    if resume:
        from ..utils.checkpoint import resume_kwargs
        rk = resume_kwargs(resume)
        Y0 = rk.get("Y0", Y0)
        kw = {k: rk[k] for k in ("Xm0", "w0") if k in rk}
        if "sigma0" in rk:
            overrides.setdefault("sigma0", rk["sigma0"])
    return Y0, kw


def _on_device(op, device):
    if op.device.type != device.type:
        raise ValueError(f"the operator lives on {op.device}, the solve was "
                         f"asked for {device}")
    return op


@recorded
def solve_dual_unitdiag(A, b, c, n: int, f: int = 0,
                        dAAt=None,
                        options: Optional[SolverOptions] = None,
                        Y0: Optional[np.ndarray] = None,
                        resume: Optional[str] = None,
                        device="cuda",
                        **overrides) -> SDPResult:
    """SeDuMi dual layout: A (m, f + n^2) sparse with the free block first
    (ManiDSDP_unitdiag.m:34-37), b (m,), c (f + n^2,); or a DualOp /
    SymDualOp already on ``device`` in place of A.

    ``resume``: path of a checkpoint_every snapshot; loads the factor,
    multipliers (Xm, w) and penalty and continues that trajectory.
    ``device``: where the solve runs; "cuda" (the default) raises when no
    GPU is present."""
    with current().timed("operator"):
        device = resolve_device(device)
        Y0, kw = _resume(resume, Y0, overrides)
        op = _on_device(A, device) if isinstance(A, (DualOp, SymDualOp)) \
            else DualOp.build(A, b, c, n, f, dAAt, device=device)
    return solve_dual_al("dual_unitdiag", op, options, Y0=Y0, **kw,
                         **overrides)


@recorded
def solve_bqp_sos_dual(Q, e, q: int,
                       options: Optional[SolverOptions] = None,
                       device="cuda",
                       **overrides) -> SDPResult:
    """One-call SOS dual of min x'Qx + e'x over {-1,1}^q via the expanded
    basis tensor operator (ops/symdual.SymDualOp, kernels K7 and K8).

    The same problem as assemble_bqpsos -> solve_dual_unitdiag (reference
    example/dual/example_bqp_dual.m:10-40).  b is normalized by max|b|
    internally as the reference examples do; the returned ``obj`` is
    scaled back to the unnormalized problem.
    """
    timers = current()
    with timers.timed("operator"):
        op = SymDualOp.build_bqpsos(Q, e, q, device=device)
        maxb = float(op.b.abs().max())
        op = op.scaled(maxb)
        # reference p0 = ceil(log(#constraints)) (ManiDSDP_unitdiag.m:11);
        # the flat tensor length would inflate it
        overrides.setdefault("p0", max(int(np.ceil(np.log(op.m_true))), 1))
        # exact-correspondence parameter mapping (ops/symdual.py): every
        # class size is 4x on the duplicated basis, so sigma_e =
        # sigma_ref/4 gives identical cost values and rho tests, gradients
        # and Hessians / 2, step norms * sqrt(2), ||As|| * 2 and gradnorm /
        # sqrt(2): tau thresholds scale by 2 sqrt(2) and tolgradnorm by
        # 1/sqrt(2)
        d = VARIANT_DEFAULTS["dual_unitdiag"]
        s2 = float(np.sqrt(2.0))
        overrides.setdefault("sigma0", d["sigma0"] / 4.0)
        overrides.setdefault("sigma_min", d["sigma_min"] / 4.0)
        overrides.setdefault("sigma_max", d["sigma_max"] / 4.0)
        overrides.setdefault("tau1", d["tau1"] * 2.0 * s2)
        # tau2: the reference's own large-q recipe drops tau2 to 10
        # (example/dual/example_bqp_dual.m:36, "% q = 80, i = 3")
        tau2_ref = 10.0 if q >= 70 else d["tau2"]
        overrides.setdefault("tau2", tau2_ref * 2.0 * s2)
        overrides.setdefault("tolgradnorm", 1e-8 / s2)
        # plateau-boost budget: deep enough to collapse gradnorm without
        # the 30 x 200 default's cost
        overrides.setdefault("boost_tr_maxiter", 15)
        overrides.setdefault("boost_tr_maxinner", 100)
        # forced sigma escalation on pinf stagnation (config.sigma_push)
        overrides.setdefault("sigma_push", True)
    res = solve_dual_al("dual_unitdiag", op, options, **overrides)
    with timers.timed("result"):
        res.obj = res.obj * maxb
    return res
