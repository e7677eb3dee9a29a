"""One-call BQP moment-SDP primal solver on the expanded tensor operator
(PyTorch port of manisdp_tpu/solvers/primal_mom.py; the reference's
example/example_bqp.m:10-15, bqpmom -> ManiSDP_unitdiag).

The same problem as frontends.moments.bqpmom -> solve_unitdiag, with obj /
gap / pinf / dinf defined as the reference's: ``ops/symmom.SymMomOp``
(kernels K9 and K10) reproduces the constraint rows exactly.

Parameter mapping (expanded-basis correspondence): on the
duplicate-symmetric subspace the expanded AL cost equals the original one
as a function, so sigma needs no remapping.  Each expanded column's
Euclidean gradient is half the original column's and tangent norms scale
by sqrt(2), so

    tau1, tau2       -> sqrt(2) * tau
    tolgradnorm      -> tolgradnorm / sqrt(2)

and escape vectors lift with 1/sqrt(2) per copy, then scale by sqrt(2)
(solvers/primal_al.py, the compressed certificate).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..config import VARIANT_DEFAULTS, SolverOptions
from ..ops.symmom import SymMomOp
from .common import SDPResult, current, recorded
from .primal_al import solve_primal_al


@recorded
def solve_bqp_mom(Q, e, q: int,
                  options: Optional[SolverOptions] = None,
                  device="cuda",
                  **overrides) -> SDPResult:
    """Primal moment-SDP of min x'Qx + e'x over {-1,1}^q on ``device``
    ("cuda", the default, raises when no GPU is present)."""
    with current().timed("operator"):
        op = SymMomOp.build_bqpmom(Q, e, q, device=device)
        d = VARIANT_DEFAULTS["unitdiag"]
        s2 = float(np.sqrt(2.0))
        overrides.setdefault("tau1", d["tau1"] * s2)
        overrides.setdefault("tau2", d["tau2"] * s2)
        overrides.setdefault("tolgradnorm", 1e-8 / s2)
        # keep the reference default p0 = 2 (ManiSDP_unitdiag.m:10); the
        # driver's log(m) fallback would see the inflated flat length
        overrides.setdefault("p0", d.get("p0", 2))
    return solve_primal_al("unitdiag", op, options, **overrides)
