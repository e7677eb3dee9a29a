"""min <C,X> s.t. A(X)=b, diag(X)=1, X>=0 (PyTorch port of
manisdp_tpu/solvers/unitdiag.py; src/primal/ManiSDP_unitdiag.m: oblique
manifold + augmented Lagrangian).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..config import SolverOptions
from .common import SDPResult
from .primal_al import solve_sedumi_al


def solve_unitdiag(At, b, c, n: int,
                   options: Optional[SolverOptions] = None,
                   Y0: Optional[np.ndarray] = None,
                   y0: Optional[np.ndarray] = None,
                   mesh=None,
                   resume: Optional[str] = None,
                   device="cuda",
                   **overrides) -> SDPResult:
    """SeDuMi-format input: At (n^2, m) sparse (or a ConstraintOp already
    on ``device``), b (m,), c (n^2,).

    ``resume``: path of a checkpoint_every snapshot; loads the
    factor/multipliers/penalty and continues that trajectory.
    ``mesh``: a DeviceMesh this process is a rank of; the constraint
    operator is sharded over its ``model`` axis (or its last) and every
    rank returns the same result (parallel/sharded_ops.py).
    ``device``: where the solve runs (under a mesh, this rank's device);
    "cuda" (the default) raises when no GPU is present."""
    return solve_sedumi_al("unitdiag", At, b, c, n, options, Y0, y0, mesh,
                           resume, device, overrides)
