"""SeDuMi-cone dispatcher (PyTorch port of manisdp_tpu/solvers/dispatch.py):
route (At, b, c, K) to the driver that solves it.

A single PSD block with no LP cone goes to the general primal AL driver.
The JAX package folds an LP cone (``K.l``) and multiple blocks into its
multiblock driver, which the port does not have yet: those raise.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..config import SolverOptions
from .common import SDPResult
from .general import solve_sdp


def solve_sedumi(data, options: Optional[SolverOptions] = None,
                 device="cuda", **overrides) -> SDPResult:
    """Solve SeDuMi-format data (e.g. from frontends.sdpa.read_sdpa): a
    single PSD block -> the general driver on ``device``."""
    K = data.K
    l = int(getattr(K, "l", 0) or 0)
    s = K.s if isinstance(K.s, (list, tuple, np.ndarray)) else [K.s]
    s = [int(x) for x in s]
    if l == 0 and len(s) == 1:
        return solve_sdp(data.At, data.b, data.c, s[0], options,
                         device=device, **overrides)
    raise NotImplementedError(
        f"K.l = {l} and {len(s)} PSD block(s): the JAX package solves these "
        "with its multiblock driver (solvers/multiblock.py), which is not "
        "ported yet")
