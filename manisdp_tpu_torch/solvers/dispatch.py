"""SeDuMi-cone dispatcher (PyTorch port of manisdp_tpu/solvers/dispatch.py):
route (At, b, c, K) to the driver that solves it.

A single PSD block with no LP cone goes to the general primal AL driver.
An LP cone (``K.l``) is folded as K.l Euclidean 1x1 blocks into the
multiblock driver, with the PSD blocks after it (a 1x1 PSD block is a
nonnegative variable, and read_sdpa orders the LP part first, which is the
multiblock vec layout for leading 1x1 blocks); so are several PSD blocks.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..config import SolverOptions
from .common import SDPResult
from .general import solve_sdp
from .multiblock import solve_multiblock


def solve_sedumi(data, options: Optional[SolverOptions] = None,
                 device="cuda", **overrides) -> SDPResult:
    """Solve SeDuMi-format data (e.g. from frontends.sdpa.read_sdpa) on
    ``device``: a single PSD block -> the general driver; several blocks
    and / or an LP cone -> the multiblock driver with the LP part as 1x1
    Euclidean blocks."""
    K = data.K
    l = int(getattr(K, "l", 0) or 0)
    s = K.s if isinstance(K.s, (list, tuple, np.ndarray)) else [K.s]
    s = [int(x) for x in s]
    if l == 0 and len(s) == 1:
        return solve_sdp(data.At, data.b, data.c, s[0], options,
                         device=device, **overrides)
    ns = [1] * l + s
    return solve_multiblock(data.At, data.b, data.c, ns=ns, nob=0,
                            options=options, device=device, **overrides)
