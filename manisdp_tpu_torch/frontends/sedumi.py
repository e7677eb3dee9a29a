"""SeDuMi-format problem container.

The reference's drivers take SeDuMi data ``(At, b, c, K)`` where
``At`` is n^2-by-m sparse (columns = vectorized constraint matrices),
``b`` in R^m, ``c = vec(C)``, and the cone ``K`` has fields
``K.s`` (PSD block size(s)), ``K.f`` (free variables), ``K.l``
(nonnegative orthant; unused by ManiSDP), ``K.nob`` (number of leading
unit-diagonal blocks for the multiblock drivers) (reference README.md:15).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Union

import numpy as np
import scipy.sparse as sp


@dataclasses.dataclass
class Cone:
    s: Union[int, List[int]]       # PSD block size or list of sizes
    f: int = 0                     # leading free variables
    l: int = 0                     # nonnegative orthant size
    nob: int = 0                   # leading unit-diagonal blocks (multiblock)


@dataclasses.dataclass
class SedumiData:
    At: sp.spmatrix                # (sum n_i^2 [+f+l], m)
    b: np.ndarray                  # (m,)
    c: np.ndarray                  # like At's row dimension
    K: Cone
