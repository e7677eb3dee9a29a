"""Monomial-basis utilities for moment/SOS relaxation generators.

Equivalent of the reference's graded-basis machinery
(src/basicfunction/get_basis.m, bfind.m, comp.m): monomials in n
variables ordered by (total degree, reversed-lexicographic exponent
tuple) — the order comp.m:1-23 implements by comparing degree first,
then exponents from the last variable down.  We generate with
itertools + a sort and look up with a dict instead of binary search.
"""

from __future__ import annotations

from itertools import combinations_with_replacement
from typing import Dict, Tuple

import numpy as np


def monomial_basis(n: int, d: int, max_power: int | None = None,
                   drop_all_even: bool = False) -> np.ndarray:
    """Exponent matrix (n, count) of monomials with degree <= d in the
    reference's graded order.

    ``max_power`` filters out monomials with any exponent above it
    (e.g. 1 for squarefree); ``drop_all_even`` removes perfect squares
    (used by bqpmom's label set, bqpmom.m:17-23).
    """
    if max_power == 1 and n <= 62:
        # the fast path's int64 bitmask sort key overflows at n >= 63
        # (ADVICE r2) — the generic enumeration below sorts by
        # tuple(e[::-1]), the same order, without the overflow
        return _squarefree_basis(n, d, drop_all_even)
    cols = []
    for deg in range(d + 1):
        degree_cols = []
        for combo in combinations_with_replacement(range(n), deg):
            e = np.zeros(n, dtype=np.int64)
            for v in combo:
                e[v] += 1
            if max_power is not None and e.max(initial=0) > max_power:
                continue
            # NB: the constant monomial (deg 0) is all-even and is
            # dropped too (matches bqpmom.m:19's mod-2 filter).
            if drop_all_even and np.all(e % 2 == 0):
                continue
            degree_cols.append(e)
        degree_cols.sort(key=lambda e: tuple(e[::-1]))
        cols.extend(degree_cols)
    if not cols:
        return np.zeros((n, 0), dtype=np.int64)
    return np.stack(cols, axis=1)


def _squarefree_basis(n: int, d: int, drop_all_even: bool) -> np.ndarray:
    """Vectorized squarefree (0/1 exponent) basis in the graded order.

    Within a degree, the reference order sorts by tuple(e[::-1])
    lexicographically, which for 0/1 exponents equals ascending order
    of the support bitmask sum(e_v * 2^v).  Enumerating subsets per
    degree with itertools.combinations and sorting by that key is
    ~20x faster than the generic path (the q=60 SOS basis has 524k
    columns).
    """
    from itertools import combinations

    assert n <= 62, "int64 bitmask key overflows at n >= 63"
    blocks = []
    for deg in range(d + 1):
        if deg == 0:
            if not drop_all_even:       # constant monomial is all-even
                blocks.append(np.zeros((1, n), dtype=np.int64))
            continue
        combos = np.fromiter(
            (v for c in combinations(range(n), deg) for v in c),
            dtype=np.int64).reshape(-1, deg)
        if combos.size == 0:
            continue
        E = np.zeros((combos.shape[0], n), dtype=np.int64)
        E[np.arange(combos.shape[0])[:, None], combos] = 1
        # drop_all_even never removes squarefree deg>=1 monomials
        key = E @ (1 << np.arange(n, dtype=np.int64))
        blocks.append(E[np.argsort(key, kind="stable")])
    if not blocks:
        return np.zeros((n, 0), dtype=np.int64)
    return np.concatenate(blocks, axis=0).T


def basis_index(basis: np.ndarray) -> Dict[Tuple[int, ...], int]:
    """Monomial tuple -> column index map (replaces bfind binary search)."""
    return {tuple(basis[:, t]): t for t in range(basis.shape[1])}
