"""Toroidal grid graphs with +-1 edge weights, as MaxCut SDP costs.

Frozen copy of chip_smoke.py's ``torus_standin`` and ``laplacian_cost``
(chip_smoke.py:310-317, 327-339), drawn from the benchmark's own
generator: Gset's G62-G81 series (rudy's toroidal grids with weights
+-1 at random) at the ``rows`` x ``cols`` shape of the traffic mix.
C = -L/4 of the weighted Laplacian; n = rows * cols, 2n edges.
"""

import numpy as np
import scipy.sparse as sp


def laplacian_cost(n, i, j, w):
    """C = -L/4 of the graph with edges (i, j, w): the MaxCut SDP cost."""
    W = sp.coo_matrix((np.r_[w, w], (np.r_[i, j], np.r_[j, i])),
                      shape=(n, n)).tocsr()
    deg = np.asarray(W.sum(axis=1)).ravel()
    return (-0.25) * (sp.diags(deg) - W).tocsr()


def make(params: dict, rng: np.random.Generator):
    """One instance: the scipy CSR cost of a rows x cols torus."""
    rows, cols = int(params["rows"]), int(params["cols"])
    a, b = np.meshgrid(np.arange(rows), np.arange(cols), indexing="ij")
    v = (a * cols + b).ravel()
    right = (a * cols + (b + 1) % cols).ravel()
    down = (((a + 1) % rows) * cols + b).ravel()
    i = np.r_[v, v]
    j = np.r_[right, down]
    w = rng.choice([-1.0, 1.0], size=i.size)
    return laplacian_cost(rows * cols, i, j, w)


def vary(C, rng: np.random.Generator):
    """The seed's copy of a pool cost: C + a I with a = -k / 1024 for a
    whole k in [1, 64].  On diag(X) = 1 that adds a n to every objective
    and leaves the solution and S = C - diag(z) as they are; the
    Riemannian gradient and Hessian on the oblique manifold are the same,
    so the solver takes the same path and every seed's window does the
    same work.  C's entries are multiples of 1/4, so C + a I is exact.
    The shift is negative and small: C = -L/4 <= 0 gives <C, X> <= 0, so
    |<C + a I, X>|, by which the reference normalises the gap, grows by
    at most n / 16 and never shrinks.  (A shift up to +1 can bring
    it near 0, and one seed's run then read a returned pair's gap over
    1e-8: PERF.md section 2.)  Which pool calls a window sends is the
    traffic mix's choice (``first_call``): a pool call whose batch
    stalls on one hard torus is part of the traffic wherever the window
    reaches it."""
    a = -int(rng.integers(1, 65)) / 1024.0
    return (C + a * sp.identity(C.shape[0], format="csr")).tocsr()
