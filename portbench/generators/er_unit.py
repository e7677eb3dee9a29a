"""Erdos-Renyi graphs with unit edge weights, as MaxCut SDP costs.

Frozen copy of chip_smoke.py's ``g1_standin`` (chip_smoke.py:319-325),
drawn from the benchmark's own generator: ``m`` distinct edges among
the n(n-1)/2 pairs of ``n`` vertices, the shape of Gset's G1 (rudy's
random graph, n = 800, 19,176 edges, density 6 %).  C = -L/4.
"""

import numpy as np
import scipy.sparse as sp


def laplacian_cost(n, i, j, w):
    """C = -L/4 of the graph with edges (i, j, w): the MaxCut SDP cost
    (chip_smoke.py:310-317)."""
    W = sp.coo_matrix((np.r_[w, w], (np.r_[i, j], np.r_[j, i])),
                      shape=(n, n)).tocsr()
    deg = np.asarray(W.sum(axis=1)).ravel()
    return (-0.25) * (sp.diags(deg) - W).tocsr()


def make(params: dict, rng: np.random.Generator):
    """One instance: the scipy CSR cost of an n-vertex, m-edge graph."""
    n, m = int(params["n"]), int(params["m"])
    iu, ju = np.triu_indices(n, 1)
    pick = rng.choice(iu.size, size=m, replace=False)
    return laplacian_cost(n, iu[pick], ju[pick], np.ones(m))


def vary(C, rng: np.random.Generator):
    """The seed's copy of a pool graph: its vertices renumbered, P C P'
    (the same problem; the solver takes another path to it)."""
    perm = rng.permutation(C.shape[0])
    return C[perm][:, perm].tocsr()
