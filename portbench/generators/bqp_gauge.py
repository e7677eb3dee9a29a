"""Binary quadratic programs min x'Qx + e'x over {-1, 1}^q, varied by a
sign gauge: the problems of ``bqp_normal`` (its ``make``, so a cell on
this generator draws the same pool as one on that), each seed's copy
taken by x_i -> s_i x_i for a sign vector s.

The gauge is exact in floating point (Q_ij -> s_i s_j Q_ij, e_i ->
s_i e_i), keeps the optimum and its value, and maps the moment matrix of
the order-2 relaxation by a +-1 diagonal similarity that keeps every
class constraint, so every seed solves the same relaxation.  It is the
variant for the primal moment driver (solve_bqp_mom), which does not
normalise C and whose sigma schedule compares pinf with the gradient
norm: ``bqp_normal``'s 2^k scale there changes the solver's path and its
work, not only the bits.  Kept over the 2^k scale by six seeds of the
cell's first four pool calls on an H100 (PERF.md section 4): under the
gauge every solve certified and the four calls took 27.9-35.1 s a seed
(spread 10 %, Hessian products 8 %); under the 2^k scale 6 of 24 solves
ran out of outer iterations and the calls took 60.1-145.0 s (spread
46 %, products 36 %).
"""

import numpy as np

from portbench import registry


def make(params: dict, rng: np.random.Generator):
    """One instance: (Q (q, q), e (q,), q), as bqp_normal draws it."""
    return registry.generator("bqp_normal").make(params, rng)


def vary(inst, rng: np.random.Generator):
    """The seed's copy of a pool problem: (S Q S, S e) with S = diag(s),
    s uniform in {-1, 1}^q."""
    Q, e, q = inst
    s = rng.choice(np.array([-1.0, 1.0]), size=q)
    return s[:, None] * Q * s[None, :], s * e, q
