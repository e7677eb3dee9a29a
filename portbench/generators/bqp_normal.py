"""Binary quadratic programs min x'Qx + e'x over {-1, 1}^q.

Frozen copy of the stand-in of chip_smoke.py's ``bqp_instance``
(chip_smoke.py:1150-1165; bench.py:176-179), drawn from the benchmark's
own generator: Q the symmetrised standard normal matrix (Q + Q')/2, e
standard normal, the class of ManiSDP-matlab's bqp_Q_q_i / bqp_e_q_i
data.
"""

import numpy as np


def make(params: dict, rng: np.random.Generator):
    """One instance: (Q (q, q), e (q,), q)."""
    q = int(params["q"])
    Q = rng.standard_normal((q, q))
    Q = (Q + Q.T) / 2.0
    e = rng.standard_normal(q)
    return Q, e, q


def vary(inst, rng: np.random.Generator):
    """The seed's copy of a pool program: (2^k Q, 2^k e) for a whole k in
    [-3, 3].  A power of two scales exactly, and the solver divides b by
    max |b|, so it takes the same path, bit for bit, to the same
    certificate, and its bound scales by 2^k: every seed's window does
    the same work.  (A renumbering, or a scale that is not a power of
    two, changes the path at rounding level, and with it the solve time:
    PERF.md section 4 gives those readings.)"""
    Q, e, q = inst
    c = 2.0 ** int(rng.integers(-3, 4))
    return c * Q, c * e, q
