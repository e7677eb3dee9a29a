"""Plain reference for the order-2 SOS dual of a binary quadratic program,
min x'Qx + e'x over x in {-1, 1}^q, as solve_bqp_sos_dual returns it.

The answer lives on the solver's expanded monomial basis of
n~ = 2 + q + q^2 columns [1, 1', x_a (a < q), then a q x q grid whose slot
(i, j) is x_i x_j for i != j and x_i for i == j] (its documented output
layout): every squarefree monomial of degree <= 2 twice.  On {-1, 1}^q
the product of the monomials of columns u and v is the monomial of the
XOR of their index sets, so entry (u, v) of a Gram or moment matrix
belongs to one class: a squarefree monomial of degree <= 4.  The
reference works those classes out again from the basis, and the
polynomial's coefficients b from Q and e (b of 1: trace Q; of x_a: e_a;
of x_i x_j: 2 Q_ij; 0 for degree 3 and 4), and judges:

- the SOS certificate, the Gram matrix X~: its class sums a must be
  s b + (0 ... ) with one scale s > 0 for every class but 1, and then
  f(x) - mu / s = v(x)' X~ v(x) / s with mu = s b_1 - a_1.  ``sos_res`` is
  |a - s b| over the classes other than 1, relative to s |b|;
  ``bound_rel`` = |mu / s - obj| / (1 + |obj|): the returned bound must
  be the one X~ certifies;
- dinf = max(0, -lambda_min(X~)) / (1 + |lambda_max(X~)|): X~ >= 0;
- the moment side, S = Y'Y: y = the mean of S over each class (the
  closed-form y-step), pinf = |mat(y) - S|_F (C = 0), and
  gap = |s obj - s b'y| / (1 + |s obj| + |s b'y|);
- ``y_rel`` (read, not compared): the returned multipliers (the
  per-degree flat layout
  [y0, y1 (q), Y2 (q, q), Y3 (q^3), Y4 (q^4)], the class value at every
  permutation of distinct indices) against the reference's y, read at
  each class's sorted indices, relative to max |y|.

eta = max(pinf, dinf, gap).  Plain torch only: nothing of the program is
imported.
"""

from __future__ import annotations

import numpy as np
import torch

# y_rel is read and not compared: at these instances the optimal moments
# are +-1, exact in float32, so the control cannot fail it (PERF.md)
NUMBERS = {"eta_max": "eta", "sos_res_max": "sos_res",
           "bound_rel_max": "bound_rel"}
INF = float("inf")


def basis_masks(q: int, device) -> torch.Tensor:
    """Index-set bitmask (int64) of each column of the expanded basis."""
    if q > 62:
        raise ValueError("the bitmask classes hold q <= 62")
    bit = torch.ones(q, dtype=torch.int64, device=device) << \
        torch.arange(q, device=device)
    o = 2 + q
    m = torch.zeros(o + q * q, dtype=torch.int64, device=device)
    m[2:o] = bit
    m[o:] = (bit[:, None] | bit[None, :]).reshape(-1)
    return m


def classes(q: int, device):
    """(masks of the classes, sorted (K,); class of each entry (n~, n~))."""
    m = basis_masks(q, device)
    return torch.unique(m[:, None] ^ m[None, :], return_inverse=True)


def coefficients(Q, e, uniq) -> torch.Tensor:
    """b over the classes ``uniq`` from the raw Q and e."""
    q = Q.shape[0]
    dev = uniq.device
    f64 = dict(dtype=torch.float64, device=dev)
    Qt = torch.as_tensor(np.asarray(Q, dtype=np.float64), **f64)
    bit = torch.ones(q, dtype=torch.int64, device=dev) << \
        torch.arange(q, device=dev)
    b = torch.zeros(uniq.shape[0], **f64)
    iu, ju = torch.triu_indices(q, q, 1, device=dev)
    where = lambda masks: torch.searchsorted(uniq, masks)  # noqa: E731
    b[where(torch.zeros(1, dtype=torch.int64, device=dev))] = \
        torch.trace(Qt)
    b[where(bit)] = torch.as_tensor(np.asarray(e, dtype=np.float64), **f64)
    b[where(bit[iu] | bit[ju])] = 2.0 * Qt[iu, ju]
    return b


def flat_positions(uniq, q: int) -> torch.Tensor:
    """Position of each class in the per-degree flat multiplier layout,
    at its sorted indices."""
    dev = uniq.device
    bits = ((uniq[:, None] >> torch.arange(q, device=dev)) & 1)
    deg = bits.sum(dim=1)
    idx = torch.argsort(1 - bits, dim=1, stable=True)[:, :4]
    if idx.shape[1] < 4:
        idx = torch.nn.functional.pad(idx, (0, 4 - idx.shape[1]))
    idx = torch.where(torch.arange(4, device=dev)[None, :] < deg[:, None],
                      idx, 0)
    i, j, k, l_ = idx.unbind(1)
    off = [0, 1, 1 + q, 1 + q + q ** 2, 1 + q + q ** 2 + q ** 3]
    pos = torch.zeros_like(deg)
    pos = torch.where(deg == 1, off[1] + i, pos)
    pos = torch.where(deg == 2, off[2] + i * q + j, pos)
    pos = torch.where(deg == 3, off[3] + (i * q + j) * q + k, pos)
    pos = torch.where(deg == 4, off[4] + ((i * q + j) * q + k) * q + l_,
                      pos)
    return pos


def judge(instance, result, device) -> dict:
    """Readings of one returned answer (``result.X`` (n~, n~), ``Y``
    (p, n~), ``y`` flat, ``obj``) against the raw (Q, e, q)."""
    Q, e, q = instance
    bad = dict(eta=INF, pinf=INF, dinf=INF, gap=INF, sos_res=INF,
               bound_rel=INF, y_rel=INF)
    n = 2 + q + q * q
    flat = 1 + q + q ** 2 + q ** 3 + q ** 4
    f64 = dict(dtype=torch.float64, device=device)
    if result.X is None or result.y is None or \
            np.shape(result.X) != (n, n) or np.shape(result.Y)[-1] != n or \
            np.size(result.y) != flat:
        return bad
    uniq, inv = classes(q, device)
    inv = inv.reshape(-1)
    K = uniq.shape[0]
    b = coefficients(Q, e, uniq)
    obj = float(result.obj)

    # the SOS certificate
    X = torch.as_tensor(np.asarray(result.X, dtype=np.float64), **f64)
    a = torch.zeros(K, **f64).index_add_(0, inv, X.reshape(-1))
    rest = torch.arange(K, device=device) != 0       # uniq[0] is mask 0
    s = float(torch.dot(a[rest], b[rest]) / torch.dot(b[rest], b[rest]))
    if not s > 0.0:
        return bad
    sos_res = float(torch.linalg.norm(a[rest] - s * b[rest])) / \
        (s * float(torch.linalg.norm(b)))
    mu = s * float(b[0]) - float(a[0])
    bound_rel = abs(mu / s - obj) / (1.0 + abs(obj))
    w = torch.linalg.eigvalsh(X)
    dinf = max(0.0, -float(w[0])) / (1.0 + abs(float(w[-1])))
    del X, w

    # the moment side
    Y = torch.as_tensor(np.asarray(result.Y, dtype=np.float64), **f64)
    S = (Y.T @ Y).reshape(-1)
    size = torch.bincount(inv, minlength=K).to(torch.float64)
    y = torch.zeros(K, **f64).index_add_(0, inv, S) / size
    pinf = float(torch.linalg.norm(y[inv] - S))
    del S
    by = s * float(torch.dot(b, y))
    so = s * obj
    gap = abs(so - by) / (1.0 + abs(so) + abs(by))
    yp = torch.as_tensor(np.asarray(result.y, dtype=np.float64).ravel(),
                         **f64)[flat_positions(uniq, q)]
    y_rel = float(torch.max(torch.abs(yp - y))) / \
        float(torch.max(torch.abs(y)))
    return dict(eta=max(pinf, dinf, gap), pinf=pinf, dinf=dinf, gap=gap,
                sos_res=sos_res, bound_rel=bound_rel, y_rel=y_rel)


class Answer:
    """An answer in the solver's result layout (X, Y, y, obj)."""

    def __init__(self, X, Y, y, obj, status=0, eta=0.0):
        self.X, self.Y, self.y, self.obj = X, Y, y, obj
        self.status, self.eta = status, eta


def rounded_f32(result) -> Answer:
    """The answer as a float32 computation would hold it at best: every
    returned number rounded to float32."""
    f32 = lambda a: np.asarray(a, dtype=np.float32).astype(np.float64)  # noqa: E731
    return Answer(f32(result.X), f32(result.Y), f32(result.y),
                  float(np.float32(result.obj)), result.status, result.eta)
