"""Plain reference for the order-2 moment relaxation of a binary quadratic
program, min x'Qx + e'x over x in {-1, 1}^q, solved in the primal as
solve_bqp_mom returns it (ManiSDP-matlab example/example_bqp.m: bqpmom ->
ManiSDP_unitdiag).

The relaxation (bqpmom.m) is worked out again here from (Q, e, q).  X is
the moment matrix of the n = 1 + q + C(q, 2) squarefree monomials of
degree <= 2 in bqpmom.m's graded order [1, x_0 .. x_{q-1}, x_a x_b (a < b,
by b, then a)], diag(X) = 1 (the unit-diagonal manifold), X >= 0.  The
product of two basis monomials has a label, its exponent vector: power 2
at the indices both hold, 1 at those one holds.  On {-1, 1}^q a label's
value is that of the XOR of the two index sets, its class: a squarefree
monomial of degree <= 4.  The rows A(X) = b (b = 1 on the first row, 0
elsewhere), on a symmetric X:

- X[1, 1] = 1;
- (X[1, 1] - X[x_a, x_a]) / 2 for every a, and (X[x_a, x_a] -
  X[x_a x_b, x_a x_b]) / 2 for every pair monomial and each of its two
  variables;
- the substitution x_k^2 = 1: for every basis monomial m != 1 without
  x_k, min(n1, n2) (mean of X over label m x_k^2 - mean over label m),
  with n1, n2 the entries (both triangles) of the two labels;
- within a label of several entries u < v (basis order), the entry of
  the largest u (then of the smallest v) minus each other entry.

That is m = n(n+1)/2 - labels + q(n - 1) - n + 1 rows (the published
counting rule), with classes = 1 + q + C(q,2) + C(q,3) + C(q,4).  The cost
C: Q_aa on X[x_a, x_a], e_a / 2 on X[1, x_a], and Q_ab / 2 on each of the
label x_a x_b's two entries X[1, x_a x_b], X[x_a, x_b], both triangles.

The answer is judged in the solver's output layout.  ``Y`` (p, n~) lives
on the expanded basis of n~ = 2 + q + q^2 columns [1, 1', x_a, then a
q x q grid whose slot (i, j) is x_i x_j for i != j and x_i for i == j],
in which every original column has two copies: the first (1: column 0,
x_a: column 2 + a, x_a x_b for a < b: column 2 + q + a q + b) and the
second (1': column 1, x_a: column 2 + q + a (q + 1), x_a x_b: column
2 + q + b q + a).  X = Yc'Yc is judged on each copy set Yc, and each
reading below is the worse of the two.  ``y`` is the flat per-family multiplier
layout of ops/symmom.py [r0 (1), D1 (q), D2 (q, q), SUBv (q, q), SUBp
(q, q, q), EQ2 (q, q), EQ4 (q, q, q), EQ6 (q, q, q, q)], read at each
row's slot: D1[a]; D2[a, b] for variable a of x_a x_b; SUBv[k, b] for
x_b, k; SUBp[k, b, c] for x_b x_c (b < c), k; EQ2[a, b] for label x_a x_b;
EQ4[s, t, c] for X[x_s, x_t x_c] in the label x_s x_t x_c (c the
largest); EQ6[i, j, k, l] for X[x_i x_j, x_k x_l] and EQ6[j, i, k, l] for
X[x_i x_k, x_j x_l] in the label x_i x_j x_k x_l (i < j < k < l).

Readings, as ManiSDP_unitdiag.m:65-69 defines them:

- pinf = |A(X) - b| / (1 + |b|);
- dinf = max(0, -lambda_min(S)) / (1 + |lambda_max(S)|) by a float64
  eigvalsh, S = mat(c - A'y) - Diag(z), z = colsum((mat(c - A'y)) o X);
- gap = |<C, X> - (b'y + sum z)| / (1 + |<C, X>| + |b'y + sum z|);
- eta = max(pinf, dinf, gap);
- obj_rel = |obj - <C, X>| / (1 + |<C, X>|): the returned objective must
  be the answer's;
- diag_err = max |diag(X) - 1|, the unit diagonal (read, not compared).

Plain torch only: nothing of the program is imported.
"""

from __future__ import annotations

from math import comb

import numpy as np
import torch

# obj_rel: the program reads <= 2.5e-16, the float32 control 3.3e-8.
# diag_err is read and not compared: at these instances the relaxation is
# tight and its rank-one answers are exact in float32, so the program and
# the control both read 0 and no limit lies between (PERF.md section 2)
NUMBERS = {"eta_max": "eta", "obj_rel_max": "obj_rel"}
INF = float("inf")
_STRUCT = {}


def flat_length(q: int) -> int:
    return 1 + q + 3 * q ** 2 + 2 * q ** 3 + q ** 4


def sizes(q: int) -> dict:
    """The relaxation's sizes by the published counting rule."""
    n = 1 + q + comb(q, 2)
    labels = (q + comb(q, 2) + q * (q - 1) + comb(q, 3)
              + q * comb(q - 1, 2) + comb(q, 4))
    classes = 1 + q + comb(q, 2) + comb(q, 3) + comb(q, 4)
    rows = n * (n + 1) // 2 - labels + q * (n - 1) - n + 1
    return dict(n=n, labels=labels, classes=classes, rows=rows,
                n_expanded=2 + q + q * q, flat=flat_length(q))


def _bits(masks, q: int, count: int):
    """The ``count`` lowest set bits of each mask, ascending (int64)."""
    out = [torch.full_like(masks, -1) for _ in range(count)]
    seen = torch.zeros_like(masks)
    for j in range(q):
        has = ((masks >> j) & 1).bool()
        for c in range(count):
            out[c] = torch.where(has & (seen == c), j, out[c])
        seen = seen + has.long()
    return out


class Relaxation:
    """bqpmom.m's basis, labels, rows and the rows' multiplier slots for one
    q on one device.  ``slot``, ``u``, ``v``, ``coef``: every nonzero of
    the rows, both triangles listed; A(X)[slot] = sum coef X[u, v] and
    (A'y)[u, v] = sum coef y[slot]."""

    def __init__(self, q: int, device):
        if q > 62:
            raise ValueError("the bitmask labels hold q <= 62")
        dev = torch.device(device)
        i64 = dict(dtype=torch.int64, device=dev)
        self.q, self.device = q, dev
        n = 1 + q + comb(q, 2)
        self.n = n
        ar = torch.arange(q, **i64)
        a_, b_ = torch.triu_indices(q, q, 1, device=dev)
        order = torch.argsort(b_ * q + a_)
        pa, pb = a_[order], b_[order]
        one = torch.zeros(1, **i64)
        bit = torch.ones(q, **i64) << ar
        self.mask = torch.cat([one, bit, bit[pa] | bit[pb]])
        self.lo = torch.cat([one - 1, ar, pa])
        self.hi = torch.cat([one - 1, ar, pb])
        deg = torch.cat([one, torch.ones(q, **i64),
                         torch.full((pa.numel(),), 2, **i64)])
        # first and second copy of each original column in the expanded
        # layout
        self.col = torch.cat([one, 2 + ar, 2 + q + pa * q + pb])
        self.col2 = torch.cat([one + 1, 2 + q + ar * (q + 1),
                               2 + q + pb * q + pa])
        off = np.cumsum([0, 1, q, q * q, q * q, q ** 3, q * q, q ** 3])
        D1, D2, SUBv, SUBp, EQ2, EQ4, EQ6 = (int(o) for o in off[1:])
        rows = []

        def add(slot, u, v, coef, both=True):
            coef = torch.as_tensor(coef, dtype=torch.float64, device=dev)
            coef = coef.expand(slot.shape)
            rows.append((slot, u, v, coef))
            if both:
                rows.append((slot, v, u, coef))

        # X[1, 1] = 1, and the equal diagonal
        add(one, one, one, 1.0, both=False)
        add(D1 + ar, one.expand(q), one.expand(q), 0.5, both=False)
        add(D1 + ar, 1 + ar, 1 + ar, -0.5, both=False)
        P = 1 + q + torch.arange(pa.numel(), **i64)
        for pos, other in ((pa, pb), (pb, pa)):
            slot = D2 + pos * q + other
            add(slot, 1 + pos, 1 + pos, 0.5, both=False)
            add(slot, P, P, -0.5, both=False)

        # the labels of the entries u < v
        u, v = torch.triu_indices(n, n, 1, device=dev)
        x = self.mask[u] ^ self.mask[v]
        a = self.mask[u] & self.mask[v]
        lab, inv, cnt = torch.unique(torch.stack([x, a], 1), dim=0,
                                     return_inverse=True, return_counts=True)
        L = lab.shape[0]
        pdeg = deg[u] + deg[v] - 2 * (a != 0).long()
        ldeg = torch.zeros(L, **i64).scatter_(0, inv, pdeg)

        # equality within a label: the entry of the largest u, then the
        # smallest v, minus each other
        rank = u * n + (n - 1 - v)
        best = torch.full((L,), -1, **i64).scatter_reduce(
            0, inv, rank, "amax")
        rest = rank != best[inv]
        eu, ev, el = u[rest], v[rest], inv[rest]
        ru, rv = best[el] // n, n - 1 - best[el] % n
        if bool(torch.any(lab[el, 1] != 0)):
            raise AssertionError("a label with a square has two entries")
        d = ldeg[el]
        A, B, Cc, D = self.lo[eu], self.hi[eu], self.lo[ev], self.hi[ev]
        slot = torch.where(
            d == 2, EQ2 + Cc * q + D,
            torch.where(d == 3, EQ4 + (A * q + Cc) * q + D,
                        EQ6 + torch.where(
                            B < Cc, ((A * q + B) * q + Cc) * q + D,
                            ((Cc * q + A) * q + B) * q + D)))
        if bool(torch.any((d < 2) | (d > 4))):
            raise AssertionError("an equality row outside degrees 2 to 4")
        add(slot, ru, rv, 0.5)
        add(slot, eu, ev, -0.5)
        self.n_equal = int(eu.numel())

        # substitution x_k^2 = 1: label m x_k^2 (t1) against label m (t2)
        perm = torch.argsort(inv, stable=True)
        start = torch.cumsum(cnt, 0) - cnt
        t1 = torch.nonzero(lab[:, 1] != 0).ravel()
        plain = torch.nonzero(lab[:, 1] == 0).ravel()   # sorted by x
        at = torch.searchsorted(lab[plain, 0], lab[t1, 0])
        t2 = plain[at]
        if not torch.equal(lab[t2, 0], lab[t1, 0]):
            raise AssertionError("a substitution label without its base")
        (k,) = _bits(lab[t1, 1], q, 1)
        b1, c1_ = _bits(lab[t1, 0], q, 2)
        dx = ldeg[t1]
        slot = torch.where(dx == 1, SUBv + k * q + b1,
                           SUBp + (k * q + b1) * q + c1_)
        n1, n2 = cnt[t1].double(), cnt[t2].double()
        w1 = torch.where(n1 < n2, 1.0, n2 / n1)
        w2 = torch.where(n1 < n2, n1 / n2, 1.0)
        for t, w in ((t1, w1), (t2, -w2)):
            for j in range(int(cnt[t].max())):
                has = j < cnt[t]
                p = perm[start[t[has]] + j]
                add(slot[has], u[p], v[p], w[has])
        self.n_subst = int(t1.numel())

        self.slot = torch.cat([r[0] for r in rows])
        self.u = torch.cat([r[1] for r in rows])
        self.v = torch.cat([r[2] for r in rows])
        self.coef = torch.cat([r[3] for r in rows])
        self.row_slots = torch.unique(self.slot)
        self.n_rows = 1 + q + 2 * pa.numel() + self.n_subst + self.n_equal

        # the cost lives on the labels x_a and x_a x_b
        self._labels = (x, a, inv, cnt, u, v, ldeg)

    def cost(self, Q, e) -> torch.Tensor:
        """C (n, n) float64 from the raw Q and e (bqpmom.m:93-114)."""
        q, n, dev = self.q, self.n, self.device
        f64 = dict(dtype=torch.float64, device=dev)
        Qt = torch.as_tensor(np.asarray(Q, dtype=np.float64), **f64)
        et = torch.as_tensor(np.asarray(e, dtype=np.float64).ravel(), **f64)
        x, a, inv, cnt, u, v, ldeg = self._labels
        C = torch.zeros((n, n), **f64)
        d = 1 + torch.arange(q, device=dev)
        C[d, d] = torch.diagonal(Qt)
        pdeg = ldeg[inv]
        lin = (a == 0) & (pdeg == 1)
        quad = (a == 0) & (pdeg == 2)
        (i1,) = _bits(x[lin], q, 1)
        val = torch.zeros(u.shape, **f64)
        val[lin] = et[i1] / (2.0 * cnt[inv[lin]])
        i2, j2 = _bits(x[quad], q, 2)
        val[quad] = Qt[i2, j2] / cnt[inv[quad]]
        keep = lin | quad
        C.index_put_((u[keep], v[keep]), val[keep], accumulate=True)
        C.index_put_((v[keep], u[keep]), val[keep], accumulate=True)
        return C

    def apply(self, X) -> torch.Tensor:
        """A(X) in the flat layout (zero at slots that hold no row)."""
        out = torch.zeros(flat_length(self.q), dtype=torch.float64,
                          device=self.device)
        return out.index_add_(0, self.slot, self.coef * X[self.u, self.v])

    def adjoint(self, y) -> torch.Tensor:
        """mat(A'y) (n, n), y read at the rows' slots only."""
        n = self.n
        out = torch.zeros(n * n, dtype=torch.float64, device=self.device)
        out.index_add_(0, self.u * n + self.v, self.coef * y[self.slot])
        return out.reshape(n, n)


def relaxation(q: int, device) -> Relaxation:
    key = (int(q), str(torch.device(device)))
    if key not in _STRUCT:
        _STRUCT.clear()
        _STRUCT[key] = Relaxation(int(q), device)
    return _STRUCT[key]


def _finite(x: float) -> float:
    return x if np.isfinite(x) else INF


def _readings(R, Y, cols, C, y, obj) -> dict:
    """The readings of X = Yc'Yc, Yc the columns ``cols`` of Y."""
    Yc = Y[:, cols]
    X = Yc.T @ Yc
    del Yc
    diag_err = float(torch.max(torch.abs(torch.diagonal(X) - 1.0)))
    r = R.apply(X)
    r[0] -= 1.0
    pinf = float(torch.linalg.norm(r)) / 2.0
    del r
    cx = float(torch.sum(C * X))
    S = C - R.adjoint(y)
    z = torch.sum(S * X, dim=0)
    S = S - torch.diag(z)
    S = 0.5 * (S + S.T)
    w = torch.linalg.eigvalsh(S)
    dinf = max(0.0, -float(w[0])) / (1.0 + abs(float(w[-1])))
    by = float(y[0]) + float(torch.sum(z))
    gap = abs(cx - by) / (1.0 + abs(cx) + abs(by))
    obj_rel = abs(float(obj) - cx) / (1.0 + abs(cx))
    out = dict(pinf=pinf, dinf=dinf, gap=gap, obj_rel=obj_rel,
               diag_err=diag_err)
    return {k: _finite(float(val)) for k, val in out.items()}


def judge(instance, result, device) -> dict:
    """Readings of one returned answer (``result.Y`` (p, n~), ``y`` flat,
    ``obj``) against the raw (Q, e, q): each the worse of the readings
    of the first copies' X and of the second copies'."""
    Q, e, q = instance
    bad = dict(eta=INF, pinf=INF, dinf=INF, gap=INF, obj_rel=INF,
               diag_err=INF)
    sz = sizes(q)
    if result.Y is None or result.y is None or \
            np.ndim(result.Y) != 2 or \
            np.shape(result.Y)[-1] != sz["n_expanded"] or \
            np.size(result.y) != sz["flat"]:
        return bad
    R = relaxation(q, device)
    f64 = dict(dtype=torch.float64, device=R.device)
    Y = torch.as_tensor(np.asarray(result.Y, dtype=np.float64), **f64)
    y = torch.as_tensor(np.asarray(result.y, dtype=np.float64).ravel(),
                        **f64)
    C = R.cost(Q, e)
    first, second = (_readings(R, Y, cols, C, y, result.obj)
                     for cols in (R.col, R.col2))
    out = {k: max(first[k], second[k]) for k in first}
    out["eta"] = max(out["pinf"], out["dinf"], out["gap"])
    return out


class Answer:
    """An answer in the solver's result layout (Y, y, obj)."""

    def __init__(self, Y, y, obj, status=0, eta=0.0):
        self.Y, self.y, self.obj = Y, y, obj
        self.status, self.eta = status, eta


def rounded_f32(result) -> Answer:
    """The answer as a float32 computation would hold it at best: every
    returned number rounded to float32."""
    f32 = lambda a: np.asarray(a, dtype=np.float32).astype(np.float64)  # noqa: E731
    return Answer(f32(result.Y), f32(result.y), float(np.float32(result.obj)),
                  result.status, result.eta)
