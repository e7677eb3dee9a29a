"""The references' residuals are near zero on tiny instances solved by
their own plain code, reject a perturbed answer, and reject the control:
the same answers held in float32."""

import itertools

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from portbench import registry, runner

CPU = torch.device("cpu")


def _maxcut(n, seed):
    rng = np.random.default_rng(seed)
    W = np.triu(rng.standard_normal((n, n)), 1)
    W = W + W.T
    return sp.csr_matrix(-0.25 * (np.diag(W.sum(1)) - W))


@pytest.mark.parametrize("n,p", [(8, 8), (12, 6)])
def test_maxcut_plain_solve_is_certified(n, p):
    ref = registry.reference("maxcut")
    limits = registry.config(registry.benchmark(), "maxcut")["limits"]
    C = _maxcut(n, n)
    ans = ref.solve_plain([C], p, torch.float64, 20000, 0, CPU)[0]
    r = ref.judge(C, ans, CPU)
    assert r["eta"] <= 1e-12 and r["z_rel"] <= 1e-13
    # a perturbed factor, a wrong objective, wrong multipliers
    Yp = ans.Y.copy()
    Yp[0, 0] += 1e-6
    zp = ans.z.copy()
    zp[1] += 1e-6
    for bad in (ref.Answer(Yp, ans.z, ans.obj),
                ref.Answer(ans.Y, ans.z, ans.obj * (1 + 1e-6)),
                ref.Answer(ans.Y, zp, ans.obj)):
        assert ref.judge(C, bad, CPU)["eta"] > limits["eta_max"]
    # the control: the solver in float32, and the answer rounded to f32
    assert ans.status == 0
    plain32 = ref.solve_plain([C], p, torch.float32, 20000, 0, CPU)[0]
    assert plain32.status == 1          # its own f32 certificate fails
    for bad in (plain32, ref.rounded_f32(ans)):
        assert ref.judge(C, bad, CPU)["eta"] > limits["eta_max"]


def _bqp_certified(Q, e):
    """A certified answer at q = 2, by enumeration: the basis [1, x0, x1,
    x0 x1] spans every function on {-1, 1}^2, so f - min f is the sum of
    (f(x') - min f) times the square of the indicator of x'."""
    q = 2
    pts = [np.array(x, dtype=float) for x in itertools.product((-1, 1),
                                                              repeat=q)]
    f = [x @ Q @ x + e @ x for x in pts]
    lam = min(f)
    xs = pts[int(np.argmin(f))]
    X = np.zeros((4, 4))
    for x, fx in zip(pts, f):
        h = np.array([1.0, x[0], x[1], x[0] * x[1]]) / 4.0
        X += (fx - lam) * np.outer(h, h)
    # the expanded basis [1, 1', x0, x1, x0', x0 x1, x1 x0, x1']: columns
    # that copy original monomials 0, 0, 1, 2, 1, 3, 3, 2
    L = np.zeros((8, 4))
    L[np.arange(8), [0, 0, 1, 2, 1, 3, 3, 2]] = 1.0
    Xt = L @ X @ L.T / 4.0
    v = L @ np.array([1.0, xs[0], xs[1], xs[0] * xs[1]])
    y = np.zeros(1 + q + q ** 2 + q ** 3 + q ** 4)
    y[0] = 1.0
    y[1:3] = xs
    y[3 + 1] = y[3 + 2] = xs[0] * xs[1]        # Y2[0, 1], Y2[1, 0]
    ref = registry.reference("bqp_sos")
    return ref.Answer(Xt, v[None, :], y, lam), lam


def test_bqp_certificate_by_enumeration():
    ref = registry.reference("bqp_sos")
    limits = registry.config(registry.benchmark(), "bqp-sos")["limits"]
    rng = np.random.default_rng(4)
    Q = rng.standard_normal((2, 2))
    Q = (Q + Q.T) / 2
    e = rng.standard_normal(2)
    ans, lam = _bqp_certified(Q, e)
    r = ref.judge((Q, e, 2), ans, CPU)
    assert max(r.values()) <= 1e-14, r
    # a scaled certificate (the solver's normalisation) is as good
    scaled = ref.Answer(ans.X / 7.0, ans.Y, ans.y, lam)
    assert max(ref.judge((Q, e, 2), scaled, CPU).values()) <= 1e-14
    bad = [ref.Answer(ans.X, ans.Y, ans.y, lam + 1e-6),           # bound
           ref.Answer(ans.X + 1e-6 * np.eye(8)[::-1], ans.Y, ans.y,
                      lam),                                        # Gram
           ref.Answer(ans.X, ans.Y * (1 + 1e-6 * np.arange(8)), ans.y,
                      lam)]                                        # factor
    for b in bad:
        _, checks = runner.verdict(
            {k: ref.judge((Q, e, 2), b, CPU)[v]
             for k, v in ref.NUMBERS.items()}, limits)
        assert any(c["value"] > c["limit"] for c in checks.values())
    y_bad = ans.y.copy()
    y_bad[1] += 1e-6
    assert ref.judge((Q, e, 2), ref.Answer(ans.X, ans.Y, y_bad, lam),
                     CPU)["y_rel"] > 0.5e-6


def test_bqp_program_answer_and_its_control():
    """The program's answer at q = 6 on the CPU passes; the same answer
    rounded to float32 (the control) fails."""
    cell = runner.Cell("bqp-sos.d60", traffic={"q": 6})
    limits = cell.config["limits"]
    inst = cell.instances(11, 0, 0)
    res = cell.solve(cell.entry(), inst, CPU)[0]
    ref = cell.reference
    good = ref.judge(inst[0], res, CPU)
    ok, _ = runner.verdict({k: good[v] for k, v in ref.NUMBERS.items()},
                           limits)
    assert ok, good
    bad = ref.judge(inst[0], ref.rounded_f32(res), CPU)
    ok, _ = runner.verdict({k: bad[v] for k, v in ref.NUMBERS.items()},
                           limits)
    assert not ok, bad


@pytest.mark.parametrize("name,traffic,per", [
    ("maxcut.g1-b64", {"n": 40, "m": 120}, 4),
    ("maxcut.torus3k-b16", {"rows": 6, "cols": 5}, 4),
    ("bqp-sos.d60", {"q": 6}, 1)])
def test_control_comes_out_not_correct(name, traffic, per):
    """portbench/control.py's readings at a test size: the program's
    answers pass, every control fails."""
    from portbench import control
    cell = runner.Cell(name, traffic=traffic)
    cell.traffic["instances_per_call"] = per
    out = control.seed_readings(cell, cell.entry(), 2 ** 33 + 5, 1, 3000,
                                CPU)
    assert out["program"]["correct"], out["program"]
    kinds = [k for k in out if k.startswith("control_")]
    assert kinds and not any(out[k]["correct"] for k in kinds), out
