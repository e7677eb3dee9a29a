"""The benchmark's plain reference of the BQP moment primal
(portbench/reference/bqp_mom.py) against the port on the CPU: its rows,
cost and multiplier slots are the program's bqpmom rows, it judges the
port's solve_bqp_mom answers as the program judges them, the sign gauge
of the cell's traffic keeps the optimum, and a broken answer fails a
limit."""

from math import comb

import numpy as np
import pytest
import threadpoolctl
import torch

from manisdp_tpu_torch.frontends.moments import bqpmom
from manisdp_tpu_torch.ops.symmom import SymMomOp, dontcare_mask
from manisdp_tpu_torch.solvers.primal_mom import solve_bqp_mom
from portbench import registry, runner

CPU = torch.device("cpu")
REF = registry.reference("bqp_mom")
CONFIG = registry.config(registry.benchmark(), "bqp-mom")
LIMITS = CONFIG["limits"]


@pytest.fixture(autouse=True, scope="module")
def _one_cpu_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpoolctl.threadpool_limits(1):
        yield
    torch.set_num_threads(n)


def _instance(q, seed):
    rng = np.random.default_rng(seed)
    Q = rng.standard_normal((q, q))
    return (Q + Q.T) / 2, rng.standard_normal(q), q


def _solve(inst):
    return solve_bqp_mom(*inst, device="cpu", **CONFIG["options"])


_SOLVED = {}


def _solved(q, seed):
    if (q, seed) not in _SOLVED:
        inst = _instance(q, seed)
        _SOLVED[q, seed] = inst, _solve(inst)
    return _SOLVED[q, seed]


def _correct(inst, answer) -> bool:
    r = REF.judge(inst, answer, CPU)
    ok, _ = runner.verdict({k: r[v] for k, v in REF.NUMBERS.items()},
                           LIMITS)
    return ok


@pytest.mark.parametrize("q", [2, 3, 5, 8])
def test_sizes_are_the_programs(q):
    """The classes are the squarefree monomials of degree <= 4 and the
    rows those the program counts; every row has a slot of its own."""
    R = REF.relaxation(q, CPU)
    classes = torch.unique(R.mask[:, None] ^ R.mask[None, :]).numel()
    assert classes == REF.sizes(q)["classes"] == \
        1 + q + comb(q, 2) + comb(q, 3) + comb(q, 4)
    op = SymMomOp.build_bqpmom(*_instance(q, 0)[:2], q, device="cpu")
    assert R.n == op.n_orig == REF.sizes(q)["n"]
    assert R.n_rows == op.m_true == REF.sizes(q)["rows"]
    assert R.row_slots.numel() == R.n_rows
    # the two copies of each column are the program's
    assert np.array_equal(R.col.numpy(), op.dup0.numpy())
    assert np.array_equal(R.col2.numpy(), op.dup1.numpy())
    # the slots are the valid ones of the program's flat layout
    valid = np.flatnonzero(~dontcare_mask(q))
    assert np.array_equal(R.row_slots.numpy(), valid)


@pytest.mark.parametrize("q", [3, 4])
def test_rows_cost_and_adjoint_are_the_programs(q):
    """The rows are those of the port's rebuild of bqpmom.m (as a set of
    values on a random symmetric X), at the slots where K9's twin puts
    them; the cost is bqpmom's; mat(c - A'y) is the program's compressed
    dual slack."""
    Q, e, _ = _instance(q, q)
    rng = np.random.default_rng(10 + q)
    R = REF.relaxation(q, CPU)
    n = R.n
    X = rng.standard_normal((n, n))
    X = X + X.T
    data = bqpmom(q, Q, e)
    ax = R.apply(torch.as_tensor(X))
    np.testing.assert_allclose(np.sort(ax[R.row_slots].numpy()),
                               np.sort(data.At.T @ X.ravel(order="F")),
                               rtol=0, atol=1e-13)
    np.testing.assert_array_equal(R.cost(Q, e).numpy(),
                                  data.c.reshape(n, n, order="F"))
    op = SymMomOp.build_bqpmom(Q, e, q, device="cpu")
    expand = np.zeros(op.n, dtype=np.int64)
    expand[op.dup0.numpy()] = np.arange(n)
    expand[op.dup1.numpy()] = np.arange(n)
    flat = op.apply_from_e(torch.as_tensor(X[np.ix_(expand, expand)]))
    np.testing.assert_allclose(flat.numpy(), ax.numpy(), rtol=0, atol=1e-13)
    y = torch.as_tensor(rng.standard_normal(REF.flat_length(q)))
    y[torch.as_tensor(dontcare_mask(q))] = 0.0
    np.testing.assert_allclose(
        (R.cost(Q, e) - R.adjoint(y)).numpy(),
        op.compress_coef(op.s_vals(y)).numpy(), rtol=0, atol=1e-12)


@pytest.mark.parametrize("q,seed", [(5, 1), (8, 2)])
def test_judges_the_program_as_it_judges_itself(q, seed):
    inst, res = _solved(q, seed)
    assert res.status == 0 and res.eta <= CONFIG["tol"]
    r = REF.judge(inst, res, CPU)
    assert r["eta"] <= 1e-8
    assert abs(r["eta"] - res.eta) <= 1e-10
    for key in ("pinf", "dinf", "gap"):
        assert abs(r[key] - getattr(res, key)) <= 1e-10, key
    assert _correct(inst, res), r


def test_the_sign_gauge_keeps_the_optimum():
    """A problem and its copy in the traffic's sign gauge, each solved to
    status 0, give the same objective."""
    inst = _instance(7, 4)
    gauge = registry.generator("bqp_gauge")
    copy = gauge.vary(inst, np.random.default_rng(9))
    s = np.sign(copy[1] / inst[1])
    assert set(s) == {-1.0, 1.0}
    assert np.array_equal(copy[0], s[:, None] * inst[0] * s[None, :])
    a, b = _solve(inst), _solve(copy)
    assert a.status == 0 and b.status == 0
    assert abs(a.obj - b.obj) <= 1e-7 * max(1.0, abs(a.obj))


def test_faults_fail_a_limit():
    """The answer rounded to float32, another instance's multipliers, the
    first or the second copy of a column of Y perturbed, and another
    objective: each fails a limit."""
    inst, res = _solved(5, 1)
    assert _correct(inst, res)
    assert not _correct(inst, REF.rounded_f32(res))
    inst2 = _instance(5, 3)
    res2 = _solve(inst2)
    assert res2.status == 0
    assert not _correct(inst, REF.Answer(res.Y, res2.y, res.obj))
    Y = np.array(res.Y)
    Y[:, 2 + 5 + 1 * 5 + 3] *= 1.0 + 1e-6     # the first copy of x_1 x_3
    assert not _correct(inst, REF.Answer(Y, res.y, res.obj))
    Y = np.array(res.Y)
    Y[:, 2 + 5 + 3 * 5 + 1] *= 1.0 + 1e-6     # its second copy
    assert not _correct(inst, REF.Answer(Y, res.y, res.obj))
    assert not _correct(inst, REF.Answer(res.Y, res.y, res.obj + 1e-6))


def _run(options=None):
    cell = runner.Cell("bqp-mom.d60", traffic={"q": 6})
    if options:
        cell.config["options"] = dict(cell.config["options"], **options)
    return runner.run("bqp-mom.d60", 20260101, 0.5, False, device=CPU,
                      cell=cell, log=lambda msg: None)


def test_a_run_of_the_cell_is_correct():
    out = _run()
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert set(out["metrics"]) == {"instances_per_s", "setup_s"}


def test_a_step_returning_its_state_is_not_correct(monkeypatch):
    import manisdp_tpu_torch.solvers.primal_al as primal_al
    make = primal_al.make_trustregions

    def frozen(*a, **kw):
        solve = make(*a, **kw)

        def frozen_solve(Y, *args, **kwargs):
            return solve(Y, *args, **kwargs)._replace(Y=Y)
        return frozen_solve
    monkeypatch.setattr(primal_al, "make_trustregions", frozen)
    out = _run({"max_outer": 20})
    assert not out["correct"]
    assert out["checks"]["uncertified_share"]["value"] == 1.0
