"""The port's solve_bqp_mom (the primal moment path on SymMomOp: kernels
K9 / K10 through their plain twins, K8's sym_factor as the symmetrize hook,
the compressed dense certificate) against the JAX package's, from the same
Y0, on test_primal_mom.py's cases; and against the port's own SOS dual,
the other side of the same relaxation pair."""

import numpy as np
import pytest
import threadpoolctl
import torch

from manisdp_tpu.solvers.primal_mom import solve_bqp_mom as jax_solve_bqp_mom
from manisdp_tpu_torch.solvers import primal_mom
from manisdp_tpu_torch.solvers.dual_unitdiag import solve_bqp_sos_dual
from manisdp_tpu_torch.solvers.primal_mom import solve_bqp_mom


@pytest.fixture(autouse=True, scope="module")
def _one_cpu_thread():
    """Torch and BLAS on one thread for this module: the parallel test run
    puts several workers on the CPU, and their thread pools then
    oversubscribe it, so the solvers' many small ops and LAPACK calls spin
    (a 1 s multiblock solve took minutes)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpoolctl.threadpool_limits(1):
        yield
    torch.set_num_threads(n)


CASES = [(6, 0), (8, 3)]
KW = dict(verbose=False, max_outer=200)


def _instance(q, seed):
    rng = np.random.default_rng(seed)
    Q = rng.standard_normal((q, q))
    return (Q + Q.T) / 2, rng.standard_normal(q)


def _y0(q):
    """A (2, n~) factor with unit columns, the reference's p0 = 2."""
    Y0 = np.random.default_rng(100 + q).standard_normal((2, 2 + q + q * q))
    return Y0 / np.linalg.norm(Y0, axis=0)


@pytest.fixture(scope="module")
def solves():
    """Both packages' solves of every case, run once for the module."""
    out = {}
    for q, seed in CASES:
        Q, e = _instance(q, seed)
        out[q, seed] = (jax_solve_bqp_mom(Q, e, q, Y0=_y0(q), **KW),
                        solve_bqp_mom(Q, e, q, Y0=_y0(q), device="cpu",
                                      **KW))
    return out


@pytest.mark.parametrize("q,seed", CASES)
def test_matches_jax_from_the_same_y0(solves, q, seed):
    jr, tr = solves[q, seed]
    assert jr.status == 0 and tr.status == 0
    assert tr.eta <= 1e-8
    assert abs(tr.obj - jr.obj) <= 1e-7 * max(1.0, abs(jr.obj))


@pytest.mark.parametrize("q,seed", CASES)
def test_follows_the_jax_trajectory(solves, q, seed):
    """The symmetrize hook runs at the JAX package's three sites (initial
    factor, every inner solve, the rebuilt factor and escape direction):
    dropping one still converges, but leaves the reference trajectory,
    which the ranks and objectives of the early outer iterations show."""
    jr, tr = solves[q, seed]
    head = 8
    jo = np.array([h["obj"] for h in jr.history[:head]])
    to = np.array([h["obj"] for h in tr.history[:head]])
    np.testing.assert_allclose(to, jo, rtol=1e-6)
    # the ranks agree through the seventh outer iteration; the eighth's is
    # the escape count of the seventh certificate (the compressed f32
    # eigh), which may differ only where its bottom eigenvalue sits within
    # f32 rounding of zero in both packages
    assert tr.fac_size[:head - 1] == jr.fac_size[:head - 1]
    if tr.fac_size[head - 1] != jr.fac_size[head - 1]:
        dt, dj = (r.history[head - 2]["dinf"] for r in (tr, jr))
        print(f"margin: iteration {head - 1} dinf {dt:.3e} / {dj:.3e}")
        assert max(dt, dj) <= 1e-6


def test_primal_equals_the_ports_sos_dual(solves):
    """The order-2 bqpmom primal and the bqpsos dual are a dual pair: the
    port's two expanded-basis solvers reach the same optimum."""
    q, seed = CASES[1]
    Q, e = _instance(q, seed)
    rd = solve_bqp_sos_dual(Q, e, q, device="cpu", verbose=False)
    tr = solves[q, seed][1]
    assert rd.status == 0
    assert abs(rd.obj - tr.obj) <= 1e-7 * max(1.0, abs(tr.obj))


def test_maps_the_reference_parameters(monkeypatch):
    """tau1 / tau2 scale by sqrt(2), tolgradnorm by 1 / sqrt(2), p0 = 2,
    as in the JAX package; an explicit override wins."""
    seen = []
    monkeypatch.setattr(primal_mom, "solve_primal_al",
                        lambda name, op, options, **kw: seen.append(
                            (name, op, kw)))
    Q, e = _instance(4, 1)
    solve_bqp_mom(Q, e, 4, device="cpu", tau2=3.0)
    (name, op, kw), = seen
    s2 = np.sqrt(2.0)
    assert name == "unitdiag" and op.q == 4 and op.n == 22
    d = primal_mom.VARIANT_DEFAULTS["unitdiag"]
    assert kw["tau1"] == pytest.approx(s2 * d["tau1"])
    assert kw["tau2"] == 3.0
    assert kw["tolgradnorm"] == pytest.approx(1e-8 / s2)
    assert kw["p0"] == 2


def test_the_rtr_frees_each_step_before_the_next(monkeypatch):
    """When the RTR evaluates a trial point, the accepted point's residuals
    are the only earlier ones live, and when it forms a gradient no
    earlier gradient's carrier is: a rejected step leaves nothing behind,
    so the solve's peak memory does not depend on which steps were
    rejected or at what factor size."""
    import weakref

    from manisdp_tpu_torch.solvers import primal_al
    make = primal_al._make_problem
    made = {"cost": [], "grad": []}
    live = {"cost": [], "grad": []}

    def count(kind):
        live[kind].append(sum(r() is not None for r in made[kind]))

    def tracked(variant):
        problem, cost_only = make(variant)

        def cost(Y, params):
            count("cost")
            f, aux = problem.cost(Y, params)
            made["cost"].append(weakref.ref(aux[0]))
            return f, aux

        def grad(Y, params, aux):
            count("grad")
            g, gaux = problem.grad(Y, params, aux)
            made["grad"].append(weakref.ref(gaux[0]))
            return g, gaux
        return primal_al.Problem(manifold=problem.manifold, cost=cost,
                                 grad=grad, hess=problem.hess), cost_only

    monkeypatch.setattr(primal_al, "_make_problem", tracked)
    Q, e = _instance(6, 0)
    res = solve_bqp_mom(Q, e, 6, Y0=_y0(6), device="cpu", **KW)
    assert res.status == 0
    # the RTR took more than one step a solve, so both checks were reached
    assert len(live["cost"]) > 2 * len(res.fac_size)
    assert max(live["cost"]) == 1
    assert max(live["grad"]) == 0
