"""The port's batched MaxCut path on the CPU (plain twins) against the JAX
package's solvers/batch.py: the batched SymCOO (K1's instance mode), the
batched RTR and line search from the same explicit inputs, whole solves,
and K11's twin against the formulas of the JAX tCG body."""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import threadpoolctl
import torch

import chip_smoke
from manisdp_tpu import solve_maxcut_batch as j_batch
from manisdp_tpu.config import merged_options as j_merged
from manisdp_tpu.ops.sparse import SymCOO as JSymCOO
from manisdp_tpu.solvers.batch import _batched_fns, _pad_sym_coo
from manisdp_tpu_torch import kernels as K
from manisdp_tpu_torch import solve_maxcut_batch
from manisdp_tpu_torch.core import (TROptions, make_batched_trustregions,
                                    make_trustregions)
from manisdp_tpu_torch.manifolds import Oblique
from manisdp_tpu_torch.manifolds.product import MaskedProduct
from manisdp_tpu_torch.ops.sparse import BatchedSymCOO
from manisdp_tpu_torch.solvers.common import make_batched_line_search
from manisdp_tpu_torch.solvers.maxcut import make_maxcut_problem
from test_batch import random_sparse_cost, random_sym_cost


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


N_PAD = 32
TR = dict(maxiter=40, maxinner=100, tolgradnorm=1e-8)


def _rel(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    return np.max(np.abs(got - ref)) / max(np.max(np.abs(ref)), 1e-300)


def _y0(B, p, p_pad, n, seed):
    """Column-normalized factors, zero padding rows, random unit padding
    columns (as the drivers start them)."""
    rs = np.random.RandomState(seed)
    Y = np.zeros((B, p_pad, n))
    for b in range(B):
        y = rs.randn(p, n)
        Y[b, :p] = y / np.linalg.norm(y, axis=0)
    return Y


def _dense_costs(Cs, n_pad):
    out = np.zeros((len(Cs), n_pad, n_pad))
    for b, C in enumerate(Cs):
        Cb = C.toarray() if sp.issparse(C) else np.asarray(C, float)
        out[b, :C.shape[0], :C.shape[0]] = 0.5 * (Cb + Cb.T)
    return out


def _jax_sparse(Cs, n_pad):
    """The JAX package's padded SymCOO batch (solvers/batch.py:160-171)."""
    nnz_pad = max(sp.coo_matrix(C).nnz for C in Cs)
    arrs = [_pad_sym_coo(C, n_pad, nnz_pad) for C in Cs]
    ii, jj, vv = (np.stack([a[k] for a in arrs]) for k in range(3))
    return JSymCOO(i=jnp.asarray(ii), j=jnp.asarray(jj), v=jnp.asarray(vv),
                   n=n_pad)


def _instances(dense):
    """Dense: three n = 24 instances padded to 32; sparse: two ragged ones
    (n = 20, 26) in a bucket of 32; and the seed of their Y0 (rank 3).

    Equal tCG iteration counts are a knife-edge comparison: the kappa
    stop compares a residual norm with its target, so a last-bit change
    of summation order can move it by one iteration, and a long RTR run
    (rank 6 at n = 20 took 400+ tCG iterations) amplifies that into
    another trajectory; the port's own dense and sparse single solves then
    differ as much as either does from JAX.  These inputs are ones where
    the JAX package's and the port's single-instance solves take equal
    counts, so a difference here is one of the batch."""
    if dense:
        return [random_sym_cost(24, s) for s in range(3)], 11
    return [random_sparse_cost(20, 1), random_sparse_cost(26, 2)], 12


def _params(Cs, dense):
    """(JAX C_param, port C_param) of one bucket."""
    if dense:
        Cd = _dense_costs(Cs, N_PAD)
        return jnp.asarray(Cd), torch.tensor(Cd)
    return _jax_sparse(Cs, N_PAD), BatchedSymCOO.from_scipy(Cs, N_PAD, "cpu")


# ----------------------------------------------------------- operators --

def test_batched_symcoo_matches_jax():
    """K1's twin in instance mode: per-instance Y·C_b, the cost and z equal
    the JAX package's vmap over its padded SymCOO batch."""
    Cs = [random_sparse_cost(20, 1), random_sparse_cost(26, 2)]
    jC, tC = _params(Cs, dense=False)
    Y = _y0(2, 6, 8, N_PAD, seed=5)
    jY, tY = jnp.asarray(Y), torch.tensor(Y)
    import jax
    jYC = jax.vmap(lambda Yb, Cb: Cb.matmat(Yb))(jY, jC)
    jz = jax.vmap(lambda Yb, Cb: Cb.quad_cols(Yb))(jY, jC)
    tYC = K.symcoo_spmm(tY, tC, "plain")
    tYC2, tz = K.symcoo_spmm(tY, tC, "cost")
    assert _rel(tYC, jYC) <= 1e-12 and _rel(tYC2, jYC) <= 1e-12
    assert _rel(tz, jz) <= 1e-12
    f, _ = make_maxcut_problem(False).cost(tY, tC)
    np.testing.assert_allclose(f.numpy(), 0.5 * np.asarray(jz).sum(1),
                               rtol=1e-12)
    # padding columns have empty segments: their products are exactly 0
    assert not torch.any(tYC[0, :, 20:]) and not torch.any(tYC[1, :, 26:])
    # the per-instance column pointer counts only the instance's entries
    for b, C in enumerate(Cs):
        nnz = sp.coo_matrix(0.5 * (C + C.T)).nnz
        assert int(tC.colptr[b, -1]) == nnz
    assert int(tC.eoff[1]) == int(tC.colptr[0, -1])


def test_batched_symcoo_select_keeps_each_instance():
    """A subset of a BatchedSymCOO, out of order: each kept instance's K1
    products (``plain``, ``cost``, ``hess``) equal those of instance(b) of
    the whole batch, and the entry arrays hold only the kept entries."""
    Cs = [random_sparse_cost(20, 1), random_sparse_cost(26, 2),
          random_sparse_cost(18, 7), random_sparse_cost(30, 4)]
    _, tC = _params(Cs, dense=False)
    keep = [3, 0, 2]
    sub = tC.select(keep)
    assert sub.nb == 3 and sub.n == tC.n
    assert sub.i.shape[0] == sum(int(tC.colptr[b, -1]) for b in keep)
    Y = torch.tensor(_y0(3, 6, 8, N_PAD, seed=8))
    U = Oblique.proj(Y, torch.tensor(_y0(3, 6, 8, N_PAD, seed=9)))
    YC = K.symcoo_spmm(Y, sub, "plain")
    YC2, eG = K.symcoo_spmm(Y, sub, "cost")
    H = K.symcoo_spmm(U, sub, "hess", B=Y, eG=eG)
    for k, b in enumerate(keep):
        Cb = tC.instance(b)
        assert torch.equal(sub.instance(k).colptr, Cb.colptr)
        assert torch.equal(YC[k], K.symcoo_spmm(Y[k], Cb, "plain"))
        ref, eGb = K.symcoo_spmm(Y[k], Cb, "cost")
        assert torch.equal(YC2[k], ref) and torch.equal(eG[k], eGb)
        assert torch.equal(H[k], K.symcoo_spmm(U[k], Cb, "hess", B=Y[k],
                                               eG=eGb))


def test_batched_hess_twin_is_the_per_instance_hessian():
    Cs, _ = _instances(dense=False)
    _, tC = _params(Cs, dense=False)
    Y = torch.tensor(_y0(2, 6, 8, N_PAD, seed=6))
    U = Oblique.proj(Y, torch.tensor(_y0(2, 6, 8, N_PAD, seed=7)))
    _, eG = K.symcoo_spmm(Y, tC, "cost")
    H = K.symcoo_spmm(U, tC, "hess", B=Y, eG=eG)
    for b in range(2):
        Cb = tC.instance(b)
        ref = K.symcoo_spmm(U[b], Cb, "hess", B=Y[b],
                            eG=K.symcoo_spmm(Y[b], Cb, "cost")[1])
        assert torch.equal(H[b], ref)


# ----------------------------------------------------------------- RTR --

@pytest.mark.parametrize("dense", [True, False], ids=["dense", "sparse"])
def test_batched_rtr_matches_jax(dense):
    """The batched RTR against the JAX package's vmapped solve
    (_batched_fns(opt, dense)[0]) from one explicit Y0: Y, fx and the
    gradient norm to 1e-9, equal TR and tCG iteration counts per
    instance."""
    Cs, seed = _instances(dense)
    B = len(Cs)
    jC, tC = _params(Cs, dense)
    Y0 = _y0(B, 3, 8, N_PAD, seed)
    td = float(np.pi * np.sqrt(N_PAD))
    vsolve = _batched_fns(j_merged("maxcut_unitdiag", None), dense)[0]
    jr = vsolve(jnp.asarray(Y0), jC, td)
    tr = make_batched_trustregions(make_maxcut_problem(dense),
                                   TROptions(**TR))(torch.tensor(Y0), tC, td)
    assert _rel(tr.Y, jr.Y) <= 1e-9
    assert _rel(tr.fx, jr.fx) <= 1e-9
    np.testing.assert_allclose(tr.norm_grad.numpy(), np.asarray(jr.norm_grad),
                               rtol=0, atol=1e-9)
    np.testing.assert_array_equal(tr.iters, np.asarray(jr.iters))
    np.testing.assert_array_equal(tr.inner_iters, np.asarray(jr.inner_iters))


@pytest.mark.parametrize("dense", [True, False], ids=["dense", "sparse"])
def test_batched_rtr_matches_single_instances(dense):
    """Each instance of the batched RTR follows the port's single-instance
    RTR from the same Y0_b: an instance that stops early is left as it is
    while the others go on."""
    Cs, seed = _instances(dense)
    _, tC = _params(Cs, dense)
    Y0 = torch.tensor(_y0(len(Cs), 3, 8, N_PAD, seed))
    td = float(np.pi * np.sqrt(N_PAD))
    problem = make_maxcut_problem(dense)
    br = make_batched_trustregions(problem, TROptions(**TR))(Y0, tC, td)
    single = make_trustregions(problem, TROptions(**TR))
    for b in range(len(Cs)):
        sr = single(Y0[b], tC[b] if dense else tC.instance(b), td)
        assert _rel(br.Y[b], sr.Y) <= 1e-12
        assert abs(float(br.fx[b]) - float(sr.fx)) <= 1e-12 * abs(
            float(sr.fx))
        assert (br.iters[b], br.inner_iters[b]) == (sr.iters, sr.inner_iters)


def test_batched_rtr_leaves_converged_instances_alone():
    """An instance that starts below tolgradnorm is never touched, and one
    with maxiter reached runs exactly maxiter iterations."""
    Cs, seed = _instances(dense=True)
    _, tC = _params(Cs, dense=True)
    td = float(np.pi * np.sqrt(N_PAD))
    problem = make_maxcut_problem(True)
    Y0 = torch.tensor(_y0(3, 3, 8, N_PAD, seed))
    solved = make_trustregions(problem, TROptions(**TR))(Y0[1], tC[1], td)
    Y0[1] = solved.Y
    br = make_batched_trustregions(problem, TROptions(
        maxiter=3, maxinner=100, tolgradnorm=1e-8))(Y0, tC, td)
    assert torch.equal(br.Y[1], Y0[1])
    assert (br.iters[1], br.inner_iters[1]) == (0, 0)
    assert br.iters[0] == br.iters[2] == 3


def test_batched_line_search_matches_jax():
    """The batched line search against the JAX package's vline from the
    same Y and escape direction U."""
    Cs, _ = _instances(dense=True)
    jC, tC = _params(Cs, dense=True)
    Y = _y0(3, 6, 8, N_PAD, seed=14)
    U = np.zeros_like(Y)
    U[:, 6:] = np.random.RandomState(15).randn(3, 2, N_PAD)
    vline = _batched_fns(j_merged("maxcut_unitdiag", None), True)[1]
    jY = vline(jnp.asarray(Y), jnp.asarray(U), jC)
    problem = make_maxcut_problem(True)
    ls = make_batched_line_search(lambda Yb, Cp: problem.cost(Yb, Cp)[0],
                                  Oblique.renormalize)
    tY = ls(torch.tensor(Y), torch.tensor(U), tC)
    assert _rel(tY, jY) <= 1e-12


# -------------------------------------------------------------- solves --

def _check_against_jax(Cs, tol, **kw):
    got = solve_maxcut_batch(Cs, tol=tol, verbose=False, device="cpu", **kw)
    ref = j_batch(Cs, tol=tol, verbose=False, **kw)
    assert len(got) == len(Cs)
    for b, C in enumerate(Cs):
        r = got[b]
        assert r.status == 0, f"instance {b} not optimal"
        assert r.dinf < 1e-7
        assert abs(r.obj - ref[b].obj) < 1e-5 * (1 + abs(ref[b].obj))
        n = C.shape[0]
        assert r.X.shape == (n, n)
        assert np.allclose(np.diag(r.X), 1.0, atol=1e-9)
    return got


def test_batch_matches_jax():
    """tests/test_batch.py::test_batch_matches_single's input."""
    _check_against_jax([random_sym_cost(24, s) for s in range(4)], 1e-7,
                       max_outer=40)


def test_batch_ragged_sizes_and_sparse_match_jax():
    """tests/test_batch.py::test_batch_ragged_sizes_and_sparse's input:
    two buckets, dense and sparse instances, n padding stripped."""
    Cs = [random_sym_cost(20, 0), random_sparse_cost(26, 1),
          random_sym_cost(33, 2), random_sparse_cost(20, 3)]
    _check_against_jax(Cs, 1e-7, max_outer=60, n_bucket=32)


def test_batch_forced_sparse_matches_jax():
    """tests/test_batch.py::test_batch_forced_sparse_kernels's input
    through the sparse bucket (K1's instance mode)."""
    Cs = [random_sparse_cost(18, 7), random_sparse_cost(18, 8)]
    _check_against_jax(Cs, 1e-7, max_outer=60, dense_cost_max_n=0,
                       dense_cost_nnz_factor=0)


def test_batch_mixed_warns_and_runs_f64():
    """tests/test_mixed_precision.py::test_batch_mixed_warns's input."""
    from test_mixed_precision import _random_laplacian_cost
    Cs = np.stack([_random_laplacian_cost(16, s) for s in range(2)])
    with pytest.warns(UserWarning, match="mixed"):
        res = solve_maxcut_batch(Cs, verbose=False, inner_dtype="mixed",
                                 max_outer=2, p0=4, device="cpu")
    assert all(np.isfinite(r.obj) for r in res)


def _ragged(dense):
    """Six instances of n 8-30 in a bucket of 32 that certify at outer
    iterations 1 and 2 (default options, tol 1e-7)."""
    sizes = [(24, 0), (12, 1), (30, 2), (18, 3), (8, 4), (28, 5)] if dense \
        else [(20, 1), (26, 2), (18, 7), (12, 3), (30, 4), (8, 5)]
    make = random_sym_cost if dense else random_sparse_cost
    return [make(n, s) for n, s in sizes]


@pytest.mark.parametrize("case", ["dense", "sparse", "capped"])
def test_batch_drops_certified_instances_on_their_own_paths(case):
    """Certified instances leave the batch: every instance of a ragged
    bucket ends as the bucket solved for it alone from its start row
    (status, outer and RTR iterations, Hessian products and ranks equal;
    obj, dinf and Y to 1e-12), and each outer iteration's ``live`` is B
    less the instances certified before it.  ``capped``: max_outer 1, so
    the uncertified instances are returned as the last iteration left
    them."""
    from manisdp_tpu_torch.config import merged_options
    from manisdp_tpu_torch.solvers.batch import _solve_instances
    from manisdp_tpu_torch.solvers.common import bucketed, recorded
    dense = case != "sparse"
    Cs = _ragged(dense)
    ns = [C.shape[0] for C in Cs]
    opt = merged_options("maxcut_unitdiag", None, tol=1e-7, verbose=False,
                         max_outer=1 if case == "capped" else 40)
    gen = torch.Generator()
    gen.manual_seed(opt.seed)
    Y0 = torch.stack([Oblique.rand(gen, opt.p0, N_PAD,
                                   bucketed(opt.p0, opt.p_bucket))
                      for _ in Cs])
    run = recorded(_solve_instances)
    batch = run(Cs, ns, N_PAD, opt, "cpu", dense, Y0.clone(), len(Cs))
    ends = [r.iterations for r in batch]
    statuses = [r.status for r in batch]
    assert set(ends) == ({1} if case == "capped" else {1, 2})
    assert set(statuses) == ({0, 1} if case == "capped" else {0})
    for b, r in enumerate(batch):
        s = run([Cs[b]], [ns[b]], N_PAD, opt, "cpu", dense,
                Y0[b:b + 1].clone(), 1)[0]
        assert (r.status, r.iterations, r.hess_calls, r.rtr_iters,
                r.fac_size) == (s.status, s.iterations, s.hess_calls,
                                s.rtr_iters, s.fac_size)
        assert r.Y.shape == s.Y.shape == (r.fac_size[-1], ns[b])
        for got, ref in ((r.obj, s.obj), (r.dinf, s.dinf), (r.Y, s.Y)):
            assert _rel(got, ref) <= 1e-12
        for h in r.history:
            gone = sum(e < h["iter"] and st == 0
                       for e, st in zip(ends, statuses))
            assert h["live"] == len(Cs) - gone


def test_batch_returns_the_certified_pair():
    """Two 40 x 30 tori at p0 = 40 through the sparse bucket: the first
    certifies at outer iteration 1, the second at 2.  Every certified
    instance's returned z is colsum(Y o YC) of its returned Y, and obj is
    its sum, to 1e-12 (the batch used to return the certifying
    iteration's z with a Y the RTR had stepped on since: 7.3e-9 apart)."""
    Cs = [chip_smoke.torus_standin(40, 30, s) for s in (0, 2)]
    res = solve_maxcut_batch(Cs, p0=40, verbose=False, device="cpu",
                             dense_cost_max_n=0, dense_cost_nnz_factor=0)
    assert [r.iterations for r in res] == [1, 2]
    for C, r in zip(Cs, res):
        assert r.status == 0
        z = np.sum(r.Y * (r.Y @ C.toarray()), axis=0)
        assert _rel(r.z, z) <= 1e-12
        assert abs(r.obj - z.sum()) <= 1e-12 * abs(z.sum())


def test_batch_refuses_mesh_and_a_missing_card(monkeypatch):
    """A mesh is taken (one gloo rank, its batch axis of one place: the
    result equals the unsharded call's); no card still raises."""
    from manisdp_tpu_torch.parallel import spawn_ranks
    import _torch_rank_workers as W
    Cs = [random_sym_cost(8, 0)]
    kw = dict(max_outer=10, verbose=False)
    out = spawn_ranks(W.run_jobs, 1, "gloo", "cpu", threads=1, args=(
        [("b", "maxcut_batch", dict(Cs=Cs, kw=kw))],))
    got = out[0]["b"]["result"][0]
    ref = solve_maxcut_batch(Cs, device="cpu", **kw)[0]
    assert got["obj"] == ref.obj and got["status"] == ref.status
    np.testing.assert_array_equal(got["Y"], ref.Y)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        solve_maxcut_batch(Cs)


# ------------------------------------------------------------- K11 twin --

def _tcg_reference(d, Hd, r, eta, Heta, s, j, mininner):
    """One iteration of the JAX package's tCG body (core/trustregions.py
    :102-160) for one instance, in numpy; s = (e_Pe, e_Pd, d_Pd, z_r, mv,
    DD, kappa, linear)."""
    e_Pe, e_Pd, d_Pd, z_r, mv, DD, kappa, linear = s
    d_Hd, d_r = np.sum(d * Hd), np.sum(d * r)
    alpha = z_r / d_Hd
    e_Pe_new = e_Pe + 2.0 * alpha * e_Pd + alpha * alpha * d_Pd
    boundary = (d_Hd <= 0.0) or (e_Pe_new >= DD)
    tau = (-e_Pd + np.sqrt(e_Pd * e_Pd + d_Pd * (DD - e_Pe))) / d_Pd
    step = tau if boundary else alpha
    new_mv = mv - step * d_r + 0.5 * step * step * d_Hd
    model_inc = (not boundary) and new_mv >= mv
    stop = (1 if d_Hd <= 0 else 2) if boundary else (6 if model_inc else 0)
    if not model_inc:
        eta, Heta, mv = eta - step * d, Heta - step * Hd, new_mv
    r = r - alpha * Hd
    r_r = np.sum(r * r)
    if stop == 0 and j + 1 >= mininner and np.sqrt(r_r) <= kappa:
        stop = 3 if linear > 0 else 4
    beta = r_r / z_r
    s_next = (e_Pe if boundary else e_Pe_new, beta * (e_Pd + alpha * d_Pd),
              r_r + beta * beta * d_Pd, r_r, mv, DD, kappa, linear)
    return eta, Heta, r, r + beta * d, s_next, (j + 1, stop)


def _six_instances():
    """Six tCG states (B = 6, p = 3, n = 7): an ordinary step, a model
    increase (stop 6 keeps the previous iterate), negative curvature (1),
    the trust-region boundary (2), a met kappa target (3) and one stopped
    instance that must be left as it is.  Returns (d, Hd, r, eta, Heta,
    sc, st) as numpy arrays."""
    rs = np.random.RandomState(0)
    B, p, n = 6, 3, 7
    d = rs.randn(B, p, n)
    Hd = d * rs.uniform(1.0, 2.0, (B, p, n))
    Hd[2] = -d[2]                                   # negative curvature
    r, eta, Heta = (rs.randn(B, p, n) for _ in range(3))
    r *= np.sign(np.sum(d * r, axis=(1, 2)))[:, None, None]   # <d, r> > 0
    d_r = np.sum(d * r, axis=(1, 2))
    sc = np.tile([0.3, 0.2, 5.0, 2.0, -1.0, 1e6, 1e-9, 1.0], (B, 1))
    # the model decreases iff <d, r> > z_r / 2 (alpha = z_r / <d, Hd>)
    sc[:, 3] = d_r
    sc[1, 3] = 4.0 * d_r[1]                         # model increase
    sc[3, :2] = 0.0
    sc[3, 5] = 1e-8                                 # tiny trust region
    sc[4, 6] = 1e6                                  # kappa target met
    st = np.zeros((B, 2), dtype=np.int32)
    st[:, 0] = 3
    st[5, 1] = 2                                    # already stopped
    return d, Hd, r, eta, Heta, sc, st


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12),
                                       (torch.float32, 1e-5)])
def test_tcg_twin_matches_the_formulas(dtype, tol):
    """K11's twin on the six instances of _six_instances."""
    d, Hd, r, eta, Heta, sc, st = _six_instances()
    B = d.shape[0]
    T = lambda a: torch.tensor(a, dtype=dtype)  # noqa: E731
    td, tHd, tr, teta, tHeta = (T(a) for a in (d, Hd, r, eta, Heta))
    tsc, tst = T(sc), torch.tensor(st)
    e2, H2, r2, w, sc2, st2 = K.tcg_step(td, tHd, teta, tHeta, tr, tsc, tst,
                                         1)
    stops = []
    for b in range(B):
        if b == 5:
            for got, ref in ((e2[b], eta[b]), (H2[b], Heta[b]),
                             (r2[b], r[b]), (sc2[b], sc[b])):
                np.testing.assert_array_equal(got.numpy(), T(ref).numpy())
            assert st2[b].tolist() == [3, 2]
            continue
        ref = _tcg_reference(d[b], Hd[b], r[b], eta[b], Heta[b], sc[b],
                             3, 1)
        for got, want in zip((e2[b], H2[b], r2[b], w[b], sc2[b]), ref):
            assert _rel(got.double().numpy(), np.asarray(want)) <= tol
        assert tuple(st2[b].tolist()) == ref[5]
        stops.append(ref[5][1])
    assert stops == [0, 6, 1, 2, 3]
    # model increase: the previous iterate is kept exactly
    assert torch.equal(e2[1], teta[1]) and torch.equal(H2[1], tHeta[1])


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12),
                                       (torch.float32, 1e-5)])
@pytest.mark.parametrize("geometry", ["oblique", "masked", "instance",
                                      "instance_masked"])
def test_tcg_fused_twin_projects_the_next_direction(geometry, dtype, tol):
    """K11's step with the tangent projection (the tCG of the oblique and
    masked-product manifolds) against the JAX tCG body followed by the
    projection w - Y (colsum(Y w) mask), and bit for bit against the
    composition it replaces: the three passes' twins, then the manifold's
    own tangent map (K2 proj).  ``instance``: the six states of
    _six_instances with the instance stride (model increase, negative
    curvature, boundary, met target, one stopped, whose direction is
    never read again); otherwise B = 1, the ordinary step."""
    d, Hd, r, eta, Heta, sc, st = _six_instances()
    if not geometry.startswith("instance"):
        d, Hd, r, eta, Heta, sc, st = (a[:1] for a in
                                       (d, Hd, r, eta, Heta, sc, st))
    B, p, n = d.shape
    rs = np.random.RandomState(1)
    Y = rs.randn(B, p, n)
    Y /= np.linalg.norm(Y, axis=1, keepdims=True)
    mask = np.ones(n)
    if geometry.endswith("masked"):
        mask[[1, 4, 5]] = 0.0
    T = lambda a: torch.tensor(a, dtype=dtype)  # noqa: E731
    tvecs = [T(a) for a in (d, Hd, eta, Heta, r)]
    tsc, tst, tY = T(sc), torch.tensor(st), T(Y)
    if geometry.endswith("masked"):
        M = MaskedProduct(mask, "cpu")
        tmask = M.tangent_cols(tY)
    else:
        M, tmask = Oblique, None
        assert Oblique.tangent_cols(tY) is None
    got = K.tcg_step(*[t.clone() for t in tvecs], tsc, tst, 1, tY, tmask)
    # the composition: dots, update, finish, then M.tangent
    td, tHd, teta, tHeta, tr = tvecs
    part = K.tcg_dots_plain(td, tHd, tr, tst)
    e2, H2, r2, part2, xs = K.tcg_update_plain(part, tsc, tst, td, tHd,
                                               teta, tHeta, tr)
    w, sc2, st2 = K.tcg_finish_plain(part2, tsc, tst, xs, r2, td, 1)
    comp = (e2, H2, r2, M.tangent(tY, w), sc2, st2)
    for g, c in zip(got, comp):
        assert torch.equal(g, c)
    e2, H2, r2, dn, sc2, st2 = got
    for b in range(B):
        if st[b, 1] != 0:
            for g, ref in ((e2[b], eta[b]), (H2[b], Heta[b]),
                           (r2[b], r[b]), (sc2[b], sc[b])):
                np.testing.assert_array_equal(g.numpy(), T(ref).numpy())
            assert st2[b].tolist() == st[b].tolist()
            continue
        ref = list(_tcg_reference(d[b], Hd[b], r[b], eta[b], Heta[b], sc[b],
                                  3, 1))
        wb = ref[3]
        ref[3] = wb - Y[b] * (np.sum(Y[b] * wb, axis=0) * mask)
        for g, want in zip((e2[b], H2[b], r2[b], dn[b], sc2[b]), ref):
            assert _rel(g.double().numpy(), np.asarray(want)) <= tol
        assert tuple(st2[b].tolist()) == ref[5]
        # the next direction is tangent on the oblique columns
        tang = np.sum(Y[b] * dn[b].double().numpy(), axis=0)[mask > 0]
        assert np.max(np.abs(tang)) <= 100 * tol * max(1.0,
                                                       np.abs(wb).max())
        # a masked column is left as r + beta d
        off = mask == 0
        if off.any():
            assert _rel(dn[b].double().numpy()[:, off], wb[:, off]) <= tol
