"""The port's dense and entrywise constraint carriers against the JAX
package's on the CPU (plain twins of kernels K4 and K5): the carriers'
construction and every protocol method, EntrywiseConstraintOp.detect, the
AL cost / grad / Hessian / stats on each carrier, and end-to-end solves
through the operator ladder from the same Y0, with checkpoint and resume
on each carrier."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import threadpoolctl
import torch

from manisdp_tpu import solve_sdp as j_sdp
from manisdp_tpu import solve_unittrace as j_unittrace
from manisdp_tpu.frontends.workloads import lovasz_theta
from manisdp_tpu.ops.sparse import ConstraintOp as JOp
from manisdp_tpu.ops.sparse import EntrywiseConstraintOp as JEw
from manisdp_tpu.solvers import primal_al as jal
from manisdp_tpu_torch import kernels as K
from manisdp_tpu_torch import recipes, solve_sdp, solve_unittrace
from manisdp_tpu_torch.convert import dense_op_from_jax, entrywise_op_from_jax
from manisdp_tpu_torch.core.trustregions import cast_floats
from manisdp_tpu_torch.frontends.workloads import matrix_completion
from manisdp_tpu_torch.ops.sparse import (ConstraintOp, DenseConstraintOp,
                                          EntrywiseConstraintOp)
from manisdp_tpu_torch.solvers import primal_al as tal
from manisdp_tpu_torch.utils.checkpoint import resume_kwargs

import _torch_parity as parity


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


TOL = {np.float64: 1e-12, np.float32: 1e-5}
P_PAD = 8


def _rel(got, ref):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    return np.max(np.abs(got - ref)) / max(np.max(np.abs(ref)), 1e-300)


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _cast32(jop):
    return jax.tree_util.tree_map(
        lambda a: a.astype(jnp.float32)
        if jnp.issubdtype(a.dtype, jnp.floating) else a, jop)


def _theta(n=20, m_edges=60):
    """lovasz_theta with its trace row dropped (tr(X) = 1 is the sphere's):
    edge constraints X_ij + X_ji = 0, an entrywise set."""
    data = lovasz_theta(n, m_edges, seed=1)
    At = sp.csc_matrix(data.At)
    m = At.shape[1] - 1
    return At[:, :m], data.b[:m], data.c, n


def _pair(At, b, c, n):
    return JOp.build(At, b, c, n), ConstraintOp.build(At, b, c, n, "cpu")


@pytest.fixture(scope="module")
def mc():
    data, _ = matrix_completion(30, 30, rank=3, m_samples=500, seed=3)
    return _pair(data.At, data.b, data.c, data.K.s)


@pytest.fixture(scope="module")
def theta():
    data = lovasz_theta(20, 60, seed=1)          # with its trace row
    return _pair(data.At, data.b, data.c, data.K.s)


def _carriers(pair, kind):
    jop, top = pair
    if kind == "dense":
        return jop.to_dense_op(), top.to_dense_op()
    return JEw.detect(jop), EntrywiseConstraintOp.detect(top)


# ---------------------------------------------------------- construction --

def test_detect_accepts_mc_and_rejects_theta(mc, theta):
    assert isinstance(EntrywiseConstraintOp.detect(mc[1]),
                      EntrywiseConstraintOp)
    assert JEw.detect(mc[0]) is not None
    # lovasz_theta's trace row has n entries
    assert JEw.detect(theta[0]) is None
    assert EntrywiseConstraintOp.detect(theta[1]) is None


def _entry_set(case, n=6):
    """Constraint sets around the entrywise boundary: (rows of vec(X),
    column k, value) triplets."""
    diag = [(0 + 0 * n, 0, 2.0), (3 + 3 * n, 1, -1.0)]
    pair = [(1 + 2 * n, 2, 0.5), (2 + 1 * n, 2, 0.5)]
    pair2 = [(4 + 0 * n, 3, 1.5), (0 + 4 * n, 3, 1.5)]
    t = {"mixed": diag + pair + pair2,
         "lone_offdiag": diag + [(1 + 2 * n, 2, 0.5)],
         "unequal_pair": diag + [(1 + 2 * n, 2, 0.5), (2 + 1 * n, 2, 0.7)],
         "shared_position": diag + pair + [(1 + 2 * n, 3, 1.0),
                                           (2 + 1 * n, 3, 1.0)],
         "three_entries": diag + pair + [(5 + 5 * n, 2, 1.0)],
         "empty_row": diag + [(5 + 5 * n, 3, 1.0)],
         "two_diagonals": [(0 + 0 * n, 0, 1.0), (3 + 3 * n, 0, 1.0)]}[case]
    rows, cols, vals = zip(*t)
    m = max(cols) + 1
    At = sp.coo_matrix((vals, (rows, cols)), shape=(n * n, m)).tocsc()
    rs = np.random.RandomState(0)
    C = rs.randn(n, n)
    return At, rs.randn(m), (C + C.T).flatten(order="F"), n


@pytest.mark.parametrize("case", ["mixed", "lone_offdiag", "unequal_pair",
                                  "shared_position", "three_entries",
                                  "empty_row", "two_diagonals"])
def test_detect_accepts_and_rejects_where_jax_does(case):
    jop, top = _pair(*_entry_set(case))
    jew, tew = JEw.detect(jop), EntrywiseConstraintOp.detect(top)
    assert (tew is None) == (jew is None)
    assert (tew is not None) == (case == "mixed")
    if tew is None:
        return
    # diagonal constraints occupy one position (minv 1, dfac 0.5),
    # off-diagonal pairs two (minv 0.5, dfac 1)
    for f in ("aval", "C", "b", "minv", "dfac", "ki", "kj"):
        np.testing.assert_array_equal(getattr(tew, f).numpy(),
                                      np.asarray(getattr(jew, f)), f)
    assert set(np.unique(tew.dfac.numpy())) == {0.0, 0.5, 1.0}


def test_converters_give_the_ported_carriers(mc):
    jop, top = mc
    jd, td = _carriers(mc, "dense")
    conv = dense_op_from_jax(
        {f: np.asarray(getattr(jd, f)) for f in ("k", "i", "j", "v", "C",
                                                 "b")} |
        dict(m=jd.m, n=jd.n), "cpu")
    for f in ("k", "ij", "v", "krow_ptr", "pos", "pos_ptr", "kq", "vq", "C",
              "b"):
        assert torch.equal(getattr(conv, f), getattr(td, f)), f
        if not getattr(td, f).is_floating_point():
            assert getattr(td, f).dtype == torch.int32
    # the positions' CSR groups the entries of one flat position i*n + j
    ij = np.asarray(jd.i, np.int64) * jd.n + np.asarray(jd.j)
    np.testing.assert_array_equal(
        np.diff(td.pos_ptr.numpy()),
        np.unique(ij, return_counts=True)[1])
    je, te = _carriers(mc, "entrywise")
    conv = entrywise_op_from_jax(
        {f: np.asarray(getattr(je, f)) for f in ("aval", "C", "b", "minv",
                                                 "dfac", "ki", "kj")} |
        dict(m=je.m, n=je.n), "cpu")
    for f in ("aval", "C", "b", "minv", "dfac", "ki", "kj"):
        assert torch.equal(getattr(conv, f), getattr(te, f)), f


@pytest.mark.parametrize("kind", ["dense", "entrywise"])
def test_astype_casts_only_float_arrays(mc, kind):
    _, t = _carriers(mc, kind)
    t32 = t.astype(torch.float32)
    for f in ("k", "ij", "krow_ptr", "pos", "pos_ptr", "kq", "ki", "kj"):
        if hasattr(t, f):
            assert getattr(t32, f) is getattr(t, f)
    for f in ("v", "vq", "C", "b", "aval", "minv", "dfac"):
        if hasattr(t, f):
            assert getattr(t32, f).dtype == torch.float32


# ------------------------------------------------------ protocol methods --

def _inputs(n, m, dtype, seed=3):
    rs = np.random.RandomState(seed)
    Y = rs.randn(P_PAD, n)
    Y[5:] = 0.0
    U = rs.randn(P_PAD, n)
    U[5:] = 0.0
    E = rs.randn(n, n)
    return dict(Y=Y.astype(dtype), U=U.astype(dtype), y=rs.randn(m),
                E=E.astype(dtype), E2=(E * E).astype(dtype),
                V=rs.randn(n, 6).astype(dtype), sigma=0.37)


# (method, args from the inputs; "y" is an (m,) vector that each side
# carries into its residual space with res_from_mvec, "ym" the vector
# itself)
METHODS = [
    ("pattern_pair_dots", ("Y",)),
    ("pattern_pair_dots", ("Y", "U")),
    ("apply_from_e", ("E",)),
    ("apply_factored", ("Y", "U")),
    ("adjoint_on_pattern", ("y",)),
    ("es_vals", ("y", "sigma")),
    ("s_vals", ("y",)),
    ("dot_pattern", ("E", "E2")),
    ("colsum_pattern", ("E",)),
    ("matmat_pattern", ("Y", "E")),
    ("matvec_pattern", ("V", "E")),
    ("res_from_mvec", ("ym",)),
    ("dot_res", ("y", "y")),
    ("norm_res", ("y",)),
    ("c_pattern", ()),
]
CASES = [("mc", "dense"), ("mc", "entrywise"), ("theta", "dense")]


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("inst,kind", CASES)
@pytest.mark.parametrize("name,argn", METHODS,
                         ids=[f"{m[0]}_{len(m[1])}" for m in METHODS])
def test_protocol_method_matches_jax(request, inst, kind, name, argn,
                                     dtype):
    j, t = _carriers(request.getfixturevalue(inst), kind)
    if dtype == np.float32:
        j, t = _cast32(j), t.astype(torch.float32)
    d = _inputs(t.n, t.m, dtype)

    def args(side, to):
        out = []
        for a in argn:
            if a == "y":
                out.append(side.res_from_mvec(d["y"]).to(to)
                           if side is t else
                           side.res_from_mvec(d["y"]).astype(to))
            elif a == "sigma":
                out.append(d[a])
            elif a == "ym":
                out.append(d["y"])
            else:
                out.append(torch.as_tensor(d[a]) if side is t
                           else jnp.asarray(d[a]))
        return out

    tdt = getattr(torch, np.dtype(dtype).name)
    ref = getattr(j, name)
    got = getattr(t, name)
    if name != "c_pattern":
        ref = ref(*args(j, dtype))
        got = got(*args(t, tdt))
    assert got.dtype == tdt
    assert got.shape == tuple(np.shape(ref))
    assert _rel(_np(got), ref) <= TOL[dtype]


@pytest.mark.parametrize("inst,kind", CASES)
def test_residual_space_and_normal_term(request, inst, kind):
    """res_zeros / res_to_mvec round trips to the same (m,) multipliers as
    JAX, and normal_factored is adjoint_on_pattern(apply_factored)."""
    j, t = _carriers(request.getfixturevalue(inst), kind)
    d = _inputs(t.n, t.m, np.float64, seed=5)
    z = t.res_zeros()
    assert z.shape == tuple(np.shape(j.res_zeros())) and not z.any()
    y = t.res_from_mvec(d["y"])
    np.testing.assert_array_equal(t.res_to_mvec(y), d["y"])
    np.testing.assert_array_equal(t.res_to_mvec(y),
                                  j.res_to_mvec(j.res_from_mvec(d["y"])))
    Y, U = torch.as_tensor(d["Y"]), torch.as_tensor(d["U"])
    ref = j.adjoint_on_pattern(j.apply_factored(jnp.asarray(d["Y"]),
                                                jnp.asarray(d["U"])))
    assert _rel(t.normal_factored(Y, U).numpy(), ref) <= 1e-12
    assert t.nnz == j.nnz and (t.m, t.n) == (j.m, j.n)


# ----------------------------------------- AL problem / stats parity --

def _state(variant, n, m, seed=2):
    rs = np.random.RandomState(seed)
    Y = rs.randn(8, n)
    Y[5:] = 0.0
    U = rs.randn(8, n)
    U[5:] = 0.0
    if variant == "unitdiag":
        Y /= np.linalg.norm(Y, axis=0)
        U = U - Y * np.sum(Y * U, axis=0)
    elif variant == "unittrace":
        Y /= np.linalg.norm(Y)
        U = U - Y * np.sum(Y * U)
    return Y, U, rs.randn(m), 0.37


@pytest.mark.parametrize("kind", ["dense", "entrywise"])
@pytest.mark.parametrize("variant", sorted(tal.VARIANTS))
def test_problem_and_stats_match_jax(mc, variant, kind):
    jop, top = _carriers(mc, kind)
    Y, U, y_m, sigma = _state(variant, top.n, top.m)
    jprob, _ = jal._make_problem(jal.VARIANTS[variant])
    tprob, tcost = tal._make_problem(tal.VARIANTS[variant])
    jy, ty = jop.res_from_mvec(y_m), top.res_from_mvec(y_m)
    jp = dict(op=jop, y=jy, sigma=jnp.float64(sigma))
    tp = dict(op=top, y=ty, sigma=sigma)
    jY, jU = jnp.asarray(Y), jnp.asarray(U)
    tY, tU = torch.as_tensor(Y), torch.as_tensor(U)

    jf, jaux = jprob.cost(jY, jp)
    tf, taux = tprob.cost(tY, tp)
    assert float(tf) == pytest.approx(float(jf), rel=1e-10)
    assert float(tcost(tY, tp)) == float(tf)
    jg, jgaux = jprob.grad(jY, jp, jaux)
    tg, tgaux = tprob.grad(tY, tp, taux)
    assert _rel(tg.numpy(), jg) <= 1e-10
    jh = jprob.hess(jY, jU, jp, jaux, jgaux)
    th = tprob.hess(tY, tU, tp, taux, tgaux)
    assert _rel(th.numpy(), jh) <= 1e-10
    # the f32 Hessian of the tcg32 inner loop
    jh32 = jprob.hess(*_cast32((jY, jU, jp, jaux, jgaux)))
    th32 = tprob.hess(*cast_floats((tY, tU, tp, taux, tgaux),
                                   torch.float32))
    assert th32.dtype == torch.float32
    assert _rel(th32.numpy(), jh32) <= 1e-5

    js = jal._make_stats(jal.VARIANTS[variant])(jY, jop, jy,
                                                jnp.float64(sigma))
    ts = tal._make_stats(tal.VARIANTS[variant])(tY, top, ty, sigma)
    for name, got, ref in zip(("obj", "pinf", "y", "sv", "z", "by", "gap"),
                              ts, js):
        assert _rel(got.numpy(), ref) <= 1e-10, name


# ----------------------------------------------------------- end to end --

def _y0(p, n, seed, frob=False):
    Y = np.random.RandomState(seed).randn(p, n)
    return Y / np.linalg.norm(Y) if frob else Y


def _mc40():
    data, _ = matrix_completion(40, 40, rank=3, m_samples=1200, seed=3)
    _, kw = recipes.recipe("mc")
    return data, dict(kw, verbose=False)


@pytest.mark.parametrize("mode,cls", [("auto", EntrywiseConstraintOp),
                                      ("dense", DenseConstraintOp)])
def test_mc_solve_matches_jax(mode, cls, monkeypatch):
    """tests/test_entrywise.py:74 on the port: the ladder picks the carrier
    JAX picks and the solve reaches JAX's optimum in as many iterations."""
    data, kw = _mc40()
    n = data.K.s
    picked = []
    select = tal._select_operator
    monkeypatch.setattr(tal, "_select_operator",
                        lambda opt, op: picked.append(select(opt, op)) or
                        picked[-1])
    Y0 = _y0(1, n, 5)
    res = solve_sdp(data.At, data.b, data.c, n, Y0=Y0, device="cpu",
                    al_op_mode=mode, **kw)
    ref = j_sdp(data.At, data.b, data.c, n, Y0=Y0, al_op_mode=mode, **kw)
    assert type(picked[0]) is cls
    assert res.status == 0 and ref.status == 0 and res.eta < 1e-8
    assert res.iterations == ref.iterations
    np.testing.assert_allclose(res.obj, ref.obj, rtol=1e-6)
    np.testing.assert_allclose(res.y, ref.y, rtol=1e-4, atol=1e-6)
    assert res.y.shape == (data.b.shape[0],) and res.S.shape == (n, n)


def test_dense_eigh_certificate_matches_jax():
    """cert_method="dense_eigh" on the entrywise carrier (eig_switch_n
    lowered so the dense eigh certificate is not taken instead): the far
    tier, the near tier and the exact f64 eigh fallback all run.

    Both packages' far tier is an f32 eigh (LAPACK through PyTorch, XLA's
    in JAX), whose escape vectors agree only to f32 rounding.  So the
    trajectories agree to 1e-10 for two outer iterations (dinf to the f32
    eigh's 1e-5), the third inner solve starts from those vectors, and
    the outer count that follows depends on the machine's BLAS.  Held: the
    first two iterations, then the status, eta and the optimum."""
    from manisdp_tpu_torch.ops import dense_cert
    data, kw = _mc40()
    n = data.K.s
    kw = dict(kw, cert_method="dense_eigh", eig_switch_n=16)
    Y0 = _y0(1, n, 5)
    dense_cert.reset_counts()
    res = solve_sdp(data.At, data.b, data.c, n, Y0=Y0, device="cpu", **kw)
    ref = j_sdp(data.At, data.b, data.c, n, Y0=Y0, **kw)
    parity.hold(res.history, ref.history, head=2, dinf_rtol=1e-5)
    print(f"margin: the second iteration's f32 dinf apart by "
          f"{parity.rel(res.history[1]['dinf'], ref.history[1]['dinf']):.2e}"
          f" relative; outer iterations {res.iterations} / {ref.iterations}")
    assert res.status == 0 and ref.status == 0 and res.eta < 1e-8
    np.testing.assert_allclose(res.obj, ref.obj, rtol=1e-6)
    counts = dict(dense_cert.COUNTS)
    assert sum(counts.values()) == res.iterations
    assert counts["far"] > 0 and counts["near"] + counts["eigh64"] > 0


def test_theta_unittrace_on_the_entrywise_carrier():
    """A small Lovasz theta through solve_unittrace (tests/test_theta.py's
    construction): its edge constraints are entrywise.

    The trajectories agree to 1e-10 for eight outer iterations.  The
    ninth inner solve starts from the eighth certificate's escape vectors,
    which LOBPCG determines only to its residual tolerance (1e-9 of the
    spectral scale), so the ninth gradnorm and dinf differ at ~1e-9
    relative; the nonconvex inner solves amplify that, and the outer count
    that follows depends on the machine's BLAS.  Held: the first eight
    iterations, then the status, eta and the optimum."""
    At, b, c, n = _theta()
    assert EntrywiseConstraintOp.detect(
        ConstraintOp.build(At, b, c, n, "cpu")) is not None
    Y0 = _y0(1, n, 2, frob=True)
    kw = dict(verbose=False, max_outer=300)
    res = solve_unittrace(At, b, c, n, Y0=Y0, device="cpu", **kw)
    ref = j_unittrace(At, b, c, n, Y0=Y0, **kw)
    at = parity.hold(res.history, ref.history, head=8, dinf_rtol=1e-9)
    if at < min(len(res.history), len(ref.history)):
        a, b_ = res.history[at], ref.history[at]
        print(f"margin: at outer iteration {at + 1} gradnorm apart by "
              f"{parity.rel(a['gradnorm'], b_['gradnorm']):.2e}, dinf by "
              f"{parity.rel(a['dinf'], b_['dinf']):.2e} relative; outer "
              f"iterations {res.iterations} / {ref.iterations}")
    assert res.status == 0 and ref.status == 0 and res.eta < 1e-8
    np.testing.assert_allclose(res.obj, ref.obj, rtol=1e-6)
    np.testing.assert_allclose(np.trace(res.X), 1.0, atol=1e-8)


@pytest.mark.parametrize("mode", ["entrywise", "dense"])
def test_checkpoint_and_resume_on_each_carrier(tmp_path, mode):
    """The checkpoint carries (m,) multipliers out of each carrier's
    residual space and the resumed solve carries them back in."""
    data, kw = _mc40()
    n = data.K.s
    kw = dict(kw, al_op_mode=mode)
    path = str(tmp_path / "al.npz")
    Y0 = _y0(1, n, 5)
    first = solve_sdp(data.At, data.b, data.c, n, Y0=Y0, device="cpu",
                      checkpoint_every=3, checkpoint_path=path,
                      **dict(kw, max_outer=3))
    assert first.status == 1 and first.iterations == 3
    rk = resume_kwargs(path)
    assert rk["y0"].shape == (data.b.shape[0],)
    assert rk["sigma0"] == first.sigma
    np.testing.assert_array_equal(rk["y0"], first.y)
    res = solve_sdp(data.At, data.b, data.c, n, resume=path, device="cpu",
                    **kw)
    full = solve_sdp(data.At, data.b, data.c, n, Y0=Y0, device="cpu", **kw)
    assert res.status == 0 and full.status == 0
    np.testing.assert_allclose(res.obj, full.obj, rtol=1e-7)


def test_carrier_wrappers_count_nothing_on_the_cpu(mc):
    """On CPU tensors the carriers run the kernels' plain twins."""
    _, td = _carriers(mc, "dense")
    _, te = _carriers(mc, "entrywise")
    K.reset_launches()
    Y = torch.as_tensor(_inputs(td.n, td.m, np.float64)["Y"])
    td.normal_factored(Y, Y)
    td.es_vals(td.res_zeros(), 0.5)
    te.normal_factored(Y, Y)
    te.es_vals(te.res_zeros(), 0.5)
    assert not any(K.LAUNCHES.values())
    assert not any(K.CSR_LAUNCHES.values())
    assert not any(K.MASKED_LAUNCHES.values())
