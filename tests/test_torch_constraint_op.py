"""The port's ConstraintOp and the plain twins of kernels K3, K4 and K1's
al_hess mode against the JAX package's ConstraintOp, on the same numpy
inputs: the assembled arrays, the JAX-state converter, and every method of
the operator protocol (manisdp_tpu/ops/sparse.py:240-338)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import threadpoolctl
import torch

from manisdp_tpu.ops.sparse import ConstraintOp as JOp
from manisdp_tpu_torch import kernels as K
from manisdp_tpu_torch.convert import constraint_op_from_jax
from manisdp_tpu_torch.ops.sparse import ConstraintOp

N, M, P_PAD = 12, 30, 8


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
ARRAYS = ("k", "i", "j", "v", "a2p", "b", "kp", "vp", "a2p_sorted")


def _rel(got, ref):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    return np.max(np.abs(got - ref)) / max(np.max(np.abs(ref)), 1e-300)


def random_sdp(n, m, seed):
    """Symmetric SeDuMi constraints of 1-3 random entries each (one
    constraint row left empty) and a cost C on the diagonal plus entries
    no constraint touches, so the pattern has empty adjoint segments."""
    rs = np.random.RandomState(seed)
    rows, cols, vals = [], [], []
    for k in range(m):
        if k == m // 2:
            continue
        for _ in range(rs.randint(1, 4)):
            i, j = rs.randint(0, n, 2)
            v = rs.randn()
            rows.append(i + j * n)
            cols.append(k)
            vals.append(v)
            if i != j:
                rows.append(j + i * n)
                cols.append(k)
                vals.append(v)
    At = sp.coo_matrix((vals, (rows, cols)), shape=(n * n, m)).tocsc()
    Cm = sp.random(n, n, density=0.2, random_state=rs).toarray()
    Cm = Cm + Cm.T + np.diag(rs.randn(n))
    return At, rs.randn(m), Cm.flatten(order="F")


@pytest.fixture(scope="module")
def ops():
    At, b, c = random_sdp(N, M, seed=5)
    jop = JOp.build(At, b, c, N)
    top = ConstraintOp.build(At, b, c, N, "cpu")
    return jop, top


def _jax_arrays(jop):
    a = {f: np.asarray(getattr(jop, f)) for f in ARRAYS}
    a.update({"pat.i": np.asarray(jop.pat.i), "pat.j": np.asarray(jop.pat.j),
              "pat.v": np.asarray(jop.pat.v), "m": jop.m, "n": jop.n})
    return a


def _check_arrays(top, jop):
    assert (top.m, top.n) == (jop.m, jop.n)
    for f in ARRAYS:
        np.testing.assert_array_equal(getattr(top, f).numpy(),
                                      np.asarray(getattr(jop, f)))
    for f in ("i", "j", "v"):
        np.testing.assert_array_equal(getattr(top.pat, f).numpy(),
                                      np.asarray(getattr(jop.pat, f)))
    for f in ("k", "i", "j", "a2p", "kp", "a2p_sorted"):
        assert getattr(top, f).dtype == torch.int32
    counts = np.bincount(np.asarray(jop.k), minlength=jop.m)
    np.testing.assert_array_equal(np.diff(top.krow_ptr.numpy()), counts)
    seg = np.bincount(np.asarray(jop.a2p_sorted), minlength=jop.pat.nnz)
    np.testing.assert_array_equal(np.diff(top.pat_ptr.numpy()), seg)
    np.testing.assert_array_equal(
        np.diff(top.pat.colptr.numpy()),
        np.bincount(np.asarray(jop.pat.j), minlength=jop.n))


def test_build_matches_jax_arrays(ops):
    jop, top = ops
    _check_arrays(top, jop)
    # the instance exercises empty segments in both orderings
    assert np.any(np.diff(top.pat_ptr.numpy()) == 0)
    assert np.any(np.diff(top.krow_ptr.numpy()) == 0)


def test_constraint_op_from_jax_roundtrip(ops):
    jop, top = ops
    conv = constraint_op_from_jax(_jax_arrays(jop), "cpu")
    _check_arrays(conv, jop)
    for f in ("krow_ptr", "pat_ptr"):
        assert torch.equal(getattr(conv, f), getattr(top, f))
    with pytest.raises(ValueError, match="sorted"):
        bad = _jax_arrays(jop)
        bad["k"] = bad["k"][::-1].copy()
        constraint_op_from_jax(bad, "cpu")


def test_astype_casts_only_float_arrays(ops):
    _, top = ops
    t32 = top.astype(torch.float32)
    for f in ("v", "vp", "b"):
        assert getattr(t32, f).dtype == torch.float32
    assert t32.pat.v.dtype == torch.float32
    for f in ("k", "a2p", "kp", "a2p_sorted", "krow_ptr", "pat_ptr"):
        assert getattr(t32, f) is getattr(top, f)
    assert t32.pat.colptr is top.pat.colptr


def _inputs(dtype, seed=3):
    rs = np.random.RandomState(seed)
    Y = rs.randn(P_PAD, N)
    Y[5:] = 0.0
    U = rs.randn(P_PAD, N)
    U[5:] = 0.0
    return dict(Y=Y.astype(dtype), U=U.astype(dtype),
                w=rs.randn(M).astype(dtype),
                e=rs.randn(10 * N).astype(dtype),
                V=rs.randn(N, 6).astype(dtype),
                x=rs.randn(N * N).astype(dtype), sigma=0.37)


# (name, args built from the inputs and the op's pattern size)
METHODS = [
    ("pattern_pair_dots", lambda d, P: (d["Y"],)),
    ("pattern_pair_dots_U", lambda d, P: (d["Y"], d["U"])),
    ("apply_from_e", lambda d, P: (d["e"][:P],)),
    ("apply_factored", lambda d, P: (d["Y"], d["U"])),
    ("apply_vec", lambda d, P: (d["x"],)),
    ("adjoint_on_pattern", lambda d, P: (d["w"],)),
    ("es_vals", lambda d, P: (d["w"], d["sigma"])),
    ("s_vals", lambda d, P: (d["w"],)),
    ("pattern_dense", lambda d, P: (d["e"][:P],)),
    ("dot_res", lambda d, P: (d["w"], d["w"][::-1].copy())),
    ("norm_res", lambda d, P: (d["w"],)),
    ("dot_pattern", lambda d, P: (d["e"][:P], d["e"][:P] ** 2)),
    ("colsum_pattern", lambda d, P: (d["e"][:P],)),
    ("matmat_pattern", lambda d, P: (d["Y"], d["e"][:P])),
    ("matvec_pattern", lambda d, P: (d["V"], d["e"][:P])),
]


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("name,make", METHODS, ids=[m[0] for m in METHODS])
def test_protocol_method_matches_jax(ops, name, make, dtype):
    jop, top = ops
    if dtype == np.float32:
        jop = jax.tree_util.tree_map(
            lambda a: a.astype(jnp.float32)
            if jnp.issubdtype(a.dtype, jnp.floating) else a, jop)
        top = top.astype(torch.float32)
    d = _inputs(dtype)
    args = make(d, jop.pat.nnz)
    method = name.removesuffix("_U")
    to_j = lambda a: jnp.asarray(a) if isinstance(a, np.ndarray) else a  # noqa: E731
    to_t = lambda a: torch.as_tensor(a) if isinstance(a, np.ndarray) else a  # noqa: E731
    ref = getattr(jop, method)(*map(to_j, args))
    got = getattr(top, method)(*map(to_t, args))
    assert got.dtype == getattr(torch, np.dtype(dtype).name)
    assert _rel(got.numpy(), ref) <= TOL[dtype]


def test_protocol_scalars_and_residual_space(ops):
    jop, top = ops
    np.testing.assert_array_equal(top.c_pattern.numpy(),
                                  np.asarray(jop.c_pattern))
    assert top.nnz == jop.nnz
    z = top.res_zeros()
    assert z.shape == (M,) and z.dtype == torch.float64 and not z.any()
    y = np.random.RandomState(2).randn(M)
    np.testing.assert_array_equal(top.res_to_mvec(top.res_from_mvec(y)), y)
    np.testing.assert_array_equal(top.res_to_mvec(top.res_from_mvec(y)),
                                  jop.res_to_mvec(jop.res_from_mvec(y)))


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_twins_match_jax_formulas(ops, dtype):
    """K3's, K4's and K1 al_hess's twins against the JAX expressions the
    kernels replace (ops/sparse.py pair_dots, apply_from_e,
    adjoint_on_pattern, es_vals; solvers/primal_al.py hess)."""
    jop, top = ops
    tdt = getattr(torch, np.dtype(dtype).name)
    jop = jax.tree_util.tree_map(
        lambda a: a.astype(dtype)
        if jnp.issubdtype(a.dtype, jnp.floating) else a, jop)
    top = top.astype(tdt)
    d = _inputs(dtype, seed=9)
    t = {k: torch.as_tensor(v) for k, v in d.items() if k != "sigma"}
    j = {k: jnp.asarray(v) for k, v in d.items() if k != "sigma"}
    s = d["sigma"]
    P = jop.pat.nnz
    e = K.pattern_dots_plain(t["Y"], t["U"], top.pat)
    assert _rel(e.numpy(), jop.pattern_pair_dots(j["Y"], j["U"])) <= \
        TOL[dtype]
    got = K.csr_gather_plain(t["e"][:P], top.krow_ptr, top.a2p, top.v)
    assert _rel(got.numpy(), jop.apply_from_e(j["e"][:P])) <= TOL[dtype]
    got = K.csr_gather_plain(t["w"], top.pat_ptr, top.kp, top.vp,
                             base=top.pat.v, alpha=s)
    assert _rel(got.numpy(), jop.es_vals(j["w"], s)) <= TOL[dtype]
    es = jop.es_vals(j["w"], s)
    ayu = jop.adjoint_on_pattern(j["w"][::-1])
    eH = 2.0 * jop.matmat_pattern(j["U"], es) + \
        4.0 * s * jop.matmat_pattern(j["Y"], ayu)
    YeG = jnp.asarray(np.random.RandomState(1).randn(N).astype(dtype))
    ref_diag = eH - j["Y"] * jnp.sum(j["Y"] * eH, axis=0, keepdims=True) \
        - j["U"] * YeG[None, :]
    kw = dict(vals=torch.as_tensor(np.asarray(es)), B=t["Y"],
              vals2=torch.as_tensor(np.asarray(ayu)), coefs=(2.0, 4.0 * s))
    for eG, ref in ((None, eH), (torch.as_tensor(np.asarray(YeG)),
                                 ref_diag)):
        got = K.symcoo_spmm_plain(t["U"], top.pat, "al_hess", eG=eG, **kw)
        assert _rel(got.numpy(), ref) <= TOL[dtype]
        # the wrapper takes the twin on CPU tensors and counts nothing
        before = dict(K.LAUNCHES)
        wrapped = K.symcoo_spmm(t["U"], top.pat, "al_hess", eG=eG, **kw)
        assert torch.equal(wrapped, got) and K.LAUNCHES == before
