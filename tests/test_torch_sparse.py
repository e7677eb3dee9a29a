"""SymCOO and kernel K1's plain twin (every mode) against the JAX
package's gather / segment-sum expressions, on the same numpy inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import threadpoolctl
import torch

from manisdp_tpu.ops.sparse import SymCOO as JSymCOO
from manisdp_tpu.ops.sparse import pair_dots as j_pair_dots
from manisdp_tpu.ops.sparse import scatter_cols as j_scatter_cols
from manisdp_tpu.solvers.maxcut import make_maxcut_problem as j_problem
from manisdp_tpu_torch import kernels as K
from manisdp_tpu_torch.convert import factor_from_numpy, symcoo_from_arrays
from manisdp_tpu_torch.ops.sparse import SymCOO, pair_dots, scatter_cols

# relative to the largest entry: different summation order only


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


TOL = {np.float64: 1e-13, np.float32: 1e-5}
N, P, P_PAD = 40, 5, 8


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.max(np.abs(got - ref)) / max(np.max(np.abs(ref)), 1e-300)


@pytest.fixture(scope="module")
def data():
    rs = np.random.RandomState(11)
    A = sp.random(N, N, density=0.15, random_state=rs)
    A = A + A.T + sp.diags(rs.randn(N))
    Y = rs.randn(P_PAD, N)
    Y[P:] = 0.0
    Y /= np.linalg.norm(Y, axis=0)
    U = rs.randn(P_PAD, N)
    U[P:] = 0.0
    U = U - Y * np.sum(Y * U, axis=0)
    z = rs.randn(N)
    jC = JSymCOO.from_scipy(A)
    tC = symcoo_from_arrays(np.asarray(jC.i), np.asarray(jC.j),
                            np.asarray(jC.v), N, "cpu")
    return dict(A=A, Y=Y, U=U, z=z, jC=jC, tC=tC)


def _cast(d, dtype):
    jC = JSymCOO(i=d["jC"].i, j=d["jC"].j, v=d["jC"].v.astype(dtype), n=N)
    tC = d["tC"].astype(getattr(torch, np.dtype(dtype).name))
    arrs = {k: d[k].astype(dtype) for k in ("Y", "U", "z")}
    return jC, tC, arrs


def test_symcoo_from_arrays_roundtrip(data):
    jC, tC = data["jC"], data["tC"]
    for f in ("i", "j", "v"):
        np.testing.assert_array_equal(getattr(tC, f).numpy(),
                                      np.asarray(getattr(jC, f)))
    counts = np.bincount(np.asarray(jC.j), minlength=N)
    np.testing.assert_array_equal(np.diff(tC.colptr.numpy()), counts)
    assert tC.colptr.dtype == torch.int32 and tC.colptr[-1] == tC.nnz
    np.testing.assert_array_equal(tC.to_dense().numpy(),
                                  np.asarray(jC.to_dense()))
    # unsorted input is sorted by (column, row)
    perm = np.random.RandomState(0).permutation(tC.nnz)
    tC2 = SymCOO.from_arrays(np.asarray(jC.i)[perm], np.asarray(jC.j)[perm],
                             np.asarray(jC.v)[perm], N, "cpu")
    np.testing.assert_array_equal(tC2.j.numpy(), tC.j.numpy())
    np.testing.assert_array_equal(tC2.i.numpy(), tC.i.numpy())
    Yt = factor_from_numpy(data["Y"][:P], P_PAD, "cpu")
    np.testing.assert_array_equal(Yt.numpy(), data["Y"])


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("op", ["scatter_cols", "pair_dots", "matmat",
                                "matmat_vals", "matvec_block", "quad_cols",
                                "quad_cols_u", "quad_form"])
def test_symcoo_ops_match_jax(data, op, dtype):
    jC, tC, a = _cast(data, dtype)
    Y, U = a["Y"], a["U"]
    tY, tU = torch.from_numpy(Y), torch.from_numpy(U)
    vals = (2.0 * np.asarray(jC.v)).astype(dtype)
    if op == "scatter_cols":
        ref = j_scatter_cols(jC.v, jC.i, jC.j, Y, N)
        got = scatter_cols(tC.v, tC.i, tC.j, tY, N)
    elif op == "pair_dots":
        ref = j_pair_dots(Y, U, jC.i, jC.j)
        got = pair_dots(tY, tU, tC.i, tC.j)
    elif op == "matmat":
        ref, got = jC.matmat(Y), tC.matmat(tY)
    elif op == "matmat_vals":
        ref = jC.matmat_vals(Y, vals)
        got = tC.matmat_vals(tY, torch.from_numpy(vals))
    elif op == "matvec_block":
        V = np.ascontiguousarray(U.T[:, :3])
        ref, got = jC.matvec_block(V), tC.matvec_block(torch.from_numpy(V))
    elif op == "quad_cols":
        ref, got = jC.quad_cols(Y), tC.quad_cols(tY)
    elif op == "quad_cols_u":
        ref, got = jC.quad_cols(Y, U), tC.quad_cols(tY, tU)
    else:
        ref, got = jC.quad_form(Y, U), tC.quad_form(tY, tU)
    assert got.dtype == getattr(torch, np.dtype(dtype).name)
    assert _rel(got.numpy(), ref) <= TOL[dtype]


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("mode", ["plain", "shift", "cost", "hess"])
def test_k1_twin_matches_jax(data, mode, dtype):
    """K1's modes against the JAX expressions they replace: SymCOO.matmat,
    the certificate's row matvec (maxcut.py mvr), and the sparse MaxCut
    cost / hess (make_maxcut_problem(dense=False))."""
    jC, tC, a = _cast(data, dtype)
    Y, U, z = a["Y"], a["U"], a["z"]
    tY, tU, tz = (torch.from_numpy(x) for x in (Y, U, z))
    prob = j_problem(dense=False)
    if mode == "plain":
        pairs = [(K.symcoo_spmm(tY, tC, "plain"), jC.matmat(Y))]
    elif mode == "shift":
        pairs = [(K.symcoo_spmm(tY, tC, "shift", z=tz),
                  jC.matmat(Y) - z[None, :] * Y)]
    elif mode == "cost":
        _, (jYC, jeG) = prob.cost(Y, jC)
        YC, eG = K.symcoo_spmm(tY, tC, "cost")
        pairs = [(YC, jYC), (eG, jeG)]
    else:
        _, aux = prob.cost(Y, jC)
        eG = torch.from_numpy(np.array(aux[1]))
        pairs = [(K.symcoo_spmm(tU, tC, "hess", B=tY, eG=eG),
                  prob.hess(Y, U, jC, aux, ()))]
    for got, ref in pairs:
        assert _rel(got.numpy(), ref) <= TOL[dtype]
    got0 = pairs[0][0]
    if got0.dim() == 2:
        assert torch.all(got0[P:] == 0)        # padding rows stay zero
    assert K.LAUNCHES["symcoo_spmm"] == 0        # twins are not launches


def test_k1_wrapper_checks_operands(data):
    tC, Y = data["tC"], torch.from_numpy(data["Y"])
    with pytest.raises(ValueError, match="mode"):
        K.symcoo_spmm(Y, tC, "bogus")
    with pytest.raises(ValueError, match="missing"):
        K.symcoo_spmm(Y, tC, "shift")
    with pytest.raises(ValueError, match="devices"):
        K.symcoo_spmm(Y.to("meta"), tC, "plain")
