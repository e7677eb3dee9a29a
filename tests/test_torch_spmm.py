"""Kernel K1's design (csrc/symcoo_spmm.cu) written out as torch ops: the
N-major gather from an explicit (n, pp) copy with every output element
summed in entry order, and the epilogues' column sums in the kernel's
tree (partials over rows l, l + 32, ..., then the 32-way xor butterfly).
Held to the JAX expressions K1 replaces (SymCOO.matmat / quad_cols, the
certificate's row matvec, the MaxCut cost and Hessian, the AL Hessian of
solvers/primal_al.py) on the same numpy inputs, and the layout rule
(kernels.symcoo_spmm_layout) that picks which factors are copied."""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import threadpoolctl
import torch

from manisdp_tpu.ops.sparse import SymCOO as JSymCOO
from manisdp_tpu.solvers.maxcut import make_maxcut_problem as j_problem
from manisdp_tpu_torch import kernels as K
from manisdp_tpu_torch.convert import symcoo_from_arrays


@pytest.fixture(autouse=True, scope="module")
def _one_cpu_thread():
    """Torch and BLAS on one thread for this module: the parallel test run
    puts several workers on the CPU, and their thread pools then
    oversubscribe it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpoolctl.threadpool_limits(1):
        yield
    torch.set_num_threads(n)


N = 50
# different summation order only (f64)
TOL = 1e-12


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.max(np.abs(got - ref)) / max(np.max(np.abs(ref)), 1e-300)


def _views(*factors):
    """symcoo_spmm_layout's views of single-instance (p, n) factors."""
    return [(X.stride(0), X.stride(1), 0, X.data_ptr()) for X in factors]


def k1_nmajor(A, C, mode, vals=None, z=None, B=None, eG=None, vals2=None,
              coefs=(1.0, 1.0)):
    """K1 as the kernel computes it.  The gathered factors (A, and B in
    al_hess) are read from an (n, pp) copy (rows zero beyond p) or, when
    symcoo_spmm_layout finds them N-major, from the factor's own (n, p)
    view; each output element is a chain over its column's entries in
    entry order (vectorized across columns by the entry's rank); the
    column sums run over 32 partials, x_l the chain over rows l, l + 32,
    ... (so a column of several row chunks continues x_l across them),
    then the butterfly with offsets 16, 8, 4, 2, 1."""
    p, n = A.shape
    two = mode == "al_hess"
    vw, pp, copy = K.symcoo_spmm_layout(
        p, A.dtype, _views(A, B) if two else _views(A))
    assert pp >= p and pp % vw == 0

    def source(X, cp):
        if not cp:
            return X.T
        Xt = torch.zeros((n, pp), dtype=X.dtype)
        Xt[:, :p] = X.T
        return Xt

    ptr = C.colptr.long()
    lens = ptr[1:] - ptr[:-1]
    rows = C.i.long()

    def product(Xt, v):
        acc = torch.zeros((n, Xt.shape[1]), dtype=Xt.dtype)
        for t in range(int(lens.max())):
            cols = torch.nonzero(lens > t).ravel()
            e = ptr[cols] + t
            acc[cols] = acc[cols] + v[e, None] * Xt[rows[e]]
        return acc[:, :p].T

    H = product(source(A, copy[0]), C.v if vals is None else vals)
    if two:
        H = coefs[0] * H + coefs[1] * product(source(B, copy[1]), vals2)

    def colsum(X, Y):
        x = [torch.zeros(n, dtype=X.dtype) for _ in range(32)]
        for lane in range(32):
            for r in range(lane, p, 32):
                x[lane] = x[lane] + X[r] * Y[r]
        y = [x[lane] + x[lane + 16] for lane in range(16)]
        h = 8
        while h:
            y = [y[lane] + y[lane + h] for lane in range(h)]
            h //= 2
        return y[0]

    if mode == "plain" or (two and eG is None):
        return H
    if mode == "shift":
        return H - z[None, :] * A
    if mode == "cost":
        return H, colsum(H, A)
    return H - B * colsum(B, H)[None, :] - A * eG[None, :]


@pytest.fixture(scope="module")
def inputs():
    rs = np.random.RandomState(23)
    A = sp.random(N, N, density=0.12, random_state=rs).tolil()
    A[:, 7] = rs.randn(N, 1)            # one long column (and row)
    A[:, 11] = 0.0                      # empty columns
    A[:, 30] = 0.0
    A = sp.csr_matrix(A)
    A = A + A.T + sp.diags(rs.randn(N))
    A.eliminate_zeros()
    jC = JSymCOO.from_scipy(A)
    tC = symcoo_from_arrays(np.asarray(jC.i), np.asarray(jC.j),
                            np.asarray(jC.v), N, "cpu")
    return rs, jC, tC


@pytest.mark.parametrize("p", [3, 16, 40])
def test_k1_decomposition_matches_jax(inputs, p):
    """Every mode of K1's decomposition against the JAX expressions it
    replaces, with the factor row-major (copied) and, for plain / shift,
    as the Vᵀ view of an (n, p) block (gathered in place)."""
    rs, jC, tC = inputs
    Y = rs.randn(p, N)
    Y /= np.linalg.norm(Y, axis=0)
    U = rs.randn(p, N)
    U -= Y * np.sum(Y * U, axis=0)
    z, YeG = rs.randn(N), rs.randn(N)
    nnz = tC.nnz
    es, ayu = rs.randn(nnz), rs.randn(nnz)
    sigma = 0.37
    tY, tU, tz, tYeG = (torch.from_numpy(np.ascontiguousarray(x))
                        for x in (Y, U, z, YeG))
    tes, tayu = torch.from_numpy(es), torch.from_numpy(ayu)
    Vt = torch.from_numpy(np.ascontiguousarray(Y.T)).T    # N-major view

    prob = j_problem(dense=False)
    _, (jYC, jeG) = prob.cost(Y, jC)
    jUC_hess = prob.hess(Y, U, jC, (jYC, jeG), ())
    # solvers/primal_al.py hess: eH, and its unit-diagonal epilogue
    jeH = 2.0 * jC.matmat_vals(U, es) + 4.0 * sigma * jC.matmat_vals(Y, ayu)
    jeH_diag = jeH - Y * jnp.sum(Y * jeH, axis=0, keepdims=True) \
        - U * YeG[None, :]
    al = dict(vals=tes, B=tY, vals2=tayu, coefs=(2.0, 4.0 * sigma))
    cases = [
        (k1_nmajor(tY, tC, "plain"), jC.matmat(Y)),
        (k1_nmajor(Vt, tC, "plain"), jC.matmat(Y)),
        (k1_nmajor(tY, tC, "shift", z=tz), jC.matmat(Y) - z[None, :] * Y),
        (k1_nmajor(Vt, tC, "shift", z=tz), jC.matmat(Y) - z[None, :] * Y),
        (k1_nmajor(tY, tC, "cost")[0], jYC),
        (k1_nmajor(tY, tC, "cost")[1], jC.quad_cols(Y)),
        (k1_nmajor(tY, tC, "cost")[1], jeG),
        (k1_nmajor(tU, tC, "hess", B=tY, eG=torch.from_numpy(
            np.array(jeG))), jUC_hess),
        (k1_nmajor(tU, tC, "al_hess", **al), jeH),
        (k1_nmajor(tU, tC, "al_hess", eG=tYeG, **al), jeH_diag),
    ]
    for got, ref in cases:
        assert got.shape == tuple(np.shape(ref))
        assert _rel(got.numpy(), ref) <= TOL
    # and the CPU twin the wrapper runs on CPU tensors agrees
    assert _rel(k1_nmajor(tU, tC, "al_hess", eG=tYeG, **al).numpy(),
                K.symcoo_spmm(tU, tC, "al_hess", eG=tYeG, **al).numpy()) \
        <= TOL


def test_k1_layout_rule():
    """Which factors the kernel copies, at what row length and load
    width: p-major factors are copied (pp = p rounded up to 16 B); Vᵀ
    views are gathered in place, with 16-B loads when aligned and p fills
    whole vectors, else scalar loads; a mix copies only what needs it."""
    f64, f32 = torch.float64, torch.float32
    Y = torch.zeros((16, N), dtype=f64)
    assert K.symcoo_spmm_layout(16, f64, _views(Y)) == (2, 16, [True])
    assert K.symcoo_spmm_layout(3, f64, _views(Y[:3])) == (2, 4, [True])
    assert K.symcoo_spmm_layout(3, f32, _views(Y[:3].float())) == \
        (4, 4, [True])
    V = torch.zeros((N, 16), dtype=f64)
    assert K.symcoo_spmm_layout(16, f64, _views(V.T)) == (2, 16, [False])
    V9 = torch.zeros((N, 9), dtype=f64)
    assert K.symcoo_spmm_layout(9, f64, _views(V9.T)) == (1, 9, [False])
    # a V^T view one element off 16-B alignment: scalar loads in place
    Vo = torch.zeros((N * 16 + 1,), dtype=f64)[1:].view(N, 16)
    assert K.symcoo_spmm_layout(16, f64, _views(Vo.T)) == (1, 16, [False])
    # al_hess: an aligned V^T beside a row-major factor; one p = 1 row
    assert K.symcoo_spmm_layout(16, f64, _views(V.T, Y)) == \
        (2, 16, [False, True])
    assert K.symcoo_spmm_layout(9, f64, _views(V9.T, Y[:9])) == \
        (2, 10, [True, True])
    assert K.symcoo_spmm_layout(1, f64, _views(Y[:1])) == (1, 1, [False])
    # instance strides must keep every instance's rows aligned
    batch = [(1, 16, 16 * N + 1, 0)]
    assert K.symcoo_spmm_layout(16, f64, batch) == (1, 16, [False])
