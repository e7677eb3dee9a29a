"""The port's general dual operator (DualOp, SparseMat, build_iab: kernel
K4 through its plain twin on the CPU) against the JAX package's on the
same numpy data: the BQP SOS dual (assemble_bqpsos, q = 6) and the quartic
over the sphere (qssos, d = 4)."""

import jax.numpy as jnp
import numpy as np
import pytest
import threadpoolctl
import torch

from manisdp_tpu.frontends.monomials import monomial_basis
from manisdp_tpu.ops.dualops import DualOp as JDualOp
from manisdp_tpu.solvers import dual_al as jal
from manisdp_tpu.solvers.dual_general import build_iab as j_build_iab
from manisdp_tpu_torch.convert import dual_op_from_jax, sparse_mat_from_jax
from manisdp_tpu_torch.frontends.sos import assemble_bqpsos, qssos
from manisdp_tpu_torch.ops.dualops import DualOp
from manisdp_tpu_torch.solvers import dual_al as tal
from manisdp_tpu_torch.solvers.dual_general import build_iab


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


FIELDS = ("k_r", "lin_r", "v_r", "k_c", "lin_c", "v_c", "b", "cf", "C",
          "idAAt", "bA", "Ac")
SPARSE = ("row_r", "col_r", "val_r", "row_c", "col_c", "val_c")


def _rel(got, ref):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    return np.max(np.abs(got - ref)) / max(np.max(np.abs(ref)), 1e-300)


def bqp_data(q=6, seed=1):
    rng = np.random.default_rng(seed)
    Q = rng.standard_normal((q, q))
    Q = (Q + Q.T) / 2
    A, b, c, mb, f, dAAt = assemble_bqpsos(Q, rng.standard_normal(q), q)
    return A, b / np.max(np.abs(b)), c, mb, f, dAAt


def qs_data(d=4, seed=2):
    coe = np.random.RandomState(seed).randn(monomial_basis(d, 4).shape[1])
    A, b, c, mb, f, dAAt = qssos(d, coe)
    return A, b / np.max(np.abs(b)), c, mb, f, dAAt


@pytest.fixture(scope="module", params=["bqp", "qs"])
def ops(request):
    data = (bqp_data if request.param == "bqp" else qs_data)()
    return data, JDualOp.build(*data), DualOp.build(*data, device="cpu")


def test_built_arrays_match_jax(ops):
    data, jop, top = ops
    for k in FIELDS:
        np.testing.assert_array_equal(getattr(top, k).numpy(),
                                      np.asarray(getattr(jop, k)))
    for k in SPARSE:
        np.testing.assert_array_equal(getattr(top.B, k).numpy(),
                                      np.asarray(getattr(jop.B, k)))
    assert (top.m, top.n, top.f) == (jop.m, jop.n, jop.f)
    assert (top.B.nrows, top.B.ncols) == (jop.B.nrows, jop.B.ncols)
    assert top.lin_r.dtype == torch.int32 and top.krow_ptr.dtype == \
        torch.int32
    # the converter rebuilds the port's pointers from the JAX fields
    fields = {k: np.asarray(getattr(jop, k)) for k in FIELDS}
    fields.update(m=jop.m, n=jop.n, f=jop.f,
                  B={k: np.asarray(getattr(jop.B, k)) for k in SPARSE}
                  | dict(nrows=jop.B.nrows, ncols=jop.B.ncols))
    conv = dual_op_from_jax(fields, "cpu")
    for k in ("krow_ptr", "pos", "pos_ptr"):
        np.testing.assert_array_equal(getattr(conv, k).numpy(),
                                      getattr(top, k).numpy())
    for k in ("row_ptr", "col_ptr"):
        np.testing.assert_array_equal(getattr(conv.B, k).numpy(),
                                      getattr(top.B, k).numpy())


def test_products_match_jax(ops):
    data, jop, top = ops
    rng = np.random.default_rng(3)
    n, m = top.n, top.m
    M = rng.standard_normal((n, n))
    y = rng.standard_normal(m)
    S = M + M.T
    for dt, tol in ((torch.float64, 1e-12), (torch.float32, 1e-5)):
        op = top.astype(dt)
        T = lambda a: torch.as_tensor(a).to(dt)  # noqa: E731
        assert _rel(op.apply(T(M)).numpy(), jop.apply(jnp.asarray(M))) <= tol
        assert _rel(op.adjoint(T(y)).numpy(),
                    jop.adjoint(jnp.asarray(y))) <= tol
        assert _rel(op.y_step(T(S)).numpy(),
                    jop.y_step(jnp.asarray(S))) <= tol
        assert _rel(op.adjoint_scaled(T(y)).numpy(),
                    jop.adjoint(jop.idAAt * jnp.asarray(y))) <= tol
        Xm = rng.standard_normal((n, n))
        ref = jop.adjoint(jnp.asarray(y)) - (jnp.asarray(S) - jop.C) \
            - jnp.asarray(Xm) / 0.37
        assert _rel(op.residual(T(y), T(S), T(Xm), 0.37).numpy(), ref) <= tol
        if top.f:
            assert _rel(op.B.rmatvec(T(y)).numpy(),
                        jop.B.rmatvec(jnp.asarray(y))) <= tol
            w = rng.standard_normal(top.f)
            assert _rel(op.B.matvec(T(w)).numpy(),
                        jop.B.matvec(jnp.asarray(w))) <= tol


def test_build_iab_and_its_products_match_jax():
    A, b, c, mb, f, dAAt = qs_data()
    jiab = j_build_iab(A, mb, f, dAAt)
    tiab = build_iab(A, mb, f, dAAt, device="cpu")
    for k in SPARSE:
        np.testing.assert_array_equal(getattr(tiab, k).numpy(),
                                      np.asarray(getattr(jiab, k)))
    conv = sparse_mat_from_jax({k: np.asarray(getattr(jiab, k))
                                for k in SPARSE} |
                               dict(nrows=jiab.nrows, ncols=jiab.ncols),
                               "cpu")
    np.testing.assert_array_equal(conv.row_ptr.numpy(),
                                  tiab.row_ptr.numpy())
    rng = np.random.default_rng(4)
    u = rng.standard_normal(f)
    M = rng.standard_normal((mb, mb))
    assert _rel(tal._iab_mat(tiab, mb, torch.as_tensor(u)).numpy(),
                jal._iab_mat(jiab, mb, jnp.asarray(u))) <= 1e-12
    assert _rel(tal._iab_rmat(tiab, torch.as_tensor(M)).numpy(),
                jal._iab_rmat(jiab, jnp.asarray(M))) <= 1e-12


def test_int32_limits_raise():
    with pytest.raises(ValueError, match="int32"):
        DualOp.build(np.zeros((1, 4)), np.zeros(1), np.zeros(1), 46341,
                     device="cpu")
