"""The port's dense eigen-certificate (ops/dense_cert.py, kernel K6's plain
twin on the CPU) against the JAX package's DenseEighCert and
np.linalg.eigh: the cases of tests/test_dense_cert.py, one refinement
step's outputs, and the driver's tiers in DenseEighCert.certify."""

import jax.numpy as jnp
import numpy as np
import pytest
import threadpoolctl
import torch

from manisdp_tpu.ops import dense_cert as jdc
from manisdp_tpu_torch import kernels as K
from manisdp_tpu_torch.ops import dense_cert as tdc
from test_dense_cert import _planted


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


def _both(X, k, tier, **kw):
    """The same matrix through the JAX and the port's certificate."""
    j = jdc.DenseEighCert(X.shape[0], k=k)
    t = tdc.DenseEighCert(X.shape[0], k=k)
    X32 = X.astype(np.float32)
    if tier == "far":
        return j.far(jnp.asarray(X32)), t.far(torch.as_tensor(X32))
    return (j.near(jnp.asarray(X), jnp.asarray(X32), **kw),
            t.near(torch.as_tensor(X), torch.as_tensor(X32), **kw))


def _agree(res, ref, scale, tol):
    assert res.certified == ref.certified
    assert res.num_neg == ref.num_neg
    assert abs(res.lam_min - ref.lam_min) <= tol * scale
    assert abs(res.lam_max - ref.lam_max) <= tol * scale
    assert res.neg_vecs.shape == np.shape(ref.neg_vecs)
    assert res.neg_vecs.dtype == torch.float64


@pytest.mark.parametrize("n,r", [(200, 3), (400, 17)])
def test_near_certifies_planted_cluster(n, r):
    X, lam = _planted(n, r, cluster_spread=1e-10, seed=1)
    ref, res = _both(X, 9, "near", target_rel=1e-9)
    assert res.certified
    scale = 1.0 + abs(lam[-1])
    assert res.lam_min <= lam[0] + 1e-12 * scale
    assert res.lam_min >= lam[0] - 2e-9 * scale
    assert abs(res.lam_max - lam[-1]) <= 2e-9 * scale
    _agree(res, ref, scale, 2e-9)


def test_near_detects_negative_eigenvalue():
    n, r = 300, 5
    X, lam = _planted(n, r, cluster_spread=1e-10, neg=3e-6, seed=2)
    ref, res = _both(X, 9, "near", target_rel=1e-9)
    assert res.certified
    dinf = max(0.0, -res.lam_min) / (1.0 + abs(res.lam_max))
    assert dinf > 1e-8 and res.num_neg >= 1
    v = res.neg_vecs[:, 0].numpy()
    mu = float(v @ X @ v)
    assert np.linalg.norm(X @ v - mu * v) <= 1e-6 * (1.0 + abs(res.lam_max))
    assert mu < 0
    _agree(res, ref, 1.0 + abs(lam[-1]), 2e-9)


def test_far_tier_spectrum_and_vecs():
    n, r = 256, 4
    X, lam = _planted(n, r, cluster_spread=1e-4, seed=3)
    ref, res = _both(X, 9, "far")
    scale = 1.0 + abs(lam[-1])
    assert abs(res.lam_min - lam[0]) <= 1e-4 * scale
    assert abs(res.lam_max - lam[-1]) <= 1e-4 * scale
    assert res.neg_vecs.shape == (n, 9) and not res.certified
    _agree(res, ref, scale, 1e-5)


def test_near_random_dense_matches_eigh():
    rng = np.random.default_rng(4)
    n = 257
    X = rng.standard_normal((n, n))
    X = (X + X.T) / 2
    lam = np.linalg.eigvalsh(X)
    ref, res = _both(X, 5, "near", target_rel=1e-9)
    assert res.certified
    scale = 1.0 + abs(lam[-1])
    assert res.lam_min <= lam[0] + 1e-12 * scale
    assert res.lam_min >= lam[0] - 1e-8 * scale
    assert res.num_neg == int(np.sum(lam < 0))
    _agree(res, ref, scale, 1e-9)


def test_one_refinement_step_matches_jax():
    """_oa_refine's outputs (the K6 twin between the GEMMs) against the
    JAX step on the same f64 matrix and f32 basis."""
    X, _ = _planted(150, 6, cluster_spread=1e-8, seed=5)
    _, V32 = np.linalg.eigh(X.astype(np.float32))
    V = V32.astype(np.float64)
    ref = jdc._oa_refine(jnp.asarray(X), jnp.asarray(V))
    got = tdc._oa_refine(torch.as_tensor(X), torch.as_tensor(V))
    names = ("V_new", "mu", "mu_min", "mu_max", "gersh_min", "gersh2_min",
             "bmin")
    for name, g, r in zip(names, got, ref):
        r = np.asarray(r)
        g = g.numpy()
        assert np.max(np.abs(g - r)) <= 1e-10 * max(np.max(np.abs(r)), 1.0), \
            name


def test_oa_refine_twin_is_the_jax_algebra():
    """K6's twin alone: E and the Gershgorin row quantities, with a
    near-degenerate pair to take the R/2 branch."""
    rs = np.random.RandomState(6)
    n = 40
    V = np.linalg.qr(rs.randn(n, n))[0] + 1e-6 * rs.randn(n, n)
    S = rs.randn(n, n)
    S = 0.5 * (S + S.T)
    B = V.T @ V
    mu = np.diag(S) / np.diag(B)
    mu[3] = mu[7] * (1 + 1e-9)
    t = [torch.as_tensor(a) for a in (S, B, mu)]
    E, bsum, g1, g2 = K.oa_refine(*t, torch.min(t[2]), torch.max(t[2]))
    eye = np.eye(n)
    R = eye - B
    mn, mx = mu.min(), mu.max()
    d = mu[None, :] - mu[:, None]
    safe = np.abs(d) > 1e-3 * (max(abs(mn), abs(mx)) + 1e-30)
    E_ref = np.where(safe, (S + mu[None, :] * R) / np.where(safe, d, 1.0),
                     0.5 * R)
    assert not safe[3, 7] and np.max(np.abs(E.numpy() - E_ref)) <= 1e-12
    np.testing.assert_allclose(bsum.numpy(),
                               np.sum(np.abs(B - eye), axis=1), rtol=1e-13)
    for g, G in ((g1, S - mn * B), (g2, mx * B - S)):
        off = np.sum(np.abs(G), axis=1) - np.abs(np.diag(G))
        np.testing.assert_allclose(g.numpy(), np.diag(G) - off, rtol=1e-12,
                                   atol=1e-12)


@pytest.mark.parametrize("case", ["far", "near", "ritz", "eigh64"])
def test_certify_tiers(case):
    """DenseEighCert.certify takes the driver's tier and counts it: far;
    a near bound that certifies; an uncertified bound whose Ritz value
    already proves dinf > 2 tol; otherwise the exact f64 eigh."""
    n, tol = 120, 1e-8
    neg = {"ritz": 1e-3, "eigh64": 0.0}.get(case, 0.0)
    X, lam = _planted(n, 4, cluster_spread=1e-10, neg=neg, seed=7)
    dc = tdc.DenseEighCert(n, k=5, refine_max=3)
    if case in ("ritz", "eigh64"):
        dc.refine_max = 1             # one step: the bound misses 0.1 tol
        X = X + 1e-3 * np.diag(np.random.RandomState(1).rand(n))
        lam = np.linalg.eigvalsh(X)
    tdc.reset_counts()
    res = dc.certify(torch.as_tensor(X), far=case == "far", tol=tol)
    assert tdc.COUNTS == {k: int(k == case) for k in tdc.COUNTS}
    scale = 1.0 + abs(lam[-1])
    if case == "eigh64":
        assert res.lam_min == pytest.approx(lam[0], abs=1e-12 * scale)
    elif case == "near":                  # a certified lower bound
        assert lam[0] - 1e-9 * scale <= res.lam_min <= lam[0] + 1e-12 * scale
    elif case == "ritz":                  # a Rayleigh quotient: above lam_min
        assert lam[0] - 1e-12 * scale <= res.lam_min < -2 * tol * scale
    assert res.neg_vecs.shape == (n, 5)
