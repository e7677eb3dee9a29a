"""The port's subpackage exports and the functions behind them against
the JAX package: each subpackage's ``__all__``; ``ops.dual_certificate``
(eigh, lobpcg, auto) on a seeded 200 x 200 S; ``ops.eigs_rr.lobpcg_rows``;
``solvers.common.sigma_update`` over a grid; ``parallel.spawn_ranks``'s
default device.  The same numpy inputs go to both packages."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import threadpoolctl
import torch

from manisdp_tpu.config import SolverOptions as JOptions
from manisdp_tpu.ops.eigs import dual_certificate as j_dual_certificate
from manisdp_tpu.ops.eigs_rr import lobpcg_rows as j_lobpcg_rows
from manisdp_tpu.solvers.common import sigma_update as j_sigma_update
from manisdp_tpu_torch.config import SolverOptions
from manisdp_tpu_torch.ops import CertResult, dual_certificate
from manisdp_tpu_torch.ops.eigs_rr import lobpcg_rows
from manisdp_tpu_torch.parallel import spawn_ranks
from manisdp_tpu_torch.solvers.common import sigma_update


@pytest.fixture(autouse=True, scope="module")
def _one_cpu_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpoolctl.threadpool_limits(1):
        yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("sub", ["ops", "solvers", "frontends", "utils",
                                 "manifolds", "parallel"])
def test_subpackage_all_matches_jax(sub):
    """Every name the JAX subpackage exports, the port's exports too (the
    port's ``parallel`` adds its launcher, ``init_distributed`` and
    ``spawn_ranks``); each exported name resolves."""
    jmod = importlib.import_module(f"manisdp_tpu.{sub}")
    tmod = importlib.import_module(f"manisdp_tpu_torch.{sub}")
    extra = {"init_distributed", "spawn_ranks"} if sub == "parallel" else set()
    assert set(tmod.__all__) == set(jmod.__all__) | extra
    for name in tmod.__all__:
        assert getattr(tmod, name) is not None


def test_manifold_protocol():
    from manisdp_tpu_torch.manifolds import Euclidean, Manifold, Oblique, \
        Sphere
    for m in (Oblique, Sphere, Euclidean):
        for meth in ("inner", "norm", "proj", "retr", "zerovec",
                     "typicaldist"):
            assert callable(getattr(m, meth))
    assert getattr(Manifold, "_is_protocol", False)


def _sym(n=200, seed=11):
    rs = np.random.RandomState(seed)
    A = rs.randn(n, n)
    S = (A + A.T) / 2
    return S, np.linalg.eigvalsh(S)


def _resid(S, vecs, vals):
    """The largest eigen-residual ||S v - lam v|| of the (n, k) pairs."""
    return float(np.max(np.linalg.norm(S @ vecs - vecs * vals[None, :],
                                       axis=0)))


@pytest.mark.parametrize("method", ["eigh", "lobpcg", "auto"])
def test_dual_certificate_matches_jax(method):
    """lambda_min, the bottom-k values and (eigh, auto: n < eig_switch_n
    picks eigh) lambda_max to 1e-10 (eigh) / 1e-8 (lobpcg, auto) of the
    JAX package's; vectors through their residuals.  On the lobpcg path
    lambda_max is each package's Lanczos upper estimate from its own
    random start (ops/eigs.py: the top Ritz value padded by the last
    beta), so there both must bound the true lambda_max from above."""
    S, ref = _sym()
    n, k = S.shape[0], 6
    tol = 1e-10 if method == "eigh" else 1e-8
    Sj = jnp.asarray(S)
    jres = j_dual_certificate(method, n, k, S_dense=Sj,
                              matvec=lambda V: Sj @ V,
                              key=jax.random.PRNGKey(0), lobpcg_tol=1e-10)
    St = torch.as_tensor(S)
    gen = torch.Generator()
    gen.manual_seed(0)
    tres = dual_certificate(method, n, k, S_dense=St,
                            matvec_rows=lambda V: V @ St, gen=gen,
                            lobpcg_tol=1e-10)
    assert isinstance(tres, CertResult)
    tv, jv = tres.neg_vals.numpy(), np.asarray(jres.neg_vals)
    np.testing.assert_allclose(tv, jv, rtol=0, atol=tol)
    np.testing.assert_allclose(tv, ref[:k], rtol=0, atol=tol)
    assert abs(float(tres.lam_min) - float(jres.lam_min)) <= tol
    assert float(tres.lam_min) <= ref[0] + 1e-12
    if method == "lobpcg":
        assert float(tres.lam_max) >= ref[-1] - tol
        assert float(jres.lam_max) >= ref[-1] - tol
    else:
        assert abs(float(tres.lam_max) - float(jres.lam_max)) <= tol
        assert int(tres.num_neg) == int(jres.num_neg) == int(np.sum(ref < 0))
    # the port's vectors to 1e-6; the JAX routine (lobpcg_standard) stops
    # on a residual relative to 10 n |A x|, so its vectors to 1e-4
    tvec = tres.neg_vecs.numpy()
    assert tvec.shape == (n, k)
    assert _resid(S, tvec, tv) <= 1e-6
    assert _resid(S, np.asarray(jres.neg_vecs), jv) <= 1e-4


def test_dual_certificate_rejects_missing_inputs():
    with pytest.raises(ValueError, match="S_dense"):
        dual_certificate("eigh", 10, 2)
    with pytest.raises(ValueError, match="matvec_rows"):
        dual_certificate("lobpcg", 10, 2, S_dense=torch.eye(10))
    with pytest.raises(ValueError, match="unknown"):
        dual_certificate("dense", 10, 2, S_dense=torch.eye(10))


def test_lobpcg_rows_matches_jax():
    """The one-shot rowrr wrapper: the bottom-k Ritz values to 1e-9 of
    the JAX package's lobpcg_rows (and of eigvalsh); lambda_min, the
    bottom Ritz value less its residual (which depends on where each
    solve stopped), a lower bound within 1e-8 in both; Ritz vectors with
    small residuals; with a deflation factor as well."""
    S, ref = _sym(300, 7)
    n, k = S.shape[0], 5
    Sj, St = jnp.asarray(S), torch.as_tensor(S)
    jres = j_lobpcg_rows(lambda V: V @ Sj, n, k, jax.random.PRNGKey(0),
                         maxiter=200, tol=1e-10)
    gen = torch.Generator()
    gen.manual_seed(0)
    tres = lobpcg_rows(lambda V: V @ St, n, k, gen, maxiter=200, tol=1e-10)
    tv = tres.neg_vals.numpy()
    np.testing.assert_allclose(tv, np.asarray(jres.neg_vals), rtol=0,
                               atol=1e-9)
    np.testing.assert_allclose(tv, ref[:k], rtol=0, atol=1e-9)
    for lam in (float(tres.lam_min), float(jres.lam_min)):
        assert ref[0] - 1e-8 <= lam <= ref[0] + 1e-12
    assert float(tres.lam_max) >= ref[-1] - 1e-6
    assert _resid(S, tres.neg_vecs.numpy(), tv) <= 1e-7
    Y = np.random.RandomState(3).randn(6, n)
    jd = j_lobpcg_rows(lambda V: V @ Sj, n, k, jax.random.PRNGKey(1),
                       maxiter=200, tol=1e-10, deflate=jnp.asarray(Y))
    td = lobpcg_rows(lambda V: V @ St, n, k, gen, maxiter=200, tol=1e-10,
                     deflate=torch.as_tensor(Y))
    np.testing.assert_allclose(td.neg_vals.numpy(), np.asarray(jd.neg_vals),
                               rtol=0, atol=1e-9)


def test_sigma_update_matches_jax():
    """sigma_update over a grid of (pinf, gradnorm), sigma at and away
    from its clamps, the default and a custom schedule: bit-equal."""
    custom = dict(tau1=0.3, tau2=3.0, gama=1.7, sigma_min=1e-2,
                  sigma_max=1e3)
    for kw in ({}, custom):
        jopt, topt = JOptions(**kw), SolverOptions(**kw)
        for sigma in (topt.sigma_min, 0.37, 1.0, 42.0, topt.sigma_max):
            for pinf in (0.0, 1e-9, 1e-3, 0.5, 2.0, 1e3):
                for gradnorm in (0.0, 1e-9, 1e-3, 0.5, 2.0, 1e3):
                    got = sigma_update(sigma, pinf, gradnorm, topt)
                    want = j_sigma_update(sigma, pinf, gradnorm, jopt)
                    assert got == want and type(got) is type(want)


def test_spawn_ranks_defaults_to_the_card(monkeypatch):
    """spawn_ranks runs on the card unless asked for the CPU: without one
    its default raises before any rank starts, as resolve_device does."""
    import torch.multiprocessing as mp

    def no_spawn(*a, **kw):
        raise AssertionError("a rank was started")

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(mp, "spawn", no_spawn)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        spawn_ranks(print, 1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        spawn_ranks(print, 2, "gloo", "cuda:0")
