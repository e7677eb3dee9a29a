"""Kernel build and launch plumbing of manisdp_tpu_torch, and K1-K6 on
the card against their plain twins.

This file imports no jax, so the card tests run on a machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py
"""

import importlib

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import chip_smoke
from manisdp_tpu_torch import kernels as K
from manisdp_tpu_torch.ops.sparse import (ConstraintOp, DenseConstraintOp,
                                          SymCOO)

# the module, not the build() function that kernels/__init__ re-exports
B = importlib.import_module("manisdp_tpu_torch.kernels.build")
N = 40


def _rel(got, ref):
    got, ref = got.double().cpu(), ref.double().cpu()
    return float(torch.max(torch.abs(got - ref)) /
                 max(float(torch.max(torch.abs(ref))), 1e-300))


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(B, "_lib", None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(B, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        B.build()
    assert B._lib is None


def test_library_name_tracks_sources_and_flags():
    path = B._lib_path()
    assert path.parent == B.BUILD_DIR
    assert B.BUILD_DIR.parts[-2:] == ("build", "manisdp_tpu_torch")
    for name in B.SOURCES:
        assert (B.SRC_DIR / name).exists()
    assert "arch=compute_90a,code=sm_90a" in B.FLAGS
    assert path == B._lib_path()                  # deterministic


def test_reset_launches():
    K.LAUNCHES["symcoo_spmm"] = 3
    K.SPMM_LAUNCHES["al_hess"] = 2
    K.CSR_LAUNCHES["scatter_pos"] = 4
    K.MASKED_LAUNCHES["aat"] = 5
    K.reset_launches()
    assert K.LAUNCHES == {"symcoo_spmm": 0, "oblique_cols": 0,
                          "pattern_dots": 0, "csr_gather": 0,
                          "masked_sym": 0, "oa_refine": 0}
    assert set(K.SPMM_LAUNCHES) == set(K.SPMM_MODES)
    assert set(K.MASKED_LAUNCHES) == set(K.MASKED_MODES)
    assert set(K.CSR_LAUNCHES) == {"gather", "scatter_pos"}
    for counts in (K.SPMM_LAUNCHES, K.CSR_LAUNCHES, K.MASKED_LAUNCHES):
        assert not any(counts.values())


def test_carrier_wrappers_reject_bad_modes_anywhere():
    """Checks that hold before any device is touched (CPU tensors too)."""
    E = torch.ones((3, 3), dtype=torch.float64)
    with pytest.raises(ValueError, match="unknown"):
        K.masked_sym(E, E, E, "transpose")
    with pytest.raises(ValueError, match="dfac"):
        K.masked_sym(E, E, None, "apply")                 # apply needs dfac
    with pytest.raises(ValueError, match="C"):
        K.masked_sym(E, E, E, "apply", C=E)               # only axpy takes C
    ptr = torch.tensor([0, 1], dtype=torch.int32)
    with pytest.raises(ValueError, match="size"):
        K.csr_gather(E[0], ptr, ptr[:1], E[0, :1], pos=ptr[:1])


def test_chip_smoke_refuses_without_cuda(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert chip_smoke.main([]) == 1
    out = capsys.readouterr()
    assert out.out == "" and "no CUDA device" in out.err


@pytest.mark.parametrize("name,n,edges", [("G1", 800, 19176),
                                          ("G67", 10000, 20000)])
def test_chip_smoke_standins_have_gset_shape(name, n, edges):
    C, label = chip_smoke.load_graph(name, None, 0)
    assert "stand-in" in label and C.shape == (n, n)
    assert abs(C - C.T).max() == 0
    off = sp.triu(C, 1)
    assert off.nnz == edges
    np.testing.assert_allclose(np.asarray(C.sum(axis=0)).ravel(), 0.0,
                               atol=1e-12)              # C = -L/4


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("p_pad", [8, 48, 96, 136])
def test_kernels_match_twins_on_card(cuda_device, dtype, p_pad):
    """Every K1 and K2 mode on the card against its twin on the same
    inputs; p_pad = 8, 48 and 96 take K1's one-pass widths of 1, 2 and 4
    chunks of 32 rows, p_pad = 136 its two-pass Hessian path."""
    tol = {torch.float64: 1e-12, torch.float32: 1e-5}[dtype]
    rs = np.random.RandomState(11)
    A = sp.random(N, N, density=0.15, random_state=rs)
    A = A + A.T + sp.diags(rs.randn(N))
    C = SymCOO.from_scipy(A, cuda_device).astype(dtype)
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(0)
    rnd = lambda *s: torch.randn(s, generator=gen, dtype=dtype,  # noqa: E731
                                 device=cuda_device)
    Y = K.oblique_cols_plain(rnd(p_pad, N), None, "renormalize")
    U = K.oblique_cols_plain(Y, rnd(p_pad, N), "proj")
    eG = K.symcoo_spmm_plain(Y, C, "cost")[1]
    cases = [(K.symcoo_spmm, K.symcoo_spmm_plain, (Y, C, m), kw)
             for m, kw in (("plain", {}), ("shift", dict(z=rnd(N))),
                           ("cost", {}), ("hess", dict(B=Y, eG=eG)))]
    cases.append((K.symcoo_spmm, K.symcoo_spmm_plain,
                  (rnd(N, 7).T, C, "plain"), {}))
    cases += [(K.oblique_cols, K.oblique_cols_plain, (Y, U, m), {})
              for m in ("proj", "retr")]
    cases.append((K.oblique_cols, K.oblique_cols_plain,
                  (Y + U, None, "renormalize"), {}))
    before = dict(K.LAUNCHES)
    for fn, twin, args, kw in cases:
        got, ref = fn(*args, **kw), twin(*args, **kw)
        got = got if isinstance(got, tuple) else (got,)
        ref = ref if isinstance(ref, tuple) else (ref,)
        for g, r in zip(got, ref):
            assert g.device.type == "cuda"
            assert _rel(g, r) <= tol
    torch.cuda.synchronize()
    assert K.LAUNCHES["symcoo_spmm"] - before["symcoo_spmm"] == 5
    assert K.LAUNCHES["oblique_cols"] - before["oblique_cols"] == 3


@pytest.mark.cuda
def test_wrapper_rejects_what_the_kernel_does_not_take(cuda_device):
    C = SymCOO.from_scipy(sp.eye(N, format="csr"), cuda_device)
    Y = torch.ones((4, N), dtype=torch.float64, device=cuda_device)
    with pytest.raises(TypeError):
        K.symcoo_spmm(Y.float(), C, "plain")              # dtype mix
    with pytest.raises(ValueError):
        K.oblique_cols(Y.T, Y.T, "proj")                  # not contiguous
    with pytest.raises(ValueError):
        K.symcoo_spmm(Y, C, "hess", B=Y[:2], eG=Y[0])     # B shape
    with pytest.raises(ValueError, match="devices"):
        K.symcoo_spmm(Y.cpu(), C, "plain")                # CPU / CUDA mix


def _constraint_op(device, n=N, m=60, seed=3):
    """A random symmetric constraint set whose pattern has entries that
    only C touches (empty adjoint segments) and an empty constraint."""
    rs = np.random.RandomState(seed)
    rows, cols, vals = [], [], []
    for k in range(m):
        if k == 7:
            continue
        for _ in range(rs.randint(1, 3)):
            i, j = rs.randint(0, n, 2)
            rows += [i + j * n, j + i * n] if i != j else [i + j * n]
            cols += [k, k] if i != j else [k]
            vals += [rs.randn()] * (2 if i != j else 1)
    At = sp.coo_matrix((vals, (rows, cols)), shape=(n * n, m)).tocsc()
    c = np.diag(rs.randn(n)).flatten(order="F")
    return ConstraintOp.build(At, rs.randn(m), c, n, device)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("p_pad", [8, 24, 48, 136])
def test_al_kernels_match_twins_on_card(cuda_device, dtype, p_pad):
    """K3, K4 in both orderings (with and without base / alpha) and K1's
    al_hess mode (epilogues none and diag) on the card against their
    twins; p_pad = 136 takes K1's and K3's multi-pass paths."""
    tol = {torch.float64: 1e-12, torch.float32: 1e-5}[dtype]
    op = _constraint_op(cuda_device).astype(dtype)
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(1)
    rnd = lambda *s: torch.randn(s, generator=gen, dtype=dtype,  # noqa: E731
                                 device=cuda_device)
    Y, U = rnd(p_pad, N), rnd(p_pad, N)
    e, w = rnd(op.pat.nnz), rnd(op.m)
    es, ayu = rnd(op.pat.nnz), rnd(op.pat.nnz)
    hess = dict(vals=es, B=Y, vals2=ayu, coefs=(2.0, 1.48))
    cases = [(K.pattern_dots, K.pattern_dots_plain, (Y, U, op.pat), {}),
             (K.pattern_dots, K.pattern_dots_plain, (Y.T.contiguous().T,
                                                     U, op.pat), {}),
             (K.csr_gather, K.csr_gather_plain,
              (e, op.krow_ptr, op.a2p, op.v), {}),
             (K.csr_gather, K.csr_gather_plain,
              (w, op.pat_ptr, op.kp, op.vp), {}),
             (K.csr_gather, K.csr_gather_plain,
              (w, op.pat_ptr, op.kp, op.vp), dict(base=op.pat.v,
                                                  alpha=0.37)),
             (K.csr_gather, K.csr_gather_plain,
              (w, op.pat_ptr, op.kp, op.vp), dict(base=op.pat.v,
                                                  alpha=-1.0)),
             (K.symcoo_spmm, K.symcoo_spmm_plain, (U, op.pat, "al_hess"),
              hess),
             (K.symcoo_spmm, K.symcoo_spmm_plain, (U, op.pat, "al_hess"),
              dict(hess, eG=rnd(N)))]
    before = dict(K.LAUNCHES)
    al_before = K.SPMM_LAUNCHES["al_hess"]
    for fn, twin, args, kw in cases:
        got, ref = fn(*args, **kw), twin(*args, **kw)
        assert got.device.type == "cuda"
        assert _rel(got, ref) <= tol
    torch.cuda.synchronize()
    assert K.LAUNCHES["pattern_dots"] - before["pattern_dots"] == 2
    assert K.LAUNCHES["csr_gather"] - before["csr_gather"] == 4
    assert K.SPMM_LAUNCHES["al_hess"] - al_before == 2
    # the pattern entries only C touches come out as base alone
    empty = torch.nonzero(op.pat_ptr[1:] == op.pat_ptr[:-1]).ravel()
    assert empty.numel() > 0
    got = K.csr_gather(w, op.pat_ptr, op.kp, op.vp, base=op.pat.v,
                       alpha=0.37)
    assert torch.equal(got[empty], op.pat.v[empty])


@pytest.mark.cuda
def test_al_wrappers_reject_what_the_kernels_do_not_take(cuda_device):
    op = _constraint_op(cuda_device)
    Y = torch.ones((4, N), dtype=torch.float64, device=cuda_device)
    w = torch.ones((op.m,), dtype=torch.float64, device=cuda_device)
    with pytest.raises(TypeError):
        K.csr_gather(w.float(), op.pat_ptr, op.kp, op.vp)   # dtype mix
    with pytest.raises(TypeError):
        K.csr_gather(w, op.pat_ptr.long(), op.kp, op.vp)    # int64 ptr
    with pytest.raises(ValueError):
        K.pattern_dots(Y, Y[:2], op.pat)                    # U shape
    with pytest.raises(ValueError):
        K.symcoo_spmm(Y, op.pat, "al_hess", vals=op.pat.v, B=Y,
                      vals2=op.pat.v[:-1])                  # vals2 shape
    with pytest.raises(ValueError, match="missing"):
        K.symcoo_spmm(Y, op.pat, "al_hess", B=Y)            # no vals2
    with pytest.raises(ValueError, match="devices"):
        K.csr_gather(w.cpu(), op.pat_ptr, op.kp, op.vp)     # CPU / CUDA mix


def _carrier_inputs(device, dtype, n, seed=2):
    """A symmetric entrywise mask (aval, dfac as the carrier has them: dfac
    1 off the diagonal, 0.5 on it) and random dense operands."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    rnd = lambda *s: torch.randn(s, generator=gen, dtype=dtype,  # noqa: E731
                                 device=device)
    mask = torch.rand((n, n), generator=gen, device=device) < 0.3
    mask = mask | mask.T
    aval = torch.where(mask, rnd(n, n), torch.zeros((), dtype=dtype,
                                                    device=device))
    aval = torch.triu(aval) + torch.triu(aval, 1).T
    dfac = torch.where(mask, 1.0, 0.0).to(dtype)
    dfac.diagonal().mul_(0.5)
    return aval, dfac, rnd(n, n), rnd(n, n)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("n", [40, 77])
def test_masked_sym_matches_twin_on_card(cuda_device, dtype, n):
    """K5's three modes on the card against their twin; n = 77 leaves
    ragged 32 x 32 tiles on the diagonal and the edges."""
    tol = {torch.float64: 1e-12, torch.float32: 1e-5}[dtype]
    aval, dfac, E, C = _carrier_inputs(cuda_device, dtype, n)
    cases = [((E, aval, dfac, "apply"), {}), ((E, aval, dfac, "aat"), {}),
             ((E, aval, None, "axpy"), dict(C=C, alpha=0.37)),
             ((E, aval, None, "axpy"), dict(C=C, alpha=-1.0)),
             ((E, aval, None, "axpy"), {})]
    before = dict(K.MASKED_LAUNCHES)
    for args, kw in cases:
        got, ref = K.masked_sym(*args, **kw), K.masked_sym_plain(*args, **kw)
        assert got.device.type == "cuda" and got.dtype == dtype
        assert _rel(got, ref) <= tol
    torch.cuda.synchronize()
    assert {m: K.MASKED_LAUNCHES[m] - before[m] for m in before} == \
        {"apply": 1, "aat": 1, "axpy": 3}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_csr_gather_scatter_pos_matches_twin_on_card(cuda_device, dtype):
    """K4's scatter_pos mode on the dense carrier's position order, with
    base (es / s) and without (the adjoint), plus a hand-made row whose
    segment is empty; positions no A entry touches keep base exactly."""
    tol = {torch.float64: 1e-12, torch.float32: 1e-5}[dtype]
    op = DenseConstraintOp.from_op(_constraint_op(cuda_device)).astype(dtype)
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(4)
    w = torch.randn((op.m,), generator=gen, dtype=dtype, device=cuda_device)
    base = op.C.reshape(-1)
    size = N * N
    for kw in (dict(base=base, alpha=0.37), dict(base=base, alpha=-1.0),
               {}):
        args = (w, op.pos_ptr, op.kq, op.vq)
        got = K.csr_gather(*args, pos=op.pos, size=size, **kw)
        ref = K.csr_gather_plain(*args, pos=op.pos, size=size, **kw)
        assert _rel(got, ref) <= tol
    off = torch.ones(size, dtype=torch.bool, device=cuda_device)
    off[op.pos.long()] = False
    assert torch.equal(got[off], torch.zeros_like(got[off]))
    got = K.csr_gather(w, op.pos_ptr, op.kq, op.vq, base=base, alpha=0.37,
                       pos=op.pos, size=size)
    assert torch.equal(got[off], base[off]) and (base[off] != 0).any()
    # rows 0 and 2 have entries, row 1 an empty segment
    i32 = dict(dtype=torch.int32, device=cuda_device)
    ptr = torch.tensor([0, 2, 2, 3], **i32)
    col = torch.tensor([0, 1, 2], **i32)
    val = torch.tensor([1.0, 2.0, 3.0], dtype=dtype, device=cuda_device)
    pos = torch.tensor([5, 1, 7], **i32)
    x = torch.tensor([1.0, 10.0, 100.0], dtype=dtype, device=cuda_device)
    b = torch.arange(9, dtype=dtype, device=cuda_device)
    got = K.csr_gather(x, ptr, col, val, base=b, alpha=2.0, pos=pos, size=9)
    want = b.clone()
    want[5] += 2.0 * 21.0
    want[7] += 2.0 * 300.0
    assert torch.equal(got, want)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("n", [40, 300])
def test_oa_refine_matches_twin_on_card(cuda_device, n):
    """K6 (f64) against its twin on a near-orthonormal basis of a random
    symmetric matrix, with one near-degenerate pair."""
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(5)
    f64 = dict(dtype=torch.float64, device=cuda_device)
    X = torch.randn((n, n), generator=gen, **f64)
    X = 0.5 * (X + X.T)
    V = torch.linalg.eigh(X.float())[1].double()
    S = V.T @ X @ V
    S = 0.5 * (S + S.T)
    B = V.T @ V
    mu = torch.diagonal(S) / torch.diagonal(B)
    mu[3] = mu[7] * (1 + 1e-9)
    args = (S, B, mu.contiguous(), torch.min(mu), torch.max(mu))
    before = K.LAUNCHES["oa_refine"]
    got, ref = K.oa_refine(*args), K.oa_refine_plain(*args)
    for g, r in zip(got, ref):
        assert _rel(g, r) <= 1e-12
    torch.cuda.synchronize()
    assert K.LAUNCHES["oa_refine"] - before == 1


@pytest.mark.cuda
def test_carrier_wrappers_reject_what_the_kernels_do_not_take(cuda_device):
    E = torch.ones((8, 8), dtype=torch.float64, device=cuda_device)
    with pytest.raises(TypeError):
        K.masked_sym(E.float(), E, E, "apply")            # dtype mix
    with pytest.raises(ValueError):
        K.masked_sym(E[:, :4], E[:, :4], E[:, :4], "apply")  # not square
    with pytest.raises(ValueError):
        K.masked_sym(E.T[::2], E[::2], None, "axpy")      # not contiguous
    mu = torch.ones(8, dtype=torch.float64, device=cuda_device)
    with pytest.raises(TypeError, match="float64"):
        K.oa_refine(E.float(), E.float(), mu.float(), mu[0].float(),
                    mu[0].float())
    with pytest.raises(ValueError, match="devices"):
        K.masked_sym(E.cpu(), E, E, "apply")              # CPU / CUDA mix
