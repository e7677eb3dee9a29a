"""Kernel build and launch plumbing of manisdp_tpu_torch, and K1-K11 on
the card against their plain twins.

This file imports no jax, so the card tests run on a machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py
"""

import gc
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


def test_library_name_tracks_included_headers():
    """Every header a kernel source includes is hashed into the library
    name, so an edited header is never served from a stale build."""
    import re
    included = {m for name in B.SOURCES for m in re.findall(
        r'#include "([^"]+)"', (B.SRC_DIR / name).read_text())}
    assert included and included == set(B.HEADERS)
    assert {p.name for p in B.SRC_DIR.glob("*.cuh")} == set(B.HEADERS)


def test_reset_launches():
    K.LAUNCHES["symcoo_spmm"] = 3
    K.SPMM_LAUNCHES["al_hess"] = 2
    K.CSR_LAUNCHES["scatter_pos"] = 4
    K.MASKED_LAUNCHES["aat"] = 5
    K.OBLIQUE_LAUNCHES["proj_eG"] = 6
    K.SYMDUAL_LAUNCHES["sym_mat"] = 7
    K.LAUNCHES["symmom_adjoint"] = 8
    K.OBLIQUE_LAUNCHES["masked"] = 9
    K.INSTANCE_LAUNCHES["symcoo_spmm"] = 10
    K.TCG_LAUNCHES["projected"] = 11
    K.LAUNCHES["tcg_step"] = 12
    K.SYMDUAL_APPLY_LAUNCHES["rows"] = 13
    K.TCG_LAUNCHES["split"] = 14
    K.COLLECTIVES["all_to_all"] = 15
    K.TCG_LAUNCHES["peer"] = 16
    K.reset_launches()
    assert K.LAUNCHES == {"symcoo_spmm": 0, "oblique_cols": 0,
                          "pattern_dots": 0, "csr_gather": 0,
                          "masked_sym": 0, "oa_refine": 0,
                          "symdual_apply": 0, "symdual_adjoint": 0,
                          "symmom_apply": 0, "symmom_adjoint": 0,
                          "tcg_step": 0}
    assert set(K.SPMM_LAUNCHES) == set(K.SPMM_MODES)
    assert set(K.MASKED_LAUNCHES) == set(K.MASKED_MODES)
    assert set(K.CSR_LAUNCHES) == {"gather", "scatter_pos"}
    assert set(K.OBLIQUE_LAUNCHES) == set(K.OBLIQUE_MODES) | {"proj_eG",
                                                              "masked"}
    assert set(K.SYMDUAL_LAUNCHES) == {"adjoint", "residual", "sym_factor",
                                       "sym_mat", "adjoint_rows"}
    assert set(K.SYMDUAL_APPLY_LAUNCHES) == {"rows"}
    assert set(K.INSTANCE_LAUNCHES) == {"symcoo_spmm", "oblique_cols"}
    assert set(K.TCG_LAUNCHES) == {"projected", "split", "peer"}
    for counts in (K.SPMM_LAUNCHES, K.CSR_LAUNCHES, K.MASKED_LAUNCHES,
                   K.OBLIQUE_LAUNCHES, K.SYMDUAL_LAUNCHES,
                   K.SYMDUAL_APPLY_LAUNCHES, K.INSTANCE_LAUNCHES,
                   K.TCG_LAUNCHES, K.COLLECTIVES):
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


def test_chip_smoke_bqp_reader(tmp_path):
    """--bqp DIR reads the reference's comma-separated Q / e files; without
    them the seeded stand-in of bench.py is used and labelled so."""
    Q, e, label = chip_smoke.bqp_instance(6, None)
    assert "stand-in" in label and Q.shape == (6, 6) and e.shape == (6,)
    np.testing.assert_array_equal(Q, Q.T)
    Q2 = np.arange(9.0).reshape(3, 3)
    np.savetxt(tmp_path / "bqp_Q_3_1.txt", Q2 + Q2.T, delimiter=",")
    np.savetxt(tmp_path / "bqp_e_3_1.txt", np.ones(3), delimiter=",")
    Q3, e3, label = chip_smoke.bqp_instance(3, str(tmp_path))
    assert "reference" in label
    np.testing.assert_array_equal(Q3, Q2 + Q2.T)
    np.testing.assert_array_equal(e3, np.ones(3))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("p_pad", [8, 16, 40, 48, 96, 136])
def test_kernels_match_twins_on_card(cuda_device, dtype, p_pad):
    """Every K1 and K2 mode on the card against its twin on the same
    inputs; K1 takes rows in chunks of 32 vectors (64 rows f64, 128 f32),
    so p_pad = 96 is one chunk in f32 and two in f64, and 136 takes the
    Hessian's second gather in both."""
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
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("p", [3, 9, 16, 40, 136])
def test_k1_layouts_are_bit_equal_on_card(cuda_device, dtype, p):
    """K1 on a row-major factor (transposed into the kernel's N-major
    copy) and on the same factor as an N-major view (gathered in place,
    16-B or scalar loads), in every mode and instance mode: the same
    bits, since every element is the same chain in entry order."""
    from manisdp_tpu_torch.ops.sparse import BatchedSymCOO
    rs = np.random.RandomState(13)
    A = sp.random(N, N, density=0.15, random_state=rs)
    A = A + A.T + sp.diags(rs.randn(N))
    C = SymCOO.from_scipy(A, cuda_device).astype(dtype)
    Cb = BatchedSymCOO.from_scipy([A, A[:30, :30]], N, cuda_device, dtype)
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(p)
    rnd = lambda *s: torch.randn(s, generator=gen, dtype=dtype,  # noqa: E731
                                 device=cuda_device)
    nmajor = lambda X: X.transpose(-1, -2).contiguous().transpose(-1, -2)  # noqa: E731
    Y, U, z, eG = rnd(p, N), rnd(p, N), rnd(N), rnd(N)
    es, ayu = rnd(C.nnz), rnd(C.nnz)
    Yb, Ub, zb, eGb = rnd(2, p, N), rnd(2, p, N), rnd(2, N), rnd(2, N)
    al = dict(vals=es, vals2=ayu, coefs=(2.0, 0.3))
    cases = [(Y, None, C, "plain", {}), (Y, None, C, "shift", dict(z=z)),
             (Y, None, C, "cost", {}), (U, Y, C, "hess", dict(eG=eG)),
             (U, Y, C, "al_hess", al), (U, Y, C, "al_hess", dict(al, eG=eG)),
             (Yb, None, Cb, "plain", {}), (Yb, None, Cb, "cost", {}),
             (Yb, None, Cb, "shift", dict(z=zb)),
             (Ub, Yb, Cb, "hess", dict(eG=eGb))]
    for X, B, CC, mode, kw in cases:
        bkw = {} if B is None else dict(B=B)
        bkt = {} if B is None else dict(B=nmajor(B))
        got = K.symcoo_spmm(X, CC, mode, **bkw, **kw)
        again = K.symcoo_spmm(nmajor(X), CC, mode, **bkt, **kw)
        got = got if isinstance(got, tuple) else (got,)
        again = again if isinstance(again, tuple) else (again,)
        assert all(torch.equal(g, a) for g, a in zip(got, again)), mode
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("p_pad", [8, 16, 40, 48, 136])
def test_instance_modes_match_twins_on_card(cuda_device, dtype, p_pad):
    """K1's instance mode (ragged instances of n = 30, 40, 17 in one
    launch, padding columns with empty segments) and K2 with the instance
    stride against their twins; K1 on the identity gives the dense C."""
    from manisdp_tpu_torch.ops.sparse import BatchedSymCOO
    tol = {torch.float64: 1e-12, torch.float32: 1e-5}[dtype]
    rs = np.random.RandomState(12)
    mats = []
    for n in (30, N, 17):
        A = sp.random(n, n, density=0.2, random_state=rs)
        mats.append(A + A.T + sp.diags(rs.randn(n)))
    C = BatchedSymCOO.from_scipy(mats, N, cuda_device, dtype)
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(1)
    rnd = lambda *s: torch.randn(s, generator=gen, dtype=dtype,  # noqa: E731
                                 device=cuda_device)
    Y = K.oblique_cols_plain(rnd(3, p_pad, N), None, "renormalize")
    U = K.oblique_cols_plain(Y, rnd(3, p_pad, N), "proj")
    eG = K.symcoo_spmm_plain(Y, C, "cost")[1]
    before = dict(K.INSTANCE_LAUNCHES)
    cases = [(K.symcoo_spmm, K.symcoo_spmm_plain, (Y, C, m), kw)
             for m, kw in (("plain", {}), ("shift", dict(z=rnd(3, N))),
                           ("cost", {}), ("hess", dict(B=Y, eG=eG)))]
    cases += [(K.oblique_cols, K.oblique_cols_plain, (Y, U, m), {})
              for m in ("proj", "retr")]
    cases.append((K.oblique_cols, K.oblique_cols_plain,
                  (Y + U, None, "renormalize"), {}))
    cases.append((K.oblique_cols, K.oblique_cols_plain, (Y, U, "proj"),
                  dict(v=U, g=rnd(3, N))))
    for fn, twin, args, kw in cases:
        got, ref = fn(*args, **kw), twin(*args, **kw)
        got = got if isinstance(got, tuple) else (got,)
        ref = ref if isinstance(ref, tuple) else (ref,)
        for g, r in zip(got, ref):
            assert g.device.type == "cuda"
            assert _rel(g, r) <= tol
    AC = K.symcoo_spmm(Y, C, "plain")
    assert not torch.any(AC[0, :, 30:]) and not torch.any(AC[2, :, 17:])
    torch.cuda.synchronize()
    assert K.INSTANCE_LAUNCHES["symcoo_spmm"] - before["symcoo_spmm"] == 5
    assert K.INSTANCE_LAUNCHES["oblique_cols"] - before["oblique_cols"] == 4
    Cs = C.instance(1)
    assert torch.equal(Cs.to_dense().cpu(),
                       SymCOO.from_scipy(mats[1], "cpu").astype(dtype)
                       .to_dense())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("keep", [[3, 0, 2], [2, 3], [1]])
def test_instance_mode_on_a_selected_batch_on_card(cuda_device, dtype, keep):
    """K1's instance mode on ``BatchedSymCOO.select(keep)`` (the batch's
    live instances): each kept instance's ``plain``, ``cost`` and ``hess``
    within 1e-12 (f64) / 1e-5 (f32) of the twin, and bit-equal to its row
    of the whole batch's launch when both take the same walk (two dense
    instances put the whole batch on the deep walk; [2, 3] keeps the two
    sparse ones, which take the shallow one)."""
    from manisdp_tpu_torch.ops.sparse import BatchedSymCOO
    tol = {torch.float64: 1e-12, torch.float32: 1e-5}[dtype]
    rs = np.random.RandomState(14)
    mats = []
    for density in (0.6, 0.5, 0.04, 0.06):
        A = sp.random(N, N, density=density, random_state=rs)
        mats.append(A + A.T + sp.diags(rs.randn(N)))
    C = BatchedSymCOO.from_scipy(mats, N, cuda_device, dtype)
    sub = C.select(keep)
    deep = lambda CC: CC.v.shape[0] > K.SPMM_DEEP_MEAN * N * CC.nb  # noqa: E731
    assert deep(C) and deep(sub) == (keep != [2, 3])
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(2)
    rnd = lambda *s: torch.randn(s, generator=gen, dtype=dtype,  # noqa: E731
                                 device=cuda_device)
    Y = K.oblique_cols_plain(rnd(4, 40, N), None, "renormalize")
    U = K.oblique_cols_plain(Y, rnd(4, 40, N), "proj")
    rows = torch.tensor(keep, device=cuda_device)
    Ys, Us = Y[rows].contiguous(), U[rows].contiguous()
    whole = (K.symcoo_spmm(Y, C, "plain"), *K.symcoo_spmm(Y, C, "cost"))
    whole += (K.symcoo_spmm(U, C, "hess", B=Y, eG=whole[2]),)
    got = (K.symcoo_spmm(Ys, sub, "plain"), *K.symcoo_spmm(Ys, sub, "cost"))
    got += (K.symcoo_spmm(Us, sub, "hess", B=Ys, eG=got[2]),)
    ref = (K.symcoo_spmm_plain(Ys, sub, "plain"),
           *K.symcoo_spmm_plain(Ys, sub, "cost"))
    ref += (K.symcoo_spmm_plain(Us, sub, "hess", B=Ys, eG=ref[2]),)
    for g, w, r in zip(got, whole, ref):
        assert _rel(g, r) <= tol
        if deep(sub) == deep(C):
            assert torch.equal(g, w[rows])
    torch.cuda.synchronize()


def _tcg_state(device, dtype, shape, tangent, seed):
    """K11's inputs at one (B, p, n) shape: the vectors (d, Hd, eta, Heta,
    r) with <d, r> > 0, the scalar state (instance 1 set up for a model
    increase and the last one stopped when B > 1) and, with a tangent, a
    point Y of unit columns (and a random column mask)."""
    B = shape[0]
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    rnd = lambda *s: torch.randn(s, generator=gen, dtype=dtype,  # noqa: E731
                                 device=device)
    d, r, eta, Heta = (rnd(*shape) for _ in range(4))
    Hd = d * (1.0 + rnd(*shape).abs())
    d_r = torch.sum(d * r, dim=(1, 2))
    r = r * torch.sign(d_r)[:, None, None]
    sc = torch.tensor([0.3, 0.2, 5.0, 1.0, -1.0, 1e6, 1e-9, 1.0],
                      dtype=dtype, device=device).repeat(B, 1)
    sc[:, 3] = d_r.abs()
    st = torch.zeros((B, 2), dtype=torch.int32, device=device)
    if B > 1:
        sc[1, 3] *= 4.0                             # model increase
        st[B - 1, 1] = 2                            # stopped
    Y = mask = None
    if tangent is not None:
        Y = K.oblique_cols_plain(rnd(*shape), None, "renormalize")
    if tangent == "masked":
        mask = (torch.rand(shape[2], generator=gen, device=device) <
                0.5).to(dtype)
    return (d, Hd, eta, Heta, r), sc, st, Y, mask


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("shape", [(1, 48, 3000), (4, 8, N), (3, 192, 77)])
@pytest.mark.parametrize("tangent", [None, "oblique", "masked"])
def test_tcg_step_matches_twin_on_card(cuda_device, dtype, shape, tangent):
    """K11's one-launch step against its twin (the three passes' twins,
    then with a tangent K2's proj of the next direction): random vectors
    and scalar states, one instance stopped (left as it is), one with a
    model increase; a second call on the same inputs is bitwise equal.
    At p = 192 the f64 projection stages its column tiles in two row
    chunks."""
    tol = {torch.float64: 1e-12, torch.float32: 1e-5}[dtype]
    B = shape[0]
    (d, Hd, eta, Heta, r), sc, st, Y, mask = _tcg_state(
        cuda_device, dtype, shape, tangent, 2)

    def run(step):
        vecs = [t.clone() for t in (d, Hd, eta, Heta, r)]
        return step(*vecs, sc, st, 1, Y, mask)

    before = (K.LAUNCHES["tcg_step"], K.TCG_LAUNCHES["projected"])
    got = run(K.tcg_step)
    ref = run(K.tcg_step_plain)
    # a stopped instance's next direction is never read: the kernel leaves
    # it, the twin computes it
    act = slice(0, B - 1) if B > 1 else slice(0, 1)
    for g, f in zip(got[:4], ref[:4]):
        assert g.device.type == "cuda"
        assert _rel(g[act], f[act]) <= tol
    assert _rel(got[4], ref[4]) <= tol
    assert torch.equal(got[5], ref[5])
    if B > 1:
        for g, x in ((got[0], eta), (got[1], Heta), (got[2], r)):
            assert torch.equal(g[B - 1], x[B - 1])
        assert torch.equal(got[4][B - 1], sc[B - 1])
        assert torch.equal(got[0][1], eta[1])       # stop 6 keeps eta
    again = run(K.tcg_step)
    for a, g in zip(again, got):
        assert torch.equal(a, g)
    torch.cuda.synchronize()
    assert K.LAUNCHES["tcg_step"] - before[0] == 2
    assert K.TCG_LAUNCHES["projected"] - before[1] == (2 if tangent else 0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("p", [3, 8, 40, 48, 136, 192, 520])
def test_oblique_tiles_match_twin_on_card(cuda_device, dtype, p):
    """K2's column tiles in every mode against the twin: n not a multiple
    of the tile's width and odd (an f32 row pitch that is no multiple of
    16 bytes), with and without the mask, single and with the instance
    stride; every call repeated bit for bit.  At p = 520 the f64 tile is
    staged in row chunks."""
    tol = {torch.float64: 1e-12, torch.float32: 1e-5}[dtype]
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(7)
    rnd = lambda *s: torch.randn(s, generator=gen, dtype=dtype,  # noqa: E731
                                 device=cuda_device)
    before = K.LAUNCHES["oblique_cols"]
    calls = 0
    for shape in ((p, 333), (3, p, 301)):
        n = shape[-1]
        Y = K.oblique_cols_plain(rnd(*shape), None, "renormalize")
        H, U, g = rnd(*shape), rnd(*shape), rnd(*shape[:-2], n)
        mask = (torch.rand(n, generator=gen, device=cuda_device) <
                0.5).to(dtype)
        for m in (None, mask):
            for mode, u, kw in (("proj", H, {}), ("proj", H, dict(v=U, g=g)),
                                ("retr", H, {}), ("renormalize", None, {})):
                got = K.oblique_cols(Y, u, mode, mask=m, **kw)
                ref = K.oblique_cols_plain(Y, u, mode, mask=m, **kw)
                assert _rel(got, ref) <= tol
                assert torch.equal(got, K.oblique_cols(Y, u, mode, mask=m,
                                                       **kw))
                calls += 2
    torch.cuda.synchronize()
    assert K.LAUNCHES["oblique_cols"] - before == calls


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
    v = Y[None]
    sc = torch.zeros((1, 8), dtype=torch.float64, device=cuda_device)
    st = torch.zeros((1, 2), dtype=torch.int32, device=cuda_device)
    vecs = [v.clone() for _ in range(5)]
    with pytest.raises(ValueError, match="vectors of shape"):
        K.tcg_step(v.transpose(1, 2), *vecs[1:], sc, st, 1)
    with pytest.raises(ValueError, match="mask goes with Y"):
        K.tcg_step(*vecs, sc, st, 1, None, Y[0])
    with pytest.raises(ValueError, match="Y must be"):
        K.tcg_step(*vecs, sc, st, 1, Y)                   # not (B, p, n)


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
@pytest.mark.parametrize("p_pad", [8, 16, 24, 40, 48, 136])
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
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("p", [8, 16, 24])
@pytest.mark.parametrize("samples,deep", [(900, True), (60, False)])
def test_k1_k3_on_a_shards_columns_on_card(cuda_device, dtype, p, samples,
                                           deep):
    """K1 (``plain``, ``cost``, ``al_hess``) and K3 on each world-2 and
    world-4 shard of a matrix-completion operator whose columns take K1's
    deep walk (900 samples) or its shallow one (60): over the shard's
    columns they are bit-equal to the same kernels run over all n columns
    of the shard's pattern, and within 1e-12 (f64) / 1e-5 (f32) of the
    twins."""
    import dataclasses
    from manisdp_tpu_torch.frontends.workloads import matrix_completion
    from manisdp_tpu_torch.parallel.sharded_ops import ShardedConstraintOp
    tol = {torch.float64: 1e-12, torch.float32: 1e-5}[dtype]
    data, _ = matrix_completion(30, 40, rank=2, m_samples=samples, seed=2)
    n = int(data.K.s)
    arrays = ConstraintOp.build(data.At, data.b, data.c, n,
                                "cpu").host_arrays(full=True)
    assert (arrays["pat_i"].size > K.SPMM_DEEP_MEAN * n) == deep
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(4)
    rnd = lambda *s: torch.randn(s, generator=gen, dtype=dtype,  # noqa: E731
                                 device=cuda_device)
    Y, U = rnd(p, n), rnd(p, n)
    spans = K.SPAN_LAUNCHES["symcoo_spmm"], K.SPAN_LAUNCHES["pattern_dots"]
    for world in (2, 4):
        for r in range(world):
            loc = ShardedConstraintOp.build(arrays, r, world,
                                            cuda_device).local.astype(dtype)
            pat = loc.pat
            c0, c1 = pat.span[:2]
            whole = dataclasses.replace(pat, span=None)
            es, ayu = rnd(pat.nnz), rnd(pat.nnz)
            for mode, A, kw in (
                    ("plain", Y, dict(vals=es)),
                    ("cost", Y, dict(vals=es)),
                    ("al_hess", U, dict(vals=es, B=Y, vals2=ayu,
                                        coefs=(2.0, 1.48)))):
                got = K.symcoo_spmm(A, pat, mode, **kw)
                full = K.symcoo_spmm(A, whole, mode, **kw)
                twin = K.symcoo_spmm_plain(A, pat, mode, **kw)
                if mode == "cost":
                    assert torch.equal(got[1], full[1][c0:c1])
                    got, full, twin = got[0], full[0], twin[0]
                assert got.shape == (p, c1 - c0)
                assert torch.equal(got, full[:, c0:c1]), (world, r, mode)
                assert _rel(got, twin) <= tol
            got = K.pattern_dots(Y, U, pat)
            assert torch.equal(got, K.pattern_dots(Y, U, whole))
            assert _rel(got, K.pattern_dots_plain(Y, U, pat)) <= tol
    torch.cuda.synchronize()
    assert K.SPAN_LAUNCHES["symcoo_spmm"] - spans[0] == 3 * 6
    assert K.SPAN_LAUNCHES["pattern_dots"] - spans[1] == 6


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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("shape", [(1, 48, 3000), (4, 8, N), (3, 192, 77)])
@pytest.mark.parametrize("tangent", [None, "oblique", "masked"])
def test_tcg_split_is_bit_equal_at_world_one_on_card(cuda_device, dtype,
                                                     shape, tangent):
    """K11's split mode with the sum over one rank (the identity) gives the
    one launch's bits on every output (the stopped instance's state left as
    it is by both), and agrees with its twin (the three phases' twins with
    the reduction between them)."""
    tol = {torch.float64: 1e-12, torch.float32: 1e-5}[dtype]
    B = shape[0]
    (d, Hd, eta, Heta, r), sc, st, Y, mask = _tcg_state(
        cuda_device, dtype, shape, tangent, 3)
    calls = []

    def one_rank(t):
        calls.append(tuple(t.shape))
        return t

    def run(step, **kw):
        vecs = [t.clone() for t in (d, Hd, eta, Heta, r)]
        return step(*vecs, sc, st, 1, Y, mask, **kw)

    before = (K.LAUNCHES["tcg_step"], K.TCG_LAUNCHES["split"])
    split = run(K.tcg_step, reduce=one_rank)
    torch.cuda.synchronize()
    nblk = K.tcg_blocks(d.numel() // B)
    assert calls == [(B, nblk, 2), (B, nblk)]
    one = run(K.tcg_step)
    act = slice(0, B - 1) if B > 1 else slice(0, 1)
    for g, o in zip(split[:3] + split[4:], one[:3] + one[4:]):
        assert torch.equal(g, o)
    assert torch.equal(split[3][act], one[3][act])
    ref = run(K.tcg_step_plain, reduce=lambda t: t)
    for g, f in zip(split[:4], ref[:4]):
        assert _rel(g[act], f[act]) <= tol
    assert _rel(split[4], ref[4]) <= tol and torch.equal(split[5], ref[5])
    assert K.LAUNCHES["tcg_step"] - before[0] == 2
    assert K.TCG_LAUNCHES["split"] - before[1] == 1


@pytest.mark.parametrize("tangent", [None, "oblique"])
def test_tcg_peer_twin_sums_through_the_peers_plain(tangent):
    """On CPU tensors K11's peer mode is its twin with the sum over the
    ranks taken by ``peer.plain`` (distributed.ordered_sum on a group):
    called on the partials (B, 1, 2) and (B, 1), and at one rank equal to
    the split twin's; reduce and peer together raise."""
    (d, Hd, eta, Heta, r), sc, st, Y, mask = _tcg_state(
        torch.device("cpu"), torch.float64, (3, 6, 20), tangent, 5)
    calls = []

    class Peer:
        @staticmethod
        def plain(t):
            calls.append(tuple(t.shape))
            return t

    def run(**kw):
        vecs = [t.clone() for t in (d, Hd, eta, Heta, r)]
        return K.tcg_step(*vecs, sc, st, 1, Y, mask, **kw)

    got = run(peer=Peer())
    assert calls == [(3, 1, 2), (3, 1)]
    for g, o in zip(got, run(reduce=lambda t: t)):
        assert torch.equal(g, o)
    with pytest.raises(ValueError, match="not both"):
        run(reduce=lambda t: t, peer=Peer())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("shape", [(1, 48, 3000), (4, 8, N), (3, 192, 77)])
@pytest.mark.parametrize("tangent", [None, "oblique", "masked"])
def test_tcg_peer_is_bit_equal_at_world_one_on_card(cuda_device, dtype,
                                                    shape, tangent):
    """K11's peer mode at one rank (PeerSums without a group: its own
    receive buffer, no peers, the barrier a grid.sync) gives the one
    launch's bits and the split mode's on every output, over consecutive
    steps that reuse the buffer (epochs 1, 3, 5); counted in
    TCG_LAUNCHES["peer"]."""
    from manisdp_tpu_torch.parallel.peer import PeerSums
    B = shape[0]
    (d, Hd, eta, Heta, r), sc, st, Y, mask = _tcg_state(
        cuda_device, dtype, shape, tangent, 3)
    peer = PeerSums()
    try:
        def run(**kw):
            vecs = [t.clone() for t in (d, Hd, eta, Heta, r)]
            return K.tcg_step(*vecs, sc, st, 1, Y, mask, **kw)

        before = (K.LAUNCHES["tcg_step"], K.TCG_LAUNCHES["peer"])
        one = run()
        split = run(reduce=lambda t: t)
        act = slice(0, B - 1) if B > 1 else slice(0, 1)
        for _ in range(3):
            got = run(peer=peer)
            torch.cuda.synchronize()
            for g, o, s in zip(got[:3] + got[4:], one[:3] + one[4:],
                               split[:3] + split[4:]):
                assert torch.equal(g, o) and torch.equal(g, s)
            assert torch.equal(got[3][act], one[3][act])
        assert K.TCG_LAUNCHES["peer"] - before[1] == 3
        assert K.LAUNCHES["tcg_step"] - before[0] == 5
        assert peer.buffers(B, K.tcg_blocks(d.numel() // B), dtype,
                            cuda_device).epoch == 7
    finally:
        peer.close()


def _one_rank_collectives():
    """The all-to-all and the all-reduce of a group of one rank."""
    return (lambda send, recv: recv.copy_(send)), (lambda t: t)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("q", [3, 7, 12, 20, 33, 60])
def test_symdual_row_modes_match_on_card(cuda_device, dtype, q):
    """K7's and K8's row-block modes at one rank against their twins (the
    torch ports of the JAX apply_sharded / adjoint_sharded) and against
    the full-mode kernels: y on every slot (0 at the repeated-index ones),
    the adjoint entirely; K8's row blocks of q / D rows at every offset
    (D = 3 / 4 where it divides q; no communication) assembled into the
    full adjoint."""
    tol = 1e-12 if dtype == torch.float64 else 1e-5
    n = 2 + q + q * q
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(q)
    rnd = lambda *s: torch.randn(s, generator=gen, dtype=torch.float64,  # noqa: E731
                                 device=cuda_device).to(dtype)
    M = rnd(n, n)
    M = M + M.T
    top, rows = M[:2 + q].contiguous(), M[2 + q:].reshape(q, q, n)
    a2a, reduce = _one_rank_collectives()
    before = (K.LAUNCHES["symdual_apply"], K.SYMDUAL_APPLY_LAUNCHES["rows"])
    got = K.symdual_apply_rows(top, rows, q, 0, a2a, reduce)
    twin = K.symdual_apply_rows_plain(top.cpu(), rows.cpu(), q, 0, a2a,
                                      reduce)
    full = K.symdual_apply(M, q)
    for g, t, f in zip(got, twin, full):
        assert g.device.type == "cuda" and g.dtype == dtype
        assert _rel(g, t) <= tol and _rel(g, f) <= tol
    torch.cuda.synchronize()
    assert K.LAUNCHES["symdual_apply"] - before[0] == 2
    assert K.SYMDUAL_APPLY_LAUNCHES["rows"] - before[1] == 1
    y = tuple(got)
    W = K.symdual_adjoint(y, q)
    for D in [1] + [D for D in (3, 4) if q % D == 0]:
        ql = q // D
        parts = []
        for off in range(0, q, ql):
            yl = y[:4] + (y[4][off:off + ql],)
            t, r = K.symdual_adjoint_rows(yl, q, off)
            tt, rt = K.symdual_adjoint_rows_plain(
                tuple(v.cpu() for v in yl), q, off)
            assert _rel(t, tt) <= tol and _rel(r, rt) <= tol
            assert torch.equal(t, W[:2 + q])
            parts.append(r)
        assert torch.equal(torch.cat(parts), W[2 + q:])


def _no_exchange(send, recv):
    raise AssertionError("an all-to-all at one rank")


def _grid(q, dtype, device, seed):
    """A seeded (n~, n~) M on the card, its top rows and its Q grid."""
    n = 2 + q + q * q
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    M = torch.randn((n, n), generator=gen, dtype=torch.float64,
                    device=device).to(dtype)
    return M, M[:2 + q].contiguous(), M[2 + q:].reshape(q, q, n)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("D", [1, 4])
@pytest.mark.parametrize("q", [12, 60])
def test_symdual_apply_rows_ranks_on_card(cuda_device, dtype, D, q):
    """K7's row-block mode over D ranks in one process (a thread per rank,
    the all-to-all by slicing the ranks' send buffers:
    chip_smoke.rows_in_one_process) against its twin with the same
    collectives, run in f64 on the same inputs: 1e-14 (f64) / 1e-6 (f32)
    relative; a second call gives the same bits."""
    tol = 1e-14 if dtype == torch.float64 else 1e-6
    _, top, rows = _grid(q, dtype, cuda_device, 100 + q)
    run = chip_smoke.rows_in_one_process
    got = run(K.symdual_apply_rows, top, rows, q, D)
    again = run(K.symdual_apply_rows, top, rows, q, D)
    twin = run(K.symdual_apply_rows_plain, top.double(), rows.double(), q,
               D)
    for g, a, t in zip(got, again, twin):
        assert g.dtype == dtype and g.shape == t.shape
        assert _rel(g, t) <= tol
        assert torch.equal(g, a)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_symdual_apply_rows_one_rank_on_card(cuda_device, dtype):
    """At one rank K7's row-block mode never calls the all-to-all, equals
    the full-mode kernel's Y4 bit for bit (and y0 .. Y3 to 1e-12 / 1e-5
    relative, as test_symdual_row_modes_match_on_card), and allocates no
    more than its outputs and its q^3 + q + q^4 workspace."""
    q = 33
    M, top, rows = _grid(q, dtype, cuda_device, 7)
    full = K.symdual_apply(M, q)
    torch.cuda.synchronize()
    gc.collect()
    torch.cuda.empty_cache()
    # bytes requested (the allocator may hand out larger cached blocks)
    stat = "requested_bytes.all.{}"
    torch.cuda.reset_peak_memory_stats(cuda_device)
    base = torch.cuda.memory_stats(cuda_device)[stat.format("current")]
    got = K.symdual_apply_rows(top, rows, q, 0, _no_exchange, lambda t: t)
    torch.cuda.synchronize()
    peak = torch.cuda.memory_stats(cuda_device)[stat.format("peak")] - base
    entries = (1 + q + q * q + q ** 3 + q ** 4) + (q ** 3 + q + q ** 4)
    assert peak <= entries * M.element_size()
    assert torch.equal(got[4], full[4])
    # y0 .. Y3 sum their terms in another order than the full mode
    for g, f in zip(got, full):
        assert _rel(g, f) <= (1e-12 if dtype == torch.float64 else 1e-5)


@pytest.mark.cuda
def test_symdual_apply_rows_past_the_slab_on_card(cuda_device):
    """K7's row-block mode at q = 170 in f64, whose q x (q + 1) slab
    (232,560 bytes) would exceed a block's 232,448 bytes of shared memory:
    it runs, and every degree is within 1e-13 (of the largest sum) of the
    class sums by index_add_ (chip_smoke.class_sums; the twin's q^4
    temporaries would not fit the card)."""
    q = 170
    assert q * (q + 1) * 8 > 232_448
    M, top, rows = _grid(q, torch.float64, cuda_device, 170)
    got = K.symdual_apply_rows(top, rows, q, 0, _no_exchange, lambda t: t)
    canon = chip_smoke.symdual_canonical_slots(q, cuda_device)
    cls = chip_smoke.symdual_class_map(q, cuda_device, kernel=True,
                                       canonical=canon).view(-1)
    canon = canon.long()
    sums = chip_smoke.class_sums(torch.empty_like(canon, dtype=M.dtype), cls,
                                 M)
    del cls, M, top, rows
    errs, big = chip_smoke.class_sums_errors(got, sums, canon, q)
    assert max(errs) / big <= 1e-13
    del got, sums, canon
    gc.collect()
    torch.cuda.empty_cache()


def _dontcare(q):
    from manisdp_tpu_torch.ops.symdual import _dontcare_mask
    return torch.as_tensor(_dontcare_mask(q))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("q", [3, 7, 18, 20, 33, 60, 61])
def test_symdual_kernels_match_twins_on_card(cuda_device, dtype, q):
    """K7 (with and without the y-step epilogue) and K8's three modes
    against their twins; K7's repeated-index slots are 0 in both.  q takes
    every residue mod 4 (so every 16-byte phase of Y4's rows, the output
    rows and B1 / B2's), and 60, the solves' own; y carries NaN in every
    don't-care slot, both as views of one flat buffer (K7's output, Y4 at
    an odd offset) and as separate tensors.  Every K8 call is one launch
    and repeats bit for bit."""
    from manisdp_tpu_torch.ops.symdual import _flatten
    tol = 1e-12 if dtype == torch.float64 else 1e-5
    n = 2 + q + q * q
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(q)
    rnd = lambda *s: torch.randn(s, generator=gen, dtype=torch.float64,  # noqa: E731
                                 device=cuda_device).to(dtype)
    M, B1, B2 = rnd(n, n), rnd(n, n), rnd(n, n)
    scale, shift = rnd(5), rnd(1)[0]
    before = dict(K.LAUNCHES)
    for kw in ({}, dict(scale=scale, shift=shift)):
        got = _flatten(*K.symdual_apply(M, q, **kw))
        ref = _flatten(*K.symdual_apply_plain(M, q, **kw))
        assert got.device.type == "cuda" and got.dtype == dtype
        assert _rel(got, ref) <= tol
        assert not torch.any(got.cpu()[_dontcare(q)] != 0)
    assert K.LAUNCHES["symdual_apply"] - before["symdual_apply"] == 2
    flat = rnd(1 + q + q * q + q ** 3 + q ** 4)
    flat[_dontcare(q).to(cuda_device)] = float("nan")
    sizes = [1, q, q * q, q ** 3, q ** 4]
    parts = torch.split(flat, sizes)
    views = (parts[0].reshape(()), parts[1], parts[2].view(q, q),
             parts[3].view(q, q, q), parts[4].view(q, q, q, q))
    separate = tuple(t.clone() for t in views)

    def once(fn, *args, **kw):
        start = K.LAUNCHES["symdual_adjoint"]
        got, again = fn(*args, **kw), fn(*args, **kw)
        torch.cuda.synchronize()
        assert K.LAUNCHES["symdual_adjoint"] - start == 2
        assert torch.equal(got, again) and not torch.any(torch.isnan(got))
        return got

    for y in (views, separate):
        for kw in ({}, dict(scale=scale), dict(B1=B1, c1=-1.0),
                   dict(B1=B1, c1=-1.0, B2=B2, c2=-1.0 / 0.37),
                   dict(scale=scale, B1=B1, c1=-1.0, B2=B2, c2=-0.3)):
            assert _rel(once(K.symdual_adjoint, y, q, **kw),
                        K.symdual_adjoint_plain(y, q, **kw)) <= tol
    for p in (1, 8, 13, 192):
        Y = rnd(p, n)
        for renorm in (True, False):
            assert _rel(once(K.symdual_sym_factor, Y, q, renorm),
                        K.symdual_sym_factor_plain(Y, q, renorm)) <= tol
    assert _rel(once(K.symdual_sym_mat, M, q),
                K.symdual_sym_mat_plain(M, q)) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_oblique_proj_eg_matches_twin_on_card(cuda_device, dtype):
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(3)
    rnd = lambda *s: torch.randn(s, generator=gen, dtype=dtype,  # noqa: E731
                                 device=cuda_device)
    Y, H, U, g = rnd(24, 500), rnd(24, 500), rnd(24, 500), rnd(500)
    before = K.OBLIQUE_LAUNCHES["proj_eG"]
    got = K.oblique_cols(Y, H, "proj", v=U, g=g)
    assert _rel(got, K.oblique_cols_plain(Y, H, "proj", v=U, g=g)) <= \
        (1e-12 if dtype == torch.float64 else 1e-5)
    torch.cuda.synchronize()
    assert K.OBLIQUE_LAUNCHES["proj_eG"] - before == 1


@pytest.mark.cuda
def test_symdual_wrappers_reject_what_the_kernels_do_not_take(cuda_device):
    q, n = 3, 14
    M = torch.ones((n, n), dtype=torch.float64, device=cuda_device)
    with pytest.raises(ValueError):
        K.symdual_apply(M[:, :7], q)                       # wrong shape
    with pytest.raises(ValueError):
        K.symdual_apply(M.T, q)                            # not contiguous
    with pytest.raises(TypeError):
        K.symdual_apply(M, q, scale=torch.ones(5, device=cuda_device))
    y = (M[0, 0], M[0, :q], M[:q, :q], torch.ones((q,) * 3, dtype=M.dtype,
                                                  device=cuda_device),
         torch.ones((q,) * 4, dtype=M.dtype, device=cuda_device))
    with pytest.raises(ValueError):
        K.symdual_adjoint(y[:4], q)                        # 4-tuple
    with pytest.raises(ValueError):
        K.symdual_adjoint(y, 4)                            # wrong q
    with pytest.raises(ValueError):
        K.symdual_sym_factor(M, 4)                         # wrong width
    with pytest.raises(ValueError, match="devices"):
        K.oblique_cols(M, M.cpu(), "proj")                 # CPU / CUDA mix
    with pytest.raises(ValueError):
        K.oblique_cols(M, M, "retr", v=M, g=M[0])          # eG in proj only


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("q", [3, 7, 20, 33, 61])
def test_symmom_kernels_match_twins_on_card(cuda_device, dtype, q):
    """K9 on every slot (don't-care slots 0 in both) and K10 with and
    without its fused base, with NaN in y's don't-care slots (never
    read)."""
    from manisdp_tpu_torch.ops.symmom import dontcare_mask
    tol = 1e-12 if dtype == torch.float64 else 1e-5
    n = 2 + q + q * q
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(q)
    rnd = lambda *s: torch.randn(s, generator=gen, dtype=torch.float64,  # noqa: E731
                                 device=cuda_device).to(dtype)
    M, C = rnd(n, n), rnd(n, n)
    before = dict(K.LAUNCHES)
    got, ref = K.symmom_apply(M, q), K.symmom_apply_plain(M, q)
    assert got.device.type == "cuda" and got.dtype == dtype
    assert _rel(got, ref) <= tol
    assert torch.equal(K.symmom_apply(M, q), got)        # repeats bit for bit
    dc = torch.as_tensor(dontcare_mask(q), device=cuda_device)
    assert not torch.any(got[dc] != 0)
    y = rnd(got.shape[0])
    clean = torch.where(dc, torch.zeros_like(y), y)
    dirty = torch.where(dc, torch.full_like(y, float("nan")), y)
    for kw in ({}, dict(base=C, alpha=-0.37)):
        got = K.symmom_adjoint(dirty, q, **kw)
        assert not torch.any(torch.isnan(got))
        assert _rel(got, K.symmom_adjoint_plain(clean, q, **kw)) <= tol
    torch.cuda.synchronize()
    assert K.LAUNCHES["symmom_apply"] - before["symmom_apply"] == 2
    assert K.LAUNCHES["symmom_adjoint"] - before["symmom_adjoint"] == 2


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_oblique_masked_matches_twin_on_card(cuda_device, dtype):
    """K2's masked mode in every mode; without a mask the kernel gives
    bit for bit what it gave before (mask all ones = no mask)."""
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(5)
    rnd = lambda *s: torch.randn(s, generator=gen, dtype=dtype,  # noqa: E731
                                 device=cuda_device)
    Y, H, U, g = rnd(24, 500), rnd(24, 500), rnd(24, 500), rnd(500)
    mask = (torch.rand(500, generator=gen, device=cuda_device) < 0.5) \
        .to(dtype)
    tol = 1e-12 if dtype == torch.float64 else 1e-5
    before = K.OBLIQUE_LAUNCHES["masked"]
    for mode, u, kw in (("proj", H, {}), ("proj", H, dict(v=U, g=g)),
                        ("retr", H, {}), ("renormalize", None, {})):
        got = K.oblique_cols(Y, u, mode, mask=mask, **kw)
        ref = K.oblique_cols_plain(Y, u, mode, mask=mask, **kw)
        assert _rel(got, ref) <= tol
        off = mask == 0
        if mode == "proj" and not kw:
            assert torch.equal(got[:, off], H[:, off])
        if mode == "renormalize":
            assert torch.equal(got[:, off], Y[:, off])
        ones = K.oblique_cols(Y, u, mode, mask=torch.ones_like(mask), **kw)
        assert torch.equal(ones, K.oblique_cols(Y, u, mode, **kw))
    torch.cuda.synchronize()
    assert K.OBLIQUE_LAUNCHES["masked"] - before == 8


@pytest.mark.cuda
def test_symmom_wrappers_reject_what_the_kernels_do_not_take(cuda_device):
    q, n = 3, 14
    M = torch.ones((n, n), dtype=torch.float64, device=cuda_device)
    with pytest.raises(ValueError):
        K.symmom_apply(M[:, :7], q)                        # wrong shape
    with pytest.raises(ValueError):
        K.symmom_apply(M.T, q)                             # not contiguous
    y = torch.ones(K.symmom_apply(M, q).shape[0] + 1, dtype=M.dtype,
                   device=cuda_device)
    with pytest.raises(ValueError):
        K.symmom_adjoint(y, q)                             # wrong length
    with pytest.raises(TypeError):
        K.symmom_adjoint(y[:-1], q, base=M.float())        # dtype mix
    with pytest.raises(ValueError):
        K.oblique_cols(M, M, "proj", mask=M[0, :5])        # mask length


# -- K3 / K4 redesigns: host-side choices (CPU) and the card -------------

@pytest.mark.parametrize("nnz,nrows,plan", [
    (8_988_440, 4_494_220, 0),      # mc-12000 A, k order (2 per row)
    (8_988_440, 9_000_440, 0),      # mc-12000 Aᵀ on the pattern (0-2)
    (9_000_440, 12_000, 2),         # colsum_pattern (~750 per row)
    (3_355_141, 523_686, 1),        # BQP q = 60 DualOp (6, long rows)
    (57_660, 497, 2),               # iAB columns at d = 30 (~116)
    (0, 0, 0), (0, 10, 0), (2, 1, 0), (3, 1, 1), (16, 1, 1), (17, 1, 2)])
def test_csr_gather_plan(nnz, nrows, plan):
    """K4's mapping from the mean row length (a thread per row with two
    rows or one, or a warp per row), from the two tensor shapes alone."""
    assert K.csr_gather_plan(nnz, nrows) == plan


def test_csr_long_rows_metadata():
    """K4's host metadata: the rows longer than CSR_LONG_ROW, read back
    once per pointer tensor (cached_long_rows), built anew after an
    in-place write, dropped with the tensor, and shared by an operator's
    astype copies, which keep its pointers."""
    lens = np.array([0, 33, 32, 1, 500, 0, 40])
    ptr = torch.as_tensor(np.concatenate([[0], np.cumsum(lens)]),
                          dtype=torch.int32)
    rows = K.csr_long_rows(ptr)
    assert rows.dtype == torch.int32 and rows.tolist() == [1, 4, 6]
    assert K.csr_long_rows(ptr[:3]).tolist() == [1]
    assert K.csr_long_rows(ptr[:1]).numel() == 0
    first = K.cached_long_rows(ptr)
    assert torch.equal(first, rows) and K.cached_long_rows(ptr) is first
    ptr[2:] += 10                        # row 1 now 43 long, row 2 32
    assert K.cached_long_rows(ptr) is not first
    assert K.cached_long_rows(ptr).tolist() == [1, 4, 6]
    ptr[1] = 43                          # row 0 43 long, row 1 empty
    assert K.cached_long_rows(ptr).tolist() == [0, 4, 6]
    key = id(ptr)
    assert key in K._LONG_ROWS
    del ptr
    gc.collect()
    assert key not in K._LONG_ROWS
    with torch.inference_mode():         # no version counter to read
        ptr = torch.tensor([0, 40, 41], dtype=torch.int32)
    first = K.cached_long_rows(ptr)
    assert first.tolist() == [0] and K.cached_long_rows(ptr) is first
    dop = _bqp_dualop(12, "cpu")
    d32 = dop.astype(torch.float32)
    assert d32.krow_ptr is dop.krow_ptr and d32.pos_ptr is dop.pos_ptr
    lens = np.diff(dop.krow_ptr.numpy())
    np.testing.assert_array_equal(K.cached_long_rows(d32.krow_ptr).numpy(),
                                  np.flatnonzero(lens > K.CSR_LONG_ROW))
    assert K.cached_long_rows(dop.krow_ptr) is \
        K.cached_long_rows(d32.krow_ptr)
    assert K.csr_long_rows(dop.pos_ptr).numel() == 0
    op = _constraint_op("cpu")
    o32 = op.astype(torch.float32)
    for name in ("krow_ptr", "pat_ptr"):
        assert getattr(o32, name) is getattr(op, name)
    assert o32.pat.colptr is op.pat.colptr


@pytest.mark.parametrize("p,dtype,pp,group", [
    (16, torch.float64, 16, 4), (16, torch.float32, 16, 2),
    (8, torch.float64, 8, 2), (8, torch.float32, 8, 1),
    (24, torch.float64, 24, 4), (24, torch.float32, 24, 2),
    (1, torch.float64, 2, 1), (1, torch.float32, 4, 1),
    (33, torch.float64, 34, 8), (33, torch.float32, 36, 4),
    (130, torch.float64, 130, 32), (130, torch.float32, 132, 16)])
def test_pattern_dots_layout(p, dtype, pp, group):
    """K3's N-major scratch row (p rounded up to a 16-B vector) and its
    lanes per entry (at least two vectors each where the row has them, at
    most 32 lanes)."""
    assert K.pattern_dots_layout(p, dtype) == (pp, group)
    vec = 16 // torch.empty((), dtype=dtype).element_size()
    nvec = pp // vec
    assert pp % vec == 0 and pp - p < vec
    assert group == 32 or 2 * group <= nvec < 4 * group or group == 1


def _bqp_dualop(q, device):
    from manisdp_tpu_torch.frontends.sos import assemble_bqpsos
    from manisdp_tpu_torch.ops.dualops import DualOp
    Q, e, _ = chip_smoke.bqp_instance(q, None)
    A, b, c, mb, f, dAAt = assemble_bqpsos(Q, e, q)
    return DualOp.build(A, b / np.max(np.abs(b)), c, mb, f, dAAt,
                        device=device)


def test_dualop_row_profile():
    """The q-variable BQP DualOp's rows: one of n = 1 + q + q(q-1)/2
    entries, n - 1 of 2q, the rest of 6, all the long ones first; its mean
    (~7) puts it on K4's thread-per-row mapping, and its metadata lists
    the n rows above 32 entries for a warp each."""
    dop = _bqp_dualop(20, "cpu")
    prof = chip_smoke.row_profile(dop.krow_ptr)
    assert prof["most_common"] == {6: 5985, 40: 210, 211: 1}
    assert prof["max"] == 211 and prof["plan"] == 1
    assert prof["long_rows"] == 211
    assert K.csr_long_rows(dop.krow_ptr).tolist() == list(range(211))
    lens = np.diff(dop.krow_ptr.numpy())
    assert np.all(lens[:211] > K.CSR_LONG_ROW)


def _held_twice(fn, twin, args, kw, tol, scale=None):
    """One kernel call against its twin (relative to the largest output,
    or to ``scale`` per output), and a second call bit-equal to the
    first."""
    got, ref = fn(*args, **kw), twin(*args, **kw)
    again = fn(*args, **kw)
    torch.cuda.synchronize()
    assert got.device.type == "cuda"
    if scale is None:
        assert _rel(got, ref) <= tol
    else:
        assert float(torch.max(torch.abs(got - ref).double() / scale)) <= tol
    assert torch.equal(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_csr_gather_dual_operators_on_card(cuda_device, dtype):
    """K4 on the q = 20 BQP DualOp (rows of 211, 40 and 6: threads and the
    blocks' warps) and the d = 12 iAB pair."""
    from manisdp_tpu_torch.solvers.dual_general import build_iab
    tol = {torch.float64: 1e-12, torch.float32: 1e-5}[dtype]
    dop = _bqp_dualop(20, cuda_device).astype(dtype)
    Aq, _, _, mbq, fq, dAAtq = chip_smoke.qs_instance(12)
    iab = build_iab(Aq, mbq, fq, dAAtq, cuda_device).astype(dtype)
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(5)
    rnd = lambda *s: torch.randn(s, generator=gen, dtype=dtype,  # noqa: E731
                                 device=cuda_device)
    n = dop.n
    M, w = rnd(n * n), rnd(dop.m)
    cases = [((M, dop.krow_ptr, dop.lin_r, dop.v_r), {}),
             ((M, dop.krow_ptr, dop.lin_r, dop.v_r), dict(base=-dop.Ac)),
             ((w, dop.pos_ptr, dop.k_c, dop.v_c),
              dict(pos=dop.pos, size=n * n)),
             ((rnd(iab.ncols), iab.row_ptr, iab.col_r, iab.val_r), {}),
             ((rnd(iab.nrows), iab.col_ptr, iab.row_c, iab.val_c), {})]
    for args, kw in cases:
        _held_twice(K.csr_gather, K.csr_gather_plain, args, kw, tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_csr_gather_skewed_rows_on_card(cuda_device, dtype):
    """K4 on skewed rows: one row of 10^5 entries among 10^6 rows of one
    (a warp's walk), half the rows empty, and scatter_pos with a
    10^5-entry row; held relative to each row's sum of absolute terms (a
    10^5-term f32 sum is off by ~1e-3 of its largest output in any
    order)."""
    tol = {torch.float64: 1e-12, torch.float32: 1e-5}[dtype]
    for c in chip_smoke.skew_inputs(cuda_device, 7).values():
        kw = {}
        if "pos" in c:
            kw.update(pos=c["pos"], size=c["size"], base=c["base"].to(dtype),
                      alpha=0.5)
        args = (c["x"].to(dtype), c["ptr"], c["col"], c["val"].to(dtype))
        _held_twice(K.csr_gather, K.csr_gather_plain, args, kw, tol,
                    scale=chip_smoke.sum_scale(*args, **kw))


def _dense_pattern(n, density, device, seed=6):
    """A random symmetric pattern of ~density * n entries per column (K3's
    warp walks many entries per column)."""
    from manisdp_tpu_torch.convert import symcoo_from_arrays
    rs = np.random.RandomState(seed)
    M = sp.random(n, n, density=density, random_state=rs, format="coo")
    M = (M + M.T + sp.eye(n)).tocsc()
    M.sort_indices()
    coo = M.tocoo()
    return symcoo_from_arrays(coo.row.astype(np.int32),
                              coo.col.astype(np.int32), coo.data, n, device)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("p", [1, 3, 8, 16, 24, 31, 33, 64, 130])
def test_pattern_dots_widths_on_card(cuda_device, dtype, p):
    """K3 at every lane grouping and chunk count: contiguous factors, a
    transposed Y, a column-strided U, and U = Y; held to the twin and
    repeated bit for bit."""
    tol = {torch.float64: 1e-12, torch.float32: 1e-5}[dtype]
    n = 300
    P = _dense_pattern(n, 0.3, cuda_device)
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(p)
    rnd = lambda *s: torch.randn(s, generator=gen, dtype=dtype,  # noqa: E731
                                 device=cuda_device)
    Y, U = rnd(p, n), rnd(p, n)
    Ys = rnd(n, p).T                               # strides (1, p)
    Us = rnd(p, 2 * n)[:, ::2]                     # strides (2n, 2)
    for args in ((Y, U, P), (Ys, Us, P), (Y, Y, P), (Ys, Ys, P)):
        _held_twice(K.pattern_dots, K.pattern_dots_plain, args, {}, tol)
