#!/usr/bin/env python3
"""End-to-end smoke of the PyTorch port (``manisdp_tpu_torch``) on one
CUDA GPU.

    python3 chip_smoke.py [--gset DIR] [--seed 0] [--out DIR]

Phases (each prints one line; a failed check raises and the exit code is
not 0):
  1. environment: torch / CUDA versions, the card's name and power limit;
  2. build kernels K1-K4 from ``manisdp_tpu_torch/csrc``;
  3. every K1 / K2 mode against its plain PyTorch twin on the card at the
     G67 shapes (n = 10^4, p_pad in {8, 24, 40, 48}, f64 and f32),
     with times;
  4. a G1-size solve (n = 800: dense cost, eigh certificate);
  5. the G67-size solve (n = 10^4: sparse cost through K1, f32 tCG,
     device LOBPCG certificate), with the kernels' launch counters and an
     independent KKT oracle (dense f64 eigvalsh of S on the card);
  6. K3, K4 (both orderings, with and without base / alpha) and K1's
     ``al_hess`` mode against their twins at the shapes of trace-min
     matrix completion at n = 12,000 (nnzP = 9.0 M, m = 4.49 M, p_pad in
     {8, 16, 24}, f64 and f32), with times;
  7. that matrix completion solved through ``solve_sdp`` (the primal AL
     on the factored constraint operator, f32 tCG, device LOBPCG
     certificate), with the launch counters and an independent KKT oracle
     on the card (A(YᵀY) from the raw SeDuMi triplets, f64 eigvalsh of the
     dense S = mat(c - Aᵀy), the duality gap).
Then one ``{"kernels": [...]}`` line and, last, the result line
``{"ok": true, "device": {...}}``.

``--gset DIR`` reads G1.txt / G67.txt from a Gset directory; without it
(or when a file is missing) seeded stand-ins of the same shape are used
and labelled so.  The full record (every timing, both solves) goes to
``chip_smoke.json`` in ``--out`` (default ``build/chip_smoke``).
It needs one CUDA device and exits with an error without one.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

# factor widths of phase 3: the G67 solve runs its tCG at p_pad = 40
# (p0 = 40) and its certificate on blocks of 24 rows; 8 and 48 bracket
# the rank buckets
P_PADS = (8, 24, 40, 48)
HOT_P_PAD = 40
# trace-min matrix completion at n = 12,000, the reference construction
# (example_matrixcompletion.m; bench.py bench_mc at p = 6000); the AL's
# rank ramp keeps p_pad in {8, 16, 24}
MC = dict(p=6000, q=6000, rank=10, m_samples=4_800_000, seed=3)
AL_P_PADS = (8, 16, 24)
AL_HOT_P_PAD = 16


def emit(obj):
    print(json.dumps(obj), flush=True)


def laplacian_cost(n, i, j, w):
    """C = -L/4 of the graph with edges (i, j, w): the MaxCut SDP cost."""
    import scipy.sparse as sp
    W = sp.coo_matrix((np.r_[w, w], (np.r_[i, j], np.r_[j, i])),
                      shape=(n, n)).tocsr()
    deg = np.asarray(W.sum(axis=1)).ravel()
    return (-0.25) * (sp.diags(deg) - W).tocsr()


def g1_standin(seed):
    """Erdos-Renyi graph of G1's size: n = 800, 19,176 unit edges."""
    n, m = 800, 19176
    rng = np.random.default_rng(seed)
    iu, ju = np.triu_indices(n, 1)
    pick = rng.choice(iu.size, size=m, replace=False)
    return laplacian_cost(n, iu[pick], ju[pick], np.ones(m))


def g67_standin(seed):
    """100 x 100 toroidal grid with +-1 weights, G67's shape: n = 10^4,
    20,000 edges."""
    side = 100
    a, b = np.meshgrid(np.arange(side), np.arange(side), indexing="ij")
    v = (a * side + b).ravel()
    right = (a * side + (b + 1) % side).ravel()
    down = (((a + 1) % side) * side + b).ravel()
    i = np.r_[v, v]
    j = np.r_[right, down]
    w = np.random.default_rng(seed + 1).choice([-1.0, 1.0], size=i.size)
    return laplacian_cost(side * side, i, j, w)


def load_graph(name, gset_dir, seed):
    from manisdp_tpu_torch.frontends.gset import load_gset_laplacian
    path = os.path.join(gset_dir, f"{name}.txt") if gset_dir else None
    if path and os.path.exists(path):
        return (-0.25) * load_gset_laplacian(path), f"Gset {name}"
    make = g1_standin if name == "G1" else g67_standin
    return make(seed), f"seeded stand-in for {name} (seed {seed})"


def time_ms(fn, reps=25):
    """Median device milliseconds of one call, from CUDA events around
    it.  A spin kernel holds the stream while the host enqueues the call,
    so its launches run back to back and the events time the device work
    rather than the host's launch overhead."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)        # ~1 ms at H100 clocks
        a.record()
        fn()
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b))
    return statistics.median(ts)


def max_err(got, ref):
    import torch
    if isinstance(ref, tuple):
        pairs = list(zip(got, ref))
    else:
        pairs = [(got, ref)]
    abs_err = max(float(torch.max(torch.abs(g - r))) for g, r in pairs)
    scale = max(float(torch.max(torch.abs(r))) for _, r in pairs)
    return abs_err, abs_err / max(scale, 1e-300)


def kkt_oracle_on_card(C_sp, res, device):
    """Independent KKT check on the card: diag(X) = 1, lambda_min of the
    dense S = C - diag(z) by f64 eigvalsh, and complementarity
    <C,X> = sum(z), computed from the returned factor alone."""
    import torch
    Y = torch.as_tensor(res.Y, dtype=torch.float64, device=device)
    C = torch.as_tensor(C_sp.toarray(), dtype=torch.float64, device=device)
    X = Y.T @ Y
    pinf = float(torch.max(torch.abs(torch.diagonal(X) - 1.0)))
    z = torch.sum(C * X, dim=0)
    S = C - torch.diag(z)
    del X
    w = torch.linalg.eigvalsh(S)
    dinf = max(0.0, -float(w[0])) / (1.0 + float(w[-1]))
    obj = float(torch.sum(z))
    comp = abs(res.obj - obj) / (1.0 + abs(obj))
    return dict(pinf=pinf, dinf=dinf, comp=comp,
                eta=max(pinf, dinf, comp), lam_min=float(w[0]))


def worst_errors(rows):
    """The largest absolute and relative error of each kernel's rows."""
    worst = {}
    for r in rows:
        w = worst.setdefault(r["kernel"], dict(max_abs_err=0.0, rel_err=0.0))
        w["max_abs_err"] = max(w["max_abs_err"], r["max_abs_err"])
        w["rel_err"] = max(w["rel_err"], r["rel_err"])
    return worst


def check_case(rows, name, mode, fn, twin, args, kw, tol, **info):
    """One kernel call against its twin on the same inputs, timed."""
    import torch
    got = fn(*args, **kw)
    ref = twin(*args, **kw)
    torch.cuda.synchronize()
    abs_err, rel_err = max_err(got, ref)
    row = dict(kernel=name, mode=mode, **info, max_abs_err=abs_err,
               rel_err=rel_err, tol=tol,
               ms=time_ms(lambda: fn(*args, **kw)),
               plain_ms=time_ms(lambda: twin(*args, **kw)))
    rows.append(row)
    if not rel_err <= tol:
        raise AssertionError(f"kernel disagrees with its twin: {row}")


def phase_kernels(C_sp, device, seed):
    """Every K1 / K2 mode against its twin at the G67 shapes."""
    import torch
    from manisdp_tpu_torch import kernels as K
    from manisdp_tpu_torch.ops.sparse import SymCOO

    C64 = SymCOO.from_scipy(C_sp, device)
    n = C64.n
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    rows = []
    tol = {torch.float64: 1e-12, torch.float32: 1e-5}
    for dt in (torch.float64, torch.float32):
        C = C64.astype(dt)
        for p in P_PADS:
            rnd = lambda *s: torch.randn(s, generator=gen,  # noqa: E731
                                         dtype=torch.float64,
                                         device=device).to(dt)
            Y = K.oblique_cols_plain(rnd(p, n), None, "renormalize")
            U = K.oblique_cols_plain(Y, rnd(p, n), "proj")
            z = rnd(n)
            eG = K.symcoo_spmm_plain(Y, C, "cost")[1]
            V = rnd(n, 9)       # matvec_block's (n, k) block, K1 on V.T
            cases = [
                ("symcoo_spmm", "plain", (Y, C, "plain"), {}),
                ("symcoo_spmm", "shift", (Y, C, "shift"), dict(z=z)),
                ("symcoo_spmm", "cost", (Y, C, "cost"), {}),
                ("symcoo_spmm", "hess", (U, C, "hess"), dict(B=Y, eG=eG)),
                ("symcoo_spmm", "plain_strided", (V.T, C, "plain"), {}),
                ("oblique_cols", "proj", (Y, U, "proj"), {}),
                ("oblique_cols", "retr", (Y, U, "retr"), {}),
                ("oblique_cols", "renormalize", (Y + U, None,
                                                 "renormalize"), {}),
            ]
            for name, mode, args, kw in cases:
                check_case(rows, name, mode, getattr(K, name),
                           getattr(K, f"{name}_plain"), args, kw, tol[dt],
                           dtype=str(dt)[6:], p_pad=p, n=n, nnz=C.nnz)
    return rows


def mc_instance():
    """The n = 12,000 matrix completion (SeDuMi data) and its build
    seconds."""
    from manisdp_tpu_torch.frontends.workloads import matrix_completion
    t0 = time.perf_counter()
    data, _ = matrix_completion(MC["p"], MC["q"], rank=MC["rank"],
                                m_samples=MC["m_samples"], seed=MC["seed"])
    return data, time.perf_counter() - t0


def phase_al_kernels(op64, device, seed):
    """K3, K4 and K1 al_hess against their twins at the matrix-completion
    shapes."""
    import torch
    from manisdp_tpu_torch import kernels as K

    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    n, m = op64.n, op64.m
    sigma = 0.37
    rows = []
    tol = {torch.float64: 1e-12, torch.float32: 1e-5}
    for dt in (torch.float64, torch.float32):
        op = op64.astype(dt)
        rnd = lambda *s: torch.randn(s, generator=gen,  # noqa: E731
                                     dtype=torch.float64,
                                     device=device).to(dt)
        info = dict(dtype=str(dt)[6:], n=n, m=m, nnzP=op.pat.nnz,
                    nnzA=op.nnz)
        e, w = rnd(op.pat.nnz), rnd(m)
        # K4 does not depend on p: once per dtype, both orderings
        k4 = [("apply_from_e", (e, op.krow_ptr, op.a2p, op.v), {}),
              ("adjoint_on_pattern", (w, op.pat_ptr, op.kp, op.vp), {}),
              ("es_vals", (w, op.pat_ptr, op.kp, op.vp),
               dict(base=op.pat.v, alpha=sigma)),
              ("s_vals", (w, op.pat_ptr, op.kp, op.vp),
               dict(base=op.pat.v, alpha=-1.0))]
        for mode, args, kw in k4:
            check_case(rows, "csr_gather", mode, K.csr_gather,
                       K.csr_gather_plain, args, kw, tol[dt], p_pad=None,
                       **info)
        es = K.csr_gather_plain(w, op.pat_ptr, op.kp, op.vp, base=op.pat.v,
                                alpha=sigma)
        ayu = K.csr_gather_plain(rnd(m), op.pat_ptr, op.kp, op.vp)
        for p in AL_P_PADS:
            Y = K.oblique_cols_plain(rnd(p, n), None, "renormalize")
            U = K.oblique_cols_plain(Y, rnd(p, n), "proj")
            YeG = rnd(n)
            hess = dict(vals=es, B=Y, vals2=ayu, coefs=(2.0, 4.0 * sigma))
            for name, mode, args, kw in (
                    ("pattern_dots", "pair_dots", (Y, U, op.pat), {}),
                    ("symcoo_spmm", "al_hess", (U, op.pat, "al_hess"),
                     hess),
                    ("symcoo_spmm", "al_hess_diag", (U, op.pat, "al_hess"),
                     dict(hess, eG=YeG))):
                check_case(rows, name, mode, getattr(K, name),
                           getattr(K, f"{name}_plain"), args, kw, tol[dt],
                           p_pad=p, **info)
    return rows


def al_kkt_oracle_on_card(data, res, device):
    """Independent KKT check of a general-variant solve on the card, from
    the raw SeDuMi triplets and the returned (Y, y) alone: pinf from
    A(YᵀY), dinf from f64 eigvalsh of the dense S = mat(c - Aᵀy), gap from
    <C, X> and bᵀy.  No ConstraintOp and no kernel is used."""
    import torch
    t0 = time.perf_counter()
    n = int(data.K.s)
    At = data.At.tocoo()
    f64 = dict(dtype=torch.float64, device=device)
    lin = torch.as_tensor(At.row.astype(np.int64), device=device)
    k = torch.as_tensor(At.col.astype(np.int64), device=device)
    v = torch.as_tensor(At.data, **f64)
    Y = torch.as_tensor(res.Y, **f64)
    y = torch.as_tensor(res.y, **f64)
    b = torch.as_tensor(data.b, **f64)
    m = b.shape[0]
    Ax = torch.zeros(m, **f64).index_add_(
        0, k, v * torch.sum(Y[:, lin % n] * Y[:, lin // n], dim=0))
    pinf = float(torch.linalg.norm(Ax - b) / (1.0 + torch.linalg.norm(b)))
    cnz = np.flatnonzero(data.c)
    cl = torch.as_tensor(cnz, device=device)
    cv = torch.as_tensor(data.c[cnz], **f64)
    obj = float(torch.sum(cv * torch.sum(Y[:, cl % n] * Y[:, cl // n],
                                         dim=0)))
    by = float(torch.dot(b, y))
    gap = abs(obj - by) / (1.0 + abs(obj) + abs(by))
    del Ax, Y
    S = torch.zeros(n * n, **f64)
    S[cl] = cv
    S.index_add_(0, lin, -v * y[k])
    S = S.reshape(n, n).T          # vec is column-major; S is symmetric
    wv = torch.linalg.eigvalsh(S)
    lam_min, lam_max = float(wv[0]), float(wv[-1])
    del S
    dinf = max(0.0, -lam_min) / (1.0 + lam_max)
    torch.cuda.synchronize()
    return dict(pinf=pinf, dinf=dinf, gap=gap, eta=max(pinf, dinf, gap),
                obj=obj, trace_X=float(np.sum(res.Y * res.Y)), by=by,
                lam_min=lam_min, lam_max=lam_max,
                seconds=time.perf_counter() - t0)


def al_solve_phase(data, op, build_s, assemble_s, device):
    """Matrix completion at n = 12,000 through solve_sdp (given its
    ConstraintOp, assembled in ``assemble_s``) with bench.py's mc
    settings."""
    import torch
    from manisdp_tpu_torch import kernels as K
    from manisdp_tpu_torch import recipes, solve_sdp

    n = int(data.K.s)
    _, kw = recipes.recipe("mc")
    kw = dict(kw, delta=10, tr_maxinner=6, tr_maxiter=8, theta=1e-2,
              inner_dtype="tcg32")
    K.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = solve_sdp(op, data.b, data.c, n, device=device, verbose=False,
                    **kw)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)
    spmm_modes = dict(K.SPMM_LAUNCHES)
    out = dict(phase="mc12000_solve", instance=MC, n=n, m=op.m,
               nnzA=op.nnz, nnzP=op.pat.nnz, options=kw,
               instance_build_s=build_s, assemble_s=assemble_s,
               seconds=seconds, solver_time_s=res.time, status=res.status,
               obj=res.obj, eta=res.eta, gap=res.gap, pinf=res.pinf,
               dinf=res.dinf, iterations=res.iterations,
               fac_size=res.fac_size, rtr_iters=res.rtr_iters,
               hess_calls=res.hess_calls,
               rtr_iters_per_s=res.rtr_iters / seconds, timers=res.timers,
               launches=launches, symcoo_spmm_modes=spmm_modes)
    out["oracle"] = al_kkt_oracle_on_card(data, res, device)
    emit(out)
    if res.status != 0 or not res.eta <= 1e-8:
        raise AssertionError(f"mc12000: status {res.status}, eta {res.eta}")
    if not out["oracle"]["eta"] <= 1e-8:
        raise AssertionError(f"mc12000: KKT oracle {out['oracle']}")
    for name in ("pattern_dots", "csr_gather"):
        if launches[name] <= 0:
            raise AssertionError(f"the mc12000 solve never launched {name}")
    if spmm_modes["al_hess"] <= 0:
        raise AssertionError("the mc12000 solve never launched K1 al_hess")
    return out


def solve_phase(label, C_sp, source, device, check_oracle):
    import torch
    from manisdp_tpu_torch import kernels as K
    from manisdp_tpu_torch import solve_maxcut_unitdiag

    K.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = solve_maxcut_unitdiag(C_sp, p0=40, device=device, verbose=False)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)
    out = dict(phase=label, source=source, n=C_sp.shape[0],
               nnz=int(C_sp.nnz), seconds=seconds, status=res.status,
               obj=res.obj, eta=res.eta, dinf=res.dinf,
               outer_iters=res.iterations, fac_size=res.fac_size,
               rtr_iters=res.rtr_iters, hess_calls=res.hess_calls,
               rtr_iters_per_s=res.rtr_iters / seconds, timers=res.timers,
               launches=launches)
    if check_oracle:
        out["oracle"] = kkt_oracle_on_card(C_sp, res, device)
    emit(out)
    if res.status != 0 or not res.eta <= 1e-8:
        raise AssertionError(f"{label}: status {res.status}, eta {res.eta}")
    if check_oracle and not out["oracle"]["eta"] <= 1e-8:
        raise AssertionError(f"{label}: KKT oracle {out['oracle']}")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--gset", default=None,
                    help="Gset directory holding G1.txt and G67.txt")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=os.path.join("build", "chip_smoke"),
                    help="directory of the full JSON record")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    import manisdp_tpu_torch  # noqa: F401  (fails outside the repository)
    from manisdp_tpu_torch import kernels as K
    from manisdp_tpu_torch.kernels.build import build_info

    t_start = time.perf_counter()
    device = torch.device("cuda", 0)
    # -- 1. environment --
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 matmuls are on; the port needs f64/f32")
    emit(dict(phase="environment", python=sys.version.split()[0],
              torch=torch.__version__, cuda=torch.version.cuda,
              device=torch.cuda.get_device_name(0),
              device_count=torch.cuda.device_count(), nvidia_smi=smi))

    # -- 2. build --
    t0 = time.perf_counter()
    K.build()
    build_s = time.perf_counter() - t0
    ptxas = [ln.strip() for ln in build_info.get("ptxas", "").splitlines()
             if "registers" in ln or "spill" in ln]
    emit(dict(phase="build", seconds=build_s, ptxas=ptxas))

    # -- 3. kernels vs twins --
    C1, src1 = load_graph("G1", args.gset, args.seed)
    C67, src67 = load_graph("G67", args.gset, args.seed)
    rows = phase_kernels(C67, device, args.seed)
    worst = worst_errors(rows)
    emit(dict(phase="kernels_vs_twins", cases=len(rows), worst=worst,
              table=[{k: r[k] for k in ("kernel", "mode", "dtype", "p_pad",
                                          "rel_err", "ms", "plain_ms")}
                     for r in rows]))

    # -- 4. G1-size solve (dense path) --
    g1 = solve_phase("G1_solve", C1, src1, device, check_oracle=True)
    # -- 5. G67-size solve: the slice --
    g67 = solve_phase("G67_solve", C67, src67, device, check_oracle=True)
    for name in ("symcoo_spmm", "oblique_cols"):
        if g67["launches"][name] <= 0:
            raise AssertionError(f"the G67 solve never launched {name}")

    # -- 6. K3 / K4 / K1 al_hess vs twins at the matrix-completion shapes --
    from manisdp_tpu_torch.ops.sparse import ConstraintOp
    data, mc_build_s = mc_instance()
    t0 = time.perf_counter()
    op_mc = ConstraintOp.build(data.At, data.b, data.c, int(data.K.s),
                               device)
    torch.cuda.synchronize()
    assemble_s = time.perf_counter() - t0
    al_rows = phase_al_kernels(op_mc, device, args.seed)
    worst = worst_errors(rows + al_rows)
    emit(dict(phase="al_kernels_vs_twins", cases=len(al_rows),
              worst=worst_errors(al_rows),
              table=[{k: r[k] for k in ("kernel", "mode", "dtype", "p_pad",
                                          "rel_err", "ms", "plain_ms")}
                     for r in al_rows]))
    # -- 7. the slice's solve: matrix completion at n = 12,000 --
    mc = al_solve_phase(data, op_mc, mc_build_s, assemble_s, device)

    # each kernel's hot call on its main path: the f32 tCG's Hessian and
    # projection (G67 solve), the f32 AL Hessian's products (mc solve)
    def pick(table, name, mode, p_pad):
        return next(r for r in table if r["kernel"] == name and
                    r["mode"] == mode and r["dtype"] == "float32" and
                    r["p_pad"] == p_pad)
    entries = [
        ("symcoo_spmm", "hess", pick(rows, "symcoo_spmm", "hess", HOT_P_PAD),
         "manisdp_tpu_torch/csrc/symcoo_spmm.cu",
         "manisdp_tpu/ops/sparse.py:40", g67["launches"]["symcoo_spmm"]),
        ("oblique_cols", "proj",
         pick(rows, "oblique_cols", "proj", HOT_P_PAD),
         "manisdp_tpu_torch/csrc/oblique_cols.cu",
         "manisdp_tpu/manifolds/oblique.py:27",
         g67["launches"]["oblique_cols"]),
        ("symcoo_spmm", "al_hess",
         pick(al_rows, "symcoo_spmm", "al_hess", AL_HOT_P_PAD),
         "manisdp_tpu_torch/csrc/symcoo_spmm.cu",
         "manisdp_tpu/solvers/primal_al.py:97",
         mc["symcoo_spmm_modes"]["al_hess"]),
        ("pattern_dots", "pair_dots",
         pick(al_rows, "pattern_dots", "pair_dots", AL_HOT_P_PAD),
         "manisdp_tpu_torch/csrc/pattern_dots.cu",
         "manisdp_tpu/ops/sparse.py:240", mc["launches"]["pattern_dots"]),
        ("csr_gather", "adjoint_on_pattern",
         pick(al_rows, "csr_gather", "adjoint_on_pattern", None),
         "manisdp_tpu_torch/csrc/csr_gather.cu",
         "manisdp_tpu/ops/sparse.py:244", mc["launches"]["csr_gather"]),
    ]
    kern = [dict(name=name if name != "symcoo_spmm" else f"{name}.{mode}",
                 route="cuda", source=src, replaces=rep, launches=launches,
                 max_abs_err=worst[name]["max_abs_err"], ms=r["ms"],
                 plain_ms=r["plain_ms"])
            for name, mode, r, src, rep, launches in entries]
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "chip_smoke.json"), "w") as f:
        json.dump(dict(nvidia_smi=smi, build_s=build_s, kernel_rows=rows,
                       al_kernel_rows=al_rows, g1=g1, g67=g67, mc12000=mc,
                       kernels=kern, total_s=time.perf_counter() - t_start),
                  f, indent=1)
    emit(dict(kernels=kern))
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
