"""A/B timing and bit comparison of the port's kernels K1
(``symcoo_spmm``), K2 (``oblique_cols``), K7 (``symdual_apply``), K8
(``symdual_adjoint``), K9 (``symmom_apply``), K10 (``symmom_adjoint``)
and K11 (the tCG vector step) on one card, across source trees.

Each tree's kernels are built and run in a process of its own, in the
order given, on inputs made from fixed seeds on the card (so every
process sees the same bits):
  - K1 at chip_smoke.py's shapes: every single-instance mode on the G67
    stand-in at p_pad 8 / 24 / 40 / 48 (plain_strided: the Vᵀ view of
    matvec_block, k = 9), al_hess and al_hess_diag on the mc-12000 pattern
    at p 8 / 16 / 24, instance plain / cost / hess on the sparse batch's
    first bucket (8 grids of 60 x 50, n_pad 3,072) at p 40 / 48;
  - K9 and K7 / K10 at q = 60 (K10 with NaN in every don't-care slot);
  - K8 at q = 60: ``adjoint`` plain, scaled and as the residual (B1,
    B2), y with NaN in every don't-care slot; ``sym_mat``;
    ``sym_factor`` at p 8 / 64 / 192, with and without renorm;
  - K2: every mode (``proj``, ``proj_eG``, ``retr``, ``renormalize``) at
    G67 (n = 10^4) at p_pad 8 / 24 / 40 / 48; the instance stride at the
    sparse batch's shape (8 x 3,072) at p 40 / 48; every masked mode at
    the chain's shape (p 8, N = 4,220); ``proj_eG`` at the q = 60 dual's
    shape (p 192, n = 3,662);
  - K11: one tCG step at the sparse batch's shape (8 x 48 x 3,072) and at
    G67's (1 x 40 x 10^4), without and with the tangent projection (and
    the batch with a column mask), and a batch whose instances include a
    stopped and an idle one.  On a tree without ``kernels.tcg_step`` the
    step is its three passes followed by K2 ``proj``.  The hash covers
    eta, Heta, r, the scalar state and the next direction of the active
    instances (a stopped instance's is never read);
  - K1 ``al_hess`` and K3 on the mc-12000 pattern's world-2 and world-4
    slices (``partition``'s cuts), over the slice's columns where the
    tree's SymCOO has a ``span`` (hashed on those columns either way), and
    K3 on the whole pattern;
  - on a tree with the row-block and split modes (slice 6b), each at one
    rank (the collectives the identity): K7 ``rows`` and K8 ``rows`` (the
    rows of a quarter of the grid at offset 15) at q = 60, K7 ``rows_d4``
    over four ranks in one process (the all-to-all by slicing), every K11
    case above again in split mode (``*_split``: its hash must equal the
    one launch's);
in f32 and f64.  Each tree also solves the G67 stand-in and the sparse
batch's first bucket (their objectives hashed too) and reports the host
and the device ms per tCG iteration at their solutions
(chip_smoke.tcg_iteration_ms).  Last, it solves chip_smoke.py's phase 15
instance (the quartic over the sphere, d = 30; K11 without the
projection) counting its tCG steps by shape, times K11 at each of those
shapes (``tcg_step.qs30.step``) and reports the solve's K11 ms (steps
times ms, summed) beside the same sum of bounds.  Compare two trees in
turns on one card, e.g. the parent and the change:

    git archive <parent> | (mkdir -p build/parent && tar -x -C build/parent)
    python3 tools/kernel_ab.py --trees build/parent . . build/parent \\
        --out build/kernel_ab.json

The mc-12000 pattern is built once, on the CPU, by the first process and
kept under build/kernel_ab/.  Each tree run prints one JSON object: every
case with a hash of its output bytes, the whole call's device ms
(chip_smoke.time_ms: CUDA events, median of 25), each launch's ms
(chip_smoke.pass_times: torch.profiler) and its error against the plain
twin.  Then a summary line (per case, whether every run gave the same
bits, and the distinct hashes by tree) and the card's name and power
limit.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
Q = 60
# the chain's N (clique_chain(20, 20): 20 blocks of 211) and the q = 60
# SOS dual's expanded n
CHAIN_N, DUAL_N = 4220, 3662
PATTERN = os.path.join(ROOT, "build", "kernel_ab", "mc12000_pattern.npz")


def _chip_smoke():
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def build_pattern():
    """The mc-12000 ConstraintOp's pattern (chip_smoke.MC), saved as
    numpy arrays; the build runs on the CPU with this tree's package."""
    import numpy as np
    if os.path.exists(PATTERN):
        return
    sys.path.insert(0, ROOT)
    from manisdp_tpu_torch.ops.sparse import ConstraintOp
    cs = _chip_smoke()
    data, _ = cs.mc_instance(cs.MC)
    op = ConstraintOp.build(data.At, data.b, data.c, int(data.K.s), "cpu")
    os.makedirs(os.path.dirname(PATTERN), exist_ok=True)
    tmp = PATTERN + ".tmp.npz"
    np.savez(tmp, i=op.pat.i.numpy(), j=op.pat.j.numpy(),
             colptr=op.pat.colptr.numpy(), n=op.n)
    os.replace(tmp, PATTERN)


def digest(out):
    """A hash of the output bytes (every tensor of a tuple, in order)."""
    h = hashlib.sha256()
    for t in out if isinstance(out, tuple) else (out,):
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def child(tree):
    import numpy as np
    import torch

    # this tree's chip_smoke (timers, stand-ins), the other tree's kernels
    cs = _chip_smoke()
    sys.path.insert(0, os.path.abspath(tree))
    from manisdp_tpu_torch import kernels as K
    from manisdp_tpu_torch.ops.sparse import BatchedSymCOO, SymCOO
    from manisdp_tpu_torch.ops.symmom import dontcare_mask

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    rnd = lambda *s: torch.randn(s, generator=gen,  # noqa: E731
                                 dtype=torch.float64, device=dev)
    cases = []
    dtypes = (torch.float32, torch.float64)

    def run(name, dt, fn, twin, args, kw, timed=None, **info):
        """``timed``: the call to time, where ``fn`` does more than the
        kernel (K11's fresh copies of its in-place vectors)."""
        got, ref = fn(*args, **kw), twin(*args, **kw)
        _, rel_err = cs.max_err(got, ref)
        timed = timed or (lambda: fn(*args, **kw))
        cases.append(dict(
            case=name, dtype=str(dt)[6:], **info, rel_err=rel_err,
            hash=digest(got), ms=cs.time_ms(timed),
            passes_ms=cs.pass_times(timed)))
        return cases[-1]

    k1 = (K.symcoo_spmm, K.symcoo_spmm_plain)
    # K1 at G67
    C64 = SymCOO.from_scipy(cs.g67_standin(0), dev)
    n = C64.n
    for dt in dtypes:
        C = C64.astype(dt)
        for p in cs.P_PADS:
            Y = K.oblique_cols_plain(rnd(p, n).to(dt), None, "renormalize")
            U = K.oblique_cols_plain(Y, rnd(p, n).to(dt), "proj")
            # eG drawn, not the twin's colsum: index_add_ is atomic on the
            # card, so every process would get other bits
            z, eG = rnd(n).to(dt), rnd(n).to(dt)
            V = rnd(n, 9).to(dt)
            for mode, args, kw in (
                    ("plain", (Y, C, "plain"), {}),
                    ("shift", (Y, C, "shift"), dict(z=z)),
                    ("cost", (Y, C, "cost"), {}),
                    ("hess", (U, C, "hess"), dict(B=Y, eG=eG)),
                    ("plain_strided", (V.T, C, "plain"), {})):
                run(f"symcoo_spmm.g67.{mode}", dt, *k1, args, kw, p=p)
    del C64, C
    # K1 al_hess on the mc-12000 pattern
    pat = np.load(PATTERN)
    as_t = lambda a, d: torch.as_tensor(a, dtype=d, device=dev)  # noqa: E731
    P64 = SymCOO(i=as_t(pat["i"], torch.int32), j=as_t(pat["j"], torch.int32),
                 v=rnd(pat["i"].size), n=int(pat["n"]),
                 colptr=as_t(pat["colptr"], torch.int32))
    n, nnz = P64.n, P64.nnz
    for dt in dtypes:
        Pt = P64.astype(dt)
        es, ayu, YeG = rnd(nnz).to(dt), rnd(nnz).to(dt), rnd(n).to(dt)
        for p in cs.AL_P_PADS:
            Y = K.oblique_cols_plain(rnd(p, n).to(dt), None, "renormalize")
            U = K.oblique_cols_plain(Y, rnd(p, n).to(dt), "proj")
            hess = dict(vals=es, B=Y, vals2=ayu, coefs=(2.0, 4.0 * 0.37))
            run("symcoo_spmm.mc12000.al_hess", dt, *k1,
                (U, Pt, "al_hess"), hess, p=p)
            run("symcoo_spmm.mc12000.al_hess_diag", dt, *k1,
                (U, Pt, "al_hess"), dict(hess, eG=YeG), p=p)
    del P64, Pt, es, ayu
    # K1 instance mode on the sparse batch's first bucket
    _, sparse = cs.batch_graphs()
    Cb64 = BatchedSymCOO.from_scipy(sparse[:cs.BATCH_GRID_B], cs.BATCH_N_PAD,
                                    dev)
    B, n = Cb64.nb, Cb64.n
    for dt in dtypes:
        Cb = BatchedSymCOO(i=Cb64.i, j=Cb64.j, v=Cb64.v.to(dt),
                           colptr=Cb64.colptr, eoff=Cb64.eoff, n=n)
        for p in cs.BATCH_P_PADS:
            Y = K.oblique_cols_plain(rnd(B, p, n).to(dt), None,
                                     "renormalize")
            U = K.oblique_cols_plain(Y, rnd(B, p, n).to(dt), "proj")
            eG = rnd(B, n).to(dt)
            for mode, args, kw in (("plain", (Y, Cb, "plain"), {}),
                                   ("cost", (Y, Cb, "cost"), {}),
                                   ("hess", (U, Cb, "hess"),
                                    dict(B=Y, eG=eG))):
                run(f"symcoo_spmm.batch.instance_{mode}", dt, *k1, args, kw,
                    p=p, instances=B)
    del Cb64, Cb
    # K9, K7, K10 at q = 60
    n, m = 2 + Q + Q * Q, K.symmom_flat_length(Q)
    M64 = rnd(n, n)
    C64, y64 = rnd(n, n), rnd(m)
    dc = torch.as_tensor(dontcare_mask(Q), device=dev)
    y64 = torch.where(dc, torch.full_like(y64, float("nan")), y64)
    scale64, shift64 = rnd(5).abs() + 0.5, rnd(1)[0]
    for dt in dtypes:
        M, C, y = M64.to(dt), C64.to(dt), y64.to(dt)
        scale, shift = scale64.to(dt), shift64.to(dt)
        for name, fn, twin, args, kw in (
                ("symmom_apply", K.symmom_apply, K.symmom_apply_plain,
                 (M, Q), {}),
                ("symdual_apply.apply", K.symdual_apply,
                 K.symdual_apply_plain, (M, Q), {}),
                ("symdual_apply.y_step", K.symdual_apply,
                 K.symdual_apply_plain, (M, Q),
                 dict(scale=scale, shift=shift)),
                ("symmom_adjoint.adjoint", K.symmom_adjoint,
                 K.symmom_adjoint_plain, (y, Q), {}),
                ("symmom_adjoint.es_vals", K.symmom_adjoint,
                 K.symmom_adjoint_plain, (y, Q), dict(base=C, alpha=0.37))):
            run(name, dt, fn, twin, args, kw, q=Q)
    k8_cases(K, rnd, dtypes, run, dev)
    k2_cases(cs, K, rnd, dtypes, run)
    k11_cases(cs, K, rnd, dtypes, run, dev)
    solves, host = solve_points(cs, dev)
    solves["qs30"], steps = qs30_steps(cs, dev)
    qs30 = k11_qs30_cases(cs, K, rnd, run, dev, steps)
    if hasattr(K, "symdual_apply_rows"):
        # last: its draws from ``rnd`` must not move the other cases' inputs
        row_cases(cs, K, rnd, dtypes, run)
    shard_cases(K, SymCOO, dtypes, run, dev)
    print(json.dumps(dict(tree=tree, cases=cases, solves=solves,
                          tcg_iteration=host, qs30_k11=dict(
                              qs30, by_shape=steps))), flush=True)


def shard_cases(K, SymCOO, dtypes, run, dev):
    """K1 ``al_hess`` and K3 at p 16 on the mc-12000 pattern whole and on
    each world-2 and world-4 slice of it (``partition``'s cuts of the
    (j, i)-sorted pattern ids), with inputs of a generator of their own.  On
    a tree whose SymCOO has a ``span``, a slice runs over its own columns;
    on an older tree over all n (its other columns zero), hashed on the
    slice's columns, so the two trees' hashes compare."""
    import numpy as np
    import torch
    pat = np.load(PATTERN)
    i_all, j_all, n = pat["i"], pat["j"], int(pat["n"])
    nnzP = i_all.size
    gen = torch.Generator(device=dev)
    gen.manual_seed(16)
    rnd = lambda *s: torch.randn(s, generator=gen,  # noqa: E731
                                 dtype=torch.float64, device=dev)
    as_t = lambda a, d: torch.as_tensor(a, dtype=d, device=dev)  # noqa: E731
    spans = "span" in SymCOO.__dataclass_fields__
    for world in (1, 2, 4):
        Lp = -(-nnzP // world)
        for r in range(world):
            lo, hi = r * Lp, min((r + 1) * Lp, nnzP)
            i, j = i_all[lo:hi], j_all[lo:hi]
            c0, c1 = int(j[0]), int(j[-1]) + 1
            colptr = np.zeros(n + 1, np.int64)
            np.cumsum(np.bincount(j, minlength=n), out=colptr[1:])
            span = dict(span=(c0, c1, int(i.min()), int(i.max()) + 1)) \
                if spans and world > 1 else {}
            P64 = SymCOO(i=as_t(i, torch.int32), j=as_t(j, torch.int32),
                         v=rnd(hi - lo), n=n,
                         colptr=as_t(colptr, torch.int32), **span)

            def cols(fn):
                def call(*a, **kw):
                    out = fn(*a, **kw)
                    return out[:, c0:c1] if out.shape[-1] != c1 - c0 \
                        else out
                return call

            tag = "mc12000" if world == 1 else f"mc12000_w{world}r{r}"
            for dt in dtypes:
                Pt = P64.astype(dt)
                es, ayu = rnd(hi - lo).to(dt), rnd(hi - lo).to(dt)
                Y = K.oblique_cols_plain(rnd(16, n).to(dt), None,
                                         "renormalize")
                U = K.oblique_cols_plain(Y, rnd(16, n).to(dt), "proj")
                if world > 1:
                    run(f"symcoo_spmm.{tag}.al_hess", dt,
                        cols(K.symcoo_spmm), cols(K.symcoo_spmm_plain),
                        (U, Pt, "al_hess"), dict(vals=es, B=Y, vals2=ayu,
                                                 coefs=(2.0, 4.0 * 0.37)),
                        p=16)
                run(f"pattern_dots.{tag}", dt, K.pattern_dots,
                    K.pattern_dots_plain, (Y, U, Pt), {}, p=16)


def solve_points(cs, dev):
    """The G67 stand-in through solve_maxcut_unitdiag and the sparse
    batch's first bucket through solve_maxcut_batch (p0 = 40): their
    objectives (hex, to compare bits across trees) and iteration counts,
    and the host / device ms per tCG iteration at their solutions."""
    import torch
    from manisdp_tpu_torch import solve_maxcut_batch, solve_maxcut_unitdiag
    g67 = cs.g67_standin(0)
    single = solve_maxcut_unitdiag(g67, p0=40, device=dev, verbose=False)
    grids = cs.batch_graphs()[1][:cs.BATCH_GRID_B]
    batch = solve_maxcut_batch(grids, p0=40, device=dev, verbose=False)
    solves = dict(
        g67=dict(obj=single.obj.hex(), outer=single.iterations,
                 hess_calls=single.hess_calls),
        batch=[dict(obj=r.obj.hex(), outer=r.iterations,
                    hess_calls=r.hess_calls) for r in batch])
    host = [cs.tcg_iteration_ms([g67], [single.Y], cs.HOT_P_PAD, 10 ** 4,
                                torch.float32, dev),
            cs.tcg_iteration_ms(grids, [r.Y for r in batch],
                                cs.BATCH_P_PADS[-1], cs.BATCH_N_PAD,
                                torch.float64, dev)]
    return solves, host


def k8_cases(K, rnd, dtypes, run, dev):
    """K8 at q = 60: adjoint plain, scaled and as the dual cost's residual
    (B1, c1 = -1, B2, c2 = -1/sigma), y as views of one flat buffer (K7's
    output layout) with NaN in every don't-care slot; sym_mat; sym_factor
    at p 8 / 64 / 192 with and without renorm."""
    import torch
    from manisdp_tpu_torch.ops.symdual import _dontcare_mask, _split
    n = 2 + Q + Q * Q
    flat64 = rnd(1 + Q + Q * Q + Q ** 3 + Q ** 4)
    flat64[torch.as_tensor(_dontcare_mask(Q), device=dev)] = float("nan")
    M64, X64 = rnd(n, n), rnd(n, n)
    scale64 = rnd(5).abs() + 0.5
    Ys64 = {p: rnd(p, n) for p in (8, 64, 192)}
    adj = (K.symdual_adjoint, K.symdual_adjoint_plain)
    for dt in dtypes:
        y = _split(flat64.to(dt), Q)
        M, X, scale = M64.to(dt), X64.to(dt), scale64.to(dt)
        for mode, kw in (("adjoint", {}),
                         ("adjoint_scaled", dict(scale=scale)),
                         ("residual", dict(B1=M, c1=-1.0, B2=X,
                                           c2=-1.0 / 0.37))):
            run(f"symdual_adjoint.{mode}", dt, *adj, (y, Q), kw, q=Q)
        run("symdual_adjoint.sym_mat", dt, K.symdual_sym_mat,
            K.symdual_sym_mat_plain, (M, Q), {}, q=Q)
        for p, Y64 in Ys64.items():
            for renorm in (True, False):
                run(f"symdual_adjoint.sym_factor_"
                    f"{'renorm' if renorm else 'plain'}", dt,
                    K.symdual_sym_factor, K.symdual_sym_factor_plain,
                    (Y64.to(dt), Q, renorm), {}, p=p)


def row_cases(cs, K, rnd, dtypes, run):
    """K7's and K8's row-block modes at q = 60 and one rank: apply on the
    whole grid (the all-to-all a copy, the all-reduce the identity), the
    adjoint of the Y4 rows [15, 30); then the apply over D = 4 ranks in
    this process (chip_smoke.rows_in_one_process: a thread per rank, the
    all-to-all by slicing the ranks' send buffers)."""
    from manisdp_tpu_torch.ops.symdual import _split
    n, o, ql = 2 + Q + Q * Q, 2 + Q, Q // 4
    M64 = rnd(n, n)
    M64 = M64 + M64.T
    flat64 = rnd(1 + Q + Q * Q + Q ** 3 + Q ** 4)
    a2a = lambda send, recv: recv.copy_(send)  # noqa: E731
    one = lambda t: t  # noqa: E731
    for dt in dtypes:
        M = M64.to(dt)
        top, rows = M[:o].contiguous(), M[o:].reshape(Q, Q, n)
        run("symdual_apply.rows", dt, K.symdual_apply_rows,
            K.symdual_apply_rows_plain, (top, rows, Q, 0, a2a, one), {}, q=Q)
        y = _split(flat64.to(dt), Q)
        yl = y[:4] + (y[4][ql:2 * ql].contiguous(),)
        run("symdual_adjoint.rows", dt, K.symdual_adjoint_rows,
            K.symdual_adjoint_rows_plain, (yl, Q, ql), {}, q=Q)
    for dt in dtypes:
        M = M64.to(dt)
        top, rows = M[:o].contiguous(), M[o:].reshape(Q, Q, n)
        run("symdual_apply.rows_d4", dt,
            lambda *a: cs.rows_in_one_process(K.symdual_apply_rows, *a),
            lambda *a: cs.rows_in_one_process(K.symdual_apply_rows_plain,
                                              *a),
            (top, rows, Q, 4), {}, q=Q, ranks=4)


def k2_cases(cs, K, rnd, dtypes, run):
    """K2 at the G67, batch, chain and q = 60 dual shapes."""
    k2 = (K.oblique_cols, K.oblique_cols_plain)

    def modes(Y, H, U, g, mask=None):
        m = {} if mask is None else dict(mask=mask)
        return (("proj", (Y, H, "proj"), m),
                ("proj_eG", (Y, H, "proj"), dict(v=U, g=g, **m)),
                ("retr", (Y, H, "retr"), m),
                ("renormalize", (Y + H, None, "renormalize"), m))

    def inputs(shape, dt):
        Y = K.oblique_cols_plain(rnd(*shape).to(dt), None, "renormalize")
        return (Y, rnd(*shape).to(dt), rnd(*shape).to(dt),
                rnd(*shape[:-2], shape[-1]).to(dt))

    for dt in dtypes:
        for p in cs.P_PADS:
            for mode, args, kw in modes(*inputs((p, 10 ** 4), dt)):
                run(f"oblique_cols.g67.{mode}", dt, *k2, args, kw, p=p)
        for p in cs.BATCH_P_PADS:
            for mode, args, kw in modes(*inputs(
                    (cs.BATCH_GRID_B, p, cs.BATCH_N_PAD), dt)):
                run(f"oblique_cols.batch.instance_{mode}", dt, *k2, args,
                    kw, p=p, instances=cs.BATCH_GRID_B)
        n = CHAIN_N
        Y, H, U, g = inputs((8, n), dt)
        mask = (rnd(n) > 0).to(dt)
        for mode, args, kw in modes(Y, H, U, g, mask):
            run(f"oblique_cols.chain.masked_{mode}", dt, *k2, args, kw, p=8)
        Y, H, U, g = inputs((192, DUAL_N), dt)
        mode, args, kw = modes(Y, H, U, g)[1]
        run("oblique_cols.q60.proj_eG", dt, *k2, args, kw, p=192)


def k11_step(K):
    """The tree's one tCG vector step, (d, Hd, eta, Heta, r, sc, st,
    mininner, Y, mask) -> (eta, Heta, r, d, sc, st): ``tcg_step``, or on
    a tree without it the three passes and K2 ``proj``."""
    if hasattr(K, "tcg_step"):
        return K.tcg_step, K.tcg_step_plain

    def compose(dots, update, finish, proj):
        def step(d, Hd, eta, Heta, r, sc, st, mininner, Y=None, mask=None):
            part = dots(d, Hd, r, st)
            eta, Heta, r, part2, xs = update(part, sc, st, d, Hd, eta, Heta,
                                             r)
            d, sc, st = finish(part2, sc, st, xs, r, d, mininner)
            if Y is not None:
                d = proj(Y, d, "proj", mask=mask)
            return eta, Heta, r, d, sc, st
        return step

    return (compose(K.tcg_dots, K.tcg_update, K.tcg_finish,
                    K.oblique_cols),
            compose(K.tcg_dots_plain, K.tcg_update_plain,
                    K.tcg_finish_plain, K.oblique_cols_plain))


def k11_inputs(rnd, shape, dt):
    """A tCG state at one (B, p, n) shape: d, Hd (d times a positive
    diagonal), eta, Heta, r (with <d, r> > 0) and the scalar state sc of
    a first trust region."""
    import numpy as np
    import torch
    d = rnd(*shape).to(dt)
    Hd = d * (1.0 + rnd(*shape).abs().to(dt))
    r = rnd(*shape).to(dt)
    r = r * torch.sign(torch.sum(d * r, dim=(1, 2)))[:, None, None]
    eta, Heta = rnd(*shape).to(dt), rnd(*shape).to(dt)
    r_r = torch.sum(r * r, dim=(1, 2))
    z = torch.zeros_like(r_r)
    sc = torch.stack([z, z + 0.2, r_r * 1.5, r_r, z,
                      z + np.pi ** 2 * shape[2] / 64, z, z + 1], 1)
    return (d, Hd, eta, Heta, r), sc


def k11_run(run, name, kern, twin, vecs, sc, st, Y, mask, **info):
    """One K11 case: the kernel and the twin on fresh copies of ``vecs``
    (hashing eta, Heta, r, sc, st and the active instances' d), timed on
    one set of buffers, whose values drift."""
    act = st[:, 1] == 0
    bufs = [t.clone() for t in vecs]

    def call(f):
        e2, H2, r2, d2, sc2, st2 = f(*[t.clone() for t in vecs], sc, st, 1,
                                     Y, mask)
        return e2, H2, r2, sc2, st2.to(e2.dtype), d2[act]

    return run(name, vecs[0].dtype, lambda: call(kern), lambda: call(twin),
               (), {}, timed=lambda: kern(*bufs, sc, st, 1, Y, mask), **info)


def k11_cases(cs, K, rnd, dtypes, run, dev):
    """K11 at the batch's and G67's shapes, without and with the tangent
    projection; the vectors are fresh copies for every call."""
    import torch
    kern, twin = k11_step(K)
    for shape in ((cs.BATCH_GRID_B, cs.BATCH_P_PADS[-1], cs.BATCH_N_PAD),
                  (1, cs.HOT_P_PAD, 10 ** 4)):
        B, p, n = shape
        for dt in dtypes:
            vecs, sc = k11_inputs(rnd, shape, dt)
            Y = K.oblique_cols_plain(rnd(*shape).to(dt), None, "renormalize")
            mask = (rnd(n) > 0).to(dt)
            st = torch.zeros((B, 2), dtype=torch.int32, device=dev)
            variants = [("step", None, None, st), ("step_proj", Y, None, st)]
            if B > 1:
                idle = st.clone()
                idle[1, 1], idle[B - 1, 1] = 2, 7     # stopped, idle
                variants += [("step_proj_masked", Y, mask, st),
                             ("step_proj_stopped", Y, None, idle)]
            for name, Yv, mv, stv in variants:
                k11_run(run, f"tcg_step.{'batch' if B > 1 else 'g67'}.{name}",
                        kern, twin, vecs, sc, stv, Yv, mv, p=p, instances=B)
                if hasattr(K, "symdual_apply_rows"):
                    # split mode at one rank: the sum over ranks the identity
                    k11_run(run, f"tcg_step.{'batch' if B > 1 else 'g67'}."
                            f"{name}_split", split_step(K.tcg_step),
                            split_step(K.tcg_step_plain), vecs, sc, stv, Yv,
                            mv, p=p, instances=B)


def split_step(step):
    """K11's ``step`` (kernel or twin) in split mode at one rank."""
    def run(*args):
        return step(*args, reduce=lambda t: t)
    return run


def qs30_steps(cs, dev):
    """chip_smoke's phase 15 solve, the quartic over the sphere at d = 30
    through solve_dual_sdp (the Euclidean manifold: K11 without the
    projection), with its tCG vector steps counted by shape: the solve's
    objective (hex) and iterations, and [(B, p, n), dtype, steps] by
    shape."""
    import numpy as np
    from manisdp_tpu_torch import solve_dual_sdp
    from manisdp_tpu_torch.core import trustregions as TRm
    # the tree's first kernel call of a tCG step takes d first
    name = "tcg_step" if hasattr(TRm, "tcg_step") else "tcg_dots"
    fn, steps = getattr(TRm, name), {}

    def spy(d, *a):
        key = (tuple(d.shape), str(d.dtype)[6:])
        steps[key] = steps.get(key, 0) + 1
        return fn(d, *a)

    A, b, c, mb, f, dAAt = cs.qs_instance(cs.QS_D)
    maxb = float(np.max(np.abs(b)))
    setattr(TRm, name, spy)
    try:
        res = solve_dual_sdp(A, b / maxb, c, mb, f=f, dAAt=dAAt, device=dev,
                             verbose=False, **cs.QS_KW)
    finally:
        setattr(TRm, name, fn)
    return (dict(obj=res.obj.hex(), outer=res.iterations,
                 hess_calls=res.hess_calls),
            [[list(k[0]), k[1], v] for k, v in sorted(steps.items())])


def k11_qs30_cases(cs, K, rnd, run, dev, steps):
    """K11 without the projection at every tCG shape of the qs-d30 solve,
    and the solve's K11 time: the steps at each shape times its ms, beside
    the same sum of bounds (one read of d, Hd, eta, Heta, r and one write
    of eta, Heta, r, d; chip_smoke.bound)."""
    import torch
    kern, twin = k11_step(K)
    total = bound = 0.0
    for shape, dtype, count in steps:
        dt = getattr(torch, dtype)
        vecs, sc = k11_inputs(rnd, tuple(shape), dt)
        st = torch.zeros((shape[0], 2), dtype=torch.int32, device=dev)
        case = k11_run(run, "tcg_step.qs30.step", kern, twin, vecs, sc, st,
                       None, None, p=shape[1], n=shape[2], steps=count)
        L = vecs[0].numel()
        total += count * case["ms"]
        bound += count * cs.bound(9.0 * L * vecs[0].element_size(),
                                  14.0 * L, dtype)[0]
    return dict(steps=sum(c for *_, c in steps), k11_ms=total,
                bound_ms=bound)


def summary(runs):
    """Per case (name, dtype, p): whether every run gave the same bits,
    and the hashes by tree."""
    out = {}
    for run in runs:
        for c in run["cases"]:
            key = f"{c['case']}|{c['dtype']}|{c.get('p', c.get('q'))}"
            out.setdefault(key, {}).setdefault(run["tree"], set()).add(
                c["hash"])
    return {key: dict(equal=len(set().union(*by.values())) == 1,
                      hashes={t: sorted(h) for t, h in by.items()})
            for key, by in out.items()}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trees", nargs="+", default=["."])
    ap.add_argument("--out", default=None)
    ap.add_argument("--child", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child is not None:
        child(args.child)
        return 0
    build_pattern()
    runs = []
    for tree in args.trees:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                               "--child", tree], capture_output=True,
                              text=True, cwd=ROOT)
        if proc.returncode != 0:
            print(proc.stdout, proc.stderr, file=sys.stderr)
            return proc.returncode
        runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
        print(json.dumps(runs[-1]), flush=True)
    same = summary(runs)
    print(json.dumps(dict(bit_equal={k: v["equal"] for k, v in
                                     same.items()},
                          solves_equal=all(r["solves"] == runs[0]["solves"]
                                           for r in runs),
                          tcg_iteration=[[r["tree"], r["tcg_iteration"]]
                                         for r in runs],
                          qs30_k11=[[r["tree"], r["qs30_k11"]["k11_ms"],
                                     r["qs30_k11"]["bound_ms"],
                                     r["qs30_k11"]["steps"]]
                                    for r in runs])), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(dict(nvidia_smi=smi, runs=runs, hashes=same), f,
                      indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
