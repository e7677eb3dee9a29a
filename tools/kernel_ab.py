"""A/B timing and bit comparison of the port's kernels K1
(``symcoo_spmm``), K7 (``symdual_apply``), K9 (``symmom_apply``) and K10
(``symmom_adjoint``) on one card, across source trees.

Each tree's kernels are built and run in a process of its own, in the
order given, on inputs made from fixed seeds on the card (so every
process sees the same bits):
  - K1 at chip_smoke.py's shapes: every single-instance mode on the G67
    stand-in at p_pad 8 / 24 / 40 / 48 (plain_strided: the Vᵀ view of
    matvec_block, k = 9), al_hess and al_hess_diag on the mc-12000 pattern
    at p 8 / 16 / 24, instance plain / cost / hess on the sparse batch's
    first bucket (8 grids of 60 x 50, n_pad 3,072) at p 40 / 48;
  - K9 and K7 / K10 at q = 60 (K10 with NaN in every don't-care slot);
in f32 and f64.  Compare two trees in turns on one card, e.g. the parent
and the change:

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

    def run(name, dt, fn, twin, args, kw, **info):
        got, ref = fn(*args, **kw), twin(*args, **kw)
        _, rel_err = cs.max_err(got, ref)
        cases.append(dict(
            case=name, dtype=str(dt)[6:], **info, rel_err=rel_err,
            hash=digest(got), ms=cs.time_ms(lambda: fn(*args, **kw)),
            passes_ms=cs.pass_times(lambda: fn(*args, **kw))))

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
    print(json.dumps(dict(tree=tree, cases=cases)), flush=True)


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
                                     same.items()})), flush=True)
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
