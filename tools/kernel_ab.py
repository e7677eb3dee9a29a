"""A/B timing of the port's K7 (``symdual_apply``) and K10
(``symmom_adjoint``) on one card, across source trees.

Each tree's kernels are built and timed in a process of its own, in the
order given, at the q = 60 shapes of chip_smoke.py's phases 12 and 16:
K7 plain and with the y_step epilogue, K10 plain and with the fused base
(NaN in every don't-care slot of y), in f32 and f64.  Compare two trees in
turns on one card, e.g. the parent and the change:

    git archive <parent> | (mkdir -p build/parent && tar -x -C build/parent)
    python3 tools/kernel_ab.py --trees build/parent . . build/parent \\
        --out build/kernel_ab.json

Prints one JSON object per tree run, each case with the whole call's
device ms (chip_smoke.time_ms: CUDA events, median of 25), each launch's
ms (chip_smoke.pass_times: torch.profiler) and its error against the plain
twin; then the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
Q = 60


def child(tree):
    import importlib.util

    import torch

    # this tree's chip_smoke (its timers), the other tree's kernels
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    sys.path.insert(0, os.path.abspath(tree))
    from manisdp_tpu_torch import kernels as K
    from manisdp_tpu_torch.ops.symmom import dontcare_mask

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    rnd = lambda *s: torch.randn(s, generator=gen,  # noqa: E731
                                 dtype=torch.float64, device=dev)
    n, m = 2 + Q + Q * Q, K.symmom_flat_length(Q)
    M64 = rnd(n, n)
    M64 = 0.5 * (M64 + M64.T)
    C64, y64 = rnd(n, n), rnd(m)
    dc = torch.as_tensor(dontcare_mask(Q), device=dev)
    y64 = torch.where(dc, torch.full_like(y64, float("nan")), y64)
    scale64, shift64 = rnd(5).abs() + 0.5, rnd(1)[0]
    cases = []
    for dt in (torch.float32, torch.float64):
        M, C, y = M64.to(dt), C64.to(dt), y64.to(dt)
        scale, shift = scale64.to(dt), shift64.to(dt)
        for name, fn, twin, args, kw in (
                ("symdual_apply.apply", K.symdual_apply,
                 K.symdual_apply_plain, (M, Q), {}),
                ("symdual_apply.y_step", K.symdual_apply,
                 K.symdual_apply_plain, (M, Q),
                 dict(scale=scale, shift=shift)),
                ("symmom_adjoint.adjoint", K.symmom_adjoint,
                 K.symmom_adjoint_plain, (y, Q), {}),
                ("symmom_adjoint.es_vals", K.symmom_adjoint,
                 K.symmom_adjoint_plain, (y, Q), dict(base=C, alpha=0.37))):
            got, ref = fn(*args, **kw), twin(*args, **kw)
            abs_err, rel_err = cs.max_err(got, ref)
            cases.append(dict(
                case=name, dtype=str(dt)[6:], rel_err=rel_err,
                ms=cs.time_ms(lambda: fn(*args, **kw)),
                passes_ms=cs.pass_times(lambda: fn(*args, **kw))))
    print(json.dumps(dict(tree=tree, q=Q, cases=cases)), flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trees", nargs="+", default=["."])
    ap.add_argument("--out", default=None)
    ap.add_argument("--child", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child is not None:
        child(args.child)
        return 0
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
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(dict(nvidia_smi=smi, runs=runs), f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
