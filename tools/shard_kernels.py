"""Per-shard kernel times of the sharded constraint operator
(``parallel/sharded_ops.ShardedConstraintOp``) at mc-12000, without
spawning ranks: each piece of ``partition(arrays, world)`` is built in
this process with ``ShardedConstraintOp.from_piece(...).local`` and its
kernels are timed one at a time on one card.

For world sizes 2 and 4 (``--worlds``), every rank's piece: K1
``al_hess`` (the AL Hessian's two products, no epilogue, as the sharded
operator launches it), K1 ``plain`` and K3 (the pair dots), f32 and f64,
p 16, each beside its plain twin, its bound, the same kernel on the whole
pattern in the same call and, for K3, ``torch.sparse.sampled_addmm``
(``chip_smoke.piece_times``, which phase 24 also runs).  Every output is
hashed, so trees can be compared bit for bit, in turns on one card:

    git archive <parent> | (mkdir -p build/parent && tar -x -C build/parent)
    python3 tools/shard_kernels.py --trees build/parent . . build/parent \\
        --out build/shard_kernels.json

The mc-12000 operator (chip_smoke.MC; ``--mc`` a smaller one, for a CPU
rehearsal with ``--device cpu``) is built once, on the CPU, by the first
process and its host arrays kept under build/shard_kernels/.  Each tree
prints one JSON object; then a summary (per case, whether every run gave
the same bits) and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, "build", "shard_kernels")


def _chip_smoke():
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def build_arrays(mc):
    """The matrix completion ``mc``'s operator (chip_smoke.MC's keys): its
    host arrays (``ConstraintOp.host_arrays(full=True)``), saved as numpy
    arrays (built with this tree's package); returns their path."""
    import numpy as np
    path = os.path.join(CACHE, "mc_{p}x{q}_{m_samples}_{seed}.npz".format(
        **mc))
    if os.path.exists(path):
        return path
    sys.path.insert(0, ROOT)
    from manisdp_tpu_torch.ops.sparse import ConstraintOp
    cs = _chip_smoke()
    data, _ = cs.mc_instance(mc)
    arrays = ConstraintOp.build(data.At, data.b, data.c, int(data.K.s),
                                "cpu").host_arrays(full=True)
    os.makedirs(CACHE, exist_ok=True)
    tmp = path + ".tmp.npz"
    np.savez(tmp, **arrays)
    os.replace(tmp, path)
    return path


def child(tree, worlds, device, path):
    """chip_smoke.piece_times with ``tree``'s package on the arrays saved
    at ``path``."""
    import numpy as np
    cs = _chip_smoke()
    sys.path.insert(0, os.path.abspath(tree))
    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files}
    arrays["m"], arrays["n"] = int(arrays["m"]), int(arrays["n"])
    rows = cs.piece_times(arrays, worlds, device)
    print(json.dumps(dict(tree=tree, rows=rows)), flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trees", nargs="+", default=["."])
    ap.add_argument("--worlds", nargs="+", type=int, default=[2, 4])
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda:0",
                    help="cpu: run the plain twins, untimed (a rehearsal)")
    ap.add_argument("--mc", default=None,
                    help="p,q,m_samples of a smaller matrix completion (a "
                    "rehearsal; the cache then holds it)")
    ap.add_argument("--child", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--arrays", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child is not None:
        child(args.child, args.worlds, args.device, args.arrays)
        return 0
    cs = _chip_smoke()
    mc = dict(cs.MC)
    if args.mc:
        mc.update(zip(("p", "q", "m_samples"), map(int, args.mc.split(","))))
    path = build_arrays(mc)
    runs = []
    for tree in args.trees:
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--child", tree,
             "--arrays", path, "--device", args.device, "--worlds",
             *map(str, args.worlds)],
            capture_output=True,
            text=True, cwd=ROOT)
        if proc.returncode != 0:
            print(proc.stdout, proc.stderr, file=sys.stderr)
            return proc.returncode
        runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
        print(json.dumps(runs[-1]), flush=True)
    hashes = {}
    for run in runs:
        for r in run["rows"]:
            key = f"{r['kernel']}|w{r['world']}r{r['rank']}|{r['dtype']}"
            hashes.setdefault(key, set()).add(r["hash"])
    same = {k: len(v) == 1 for k, v in hashes.items()}
    print(json.dumps(dict(bit_equal=same, all_equal=all(same.values()))),
          flush=True)
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.strip()
    except FileNotFoundError:
        smi = "no nvidia-smi (a CPU rehearsal)"
    print(smi)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(dict(nvidia_smi=smi, runs=runs, bit_equal=same), f,
                      indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
