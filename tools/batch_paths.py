"""Per-instance paths of ``solve_maxcut_batch`` on pool calls of a
portbench MaxCut cell, compared across source trees on one card.

Each tree runs in a process of its own, in the order given: one warm call
(the cell's warm-up instances, untimed), then each of the window calls
``--calls`` of seed ``--seed`` (``portbench.runner.Cell.instances``, so
every tree gets the same problems), timed to ``torch.cuda.synchronize()``
with the peak device memory.  Per instance it records status, outer and
RTR iterations, Hessian products, ranks, obj and dinf (exact, as hex),
each outer iteration's dinf, and whether the returned z is colsum(Y o YC)
of the returned Y (``z_rel``, relative to 1 + max |z|).  Then a summary:
per call, the instances whose obj, dinf and iteration count every tree
shares bit for bit, and the per-iteration dinf of every instance left
uncertified, by tree.  Compare the parent and the change in turns:

    git archive <parent> | (mkdir -p build/parent && tar -x -C build/parent)
    python3 tools/batch_paths.py --trees build/parent . . build/parent \\
        --cell maxcut.torus3k-b16-stall --calls 4 --seed 3200002101 \\
        --out build/batch_paths.json

``--device cpu --params rows=6,cols=5`` rehearses it on the CPU at a
small torus.  The portbench cell is read from this checkout; only the
solver comes from each tree.
"""

import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _one(args):
    """Solve the calls with the tree ``args.tree`` first on the path and
    print one JSON object."""
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    sys.path.insert(1, ROOT)
    import numpy as np
    import torch
    import manisdp_tpu_torch
    from portbench.runner import STREAM_WARM, STREAM_WINDOW, Cell
    assert os.path.dirname(os.path.dirname(manisdp_tpu_torch.__file__)) \
        == tree, manisdp_tpu_torch.__file__
    params = dict(kv.split("=") for kv in args.params.split(",")) \
        if args.params else None
    cell = Cell(args.cell, traffic=params and {k: int(v) for k, v in
                                               params.items()})
    device = torch.device(args.device)
    entry = cell.entry()
    sync = (lambda: torch.cuda.synchronize(device)) \
        if device.type == "cuda" else (lambda: None)
    cell.solve(entry, cell.instances(args.seed, STREAM_WARM, 0)[:2], device)
    calls = []
    for k in (int(c) for c in args.calls.split(",")):
        inst = cell.instances(args.seed, STREAM_WINDOW, k)
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        sync()
        t0 = time.perf_counter()
        out = cell.solve(entry, inst, device)
        sync()
        wall = time.perf_counter() - t0
        rows = []
        for C, r in zip(inst, out):
            z = np.sum(r.Y * (C @ r.Y.T).T, axis=0)
            rows.append(dict(
                status=r.status, iterations=r.iterations,
                rtr_iters=r.rtr_iters, hess_calls=r.hess_calls,
                fac_size=r.fac_size, obj=float(r.obj).hex(),
                dinf=float(r.dinf).hex(),
                dinf_by_iter=[h["dinf"] for h in r.history],
                live=[h.get("live") for h in r.history],
                z_rel=float(np.max(np.abs(z - r.z)) /
                            (1 + np.max(np.abs(z))))))
        calls.append(dict(call=k, wall_s=wall, instances=rows,
                          peak_mem_gb=(torch.cuda.max_memory_allocated(
                              device) / 1e9 if device.type == "cuda"
                              else None),
                          timers=dict(out[0].timers)))
    print(json.dumps(dict(tree=args.tree, calls=calls)), flush=True)


def _summary(runs):
    """Per call: the instances on which every tree agrees bit for bit, and
    the uncertified instances' dinf by outer iteration, by tree."""
    out = []
    for c, call in enumerate(runs[0]["calls"]):
        same, held = [], {}
        for j, inst in enumerate(call["instances"]):
            key = lambda r: (r["status"], r["iterations"], r["obj"],  # noqa: E731
                             r["dinf"], r["dinf_by_iter"])
            if all(key(run["calls"][c]["instances"][j]) == key(inst)
                   for run in runs):
                same.append(j)
            if any(run["calls"][c]["instances"][j]["status"] != 0
                   for run in runs):
                held[j] = {run["tree"]: run["calls"][c]["instances"][j][
                    "dinf_by_iter"] for run in runs}
        out.append(dict(call=call["call"], bit_equal=same,
                        n=len(call["instances"]),
                        walls={f"{run['tree']}#{i}":
                               run["calls"][c]["wall_s"]
                               for i, run in enumerate(runs)},
                        uncertified=held))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trees", nargs="+", default=["."])
    ap.add_argument("--tree", help=argparse.SUPPRESS)
    ap.add_argument("--cell", default="maxcut.torus3k-b16-stall")
    ap.add_argument("--calls", default="4")
    ap.add_argument("--seed", type=int, default=3200002101)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--params", default="")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    if args.tree:
        return _one(args)
    runs = []
    for tree in args.trees:
        cmd = [sys.executable, os.path.abspath(__file__), "--tree", tree,
               "--cell", args.cell, "--calls", args.calls, "--seed",
               str(args.seed), "--device", args.device, "--params",
               args.params]
        res = subprocess.run(cmd, capture_output=True, text=True, cwd=ROOT)
        if res.returncode != 0:
            sys.stderr.write(res.stderr[-4000:])
            return res.returncode
        runs.append(json.loads(res.stdout.strip().splitlines()[-1]))
    summary = _summary(runs)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(dict(runs=runs, summary=summary), f)
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
