"""The readings the limits of ``correct`` are set from, for one cell, over
several seeds in one process:

- the program: the window's solver calls on the cell's own traffic
  (``--calls`` a seed), judged by the reference as a run judges them
  (the lower readings);
- the control, the nearest precision below the configuration's float64:
  (a) every answer of the same calls rounded to float32, the best answer
  a float32 computation can hold, and (b) for a configuration whose
  reference has a plain solver, that solver in float32 (TF32 off) on the
  same instances (the upper readings).

    python3 portbench/control.py --workload <cell> --seeds 1,2,3 \
        [--calls 1] [--plain-iters 3000] [--out FILE]

Each seed prints one JSON line: every number with its limit, for the
program and for each control, and whether each comes out correct.  The
benchmark's runs do not run this.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def transformed(records, fn):
    """The records with every result replaced by ``fn(result)``."""
    from portbench.runner import Record
    return [Record(seconds=r.seconds, instances=r.instances,
                   results=[fn(x) for x in r.results]) for r in records]


def plain_records(cell, records, iters, seed, device):
    """The reference's plain solver in float32 in the program's place, on
    the same instances, or None where the reference has none."""
    import torch
    solve = getattr(cell.reference, "solve_plain", None)
    if solve is None or iters <= 0:
        return None
    p = int(cell.config["options"]["p0"])
    from portbench.runner import Record
    return [Record(seconds=0.0, instances=r.instances,
                   results=solve(r.instances, p, torch.float32, iters,
                                 seed, device)) for r in records]


def seed_readings(cell, entry, seed, calls, iters, device):
    """{kind: {"numbers": ..., "correct": ...}} for one seed."""
    from portbench import runner
    limits = cell.config["limits"]
    records = runner.run_window(cell, entry, seed, 0.0, device, calls=calls)
    kinds = {"program": records,
             "control_f32_rounded": transformed(
                 records, cell.reference.rounded_f32)}
    plain = plain_records(cell, records, iters, seed, device)
    if plain is not None:
        kinds["control_plain_f32"] = plain
    out = {}
    for kind, recs in kinds.items():
        numbers, attempted, failed, worst = runner.judge(cell, recs, seed,
                                                         device)
        ok, _ = runner.verdict(numbers, limits)
        out[kind] = dict(numbers=numbers, correct=ok, worst=worst,
                         attempted=attempted, failed=failed)
    out["call_s"] = [r.seconds for r in records]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True,
                    help="comma-separated whole numbers")
    ap.add_argument("--calls", type=int, default=1)
    ap.add_argument("--plain-iters", type=int, default=3000)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    import torch
    from portbench import runner
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    cell = runner.Cell(args.workload)
    entry = cell.entry()
    warm = cell.instances(0, runner.STREAM_WARM, 0)
    cell.solve(entry, warm, device)
    lines = []
    for seed in (int(s) for s in args.seeds.split(",")):
        res = dict(workload=args.workload, seed=seed,
                   **seed_readings(cell, entry, seed, args.calls,
                                   args.plain_iters, device))
        line = json.dumps(res)
        print(line, flush=True)
        lines.append(line)
    if args.out:
        with open(args.out, "a") as fh:
            fh.write("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
