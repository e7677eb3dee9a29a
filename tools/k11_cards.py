"""K11's two sharded modes across cards, tree against tree: the peer mode
(one launch a step, the sums over ranks on the device) and the split
mode (three launches around two NCCL all-reduces) at the G67-size dense
MaxCut's tCG shape on a rank, (1, 40, 10,000 / D), f64, with the
tangent projection, as ``sharded_maxcut_solve`` runs it.

For each tree of ``--trees`` (in the order given, so "A B B A" runs in
turns on the same cards), a process run from that tree builds its
kernels and spawns D NCCL ranks (one a card, ``--world``, default every
card up to 4); each rank runs ``chip_smoke.k11_modes`` of that tree: both
modes against their twins and each other, each timed one call at a time,
in a chain of 50 steps at the host's pace and at the device's (behind a
spin), with the split mode's two all-reduces alone.  Every output's hash
goes beside the times, so trees can be compared bit for bit.

    git archive <parent> | (mkdir -p build/parent && tar -x -C build/parent)
    python3 tools/k11_cards.py --trees build/parent . . build/parent \\
        --out build/k11_cards.json          # on a host with 2-4 cards

Prints one JSON object per tree run, then a summary (per tree and mode,
the ranks' median device-chain ms and whether every run's outputs had
the same bits) and the cards' name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, P, SEED = 10_000, 40, 25


def rank_job(tree):
    """One rank: chip_smoke.k11_modes of ``tree`` on this rank's columns of
    a seeded (P, N) Oblique.rand factor."""
    import torch
    import torch.distributed as dist
    sys.path.insert(0, tree)
    import chip_smoke as cs
    from manisdp_tpu_torch.manifolds import Oblique
    from manisdp_tpu_torch.parallel.mesh import (make_mesh, mesh_axis,
                                                 model_cols)
    world, rank = dist.get_world_size(), dist.get_rank()
    device = torch.device("cuda", torch.cuda.current_device())
    group = mesh_axis(make_mesh(world, "model", "cuda"), "model")[2]
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED)
    Y = Oblique.rand(gen, P, N)
    Yl = Y[:, model_cols(N, world, rank)].contiguous()
    out = cs.k11_modes(Yl, group, gen, Oblique.typicaldist(P, N), True)
    out["rank"] = rank
    return out


def run_tree(world):
    """In a tree's own process: build, spawn, print the ranks' results."""
    from manisdp_tpu_torch.kernels.build import build
    from manisdp_tpu_torch.parallel import spawn_ranks
    build()
    ranks = spawn_ranks(rank_job, world, "nccl", "cuda",
                        args=(os.getcwd(),))
    print(json.dumps(dict(tree=os.getcwd(), world=world, ranks=ranks)))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trees", nargs="+", default=["."])
    ap.add_argument("--world", type=int, default=None)
    ap.add_argument("--out", default=None)
    ap.add_argument("--run-here", action="store_true",
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("k11_cards: no CUDA device", file=sys.stderr)
        return 1
    world = args.world or min(4, torch.cuda.device_count())
    if args.run_here:
        sys.path.insert(0, os.getcwd())
        run_tree(world)
        return 0
    if world < 2:
        print(f"k11_cards: {world} card; the modes differ only across "
              "cards", file=sys.stderr)
        return 1
    runs = []
    for tree in args.trees:
        tree = os.path.abspath(tree)
        proc = subprocess.run(
            [sys.executable, os.path.join(ROOT, "tools", "k11_cards.py"),
             "--run-here", "--world", str(world)], cwd=tree,
            capture_output=True, text=True)
        if proc.returncode != 0:
            print(proc.stdout[-3000:], proc.stderr[-3000:], file=sys.stderr)
            return proc.returncode
        rec = json.loads(proc.stdout.strip().splitlines()[-1])
        runs.append(rec)
        print(json.dumps(rec), flush=True)
    summary = {}
    for rec in runs:
        for mode in ("split", "peer"):
            s = summary.setdefault(rec["tree"], {}).setdefault(
                mode, dict(chain_ms=[], host_chain_ms=[], digests=set()))
            s["chain_ms"].append(statistics.median(
                r[mode]["chain_ms"] for r in rec["ranks"]))
            s["host_chain_ms"].append(statistics.median(
                r[mode]["host_chain_ms"] for r in rec["ranks"]))
            s["digests"].add(tuple(r[mode]["digest"] for r in rec["ranks"]))
    for modes in summary.values():
        for s in modes.values():
            s["same_bits"] = len(s.pop("digests")) == 1
    trees = list(summary)
    same = all(len({tuple(r[m]["digest"] for r in rec["ranks"])
                    for rec in runs}) == 1 for m in ("split", "peer"))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    out = dict(summary=summary, trees=trees, same_bits_across_trees=same,
               nvidia_smi=smi)
    print(json.dumps(out), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(dict(out, runs=runs), f, indent=1)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
