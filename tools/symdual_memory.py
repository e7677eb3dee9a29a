#!/usr/bin/env python3
"""Peak device memory of the expanded-basis SOS-dual operator at large q,
on one CUDA card.

    python3 tools/symdual_memory.py [--q 80 100 130] [--seed 0]

For each q: ``SymDualOp.build_bqpsos`` of a seeded BQP instance (bench.py's
stand-in construction), then one ``apply`` (kernel K7) of a random
symmetric (n~, n~) matrix and one ``adjoint`` (kernel K8) of its result,
in float64; ``torch.cuda.max_memory_allocated()`` after each step, the
peak counted from a reset before the build.  No solve.  One JSON line per
q, then the card's name and power limit.  This sizes the sharded q^4
operator (``ShardedSymDualOp``, the JAX package's
parallel/symdual_sharded.py): every q^4 tensor is (q^4 * 8) bytes.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def measure(q: int, seed: int, device) -> dict:
    import torch
    from manisdp_tpu_torch.ops.symdual import SymDualOp
    rng = np.random.default_rng(seed)
    Q = rng.standard_normal((q, q))
    Q = (Q + Q.T) / 2
    e = rng.standard_normal(q)
    gb = lambda: torch.cuda.max_memory_allocated() / 1e9  # noqa: E731
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated() / 1e9
    t0 = time.perf_counter()
    op = SymDualOp.build_bqpsos(Q, e, q, device=device)
    torch.cuda.synchronize()
    out = dict(q=q, n_tilde=op.n, m_flat=op.m, m_true=op.m_true,
               q4_tensor_gb=q ** 4 * 8 / 1e9, build_s=time.perf_counter() - t0,
               peak_build_gb=gb() - base)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    M = torch.randn((op.n, op.n), generator=gen, dtype=torch.float64,
                    device=device)
    M = M + M.T
    t0 = time.perf_counter()
    y = op.apply(M)
    torch.cuda.synchronize()
    out.update(apply_s=time.perf_counter() - t0, peak_apply_gb=gb() - base)
    t0 = time.perf_counter()
    W = op.adjoint(y)
    torch.cuda.synchronize()
    out.update(adjoint_s=time.perf_counter() - t0,
               peak_adjoint_gb=gb() - base,
               finite=bool(torch.isfinite(W).all() and
                           all(torch.isfinite(t).all() for t in y)))
    del op, M, y, W
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--q", type=int, nargs="+", default=[80, 100, 130])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("symdual_memory: no CUDA device; nothing was run",
              file=sys.stderr)
        return 1
    torch.cuda.set_device(0)
    device = torch.device("cuda", 0)
    torch.zeros(1, device=device)     # the allocator's stats exist from here
    ok = True
    for q in args.q:
        row = measure(q, args.seed, device)
        ok &= row["finite"]
        print(json.dumps(row), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0], flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
