#!/usr/bin/env python3
"""Which certificate certifies matrix completion under ``mesh=``, on one
CUDA card.

    python3 tools/sharded_cert_study.py [--n2 2000] [--mc12000]
                                        [--max-outer 60]

Solves trace-min matrix completion (``frontends.workloads.matrix_completion``
with chip_smoke.py's construction; n = 2,000 by default, and with
``--mc12000`` chip_smoke.py's n = 12,000 instance) through ``solve_sdp``
with chip_smoke.py's mc options on the factored operator
(``al_op_mode="sparse"``), four ways: on
one card and sharded over a one-rank NCCL mesh (``make_mesh(1)``), each
with the default devrr certificate and with ``cert_method="lobpcg"`` (the
certificate the JAX package's sharded path always takes).  One JSON line
a solve: status, objective, outer iterations, the last outer iteration's
gap / pinf / dinf, seconds, the certificate's seconds; then the card's
name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n2", type=int, default=2000,
                    help="the small instance's n (= p + q of the "
                    "completion)")
    ap.add_argument("--mc12000", action="store_true")
    ap.add_argument("--max-outer", type=int, default=60)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("sharded_cert_study: no CUDA device; nothing was run",
              file=sys.stderr)
        return 1
    import chip_smoke as cs
    from manisdp_tpu_torch import solve_sdp
    from manisdp_tpu_torch.frontends.workloads import matrix_completion
    from manisdp_tpu_torch.ops.sparse import ConstraintOp
    from manisdp_tpu_torch.parallel.mesh import make_mesh

    device = torch.device("cuda", 0)
    mesh = make_mesh(1, "model", "cuda")
    half = args.n2 // 2
    specs = [dict(p=half, q=half, rank=10, m_samples=int(0.4 * half ** 2),
                  seed=3)]
    if args.mc12000:
        specs.append(cs.MC)
    for spec in specs:
        data, _ = matrix_completion(spec["p"], spec["q"], rank=spec["rank"],
                                    m_samples=spec["m_samples"],
                                    seed=spec["seed"])
        n = int(data.K.s)
        op = ConstraintOp.build(data.At, data.b, data.c, n, device)
        for sharded in (False, True):
            for cert in ("devrr", "lobpcg"):
                kw = dict(cs.mc_options(), cert_method=cert,
                          max_outer=args.max_outer, al_op_mode="sparse")
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                res = solve_sdp(op, None, None, n, device=device,
                                verbose=False,
                                **(dict(mesh=mesh) if sharded else {}), **kw)
                torch.cuda.synchronize()
                last = res.history[-1]
                print(json.dumps(dict(
                    n=n, m=op.m, sharded=sharded, cert_method=cert,
                    status=res.status, obj=res.obj,
                    iterations=res.iterations, gap=last["gap"],
                    pinf=last["pinf"], dinf=last["dinf"],
                    seconds=time.perf_counter() - t0,
                    cert_s=res.timers.get("cert"))), flush=True)
        del op, data
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
