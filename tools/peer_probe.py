"""The round trip of one flag between two ranks through memory mapped
with CUDA IPC (csrc/peer_probe.cu), the mechanism of K11's peer mode.

Cases (``--cases``):
  a  two ranks on two cards (NCCL group, rank r on cuda:r), needs two
     cards; the cards' peer access is printed beside it;
  b  two processes on card 0 (gloo group).  CUDA IPC maps memory between
     processes on one card, but without MPS their contexts take turns on
     it: a flag may wait a time slice, or never meet within the time-out.

Each rank allocates a 4 KB buffer, the ranks exchange their IPC handles
through the port's ``parallel.distributed.all_gather`` and open the
other's.  Then, ``--repeats`` times: one launch of a single thread
running ``--iters`` round trips (rank 0 stores i in the other's flag and
waits for the echo; ns per round trip from the device's %globaltimer,
the first round trip, which waits for the other's launch, left out;
how many were done before the time-out), and
``--launches`` launches that each meet the other rank at one flag
barrier (ms per launch from CUDA events around them: launch, stores and
the wait together).  A wait gives up after ``--timeout`` seconds and the
probe reports how far it got; ``met`` says the two ranks met at every
barrier and in the round trips (however slowly).

    python3 tools/peer_probe.py --cases b           # one card
    python3 tools/peer_probe.py --cases a,b --out build/peer_probe.json
                                                    # two cards or more

Prints one JSON object per case, then the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "manisdp_tpu_torch", "csrc", "peer_probe.cu")
OUT_DIR = os.path.join(ROOT, "build", "peer_probe")


def build() -> str:
    """nvcc the probe into build/peer_probe/ (a plain C library)."""
    os.makedirs(OUT_DIR, exist_ok=True)
    lib = os.path.join(OUT_DIR, "libpeer_probe.so")
    nvcc = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
           "-O3", "-Xcompiler", "-fPIC", "-shared", "-o", lib, SRC]
    subprocess.run(cmd, check=True)
    return lib


def _load(path):
    P, I, U = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint64
    lib = ctypes.CDLL(path)
    for name, args in (("probe_alloc", (P, P)), ("probe_open", (P, P)),
                       ("probe_close", (P,)), ("probe_free", (P,)),
                       ("probe_pingpong", (P, P, I, I, U, U, P)),
                       ("probe_barrier", (P, P, U, U, P)),
                       ("probe_results", (P, P))):
        fn = getattr(lib, name)
        fn.argtypes = list(args)
        fn.restype = ctypes.c_int
    return lib


def _ok(err, what):
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


def probe_rank(path, iters, launches, repeats, timeout_s):
    """One rank of a case: map the other rank's buffer, then time the
    round trips and the barrier launches."""
    import torch
    import torch.distributed as dist
    sys.path.insert(0, ROOT)
    from manisdp_tpu_torch.parallel.distributed import all_gather
    lib = _load(path)
    me, device = dist.get_rank(), torch.device(
        "cuda", torch.cuda.current_device())
    mine, peer = ctypes.c_void_p(), ctypes.c_void_p()
    handle = (ctypes.c_uint8 * 64)()
    _ok(lib.probe_alloc(ctypes.byref(mine), handle), "probe_alloc")
    hs = all_gather(torch.tensor(list(handle), dtype=torch.uint8,
                                 device=device)[:, None]).T.cpu()
    other = (ctypes.c_uint8 * 64)(*hs[1 - me].tolist())
    _ok(lib.probe_open(other, ctypes.byref(peer)), "probe_open")
    stream = torch.cuda.current_stream().cuda_stream
    timeout_ns = int(timeout_s * 1e9)
    res = (ctypes.c_uint64 * 4)()
    out = dict(rank=me, device=str(device), round_trip_us=[], done=[],
               barrier_ms=[], barriers_met=[])
    epoch = 0
    for rep in range(repeats):
        dist.barrier()
        _ok(lib.probe_pingpong(mine, peer, me, iters, rep * (iters + 1),
                               timeout_ns, stream), "pingpong")
        torch.cuda.synchronize()
        _ok(lib.probe_results(mine, res), "probe_results")
        done, ns = res[0], res[1]
        out["done"].append(done)
        out["round_trip_us"].append(ns / 1e3 / (done - 1) if done > 1
                                    else None)
        dist.barrier()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        met = 0
        a.record()
        for _ in range(launches):
            epoch += 1
            _ok(lib.probe_barrier(mine, peer, epoch, timeout_ns, stream),
                "barrier")
        b.record()
        torch.cuda.synchronize()
        _ok(lib.probe_results(mine, res), "probe_results")
        met = res[2]
        out["barrier_ms"].append(a.elapsed_time(b) / launches)
        out["barriers_met"].append(bool(met))
        if not met:
            break
    dist.barrier()
    _ok(lib.probe_close(peer), "probe_close")
    dist.barrier()
    _ok(lib.probe_free(mine), "probe_free")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cases", default="a,b")
    ap.add_argument("--iters", type=int, default=2000)
    ap.add_argument("--launches", type=int, default=200)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--timeout", type=float, default=2.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("peer_probe: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from manisdp_tpu_torch.parallel import spawn_ranks
    t0 = time.perf_counter()
    path = build()
    rec = dict(build_s=time.perf_counter() - t0, cases={})
    cards = torch.cuda.device_count()
    for case in args.cases.split(","):
        if case == "a" and cards < 2:
            rec["cases"]["a"] = dict(run=False, reason=f"{cards} card")
            print(json.dumps(dict(case="a", **rec["cases"]["a"])),
                  flush=True)
            continue
        backend, dev = ("nccl", "cuda") if case == "a" else ("gloo",
                                                             "cuda:0")
        t0 = time.perf_counter()
        ranks = spawn_ranks(probe_rank, 2, backend, dev,
                            args=(path, args.iters, args.launches,
                                  args.repeats, args.timeout))
        r0 = ranks[0]
        rts = [v for v in r0["round_trip_us"] if v is not None]
        c = dict(case=case, backend=backend, ranks_on=[r["device"]
                                                       for r in ranks],
                 iters=args.iters, launches=args.launches,
                 round_trip_us_median=statistics.median(rts) if rts
                 else None,
                 barrier_ms_median=[statistics.median(r["barrier_ms"])
                                    for r in ranks],
                 met=all(all(r["barriers_met"]) and
                         all(d > 1 for d in r["done"]) for r in ranks),
                 round_trips_done=[r["done"] for r in ranks],
                 call_s=time.perf_counter() - t0, ranks=ranks)
        if case == "a":
            c["peer_access"] = torch.cuda.can_device_access_peer(0, 1)
        rec["cases"][case] = c
        print(json.dumps(c), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    rec["nvidia_smi"] = smi
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(rec, f, indent=1)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
