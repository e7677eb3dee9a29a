"""Device busy time, device time by kernel kind, and the idle gaps by what
the host was doing, from one torch.profiler trace of whole solver calls.

``KINDS`` is a frozen copy of the kernel kinds of chip_smoke.py's
``profile_breakdown`` (chip_smoke.py:1556-1612), the table PERF.md's
earlier busy shares were read with.  Busy time here is the union of the
device events' intervals (kernels, copies, sets), not their sum, so
overlapping work is counted once.
"""

from __future__ import annotations

import heapq
import time

KINDS = (("K1 symcoo_spmm", ("symcoo_spmm_kernel", "spmm_nmajor")),
         ("K9 symmom_apply", ("mom_stage", "mom_sym<", "mom_rows")),
         ("K10 symmom_adjoint", ("namespace)::coef_kernel",
                                 "namespace)::out_kernel")),
         ("K7 symdual_apply", ("symdual_stage", "symdual_sym<",
                               "symdual_y4")),
         ("K8 symdual_adjoint", ("adjoint_kernel", "sym_factor_kernel",
                                 "sym_mat_pair_kernel",
                                 "sym_mat_tile_kernel")),
         ("K2 oblique_cols", ("oblique_cols", "oblique_tiles")),
         ("K11 tcg_step", ("tcg_",)),
         ("K4 csr_gather", ("csr_gather",)),
         ("K6 oa_refine", ("oa_refine",)),
         ("GEMM (cuBLAS)", ("gemm", "gemv", "sm90_xmma", "cutlass",
                            "Kernel2", "dot_kernel")),
         ("cuSOLVER", ("syevd", "syevj", "sytrd", "ormtr", "orgtr",
                       "steqr", "stedc", "potrf", "cusolver", "lansy",
                       "larf", "geqrf")),
         ("memcpy / memset", ("Memcpy", "Memset", "memcpy", "memset")),
         ("NCCL collectives", ("nccl",)),
         ("reductions", ("reduce", "Reduce")),
         ("indexing / copies", ("index", "Index", "gather", "scatter",
                                "copy", "cat", "Cat", "tril", "triu")),
         ("elementwise", ("elementwise", "Elementwise", "vectorized",
                          "unrolled")))
# idle stretches shorter than this are launch latency, not host work
MIN_GAP_US = 5.0
NO_OP = "python (no torch op)"


def kind_of(name: str) -> str:
    return next((k for k, keys in KINDS if any(key in name for key in keys)),
                "other")


def union_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def gaps(intervals, start: float, end: float, min_len: float = MIN_GAP_US):
    """The stretches of [start, end] no interval covers, at least
    ``min_len`` long."""
    out, cur = [], start
    for s, e in sorted(intervals):
        if s - cur >= min_len:
            out.append((cur, s))
        cur = max(cur, e)
    if end - cur >= min_len:
        out.append((cur, end))
    return out


def attribute(gap_list, host_events):
    """Seconds of idle device time by the innermost host event that covers
    each gap's midpoint (``host_events``: (start, end, name)); a gap no
    host event covers is Python between torch calls."""
    events = sorted(host_events)
    active, i, out = [], 0, {}
    for g0, g1 in sorted(gap_list, key=lambda g: g[0] + g[1]):
        mid = 0.5 * (g0 + g1)
        while i < len(events) and events[i][0] <= mid:
            s, e, name = events[i]
            heapq.heappush(active, (e - s, e, i, name))
            i += 1
        while active and active[0][1] < mid:
            heapq.heappop(active)
        name = active[0][3] if active else NO_OP
        out[name] = out.get(name, 0.0) + (g1 - g0) / 1e6
    return out


def top(d: dict, k: int = 10):
    return [[name, s] for name, s in
            sorted(d.items(), key=lambda kv: kv[1], reverse=True)[:k]]


def trace_calls(run, with_host: bool) -> dict:
    """Run ``run()`` (whole solver calls, ending in a synchronize) under
    torch.profiler.  Device activity always; with ``with_host`` the host's
    ops too, for the idle gaps (the host tracing slows the calls: the
    busy share is taken from a run without it).  Returns wall_s, busy_s,
    by_kind {kind: s} and, with the host, idle_by_host_op {op: s}."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CUDA]
    if with_host:
        acts.append(ProfilerActivity.CPU)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=acts) as prof:
        run()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    dev, host, by_kind = [], [], {}
    for evt in prof.events():
        tr = evt.time_range
        if evt.device_type == DeviceType.CUDA:
            dev.append((tr.start, tr.end))
            kind = kind_of(evt.name)
            by_kind[kind] = by_kind.get(kind, 0.0) + (tr.end - tr.start) / 1e6
        elif with_host and tr.end > tr.start:
            host.append((tr.start, tr.end, evt.name))
    out = dict(wall_s=wall, busy_s=union_us(dev) / 1e6, by_kind=by_kind,
               device_events=len(dev))
    if with_host and dev:
        t_lo = min([s for s, _ in dev] + [s for s, _, _ in host])
        t_hi = max([e for _, e in dev] + [e for _, e, _ in host])
        out["idle_by_host_op"] = attribute(gaps(dev, t_lo, t_hi), host)
    return out
