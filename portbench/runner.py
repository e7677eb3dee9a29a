"""One run of one cell: set-up, the measured window, the traced readings,
the reference's judgement of the window's answers, and the result line.

The loop is closed: one caller sends solver calls back to back, each on
instances new to the run: the traffic mix's pool problems of that
call, in the seed's variant, made outside the timed part.  A call is
timed from entry to ``torch.cuda.synchronize()`` after it returns;
calls run until their summed time reaches ``--seconds``, the call in
flight finished and counted.
"""

from __future__ import annotations

import argparse
import gc
import importlib
import json
import statistics
import subprocess
import sys
import time
from types import SimpleNamespace

import numpy as np

from . import profile, registry

# top-level module names that no run may load (compared whole: the port's
# name begins with the JAX package's)
FORBIDDEN = ("jax", "jaxlib", "flax", "manisdp_tpu")
STREAM_WINDOW, STREAM_WARM, STREAM_TRACE, STREAM_SAMPLE = 0, 1, 2, 3
# the solver-result fields kept past a call besides the judged ones
KEPT = ("status", "eta", "hess_calls", "timers", "fac_size")


def forbidden_modules(modules=None) -> list:
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def instance_rng(seed: int, stream: int, call: int, j: int):
    """The generator of instance j of call ``call`` in ``stream``."""
    seed = int(seed)
    return np.random.default_rng(np.random.SeedSequence(
        [abs(seed), int(seed < 0), stream, call, j]))


def pool_rng(entropy: int, stream: int, call: int, j: int):
    """The generator of the pool's instance j of call ``call``: the same
    for every seed."""
    return np.random.default_rng(np.random.SeedSequence(
        [int(entropy), stream, call, j]))


class Cell:
    """A cell's configuration, traffic mix, generator and reference, found
    by name.  ``traffic`` overrides the mix's parameters (tests)."""

    def __init__(self, name: str, bench=None, traffic=None,
                 config=None):
        self.bench = registry.benchmark() if bench is None else bench
        self.name = name
        self.spec = registry.cell(self.bench, name)
        self.config = registry.config(self.bench, self.spec["config"])
        self.config.update(config or {})
        self.traffic = registry.traffic(self.spec["traffic"])
        self.traffic["params"] = dict(self.traffic["params"],
                                      **(traffic or {}))
        self.generator = registry.generator(self.traffic["generator"])
        self.reference = registry.reference(self.config["reference"])

    def instances(self, seed: int, stream: int, call: int) -> list:
        """The instances of call ``call`` of ``stream``: every seed gets the
        same problems, the pool's (drawn from the mix's ``pool_entropy``),
        each in the seed's variant (the generator's ``vary``).  The
        window's call k sends the pool's call ``first_call + k``."""
        per = int(self.traffic["instances_per_call"])
        if stream == STREAM_WINDOW:
            call += int(self.traffic["first_call"])
        pool = int(self.traffic["pool_entropy"])
        return [self.generator.vary(
                    self.generator.make(self.traffic["params"],
                                        pool_rng(pool, stream, call, j)),
                    instance_rng(seed, stream, call, j))
                for j in range(per)]

    def entry(self):
        """The solver entry the configuration names (dotted path)."""
        module, _, attr = self.config["entry"].rpartition(".")
        return getattr(importlib.import_module(module), attr)

    def solve(self, entry, instances, device) -> list:
        """One solver call on ``instances``: the whole list as a batch, or
        each instance's fields as the entry's arguments."""
        opts = dict(self.config["options"], device=device)
        if self.config["call"] == "batch":
            out = entry(list(instances), **opts)
        else:
            out = [entry(*inst, **opts) for inst in instances]
        return list(out) if isinstance(out, (list, tuple)) else [out]

    def certified(self, res) -> bool:
        return res.status == 0 and res.eta <= self.config["tol"]

    def slim(self, res):
        """The result's judged fields and counters (the rest is freed)."""
        keep = tuple(self.config["judged"]) + KEPT
        return SimpleNamespace(**{k: getattr(res, k, None) for k in keep})


class Record(SimpleNamespace):
    """One window call: seconds, instances, slimmed results."""


class Context:
    """What a per-layer metric reads: the cell, the window's calls, the
    traced profile and the device."""

    def __init__(self, cell, records, device, seed, setup_s=None,
                 peak_bytes=None, prof=None):
        self.cell, self.records, self.device = cell, records, device
        self.seed, self.profile = seed, prof
        self.setup_s, self.peak_bytes = setup_s, peak_bytes
        self.window_s = sum(r.seconds for r in records)

    def results(self):
        return [res for r in self.records for res in r.results]

    def certified(self):
        return [res for res in self.results() if self.cell.certified(res)]

    def timers(self):
        """Each call's phase timers once (a batch bucket's results share
        one dict)."""
        seen, out = set(), []
        for res in self.results():
            if res.timers is not None and id(res.timers) not in seen:
                seen.add(id(res.timers))
                out.append(res.timers)
        return out

    def last(self):
        return self.records[-1]


def _sync(device):
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_window(cell, entry, seed, seconds, device, stream=STREAM_WINDOW,
               calls=None, first=0):
    """Calls back to back until their summed time reaches ``seconds`` (or
    ``calls`` calls), the k-th on the instances of call ``first + k`` of
    ``stream``.  Returns the records."""
    records, total, k = [], 0.0, 0
    while (total < seconds) if calls is None else (k < calls):
        inst = cell.instances(seed, stream, first + k)
        _sync(device)
        t0 = time.perf_counter()
        out = cell.solve(entry, inst, device)
        _sync(device)
        dt = time.perf_counter() - t0
        records.append(Record(seconds=dt, instances=inst,
                              results=[cell.slim(r) for r in out]))
        total += dt
        k += 1
    return records


def judge(cell, records, seed, device):
    """The reference's numbers over a seeded sample of the window's
    certified answers, the share not certified and the answers missing:
    {name: value}."""
    ref = cell.reference
    pairs, missing, failed, attempted = [], 0, 0, 0
    for r in records:
        attempted += len(r.instances)
        missing += max(0, len(r.instances) - len(r.results))
        for inst, res in zip(r.instances, r.results):
            if cell.certified(res):
                pairs.append((inst, res))
            else:
                failed += 1
    failed += missing
    k = min(len(pairs), int(cell.config["check_sample"]))
    pick = np.random.default_rng(np.random.SeedSequence(
        [abs(int(seed)), int(seed < 0), STREAM_SAMPLE])).choice(
            len(pairs), size=k, replace=False) if k else []
    readings = [ref.judge(*pairs[i], device) for i in sorted(pick)]
    for i, rd in zip(sorted(pick), readings):
        # read, not compared: how far the reference's eta lies above the
        # program's own on the same answer
        rd["eta_over_program"] = rd["eta"] - float(pairs[i][1].eta)
    numbers = {name: (max(rd[key] for rd in readings) if readings else None)
               for name, key in ref.NUMBERS.items()}
    numbers["uncertified_share"] = failed / max(attempted, 1)
    numbers["missing"] = missing
    worst = {key: max(rd[key] for rd in readings)
             for key in (readings[0] if readings else {})}
    return numbers, attempted, failed, worst


def verdict(numbers: dict, limits: dict):
    """(correct, checks): each number beside its limit; a number with no
    reading (no certified answer to judge) is left to the share."""
    checks = {name: dict(value=v, limit=limits[name])
              for name, v in numbers.items()}
    ok = all(c["value"] is None or c["value"] <= c["limit"]
             for c in checks.values())
    return ok, checks


def power_limit():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20, check=False).stdout.strip().splitlines()
        return out[0] if out else None
    except (OSError, subprocess.SubprocessError):
        return None


def read_metrics(ctx, kind: str) -> dict:
    """The cell's ``kind`` metrics, each from its reader; a reader that
    finds nothing to read returns None and its metric is left out."""
    out = {}
    for m in registry.cell_metrics(ctx.cell.bench, ctx.cell.name, kind):
        value = registry.metric(m["name"]).read(ctx)
        if value is not None:
            out[m["name"]] = dict(value=float(value), unit=m["unit"])
    return out


def traced_readings(cell, entry, seed, device, records, log):
    """The per-layer metrics, and three whole calls on the same instances
    after the window: one plain (its wall is the call's own), one under
    the profiler with device activity only (the device's busy time, the
    time by kernel kind) and one with the host's ops traced too (the idle
    gaps by what the host was doing)."""
    one = lambda: run_window(cell, entry, seed, 0.0, device,  # noqa: E731
                             stream=STREAM_TRACE, calls=1)
    plain = one()[0].seconds
    busy = profile.trace_calls(one, with_host=False)
    host = profile.trace_calls(one, with_host=True)
    busy["plain_wall_s"] = plain
    metrics = read_metrics(Context(cell, records, device, seed, prof=busy),
                           "per_layer")
    calls = [r.seconds for r in records]
    info = dict(plain_wall_s=plain, profiled_wall_s=busy["wall_s"],
                host_traced_wall_s=host["wall_s"], busy_s=busy["busy_s"],
                window_median_call_s=statistics.median(calls),
                device_events=busy["device_events"])
    log(f"trace: {json.dumps(info)}")
    breakdown = dict(device_ops=profile.top(busy["by_kind"]),
                     idle_gaps=profile.top(host.get("idle_by_host_op", {})))
    return metrics, busy, breakdown, info


def run(cell_name, seed, seconds, trace, device=None, t_start=None,
        log=None, cell=None, host_threads=None):
    """One run; returns the result line's object.  ``device`` None: the
    first CUDA card, and a run without one raises."""
    t_start = time.perf_counter() if t_start is None else t_start
    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    split = {}
    t = time.perf_counter()
    import torch
    if host_threads:
        torch.set_num_threads(host_threads)
    cell = Cell(cell_name) if cell is None else cell
    chips = int(cell.spec["chips"])
    if device is None:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if found < chips:
            raise SystemExit(f"{cell_name} needs {chips} CUDA card(s), "
                             f"{found} found: the benchmark runs only on "
                             "cards")
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
    device = torch.device(device)
    entry = cell.entry()
    split["import_s"] = time.perf_counter() - t
    t = time.perf_counter()
    if device.type == "cuda":
        build = getattr(importlib.import_module(
            cell.config["kernels"]), "build", None)
        if build is not None:
            build()
        torch.zeros(1, device=device)
    split["kernels_s"] = time.perf_counter() - t
    t = time.perf_counter()
    warm = cell.instances(seed, STREAM_WARM, 0)
    split["instances_s"] = time.perf_counter() - t
    t = time.perf_counter()
    _sync(device)
    cell.solve(entry, warm, device)
    _sync(device)
    split["warm_call_s"] = time.perf_counter() - t
    del warm
    gc.collect()
    setup_s = time.perf_counter() - t_start
    log(f"setup: {setup_s:.3f} s {json.dumps(split)}")

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    records = run_window(cell, entry, seed, seconds, device)
    peak = torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0
    window_s = sum(r.seconds for r in records)
    log("calls_s: " + json.dumps([r.seconds for r in records]))

    dev = dict(platform="gpu" if device.type == "cuda" else device.type,
               kind=torch.cuda.get_device_name(device)
               if device.type == "cuda" else "cpu",
               count=chips, memory_peak_bytes=int(peak))
    traced = {}
    if trace:
        metrics, busy, breakdown, info = traced_readings(
            cell, entry, seed, device, records, log)
        dev.update(busy_s=busy["busy_s"], window_s=busy["wall_s"])
        traced = dict(breakdown=breakdown, trace_info=info)
    if device.type == "cuda":
        dev["power_limit"] = power_limit()
        torch.cuda.empty_cache()
    gc.collect()

    t = time.perf_counter()
    numbers, attempted, failed, worst = judge(cell, records, seed, device)
    reference_s = time.perf_counter() - t
    log(f"reference: {reference_s:.3f} s, worst readings {json.dumps(worst)}")
    if not trace:
        metrics = read_metrics(Context(cell, records, device, seed,
                                       setup_s=setup_s, peak_bytes=peak),
                               "end_to_end")
    correct, checks = verdict(numbers, cell.config["limits"])
    # the driver's keys, what it ignores, then the numbers compared last
    return dict(correct=correct, attempted=attempted, failed=failed,
                metrics=metrics, device=dev, **traced,
                window=dict(calls=len(records), seconds=window_s,
                            setup_split=split, setup_s=setup_s,
                            reference_s=reference_s, worst_readings=worst),
                checks=checks)


def main(argv=None, t_start=None, host_threads=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    out = run(args.workload, args.seed, args.seconds, bool(args.trace),
              t_start=t_start, host_threads=host_threads)
    bad = forbidden_modules()
    if bad:
        print(f"forbidden modules loaded: {bad}", file=sys.stderr)
        return 4
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0
