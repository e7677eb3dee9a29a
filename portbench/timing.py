"""The yardstick of the kernel roofline metrics: CUDA-event timing of one
call and the least time the card could take for it.

Frozen copies of chip_smoke.py's ``time_ms`` (chip_smoke.py:354-375),
``bound`` (:434-439) and the peaks ``PEAK_BYTES`` / ``PEAK_FLOPS``
(:300-301), the method PERF.md's table of kernels was made with.  The
benchmark reads these copies and never chip_smoke.py, so an edit there
cannot move a roofline here.
"""

from __future__ import annotations

import statistics

# NVIDIA H100 SXM data sheet: HBM3 bytes/s, and FLOP/s outside the tensor
# cores (the port's kernels use none): f64 34 T, f32 67 T
PEAK_BYTES = 3.35e12
PEAK_FLOPS = {"float64": 34e12, "float32": 67e12}


def time_ms(fn, reps: int = 25, warm: int = 3) -> float:
    """Median device milliseconds of one call of ``fn``, from CUDA events
    around it.  A spin kernel holds the stream while the host enqueues the
    call, so its launches run back to back and the events time the device
    work rather than the host's launch overhead."""
    import torch
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)        # ~1 ms at H100 clocks
        a.record()
        fn()
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b))
    return statistics.median(ts)


def bound_ms(bytes_: float, flops: float, dtype: str) -> float:
    """The least time (ms) the card could take: the larger of the bytes at
    the HBM rate and the operations at the dtype's peak."""
    return max(bytes_ / PEAK_BYTES, flops / PEAK_FLOPS[dtype]) * 1e3


def roofline_pct(fn, bytes_: float, flops: float, dtype: str) -> float:
    """100 x the least time over the measured time of one call."""
    return 100.0 * bound_ms(bytes_, flops, dtype) / time_ms(fn)
