"""The per-call span recorder of the solver drivers.

A public solver entry is wrapped in :func:`recorded`: its call gets one
:class:`PhaseTimers`, made at entry and current for the call through a
context variable, so an entry that hands down to another
(``solve_bqp_sos_dual`` -> ``solve_dual_al``) and the RTR
(core/trustregions.py, through :func:`span`) add to the same recorder,
and a thread keeps its own.  The recorder sums each span's seconds under
its name in ``timers.t`` (``SDPResult.timers``).  A name without a dot
is top level, and the top-level spans of a call follow one another from
entry to return: ``operator``, then per outer iteration ``rtr``,
``stats``, ``cert`` and ``rank``, then ``result``.  A dotted name lies
inside the span its prefix names (``rtr.wait``: the host blocked on a
read of a device value inside the RTR).  ``SDPResult.time`` is the
recorder's wall from entry to return.

While torch.profiler records, each span is also a profiler range
``manisdp.<name>`` and the whole call ``manisdp.call``, on the clock of
the device events, so a trace can put the device's idle gaps down to the
phase the host was in.  The ranges are ``_RecordFunctionFast`` host
ranges: ``record_function``'s user ranges are mirrored onto the device
timeline as well (``gpu_user_annotation`` events with the device's type),
where they would cover the very idle gaps they are meant to name.  With
the profiler off no range is made: a span costs two ``perf_counter``
reads and a dict add.
"""

from __future__ import annotations

import contextlib
import contextvars
import functools
import time
from typing import Optional

import torch

PREFIX = "manisdp."
_CURRENT: contextvars.ContextVar = contextvars.ContextVar(
    "manisdp_timers", default=None)
# a span outside any recorded call
_NO_SPAN = contextlib.nullcontext()


def _range(name: str):
    """An open profiler range ``manisdp.<name>`` while torch.profiler
    records, else None."""
    if not torch.autograd.profiler._is_profiler_enabled:
        return None
    rf = torch._C._profiler._RecordFunctionFast(PREFIX + name)
    rf.__enter__()
    return rf


class _Span:
    __slots__ = ("timers", "name", "rf", "t0")

    def __init__(self, timers: "PhaseTimers", name: str):
        self.timers, self.name = timers, name

    def __enter__(self):
        self.rf = _range(self.name)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.timers.add(self.name, time.perf_counter() - self.t0)
        if self.rf is not None:
            self.rf.__exit__(*exc)
        return False


class PhaseTimers:
    """Seconds per span of one solver call, on ``time.perf_counter``.
    Each top-level phase of the outer loop ends on a host read of a device
    value, so its time covers the device work it queued."""

    def __init__(self):
        self.t = {}
        self._snap = {}
        self.t0 = time.perf_counter()

    def add(self, phase: str, dt: float):
        self.t[phase] = self.t.get(phase, 0.0) + dt

    def wall(self) -> float:
        """Seconds since the call's entry."""
        return time.perf_counter() - self.t0

    def log_delta(self, verbose):
        """verbose == 2: print per-phase seconds since the last call."""
        if verbose != 2:
            return
        d = {k: v - self._snap.get(k, 0.0) for k, v in self.t.items()}
        self._snap = dict(self.t)
        print("  phases: " + ", ".join(f"{k}:{v:.2f}s"
                                       for k, v in d.items()), flush=True)

    def timed(self, phase: str):
        return _Span(self, phase)


def current() -> Optional[PhaseTimers]:
    """The recorder of the solver call in progress, or None."""
    return _CURRENT.get()


def span(name: str):
    """A span of the current call's recorder; outside a recorded call a
    no-op."""
    timers = _CURRENT.get()
    return _NO_SPAN if timers is None else _Span(timers, name)


def recorded(entry):
    """Wrap a public solver entry: the outermost recorded call makes the
    recorder (an entry called inside another's call adds to the caller's)
    and sets ``time`` on the returned SDPResult (or on each of a list) to
    the call's wall."""

    @functools.wraps(entry)
    def call(*args, **kwargs):
        if _CURRENT.get() is not None:
            return entry(*args, **kwargs)
        timers = PhaseTimers()
        token = _CURRENT.set(timers)
        rf = _range("call")
        try:
            out = entry(*args, **kwargs)
        finally:
            if rf is not None:
                rf.__exit__(None, None, None)
            _CURRENT.reset(token)
        wall = timers.wall()
        for res in (out if isinstance(out, list) else [out]):
            if hasattr(res, "time"):
                res.time = wall
        return out

    return call
