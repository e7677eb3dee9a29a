"""The port's per-call span recorder (utils/timers.py) on the CPU: a
4-instance batched MaxCut with one dense and one sparse bucket, a small
BQP SOS dual and the same size's BQP moment primal.  Each call's
top-level spans cover it from entry to return, the RTR's waits on the
device nest inside ``rtr`` and the dense certificate's tiers inside
``cert``, the spans are profiler ranges only while torch.profiler
records, and recording changes no bit of the answer."""

import threading
import time

import numpy as np
import pytest
import scipy.sparse as sp
import threadpoolctl
import torch
from torch.profiler import ProfilerActivity, profile

from manisdp_tpu_torch import solve_maxcut_batch
from manisdp_tpu_torch.solvers.dual_unitdiag import solve_bqp_sos_dual
from manisdp_tpu_torch.solvers.primal_mom import solve_bqp_mom
from manisdp_tpu_torch.utils import timers as T


@pytest.fixture(autouse=True, scope="module")
def _one_cpu_thread():
    """One torch / BLAS thread: the parallel test run shares the CPU, and
    the bit-equality below compares two runs on the same thread count."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpoolctl.threadpool_limits(1):
        yield
    torch.set_num_threads(n)


def _ring_cost(n, seed):
    """-L/4 of a ring with random positive weights (2n entries)."""
    w = np.random.RandomState(seed).uniform(0.5, 1.5, n)
    i = np.arange(n)
    W = sp.coo_matrix((w, (i, (i + 1) % n)), shape=(n, n))
    W = W + W.T
    L = sp.diags(np.asarray(W.sum(axis=1)).ravel()) - W
    return (-L / 4).tocoo()


def _dense_cost(n, seed):
    B = np.random.RandomState(seed).randn(n, n)
    C = 0.5 * (B + B.T)
    np.fill_diagonal(C, 0.0)
    return C


def _batch():
    # bucket 32 (n <= dense_cost_max_n) is dense; bucket 64 sparse, since
    # 64^2 > dense_cost_nnz_factor * nnz
    Cs = [_dense_cost(12, 1), _ring_cost(50, 2), _dense_cost(14, 3),
          _ring_cost(45, 4)]
    out = solve_maxcut_batch(Cs, device="cpu", n_bucket=32, verbose=False,
                             dense_cost_max_n=32, dense_cost_nnz_factor=1)
    assert all(r.timers is out[0].timers for r in out)
    return out


def _bqp_instance():
    rs = np.random.RandomState(5)
    Q = rs.randn(5, 5)
    return 0.5 * (Q + Q.T), rs.randn(5)


def _bqp():
    Q, e = _bqp_instance()
    return [solve_bqp_sos_dual(Q, e, 5, device="cpu", verbose=False,
                               line_search=True, inner_dtype="tcg32")]


def _mom():
    Q, e = _bqp_instance()
    return [solve_bqp_mom(Q, e, 5, device="cpu", verbose=False,
                          inner_dtype="tcg32")]


CASES = {"batch": _batch, "bqp": _bqp, "mom": _mom}
# the cases whose certificate is ops/dense_cert.py's DenseEighCert
TIERED = ("bqp", "mom")
TIERS = ("cert.far", "cert.near", "cert.eigh64")


def _timed(case):
    t = time.perf_counter()
    out = CASES[case]()
    return out, time.perf_counter() - t


def _profiled(case):
    """The call under torch.profiler, and its ``manisdp.*`` ranges
    {name: [(start_ns, end_ns)]} (read from the raw events: building
    FunctionEvents for every traced op would take most of the test)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = CASES[case]()
    ranges = {}
    for evt in prof.profiler.kineto_results.events():
        if evt.name().startswith(T.PREFIX):
            s = evt.start_ns()
            ranges.setdefault(evt.name(), []).append(
                (s, s + evt.duration_ns()))
    return out, ranges


_SEEN = {}


def _cached(kind, case):
    if (kind, case) not in _SEEN:
        _SEEN[kind, case] = (_timed if kind == "plain" else _profiled)(case)
    return _SEEN[kind, case]


def _top(timers):
    return {k: v for k, v in timers.items() if "." not in k}


@pytest.mark.parametrize("case", sorted(CASES))
def test_the_call_records_its_spans(case):
    out, _ = _cached("plain", case)
    t = out[0].timers
    for name in ("operator", "rtr", "cert", "result", "rtr.wait"):
        assert name in t, name
    if max(r.iterations for r in out) > 1:
        assert "rank" in t
        if case == "batch":
            assert "batch.held" in t
    assert all(v >= 0.0 for v in t.values())
    assert t["rtr.wait"] <= t["rtr"]
    assert t.get("batch.held", 0.0) <= sum(_top(t).values())
    if case != "batch":
        assert "stats" in t
    else:
        assert set(_top(t)) == {"operator", "rtr", "cert", "rank", "result"}


@pytest.mark.parametrize("case", sorted(CASES))
def test_top_level_spans_cover_the_call(case):
    out, wall = _cached("plain", case)
    covered = sum(_top(out[0].timers).values())
    assert 0.9 * wall <= covered <= wall
    # SDPResult.time is the recorder's wall from entry to return
    assert covered <= out[0].time <= wall
    assert all(r.time == out[0].time for r in out)


@pytest.mark.parametrize("case", sorted(CASES))
def test_spans_are_profiler_ranges_while_it_records(case):
    _, ranges = _cached("profiled", case)
    for name in ("call", "operator", "rtr", "cert", "result", "rtr.wait"):
        assert T.PREFIX + name in ranges, name
    assert len(ranges[T.PREFIX + "call"]) == 1
    rtr = ranges[T.PREFIX + "rtr"]
    for s, e in ranges[T.PREFIX + "rtr.wait"]:
        assert any(s0 <= s and e <= e0 for s0, e0 in rtr)
    (c0, c1), = ranges[T.PREFIX + "call"]
    for name, spans in ranges.items():
        assert all(c0 <= s and e <= c1 for s, e in spans), name


@pytest.mark.parametrize("case", sorted(CASES))
def test_no_range_is_entered_while_the_profiler_is_off(case, monkeypatch):
    made = []

    class Counting:
        def __init__(self, *args, **kwargs):
            made.append(args)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", Counting)
    monkeypatch.setattr(torch.profiler, "record_function", Counting)
    monkeypatch.setattr(torch.autograd.profiler, "record_function",
                        Counting)
    CASES[case]()
    assert made == []
    # the same patch sees the ranges once the profiler records
    with profile(activities=[ProfilerActivity.CPU]):
        CASES[case]()
    assert made


@pytest.mark.parametrize("case", sorted(CASES))
def test_recording_changes_no_bit(case):
    plain, _ = _cached("plain", case)
    traced, _ = _cached("profiled", case)
    for a, b in zip(plain, traced):
        assert a.status == b.status
        assert a.obj == b.obj
        assert np.array_equal(a.Y, b.Y)


@pytest.mark.parametrize("case", TIERED)
def test_certificate_tiers_lie_inside_cert(case):
    out, _ = _cached("plain", case)
    t = out[0].timers
    tiers = [k for k in t if k.startswith("cert.")]
    assert tiers and set(tiers) <= set(TIERS), tiers
    assert "cert.far" in t or "cert.near" in t
    assert sum(t[k] for k in tiers) <= t["cert"]
    _, ranges = _cached("profiled", case)
    cert = ranges[T.PREFIX + "cert"]
    seen = [k for k in TIERS if T.PREFIX + k in ranges]
    assert seen
    for k in seen:
        for s, e in ranges[T.PREFIX + k]:
            assert any(s0 <= s and e <= e0 for s0, e0 in cert), k


def test_a_span_outside_a_call_records_nothing():
    assert T.current() is None
    with T.span("rtr.wait"):
        pass
    assert T.current() is None


def test_entries_share_the_outermost_recorder():
    seen = []

    @T.recorded
    def inner():
        with T.span("rtr"):
            seen.append(T.current())
        return _Res()

    @T.recorded
    def outer():
        with T.span("operator"):
            seen.append(T.current())
        return [inner(), _Res()]

    out = outer()
    assert seen[0] is seen[1] and set(seen[0].t) == {"operator", "rtr"}
    assert out[0].time == out[1].time >= sum(seen[0].t.values())
    assert T.current() is None


def test_a_thread_keeps_its_own_recorder():
    seen = []

    @T.recorded
    def call():
        seen.append(T.current())
        if len(seen) == 1:
            worker = threading.Thread(target=call)
            worker.start()
            worker.join()
        return _Res()

    call()
    assert len(seen) == 2 and seen[0] is not seen[1]


class _Res:
    time = 0.0
