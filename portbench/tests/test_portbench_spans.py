"""The span readers (metrics/driver.operator_pct, driver.rank_pct,
driver.result_pct, driver.untraced_pct, rtr.host_pct, batch.held_pct) on
a synthetic window: each gives its share, none reads a program whose
calls are not recorded from entry to return, and driver.other_pct
splits into the new shares."""

from types import SimpleNamespace

import pytest

from portbench import registry, runner

NEW = ("driver.operator_pct", "driver.rank_pct", "driver.result_pct",
       "driver.untraced_pct", "rtr.host_pct", "batch.held_pct")

BATCH = dict(operator=1.0, rtr=3.0, cert=2.5, rank=0.5, result=0.25,
             **{"rtr.wait": 1.25, "batch.held": 0.75})
DUAL = dict(operator=0.5, rtr=6.0, stats=0.5, cert=1.0, rank=0.25,
            result=0.125, **{"rtr.wait": 2.0})


def _ctx(calls):
    """A window of calls (seconds, timers): a batch call's results share
    one timers dict, as the program's do."""
    records = [runner.Record(seconds=s, instances=[None] * 2,
                             results=[SimpleNamespace(timers=t)] * 2)
               for s, t in calls]
    return runner.Context(None, records, None, 7)


def _read(name, ctx):
    return registry.metric(name).read(ctx)


def test_each_reader_gives_its_share():
    ctx = _ctx([(8.0, dict(BATCH)), (12.0, dict(DUAL))])
    want = {"driver.operator_pct": 100 * 1.5 / 20,
            "driver.rank_pct": 100 * 0.75 / 20,
            "driver.result_pct": 100 * 0.375 / 20,
            "driver.untraced_pct": 100 * (20 - 7.25 - 8.375) / 20,
            "rtr.host_pct": 100 * (1.75 + 4.0) / 20,
            "batch.held_pct": 100 * 0.75 / 20}
    for name, value in want.items():
        assert _read(name, ctx) == pytest.approx(value), name


@pytest.mark.parametrize("calls", [
    [],
    [(5.0, None)],
    # the parent's timers: phases only, no whole-call record
    [(5.0, dict(rtr=2.0, cert=1.0, rank=0.5))],
    [(5.0, dict(BATCH)), (5.0, dict(rtr=2.0, cert=1.0, rank=0.5))],
])
def test_no_reading_without_a_whole_call_record(calls):
    ctx = _ctx(calls) if calls else runner.Context(None, [], None, 7)
    for name in NEW:
        assert _read(name, ctx) is None, name


def test_no_held_time_outside_the_batch():
    ctx = _ctx([(10.0, dict(DUAL))])
    assert _read("batch.held_pct", ctx) is None
    assert _read("driver.operator_pct", ctx) == pytest.approx(5.0)


@pytest.mark.parametrize("calls", [
    [(8.0, dict(BATCH))],
    [(12.0, dict(DUAL))],
    [(8.0, dict(BATCH)), (12.0, dict(DUAL)), (7.5, dict(BATCH))],
])
def test_other_is_operator_rank_result_stats_and_untraced(calls):
    ctx = _ctx(calls)
    stats = 100 * sum(t.get("stats", 0.0) for _, t in calls) / ctx.window_s
    parts = sum(_read(name, ctx) for name in (
        "driver.operator_pct", "driver.rank_pct", "driver.result_pct",
        "driver.untraced_pct"))
    assert _read("driver.other_pct", ctx) == pytest.approx(parts + stats)


def test_every_new_metric_is_listed_where_it_reads():
    bench = registry.benchmark()
    entries = {m["name"]: m for m in bench["per_layer"]}
    cells = [c["name"] for c in bench["workloads"]]
    for name in NEW:
        m = entries[name]
        assert (m["unit"], m["better"], m["source"], m["moves"]) == \
            ("%", "lower", "program_span", "instances_per_s")
        want = [c for c in cells if c.startswith("maxcut.")] \
            if name == "batch.held_pct" else cells
        assert sorted(m["workloads"]) == sorted(want), name
