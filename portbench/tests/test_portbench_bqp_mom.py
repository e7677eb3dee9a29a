"""The readers the BQP moment cell adds: K9's and K10's bytes against a
count by hand and PERF.md's table of kernels, and the certificate tier
shares (cert.near_pct, cert.eigh64_pct) on synthetic windows; and the
sign gauge of the cell's traffic."""

from types import SimpleNamespace

import numpy as np
import pytest

from portbench import registry, runner, timing

TIERS = ("cert.near_pct", "cert.eigh64_pct")
DUAL = dict(operator=0.5, rtr=6.0, stats=0.5, cert=1.0, rank=0.25,
            result=0.125, **{"rtr.wait": 2.0, "cert.far": 0.25,
                             "cert.near": 0.5})
MOM = dict(DUAL, **{"cert.eigh64": 0.125})


def _ctx(calls):
    records = [runner.Record(seconds=s, instances=[None],
                             results=[SimpleNamespace(timers=t)])
               for s, t in calls]
    return runner.Context(None, records, None, 7)


def _read(name, ctx):
    return registry.metric(name).read(ctx)


def test_k9_k10_bytes():
    q = 60
    n = 2 + q + q * q                                  # 3,662
    flat = 1 + q + 3 * q ** 2 + 2 * q ** 3 + q ** 4   # 13,402,861
    rows = 1_155_281            # bqpmom.m's rows at q = 60, K10's reads
    assert registry.metric("k9_roofline").bytes_at(q) == (n * n + flat) * 4
    assert registry.metric("k10_roofline").bytes_at(q) == (rows + n * n) * 4
    assert registry.metric("k10_roofline").valid_slots(q) == \
        registry.reference("bqp_mom").sizes(q)["rows"]
    # PERF.md's table, row B16 in f32: bounds 0.0320 (K9) and 0.0174 ms
    # (K10 plain)
    k9 = timing.bound_ms(registry.metric("k9_roofline").bytes_at(q),
                         registry.metric("k9_roofline").flops_at(q),
                         "float32")
    k10 = timing.bound_ms(registry.metric("k10_roofline").bytes_at(q),
                          registry.metric("k10_roofline").flops_at(q),
                          "float32")
    assert abs(k9 - 0.0320) < 5e-4 and abs(k10 - 0.0174) < 5e-4


@pytest.mark.parametrize("name", ["k9_roofline", "k10_roofline"])
def test_rooflines_read_nothing_off_the_card(name):
    import torch
    ctx = runner.Context(None, [], torch.device("cpu"), 7)
    assert _read(name, ctx) is None


def test_tier_shares():
    ctx = _ctx([(8.0, dict(DUAL)), (12.0, dict(MOM))])
    assert _read("cert.near_pct", ctx) == pytest.approx(100 * 1.0 / 20)
    assert _read("cert.eigh64_pct", ctx) == pytest.approx(100 * 0.125 / 20)
    # recorded, and the fallback never ran: 0
    assert _read("cert.eigh64_pct", _ctx([(8.0, dict(DUAL))])) == 0.0


@pytest.mark.parametrize("calls", [
    [],
    [(5.0, None)],
    # the parent's timers: a whole call, no tier of the certificate
    [(5.0, dict(operator=0.5, rtr=2.0, cert=1.0, rank=0.5, result=0.1))],
    # a call not recorded from entry to return
    [(5.0, dict(rtr=2.0, cert=1.0, **{"cert.near": 0.5}))],
])
def test_no_tier_share_without_its_spans(calls):
    ctx = _ctx(calls) if calls else runner.Context(None, [], None, 7)
    for name in TIERS:
        assert _read(name, ctx) is None, name


def test_tier_metrics_are_listed_where_they_read():
    bench = registry.benchmark()
    entries = {m["name"]: m for m in bench["per_layer"]}
    for name in TIERS:
        assert entries[name]["workloads"] == ["bqp-sos.d60", "bqp-mom.d60"]
        assert entries[name]["layer"] == entries["cert.pct"]["layer"]
    for name in ("k9_roofline", "k10_roofline"):
        assert entries[name]["workloads"] == ["bqp-mom.d60"]


def test_the_gauge_draws_bqp_d60s_pool():
    """The moment cell's call k solves the pool problem of the dual
    cell's call k, each seed's copy a sign gauge of it."""
    mom = runner.Cell("bqp-mom.d60")
    sos = runner.Cell("bqp-sos.d60")
    gen = registry.generator("bqp_normal")
    for seed in (1, 2 ** 40 + 3):
        for k in (0, 5):
            (Qm, em, q), = mom.instances(seed, runner.STREAM_WINDOW, k)
            (Qs, es, _), = sos.instances(seed, runner.STREAM_WINDOW, k)
            Q, e, _ = gen.make(mom.traffic["params"], runner.pool_rng(
                mom.traffic["pool_entropy"], runner.STREAM_WINDOW, k, 0))
            s = np.sign(em / e)
            assert q == 60 and set(np.abs(s)) == {1.0}
            assert np.array_equal(Qm, s[:, None] * Q * s[None, :])
            c = Qs[0, 1] / Q[0, 1]
            assert np.array_equal(Qs, c * Q)
