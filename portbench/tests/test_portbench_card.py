"""A traced run on the card at tiny sizes: every per-layer metric of the
cell is read, and no share passes 100 %.  Skips without a card."""

import pytest

from portbench import runner

TINY = {"maxcut.torus3k-b16": ({"rows": 12, "cols": 10}, 4),
        "maxcut.g1-b64": ({"n": 120, "m": 600}, 4),
        "bqp-sos.d60": ({"q": 8}, 1)}


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(TINY))
def test_traced_run_on_the_card(cuda_device, name):
    traffic, per = TINY[name]
    cell = runner.Cell(name, traffic=traffic)
    cell.traffic["instances_per_call"] = per
    out = runner.run(name, 99, 1.0, True, device=cuda_device, cell=cell,
                     log=lambda msg: None)
    assert out["correct"], out["checks"]
    assert out["device"]["platform"] == "gpu"
    assert 0.0 < out["device"]["busy_s"] <= out["device"]["window_s"]
    wanted = {m["name"] for m in runner.registry.cell_metrics(
        cell.bench, name, "per_layer")}
    assert set(out["metrics"]) == wanted
    for m, v in out["metrics"].items():
        if v["unit"] == "%":
            assert 0.0 <= v["value"] <= 100.0, (m, v)
