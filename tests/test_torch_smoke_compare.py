"""tools/smoke_compare.py: the fields it compares between two
chip_smoke.py records and what it reports."""

import json
import os
import subprocess
import sys

TOOL = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools", "smoke_compare.py")


def _run(tmp_path, a, b):
    pa, pb = tmp_path / "a.json", tmp_path / "b.json"
    pa.write_text(json.dumps(a))
    pb.write_text(json.dumps(b))
    r = subprocess.run([sys.executable, TOOL, str(pa), str(pb)],
                       capture_output=True, text=True, check=False)
    return r.returncode, json.loads(r.stdout)


def test_equal_records_pass(tmp_path):
    rec = {"g67": {"obj": -1.5, "status": 0, "outer_iters": 2,
                   "seconds": 3.0, "timers": {"rtr": 1.0}},
           "batch": [{"obj": 2.0, "iters": [3, 4]}, {"fx_hex": "0x1p+0"}]}
    other = json.loads(json.dumps(rec))
    other["g67"]["seconds"] = 9.0          # times are not compared
    other["g67"]["timers"]["rtr"] = 7.0
    rc, out = _run(tmp_path, rec, other)
    assert rc == 0 and out["differ"] == []
    assert out["compared"] == 5 and out["only_a"] == out["only_b"] == []


def test_a_changed_objective_fails(tmp_path):
    a = {"dual": {"bqp60": {"obj": -478.0, "status": 0, "iterations": 17},
                  "oracle": {"obj": 1.0}}}
    b = {"dual": {"bqp60": {"obj": -478.5, "status": 0, "iterations": 17},
                  "oracle": {"obj": 2.0}},
         "sharded": {"status": 0}}
    rc, out = _run(tmp_path, a, b)
    assert rc == 1
    assert out["differ"] == [dict(path="dual/bqp60/obj", a=-478.0, b=-478.5)]
    assert out["compared"] == 3 and out["only_b"] == ["sharded/status"]
