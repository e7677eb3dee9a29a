"""The harness finds every piece of a cell by name, and a cell, traffic mix
and metric added as files are found with no edit to its code."""

import json
import os
import shutil
import subprocess
import sys

from portbench import registry, runner

ROOT = registry.ROOT


def test_every_named_piece_resolves():
    bench = registry.benchmark()
    for c in bench["workloads"]:
        cell = runner.Cell(c["name"])
        assert cell.config["name"] == c["config"]
        assert callable(cell.generator.make)
        assert callable(cell.reference.judge)
        assert set(cell.config["limits"]) == \
            set(cell.reference.NUMBERS) | {"uncertified_share", "missing"}
        for kind in ("end_to_end", "per_layer"):
            for m in registry.cell_metrics(bench, c["name"], kind):
                assert callable(registry.metric(m["name"]).read)
    for cfg in bench["configs"]:
        data = registry.load_json(os.path.join(ROOT, cfg["file"]))
        assert data["name"] == cfg["name"]
        assert data["reduced"] == cfg["reduced"]


def test_names_are_checked():
    for bad in ("../x", "a b", "", "x/y"):
        try:
            registry.traffic(bad)
        except ValueError:
            continue
        raise AssertionError(f"{bad!r} accepted")


def test_files_added_to_a_copy_are_found(tmp_path):
    """A throwaway cell (a new traffic mix on an existing generator) and a
    throwaway per-layer metric, added as files and entries in a copy of
    the benchmark, are listed and resolved by the copy's unchanged code."""
    shutil.copytree(os.path.join(ROOT, "portbench"), tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = registry.benchmark()
    (tmp_path / "portbench" / "traffic" / "torus9x8-b2.json").write_text(
        json.dumps(dict(generator="torus_pm1", params=dict(rows=9, cols=8),
                        instances_per_call=2, pool_entropy=5, first_call=0,
                        why="throwaway")))
    (tmp_path / "portbench" / "metrics" / "zz.calls.py").write_text(
        "def read(ctx):\n    return len(ctx.records)\n")
    bench["workloads"].append(dict(name="maxcut.zz", config="maxcut",
                                   traffic="torus9x8-b2", chips=1,
                                   why="throwaway"))
    bench["per_layer"].append(dict(
        name="zz.calls", unit="count", better="lower",
        source="host_clock", layer="drivers", moves="instances_per_s",
        workloads=["maxcut.zz"]))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    code = (
        "import sys; sys.path.insert(0, sys.argv[1])\n"
        "from portbench import registry, runner\n"
        "assert registry.ROOT == sys.argv[1], registry.ROOT\n"
        "ls = registry.listing()\n"
        "assert 'torus9x8-b2' in ls['traffic'], ls\n"
        "assert 'zz.calls' in ls['metrics'], ls\n"
        "cell = runner.Cell('maxcut.zz')\n"
        "inst = cell.instances(7, 0, 0)\n"
        "assert [c.shape for c in inst] == [(72, 72)] * 2\n"
        "names = [m['name'] for m in registry.cell_metrics(\n"
        "    cell.bench, 'maxcut.zz', 'per_layer')]\n"
        "assert 'zz.calls' in names, names\n"
        "ctx = runner.Context(cell, [runner.Record(seconds=1.0,\n"
        "    instances=inst, results=[])], None, 7)\n"
        "assert registry.metric('zz.calls').read(ctx) == 1\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code, str(tmp_path)],
                         capture_output=True, text=True, timeout=120,
                         cwd=str(tmp_path))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
