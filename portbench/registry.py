"""Everything a cell is made of, found by name.

BENCHMARK.json (at the checkout's root) lists the cells, configurations
and metrics.  Each named piece is a file of its own under portbench/:

- configuration ``<name>``: ``configs/<name>.json`` (the file
  BENCHMARK.json names for it);
- traffic mix ``<name>``: ``traffic/<name>.json``, parameters that name
  the instance generator;
- instance generator ``<name>``: ``generators/<name>.py``, with
  ``make(params, rng)``;
- reference ``<name>``: ``reference/<name>.py``, with ``judge``;
- metric ``<name>``: ``metrics/<name>.py``, with ``read(ctx)``.

So a later change adds a cell, a configuration, a mix or a metric as new
files and entries, and edits none of these modules.
"""

from __future__ import annotations

import importlib.util
import json
import os
import re
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")


def _check_name(kind: str, name: str) -> str:
    if not isinstance(name, str) or not NAME.match(name):
        raise ValueError(f"not a valid {kind} name: {name!r}")
    return name


def load_json(path: str):
    with open(path) as fh:
        return json.load(fh)


def benchmark(root: str = ROOT) -> dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


def _entry(items, name: str, kind: str) -> dict:
    for item in items:
        if item["name"] == name:
            return item
    raise KeyError(f"no {kind} named {name!r} in BENCHMARK.json")


def cell(bench: dict, name: str) -> dict:
    return _entry(bench["workloads"], _check_name("cell", name), "cell")


def config(bench: dict, name: str, root: str = ROOT) -> dict:
    item = _entry(bench["configs"], _check_name("configuration", name),
                  "configuration")
    return load_json(os.path.join(root, item["file"]))


def traffic(name: str, here: str = HERE) -> dict:
    _check_name("traffic mix", name)
    return load_json(os.path.join(here, "traffic", f"{name}.json"))


def _module(kind: str, folder: str, name: str, here: str):
    """The module in ``<here>/<folder>/<name>.py``, loaded by path (names
    may hold dots) and cached in sys.modules."""
    _check_name(kind, name)
    path = os.path.join(here, folder, f"{name}.py")
    if not os.path.exists(path):
        raise KeyError(f"no {kind} {name!r} ({path} is missing)")
    key = f"portbench_{folder}_{name}".replace(".", "_").replace("-", "_")
    mod = sys.modules.get(key)
    if mod is not None and getattr(mod, "__file__", None) == path:
        return mod
    spec = importlib.util.spec_from_file_location(key, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[key] = mod
    spec.loader.exec_module(mod)
    return mod


def generator(name: str, here: str = HERE):
    return _module("generator", "generators", name, here)


def reference(name: str, here: str = HERE):
    return _module("reference", "reference", name, here)


def metric(name: str, here: str = HERE):
    return _module("metric", "metrics", name, here)


def cell_metrics(bench: dict, cell_name: str, kind: str) -> list:
    """The ``kind`` ("end_to_end" or "per_layer") metrics a cell reports:
    those without a ``workloads`` key and those that list it."""
    return [m for m in bench[kind]
            if cell_name in m.get("workloads", [cell_name])]


def listing(here: str = HERE) -> dict:
    """Names of every traffic mix, generator, reference and metric file."""
    out = {}
    for folder, ext in (("configs", ".json"), ("traffic", ".json"),
                        ("generators", ".py"), ("reference", ".py"),
                        ("metrics", ".py")):
        path = os.path.join(here, folder)
        out[folder] = sorted(f[:-len(ext)] for f in os.listdir(path)
                             if f.endswith(ext) and not f.startswith("_"))
    return out
