"""Compare two ``chip_smoke.py`` records field by field: every objective,
status and iteration count of the solves (keys ``obj``, ``obj_unscaled``,
``single_obj``, ``fx``, ``fx_hex``, ``status``, ``outer``,
``outer_iters``, ``iterations``, ``iters``, ``inner_iters`` and
``rtr_iters``, wherever they sit in the record), by their path.

    python3 tools/smoke_compare.py A/chip_smoke.json B/chip_smoke.json

Run both records in one call on one card (for a parent and a change: the
parent unpacked with git archive into a git-ignored directory, each
tree's ``python3 chip_smoke.py --out DIR``).  Prints one JSON object:
the number of fields compared, the fields that differ (path and both
values) and the paths found in one record only; exits 1 if any field
differs.  Times, errors and oracle residuals are not compared: they move
between calls.
"""

from __future__ import annotations

import argparse
import json
import sys

KEYS = frozenset({"obj", "obj_unscaled", "single_obj", "fx", "fx_hex",
                  "status", "outer", "outer_iters", "iterations", "iters",
                  "inner_iters", "rtr_iters"})
# sub-records whose values are timings of repeated calls, not solves
SKIP = frozenset({"timers", "oracle", "tcg_iteration", "cert_call"})


def fields(rec, path=()):
    """{path: value} of every KEYS entry of ``rec`` (lists by index)."""
    out = {}
    if isinstance(rec, dict):
        for k, v in rec.items():
            if k in SKIP:
                continue
            if k in KEYS and not isinstance(v, (dict, list)):
                out["/".join(map(str, path + (k,)))] = v
            else:
                out.update(fields(v, path + (k,)))
    elif isinstance(rec, list):
        for i, v in enumerate(rec):
            out.update(fields(v, path + (i,)))
    return out


def compare(a, b):
    fa, fb = fields(a), fields(b)
    both = sorted(set(fa) & set(fb))
    differ = [dict(path=p, a=fa[p], b=fb[p]) for p in both if fa[p] != fb[p]]
    return dict(compared=len(both), differ=differ,
                only_a=sorted(set(fa) - set(fb)),
                only_b=sorted(set(fb) - set(fa)))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("a")
    ap.add_argument("b")
    args = ap.parse_args(argv)
    with open(args.a) as f:
        a = json.load(f)
    with open(args.b) as f:
        b = json.load(f)
    res = compare(a, b)
    print(json.dumps(res))
    return 1 if res["differ"] else 0


if __name__ == "__main__":
    sys.exit(main())
