"""Cells at smoke width for the CPU tests: the same drivers, configs cut to
two layers of width 64, a handful of cameras and slots. A configuration's
sizes at smoke width, and a cell's own traffic parameters, are
`smoke/<name>.json`; the smoke traffic of each kind of mix is `TRAFFIC`."""
from __future__ import annotations

import copy
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
for p in (ROOT, os.path.join(ROOT, "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

from bench.core import spec  # noqa: E402

SMOKE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "smoke")

TRAFFIC = {
    "serve": dict(groups=[3, 2, 2], slots=4, max_new=4, check_queries=12,
                  trace_seconds=0.5, drain_seconds=30),
    "retrain": dict(scenario_seeds=[0, 1]),
}
PEAKS = {"bytes": 3.35e12, "bf16": 989e12, "fp32": 67e12}
# cells whose files the benchmark keeps but which BENCHMARK.json does not
# run (PERF.md, open questions): laid into it here, so that their driver,
# reference and limits stay tested
HELD = {"configs": [{"name": "hymba-1.5b",
                     "file": "bench/configs/hymba-1.5b.json"}],
        "workloads": [{"name": "hymba-1.5b.query", "config": "hymba-1.5b",
                       "traffic": "stream-query-open", "chips": 1},
                      {"name": "olmo-1b.query", "config": "olmo-1b",
                       "traffic": "stream-query-open", "chips": 1}]}


def _bench() -> dict:
    """BENCHMARK.json with the held-out cell laid in."""
    bench = spec.load_benchmark()
    for key, held in HELD.items():
        have = {x["name"] for x in bench[key]}
        bench[key] = bench[key] + [x for x in held if x["name"] not in have]
    return bench


def sizes(name: str) -> dict:
    """`smoke/<name>.json` of a configuration (its sizes cut to smoke
    width) or of a cell (its traffic's own parameters at smoke width)."""
    with open(os.path.join(SMOKE, name + ".json")) as f:
        return json.load(f)


def configs() -> list:
    """The configurations, held-out ones too, that have a smoke file."""
    return [c["name"] for c in _bench()["configs"]
            if os.path.exists(os.path.join(SMOKE, c["name"] + ".json"))]


def config(name: str) -> dict:
    """The configuration file `name` at smoke width."""
    entry = [c for c in _bench()["configs"] if c["name"] == name][0]
    with open(os.path.join(ROOT, entry["file"])) as f:
        return dict(json.load(f), **sizes(name))


def cell(name: str) -> spec.Cell:
    """The cell of BENCHMARK.json at smoke width, its limits loose."""
    c = copy.deepcopy(spec.cell(name, bench=_bench()))
    c.config.update(sizes(c.config_name))
    c.traffic.update(TRAFFIC[c.traffic["kind"]])
    c.traffic.update(sizes(name))
    c.traffic["limits"] = {k: 1e9 for k in c.traffic.get("limits", {})}
    return c
