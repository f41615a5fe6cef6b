"""What a run is told to do, found by name: `BENCHMARK.json` names the
cell; the cell names its configuration (`bench/configs/<name>.json`) and
its traffic mix (`bench/traffic/<name>.json`); a cell may add parameters
of its own (`bench/cells/<name>.json`, such as the open loop's rate, found
once per configuration); each metric is read by `bench/metrics/<name>.py`.
A new cell, configuration, mix or metric is a new file and a new entry;
no file here changes for it.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
from typing import Callable, Dict, List, Optional

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


@dataclasses.dataclass
class Metric:
    name: str
    unit: str
    end_to_end: bool
    workloads: Optional[List[str]]    # None: every cell

    def applies_to(self, cell: str) -> bool:
        return self.workloads is None or cell in self.workloads


@dataclasses.dataclass
class Cell:
    name: str
    config_name: str
    traffic_name: str
    chips: int
    config: dict        # the configuration file as it is run
    traffic: dict       # the mix's parameters, the cell's own laid over them
    metrics: List[Metric]
    root: str = ROOT


def _read_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_benchmark(root: str = ROOT) -> dict:
    return _read_json(os.path.join(root, "BENCHMARK.json"))


def metrics_of(bench: dict) -> List[Metric]:
    return [Metric(m["name"], m["unit"], kind == "end_to_end",
                   m.get("workloads"))
            for kind in ("end_to_end", "per_layer") for m in bench[kind]]


def cell(name: str, root: str = ROOT, bench: Optional[dict] = None) -> Cell:
    """The cell `name` of BENCHMARK.json with its files read."""
    bench = bench or load_benchmark(root)
    found = [w for w in bench["workloads"] if w["name"] == name]
    if not found:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; have "
                       f"{[w['name'] for w in bench['workloads']]}")
    w = found[0]
    here = os.path.join(root, "bench")
    cfg_entry = [c for c in bench["configs"] if c["name"] == w["config"]][0]
    config = _read_json(os.path.join(root, cfg_entry["file"]))
    traffic = _read_json(os.path.join(here, "traffic",
                                      w["traffic"] + ".json"))
    own = os.path.join(here, "cells", name + ".json")
    if os.path.exists(own):
        traffic = dict(traffic, **_read_json(own))
    return Cell(name, w["config"], w["traffic"], int(w["chips"]), config,
                traffic, metrics_of(bench), root)


def reader(metric: str, root: str = ROOT) -> Callable:
    """`read(run)` of `bench/metrics/<metric>.py`: the metric's number from
    a finished run, or None where the run holds nothing to read."""
    path = os.path.join(root, "bench", "metrics", metric + ".py")
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + metric.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def read_metrics(c: Cell, run, *, trace: bool) -> Dict[str, dict]:
    """The cell's end-to-end metrics (trace off) or per-layer metrics
    (trace on) from `run`; a reader that finds nothing leaves its metric
    out."""
    out = {}
    for m in c.metrics:
        if m.end_to_end == trace or not m.applies_to(c.name):
            continue
        value = reader(m.name, c.root)(run)
        if value is not None:
            out[m.name] = {"value": value, "unit": m.unit}
    return out
