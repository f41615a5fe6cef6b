"""What a run is told to do, found by name: `BENCHMARK.json` names the
cell; the cell names its configuration (`bench/configs/<name>.json`) and
its traffic mix (`bench/traffic/<name>.json`); a cell may add parameters
of its own (`bench/cells/<name>.json`, such as the open loop's rate, found
once per configuration); each metric is read by `bench/metrics/<name>.py`.
A configuration's model family (its `family` key) has its plain
reference and its operation counts in
`bench/reference/families/<family>.py`; each hand-written kernel whose launches the
traced stretch records is `bench/kernels/<name>.py`. A new cell,
configuration, mix, metric, model family or kernel is new files and new
entries; no file here changes for it.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import re
from types import ModuleType
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


_loaded: Dict[str, ModuleType] = {}


def _module(kind: str, name: str, root: str) -> ModuleType:
    """`bench/<kind>/<name>.py`, loaded by its path (once a process)."""
    path = os.path.join(root, "bench", kind, name + ".py")
    if path not in _loaded:
        if not os.path.exists(path):
            raise FileNotFoundError(f"no {path}: {kind} {name!r} has no "
                                    f"file of its own")
        label = re.sub(r"\W", "_", f"bench_{kind}_{name}")
        spec = importlib.util.spec_from_file_location(label, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _loaded[path] = mod
    return _loaded[path]


def reader(metric: str, root: str = ROOT) -> Callable:
    """`read(run)` of `bench/metrics/<metric>.py`: the metric's number from
    a finished run, or None where the run holds nothing to read."""
    return _module("metrics", metric, root).read


def family(cfg: dict, root: str = ROOT) -> ModuleType:
    """`bench/reference/families/<family>.py` of a configuration:
    `hidden(cfg, params, tokens, quant)`, its operation counts
    (`matmul_params`, `forward_flops`, `decode_flops`) and, where it
    defines one, its own `logits`."""
    return _module(os.path.join("reference", "families"), cfg["family"],
                   root)


def kernel(name: str, root: str = ROOT) -> ModuleType:
    """`bench/kernels/<name>.py`: the port's op it wraps (`TARGET`,
    `module:attribute`), the device functions it launches
    (`DEVICE_NAMES`), a launch's record from the op's arguments
    (`record(args, kwargs)`) and its cost (`cost(record, peaks)`:
    bytes, operations and the peak of the units doing them)."""
    return _module("kernels", name, root)


def kernels(root: str = ROOT) -> Dict[str, ModuleType]:
    """Every kernel file, by name."""
    here = os.path.join(root, "bench", "kernels")
    return {f[:-3]: kernel(f[:-3], root) for f in sorted(os.listdir(here))
            if f.endswith(".py")}


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
