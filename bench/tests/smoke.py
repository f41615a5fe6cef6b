"""Cells at smoke width for the CPU tests: the same drivers, configs cut to
two layers of width 64, a handful of cameras and slots."""
from __future__ import annotations

import copy
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
for p in (ROOT, os.path.join(ROOT, "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

from bench.core import spec  # noqa: E402

TINY = {
    "olmo-1b": dict(num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
                    d_ff=128, vocab_size=256),
    "olmo-1b-vocab8": dict(num_layers=2, d_model=64, num_heads=4,
                           num_kv_heads=4, d_ff=128, vocab_size=200),
    "hymba-1.5b": dict(num_layers=3, d_model=64, num_heads=4,
                       num_kv_heads=2, d_ff=96, vocab_size=256,
                       sliding_window=16, global_attn_layers=[0, 2],
                       meta_tokens=4,
                       ssm={"state_dim": 8, "conv_width": 4, "expand": 2}),
}
TRAFFIC = {
    "serve": dict(groups=[3, 2, 2], slots=4, max_new=4, check_queries=12,
                  trace_seconds=0.5, drain_seconds=30),
    "retrain": dict(scenario_seeds=[0, 1]),
}
CELL = {"olmo-1b.query": dict(prompt_len=20, rate=6.0),
        "hymba-1.5b.query": dict(prompt_len=24, rate=4.0),
        "olmo-1b.query-flood": dict(prompt_len=20),
        "olmo-1b.retrain": dict()}
PEAKS = {"bytes": 3.35e12, "bf16": 989e12, "fp32": 67e12}
# a cell whose files the benchmark keeps but which BENCHMARK.json does not
# run (PERF.md, open questions): laid into it here, so that its driver,
# reference and limits stay tested
HELD = {"configs": [{"name": "hymba-1.5b",
                     "file": "bench/configs/hymba-1.5b.json"}],
        "workloads": [{"name": "hymba-1.5b.query", "config": "hymba-1.5b",
                       "traffic": "stream-query-open", "chips": 1}]}


def cell(name: str) -> spec.Cell:
    """The cell of BENCHMARK.json at smoke width, its limits loose."""
    bench = spec.load_benchmark()
    for key, held in HELD.items():
        have = {x["name"] for x in bench[key]}
        bench[key] = bench[key] + [x for x in held if x["name"] not in have]
    c = copy.deepcopy(spec.cell(name, bench=bench))
    c.config.update(TINY[c.config_name])
    c.traffic.update(TRAFFIC[c.traffic["kind"]])
    c.traffic.update(CELL[name])
    c.traffic["limits"] = {k: 1e9 for k in c.traffic.get("limits", {})}
    return c
