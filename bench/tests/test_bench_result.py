"""The result line, the run's guards, and what the benchmark may import."""
from __future__ import annotations

import ast
import json
import os
import subprocess
import sys

import smoke
from bench import run as bench_run
from bench.core import device as D
from bench.core import spec
from bench.core.record import Check, Run
from bench.core.trace import Stretch

ROOT = spec.ROOT
BENCH = os.path.join(ROOT, "bench")


def _line(trace: bool):
    c = smoke.cell("olmo-1b.query-burst")
    r = Run(c.name, c.config, c.traffic, setup_s=2.0, window_s=1.0,
            attempted=3, memory_peak_bytes=123,
            checks=[Check("served_gap", 0.01, 0.1),
                    Check("unanswered", 0.0, 0.0)])
    r.peaks = smoke.PEAKS
    if trace:
        r.stretch = Stretch(wall_s=1.0, busy_s=0.5,
                            kernels={"attn_prefill_kernel": (2, 0.25)},
                            idle_gaps=[("bench.tick", 0.3)])
    return bench_run.result(c, r, trace,
                            {"kind": "NVIDIA H100 80GB HBM3",
                             "power_limit": "700.00 W"})


def test_result_line_keys_and_breakdown_only_when_traced():
    plain, traced = _line(False), _line(True)
    want = ["correct", "attempted", "failed", "metrics", "device"]
    assert list(plain) == want + ["checks"]
    assert list(traced) == want + ["breakdown", "checks"]
    assert plain["correct"] is True
    assert plain["device"]["platform"] == "gpu"
    assert "busy_s" not in plain["device"]
    assert traced["device"]["busy_s"] == 0.5
    assert traced["device"]["window_s"] == 1.0
    # a run with no queries has no tail to read: only its set-up
    assert set(plain["metrics"]) == {"setup_s"}
    assert set(traced["breakdown"]) == {"device_ops", "idle_gaps"}
    json.dumps(traced)
    # the numbers compared come last, each beside its limit
    assert traced["checks"]["served_gap"] == {"value": 0.01, "limit": 0.1}


def test_a_failed_number_makes_the_run_not_correct():
    r = Run("c", {}, {}, checks=[Check("a", 0.2, 0.1)])
    assert not r.correct
    r = Run("c", {}, {}, checks=[Check("a", float("nan"), 0.1)])
    assert not r.correct
    # control readings do not decide it
    r = Run("c", {}, {}, checks=[Check("a", 0.0, 0.1),
                                 Check("control.a", 9.0, 0.1)])
    assert r.correct
    assert not Run("c", {}, {}).correct


def test_without_cuda_the_run_exits_nonzero_and_prints_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run(
        [sys.executable, os.path.join(BENCH, "run.py"), "--workload",
         "olmo-1b.query-burst", "--seed", "3000000000", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, cwd=ROOT,
        env=env, timeout=300)
    assert p.returncode == 2
    assert p.stdout.strip() == ""
    assert "cuda" in p.stderr.lower()


def test_forbidden_modules_are_matched_by_whole_top_level_name():
    sys.modules.setdefault("repro_torch_lookalike", sys)
    try:
        assert "repro_torch_lookalike" not in D.forbidden_modules()
    finally:
        del sys.modules["repro_torch_lookalike"]
    sys.modules["jax.fake_submodule"] = sys
    try:
        assert "jax.fake_submodule" in D.forbidden_modules()
    finally:
        del sys.modules["jax.fake_submodule"]


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module and \
                node.level == 0:
            yield node.module.split(".")[0]


def _sources(top):
    for d, _, files in os.walk(top):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_nothing_in_bench_imports_jax_or_the_jax_package():
    for path in _sources(BENCH):
        for name in _imports(path):
            assert name not in ("jax", "jaxlib", "flax", "repro"), \
                (path, name)


def test_the_reference_imports_nothing_of_the_program():
    for path in _sources(os.path.join(BENCH, "reference")):
        for name in _imports(path):
            assert name not in ("repro_torch", "repro", "jax"), (path, name)


def test_the_run_reads_nothing_outside_bench_and_src():
    """No file of the benchmark names the JAX-era benchmark, its results
    or the smoke script."""
    for path in _sources(BENCH):
        if path.endswith("test_bench_result.py"):
            continue
        text = open(path).read()
        for word in ("benchmarks/", "BENCH_", "chip_smoke.py\"",
                     "open(\"chip_smoke"):
            assert word not in text, (path, word)
