"""BENCHMARK.json and the files it names: each cell, configuration, mix
and metric is found by name, a new one is only new files and entries, and
every name, unit and limit keeps to the benchmark's contract."""
from __future__ import annotations

import dataclasses
import json
import os
import re
import shutil
import subprocess
import sys

import pytest

import smoke  # noqa: F401  (puts the repository on the path)
from bench.core import device as D
from bench.core import spec
from bench.core.record import Run

ROOT = spec.ROOT
BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys_and_sizes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert len(json.dumps(BENCH)) <= 64 * 1024
    assert 1 <= BENCH["run_seconds"] <= 51
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert not p.endswith("_torch")
    assert len(BENCH["command"]) <= 32
    for word in BENCH["command"]:
        assert 1 <= len(word) <= 200 and "\n" not in word and "\t" not in word
        assert not word.startswith("/") and ".." not in word


def test_check_fits_the_time_allowed():
    # 2 + 14 x 24 runs of run_seconds + 60, 2 x 90 s a cell to compile,
    # 1200 s spare, within 43,200 s
    rs = BENCH["run_seconds"]
    assert (2 + 14 * 24) * (rs + 60) + 24 * 180 + 1200 <= 43200


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end",
                                  "per_layer"])
def test_names_are_unique_and_well_formed(kind):
    names = [e["name"] for e in BENCH[kind]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n


def test_entries_have_just_the_contract_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert len(c["reduced"]) <= 16
        for k in c["reduced"]:
            assert NAME.match(k)
            assert not (k.endswith("_dim") or k.endswith("_rank"))
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
        for w in m.get("workloads", []):
            assert w in CELLS


def test_setup_is_reported_everywhere_and_each_cell_has_metrics():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and "workloads" not in e2e["setup_s"]
    for cell in CELLS:
        mine = [m for m in BENCH["end_to_end"]
                if cell in m.get("workloads", CELLS)]
        assert len(mine) >= 2
        layer = [m for m in BENCH["per_layer"] if cell in m["workloads"]]
        assert layer
        moved = {m["name"] for m in mine}
        for m in layer:
            assert m["moves"] in moved, (cell, m["name"])


def test_per_layer_layers_are_consistent_and_rooflines_named():
    for m in BENCH["per_layer"]:
        assert "\n" not in m["layer"] and 1 <= len(m["layer"]) <= 200
        if "roofline" in m["name"]:
            assert m["name"].split(".")[0].endswith("_roofline_pct") \
                or m["name"].endswith("_roofline")
            assert m["unit"] == "%"
    assert any("mfu" in m["name"] for m in BENCH["per_layer"])


@pytest.mark.parametrize("name", CELLS)
def test_each_cell_loads_its_files_by_name(name):
    c = spec.cell(name)
    cfg_entry = [x for x in BENCH["configs"] if x["name"] == c.config_name][0]
    assert cfg_entry["file"].startswith("bench/configs/")
    assert os.path.exists(os.path.join(ROOT, "bench", "traffic",
                                       c.traffic_name + ".json"))
    assert c.traffic["kind"] in ("serve", "retrain")
    for m in c.metrics:
        if m.applies_to(name):
            assert callable(spec.reader(m.name))


def test_each_config_file_is_its_own_and_states_reductions():
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))
    for c in BENCH["configs"]:
        data = json.load(open(os.path.join(ROOT, c["file"])))
        assert data["name"] == c["name"]
        for k in c["reduced"]:
            assert k in data.get("reduced_from", {}), (c["name"], k)


@pytest.mark.parametrize("name", ["olmo-1b", "olmo-1b-vocab8", "hymba-1.5b"])
def test_model_config_of_each_file_is_as_it_was(name):
    """Each sub-configuration built from the port's type hints gives the
    ModelConfig that naming `ssm` and `global_attn_layers` gave."""
    from repro_torch.configs.base import ModelConfig, SSMConfig
    cfg = json.load(open(os.path.join(ROOT, "bench", "configs",
                                      name + ".json")))
    kw = {k: v for k, v in cfg.items()
          if k in {f.name for f in dataclasses.fields(ModelConfig)}}
    if kw.get("ssm"):
        kw["ssm"] = SSMConfig(**kw["ssm"])
    if "global_attn_layers" in kw:
        kw["global_attn_layers"] = tuple(kw["global_attn_layers"])
    assert D.model_config(cfg) == ModelConfig(**kw)


def test_a_new_cell_is_new_files_and_entries_only(tmp_path):
    """Copy the benchmark, add a configuration, a mix, a cell and a
    metric as new files and new entries, and read them; no file that was
    there changes."""
    root = tmp_path / "repo"
    shutil.copytree(os.path.join(ROOT, "bench"), root / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in (root / "bench").rglob("*")
              if p.is_file()}
    bench = json.loads(json.dumps(BENCH))
    cfg = json.load(open(os.path.join(ROOT, "bench/configs/olmo-1b.json")))
    cfg["name"] = "olmo-1b-copy"
    (root / "bench/configs/olmo-1b-copy.json").write_text(json.dumps(cfg))
    (root / "bench/traffic/stream-query-new.json").write_text(json.dumps(
        dict(json.load(open(os.path.join(
            ROOT, "bench/traffic/stream-query-open.json"))), rate=3.0,
            prompt_len=512)))
    (root / "bench/metrics/queries_done.new.py").write_text(
        "def read(run):\n    return float(len(run.queries))\n")
    bench["configs"].append(dict(bench["configs"][1], name="olmo-1b-copy",
                                 file="bench/configs/olmo-1b-copy.json"))
    bench["workloads"].append({"name": "olmo-1b-copy.burst",
                               "config": "olmo-1b-copy",
                               "traffic": "stream-query-new", "chips": 1,
                               "why": "a test"})
    bench["per_layer"].append({"name": "queries_done.new", "unit": "queries",
                               "better": "higher", "source": "host_clock",
                               "layer": "serving plane",
                               "moves": "query_p95_ms",
                               "workloads": ["olmo-1b-copy.burst"]})
    for m in bench["end_to_end"]:
        if m["name"] == "query_p95_ms":
            m["workloads"].append("olmo-1b-copy.burst")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    c = spec.cell("olmo-1b-copy.burst", root=str(root))
    assert c.config["name"] == "olmo-1b-copy" and c.traffic["rate"] == 3.0
    run = Run(c.name, c.config, c.traffic, setup_s=1.5, window_s=1.0)
    got = spec.read_metrics(c, run, trace=True)
    assert got["queries_done.new"] == {"value": 0.0, "unit": "queries"}
    after = {p: p.read_bytes() for p in before}
    assert after == before


# what the new family's files are asked, run inside the copy of the
# benchmark so that every name resolves to the copy's own files
NEW_FAMILY_CHECKS = """
import dataclasses, json, torch
import smoke
import stub_ops
from bench.core import device as D, readings as R, spec, trace as T
from bench.core import yardstick as Y
from bench.core.record import Run
from bench.reference import model as ref
from repro_torch.configs import smoke_config
from repro_torch.configs.base import MoEConfig

cfg = smoke.config("moe-test")
mc = D.model_config(cfg)
want = dataclasses.replace(smoke_config("qwen3-moe-30b-a3b"), name="moe-test")
rec = T.Recorder()
rec.install()
rec.on = True
stub_ops.scale(torch.ones(1000))
rec.on = False
launches = dict(rec.launches)
rec.uninstall()
run = Run("moe-test.query", cfg, {})
run.peaks = smoke.PEAKS
run.stretch = T.Stretch(wall_s=1.0, busy_s=1.0, launches=launches,
                        kernels={"void stub_scale_kernel<float>": (1, 1e-6)})
c = smoke.cell("moe-test.query")
try:
    Y.decode_flops(dict(cfg, family="bare"), [4])
    bare = None
except NotImplementedError as e:
    bare = str(e)
print(json.dumps({
    "moe": isinstance(mc.moe, MoEConfig), "config": mc == want,
    "configs": smoke.configs(), "smoke_cell": [
        c.config["d_model"], c.traffic["prompt_len"]],
    "hidden": ref.hidden(cfg, {}, torch.zeros(2, 5, dtype=torch.long)
                         ).tolist(),
    "counts": [Y.matmul_params(cfg), Y.forward_flops(cfg, 2, 3),
               Y.decode_flops(cfg, [4, 5])],
    "bare": bare,
    "launches": launches["stub_scale"], "unwrapped": stub_ops.scale(
        torch.ones(2)).tolist(),
    "roofline": R.roofline_pct(run, "stub_scale"),
    "metric": spec.read_metrics(c, run, trace=True),
}))
"""


def test_a_new_family_is_new_files_and_entries_only(tmp_path):
    """Copy the benchmark and add a model family as new files and new
    entries: a configuration with a `moe` sub-configuration (qwen3-moe at
    the port's smoke sizes), its reference family file with its own counts,
    a kernel file wrapping a stub op, a roofline metric of one line, a
    cell, and the smoke files. The port's ModelConfig comes out with a
    MoEConfig, `ref.hidden` and yardstick's counts call the family's file,
    a family file without its counts is refused, the Recorder records the
    stub's launches and `roofline_pct` reads them; no file that was there
    changes."""
    from repro_torch.configs import get_config, smoke_config
    root = tmp_path / "repo"
    shutil.copytree(os.path.join(ROOT, "bench"), root / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in (root / "bench").rglob("*")
              if p.is_file()}
    full = dataclasses.asdict(get_config("qwen3-moe-30b-a3b"))
    tiny = dataclasses.asdict(smoke_config("qwen3-moe-30b-a3b"))
    files = {
        "bench/configs/moe-test.json": json.dumps(
            dict(full, name="moe-test")),
        "bench/tests/smoke/moe-test.json": json.dumps(
            {k: v for k, v in tiny.items()
             if k != "name" and v != full[k]}),
        "bench/tests/smoke/moe-test.query.json": json.dumps(
            {"prompt_len": 12, "rate": 5.0}),
        f"bench/reference/families/{full['family']}.py": (
            "import torch\n"
            "def hidden(cfg, params, tokens, quant=None):\n"
            "    return torch.full((*tokens.shape, cfg['d_model']), 7.0)\n"
            "def matmul_params(cfg):\n"
            "    return 13\n"
            "def forward_flops(cfg, batch, seq, logit_rows=None):\n"
            "    return 11.0 * batch * seq\n"
            "def decode_flops(cfg, positions):\n"
            "    return 3.0 * sum(positions)\n"),
        "bench/reference/families/bare.py": (
            "def hidden(cfg, params, tokens, quant=None):\n"
            "    return tokens\n"),
        "bench/kernels/stub_scale.py": (
            "TARGET = 'stub_ops:scale'\n"
            "DEVICE_NAMES = ('stub_scale_kernel',)\n"
            "def record(args, kwargs):\n"
            "    return [args[0].numel(), args[0].element_size()]\n"
            "def cost(rec, peaks):\n"
            "    n, size = rec\n"
            "    return 2 * n * size, n, peaks['fp32']\n"),
        "bench/metrics/stub_roofline_pct.p95.py": (
            "from bench.core.readings import roofline; "
            "read = roofline('stub_scale')\n"),
        "stub_ops.py": "def scale(x, *, by=2.0):\n    return x * by\n",
    }
    for name, text in files.items():
        (root / name).write_text(text)
    bench = json.loads(json.dumps(BENCH))
    bench["configs"].append({"name": "moe-test", "source": "a test",
                             "file": "bench/configs/moe-test.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "moe-test.query", "config": "moe-test",
                               "traffic": "stream-query-open", "chips": 1,
                               "why": "a test"})
    bench["per_layer"].append({"name": "stub_roofline_pct.p95", "unit": "%",
                               "better": "higher", "source": "device_trace",
                               "layer": "kernels", "moves": "query_p95_ms",
                               "workloads": ["moe-test.query"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(root), str(root / "bench" / "tests"),
         os.path.join(ROOT, "src")]))
    p = subprocess.run([sys.executable, "-c", NEW_FAMILY_CHECKS],
                       cwd=root, env=env, capture_output=True, text=True,
                       timeout=300)
    assert p.returncode == 0, p.stderr[-4000:]
    got = json.loads(p.stdout.strip().splitlines()[-1])
    assert got["moe"] and got["config"]
    assert "moe-test" in got["configs"]
    assert got["smoke_cell"] == [tiny["d_model"], 12]
    assert got["hidden"] == [[[7.0] * tiny["d_model"]] * 5] * 2
    assert got["counts"] == [13, 66.0, 27.0]
    assert "defines no decode_flops" in got["bare"]
    assert got["launches"] == [[1000, 4]] and got["unwrapped"] == [2.0, 2.0]
    # 8000 bytes over 3.35e12 B/s against 1000 operations over 67e12
    share = 100.0 * max(8000 / 3.35e12, 1000 / 67e12) / 1e-6
    assert got["roofline"] == pytest.approx(share)
    assert got["metric"] == {"stub_roofline_pct.p95": {
        "value": got["roofline"], "unit": "%"}}
    after = {p: p.read_bytes() for p in before}
    assert after == before
