"""BENCHMARK.json and the files it names: each cell, configuration, mix
and metric is found by name, a new one is only new files and entries, and
every name, unit and limit keeps to the benchmark's contract."""
from __future__ import annotations

import json
import os
import re
import shutil

import pytest

import smoke  # noqa: F401  (puts the repository on the path)
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
    (root / "bench/traffic/stream-query-burst.json").write_text(json.dumps(
        dict(json.load(open(os.path.join(
            ROOT, "bench/traffic/stream-query-open.json"))), rate=3.0,
            prompt_len=512)))
    (root / "bench/metrics/queries_done.new.py").write_text(
        "def read(run):\n    return float(len(run.queries))\n")
    bench["configs"].append(dict(bench["configs"][1], name="olmo-1b-copy",
                                 file="bench/configs/olmo-1b-copy.json"))
    bench["workloads"].append({"name": "olmo-1b-copy.burst",
                               "config": "olmo-1b-copy",
                               "traffic": "stream-query-burst", "chips": 1,
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
