"""Golden-trace harness: run a scenario, serialize a compact behavior
trace, compare against the JAX package's checked-in goldens. Ported
from its `testing/trace.py`; the port reads the goldens as plain JSON
and never writes them (no `--regen`).

A trace captures, per window: every stream's drift score, the group
memberships, the GPU shares, the realized bandwidth, the per-stream
accuracy, and the grouping events (join/new/evict) — the full observable
decision surface of the controller.

Job ids are canonicalized ("g0", "g1", ... in order of first
appearance): `RetrainJob` draws ids from a process-global counter, so
raw ids depend on what ran before in the process.

Comparison policy (`compare`): structure — window count, stream sets,
group memberships, grouping events — must match EXACTLY; float fields
(drift scores, shares, bandwidth, accuracy) match within per-field
tolerances, because model-training floats wobble across builds while
the decisions they drive are pinned by the structural fields.

The goldens were trained from the JAX package's initial weights: an
engine held to them is built with `init_params` (the reference's
`fresh_state(0)` parameters, e.g. from
tests/fixtures/golden_engine_init.npz, which
tools/export_reference_init.py writes).

`run_scenario` drives `repro_torch.testing.invariants.InvariantChecker`
on every window by default.

Check the port against the goldens (on the card unless --device cpu):

    PYTHONPATH=src python -m repro_torch.testing.trace --check tests/golden \
        --init tests/fixtures/golden_engine_init.npz
"""
from __future__ import annotations

import copy
import dataclasses
import json
import math
import os
from typing import Dict, List, Optional

from repro_torch.configs import smoke_config
from repro_torch.configs.base import TrainConfig
from repro_torch.core.baselines import FRAMEWORKS
from repro_torch.core.controller import ControllerConfig
from repro_torch.core.trainer import SharedEngine
from repro_torch.core.transmission import ProfileTable
from repro_torch.data.scenarios import (HOSTILE_SCENARIOS, FleetScenario,
                                        build_scenario)
from repro_torch.models.convert import load_params_npz
from repro_torch.testing.invariants import InvariantChecker


def make_engine_for(scenario: FleetScenario, arch: str = "olmo-1b", *,
                    tcfg: Optional[TrainConfig] = None, init_params=None,
                    device="cuda") -> SharedEngine:
    """The smoke-width `arch` engine with the scenario's vocabulary.
    `init_params` ({seed: numpy params}) starts its jobs from given
    weights (see `SharedEngine`)."""
    cfg = dataclasses.replace(smoke_config(arch),
                              vocab_size=scenario.bank.vocab)
    return SharedEngine(cfg, tcfg, init_params=init_params, device=device)


def run_scenario(framework: str, scenario: FleetScenario, *,
                 engine: Optional[SharedEngine] = None,
                 windows: Optional[int] = None, seed: int = 0,
                 trace: Optional[dict] = None, invariants: bool = True,
                 device="cuda", **cc_overrides):
    """Run `framework` over `scenario` (churn and bandwidth events
    applied at window boundaries). Pass `trace={}` to also fill it
    with the golden-trace record. Returns the controller.

    The scenario is deep-copied first (streams carry live rng state
    and churn events carry Stream objects the controller consumes), so
    one built scenario can be run repeatedly — under several
    frameworks, say — and every run sees the identical fleet.

    `invariants`: check the window-level fleet laws
    (repro_torch.testing.invariants) around every window; an
    InvariantViolation names the window and the broken contract.
    Timing runs pass False (the bank check drains the GC per window).
    `device` places the engine built when `engine` is None."""
    own_engine = engine is None
    engine = engine or make_engine_for(scenario, device=device)
    scenario = copy.deepcopy(scenario)      # bank is shared via memo
    windows = scenario.windows if windows is None else windows
    cc_kw = dict(window_seconds=scenario.window_seconds,
                 shared_bandwidth=scenario.shared_bandwidth,
                 local_caps=scenario.local_caps)
    if getattr(scenario, "profile", None):
        cc_kw["profile_table"] = ProfileTable.from_spec(scenario.profile)
    cc_kw.update(cc_overrides)
    cc = ControllerConfig(**cc_kw)
    ctl = FRAMEWORKS[framework](engine, list(scenario.streams), cc,
                                seed=seed)
    ctl.warmup()
    checker = (InvariantChecker(bank_exact=own_engine,
                                label=f"{scenario.name}/{framework}")
               if invariants else None)
    if trace is not None:
        trace.update({"meta": {"scenario": scenario.name,
                               "scenario_seed": scenario.seed,
                               "framework": framework, "seed": seed,
                               "windows": windows},
                      "windows": []})
    jobname: Dict[str, str] = {}
    for w in range(windows):
        churned = set()
        for ev in scenario.events_at(w):
            if ev.kind == "join" and ev.stream is not None:
                live = {s.stream_id for s in ctl.streams}
                if ev.stream_id in live:
                    # a silent re-add would overwrite the stream's
                    # detector/transmission rows and leak its old job
                    # membership; hostile generators minting duplicate
                    # ids must fail loudly
                    raise ValueError(
                        f"scenario {scenario.name!r}: ChurnEvent joins "
                        f"stream {ev.stream_id!r} at window {w} but it "
                        f"is already live")
                ctl.add_stream(ev.stream)
                churned.add(ev.stream_id)
            elif ev.kind == "leave":
                ctl.remove_stream(ev.stream_id)
                churned.add(ev.stream_id)
        for be in scenario.bandwidth_events_at(w):
            if be.shared_bandwidth is not None:
                ctl.cc.shared_bandwidth = float(be.shared_bandwidth)
            if be.local_caps is not None:
                ctl.cc.local_caps = dict(be.local_caps)
        if checker is not None:
            checker.before_window(ctl, churned)
        n_events = len(ctl.grouper.events)
        wm = ctl.run_window()
        events = ctl.grouper.events[n_events:]
        if checker is not None:
            checker.after_window(ctl, wm, events)
        if trace is not None:
            trace["windows"].append(_window_record(
                ctl, wm, events, jobname))
    if checker is not None:
        # how many windows ran checked
        ctl.invariant_windows = checker.windows_checked
    return ctl


# -- trace records -----------------------------------------------------------
def _canon(jobname: Dict[str, str], job_id: str) -> str:
    if job_id not in jobname:
        jobname[job_id] = f"g{len(jobname)}"
    return jobname[job_id]


def _round(x, nd: int):
    v = float(x)
    return None if math.isnan(v) else round(v, nd)


def _window_record(ctl, wm, events, jobname: Dict[str, str]) -> dict:
    drift = {sid: _round(ctl.fleet.score(sid), 6)
             for sid in sorted(ctl.fleet.stream_ids)}
    groups = {_canon(jobname, jid): sorted(members)
              for jid, members in wm.groups.items()}
    shares = {_canon(jobname, jid): _round(v, 6)
              for jid, v in wm.shares.items()}
    bw = {sid: _round(v, 4) for sid, v in sorted(wm.bandwidth.items())}
    acc = {sid: _round(v, 4) for sid, v in sorted(wm.per_stream_acc.items())}
    evs = [{"kind": e["kind"], "stream": e["stream"],
            "job": _canon(jobname, e["job"])} for e in events]
    return {"t": wm.t, "drift": drift, "groups": groups, "shares": shares,
            "bandwidth": bw, "acc": acc, "events": evs}


def save_trace(trace: dict, path: str):
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(trace, f, indent=1, sort_keys=True)
        f.write("\n")


def load_trace(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


# -- comparison --------------------------------------------------------------
def _cmp_floats(diffs, where, a: dict, b: dict, atol: float,
                rtol: float = 0.0):
    if set(a) != set(b):
        diffs.append(f"{where}: key sets differ {sorted(a)} vs {sorted(b)}")
        return
    for k in a:
        x, y = a[k], b[k]
        if (x is None) != (y is None):
            diffs.append(f"{where}[{k}]: {x} vs {y}")
        elif x is not None and abs(x - y) > atol + rtol * abs(y):
            diffs.append(f"{where}[{k}]: {x} vs {y}")


def compare(got: dict, want: dict, *, drift_atol: float = 1e-4,
            share_atol: float = 5e-3, bw_rtol: float = 5e-3,
            acc_atol: float = 0.08) -> List[str]:
    """Diff two traces. Returns [] when `got` matches `want`; otherwise
    human-readable difference lines. Structure is exact; floats are
    toleranced (see module docstring)."""
    diffs: List[str] = []
    if got.get("meta") != want.get("meta"):
        diffs.append(f"meta: {got.get('meta')} vs {want.get('meta')}")
    gw, ww = got.get("windows", []), want.get("windows", [])
    if len(gw) != len(ww):
        diffs.append(f"window count: {len(gw)} vs {len(ww)}")
    for i, (g, w) in enumerate(zip(gw, ww)):
        at = f"window[{i}]"
        if g["t"] != w["t"]:
            diffs.append(f"{at}.t: {g['t']} vs {w['t']}")
        if g["groups"] != w["groups"]:
            diffs.append(f"{at}.groups: {g['groups']} vs {w['groups']}")
        if g["events"] != w["events"]:
            diffs.append(f"{at}.events: {g['events']} vs {w['events']}")
        _cmp_floats(diffs, f"{at}.drift", g["drift"], w["drift"],
                    drift_atol)
        _cmp_floats(diffs, f"{at}.shares", g["shares"], w["shares"],
                    share_atol)
        _cmp_floats(diffs, f"{at}.bandwidth", g["bandwidth"],
                    w["bandwidth"], 1e-6, bw_rtol)
        _cmp_floats(diffs, f"{at}.acc", g["acc"], w["acc"], acc_atol)
    return diffs


# -- golden registry ---------------------------------------------------------
# One fixed-seed scenario run per framework. Sized for tier-1: a tiny
# drift_wave fleet (2 regions x 2 streams), 3 windows, reduced training.
GOLDEN_SCENARIO = dict(name="drift_wave", seed=0, regions=2,
                       streams_per_region=2, wave_start=5.0,
                       wave_step=10.0, windows=3)
GOLDEN_CONTROLLER = dict(window_micro=4, micro_steps=2, train_batch=8,
                         sample_rate=8, p_drop=0.5, shared_bandwidth=96.0)
GOLDEN_FRAMEWORKS = ("ecco", "naive", "ekya", "recl")


def golden_scenario() -> FleetScenario:
    kw = dict(GOLDEN_SCENARIO)
    return build_scenario(kw.pop("name"), **kw)


def golden_trace(framework: str, engine: Optional[SharedEngine] = None,
                 *, device="cuda", **cc_overrides) -> dict:
    """One benign golden run (invariants ON) -> its trace record.
    `cc_overrides` change the controller config beyond the golden one
    (e.g. drift_impl="auto", shortlist_k=2 on the card)."""
    scenario = golden_scenario()
    trace: dict = {}
    run_scenario(framework, scenario, engine=engine, seed=0, trace=trace,
                 device=device, **dict(GOLDEN_CONTROLLER, **cc_overrides))
    return trace


# Hostile-scenario goldens: each of the four adversarial workloads pinned per framework at smoke scale — small
# fleets, short horizons (tier-1 runs all of these), but the same
# failure boundaries: a cohort join storm, a correlated region
# blackout, per-window drift flips, a ~100x bandwidth collapse.
# Files land as trace_<scenario>_<framework>.json.
HOSTILE_GOLDEN: Dict[str, dict] = {
    "flash_crowd_10k": dict(
        scenario=dict(seed=0, joiners=6, base_regions=1,
                      streams_per_region=2, join_window=1, windows=4),
        # shortlist caps the grouper's eval fan-out exactly where the
        # full-scale crowd needs it
        controller=dict(shortlist_k=2)),
    "sensor_blackout": dict(
        scenario=dict(seed=0, regions=2, streams_per_region=2,
                      switch_time=5.0, blackout_window=2, windows=4)),
    "oscillating_drift": dict(
        scenario=dict(seed=0, regions=2, streams_per_region=2,
                      windows=4)),
    "bandwidth_collapse": dict(
        scenario=dict(seed=0, regions=2, streams_per_region=2,
                      collapse_window=2, windows=4),
        # the scenario owns the caps (collapse events rewrite them
        # mid-run) — don't let GOLDEN_CONTROLLER's bottleneck win
        controller=dict(shared_bandwidth=None)),
}
assert set(HOSTILE_GOLDEN) == set(HOSTILE_SCENARIOS)


def hostile_scenario(name: str) -> FleetScenario:
    return build_scenario(name, **HOSTILE_GOLDEN[name]["scenario"])


def hostile_controller_kwargs(name: str) -> dict:
    kw = dict(GOLDEN_CONTROLLER)
    kw.update(HOSTILE_GOLDEN[name].get("controller", {}))
    return {k: v for k, v in kw.items() if v is not None}


def hostile_trace(name: str, framework: str,
                  engine: Optional[SharedEngine] = None, *,
                  device="cuda") -> dict:
    """One hostile scenario run (invariants ON) -> its trace record."""
    trace: dict = {}
    run_scenario(framework, hostile_scenario(name), engine=engine,
                 seed=0, trace=trace, device=device,
                 **hostile_controller_kwargs(name))
    return trace


# Metered windows held apart from any cost counter: one duck-typed table
# of fixed seconds (`cc.cost_table`), and the two model classes of the
# reference's heterogeneity benchmark (benchmarks/bench_heterogeneity.py)
# as a zoo, zoo-big the primary engine.
class FixedTable:
    """Fixed modeled seconds per (config name, kind), scaled per config
    name by `scale`; bf16 at half."""
    SEC = {"train": 1.0, "eval": 0.25, "prefill": 0.5, "decode": 0.05}

    def __init__(self, scale: Optional[Dict[str, float]] = None):
        self.scale = dict(scale or {})

    def seconds(self, cfg, *, batch, seq, kind, precision="fp32"):
        s = self.SEC[kind] * self.scale.get(cfg.name, 1.0)
        return s * (0.5 if precision == "bf16" else 1.0)


def zoo_tiers(base=None):
    """(zoo-big, zoo-small) from `base`, the smoke olmo-1b config (this
    package's by default; any ModelConfig dataclass with its fields)."""
    base = smoke_config("olmo-1b") if base is None else base
    big = dataclasses.replace(base, name="zoo-big", vocab_size=64,
                              d_model=128, d_ff=512, num_heads=8,
                              num_kv_heads=8, num_layers=4)
    small = dataclasses.replace(base, name="zoo-small", vocab_size=64,
                                d_model=64, d_ff=256, num_heads=4,
                                num_kv_heads=4, num_layers=2)
    return big, small


def golden_path(dirpath: str, framework: str,
                scenario: Optional[str] = None) -> str:
    """Golden file path; `scenario=None` is the benign drift_wave
    golden (seed layout), a name is one of the hostile goldens."""
    stem = (f"trace_{framework}" if scenario is None
            else f"trace_{scenario}_{framework}")
    return os.path.join(dirpath, f"{stem}.json")


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--check", metavar="DIR", required=True,
                    help="run every golden scenario and diff against the "
                         "goldens in DIR")
    ap.add_argument("--init", metavar="NPZ",
                    help="the reference's fresh_state(0) parameters "
                         "(without them jobs start from the port's own "
                         "initialisation, and the goldens cannot match)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    init = ({0: load_params_npz(args.init)} if args.init else None)
    engine = make_engine_for(golden_scenario(), init_params=init,
                             device=args.device)
    bad = 0
    runs = [(None, fw) for fw in GOLDEN_FRAMEWORKS] + \
        [(name, fw) for name in HOSTILE_SCENARIOS
         for fw in GOLDEN_FRAMEWORKS]
    for name, fw in runs:
        got = (golden_trace(fw, engine) if name is None
               else hostile_trace(name, fw, engine))
        diffs = compare(got, load_trace(
            golden_path(args.check, fw, scenario=name)))
        label = fw if name is None else f"{name}/{fw}"
        status = "ok" if not diffs else f"{len(diffs)} diffs"
        print(f"{label}: {status}")
        for d in diffs:
            print(f"  {d}")
        bad += bool(diffs)
    raise SystemExit(1 if bad else 0)


if __name__ == "__main__":
    main()
