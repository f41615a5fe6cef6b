"""ECCO's window loop in the port against the JAX package's, live, on the
hostile scenarios (`HOSTILE_SCENARIOS`): a cohort join storm
(flash_crowd_10k), a correlated region blackout (sensor_blackout), drift
that flips every window (oscillating_drift) and a ~100x bandwidth
collapse (bandwidth_collapse), each at the size of its golden
(`HOSTILE_GOLDEN`: 4 windows, flash_crowd_10k with 6 joiners) under
ecco, naive, ekya and recl. Both packages run in fp32 compute from the
reference's `fresh_state(0)`, bridged, with the invariants checked on
every window in both.

Held as in tests/test_torch_window.py: group memberships, grouping
events, drift scores and triggers, delivered tokens and request times
exactly; every per-stream accuracy and GPU share equal as a float; the
realized bandwidth within 1e-5 relative (GAIMD's window means,
tests/test_torch_gaimd.py); `compare` at zero tolerance but bandwidth's.

This file holds flash_crowd_10k and sensor_blackout; the drift and
bandwidth scenarios are tests/test_torch_window_hostile_drift.py, which
reuses the helpers here (the two files keep each worker's share short).
"""
import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402

from repro.configs.base import TrainConfig as JTrainConfig  # noqa: E402
from repro.testing import trace as JT  # noqa: E402
from repro_torch.configs.base import TrainConfig  # noqa: E402
from repro_torch.testing import trace as T  # noqa: E402

FP32 = dict(learning_rate=1e-3, b2=0.999, weight_decay=0.0, warmup_steps=5,
            total_steps=100000, remat="none", compute_dtype="float32")
BW_RTOL = 1e-5


def make_engines():
    """The JAX engine and the port's, both fp32, the port's jobs starting
    from the JAX engine's `fresh_state(0)` parameters."""
    scenario = JT.golden_scenario()
    jcfg = dataclasses.replace(JT.smoke_config("olmo-1b"),
                               vocab_size=scenario.bank.vocab)
    jeng = JT.SharedEngine(jcfg, JTrainConfig(**FP32))
    init = jax.tree.map(np.asarray, jeng.fresh_state(0)["params"])
    teng = T.make_engine_for(T.golden_scenario(), tcfg=TrainConfig(**FP32),
                             init_params={0: init}, device="cpu")
    return jeng, teng


@pytest.fixture(scope="module")
def engines():
    return make_engines()


def _run(mod, name, framework, engine, **kw):
    trace = {}
    ctl = mod.run_scenario(framework, mod.hostile_scenario(name),
                           engine=engine, seed=0, trace=trace,
                           **dict(mod.hostile_controller_kwargs(name), **kw))
    return ctl, trace


def _canon_ids(ctl):
    """Job ids renamed in order of first appearance over the history."""
    names = {}
    for wm in ctl.history:
        for jid in list(wm.groups) + list(wm.shares):
            names.setdefault(jid, f"g{len(names)}")
    return names


def _same_float(a, b):
    return (math.isnan(a) and math.isnan(b)) or a == b


def check_hostile(name, framework, engines):
    """Run `name` under `framework` in both packages and hold the port's
    windows to the reference's."""
    jeng, teng = engines
    windows = T.HOSTILE_GOLDEN[name]["scenario"]["windows"]
    jctl, jtrace = _run(JT, name, framework, jeng)
    tctl, ttrace = _run(T, name, framework, teng, device="cpu")
    assert tctl.invariant_windows == jctl.invariant_windows == windows
    assert T.compare(ttrace, jtrace, drift_atol=0.0, share_atol=0.0,
                     bw_rtol=BW_RTOL, acc_atol=0.0) == []
    jn, tn = _canon_ids(jctl), _canon_ids(tctl)
    assert len(tctl.history) == len(jctl.history) == windows
    for w, (tw, jw) in enumerate(zip(tctl.history, jctl.history)):
        at = f"{name}/{framework} window {w}"
        assert tw.t == jw.t, at
        assert {tn[k]: v for k, v in tw.groups.items()} == \
            {jn[k]: v for k, v in jw.groups.items()}, at
        assert list(tw.per_stream_acc) == list(jw.per_stream_acc), at
        for sid, a in tw.per_stream_acc.items():
            assert type(a) is float, (at, sid)
            assert _same_float(a, jw.per_stream_acc[sid]), (at, sid)
        assert [(tn[k], v) for k, v in tw.shares.items()] == \
            [(jn[k], v) for k, v in jw.shares.items()], at
        assert tw.delivered == jw.delivered, at
        assert list(tw.bandwidth) == list(jw.bandwidth), at
        np.testing.assert_allclose(list(tw.bandwidth.values()),
                                   list(jw.bandwidth.values()),
                                   rtol=BW_RTOL, atol=0, err_msg=at)
    assert tctl.fleet.stream_ids == jctl.fleet.stream_ids
    for sid in tctl.fleet.stream_ids:
        assert tctl.fleet.score(sid) == jctl.fleet.score(sid), sid
    assert tctl.request_time == jctl.request_time
    assert [(e["kind"], e["stream"]) for e in tctl.grouper.events] == \
        [(e["kind"], e["stream"]) for e in jctl.grouper.events]
    assert tctl.mean_accuracy(windows) == jctl.mean_accuracy(windows)
    return tctl, jctl


@pytest.mark.parametrize("framework", T.GOLDEN_FRAMEWORKS)
@pytest.mark.parametrize("name", ["flash_crowd_10k", "sensor_blackout"])
def test_hostile_window_loop_matches_reference_fp32(name, framework,
                                                     engines):
    tctl, _ = check_hostile(name, framework, engines)
    if name == "flash_crowd_10k":
        # the storm's joiners are in the fleet and drift-scored
        assert sum("crowd" in s for s in tctl.fleet.stream_ids) == \
            T.HOSTILE_GOLDEN[name]["scenario"]["joiners"]
