"""Metered job placement on a zoo of model classes, and the bf16
precision policy, in the port against the live JAX controller: the
golden drift_wave scenario under ecco with the two tiers of the
reference's heterogeneity benchmark (zoo-big, the primary engine, and
zoo-small; `repro_torch.testing.trace.zoo_tiers`), fp32
compute from each tier's reference `fresh_state(0)`, bridged, both
packages pricing with one table of fixed seconds (zoo-small at a
quarter of zoo-big), invariants on.

  * fp32 screens: every new job's tier, groups, events, shares, notes,
    `roofline` reports and accuracies equal (floats at zero tolerance,
    bandwidth within 1e-5 relative).
  * `job_precision="bf16"` with an fp32 rescore margin of 0.2: tiers,
    groups, events, the rescores' decisions, shares, `roofline` reports
    equal, bandwidth within 1e-5 relative. The bf16 screens' accuracies
    are the two packages' bf16 forwards, whose roundings differ (XLA's
    CPU backend computes in f32 between converts, PyTorch rounds each
    op), so a screen can differ by an argmax flip of its 496 positions
    (0.002 a flip): held within ACC_BF16, two flips and the record's
    rounding. Measured on the CPU at margins 0.2, 0.1 and 0.05: one flip
    (0.002), shares and bandwidth equal.
"""
import copy

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402

from repro.configs import smoke_config as jsmoke_config  # noqa: E402
from repro.configs.base import TrainConfig as JTrainConfig  # noqa: E402
from repro.testing import trace as JT  # noqa: E402
from repro.testing.invariants import InvariantChecker as JChecker  # noqa
from repro_torch.configs.base import TrainConfig  # noqa: E402
from repro_torch.testing import trace as T  # noqa: E402
from repro_torch.testing.trace import FixedTable  # noqa: E402
from repro_torch.testing.invariants import InvariantChecker  # noqa: E402
from test_torch_window_hostile import (BW_RTOL, FP32,  # noqa: E402
                                       _same_float)

ACC_BF16 = 2 / 496 + 1e-4
SCALE = {"zoo-small": 0.25}
# zoo-big's micro-window costs 2 x 1.0 + 2 x 0.25 = 2.5 s, zoo-small's
# 0.625: a budget of 12 gives the first job 12 / 4 = 3 s (zoo-big) and
# every later one at most 1.5 s (zoo-small)
BUDGET = 12.0


@pytest.fixture(scope="module")
def engines():
    jengs = [JT.SharedEngine(c, JTrainConfig(**FP32))
             for c in T.zoo_tiers(jsmoke_config("olmo-1b"))]
    tengs = [T.SharedEngine(
        c, TrainConfig(**FP32), device="cpu",
        init_params={0: jax.tree.map(np.asarray,
                                     je.fresh_state(0)["params"])})
        for c, je in zip(T.zoo_tiers(), jengs)]
    return jengs, tengs


def run_zoo(mod, checker, engines, **kw):
    """ecco over the golden scenario with engines[0] primary and the rest
    its zoo; returns (controller, trace, each canonical job's tier)."""
    scenario = copy.deepcopy(mod.golden_scenario())
    cc_kw = dict(window_seconds=scenario.window_seconds,
                 shared_bandwidth=scenario.shared_bandwidth,
                 local_caps=scenario.local_caps)
    cc_kw.update(mod.GOLDEN_CONTROLLER)
    cc_kw.update(kw)
    ctl = mod.FRAMEWORKS["ecco"](engines[0], list(scenario.streams),
                                 mod.ControllerConfig(**cc_kw), seed=0,
                                 zoo=list(engines[1:]))
    ctl.warmup()
    chk = checker(bank_exact=False, label="zoo")
    trace, names, tier = {"windows": []}, {}, {}
    for _ in range(scenario.windows):
        chk.before_window(ctl)
        n = len(ctl.grouper.events)
        wm = ctl.run_window()
        events = ctl.grouper.events[n:]
        chk.after_window(ctl, wm, events)
        trace["windows"].append(mod._window_record(ctl, wm, events, names))
        # a comprehension: a loop variable would keep a job that dies in
        # the next window alive through that window's invariant check
        tier.update({mod._canon(names, j.job_id): j.engine.cfg.name
                     for j in ctl.jobs})
    return ctl, trace, tier


def _both(engines, **kw):
    jengs, tengs = engines
    kw = dict(roofline_budget=BUDGET, cost_table=FixedTable(SCALE), **kw)
    return (run_zoo(T, InvariantChecker, tengs, **kw),
            run_zoo(JT, JChecker, jengs, **kw))


@pytest.fixture(scope="module")
def fp32_runs(engines):
    return _both(engines)


def test_zoo_placement_matches_reference(engines, fp32_runs):
    (tctl, ttrace, ttier), (jctl, jtrace, jtier) = fp32_runs
    assert ttier == jtier
    assert set(ttier.values()) == {"zoo-big", "zoo-small"}
    assert ttier["g0"] == "zoo-big"        # the first job's fair share
    assert T.compare(ttrace, jtrace, drift_atol=0.0, share_atol=0.0,
                     bw_rtol=BW_RTOL, acc_atol=0.0) == []
    for tw, jw in zip(tctl.history, jctl.history):
        assert tw.roofline == jw.roofline
        assert all(_same_float(a, jw.per_stream_acc[s])
                   for s, a in tw.per_stream_acc.items())
    # one batched metrics call per model class, each on its own bank
    _, tengs = engines
    assert {j.engine for j in tctl.jobs} <= set(tengs)


def test_zoo_tier_of_each_new_job(fp32_runs):
    """`_pick_engine` in both packages at each fleet size: the costliest
    tier whose micro-window fits budget / (window_micro * (jobs + 1))."""
    (tctl, _, _), (jctl, _, _) = fp32_runs
    jobs = (list(tctl.jobs), list(jctl.jobs))
    for n in range(6):
        tctl.jobs[:] = [None] * n
        jctl.jobs[:] = [None] * n
        assert tctl._pick_engine().cfg.name == \
            jctl._pick_engine().cfg.name == \
            ("zoo-big" if n == 0 else "zoo-small")
    tctl.jobs[:], jctl.jobs[:] = jobs
    assert tctl._micro_seconds(tctl.engine.cfg, "fp32") == \
        jctl._micro_seconds(jctl.engine.cfg, "fp32") == 2.5


def test_bf16_screens_with_fp32_rescore_match_reference(engines):
    (tctl, ttrace, ttier), (jctl, jtrace, jtier) = _both(
        engines, job_precision="bf16", rescore_margin=0.2)
    assert ttier == jtier
    assert all(j.precision == "bf16" for j in tctl.jobs)
    assert tctl.grouper.rescores > 0
    for tw, jw in zip(ttrace["windows"], jtrace["windows"]):
        assert tw["groups"] == jw["groups"]
        assert tw["events"] == jw["events"]
    for tw, jw in zip(tctl.history, jctl.history):
        assert tw.roofline == jw.roofline
    assert T.compare(ttrace, jtrace, drift_atol=0.0, share_atol=0.0,
                     bw_rtol=BW_RTOL, acc_atol=ACC_BF16) == []
