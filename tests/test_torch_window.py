"""ECCO's window loop in the port against the JAX package's, live, in one
process: the golden drift_wave scenario and controller under ecco, naive,
ekya and recl, both packages in fp32 compute from the same initial
weights (the reference's `fresh_state(0)`, bridged), invariants checked
on every window in both.

Held: group memberships and grouping events exactly, drift scores and
triggers exactly, every per-stream accuracy and GPU share equal as a
float (they feed Alg. 1 and the grouper's thresholds), delivered tokens
equal, realized bandwidth within 1e-5 relative (GAIMD's window means,
tests/test_torch_gaimd.py). The default bf16 compute is held to the
checked-in goldens in tests/test_torch_window_golden.py.
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


@pytest.fixture(scope="module")
def engines():
    scenario = JT.golden_scenario()
    jcfg = dataclasses.replace(JT.smoke_config("olmo-1b"),
                               vocab_size=scenario.bank.vocab)
    jeng = JT.SharedEngine(jcfg, JTrainConfig(**FP32))
    init = jax.tree.map(np.asarray, jeng.fresh_state(0)["params"])
    teng = T.make_engine_for(T.golden_scenario(), tcfg=TrainConfig(**FP32),
                             init_params={0: init}, device="cpu")
    return jeng, teng


def _run(mod, framework, engine, **kw):
    trace = {}
    ctl = mod.run_scenario(framework, mod.golden_scenario(), engine=engine,
                           seed=0, trace=trace,
                           **dict(mod.GOLDEN_CONTROLLER, **kw))
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


@pytest.mark.parametrize("framework", T.GOLDEN_FRAMEWORKS)
def test_window_loop_matches_reference_fp32(framework, engines):
    jeng, teng = engines
    jctl, jtrace = _run(JT, framework, jeng)
    tctl, ttrace = _run(T, framework, teng, device="cpu")
    assert tctl.invariant_windows == jctl.invariant_windows == 3
    # the trace: structure and drift exact, floats at zero tolerance but
    # bandwidth's
    assert T.compare(ttrace, jtrace, drift_atol=0.0, share_atol=0.0,
                     bw_rtol=BW_RTOL, acc_atol=0.0) == []
    # and the raw window metrics behind it
    jn, tn = _canon_ids(jctl), _canon_ids(tctl)
    assert len(tctl.history) == len(jctl.history)
    for w, (tw, jw) in enumerate(zip(tctl.history, jctl.history)):
        at = f"window {w}"
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
    for sid in tctl.fleet.stream_ids:
        assert tctl.fleet.score(sid) == jctl.fleet.score(sid)
    assert tctl.request_time == jctl.request_time
    assert [(e["kind"], e["stream"]) for e in tctl.grouper.events] == \
        [(e["kind"], e["stream"]) for e in jctl.grouper.events]
    assert tctl.mean_accuracy(3) == jctl.mean_accuracy(3)
    assert tctl.response_times(0.3) == jctl.response_times(0.3)
