"""The port's span record (`repro_torch.tracing`): the tracer itself, then
the spans the program records at smoke width on the CPU — a retraining
window's six steps under one `ecco.window`, one `ecco.eval` per eval
forward, the train step's gradients and update once per step, and on the
serving plane each query's wait in the queue, the batched prefills that
admitted it and one `ecco.tick` per logged tick — and that a window's
decisions and the served tokens are the same with tracing on and off."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch import tracing  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.core.controller import (ControllerConfig,  # noqa: E402
                                         ECCOController)
from repro_torch.core.trainer import SharedEngine  # noqa: E402
from repro_torch.data.streams import make_fleet  # noqa: E402
from repro_torch.serve.plane import FleetServePlane, ServeConfig  # noqa: E402

VOCAB = 64
STEPS = ["drift", "transmit", "alloc", "regroup", "metrics", "serve"]


@pytest.fixture(autouse=True)
def _tracer_off():
    tracing.disable()
    tracing.collect()
    yield
    tracing.disable()
    tracing.collect()


@pytest.fixture(scope="module")
def engine():
    cfg = dataclasses.replace(smoke_config("olmo-1b"), vocab_size=VOCAB)
    return SharedEngine(cfg, device="cpu")


# -- the tracer -----------------------------------------------------------

def test_off_records_nothing_and_returns_the_shared_null():
    assert not tracing.enabled()
    a, b = tracing.span("a", x=1), tracing.span("b", device=True)
    assert a is b
    with a:
        tracing.begin("q", "r0")
        tracing.end("q", "r0")
    assert tracing.collect() == []


def test_nesting_sets_parents():
    tracing.enable()
    with tracing.span("outer", k=1):
        with tracing.span("inner"):
            pass
        with tracing.span("inner"):
            pass
    got = tracing.collect()
    assert [s.name for s in got] == ["inner", "inner", "outer"]
    outer = got[-1]
    assert outer.parent is None and outer.attrs == {"k": 1}
    assert [s.parent for s in got[:2]] == [outer.id, outer.id]
    assert len({s.id for s in got}) == 3
    for s in got:
        assert outer.start <= s.start <= s.end <= outer.end
        assert s.seconds == s.end - s.start


def test_begin_and_end_pair_by_key():
    tracing.enable()
    tracing.begin("wait", "r1", a=1)
    tracing.begin("wait", "r2")
    with tracing.span("work"):
        tracing.end("wait", "r2", dropped=True)
    tracing.end("wait", "r1")
    tracing.end("wait", "never-begun")
    got = {s.attrs.get("dropped", False): s for s in tracing.collect()
           if s.name == "wait"}
    assert set(got) == {False, True}
    assert got[False].attrs == {"key": "r1", "a": 1}
    assert got[True].attrs == {"key": "r2", "dropped": True}
    # a wait is not inside the span open when it ends
    assert got[True].parent is None
    assert got[True].start < got[False].end


def test_collect_clears():
    tracing.enable()
    with tracing.span("a"):
        pass
    assert len(tracing.collect()) == 1
    assert tracing.collect() == []


def test_device_span_falls_back_to_the_host_clock_on_the_cpu():
    tracing.enable()
    with tracing.span("d", device=True):
        torch.ones(64).sum()
    (s,) = tracing.collect()
    assert s.seconds == s.end - s.start > 0


def test_a_span_is_on_the_profilers_clock():
    from torch.profiler import ProfilerActivity, profile
    tracing.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing.span("ecco.test"):
            torch.ones(8).sum()
        tracing.begin("ecco.wait", 0)
        tracing.end("ecco.wait", 0)
    names = {e.name for e in prof.events()}
    assert "ecco.test" in names and "ecco.wait" not in names


# -- the retraining window ------------------------------------------------

def _fleet():
    _, streams = make_fleet(regions=2, streams_per_region=2,
                            switch_times=(10.0,), seed=0)
    return streams


def _cc(**over):
    return ControllerConfig(window_micro=2, micro_steps=2, train_batch=4,
                            sample_rate=4, eval_batch=8, p_drop=0.0,
                            **over)


def _decisions(history):
    """Groups, shares, bandwidth, accuracies (as text, so that nan equals
    nan) and delivered tokens, window by window, job ids canonicalized by
    first appearance."""
    name = {}

    def canon(jid):
        return name.setdefault(jid, f"g{len(name)}")
    return [(wm.t, {canon(j): sorted(m) for j, m in wm.groups.items()},
             {canon(j): v for j, v in wm.shares.items()}, wm.bandwidth,
             {k: repr(v) for k, v in wm.per_stream_acc.items()},
             wm.delivered) for wm in history]


def _run_windows(engine, n, trace):
    """`n` windows with serving on; returns (controller, spans, calls), the
    calls counted around the engine's eval forward and train step, and
    the tokens the serving plane answered."""
    calls = {"eval": [], "step": 0, "served": {}}
    fwd, step = engine._forward_hits, engine._train

    def counted_fwd(params, toks, precision):
        calls["eval"].append(int(toks.shape[0]))
        return fwd(params, toks, precision)

    def counted_step(state, batch):
        calls["step"] += 1
        return step(state, batch)
    engine._forward_hits, engine._train = counted_fwd, counted_step
    scfg = ServeConfig(num_slots=8, capacity=32, max_new=4, prompt_len=8)
    try:
        ctl = ECCOController(engine, _fleet(), _cc(serve=scfg), seed=0)
        drain = ctl.serve_plane.drain

        def recorded_drain():
            out = drain()
            calls["served"].update(out)
            return out
        ctl.serve_plane.drain = recorded_drain
        if trace:
            tracing.enable()
        ctl.run(n)
        tracing.disable()
    finally:
        del engine._forward_hits
        engine._train = step
    return ctl, tracing.collect(), calls


@pytest.fixture(scope="module")
def windows(engine):
    tracing.disable()
    tracing.collect()
    return _run_windows(engine, 3, trace=True)


def test_a_window_gives_its_six_steps_in_order(windows):
    ctl, spans, _ = windows
    tops = [s for s in spans if s.name == "ecco.window"]
    assert len(tops) == len(ctl.history) == 3
    for w in tops:
        steps = [s for s in spans if s.parent == w.id]
        assert [s.name for s in steps] == ["ecco.window." + n
                                           for n in STEPS]
        assert all(w.start <= s.start <= s.end <= w.end for s in steps)
    assert all(s.parent is None for s in tops)


@pytest.mark.parametrize("name, expect", [
    ("ecco.eval", lambda c: len(c["eval"])),
    ("ecco.train.grads", lambda c: c["step"]),
    ("ecco.train.update", lambda c: c["step"]),
])
def test_span_count_equals_the_calls(windows, name, expect):
    _, spans, calls = windows
    got = [s for s in spans if s.name == name]
    assert len(got) == expect(calls) > 0


def test_eval_and_micro_window_attributes(windows):
    _, spans, calls = windows
    evals = [s for s in spans if s.name == "ecco.eval"]
    assert [s.attrs["rows"] for s in evals] == calls["eval"]
    assert {s.attrs["precision"] for s in evals} <= {"fp32", "bf16"}
    byid = {s.id: s for s in spans}
    micro = [s for s in spans if s.name == "ecco.train.micro"]
    assert micro and all(s.attrs["jobs"] > 0 for s in micro)
    # every step runs inside a micro-window, the update after the grads
    steps = [s for s in spans if s.name.startswith("ecco.train.")
             and s.name != "ecco.train.micro"]
    for s in steps:
        assert byid[s.parent].name == "ecco.train.micro"
    assert [s.name for s in steps] == ["ecco.train.grads",
                                       "ecco.train.update"] * (len(steps)
                                                               // 2)


def test_decisions_are_the_same_with_tracing_on_and_off(engine, windows):
    on = windows[0]
    off, spans, calls = _run_windows(engine, 3, trace=False)
    assert spans == []
    assert _decisions(on.history) == _decisions(off.history)
    assert windows[2]["served"] == calls["served"]
    assert sum(len(t) for t in calls["served"].values()) > 0


# -- the serving plane ----------------------------------------------------

def _plane(engine):
    plane = FleetServePlane(engine, ServeConfig(num_slots=4, capacity=32,
                                                max_new=3))
    rng = np.random.default_rng(0)
    for g in range(2):
        plane.publish(f"g{g}", engine.model.init(seed=g, device="cpu"),
                      rng.integers(0, VOCAB, size=(2, 16)))
    return plane


def _serve(engine, trace):
    """Nine queries over two groups and one unknown group, with prompts of
    two lengths, pumped until the plane drains: (plane, spans, first
    tick_log entry of the run)."""
    plane = _plane(engine)
    plane.pump()
    first = len(plane.tick_log)
    if trace:
        tracing.enable()
    rng = np.random.default_rng(1)
    for i in range(9):
        gid = "gone" if i == 4 else f"g{i % 2}"
        plane.enqueue(f"q{i}", gid, rng.integers(0, VOCAB,
                                                 size=8 + 4 * (i % 3 == 0)))
    plane.pump()
    tracing.disable()
    return plane, tracing.collect(), first


@pytest.fixture(scope="module")
def served(engine):
    tracing.disable()
    tracing.collect()
    return _serve(engine, trace=True)


ADMITTED = [f"q{i}" for i in range(9) if i != 4]


def test_each_admitted_query_has_one_queue_wait(served):
    _, spans, _ = served
    waits = [s for s in spans if s.name == "ecco.query.queue"]
    assert sorted(s.attrs["key"] for s in waits
                  if not s.attrs.get("dropped")) == sorted(ADMITTED)
    assert [s.attrs["key"] for s in waits if s.attrs.get("dropped")] == \
        ["q4"]
    assert all(s.parent is None and s.end >= s.start for s in waits)


def test_prefill_rids_cover_exactly_the_admitted(served):
    _, spans, _ = served
    pre = [s for s in spans if s.name == "ecco.prefill"]
    rids = [r for s in pre for r in s.attrs["rids"]]
    assert sorted(rids) == sorted(ADMITTED)
    admits = [s for s in spans if s.name == "ecco.admit"]
    assert sum(s.attrs["admitted"] for s in admits) == len(ADMITTED)
    byid = {s.id: s for s in spans}
    assert all(byid[s.parent].name == "ecco.admit" for s in pre)
    assert all(s.attrs["queued"] >= s.attrs["admitted"] for s in admits)


def test_ticks_equal_the_tick_log(served):
    plane, spans, first = served
    ticks = [s for s in spans if s.name == "ecco.tick"]
    assert [s.attrs["lanes"] for s in ticks] == \
        [n for n, _ in plane.tick_log[first:]]
    layers = [s for s in spans if s.name == "ecco.tick.layers"]
    assert [s.parent for s in layers] == [s.id for s in ticks]


def test_served_tokens_are_the_same_with_tracing_on_and_off(engine, served):
    on, _, _ = served
    off, spans, _ = _serve(engine, trace=False)
    assert spans == []
    assert {r: on.outputs[r] for r in ADMITTED} == \
        {r: off.outputs[r] for r in ADMITTED}


def test_window_report_reads_the_windows_ticks(engine):
    plane = _plane(engine)
    rng = np.random.default_rng(2)
    for w in range(2):
        for i in range(3 + 2 * w):
            plane.enqueue(f"w{w}.{i}", "g0", rng.integers(0, VOCAB, size=8))
        before = len(plane.tick_log)
        plane.pump()
        rep = plane.window_report()
        tt = np.asarray([dt for _, dt in plane.tick_log[before:]])
        assert rep["ticks"] == tt.size > 0
        assert rep["p50_tick_ms"] == float(np.percentile(tt, 50)) * 1e3
        assert rep["p99_tick_ms"] == float(np.percentile(tt, 99)) * 1e3
