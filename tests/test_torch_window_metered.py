"""Roofline-metered windows in the port against the live JAX controller:
the golden drift_wave scenario under ecco, naive, ekya and recl with a
window budget that binds, both packages pricing with ONE duck-typed table
of fixed seconds (`FixedTable`, keyed by config name and kind) passed as
`cc.cost_table`, so that the decisions are held apart from the two cost
counters (tests/test_torch_roofline.py holds those). fp32 compute from
the reference's `fresh_state(0)`, invariants on.

Held: shares, the allocator's notes and the `roofline` reports equal,
groups, grouping events and drift exactly, accuracies equal floats,
bandwidth within 1e-5 relative. Zoo placement and the bf16 precision
policy are tests/test_torch_window_zoo.py.
"""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.core import baselines as JB  # noqa: E402
from repro.testing import trace as JT  # noqa: E402
from repro_torch.core.baselines import FRAMEWORKS  # noqa: E402
from repro_torch.core.controller import ControllerConfig  # noqa: E402
from repro_torch.launch.roofline import CostTable  # noqa: E402
from repro_torch.testing import trace as T  # noqa: E402
from repro_torch.testing.trace import FixedTable  # noqa: E402
from test_torch_window_hostile import (BW_RTOL, _canon_ids,  # noqa: E402
                                       _same_float, make_engines)


@pytest.fixture(scope="module")
def engines():
    return make_engines()


def _run(mod, framework, engine, **kw):
    trace = {}
    ctl = mod.run_scenario(framework, mod.golden_scenario(), engine=engine,
                           seed=0, trace=trace,
                           **dict(mod.GOLDEN_CONTROLLER, **kw))
    return ctl, trace


def hold_metered(tctl, ttrace, jctl, jtrace):
    """The metered windows of the two packages: one trace, one ledger."""
    assert T.compare(ttrace, jtrace, drift_atol=0.0, share_atol=0.0,
                     bw_rtol=BW_RTOL, acc_atol=0.0) == []
    jn, tn = _canon_ids(jctl), _canon_ids(tctl)
    for w, (tw, jw) in enumerate(zip(tctl.history, jctl.history)):
        assert tw.roofline is not None, w
        assert tw.roofline == jw.roofline, w
        assert [(tn[k], v) for k, v in tw.shares.items()] == \
            [(jn[k], v) for k, v in jw.shares.items()], w
        assert list(tw.per_stream_acc) == list(jw.per_stream_acc), w
        assert all(_same_float(a, jw.per_stream_acc[sid])
                   for sid, a in tw.per_stream_acc.items()), w
        assert tw.delivered == jw.delivered, w
    assert [(e["kind"], e["stream"]) for e in tctl.grouper.events] == \
        [(e["kind"], e["stream"]) for e in jctl.grouper.events]


@pytest.fixture
def recl_reference_places_on_its_engine(monkeypatch):
    """The reference's baselines inherit ECCO's metered placement, which
    raises TypeError once RECL's snapshot dict (`zoo`) has entries under
    a budget (ROADMAP.md queue 3); the port places every baseline job on
    the primary engine. The reference is held to that here."""
    monkeypatch.setattr(JB.IndependentController, "_pick_engine",
                        lambda self: self.engine, raising=False)


# budget 6: two of the four micro-windows of window 0, one of the later
# ones; budget 0.4: the reservation alone, so every window degrades to
# eval only once a job exists
@pytest.mark.parametrize("budget", [6.0, 0.4])
@pytest.mark.parametrize("framework", T.GOLDEN_FRAMEWORKS)
def test_metered_windows_match_reference(framework, budget, engines,
                                         recl_reference_places_on_its_engine):
    jeng, teng = engines
    kw = dict(roofline_budget=budget, cost_table=FixedTable())
    jctl, jtrace = _run(JT, framework, jeng, **kw)
    tctl, ttrace = _run(T, framework, teng, device="cpu", **kw)
    assert tctl.invariant_windows == jctl.invariant_windows == 3
    hold_metered(tctl, ttrace, jctl, jtrace)
    notes = [n for wm in tctl.history for n in wm.roofline["notes"]]
    if framework != "naive":       # Uniform's round robin takes no meter
        assert notes, "the budget never bound"
    if budget < 1.0:
        # the reservation alone outspends it: no micro-window trains
        assert all("train" not in wm.roofline["by_kind"]
                   for wm in tctl.history)
        assert framework == "naive" or \
            any("eval-only" in n for n in notes)


def test_recl_under_a_budget_raises_in_the_reference_only(engines):
    """The reference defect the fixture above steps around, and the
    port's RECL running the same windows."""
    jeng, teng = engines
    kw = dict(roofline_budget=6.0, cost_table=FixedTable())
    with pytest.raises(TypeError, match="concatenate"):
        _run(JT, "recl", jeng, **kw)
    tctl, _ = _run(T, "recl", teng, device="cpu", **kw)
    assert all(j.engine is teng for j in tctl.jobs)
    assert tctl.zoo and all(isinstance(v, dict) for v in tctl.zoo.values())


def test_unmetered_windows_report_no_roofline(engines):
    _, teng = engines
    tctl, _ = _run(T, "ecco", teng, device="cpu")
    assert all(wm.roofline is None for wm in tctl.history)


# -- the metering options, once refused, now taken ------------------------
@pytest.mark.parametrize("case", ["serve+budget", "budget", "cost_table",
                                  "zoo"])
def test_metering_options_accepted(case, engines):
    from repro_torch.serve.plane import ServeConfig
    _, teng = engines
    cc, zoo = {
        "serve+budget": (ControllerConfig(serve=ServeConfig(),
                                          roofline_budget=1.0), None),
        "budget": (ControllerConfig(roofline_budget=1.0), None),
        "cost_table": (ControllerConfig(cost_table=FixedTable()), None),
        "zoo": (ControllerConfig(), []),
    }[case]
    ctl = FRAMEWORKS["ecco"](teng, [], cc, zoo=zoo)
    assert ctl.zoo == []
    assert ctl._pick_engine() is teng
    meter = ctl._window_meter()
    assert (meter is None) == (cc.roofline_budget is None)
    table = ctl._table()
    assert table is cc.cost_table if cc.cost_table is not None \
        else isinstance(table, CostTable)
    assert ctl._table() is table                  # kept across windows
    wm = ctl.run_window()                         # no streams: no work
    assert (wm.roofline is None) == (cc.roofline_budget is None)


def test_reserved_overheads_with_serving_on(engines):
    """With serving on, the gate's two fp32 evals and each query's
    prefill and decode steps are charged as "serve" before Alg. 1 runs,
    as in the reference."""
    from repro.core.controller import ControllerConfig as JCC
    from repro.serve.plane import ServeConfig as JServe
    from repro_torch.serve.plane import ServeConfig
    jeng, teng = engines
    reports = []
    for mod, eng, cc, kw in [
            (T, teng, ControllerConfig, dict(device="cpu")),
            (JT, jeng, JCC, {})]:
        serve = (ServeConfig if mod is T else JServe)(
            num_slots=8, capacity=32, max_new=4, queries_per_stream=2,
            prompt_len=8)
        ctl, _ = _run(mod, "ecco", eng, roofline_budget=6.0,
                      cost_table=FixedTable(), serve=serve, windows=2, **kw)
        reports.append([wm.roofline for wm in ctl.history])
    assert reports[0] == reports[1]
    assert any("serve" in r["by_kind"] for r in reports[0])
