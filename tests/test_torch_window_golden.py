"""The port's window loop at the golden configuration (the engine's
default bf16 compute over fp32 masters) against the checked-in goldens
(tests/golden/trace_<fw>.json, and the hostile trace_<scenario>_<fw>.json
that the reference itself reproduces in a tier-1 run) under the port's
`compare`, from the
reference's initial weights in tests/fixtures/golden_engine_init.npz;
that file held bit for bit to a live JAX `fresh_state(0)`; the port's
`InvariantChecker` firing on each law of a tampered real window; the
kernel routes deciding as the exact path; and the options the port does
not carry yet refused.

The goldens' floats come from the reference's bf16 training, whose
argmax flips move accuracies and Alg. 1 shares by far more than
`compare`'s tolerances between builds: the JAX package itself misses
these goldens in some environments (ROADMAP.md queue 3). The fp32
window parity with the live reference is tests/test_torch_window.py.
"""
import copy
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402

from repro.testing import trace as JT  # noqa: E402
from repro_torch.core.baselines import FRAMEWORKS  # noqa: E402
from repro_torch.models.convert import load_params_npz  # noqa: E402
from repro_torch.testing import trace as T  # noqa: E402
from repro_torch.testing.invariants import (InvariantChecker,  # noqa: E402
                                            InvariantViolation)

HERE = os.path.dirname(__file__)
GOLDEN_DIR = os.path.join(HERE, "golden")
FIXTURE = os.path.join(HERE, "fixtures", "golden_engine_init.npz")


def _engine():
    return T.make_engine_for(T.golden_scenario(),
                             init_params={0: load_params_npz(FIXTURE)},
                             device="cpu")


@pytest.fixture(scope="module")
def engine():
    return _engine()


def _skeleton(tree):
    if isinstance(tree, dict):
        return {k: _skeleton(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_skeleton(v) for v in tree]
    return None


def test_fixture_is_the_reference_fresh_state_bit_for_bit():
    want = jax.tree.map(np.asarray, JT.make_engine_for(
        JT.golden_scenario()).fresh_state(0)["params"])
    got = load_params_npz(FIXTURE)
    assert _skeleton(got) == _skeleton(want)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


def test_engine_starts_from_given_parameters(engine):
    state = engine.fresh_state(0)
    want = load_params_npz(FIXTURE)
    for g, w in zip(jax.tree.leaves(state["params"]), jax.tree.leaves(want)):
        np.testing.assert_array_equal(g.numpy(), w)
    for leaf in jax.tree.leaves(state["opt"]):
        assert not leaf.numpy().any()
    with pytest.raises(KeyError):
        engine.fresh_state(1)
    own = T.make_engine_for(T.golden_scenario(), device="cpu")
    assert not np.array_equal(
        own.fresh_state(0)["params"]["embed"]["table"].numpy(),
        want["embed"]["table"])


@pytest.mark.parametrize("framework", T.GOLDEN_FRAMEWORKS)
def test_port_trace_matches_golden(framework, engine):
    got = T.golden_trace(framework, engine, device="cpu")
    want = T.load_trace(T.golden_path(GOLDEN_DIR, framework))
    diffs = T.compare(got, want)
    assert not diffs, f"{framework}: the port's trace differs from the " \
        "golden:\n" + "\n".join(diffs)


def test_kernel_routes_give_the_exact_trace(engine):
    """drift_impl="auto" (the fleet_drift route) and a top-2 shortlist
    (the pairwise_js route) decide as the exact host path: on the CPU
    both reach their plain versions, on the card the kernels
    (chip_smoke.py `[window]`)."""
    exact = T.golden_trace("ecco", engine, device="cpu")
    assert T.golden_trace("ecco", engine, device="cpu", drift_impl="auto",
                          shortlist_k=2) == exact


@pytest.mark.parametrize("kw,item", [
    (dict(mesh=None), "unknown moe_impl"),
    (dict(elastic=None), "unknown moe_impl"),
    (dict(stragglers=None), "unknown moe_impl"),
], ids=["kw0-item 9", "kw1-item 9", "kw2-item 9"])   # the ids they had
def test_unported_options_refused(kw, item, engine, tmp_path):
    """The controller's `mesh`, `elastic` and `stragglers`, refused until
    distribution's fleet half (item 9a) landed, are taken now: an empty
    fleet runs a window under each. Its model half (item 9b) is taken
    too: what stays refused is an implementation name neither package
    knows."""
    from repro_torch.distributed.elastic import FleetElastic
    from repro_torch.distributed.stragglers import StragglerPolicy
    from repro_torch.launch.mesh import make_fleet_mesh
    from repro_torch.models.transformer import check_ported
    mesh = make_fleet_mesh(2, devices=["cpu"] * 2)
    given = {"mesh": mesh, "elastic": FleetElastic(str(tmp_path), mesh),
             "stragglers": StragglerPolicy()}
    ctl = FRAMEWORKS["ecco"](engine, [], **{k: given[k] for k in kw})
    assert ctl.run_window().groups == {}
    check_ported(moe_impl="ep", ssm_impl="seqpar")
    with pytest.raises(ValueError, match=item):
        check_ported(moe_impl="megablocks")
    with pytest.raises(ValueError, match="unknown ssm_impl"):
        check_ported(ssm_impl="ring")


# the hostile goldens that the reference itself reproduces in tier-1
# runs; sensor_blackout-recl (flaky in the reference), oscillating_drift
# and bandwidth_collapse (which the reference misses in every tier-1
# run) are left out (ROADMAP.md queue 3 item 2)
HOSTILE_YARDSTICKS = [("flash_crowd_10k", fw) for fw in T.GOLDEN_FRAMEWORKS] \
    + [("sensor_blackout", fw) for fw in ("ecco", "naive", "ekya")]


@pytest.mark.parametrize("scenario,framework", HOSTILE_YARDSTICKS)
def test_port_hostile_trace_matches_golden(scenario, framework, engine):
    got = T.hostile_trace(scenario, framework, engine, device="cpu")
    want = T.load_trace(T.golden_path(GOLDEN_DIR, framework,
                                      scenario=scenario))
    diffs = T.compare(got, want)
    assert not diffs, f"{scenario}/{framework}: the port's trace differs " \
        "from the golden:\n" + "\n".join(diffs)


# ---------------------------------------------------------------------------
# the invariant checker on a tampered real window
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def window():
    """ecco's third golden window (a join, an evict and a new job), on an
    engine of its own, with the checker's snapshot taken before it."""
    ctl = T.run_scenario("ecco", T.golden_scenario(), engine=_engine(),
                         windows=2, device="cpu", **T.GOLDEN_CONTROLLER)
    chk = InvariantChecker(bank_exact=True, label="tampered")
    chk.before_window(ctl)
    n = len(ctl.grouper.events)
    wm = ctl.run_window()
    events = ctl.grouper.events[n:]
    assert {e["kind"] for e in events} == {"join", "evict", "new"}
    return ctl, chk, wm, events


def _first(d):
    return next(iter(d))


def _job_of(ctl, sid):
    return next(j for j in ctl.jobs if sid in [m.stream_id
                                               for m in j.members])


def _evicted_member_kept(ctl, wm, ev):
    sid = _first(wm.delivered)
    ev.append({"kind": "evict", "stream": sid,
               "job": _job_of(ctl, sid).job_id})


def _drop_member(ctl, wm, ev):
    job = max(ctl.jobs, key=lambda j: j.num_members)
    gone = job.members.pop()
    wm.groups[job.job_id] = [m.stream_id for m in job.members]
    return lambda: job.members.append(gone)


def _local_cap(ctl, wm, ev):
    sid = _first(wm.bandwidth)
    ctl.cc.local_caps = {sid: wm.bandwidth[sid] / 2}
    return lambda: setattr(ctl.cc, "local_caps", None)


def _patched_grouper(ctl, wm, ev):
    ctl.grouper.group_request = ctl.grouper.group_request
    return lambda: delattr(ctl.grouper, "group_request")


def _bank_leak(ctl, wm, ev):
    bank = ctl.engine.bank
    slot = bank.alloc(ctl.engine.fresh_state(0))

    def undo():
        bank.free(slot)
        bank.compact()
    return undo


def _plane_row(add, remove):
    def mutate(ctl, wm, ev):
        add(ctl)
        return lambda: remove(ctl)
    return mutate


def _swap_shares(ctl, wm, ev):
    a, b = list(wm.shares)[:2]
    wm.shares[a], wm.shares[b] = wm.shares[b], wm.shares[a]


def _rejoin_elsewhere(ctl, wm, ev):
    join = next(e for e in ev if e["kind"] == "join")
    join["job"] = next(j.job_id for j in ctl.jobs
                       if j.job_id != join["job"])


TAMPER = {
    "delivered beyond bw*W/T": (
        lambda c, w, e: w.delivered.update(
            {_first(w.delivered): int(w.bandwidth[_first(w.delivered)]
                                      * 10.0) + 1}), "delivered"),
    "delivered without bandwidth": (
        lambda c, w, e: w.delivered.update(ghost=1), "no bandwidth"),
    "negative bandwidth": (
        lambda c, w, e: w.bandwidth.update({_first(w.bandwidth): -1.0}),
        "negative"),
    "local cap": (_local_cap, "local cap"),
    "shared bottleneck": (
        lambda c, w, e: w.bandwidth.update({_first(w.bandwidth): 1e6}),
        "shared bound"),
    "shares sum": (
        lambda c, w, e: w.shares.update(
            {_first(w.shares): w.shares[_first(w.shares)] + 0.5}),
        "sum to"),
    "share proportionality": (_swap_shares, "gain-proportionality"),
    "stream in two groups": (
        lambda c, w, e: w.groups[list(w.groups)[1]].append(
            w.groups[_first(w.groups)][0]), "member of both"),
    "grouped ghost": (
        lambda c, w, e: w.groups[_first(w.groups)].append("ghost"),
        "not in the fleet"),
    "groups vs live jobs": (
        lambda c, w, e: w.groups.pop(_first(w.groups)), "disagrees"),
    "member lost without churn": (_drop_member, "lost their group"),
    "join without its event": (
        lambda c, w, e: e.remove(next(x for x in e
                                      if x["kind"] == "join")),
        "no join/new event"),
    "joined elsewhere": (_rejoin_elsewhere, "last joined"),
    "evicted yet a member": (_evicted_member_kept, "still a"),
    "patched grouper regrouped": (_patched_grouper, "baseline regrouped"),
    "detector row": (_plane_row(lambda c: c.fleet.add_stream("ghost"),
                                lambda c: c.fleet.remove_stream("ghost")),
                     "drift-detector rows"),
    "transmission row": (_plane_row(
        lambda c: c.tx_plane.add_flow("ghost"),
        lambda c: c.tx_plane.remove_flow("ghost")), "transmission rows"),
    "signature row": (_plane_row(
        lambda c: c.sig_index.upsert("ghost", 0.0, (0.0, 0.0)),
        lambda c: c.sig_index.remove("ghost")), "signature-index rows"),
    "request clock": (_plane_row(
        lambda c: c.request_time.update(ghost=0.0),
        lambda c: c.request_time.pop("ghost")), "pending-request"),
    "bank slot leak": (_bank_leak, "JobBank leaked"),
}


def test_checker_accepts_the_real_window(window):
    ctl, chk, wm, events = window
    chk = copy.deepcopy(chk)
    chk.after_window(ctl, wm, list(events))
    assert chk.windows_checked == 1


@pytest.mark.parametrize("case", list(TAMPER))
def test_checker_fires_on_each_tampered_law(case, window):
    ctl, chk, wm, events = window
    mutate, msg = TAMPER[case]
    wm, events = copy.deepcopy(wm), copy.deepcopy(events)
    undo = mutate(ctl, wm, events)
    try:
        with pytest.raises(InvariantViolation, match=msg) as err:
            copy.deepcopy(chk).after_window(ctl, wm, events)
        assert "tampered: window 0" in str(err.value)
    finally:
        if callable(undo):          # mutations of the controller undo
            undo()
    copy.deepcopy(chk).after_window(ctl, window[2], list(window[3]))
