"""The port's fleet serving plane: tests/test_serve_plane.py restated on
the port's classes (store churn, the validated hot swap, mixed-group
decode against dedicated per-group loops, the controller's step 6 read
only), then held to the live JAX package: the plane on shared weights and
queries (gate decisions with equal accuracies, transcripts, the window
report but its clock readings), and the window loop with serving on from
the reference's initial weights in fp32. The launcher's `--fleet` path and
the two examples run on the CPU.

Smoke olmo (2 layers, d_model 64), vocabulary 64. Transcripts: fp32
compute over an fp32 pool equal exactly; bf16 compute over the bf16 pool
(the plane's default) equal wherever the reference's top-1 leads its
top-2 by more than 1e-2, the reference driven through the port's
transcript (tests/test_torch_hymba.py's rule).
"""
import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import smoke_config as jax_smoke_config  # noqa: E402
from repro.configs.base import TrainConfig as JTrainConfig  # noqa: E402
from repro.core.trainer import SharedEngine as JSharedEngine  # noqa: E402
from repro.serve import plane as jplane  # noqa: E402
from repro.serve.kvcache import CacheManager as JCacheManager  # noqa: E402
from repro.serve.serve_step import \
    make_fleet_decode_step as jax_fleet_step  # noqa: E402
from repro.serve.serve_step import \
    make_prefill_step as jax_prefill_step  # noqa: E402
from repro.testing import trace as JT  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.configs.base import TrainConfig  # noqa: E402
from repro_torch.core.controller import (ControllerConfig,  # noqa: E402
                                         ECCOController)
from repro_torch.core.trainer import SharedEngine  # noqa: E402
from repro_torch.data.streams import make_fleet  # noqa: E402
from repro_torch.examples import quickstart, serve_continuous  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.launch import serve as launcher  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.models.param import tree_leaves  # noqa: E402
from repro_torch.serve.kvcache import ServeLoop  # noqa: E402
from repro_torch.serve.plane import (TIMING_KEYS,  # noqa: E402
                                     FleetServePlane, ServeConfig,
                                     ServingStore)
from repro_torch.testing import trace as T  # noqa: E402

VOCAB = 64
LEAD = 1e-2
F32 = torch.float32
FP32 = dict(learning_rate=1e-3, b2=0.999, weight_decay=0.0, warmup_steps=5,
            total_steps=100000, remat="none", compute_dtype="float32")


@pytest.fixture(scope="module")
def engine():
    cfg = dataclasses.replace(smoke_config("olmo-1b"), vocab_size=VOCAB)
    return SharedEngine(cfg, device="cpu")


def _params(engine, seed):
    return engine.model.init(seed=seed, device="cpu")


def _prompts(n, slen, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, VOCAB, size=slen) for _ in range(n)]


def _solo(engine, params, prompt, max_new, capacity, dtype=torch.bfloat16):
    loop = ServeLoop(engine.model, params, num_slots=1, capacity=capacity,
                     max_new=max_new, compute_dtype=dtype, cache_dtype=dtype)
    loop.submit("solo", prompt)
    loop.run_until_drained()
    return loop.outputs["solo"]


def _solo_lead(engine, params, prompt, tokens, capacity):
    """The port's solo decode (bf16 compute, bf16 pool) driven through
    `tokens`: per emitted token its argmax and top-1/top-2 gap."""
    loop = ServeLoop(engine.model, params, num_slots=1, capacity=capacity,
                     max_new=len(tokens))
    cap = loop.mgr.capacity
    last, cache, pos = engine.model.prefill(
        loop.params, torch.as_tensor(prompt)[None], cap)
    loop.mgr.write_prefill(0, cache, pos)
    logits = [last[0].float()]
    for i, tok in enumerate(tokens[:-1]):
        lg, _ = engine.model.decode(loop.params, torch.tensor([[tok]]),
                                    loop.mgr.cache, pos + i)
        logits.append(lg[0, -1].float())
    return _tops(logits)


def _tops(logits):
    lg = np.stack([np.asarray(x, np.float32)[:VOCAB] for x in logits])
    top2 = np.sort(lg, -1)[:, -2:]
    return lg.argmax(-1).tolist(), (top2[:, 1] - top2[:, 0]).tolist()


def _check_lead(got, top, gaps, where):
    decided = 0
    for step, (t, want, gap) in enumerate(zip(got, top, gaps)):
        if gap > LEAD:
            assert t == want, (where, step, got, top, gaps)
            decided += 1
    return decided


# -- what the port does instead of the JAX plane's lane padding --------------

def test_tick_log_records_the_real_lanes(engine):
    """The JAX plane pads lanes to a shape grid (`_pad_size`) to bound
    XLA's compilations; the port's tick log records the real lanes, also
    where the tick decodes the whole pool (olmo's pool-wide step)."""
    plane = FleetServePlane(engine, ServeConfig(num_slots=8, capacity=32,
                                                max_new=3))
    plane.publish("g0", _params(engine, 0), np.stack(_prompts(2, 16)))
    for i, p in enumerate(_prompts(5, 8, seed=1)):
        plane.enqueue(f"q{i}", "g0", p)
    assert plane.pump() == 2
    assert [n for n, _ in plane.tick_log] == [5, 5]      # grid would pad 6
    assert plane.prefill_calls == 1 and plane.decode_calls == 2


# -- serving store ------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.bfloat16, F32])
def test_store_install_overwrite_remove(engine, dtype):
    st = ServingStore(dtype)
    p0, p1, p2 = (_params(engine, s) for s in (0, 1, 2))
    for gid, p in (("g0", p0), ("g1", p1), ("g2", p2)):
        st.install(gid, p)
    assert len(st) == 3

    def leaf(p):
        return tree_leaves(p)[0].clone()

    def same(row, p):
        assert torch.equal(leaf(row), leaf(p))

    def same_compute(gid, p):
        assert torch.equal(leaf(st.compute_row(gid)), leaf(p).to(dtype))

    same(st.row("g1"), p1)
    same_compute("g1", p1)
    st.install("g1", p0)                      # overwrite in place
    same(st.row("g1"), p0)
    same_compute("g1", p0)

    st.remove("g1")                           # swap-with-last removal
    assert len(st) == 2 and "g1" not in st
    same(st.row("g0"), p0)
    same(st.row("g2"), p2)
    same_compute("g2", p2)

    # growth past the initial registry capacity keeps rows intact
    for i in range(3, 9):
        st.install(f"g{i}", p1)
    same(st.row("g2"), p2)
    same_compute("g2", p2)
    assert len(st) == 8
    assert tree_leaves(st.stack())[0].shape[0] == st.reg.capacity
    nb = st.nbytes()
    assert nb["compute"] == (0 if dtype == F32 else nb["rows"] // 2)


# -- validated hot swap -------------------------------------------------------

def test_gate_seeds_ungated_then_accepts_tie(engine):
    plane = FleetServePlane(engine, ServeConfig(num_slots=4))
    p = _params(engine, 0)
    sample = np.stack(_prompts(4, 16, seed=1))
    d0 = plane.publish("g0", p, sample)
    assert d0.seeded and d0.accepted and np.isnan(d0.incumbent_acc)
    assert plane.swap_seeded == 1 and plane.staleness["g0"] == 0
    # identical candidate ties the incumbent: accepted at margin 0.0
    d1 = plane.publish("g0", p, sample)
    assert not d1.seeded and d1.accepted
    assert d1.candidate_acc == d1.incumbent_acc
    assert plane.swap_accepted == 1 and plane.staleness["g0"] == 0


def test_gate_rejection_keeps_incumbent_serving(engine):
    scfg = ServeConfig(num_slots=4, capacity=32, max_new=4,
                       gate_margin=1.1)   # > any accuracy delta: no
    plane = FleetServePlane(engine, scfg, compute_dtype=F32,
                            cache_dtype=F32)   # candidate can ever pass
    inc, cand = _params(engine, 0), _params(engine, 1)
    sample = np.stack(_prompts(4, 16, seed=2))
    plane.publish("g0", inc, sample)      # seeding ignores the margin

    for k in (1, 2):                      # repeated misses accumulate
        d = plane.publish("g0", cand, sample)
        assert not d.accepted and not d.seeded
        assert plane.swap_rejected == k and plane.staleness["g0"] == k

    # the incumbent, not the rejected candidate, answers queries
    prompt = _prompts(1, 8, seed=3)[0]
    plane.submit("q", prompt, group="g0")
    plane.run_until_drained()
    assert plane.outputs["q"] == _solo(engine, inc, prompt, 4, 32, F32)
    rep = plane.window_report()
    assert rep["swap_rejected"] == 2 and rep["staleness"] == {"g0": 2}
    assert [g["accepted"] for g in rep["gate"]] == [True, False, False]


def test_gate_accepts_when_candidate_clears_margin(engine):
    plane = FleetServePlane(engine, ServeConfig(num_slots=4, capacity=32,
                                                max_new=4,
                                                gate_margin=-1.1),
                            compute_dtype=F32, cache_dtype=F32)
    inc, cand = _params(engine, 0), _params(engine, 1)
    sample = np.stack(_prompts(4, 16, seed=4))
    plane.publish("g0", inc, sample)
    d = plane.publish("g0", cand, sample)  # margin -1.1: always clears
    assert d.accepted and plane.swap_accepted == 1
    prompt = _prompts(1, 8, seed=5)[0]
    plane.submit("q", prompt, group="g0")
    plane.run_until_drained()
    assert plane.outputs["q"] == _solo(engine, cand, prompt, 4, 32, F32)


# -- batched fleet decode -----------------------------------------------------

@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_fleet_parity_mixed_groups_with_churn(engine, precision):
    """More queries than slots across two groups with different params:
    the shared-tick decode plus slot recycling reproduces each dedicated
    per-group loop: exactly in fp32; in bf16 wherever the solo top-1
    leads by more than 1e-2 (the solo decode driven through the plane's
    transcript)."""
    dtype = F32 if precision == "fp32" else torch.bfloat16
    scfg = ServeConfig(num_slots=3, capacity=32, max_new=5, prompt_len=8)
    plane = FleetServePlane(engine, scfg, compute_dtype=dtype,
                            cache_dtype=dtype)
    pa, pb = _params(engine, 0), _params(engine, 1)
    sample = np.stack(_prompts(2, 16, seed=6))
    plane.publish("ga", pa, sample)
    plane.publish("gb", pb, sample)
    queries = {}
    for q in range(4):
        for gid, p in (("ga", pa), ("gb", pb)):
            prompt = _prompts(1, 8 + q, seed=10 + 2 * q + (gid == "gb"))[0]
            plane.enqueue(f"{gid}/q{q}", gid, prompt)
            queries[f"{gid}/q{q}"] = (p, prompt)
    plane.pump()
    got = plane.drain()
    assert set(got) == set(queries)
    decided = 0
    for rid, (p, prompt) in queries.items():
        if precision == "fp32":
            assert got[rid] == _solo(engine, p, prompt, 5, 32, F32), rid
            decided += 5
        else:
            top, gaps = _solo_lead(engine, p, prompt, got[rid], 32)
            decided += _check_lead(got[rid], top, gaps, rid)
    assert decided >= len(queries) * 5 // 2
    rep = plane.window_report()
    assert rep["queries"] == 8 and rep["dropped"] == 0
    assert rep["ticks"] > 0 and rep["p99_tick_ms"] > 0.0
    # prompts of four lengths: positions differ within a tick
    assert max(n for n, _ in plane.tick_log) == 3


def test_enqueue_validates_capacity_and_unknown_group_drops(engine):
    scfg = ServeConfig(num_slots=2, capacity=16, max_new=4)
    plane = FleetServePlane(engine, scfg)
    plane.publish("g0", _params(engine, 0),
                  np.stack(_prompts(2, 16, seed=7)))
    with pytest.raises(ValueError, match="does not fit"):
        plane.enqueue("big", "g0", _prompts(1, 14, seed=8)[0])
    plane.enqueue("ghost", "dead-group", _prompts(1, 8, seed=9)[0])
    plane.pump()
    assert plane.window_report()["dropped"] == 1
    assert "ghost" not in plane.outputs


def test_drop_group_retires_inflight_and_queued(engine):
    scfg = ServeConfig(num_slots=4, capacity=32, max_new=6)
    plane = FleetServePlane(engine, scfg)
    plane.publish("g0", _params(engine, 0),
                  np.stack(_prompts(2, 16, seed=11)))
    plane.submit("live", _prompts(1, 8, seed=12)[0], group="g0")
    plane.enqueue("queued", "g0", _prompts(1, 8, seed=13)[0])
    assert plane.mgr.active()
    plane.drop_group("g0")
    assert not plane.mgr.active() and not plane._queue
    assert len(plane.store) == 0 and plane._new_tokens == {}
    assert plane.pump() == 0


# -- controller integration ---------------------------------------------------

def _mini_fleet(seed=0):
    _, streams = make_fleet(regions=2, streams_per_region=2,
                            switch_times=(10.0,), seed=seed)
    return streams


def _mini_cc(**over):
    return ControllerConfig(window_micro=2, micro_steps=2, train_batch=4,
                            sample_rate=4, eval_batch=8, p_drop=0.0,
                            **over)


def _decisions(history):
    """Decision-plane surface with job ids canonicalized by first
    appearance (raw ids come from a process-global counter)."""
    name = {}

    def canon(jid):
        return name.setdefault(jid, f"g{len(name)}")

    out = []
    for wm in history:
        out.append({
            "t": wm.t,
            "groups": {canon(j): sorted(m) for j, m in wm.groups.items()},
            "shares": {canon(j): round(v, 6)
                       for j, v in wm.shares.items()},
            "acc": {s: None if np.isnan(v) else round(v, 6)
                    for s, v in wm.per_stream_acc.items()},
        })
    return out


def test_controller_serving_is_readonly(engine):
    """Enabling the serving plane must not move a single decision: same
    grouping, same shares, same accuracies, window for window."""
    off = ECCOController(engine, _mini_fleet(), _mini_cc(), seed=0)
    off.run(3)
    scfg = ServeConfig(num_slots=8, capacity=32, max_new=4, prompt_len=8)
    on = ECCOController(engine, _mini_fleet(), _mini_cc(serve=scfg),
                        seed=0)
    on.run(3)
    assert _decisions(off.history) == _decisions(on.history)
    assert all(wm.serve is None for wm in off.history)
    # ...and the plane actually served once groups formed (t=20)
    assert on.history[2].serve["queries"] > 0


def test_controller_serve_window_reports_and_gate(engine):
    """Window reports carry qps/latency and the swap audit: groups are
    seeded ungated the window they form; with an impossible margin every
    later publish is rejected and staleness grows while the incumbent
    keeps serving."""
    scfg = ServeConfig(num_slots=8, capacity=32, max_new=4, prompt_len=8,
                       gate_margin=1.1)
    ctl = ECCOController(engine, _mini_fleet(), _mini_cc(serve=scfg),
                         seed=0)
    ctl.run(4)
    h = ctl.history
    assert h[0].serve["queries"] == 0          # no groups yet: idle plane
    for wm in h[1:]:                           # every serving window:
        s = wm.serve
        assert s["groups"] == len(wm.groups)   # store mirrors live groups
        assert set(s["staleness"]) == set(wm.groups)
        assert s["queries"] == sum(len(m) for m in wm.groups.values())
        assert s["tokens"] > 0 and s["qps"] > 0 and s["p99_tick_ms"] > 0
        fresh = [g for g in s["gate"] if g["seeded"]]
        assert all(g["accepted"] for g in fresh)
        assert all(not g["accepted"] for g in s["gate"] if not g["seeded"])
    assert h[-1].serve["swap_accepted"] == 0
    last = h[-1].serve
    assert last["swap_rejected"] == len(h[-1].groups) and last["groups"] > 0
    assert all(v == 1 for v in last["staleness"].values())


# -- the port's plane against the live JAX plane ------------------------------

@pytest.fixture(scope="module")
def bridged():
    """Both packages' engines over one smoke olmo, and the JAX init of
    seeds 0..3 with their bridges."""
    jcfg = dataclasses.replace(jax_smoke_config("olmo-1b"), vocab_size=VOCAB)
    tcfg = dataclasses.replace(smoke_config("olmo-1b"), vocab_size=VOCAB)
    jeng, teng = JSharedEngine(jcfg), SharedEngine(tcfg, device="cpu")
    init = jax.jit(jeng.model.init)
    jps = [init(jax.random.PRNGKey(s)) for s in range(4)]
    tps = [params_from_numpy(jax.tree.map(np.asarray, p), device="cpu")
           for p in jps]
    return jeng, teng, jps, tps


def _jax_plane_fp32(jeng, scfg):
    """The JAX plane at fp32 compute over an fp32 pool (its steps are
    bf16 by default)."""
    p = jplane.FleetServePlane(jeng, scfg)
    m = jeng.model
    p.mgr = JCacheManager(m, num_slots=scfg.num_slots,
                          capacity=scfg.capacity, dtype=jnp.float32)
    p._prefill = jax.jit(jax_prefill_step(m, p.mgr.capacity,
                                          compute_dtype=jnp.float32))
    p._fleet_decode = jax.jit(jax_fleet_step(m, compute_dtype=jnp.float32))
    return p


_JAX_STEPS = {}


def _jax_lead(jeng, jp, prompt, tokens, cap):
    """The JAX model (bf16 compute, bf16 pool) driven through `tokens`:
    per emitted token its argmax and top-1/top-2 gap."""
    m = jeng.model
    if cap not in _JAX_STEPS:
        _JAX_STEPS[cap] = (
            jax.jit(lambda p, t: m.prefill(p, t, cap)),
            jax.jit(lambda p, t, c, pos: m.decode(
                p, t, jax.tree.map(lambda a: a.astype(jnp.bfloat16), c),
                pos)))
    prefill, decode = _JAX_STEPS[cap]
    last, cache, pos = prefill(jp, jnp.asarray(prompt)[None])
    logits = [last[0]]
    for i, tok in enumerate(tokens[:-1]):
        lg, cache = decode(jp, jnp.asarray([[tok]], jnp.int32), cache,
                           pos + i)
        logits.append(lg[0, -1])
    return _tops([np.asarray(x, np.float32) for x in logits])


def _drive(plane, params, seeds_of, queries):
    """Publish, serve the queries, and return (gate decisions, outputs,
    report)."""
    sample = np.stack(_prompts(4, 16, seed=20))
    gates = []
    for gid, seed in seeds_of:
        gates.append(dataclasses.asdict(plane.publish(gid, params[seed],
                                                      sample)))
    for rid, gid, prompt in queries:
        plane.enqueue(rid, gid, prompt)
    plane.pump()
    return gates, plane.drain(), plane.window_report()


def _same(a, b):
    return a == b or (isinstance(a, float) and math.isnan(a)
                      and math.isnan(b))


def _report_equal(got, want):
    assert set(got) == set(want)
    for key in want:
        if key in TIMING_KEYS:
            continue
        if key == "gate":
            assert len(got[key]) == len(want[key])
            for g, w in zip(got[key], want[key]):
                assert set(g) == set(w)
                assert all(_same(g[k], w[k]) for k in w), (g, w)
        else:
            assert got[key] == want[key], key


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_plane_matches_jax(bridged, precision):
    jeng, teng, jps, tps = bridged
    scfg = ServeConfig(num_slots=3, capacity=40, max_new=6)
    if precision == "fp32":
        jp = _jax_plane_fp32(jeng, scfg)
        tp = FleetServePlane(teng, scfg, compute_dtype=F32, cache_dtype=F32)
    else:
        jp, tp = jplane.FleetServePlane(jeng, scfg), FleetServePlane(teng,
                                                                     scfg)
    # two groups seeded, a candidate on each: seed 2 against ga's seed 0,
    # seed 0 against gb's seed 1
    seeds_of = [("ga", 0), ("gb", 1), ("ga", 2), ("gb", 0)]
    queries = [(f"q{i}", ("ga", "gb")[i % 2], p) for i, p in enumerate(
        _prompts(4, 12, seed=21) + _prompts(3, 9, seed=22)
        + _prompts(2, 16, seed=23))]
    jg, jout, jrep = _drive(jp, jps, seeds_of, queries)
    tg, tout, trep = _drive(tp, tps, seeds_of, queries)
    assert len(tg) == len(jg)
    for g, w in zip(tg, jg):
        assert set(g) == set(w) and all(_same(g[k], w[k]) for k in w), (g, w)
        assert type(g["candidate_acc"]) is float
    _report_equal(trep, jrep)
    assert set(tout) == set(jout) == {q[0] for q in queries}
    if precision == "fp32":
        assert tout == jout
        return
    # bf16: the reference through the port's transcript, on the row
    # that served each query (the gate's final decisions)
    row = {gid: seed for gid, seed in seeds_of[:2]}
    for g, (gid, seed) in zip(jg[2:], seeds_of[2:]):
        if g["accepted"]:
            row[gid] = seed
    decided = 0
    for rid, gid, prompt in queries:
        top, gaps = _jax_lead(jeng, jps[row[gid]], prompt, tout[rid],
                              scfg.capacity)
        decided += _check_lead(tout[rid], top, gaps, rid)
    assert decided >= len(queries) * scfg.max_new // 2


def _canon_serve(history):
    """Each window's serve report with the group ids canonicalized by the
    history's first appearance, and the clock readings dropped."""
    names = {}
    for wm in history:
        for jid in wm.groups:
            names.setdefault(jid, f"g{len(names)}")
    out = []
    for wm in history:
        s = {k: v for k, v in wm.serve.items() if k not in TIMING_KEYS}
        s["staleness"] = {names[k]: v for k, v in s["staleness"].items()}
        s["gate"] = [dict(g, group_id=names[g["group_id"]],
                          incumbent_acc=(None if math.isnan(
                              g["incumbent_acc"]) else g["incumbent_acc"]))
                     for g in s["gate"]]
        out.append(s)
    return out


def test_window_loop_with_serving_matches_jax_fp32():
    """ecco on the golden scenario with serving on, both packages in fp32
    from the reference's `fresh_state(0)`: every window's decisions and
    serve report (but its clock readings) equal, and the decisions equal
    to the port's own run with serving off."""
    scenario = JT.golden_scenario()
    jcfg = dataclasses.replace(JT.smoke_config("olmo-1b"),
                               vocab_size=scenario.bank.vocab)
    jeng = JT.SharedEngine(jcfg, JTrainConfig(**FP32))
    init = jax.tree.map(np.asarray, jeng.fresh_state(0)["params"])

    def port_engine():
        return T.make_engine_for(T.golden_scenario(),
                                 tcfg=TrainConfig(**FP32),
                                 init_params={0: init}, device="cpu")

    scfg = ServeConfig(num_slots=8, capacity=32, max_new=4, prompt_len=8,
                       queries_per_stream=2)
    jctl = JT.run_scenario("ecco", JT.golden_scenario(), engine=jeng,
                           seed=0, serve=scfg, **JT.GOLDEN_CONTROLLER)
    tctl = T.run_scenario("ecco", T.golden_scenario(), engine=port_engine(),
                          seed=0, device="cpu", serve=scfg,
                          **T.GOLDEN_CONTROLLER)
    off = T.run_scenario("ecco", T.golden_scenario(), engine=port_engine(),
                         seed=0, device="cpu", **T.GOLDEN_CONTROLLER)
    assert _decisions(tctl.history) == _decisions(jctl.history)
    assert _decisions(tctl.history) == _decisions(off.history)
    assert _canon_serve(tctl.history) == _canon_serve(jctl.history)
    assert sum(wm.serve["queries"] for wm in tctl.history) > 0
    assert any(g for wm in tctl.history for g in wm.serve["gate"]
               if not g["seeded"])


# -- entry points on the CPU --------------------------------------------------

def test_launcher_fleet_runs_on_cpu():
    before = flash_attention.launches
    report = launcher.main(["--fleet", "--device", "cpu", "--requests", "4",
                            "--max-new", "4", "--capacity", "32",
                            "--prompt-len", "8"])
    assert flash_attention.launches == before     # no kernel on the CPU
    assert sorted(report["outputs"]) == [f"req{i}" for i in range(4)]
    assert all(len(v) == 4 for v in report["outputs"].values())
    rep = report["report"]
    assert rep["swap_seeded"] == 2 and rep["queries"] == 4
    assert rep["swap_accepted"] + rep["swap_rejected"] == 1


def test_examples_run_on_cpu(capsys):
    ctl = quickstart.main(["--device", "cpu", "--windows", "2"])
    assert len(ctl.history) == 2
    out = serve_continuous.main(["--device", "cpu", "--rounds", "2"])
    assert len(out["outputs"]) == 8
    assert all(len(v) == 12 for v in out["outputs"].values())
    printed = capsys.readouterr().out
    assert "final mean accuracy" in printed and "swap group0" in printed
