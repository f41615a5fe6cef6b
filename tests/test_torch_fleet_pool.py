"""The fleet step's pool-wide layout (`serve_step.pool_wide`): every row of
the slot pool decoded in slot order against every live serving row, each
row taking its own group's result. On the CPU it runs op by op; on the card
the same ops are captured as CUDA graphs and replayed between the eager
attention launches.

CPU: the dense families' smoke configs (norm weights perturbed per group,
so that each group's norm differs) held to each slot decoded alone, and a
serving plane through churn (admission waves, retirement, a `publish` into
an existing row, `drop_group`) held query by query to a solo decode that
switches weights where the plane did, with its tick log, its attention
calls and its graph counters. fp32: tokens equal; bf16: tokens equal
wherever the solo top-1 leads its top-2 by more than 1e-2 (the rule of
tests/test_torch_fleet_decode.py), until the first nearer tie where each
side decodes its own tokens.

Card (`gpu`, skipped here): graph replay against the same step op by op on
the card through the same churn, a publish served without a recapture, a
store growth recaptured once, and the families that stay grouped counting
only op-by-op ticks. Imports no JAX.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch import tracing  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.core.trainer import SharedEngine  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.models.param import tree_leaves, tree_map  # noqa: E402
from repro_torch.serve.plane import FleetServePlane, ServeConfig  # noqa: E402
from repro_torch.serve.serve_step import (fleet_decode_logits,  # noqa: E402
                                          make_fleet_decode_step, pool_wide)

VOCAB = 64
LEAD = 1e-2
CAP = 32
MAX_NEW = 5
DT = {"fp32": torch.float32, "bf16": torch.bfloat16}
DENSE = ("llama3-8b", "stablelm-3b", "starcoder2-3b", "chameleon-34b")
NORM_KEYS = ("scale", "bias", "q_norm", "k_norm")


def _cfg(arch):
    return dataclasses.replace(smoke_config(arch), vocab_size=VOCAB)


def _perturb_norms(tree, rng):
    """The tree with seeded noise added to every norm weight."""
    if isinstance(tree, dict):
        return {k: (v + torch.as_tensor(rng.normal(0, 0.3, tuple(v.shape)),
                                        dtype=v.dtype)
                    if k in NORM_KEYS and torch.is_tensor(v)
                    else _perturb_norms(v, rng)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_perturb_norms(v, rng) for v in tree]
    return tree


def _lead(lg):
    top2 = np.sort(np.asarray(lg, np.float32)[..., :VOCAB], -1)[..., -2:]
    return float(top2[..., 1] - top2[..., 0])


def _check(got, top, leads, precision, where, forced=False):
    """Tokens equal (fp32) or equal where the solo top-1 leads by more
    than LEAD (bf16): until the first nearer tie, or, where the solo decode
    was teacher-forced on `got` (`forced`), at every such token. Returns
    those compared."""
    compared = 0
    for step, (t, want, lead) in enumerate(zip(got, top, leads)):
        if precision == "bf16" and lead <= LEAD:
            if forced:
                continue
            break
        assert t == want, (where, step, got, top, leads)
        compared += 1
    return compared


# -- the step -----------------------------------------------------------------

def test_pool_wide_engages_on_the_dense_attention_families():
    """Pool-wide: every segment a global-attention block and the family
    neither MoE nor hybrid; the others keep the grouped layout."""
    for arch in ("olmo-1b",) + DENSE:
        assert pool_wide(_cfg(arch)), arch
    for arch in ("hymba-1.5b", "qwen2-moe-a2.7b", "qwen3-moe-30b-a3b",
                 "xlstm-350m"):
        assert not pool_wide(_cfg(arch)), arch


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
@pytest.mark.parametrize("arch", DENSE)
def test_pool_step_equals_each_slot_alone(arch, precision):
    """Five lanes of three groups (the third group live with no lane) in a
    permuted subset of an 8-slot pool, three ticks, against each lane
    decoded alone by `Model.decode` on its own row."""
    dtype = DT[precision]
    model = build_model(_cfg(arch))
    rng = np.random.default_rng(0)
    stack = tree_map(lambda *t: torch.stack(t).to(dtype), *[
        _perturb_norms(model.init(seed=s, device="cpu"), rng)
        for s in range(3)])
    rows, slots, prompts = [0, 1, 0, 1, 1], [6, 0, 3, 5, 1], [5, 9, 13, 7, 3]
    pool = model.init_cache(8, CAP, dtype, "cpu")
    solo = []
    for slot, r, n in zip(slots, rows, prompts):
        params = tree_map(lambda t, r=r: t[r], stack)
        prompt = torch.as_tensor(rng.integers(0, VOCAB, size=n))[None]
        last, c, pos = model.prefill(params, prompt, CAP, compute_dtype=dtype)
        for dst, src in zip(tree_leaves(pool), tree_leaves(c)):
            dst[:, slot] = src[:, 0].to(dst.dtype)
        solo.append((params, int(last[0].float().argmax()), int(pos),
                     tree_map(lambda t: t[:, :1].to(dtype).clone(), c)))
    step = make_fleet_decode_step(model, compute_dtype=dtype)
    toks, poss, out = [s[1] for s in solo], [s[2] for s in solo], []
    for _ in range(3):
        nxt, _ = step(stack, rows, toks, pool, poss, slots=slots,
                      groups=range(3))
        out.append(nxt.tolist())
        toks, poss = out[-1], [p + 1 for p in poss]
    compared = 0
    for a, (params, tok, pos, cache) in enumerate(solo):
        top, leads = [], []
        for tick in range(3):
            lg, _ = model.decode(params, torch.tensor([[tok]]), cache, pos,
                                 compute_dtype=dtype)
            lg = lg[0, -1].float()
            top.append(int(lg.argmax()))
            leads.append(_lead(lg.numpy()))
            tok, pos = top[-1], pos + 1
        compared += _check([o[a] for o in out], top, leads, precision,
                           (arch, a))
    assert compared >= len(rows) * 3 // 2, compared
    if precision == "fp32":
        assert compared == len(rows) * 3


def test_groups_must_cover_the_lanes_rows():
    model = build_model(_cfg("olmo-1b"))
    stack = tree_map(lambda *t: torch.stack(t),
                     *[model.init(seed=s, device="cpu") for s in range(2)])
    pool = model.init_cache(2, CAP, torch.float32, "cpu")
    step = make_fleet_decode_step(model, compute_dtype=torch.float32)
    with pytest.raises(ValueError, match="not among groups"):
        step(stack, [0, 1], [1, 2], pool, [0, 0], groups=[0])
    with pytest.raises(ValueError, match="not among groups"):
        fleet_decode_logits(model, stack, [1], [1], pool, [0], [1],
                            compute_dtype=torch.float32, groups=[0])


# -- the plane through churn --------------------------------------------------

def _engine(arch, device):
    return SharedEngine(_cfg(arch), device=device)


def _sample():
    return np.random.default_rng(7).integers(0, VOCAB, size=(2, 16))


def _prompt(seed, n):
    return np.random.default_rng(seed).integers(0, VOCAB, size=n)


def _churn(plane, params):
    """Serves a fixed script through `plane`: three groups seeded, two
    admission waves (six slots, so the second queues), a publish into g1's
    row in flight, g2 dropped in flight, three more waves, then the drain,
    one tick a pump. Returns {rid: (group, prompt, [the params seed of each
    token])} and the lanes each tick served (the tokens it emitted)."""
    served = {}
    for g in range(3):
        plane.publish(f"g{g}", params[g], _sample())
        served[f"g{g}"] = g
    queries, lanes = {}, []
    script = {0: [("g0", 5), ("g1", 9), ("g0", 6), ("g2", 12)],
              1: [("g1", 7), ("g2", 7), ("g2", 3), ("g0", 4)],
              5: [("g1", 10), ("g0", 8), ("g1", 2)],
              8: [("g0", 11), ("g1", 6)],
              11: [("g1", 4), ("g0", 3), ("g0", 9)],
              15: [("g0", 7), ("g1", 5)],
              18: [("g1", 8), ("g0", 2)]}
    pump = 0
    while pump <= max(script) or plane._queue or plane.mgr.active():
        for gid, n in script.get(pump, ()):
            rid = f"q{len(queries)}"
            queries[rid] = (gid, _prompt(100 + len(queries), n), [])
            plane.enqueue(rid, gid, queries[rid][1])
        if pump == 3:                 # accepted whatever its accuracy
            assert plane.publish("g1", params[3], _sample()).accepted
            served["g1"] = 3
        if pump == 4:
            plane.drop_group("g2")
        before = {rid: len(t) for rid, t in plane.outputs.items()}
        ticks = plane.pump(max_ticks=1)
        emitted = 0
        for rid, toks in plane.outputs.items():
            gid, _, seeds = queries[rid]
            new = len(toks) - before.get(rid, 0)
            seeds += [served[gid]] * new
            emitted += new - (rid not in before)
        if ticks:
            lanes.append(emitted)
        pump += 1
    return queries, lanes


def _solo(model, params, prompt, tokens, seeds, dtype):
    """`prompt` decoded alone on a one-row cache, token k computed by
    params[seeds[k]] and teacher-forced on `tokens`: each token's argmax
    and lead."""
    cast = {s: tree_map(lambda t: t.to(dtype), params[s]) for s in set(seeds)}
    last, c, pos = model.prefill(cast[seeds[0]],
                                 torch.as_tensor(prompt)[None], CAP,
                                 compute_dtype=dtype)
    cache = tree_map(lambda t: t[:, :1].to(dtype).clone(), c)
    logits = [last[0].float()]
    for i, (tok, s) in enumerate(zip(tokens[:-1], seeds[1:])):
        lg, _ = model.decode(cast[s], torch.tensor([[tok]]), cache,
                             int(pos) + i, compute_dtype=dtype)
        logits.append(lg[0, -1].float())
    return ([int(x.argmax()) for x in logits],
            [_lead(x.cpu().numpy()) for x in logits])


def _plane(engine, dtype, **kw):
    return FleetServePlane(engine, ServeConfig(
        num_slots=6, capacity=CAP, max_new=MAX_NEW, gate_margin=-1.0, **kw),
        compute_dtype=dtype, cache_dtype=dtype)


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_plane_churn_equals_each_query_alone(precision, monkeypatch):
    """The plane through `_churn` on the CPU: every query answered (g2's
    cut short by the drop), each transcript held to its solo decode under
    the weights that served each token; `tick_log` records the lanes each
    tick emitted for, not the pool's six; one attention call with key
    lengths per layer a tick; every tick op by op, no graph; each
    `ecco.tick` span says so."""
    dtype = DT[precision]
    engine = _engine("olmo-1b", "cpu")
    params = [engine.model.init(seed=s, device="cpu") for s in range(4)]
    plane = _plane(engine, dtype)
    calls = []
    flash = ops._flash

    def counted(q, k, v, *, causal=True, window=0, lengths=None):
        calls.append(lengths is not None)
        return flash(q, k, v, causal=causal, window=window, lengths=lengths)
    monkeypatch.setattr(ops, "_flash", counted)
    tracing.enable()
    try:
        queries, lanes = _churn(plane, params)
        spans = [s for s in tracing.collect() if s.name == "ecco.tick"]
    finally:
        tracing.disable()
    ticks = len(plane.tick_log)
    assert plane._fleet_decode.pool_wide
    assert [n for n, _ in plane.tick_log] == lanes
    assert max(lanes) == 6 and min(lanes) < 6
    assert sum(calls) == 2 * ticks == 2 * plane.decode_calls
    assert (plane.eager_ticks, plane.graph_ticks, plane.graph_captures) == (
        ticks, 0, 0)
    assert [s.attrs for s in spans] == [{"lanes": n, "graphed": False}
                                        for n in lanes]
    out = plane.drain()
    assert set(out) <= set(queries)
    assert all(queries[r][0] == "g2" for r in set(queries) - set(out))
    compared = 0
    for rid, got in out.items():
        gid, prompt, seeds = queries[rid]
        assert len(got) == len(seeds)
        assert len(got) == MAX_NEW or gid == "g2", (rid, got)
        top, leads = _solo(engine.model, params, prompt, got, seeds, dtype)
        compared += _check(got, top, leads, precision, rid, forced=True)
    total = sum(len(v) for v in out.values())
    assert compared >= total // 2, (compared, total)
    if precision == "fp32":
        assert compared == total
    assert any(len(set(s)) > 1 for _, _, s in queries.values())   # swapped
    assert any(len(out[r]) < MAX_NEW for r in out
               if queries[r][0] == "g2")              # dropped in flight
    assert len(out) < len(queries)                    # dropped in the queue


# -- on the card --------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


class _OpByOp:
    """The fleet step op by op on whatever device, in the step's layout:
    the reference for the graphs."""
    graphed = False
    captures = 0

    def __init__(self, model, dtype):
        self.model, self.dtype = model, dtype

    def __call__(self, params_stack, rows, tokens, cache, pos, slots=None,
                 groups=None):
        logits, cache = fleet_decode_logits(
            self.model, params_stack, rows, tokens, cache, pos, slots,
            compute_dtype=self.dtype, groups=groups)
        return logits[:, 0].float().argmax(-1), cache


def _twins(card, script, arch="olmo-1b"):
    """`script(plane, params)` on a graphed plane and on its op-by-op twin
    (bf16) on the card; returns both planes and both scripts' results."""
    engine = _engine(arch, card)
    params = [engine.model.init(seed=s, device=card) for s in range(6)]
    graphed, eager = (_plane(engine, torch.bfloat16) for _ in range(2))
    eager._fleet_decode = _OpByOp(engine.model, torch.bfloat16)
    return graphed, eager, script(graphed, params), script(eager, params)


@pytest.mark.gpu
def test_graph_replay_equals_op_by_op_under_churn(card):
    """`_churn` (20+ ticks) on the card, graphed against op by op: the same
    transcripts; two captures (the first tick, and the first after g2's
    drop changed the groups), every other tick replayed; one split-KV
    attention launch and one combine per layer a tick."""
    def script(plane, params):
        tick, per_tick = plane.tick, []

        def counted():
            n = (flash_attention.launches, flash_attention.combine_launches)
            out = tick()
            per_tick.append((flash_attention.launches - n[0],
                             flash_attention.combine_launches - n[1]))
            return out
        plane.tick = counted
        return _churn(plane, params), per_tick
    graphed, eager, (got, per_tick), (want, _) = _twins(card, script)
    ticks = len(graphed.tick_log)
    assert ticks >= 20, ticks
    assert got[1] == want[1]
    assert {r: q[2] for r, q in got[0].items()} == \
        {r: q[2] for r, q in want[0].items()}
    assert graphed.drain() == eager.drain()
    assert (graphed.graph_captures, graphed.eager_ticks,
            graphed.graph_ticks) == (2, 2, ticks - 2)
    assert per_tick == [(2, 2)] * ticks


@pytest.mark.gpu
def test_publish_into_a_row_is_served_without_recapture(card):
    """After the first capture a candidate replaces g1's row in place: no
    capture follows, and every transcript, those of g1's queries admitted
    after the swap included, equals the op-by-op twin's."""
    def script(plane, params):
        for g in range(3):
            plane.publish(f"g{g}", params[g], _sample())
        for i in range(6):
            plane.enqueue(f"a{i}", f"g{i % 3}", _prompt(i, 6 + i))
        plane.pump(max_ticks=2)
        captures = plane.graph_captures
        assert plane.publish("g1", params[4], _sample()).accepted
        for i in range(6):
            plane.enqueue(f"b{i}", f"g{i % 3}", _prompt(20 + i, 4 + i))
        plane.pump()
        return captures, plane.graph_captures, plane.drain()
    graphed, eager, got, want = _twins(card, script)
    assert got[:2] == (1, 1) and graphed.graph_ticks > 0
    assert got[2] == want[2]


@pytest.mark.gpu
def test_store_growth_recaptures_once(card):
    """Four groups fill the store's first four rows; a fifth grows it to
    eight rows in new tensors: the next tick captures once more, over the
    new stack, and the transcripts equal the op-by-op twin's."""
    def script(plane, params):
        for g in range(4):
            plane.publish(f"g{g}", params[g], _sample())
        for i in range(4):
            plane.enqueue(f"a{i}", f"g{i}", _prompt(i, 5 + i))
        plane.pump(max_ticks=2)
        before = (plane.graph_captures, plane.store.reg.capacity)
        plane.publish("g4", params[4], _sample())
        for i in range(5):
            plane.enqueue(f"b{i}", f"g{i}", _prompt(30 + i, 3 + i))
        plane.pump()
        return before, (plane.graph_captures, plane.store.reg.capacity), \
            plane.drain()
    graphed, eager, got, want = _twins(card, script)
    assert got[:2] == ((1, 4), (2, 8))
    key = graphed._fleet_decode._graphs.key
    assert key[1][0] is tree_leaves(graphed.store.compute_stack())[0]
    assert got[2] == want[2]


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "xlstm-350m"])
def test_grouped_families_count_only_op_by_op_ticks(card, arch):
    """A MoE and an xLSTM plane on the card keep the grouped layout: no
    capture, no replay, every tick counted op by op."""
    engine = _engine(arch, card)
    plane = _plane(engine, torch.bfloat16)
    for g in range(2):
        plane.publish(f"g{g}", engine.model.init(seed=g, device=card),
                      _sample())
    for i in range(8):
        plane.enqueue(f"q{i}", f"g{i % 2}", _prompt(i, 4 + i))
    ticks = plane.pump()
    assert ticks > 0 and len(plane.drain()) == 8
    assert (plane.graph_captures, plane.graph_ticks, plane.eager_ticks) == (
        0, 0, ticks)
