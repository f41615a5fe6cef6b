"""granite-4.0-h-micro (the mamba_hybrid family: each layer a Mamba-2 mixer
or a NoPE GQA attention layer, muP multipliers) held to the plain float32
reference of `bench/reference/families/mamba_hybrid.py`, which is written
from the published equations and imports nothing of the port. The JAX
package has no such model, so nothing here is compared with it.

CPU, smoke width (4 layers of width 64: Mamba-2 mixers of 8 heads of 16 at
state 16 around one attention layer), seeded random weights with every leaf
perturbed (so the conv bias, dt_bias, A_log, D and the norms are not at
their inits), fp32 throughout:
  * the forward's logits against the reference's;
  * prefill, then decode through a slot of the serving pool, against the
    reference's full forward over prompt and answer;
  * the fleet tick (pool-wide) over two groups against each slot decoded
    alone;
  * the fleet step's layout (pool-wide, as the dense families');
  * the muP, attention-scale and NoPE cases one at a time;
  * the spans and the launch counter, on and off;
  * olmo-smoke's prefill and fleet tick call the same aten ops with the
    new fields at their defaults: no multiply or divide by 1.0, no rescaled
    q.
Card (`gpu`, skipped here): `ssd_scan`'s CUDA-core path at granite's scan
shape, state 128, against `ref.ssd_chunked`; a serving plane's ticks
replayed as CUDA graphs against the same plane's step op by op. Imports no
JAX.
"""
import collections
import dataclasses
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from bench.reference.families import mamba_hybrid as ref  # noqa: E402
from repro_torch import tracing  # noqa: E402
from repro_torch.configs import (MAMBA_HYBRID, PORT_ARCH_IDS,  # noqa: E402
                                 get_config, smoke_config)
from repro_torch.kernels import ref as kref  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.models.param import tree_leaves, tree_map  # noqa: E402
from repro_torch.serve.kvcache import CacheManager  # noqa: E402
from repro_torch.serve.serve_step import (fleet_decode_logits,  # noqa: E402
                                          pool_wide)

ARCH = "granite-4.0-h-micro"
F32 = torch.float32
# fp32 against fp32, relative to the largest logit: the port's chunked scan
# and flash-style attention sum in another order than the reference's
# quadratic forms; at smoke width the logits (|z| <= ~4) agree to 2e-7 -
# 4e-6 of their largest, so 1e-5 leaves room for BLAS's choice of blocking
# and still fails any dropped or doubled term (>= 1e-3)
TOL = 1e-5
CAP = 32


def _cfg(**kw):
    return dataclasses.replace(smoke_config(ARCH), **kw)


def _params(model, seed):
    """Seeded weights, every leaf perturbed off its init."""
    rng = np.random.default_rng(seed)
    return tree_map(lambda t: t + torch.as_tensor(
        rng.normal(0, 0.2, tuple(t.shape)), dtype=t.dtype),
        model.init(seed=seed, device="cpu"))


def _ref_logits(cfg, params, toks):
    c = dataclasses.asdict(cfg)
    with torch.no_grad():
        return ref.logits(c, params, ref.hidden(c, params, toks))


def _gap(got, want) -> float:
    """The largest gap over the largest magnitude of `want` (at least 1)."""
    return float((got - want).abs().max()) / max(1.0, float(
        want.abs().max()))


def _tokens(seed, shape, vocab=256):
    return torch.as_tensor(np.random.default_rng(seed).integers(
        0, vocab, size=shape))


# -- configuration --------------------------------------------------------

def test_config_holds_the_published_numbers():
    cfg = get_config(ARCH)
    assert ARCH in PORT_ARCH_IDS and cfg.family == MAMBA_HYBRID
    assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
            cfg.resolved_head_dim, cfg.d_ff, cfg.vocab_size) == \
        (40, 2048, 32, 8, 64, 8192, 100352)
    assert cfg.attn_layers == (5, 15, 25, 35)
    s = cfg.ssm
    assert (s.state_dim, s.conv_width, s.expand, s.head_dim, s.n_groups,
            s.conv_bias) == (128, 4, 2, 64, 1, True)
    assert (cfg.embedding_multiplier, cfg.residual_multiplier,
            cfg.attention_multiplier, cfg.logits_scaling) == \
        (12.0, 0.22, 0.015625, 8.0)
    assert cfg.tie_embeddings and not L.uses_rope(cfg)
    # 3.19 B parameters, counted exactly from the spec
    assert cfg.param_count() == 3_191_396_096
    assert [(g.kind, g.count) for g in T.layer_plan(cfg)] == [
        ("mamba2", 5), ("block", 1), ("mamba2", 9), ("block", 1),
        ("mamba2", 9), ("block", 1), ("mamba2", 9), ("block", 1),
        ("mamba2", 4)]


def test_smoke_config_keeps_both_kinds_and_counts_its_spec():
    cfg = smoke_config(ARCH)
    kinds = {g.kind for g in T.layer_plan(cfg)}
    assert kinds == {"mamba2", "block"}
    assert build_model(cfg).num_params() == cfg.param_count()


def test_n_groups_other_than_one_is_refused():
    cfg = _cfg(ssm=dataclasses.replace(smoke_config(ARCH).ssm, n_groups=2))
    with pytest.raises(NotImplementedError, match="one B/C group"):
        build_model(cfg)


# -- against the reference ------------------------------------------------

def test_forward_logits_equal_the_reference():
    cfg = _cfg()
    model = build_model(cfg)
    params = _params(model, 0)
    toks = _tokens(1, (2, 40))
    with torch.no_grad():
        got, _ = model.apply(params, toks, compute_dtype=F32)
    want = _ref_logits(cfg, params, toks)
    assert _gap(got[..., :cfg.vocab_size], want) < TOL


@pytest.mark.parametrize("prompt_len", [3, 13])
def test_prefill_then_decode_through_the_pool_equals_the_full_forward(
        prompt_len):
    """A prompt (shorter than the conv window, and longer) prefilled into
    slot 2 of a 4-slot pool, then six greedy steps decoded on that slot's
    view of the pool: every step's logits against the reference's full
    forward over prompt and answer."""
    cfg = _cfg()
    model = build_model(cfg)
    params = _params(model, 2)
    mgr = CacheManager(model, num_slots=4, capacity=CAP, dtype=F32,
                       device="cpu")
    assert mgr.cache["segments"][0]["state"].dtype == F32
    prompt = _tokens(3, (1, prompt_len))
    with torch.no_grad():
        last, cache, pos = model.prefill(params, prompt, mgr.capacity,
                                         compute_dtype=F32,
                                         cache_dtype=F32)
        mgr.write_prefill(2, cache, pos)
        got = [last[0]]
        toks = [int(last[0].argmax())]
        view = tree_map(lambda c: c[:, 2:3], mgr.cache)
        for step in range(6):
            lg, _ = model.decode(params, torch.tensor([[toks[-1]]]), view,
                                 pos + step, compute_dtype=F32)
            got.append(lg[0, 0])
            toks.append(int(lg[0, 0].argmax()))
    full = torch.cat([prompt[0], torch.tensor(toks[:-1])])[None]
    want = _ref_logits(cfg, params, full)[0, prompt_len - 1:]
    got = torch.stack(got)[:, :cfg.vocab_size]
    assert _gap(got, want) < TOL


def test_grouped_tick_over_two_groups_equals_each_slot_alone():
    """Five lanes of two groups in a permuted subset of a 7-slot pool (two
    rows without a lane), at staggered positions, three ticks of the fleet
    step (pool-wide) against each lane
    decoded alone by `Model.decode` on its own row's weights: logits,
    tokens and every written cache row equal within fp32 rounding."""
    cfg = _cfg()
    model = build_model(cfg)
    stack = tree_map(lambda *t: torch.stack(t), *[_params(model, s)
                                                  for s in (4, 5)])
    rows, slots, lens = [0, 1, 1, 0, 1], [5, 0, 3, 6, 2], [4, 9, 2, 11, 6]
    pool = model.init_cache(7, CAP, F32, "cpu")
    solo, toks, pos = [], [], []
    with torch.no_grad():
        for slot, r, n in zip(slots, rows, lens):
            params = tree_map(lambda t, r=r: t[r], stack)
            last, c, p = model.prefill(params, _tokens(slot, (1, n)), CAP,
                                       compute_dtype=F32, cache_dtype=F32)
            for dst, src in zip(tree_leaves(pool), tree_leaves(c)):
                dst[:, slot] = src[:, 0]
            solo.append((params, c))
            toks.append(int(last[0].argmax()))
            pos.append(p)
        for _ in range(3):
            got, _ = fleet_decode_logits(model, stack, rows, toks, pool, pos,
                                         slots, compute_dtype=F32)
            for a, (params, c) in enumerate(solo):
                want, _ = model.decode(params, torch.tensor([[toks[a]]]), c,
                                       pos[a], compute_dtype=F32)
                assert _gap(got[a], want[0]) < TOL, a
                assert int(got[a, 0].argmax()) == int(want[0, 0].argmax())
                for dst, src in zip(tree_leaves(pool), tree_leaves(c)):
                    # the fp32 states reach ~90: relative rounding
                    assert torch.allclose(dst[:, slots[a]], src[:, 0],
                                          atol=TOL, rtol=TOL)
            toks = [int(g[0].argmax()) for g in got]
            pos = [p + 1 for p in pos]


def test_the_fleet_step_groups_this_family():
    """The fleet step's layout for this family: pool-wide (every row of the
    pool, each group's weights over all rows, one state step), so that on
    the card it replays CUDA graphs between the two attention calls; the
    xLSTM family stays grouped."""
    assert pool_wide(smoke_config(ARCH))
    assert pool_wide(get_config(ARCH))
    assert not pool_wide(smoke_config("xlstm-350m"))


# -- the multipliers, the attention scale and NoPE, one at a time ----------

def _logits(cfg, params, toks):
    with torch.no_grad():
        return build_model(cfg).apply(params, toks, compute_dtype=F32)[0]


def test_each_multiplier_and_the_scale_reach_the_reference():
    """From a config with every muP number at its default, each one set in
    turn moves the port's logits, and the port stays on the reference."""
    base = _cfg(embedding_multiplier=1.0, residual_multiplier=1.0,
                attention_multiplier=0.0, logits_scaling=1.0)
    params = _params(build_model(base), 6)
    toks = _tokens(7, (2, 24))
    z0 = _logits(base, params, toks)
    hd = base.resolved_head_dim
    for kw in (dict(embedding_multiplier=12.0),
               dict(residual_multiplier=0.22),
               dict(attention_multiplier=1.0 / hd),
               dict(logits_scaling=8.0)):
        cfg = dataclasses.replace(base, **kw)
        z = _logits(cfg, params, toks)
        assert float((z - z0).abs().max()) > 1e-3, kw
        want = _ref_logits(dataclasses.replace(
            cfg, attention_multiplier=cfg.attention_multiplier
            or hd ** -0.5), params, toks)
        assert _gap(z[..., :cfg.vocab_size], want) < TOL, kw


def test_logits_scaling_divides_and_the_default_scale_is_one_over_root_hd():
    base = _cfg(logits_scaling=1.0, attention_multiplier=0.0)
    params = _params(build_model(base), 8)
    toks = _tokens(9, (1, 20))
    z = _logits(base, params, toks)
    z8 = _logits(dataclasses.replace(base, logits_scaling=8.0), params, toks)
    assert torch.equal(z8, z / 8.0)
    root = dataclasses.replace(
        base, attention_multiplier=base.resolved_head_dim ** -0.5)
    assert _gap(_logits(root, params, toks), z) < TOL


def test_nope_ignores_rope_theta_and_rope_does_not():
    """Under "nope" no rotation enters (rope_theta 10000, 500000 or 0 give
    the same logits); the same model under "rope" differs."""
    nope = _cfg()
    params = _params(build_model(nope), 10)
    toks = _tokens(11, (1, 24))
    z = _logits(nope, params, toks)
    for theta in (500000.0, 0.0):
        assert torch.equal(_logits(dataclasses.replace(
            nope, rope_theta=theta), params, toks), z)
    rope = dataclasses.replace(nope, position_embedding_type="rope")
    assert L.uses_rope(rope) and not L.uses_rope(nope)
    assert float((_logits(rope, params, toks) - z).abs().max()) > 1e-3


# -- spans and counters ---------------------------------------------------

@pytest.fixture
def traced():
    tracing.collect()
    tracing.counters()
    tracing.enable()
    try:
        yield
    finally:
        tracing.disable()
        tracing.collect()
        tracing.counters()


def test_prefill_scan_and_grouped_tick_record_their_spans(traced):
    cfg = _cfg()
    model = build_model(cfg)
    stack = tree_map(lambda t: t[None], _params(model, 12))
    params = tree_map(lambda t: t[0], stack)
    pool = model.init_cache(3, CAP, F32, "cpu")
    with torch.no_grad():
        last, c, p = model.prefill(params, _tokens(13, (2, 10)), CAP,
                                   compute_dtype=F32, cache_dtype=F32)
        for dst, src in zip(tree_leaves(pool), tree_leaves(c)):
            dst[:, :2] = src
        fleet_decode_logits(model, stack, [0, 0], [1, 2], pool, [p, p],
                            [0, 1], compute_dtype=F32)
    spans = tracing.collect()
    mixers = sum(g.count for g in T.layer_plan(cfg) if g.kind == "mamba2")
    scans = [s for s in spans if s.name == "ecco.mamba.scan"]
    assert len(scans) == mixers
    assert all(s.attrs == {"rows": 2, "length": 10, "N": 16,
                           "path": "plain"} for s in scans)
    ticks = [s for s in spans if s.name == "ecco.tick.mamba"]
    layers = [s for s in spans if s.name == "ecco.tick.layers"]
    assert len(ticks) == mixers and len(layers) == 1
    assert all(s.parent == layers[0].id for s in ticks)
    # the CPU runs the plain scan: no kernel launch to count
    assert tracing.counters() == {}


def test_counter_records_on_and_costs_one_flag_check_off():
    tracing.counters()
    tracing.count("ecco.ssd_scan.cuda_core")
    assert tracing.counters() == {}
    tracing.enable()
    try:
        tracing.count("ecco.ssd_scan.cuda_core")
        tracing.count("ecco.ssd_scan.cuda_core", 2)
        tracing.count("ecco.ssd_scan.tensor_core")
    finally:
        tracing.disable()
    assert tracing.counters() == {"ecco.ssd_scan.cuda_core": 3,
                                  "ecco.ssd_scan.tensor_core": 1}
    assert tracing.counters() == {}
    assert tracing.span("ecco.tick.mamba") is tracing.span("ecco.mamba.scan")


# -- the shared paths at the new fields' defaults -------------------------

class _Ops(TorchDispatchMode):
    """Every aten op called, with its non-tensor arguments."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        self.ops.append((str(func), [a for a in list(args) + list(
            kwargs.values()) if not torch.is_tensor(a)]))
        return func(*args, **kwargs)


def _olmo_ops(**kw):
    """The aten ops of olmo-smoke's prefill of two prompts and one
    pool-wide fleet tick over them."""
    cfg = dataclasses.replace(smoke_config("olmo-1b"), **kw)
    model = build_model(cfg)
    stack = tree_map(lambda t: t[None].to(torch.bfloat16),
                     model.init(seed=0, device="cpu"))
    params = tree_map(lambda t: t[0], stack)
    pool = model.init_cache(2, 16, torch.bfloat16, "cpu")
    with torch.no_grad(), _Ops() as rec:
        _, c, p = model.prefill(params, _tokens(14, (2, 6)), 16)
        for dst, src in zip(tree_leaves(pool), tree_leaves(c)):
            dst[:] = src.to(dst.dtype)
        fleet_decode_logits(model, stack, [0, 0], [1, 2], pool, [p, p],
                            [0, 1])
    return rec.ops


def _added(ops, base):
    """The ops of `ops` beyond those of `base`, by name, and whether
    `ops` dropped any of `base`'s."""
    got = collections.Counter(n for n, _ in ops)
    want = collections.Counter(n for n, _ in base)
    return dict(got - want), bool(want - got)


def test_olmo_calls_no_new_op_at_the_defaults():
    """Each multiplier set adds exactly its own ops to olmo-smoke's prefill
    and tick (one multiply of the embedding per path, one of q per
    attention layer per path, one divide of the logits per path; the
    residual multiplier only an `alpha` on adds that are there anyway), so
    at the defaults none of them is called; and the only multiplies by 1.0
    are those of `1.0 / x` (a reciprocal, then the multiply: the RoPE
    frequencies), which were there before the fields."""
    ops = _olmo_ops()
    ones = [i for i, (n, a) in enumerate(ops)
            if n.startswith(("aten.mul", "aten.div")) and 1.0 in a]
    assert ones and all(ops[i - 1][0] == "aten.reciprocal.default"
                        for i in ones)
    layers = smoke_config("olmo-1b").num_layers
    paths = 2                     # the prefill, the tick
    mul, div = "aten.mul.Tensor", "aten.div.Tensor"
    assert _added(_olmo_ops(embedding_multiplier=12.0), ops) == \
        ({mul: paths}, False)
    assert _added(_olmo_ops(attention_multiplier=0.5), ops) == \
        ({mul: paths * layers}, False)
    assert _added(_olmo_ops(logits_scaling=8.0), ops) == ({div: paths}, False)
    res = _olmo_ops(residual_multiplier=0.22)
    assert [n for n, _ in res] == [n for n, _ in ops]
    assert sum(0.22 in a for _, a in res) == paths * 2 * layers


# -- the card ---------------------------------------------------------------

@pytest.mark.gpu
def test_cuda_core_scan_at_state_128():
    """granite's prefill scan, x (1, 2040, 64, 64) bf16, B and C (1, 2040,
    128), chunk 64: `plan` sends state 128 to the CUDA-core kernel, which
    agrees with `ref.ssd_chunked` on the same bf16 inputs (fp32 math on
    both sides: 2e-2 on y, the rounding of y to bf16; 1e-3 relative on
    the fp32 state), and the tracer counts the launch by its path and
    names the path on the open span."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.kernels import ops
    from repro_torch.kernels.ssd_scan import CUDA_CORE, plan
    g = torch.Generator(device="cuda").manual_seed(0)
    B, S, H, P, N, Q = 1, 2040, 64, 64, 128, 64
    x = torch.randn(B, S, H, P, device="cuda", generator=g).bfloat16()
    Bm = torch.randn(B, S, N, device="cuda", generator=g).bfloat16() * 0.3
    Cm = torch.randn(B, S, N, device="cuda", generator=g).bfloat16() * 0.3
    dt = torch.nn.functional.softplus(torch.randn(
        B, S, H, device="cuda", generator=g) - 1.0)
    A = -torch.exp(torch.randn(H, device="cuda", generator=g) * 0.5)
    D = torch.randn(H, device="cuda", generator=g)
    assert plan(x, Bm, Cm, Q) == CUDA_CORE
    tracing.counters()
    tracing.collect()
    tracing.enable()
    try:
        with tracing.span("ecco.mamba.scan", path="plain"):
            y, st = ops.ssd(x, dt, A, Bm, Cm, D, chunk=Q, return_state=True)
    finally:
        tracing.disable()
    assert tracing.counters() == {"ecco.ssd_scan.cuda_core": 1}
    assert [s.attrs for s in tracing.collect()] == [{"path": "cuda_core"}]
    wy, wst = kref.ssd_chunked(x, dt, A, Bm, Cm, D, chunk=Q,
                               return_state=True)
    torch.cuda.synchronize()
    assert float((y.float() - wy.float()).abs().max()) < 2e-2 * float(
        wy.float().abs().max())
    assert float((st - wst).abs().max()) < 1e-3 * float(wst.abs().max())


class _OpByOp:
    """The fleet step op by op, in the step's layout: the graphs'
    reference."""
    graphed = False
    captures = 0

    def __init__(self, model):
        self.model = model

    def __call__(self, params_stack, rows, tokens, cache, pos, slots=None,
                 groups=None):
        logits, cache = fleet_decode_logits(
            self.model, params_stack, rows, tokens, cache, pos, slots,
            compute_dtype=torch.bfloat16, groups=groups)
        return logits[:, 0].float().argmax(-1), cache


@pytest.mark.gpu
def test_graphed_tick_equals_op_by_op_on_the_card():
    """Two planes at smoke width on the card (bf16), two groups, two waves
    of queries of both groups at staggered lengths: the graphed plane
    captures once (its first tick) and replays every later tick, and every
    transcript equals its twin's, whose step runs op by op."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.core.trainer import SharedEngine
    from repro_torch.serve.plane import FleetServePlane, ServeConfig
    card = torch.device("cuda")
    engine = SharedEngine(_cfg(), device=card)
    params = [engine.model.init(seed=s, device=card) for s in range(2)]
    sample = np.random.default_rng(7).integers(0, 256, size=(2, 16))

    def serve(plane):
        for g in range(2):
            plane.publish(f"g{g}", params[g], sample)
        for wave in range(2):
            for i in range(5):
                plane.enqueue(f"w{wave}.{i}", f"g{(i + wave) % 2}", np.random
                              .default_rng(10 * wave + i).integers(
                                  0, 256, size=4 + 3 * i))
            plane.pump()
        return plane.drain()
    graphed, eager = (FleetServePlane(engine, ServeConfig(
        num_slots=6, capacity=CAP, max_new=5, gate_margin=-1.0)) for _ in
        range(2))
    eager._fleet_decode = _OpByOp(engine.model)
    got, want = serve(graphed), serve(eager)
    assert len(got) == 10 and got == want
    ticks = len(graphed.tick_log)
    assert (graphed.graph_captures, graphed.eager_ticks,
            graphed.graph_ticks) == (1, 1, ticks - 1)
