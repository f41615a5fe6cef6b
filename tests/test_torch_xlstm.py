"""The port's xlstm-350m (the xLSTM family: alternating mLSTM and sLSTM
blocks) held to the JAX package at smoke width.

xlstm smoke: 2 layers (one mLSTM block, one sLSTM block), d_model 64, 2
heads (mLSTM head dim 64, sLSTM head dim 32), LayerNorm with affine,
vocabulary 64 (padded to 128). The JAX `Model.init` weights are bridged
into the port (`repro_torch.models.convert`), so both packages run the
same weights, at fp32 compute.

The JAX prefill builds its mLSTM decode state with `mlstm_chunked`, whose
final state is wrong when the prompt is longer than a chunk (64) and not
a multiple of it (tests/test_torch_mlstm.py). Prefill + decode is held to
the JAX package at S = 64 and 128, and at a ragged S = 70 to a JAX decode
that steps the whole prompt token by token from a fresh cache (the
oracle's state).
"""
import dataclasses

import numpy as np
import pytest
from config_parity import reference_fields

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import smoke_config as jax_smoke_config  # noqa: E402
from repro.models import xlstm as jx  # noqa: E402
from repro.models.model import build_model as jax_build_model  # noqa: E402
from repro.models.param import is_spec  # noqa: E402
from repro_torch.configs import get_config, smoke_config  # noqa: E402
from repro_torch.models import transformer as tT  # noqa: E402
from repro_torch.models import xlstm as tx  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.models.param import Spec, tree_map  # noqa: E402
from repro_torch.serve.kvcache import CacheManager, ServeLoop  # noqa: E402

VOCAB = 64
ARCH = "xlstm-350m"
F32 = jnp.float32
# fp32 compute and fp32 states: the two packages differ by summation order
# only (their matmuls and reductions sum in other orders); observed below
# 1e-5 on logits of magnitude up to about 1
FP32_TOL = 1e-4
# fp32 compute over a bf16 pool: both round C, n, h, c and the conv rows
# to bf16 after every step, but where their fp32 values straddle a bf16
# rounding boundary the stored values differ by one ulp, which the next
# steps carry into the logits (the tolerance of tests/test_torch_hymba.py)
BF16_CACHE_TOL = 5e-3
# greedy tokens are compared exactly where the reference's top-1 leads its
# top-2 by more than twice the logit agreement (tests/test_torch_serve.py)
LOGIT_TOL = BF16_CACHE_TOL


@pytest.fixture(scope="module")
def models():
    jcfg = dataclasses.replace(jax_smoke_config(ARCH), vocab_size=VOCAB)
    tcfg = dataclasses.replace(smoke_config(ARCH), vocab_size=VOCAB)
    jm = jax_build_model(jcfg)
    jp = jax.jit(jm.init)(jax.random.PRNGKey(0))
    tm = build_model(tcfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return jm, jp, tm, tp


def _tokens(shape, seed=0):
    return np.random.default_rng(seed).integers(0, VOCAB, size=shape)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _paths(tree, prefix=()):
    """{key path: leaf} of a tree of dicts and lists."""
    if isinstance(tree, dict):
        return {p: v for k, sub in tree.items()
                for p, v in _paths(sub, prefix + (k,)).items()}
    if isinstance(tree, (list, tuple)):
        return {p: v for i, sub in enumerate(tree)
                for p, v in _paths(sub, prefix + (i,)).items()}
    return {prefix: tree}


def _dtype_name(t):
    return str(t.dtype).split(".")[-1]


def test_configs_and_layer_plan_match_jax():
    from repro.models.transformer import layer_plan as jax_layer_plan
    for get, jget in ((get_config, jax_get_config),
                      (smoke_config, jax_smoke_config)):
        cfg, jcfg = get(ARCH), jget(ARCH)
        assert reference_fields(cfg, jcfg) == dataclasses.asdict(jcfg)
        assert [(s.kind, s.count, s.window) for s in tT.layer_plan(cfg)] == \
            [(s.kind, s.count, s.window) for s in jax_layer_plan(jcfg)]
    full = get_config(ARCH)
    assert [(s.kind, s.count) for s in tT.layer_plan(full)] == \
        [("mlstm", 1), ("slstm", 1)] * 12
    assert tx.mlstm_heads(full) == (2048, 4, 512)
    assert build_model(full).num_params() == \
        jax_build_model(jax_get_config(ARCH)).num_params()
    # the other families' plans keep their block segments
    assert {s.kind for s in tT.layer_plan(get_config("hymba-1.5b"))} == \
        {"block"}


def test_spec_trees_and_bridge_agree_key_for_key(models):
    """The parameter spec (norm scale and bias, the mLSTM and sLSTM
    leaves), the bridged JAX tree and the cache spec ("m" leaves
    "neg_inf") have the same key paths, shapes and init rules in both
    packages."""
    jm, jp, tm, tp = models
    jspec, tspec = _paths(jm.spec), _paths(tm.spec)
    assert sorted(tspec) == sorted(jspec)
    for path, s in tspec.items():
        assert isinstance(s, Spec) and is_spec(jspec[path])
        assert (s.shape, s.init, s.scale) == \
            (jspec[path].shape, jspec[path].init, jspec[path].scale), path
    assert {("final_norm", "bias"), ("embed", "unembed"),
            ("segments", 0, "wq"), ("segments", 1, "r_gates"),
            ("segments", 1, "ffn", "w_down")} <= set(tspec)
    bridged = _paths(tp)
    assert sorted(bridged) == sorted(tspec)
    for path, t in bridged.items():
        assert tuple(t.shape) == tspec[path].shape, path
    assert tm.num_params() == jm.num_params()
    jc, tc = _paths(jm.cache_spec(3, 20)), _paths(tm.cache_spec(3, 20))
    assert sorted(tc) == sorted(jc)
    for path, s in tc.items():
        assert (s.shape, s.init) == (jc[path].shape, jc[path].init), path
    assert tc[("segments", 0, "m")].init == "neg_inf"
    assert tc[("segments", 1, "m")].init == "neg_inf"


def test_full_width_trees_match_jax():
    """The 24-segment tree of xlstm-350m, key for key: the weight bridge
    carries it as it is."""
    jm, tm = (jax_build_model(jax_get_config(ARCH)),
              build_model(get_config(ARCH)))
    jspec, tspec = _paths(jm.spec), _paths(tm.spec)
    assert sorted(tspec) == sorted(jspec) and len(tm.spec["segments"]) == 24
    for path, s in tspec.items():
        assert s.shape == jspec[path].shape, path
    jc, tc = _paths(jm.cache_spec(4, 1056)), _paths(tm.cache_spec(4, 1056))
    assert sorted(tc) == sorted(jc)
    assert all(s.shape == jc[p].shape for p, s in tc.items())
    assert tc[("segments", 0, "C")].shape == (1, 4, 4, 512, 512)


def test_init_cache_matches_jax(models):
    """"m" leaves fp32 and -inf whatever the pool dtype, every other leaf
    zeros in it, as JAX `Model.init_cache`."""
    jm, _, tm, _ = models
    for jdt, tdt in ((jnp.bfloat16, torch.bfloat16),
                     (jnp.float32, torch.float32)):
        want = _paths(jm.init_cache(3, 20, jdt))
        got = _paths(tm.init_cache(3, 20, tdt, device="cpu"))
        assert sorted(got) == sorted(want)
        for path, t in got.items():
            assert _dtype_name(t) == str(want[path].dtype), path
            np.testing.assert_array_equal(_np(t), _np(want[path]))
        assert all(bool(torch.isneginf(t).all()) for p, t in got.items()
                   if p[-1] == "m")
    for kind, init in (("mlstm", tx.mlstm_init_cache),
                       ("slstm", tx.slstm_init_cache)):
        jinit = getattr(jx, f"{kind}_init_cache")
        want = jinit(jm.cfg, 2, jnp.bfloat16)
        got = init(tm.cfg, 2, torch.bfloat16)
        for k, t in got.items():
            assert tuple(t.shape) == want[k].shape, (kind, k)
            assert _dtype_name(t) == str(want[k].dtype), (kind, k)
            np.testing.assert_array_equal(_np(t), _np(want[k]))


def _blocks(jp, tp, seg):
    """Layer 0 of segment `seg` of the JAX and the bridged parameters."""
    return (jax.tree.map(lambda a: a[0], jp["segments"][seg]),
            tree_map(lambda t: t[0], tp["segments"][seg]))


@pytest.mark.parametrize("S", [12, 70])
def test_mlstm_block_matches_jax(models, S):
    """S = 70 spans two of the block's 64-step chunks, ragged. The output
    equals JAX's; the prefill cache equals that of a JAX block stepped
    token by token from a fresh cache (the oracle's state)."""
    jm, jp, tm, tp = models
    cfg, jcfg = tm.cfg, jm.cfg
    jb, tb = _blocks(jp, tp, 0)
    x = np.random.default_rng(S).standard_normal((2, S, 64)).astype(
        np.float32)
    want, _ = jax.jit(jx.apply_mlstm_block, static_argnums=0)(
        jcfg, jb, jnp.asarray(x))
    got, none = tx.apply_mlstm_block(cfg, tb, torch.from_numpy(x))
    assert none is None
    np.testing.assert_allclose(_np(got), _np(want), atol=FP32_TOL, rtol=0)
    out, cache = tx.mlstm_block_states(cfg, tb, torch.from_numpy(x))
    np.testing.assert_allclose(_np(out), _np(got), atol=0, rtol=0)
    step = jax.jit(lambda p, xt, c: jx.apply_mlstm_block(jcfg, p, xt,
                                                         cache=c))
    jc = jx.mlstm_init_cache(jcfg, 2, F32)
    for t in range(S):
        _, jc = step(jb, jnp.asarray(x[:, t:t + 1]), jc)
    for k in ("C", "n", "m", "conv"):
        np.testing.assert_allclose(_np(cache[k]), _np(jc[k]), atol=FP32_TOL,
                                   rtol=FP32_TOL, err_msg=k)
    assert cache["m"].dtype == torch.float32


def test_mlstm_and_slstm_decode_in_place_match_jax(models):
    """Prefill 9 steps, then 4 decode steps of each block; the port
    overwrites the cache it is given (a view of a larger pool here, in
    bf16 with m in fp32) and returns the JAX step's output."""
    jm, jp, tm, tp = models
    cfg, jcfg = tm.cfg, jm.cfg
    x = np.random.default_rng(3).standard_normal((2, 13, 64)).astype(
        np.float32)
    for seg, states, apply in ((0, "mlstm_block_states", "apply_mlstm_block"),
                               (1, "slstm_block_states", "apply_slstm_block")):
        jb, tb = _blocks(jp, tp, seg)
        _, jc = jax.jit(getattr(jx, states), static_argnums=0)(
            jcfg, jb, jnp.asarray(x[:, :9]))
        _, tc = getattr(tx, states)(cfg, tb, torch.from_numpy(x[:, :9]))
        pool = {k: torch.zeros((3,) + tuple(v.shape[1:]),
                               dtype=torch.float32 if k == "m"
                               else torch.bfloat16) for k, v in tc.items()}
        view = {k: v[1:3] for k, v in pool.items()}          # slots 1, 2
        for k in view:
            view[k].copy_(tc[k])
        jc = {k: v.astype(jnp.float32 if k == "m" else jnp.bfloat16)
              for k, v in jc.items()}
        step = jax.jit(lambda p, xt, c: getattr(jx, apply)(jcfg, p, xt,
                                                           cache=c))
        for t in range(9, 13):
            jy, jc = step(jb, jnp.asarray(x[:, t:t + 1]), jc)
            jc = {k: v.astype(jnp.float32 if k == "m" else jnp.bfloat16)
                  for k, v in jc.items()}
            ty, back = getattr(tx, apply)(cfg, tb,
                                          torch.from_numpy(x[:, t:t + 1]),
                                          cache=view)
            assert back is view
            np.testing.assert_allclose(_np(ty), _np(jy), atol=BF16_CACHE_TOL,
                                       rtol=0, err_msg=f"{apply} step {t}")
            for k in view:
                np.testing.assert_allclose(_np(pool[k][1:3]), _np(jc[k]),
                                           atol=BF16_CACHE_TOL, rtol=2 ** -7,
                                           err_msg=f"{apply} {k}")
        assert not any(bool(pool[k][0].any()) for k in pool if k != "m")


def test_slstm_block_matches_jax(models):
    jm, jp, tm, tp = models
    jb, tb = _blocks(jp, tp, 1)
    x = np.random.default_rng(5).standard_normal((2, 23, 64)).astype(
        np.float32)
    want, _ = jax.jit(jx.apply_slstm_block, static_argnums=0)(
        jm.cfg, jb, jnp.asarray(x))
    got, none = tx.apply_slstm_block(tm.cfg, tb, torch.from_numpy(x))
    assert none is None
    np.testing.assert_allclose(_np(got), _np(want), atol=FP32_TOL, rtol=0)
    _, jc = jax.jit(jx.slstm_block_states, static_argnums=0)(
        jm.cfg, jb, jnp.asarray(x))
    out, tc = tx.slstm_block_states(tm.cfg, tb, torch.from_numpy(x))
    np.testing.assert_allclose(_np(out), _np(got), atol=0, rtol=0)
    for k in ("h", "c", "n", "m", "conv"):
        np.testing.assert_allclose(_np(tc[k]), _np(jc[k]), atol=FP32_TOL,
                                   rtol=FP32_TOL, err_msg=k)


def test_forward_logits_match_jax(models):
    jm, jp, tm, tp = models
    toks = _tokens((2, 70))
    want, _ = jax.jit(lambda p, t: jm.apply(p, t, compute_dtype=F32))(
        jp, jnp.asarray(toks))
    got, aux = tm.apply(tp, torch.from_numpy(toks),
                        compute_dtype=torch.float32)
    assert got.shape == (2, 70, 128) and float(aux) == 0.0
    assert bool((got[..., VOCAB:] < -1e29).all())
    np.testing.assert_allclose(_np(got)[..., :VOCAB],
                               _np(want)[..., :VOCAB], atol=FP32_TOL, rtol=0)


def _decode_all(jm, jp, tokens, start_cache, pos0, steps):
    """JAX logits of `steps` decode calls from `start_cache`, fp32."""
    decode = jax.jit(lambda p, t, c, pos: jm.decode(p, t, c, pos,
                                                    compute_dtype=F32))
    out, c = [], start_cache
    for s in range(steps):
        lg, c = decode(jp, jnp.asarray(tokens[:, s:s + 1]), c, pos0 + s)
        out.append(np.asarray(lg[:, -1, :VOCAB], np.float32))
    return out, c


@pytest.mark.parametrize("S", [64, 128])
def test_prefill_then_decode_match_jax(models, S):
    """prefill(S) with S a multiple of the mLSTM chunk, then 3 decode
    steps; fp32 compute and an fp32 cache."""
    jm, jp, tm, tp = models
    toks = _tokens((2, S + 3), seed=S)
    jl, jc, jpos = jax.jit(lambda p, t: jm.prefill(
        p, t, S + 3, compute_dtype=F32, cache_dtype=F32))(
            jp, jnp.asarray(toks[:, :S]))
    tl, tc, tpos = tm.prefill(tp, torch.from_numpy(toks[:, :S]), S + 3,
                              compute_dtype=torch.float32,
                              cache_dtype=torch.float32)
    assert tpos == int(jpos) == S
    np.testing.assert_allclose(_np(tl)[:, :VOCAB], _np(jl)[:, :VOCAB],
                               atol=FP32_TOL, rtol=0)
    jleaves, tleaves = _paths(jc), _paths(tc)
    assert sorted(tleaves) == sorted(jleaves)
    for path, t in tleaves.items():
        assert _dtype_name(t) == str(jleaves[path].dtype), path
        np.testing.assert_allclose(_np(t), _np(jleaves[path]), atol=FP32_TOL,
                                   rtol=FP32_TOL, err_msg=str(path))
    want, _ = _decode_all(jm, jp, toks[:, S:], jc, jpos, 3)
    for step in range(3):
        tok = toks[:, S + step:S + step + 1]
        tl, tc = tm.decode(tp, torch.from_numpy(tok), tc, tpos + step,
                           compute_dtype=torch.float32)
        np.testing.assert_allclose(_np(tl)[:, -1, :VOCAB], want[step],
                                   atol=FP32_TOL, rtol=0,
                                   err_msg=f"decode step {step}")


def test_ragged_prefill_then_decode_match_oracle_state(models):
    """prefill(70) (a ragged second chunk), then 3 decode steps, against a
    JAX decode that steps all 73 tokens from a fresh fp32 cache: the
    port's prefill state is the recurrence's."""
    jm, jp, tm, tp = models
    S = 70
    toks = _tokens((2, S + 3), seed=9)
    fresh = jm.init_cache(2, S + 3, jnp.float32)
    want, _ = _decode_all(jm, jp, toks, fresh, 0, S + 3)
    tl, tc, tpos = tm.prefill(tp, torch.from_numpy(toks[:, :S]), S + 3,
                              compute_dtype=torch.float32)
    assert tpos == S
    np.testing.assert_allclose(_np(tl)[:, :VOCAB], want[S - 1],
                               atol=FP32_TOL, rtol=0)
    for step in range(3):
        tok = toks[:, S + step:S + step + 1]
        tl, tc = tm.decode(tp, torch.from_numpy(tok), tc, tpos + step,
                           compute_dtype=torch.float32)
        np.testing.assert_allclose(_np(tl)[:, -1, :VOCAB], want[S + step],
                                   atol=FP32_TOL, rtol=0,
                                   err_msg=f"decode step {step}")


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------
def _jax_steps(jm, cap):
    """The JAX reference's serving steps at fp32 compute, compiled once:
    prefill, decode, and the pool's cast of every cache leaf to its pool
    dtype (bf16, the "m" leaves fp32), as the JAX pool casts on write."""
    pool_dtypes = jax.tree.map(lambda a: a.dtype,
                               jm.init_cache(1, cap, jnp.bfloat16))
    return (jax.jit(lambda p, t: jm.prefill(p, t, cap, compute_dtype=F32)),
            jax.jit(lambda p, t, c, pos: jm.decode(p, t, c, pos,
                                                   compute_dtype=F32)),
            jax.jit(lambda c: jax.tree.map(lambda a, d: a.astype(d), c,
                                           pool_dtypes)))


def _jax_greedy_check(steps, jp, prompt, tokens):
    """Drive the JAX model at fp32 compute through `tokens`, the port's
    transcript of `prompt` (teacher forcing), its cache stored as the JAX
    serving pool stores it after prefill and after every decode step.
    Returns per emitted token the reference's argmax, its top-1/top-2
    logit gap, and how far the port's token's logit lies below the top."""
    prefill, decode, pool = steps
    last, cache, pos = prefill(jp, jnp.asarray(prompt)[None])
    cache = pool(cache)
    logits = [np.asarray(last[0, :VOCAB], np.float32)]
    for step, tok in enumerate(tokens[:-1]):
        lg, cache = decode(jp, jnp.asarray([[tok]], jnp.int32), cache,
                           pos + step)
        cache = pool(cache)
        logits.append(np.asarray(lg[0, -1, :VOCAB], np.float32))
    top = [int(np.argmax(lg)) for lg in logits]
    gaps = [float(np.diff(np.sort(lg)[-2:])[0]) for lg in logits]
    short = [float(lg.max() - lg[t]) for lg, t in zip(logits, tokens)]
    return top, gaps, short


@pytest.mark.parametrize("layout,slots,lengths", [
    ("contiguous", 2, [13, 13, 12, 12]),
    ("scattered", 3, [13, 9, 13])])
def test_serve_loop_matches_jax_greedy_reference(models, layout, slots,
                                                 lengths):
    """The port's ServeLoop (fp32 compute, bf16 pool with m in fp32)
    against the JAX greedy reference. "contiguous": equal prompts share
    slots 0-1 and decode on a view of the pool; "scattered": slots 0 and 2
    share a position while slot 1 does not, so the loop gathers and
    writes back. Prompts shorter than the mLSTM chunk, where the JAX
    prefill state is right.

    Where the reference's top-1 leads its top-2 by more than 2 LOGIT_TOL
    the port's token must be the reference's argmax, and at a nearer tie
    it must lie within 2 LOGIT_TOL of the top."""
    jm, jp, tm, tp = models
    rng = np.random.default_rng(4)
    prompts = {f"r{i}": rng.integers(0, VOCAB, size=n)
               for i, n in enumerate(lengths)}
    capacity, max_new = 24, 6
    loop = ServeLoop(tm, tp, num_slots=slots, capacity=capacity,
                     max_new=max_new, compute_dtype=torch.float32)
    calls = []
    decode_slots = loop._decode_slots

    def record(slot_list, pos):
        calls.append(list(slot_list))
        return decode_slots(slot_list, pos)

    loop._decode_slots = record
    pending = list(prompts.items())
    done = {}
    while pending or loop.mgr.active():
        while pending and loop.mgr.free_slots():
            loop.submit(*pending.pop(0))
        loop.tick()
        done.update(loop.drain())
    assert set(done) == set(prompts)
    contiguous = [c == list(range(c[0], c[0] + len(c))) for c in calls]
    if layout == "contiguous":
        assert all(contiguous) and any(len(c) > 1 for c in calls), calls
    else:
        assert not all(contiguous), calls

    decided = 0
    steps = _jax_steps(jm, capacity)
    for rid, prompt in prompts.items():
        got = done[rid]
        assert len(got) == max_new
        top, gaps, short = _jax_greedy_check(steps, jp, prompt, got)
        for step, (t, want, gap, sh) in enumerate(zip(got, top, gaps,
                                                      short)):
            assert sh <= 2 * LOGIT_TOL, (rid, step, got, top, short)
            if gap > 2 * LOGIT_TOL:
                assert t == want, (rid, step, got, top, gaps)
                decided += 1
    assert decided >= len(prompts) * max_new // 2


def test_pool_keeps_m_in_fp32_and_refuses_oversized(models):
    _, _, tm, tp = models
    mgr = CacheManager(tm, num_slots=2, capacity=16, device="cpu")
    assert (mgr.user_capacity, mgr.capacity) == (16, 16)
    ml, sl = mgr.cache["segments"]
    assert ml["C"].shape == (1, 2, 2, 64, 64) and sl["h"].shape == \
        (1, 2, 2, 32)
    for path, t in _paths(mgr.cache).items():
        want = torch.float32 if path[-1] == "m" else torch.bfloat16
        assert t.dtype == want, path
    with pytest.raises(ValueError, match="does not fit"):
        mgr.check_fit(13, 5)
    loop = ServeLoop(tm, tp, num_slots=1, capacity=16, max_new=5,
                     compute_dtype=torch.float32)
    with pytest.raises(ValueError, match="largest admissible prompt is 12"):
        loop.submit("big", _tokens(13))
    assert loop.mgr.free_slots() == [0]


@pytest.mark.parametrize("change", [
    dict(moe="moe"), dict(qk_norm=True), dict(embedding_frontend=True),
    dict(causal=False), dict(norm="qnorm")],
    ids=["moe", "qk_norm", "embedding_frontend", "non_causal", "norm"])
def test_check_ported_still_refuses(change):
    """The xLSTM family with a field that only the attention families
    read (a MoE config, qk-norm, non-causal attention) or an embedding
    frontend: the port accepts it as the reference does, with the same
    spec tree and the same fp32 forward logits on bridged weights (frame
    embeddings in for the frontend). A norm that neither package knows
    is still refused by both, with the reference's ValueError."""
    from repro.configs.base import MoEConfig as JMoEConfig
    from repro_torch.configs.base import MoEConfig
    jchange = dict(change)
    if change.get("moe"):
        change = dict(moe=MoEConfig(num_experts=4, top_k=2, d_ff_expert=32))
        jchange = dict(moe=JMoEConfig(num_experts=4, top_k=2,
                                      d_ff_expert=32))
    jcfg = dataclasses.replace(jax_smoke_config(ARCH), vocab_size=VOCAB,
                               **jchange)
    cfg = dataclasses.replace(smoke_config(ARCH), vocab_size=VOCAB, **change)
    if cfg.norm == "qnorm":
        with pytest.raises(ValueError, match="qnorm"):
            jax_build_model(jcfg)
        with pytest.raises(ValueError, match="qnorm"):
            build_model(cfg)
        return
    jm, tm = jax_build_model(jcfg), build_model(cfg)
    jspec, tspec = _paths(jm.spec), _paths(tm.spec)
    assert {k: s.shape for k, s in tspec.items()} == \
        {k: s.shape for k, s in jspec.items()}
    jp = jax.jit(jm.init)(jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    rng = np.random.default_rng(7)
    x = (rng.standard_normal((2, 16, cfg.d_model)).astype(np.float32)
         if cfg.embedding_frontend else _tokens((2, 16), seed=7))
    want, _ = jax.jit(lambda p, t: jm.apply(p, t, compute_dtype=F32))(
        jp, jnp.asarray(x))
    got, _ = tm.apply(tp, torch.from_numpy(x), compute_dtype=torch.float32)
    np.testing.assert_allclose(_np(got)[..., :VOCAB], _np(want)[..., :VOCAB],
                               atol=FP32_TOL, rtol=0)


def test_gelu_is_accepted_only_for_the_ssm_family():
    """GELU was once accepted only where the xLSTM blocks ignore it; the
    dense family now runs the reference's GELU MLP (w_in, w_down; the
    tanh approximation of jax.nn.gelu): the same fp32 logits on bridged
    weights."""
    build_model(smoke_config(ARCH))                      # act="gelu"
    jcfg = dataclasses.replace(jax_smoke_config("olmo-1b"), act="gelu",
                               vocab_size=VOCAB)
    dense = dataclasses.replace(smoke_config("olmo-1b"), act="gelu",
                                vocab_size=VOCAB)
    jm, tm = jax_build_model(jcfg), build_model(dense)
    assert sorted(tm.spec["segments"][0]["mlp"]) == ["w_down", "w_in"]
    jp = jax.jit(jm.init)(jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    x = _tokens((2, 16), seed=8)
    want, _ = jax.jit(lambda p, t: jm.apply(p, t, compute_dtype=F32))(
        jp, jnp.asarray(x))
    got, _ = tm.apply(tp, torch.from_numpy(x), compute_dtype=torch.float32)
    np.testing.assert_allclose(_np(got)[..., :VOCAB], _np(want)[..., :VOCAB],
                               atol=FP32_TOL, rtol=0)
