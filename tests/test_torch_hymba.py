"""The port's hymba (hybrid attention + Mamba heads, sliding window with
meta tokens) held to the JAX package at smoke width.

hymba smoke: 2 layers (layer 0 global, layer 1 windowed), d_model 64, 4
query and 2 KV heads, window 16, 4 meta tokens, Mamba state 8, vocabulary
64 (padded to 128). The JAX `Model.init` weights are bridged into the port
(`repro_torch.models.convert`), so both packages run the same weights, at
fp32 compute. Prompts of 12 and 13 tokens put S + meta at 16 and 17, so
the windowed layer's ring wraps at prefill or within the first decode
steps.
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
from repro.models import layers as jL  # noqa: E402
from repro.models.model import build_model as jax_build_model  # noqa: E402
from repro.models.param import is_spec  # noqa: E402
from repro_torch.configs import get_config, smoke_config  # noqa: E402
from repro_torch.models import layers as tL  # noqa: E402
from repro_torch.models import transformer as tT  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.models.param import Spec  # noqa: E402
from repro_torch.serve.kvcache import CacheManager, ServeLoop  # noqa: E402

VOCAB = 64
ARCH = "hymba-1.5b"
F32 = jnp.float32
# fp32 compute, fp32 cache: the two packages differ by summation order only
FP32_TOL = 1e-4
# fp32 compute over a bf16 cache: the JAX global-layer decode rounds its
# softmax probabilities to bf16 before the PV product, the port's
# attention kernel (here its plain version) keeps them in fp32
# (tests/test_torch_model.py BF16_CACHE_TOL)
BF16_CACHE_TOL = 5e-3
# greedy tokens are compared exactly; the reference's top-1/top-2 logit gap
# must exceed twice the logit agreement at every step, so that no near-tie
# decides a token (tests/test_torch_serve.py)
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


def test_configs_and_layer_plan_match_jax():
    from repro.models.transformer import layer_plan as jax_layer_plan
    for get, jget in ((get_config, jax_get_config),
                      (smoke_config, jax_smoke_config)):
        cfg, jcfg = get(ARCH), jget(ARCH)
        assert reference_fields(cfg, jcfg) == dataclasses.asdict(jcfg)
        assert [(s.count, s.window) for s in tT.layer_plan(cfg)] == \
            [(s.count, s.window) for s in jax_layer_plan(jcfg)]
    full = get_config(ARCH)
    assert [(s.count, s.window) for s in tT.layer_plan(full)] == \
        [(1, 0), (14, 1024), (1, 0), (15, 1024), (1, 0)]
    assert build_model(full).num_params() == \
        jax_build_model(jax_get_config(ARCH)).num_params()


def test_spec_trees_and_bridge_agree_key_for_key(models):
    """The parameter spec, the bridged JAX tree (meta, embed.unembed,
    mamba.*, mix_*) and the cache spec have the same key paths and shapes
    in both packages."""
    jm, jp, tm, tp = models
    jspec, tspec = _paths(jm.spec), _paths(tm.spec)
    assert sorted(tspec) == sorted(jspec)
    for path, s in tspec.items():
        assert isinstance(s, Spec) and is_spec(jspec[path])
        assert (s.shape, s.init, s.scale) == \
            (jspec[path].shape, jspec[path].init, jspec[path].scale), path
    assert {("meta",), ("embed", "unembed"), ("segments", 1, "mix_a"),
            ("segments", 0, "mamba", "A_log")} <= set(tspec)
    bridged = _paths(tp)
    assert sorted(bridged) == sorted(tspec)
    for path, t in bridged.items():
        assert tuple(t.shape) == tspec[path].shape, path
    assert tm.num_params() == jm.num_params()
    jc, tc = _paths(jm.cache_spec(3, 20)), _paths(tm.cache_spec(3, 20))
    assert sorted(tc) == sorted(jc)
    for path, s in tc.items():
        assert s.shape == jc[path].shape, path


def _attn_inputs(S, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, S, 64)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S), (2, S)).copy()
    return x, pos


@pytest.mark.parametrize("S,meta", [(23, 4), (37, 4), (23, 0), (16, 4)])
def test_attention_windowed_matches_jax(models, S, meta):
    """S = 23 and 37 pad to 32 and 48 (one and two blocks of 16 and a
    ragged tail); the meta prefix stays visible beyond the window."""
    jm, jp, tm, tp = models
    cfg, jcfg = tm.cfg, jm.cfg
    jattn = jax.tree.map(lambda a: a[0], jp["segments"][1]["attn"])
    tattn = {k: v[0] for k, v in tp["segments"][1]["attn"].items()}
    x, pos = _attn_inputs(S, seed=S + meta)
    want, (jk, jv) = jax.jit(jL.attention_windowed, static_argnums=0,
                             static_argnames=("window", "meta"))(
        jcfg, jattn, jnp.asarray(x), jnp.asarray(pos), window=16, meta=meta)
    got, (tk, tv) = tL.attention_windowed(cfg, tattn, torch.from_numpy(x),
                                          torch.from_numpy(pos), window=16,
                                          meta=meta)
    np.testing.assert_allclose(_np(got), _np(want), atol=FP32_TOL, rtol=0)
    np.testing.assert_allclose(_np(tk), _np(jk), atol=FP32_TOL, rtol=0)
    np.testing.assert_allclose(_np(tv), _np(jv), atol=FP32_TOL, rtol=0)


@pytest.mark.parametrize("pos", [17, 30, 41])
@pytest.mark.parametrize("cache_dtype", ["float32", "bfloat16"])
def test_ring_attention_decode_matches_jax(models, pos, cache_dtype):
    """A ring of width 16 plus 4 meta rows, decoded at positions past the
    window (slots hold positions from before and after the write)."""
    jm, jp, tm, tp = models
    cfg, jcfg = tm.cfg, jm.cfg
    jattn = jax.tree.map(lambda a: a[0], jp["segments"][1]["attn"])
    tattn = {k: v[0] for k, v in tp["segments"][1]["attn"].items()}
    rng = np.random.default_rng(pos)
    x = rng.standard_normal((2, 1, 64)).astype(np.float32)
    ring = {k: rng.standard_normal((2, n, 2, 16)).astype(np.float32)
            for k, n in (("k", 16), ("v", 16), ("mk", 4), ("mv", 4))}
    jdt, tdt = getattr(jnp, cache_dtype), getattr(torch, cache_dtype)
    jc = {k: jnp.asarray(v, jdt) for k, v in ring.items()}
    tc = {k: torch.from_numpy(v).to(tdt) for k, v in ring.items()}
    want, jnew = jax.jit(jL.attention_decode, static_argnums=0,
                         static_argnames=("window", "meta"))(
        jcfg, jattn, jnp.asarray(x), jc, pos, window=16, meta=4)
    got, tnew = tL.attention_decode(cfg, tattn, torch.from_numpy(x), tc, pos,
                                    window=16, meta=4)
    assert tnew is tc                                    # written in place
    np.testing.assert_allclose(_np(got), _np(want), atol=FP32_TOL, rtol=0)
    for k in ring:
        np.testing.assert_allclose(_np(tc[k]), _np(jnew[k]), atol=FP32_TOL,
                                   rtol=2 ** -8)


def test_forward_logits_match_jax(models):
    jm, jp, tm, tp = models
    toks = _tokens((2, 24))
    want, _ = jax.jit(lambda p, t: jm.apply(p, t, compute_dtype=F32))(
        jp, jnp.asarray(toks))
    got, aux = tm.apply(tp, torch.from_numpy(toks),
                        compute_dtype=torch.float32)
    assert got.shape == (2, 24, 128) and float(aux) == 0.0
    assert bool((got[..., VOCAB:] < -1e29).all())
    np.testing.assert_allclose(_np(got)[..., :VOCAB],
                               _np(want)[..., :VOCAB], atol=FP32_TOL, rtol=0)


@pytest.mark.parametrize("cache_dtype,tol", [("float32", FP32_TOL),
                                             ("bfloat16", BF16_CACHE_TOL)])
def test_prefill_then_decode_across_ring_wrap(models, cache_dtype, tol):
    """prefill(12) (S + meta = 16 fills the ring exactly), then 3 decode
    steps at positions 16-18, each writing over the ring's oldest slot."""
    jm, jp, tm, tp = models
    toks = _tokens((2, 15), seed=1)
    S, cap = 12, 12 + 3 + 4
    jdt, tdt = getattr(jnp, cache_dtype), getattr(torch, cache_dtype)
    jl, jc, jpos = jax.jit(lambda p, t: jm.prefill(
        p, t, cap, compute_dtype=F32, cache_dtype=jdt))(
            jp, jnp.asarray(toks[:, :S]))
    tl, tc, tpos = tm.prefill(tp, torch.from_numpy(toks[:, :S]), cap,
                              compute_dtype=torch.float32, cache_dtype=tdt)
    assert tpos == int(jpos) == 16
    np.testing.assert_allclose(_np(tl)[:, :VOCAB], _np(jl)[:, :VOCAB],
                               atol=FP32_TOL, rtol=0)
    jleaves, tleaves = _paths(jc), _paths(tc)
    assert sorted(tleaves) == sorted(jleaves)
    for path, t in tleaves.items():
        assert str(t.dtype).split(".")[-1] == str(jleaves[path].dtype), path
        np.testing.assert_allclose(_np(t), _np(jleaves[path]), atol=tol,
                                   rtol=2 ** -8, err_msg=str(path))
    decode = jax.jit(lambda p, t, c, pos: jm.decode(p, t, c, pos,
                                                    compute_dtype=F32))
    for step in range(3):
        tok = toks[:, S + step:S + step + 1]
        jl, jc = decode(jp, jnp.asarray(tok), jc, jpos + step)
        tl, tc = tm.decode(tp, torch.from_numpy(tok), tc, tpos + step,
                           compute_dtype=torch.float32)
        np.testing.assert_allclose(_np(tl)[..., :VOCAB],
                                   _np(jl)[..., :VOCAB], atol=tol, rtol=0,
                                   err_msg=f"decode step {step}")


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------
def _jax_steps(jm, cap):
    """The JAX reference's serving steps at fp32 compute, compiled once:
    prefill, decode, and the pool's cast of every cache leaf to bf16."""
    return (jax.jit(lambda p, t: jm.prefill(p, t, cap, compute_dtype=F32)),
            jax.jit(lambda p, t, c, pos: jm.decode(p, t, c, pos,
                                                   compute_dtype=F32)),
            jax.jit(lambda c: jax.tree.map(
                lambda a: a.astype(jnp.bfloat16), c)))


def _jax_greedy_check(steps, jp, prompt, tokens):
    """Drive the JAX model at fp32 compute through `tokens`, the port's
    transcript of `prompt` (teacher forcing), its cache stored in bf16
    after prefill and after every decode step as the JAX serving pool
    stores it (every leaf cast on write, the Mamba state included).
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
    """The port's ServeLoop (fp32 compute, bf16 pool) against the JAX
    greedy reference. "contiguous": equal prompts share slots 0-1 and
    decode on a view of the pool; "scattered": slots 0 and 2 share a
    position while slot 1 does not, so the loop gathers and writes back.
    Every request decodes past the window, so the ring wraps.

    The reference is driven through the port's own transcript, so every
    step is compared: where the reference's top-1 leads its top-2 by more
    than 2 LOGIT_TOL (each of the two logits may move by LOGIT_TOL) the
    port's token must be the reference's argmax, and at a nearer tie it
    must lie within 2 LOGIT_TOL of the top. At this width random weights
    put some top-2 gaps below 1e-2 (the smallest seen 4.1e-3), and the
    global layer's decode differs by up to about 2e-3 (BF16_CACHE_TOL)."""
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
    steps = _jax_steps(jm, capacity + tm.cfg.meta_tokens)
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


def test_pool_capacity_includes_meta_and_refuses_oversized(models):
    _, _, tm, tp = models
    mgr = CacheManager(tm, num_slots=2, capacity=16, device="cpu")
    assert (mgr.user_capacity, mgr.capacity) == (16, 20)
    glob, ring = mgr.cache["segments"]
    assert glob["k"].shape == (1, 2, 20, 2, 16)           # global: cap+meta
    assert ring["k"].shape == (1, 2, 16, 2, 16)           # ring: the window
    assert ring["mk"].shape == (1, 2, 4, 2, 16)
    assert ring["mamba"]["state"].shape == (1, 2, 2, 64, 8)
    assert all(t.dtype == torch.bfloat16
               for t in _paths(mgr.cache).values())
    mgr.check_fit(12, 5)                                  # 12 + 5 - 1 = 16
    with pytest.raises(ValueError, match="does not fit"):
        mgr.check_fit(13, 5)
    loop = ServeLoop(tm, tp, num_slots=1, capacity=16, max_new=5,
                     compute_dtype=torch.float32)
    with pytest.raises(ValueError, match="largest admissible prompt is 12"):
        loop.submit("big", _tokens(13))
    assert loop.mgr.free_slots() == [0]
