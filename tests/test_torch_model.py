"""The port's dense model held to the JAX package at olmo smoke width.

2 layers, d_model 64, vocabulary 64 (padded to 128, so the padded-
vocabulary mask is exercised), as tests/conftest.py `tiny_config`. The
JAX `Model.init` weights are bridged into the port
(`repro_torch.models.convert`), so both packages run the same weights.
"""
import dataclasses

import numpy as np
import pytest
from config_parity import reference_fields

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import smoke_config as jax_smoke_config  # noqa: E402
from repro.models import layers as jL  # noqa: E402
from repro.models.model import build_model as jax_build_model  # noqa: E402
from repro_torch.configs import get_config, smoke_config  # noqa: E402
from repro_torch.models import layers as tL  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.models.param import tree_leaves  # noqa: E402

VOCAB = 64
# fp32 compute: the tolerance of tests/test_kernels.py
FP32_TOL = 2e-4
# bf16 compute: the two packages round to bf16 at different places (the
# JAX attention rounds its scores and probabilities to bf16, the port's
# attention keeps them in fp32). Observed error is about one bf16 ulp of
# the largest logits (|logit| < 1, ulp 2^-8); 2e-2 allows five ulps.
BF16_TOL = 2e-2
# fp32 compute over a bf16 cache: JAX decode rounds its softmax
# probabilities to the cache dtype before the PV product, the port keeps
# them in fp32. Observed about 1.4e-3; with an fp32 cache the two agree
# to FP32_TOL (test_decode_fp32_cache_matches_jax).
BF16_CACHE_TOL = 5e-3


@pytest.fixture(scope="module")
def models():
    jcfg = dataclasses.replace(jax_smoke_config("olmo-1b"), vocab_size=VOCAB)
    tcfg = dataclasses.replace(smoke_config("olmo-1b"), vocab_size=VOCAB)
    jm = jax_build_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = build_model(tcfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return jm, jp, tm, tp


def _tokens(shape, seed=0):
    return np.random.default_rng(seed).integers(0, VOCAB, size=shape)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def test_configs_match_jax_package():
    from repro.configs import get_config as jax_get_config
    asdict = dataclasses.asdict
    for get, jget in ((get_config, jax_get_config),
                      (smoke_config, jax_smoke_config)):
        assert reference_fields(get("olmo-1b"), jget("olmo-1b")) == \
            asdict(jget("olmo-1b"))
    full = get_config("olmo-1b")
    assert (full.num_layers, full.d_model, full.num_heads,
            full.num_kv_heads, full.resolved_head_dim, full.d_ff,
            full.vocab_size) == (16, 2048, 16, 16, 128, 8192, 50304)


def test_spec_tree_matches_jax(models):
    jm, _, tm, tp = models
    from repro.models.param import is_spec
    jleaves = jax.tree.leaves(jm.spec, is_leaf=is_spec)
    jshapes = sorted((s.shape, s.init, s.scale) for s in jleaves)
    tshapes = sorted((s.shape, s.init, s.scale)
                     for s in tree_leaves(tm.spec))
    assert jshapes == tshapes
    assert tm.num_params() == jm.num_params()
    # the bridged tree carries every leaf of the spec at its shape
    assert sorted(tuple(t.shape) for t in tree_leaves(tp)) == \
        sorted(s.shape for s in jleaves)


def test_init_params_is_seeded_and_fan_in_scaled(models):
    _, _, tm, _ = models
    a = tm.init(seed=3, device="cpu")
    b = tm.init(seed=3, device="cpu")
    c = tm.init(seed=4, device="cpu")
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        assert torch.equal(x, y)
    assert not torch.equal(tree_leaves(a)[0], tree_leaves(c)[0])
    wq = a["segments"][0]["attn"]["wq"]           # (L, d, H, hd)
    std = 1.0 / np.sqrt(np.prod(wq.shape[:-1]))   # JAX fan-in rule
    assert float(wq.abs().max()) <= 3.0 * std
    assert 0.8 * std < float(wq.std()) < std
    table = a["embed"]["table"]
    assert 0.015 < float(table.std()) < 0.02      # truncated at 3 sigma


def test_norm_and_rope_match_jax():
    cfg, jcfg = smoke_config("olmo-1b"), jax_smoke_config("olmo-1b")
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5, 64), np.float32) * 3 + 1
    want = jL.apply_norm(jcfg, {}, jnp.asarray(x))
    got = tL.apply_norm(cfg, {}, torch.from_numpy(x))
    np.testing.assert_allclose(_np(got), _np(want), atol=FP32_TOL,
                               rtol=FP32_TOL)
    q = rng.standard_normal((2, 5, 4, 16), np.float32)
    pos = np.broadcast_to(np.arange(5) + 7, (2, 5))
    want = jL.apply_rope(jnp.asarray(q), jnp.asarray(pos), 10000.0)
    got = tL.apply_rope(torch.from_numpy(q), torch.from_numpy(pos.copy()),
                        10000.0)
    np.testing.assert_allclose(_np(got), _np(want), atol=FP32_TOL,
                               rtol=FP32_TOL)


@pytest.mark.parametrize("dtype,tol", [("float32", FP32_TOL),
                                       ("bfloat16", BF16_TOL)])
def test_apply_logits_match_jax(models, dtype, tol):
    jm, jp, tm, tp = models
    toks = _tokens((2, 12))
    want, _ = jm.apply(jp, jnp.asarray(toks),
                       compute_dtype=getattr(jnp, dtype))
    got, aux = tm.apply(tp, torch.from_numpy(toks),
                        compute_dtype=getattr(torch, dtype))
    assert got.dtype == getattr(torch, dtype)
    assert got.shape == (2, 12, 128) and float(aux) == 0.0
    # padded vocabulary entries are masked to NEG_INF in both
    assert bool((got[..., VOCAB:].float() < -1e29).all())
    np.testing.assert_allclose(_np(got)[..., :VOCAB],
                               _np(want)[..., :VOCAB], atol=tol, rtol=0)


@pytest.mark.parametrize("dtype,tol", [("float32", BF16_CACHE_TOL),
                                       ("bfloat16", BF16_TOL)])
def test_prefill_then_decode_match_jax(models, dtype, tol):
    """prefill, then 4 decode steps, both with a bf16 cache."""
    jm, jp, tm, tp = models
    toks = _tokens((2, 9), seed=1)
    cap = 16
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jl, jc, jpos = jm.prefill(jp, jnp.asarray(toks), cap, compute_dtype=jdt)
    tl, tc, tpos = tm.prefill(tp, torch.from_numpy(toks), cap,
                              compute_dtype=tdt)
    assert tpos == jpos == 9
    assert tc["segments"][0]["k"].dtype == torch.bfloat16
    assert tc["segments"][0]["k"].shape == (2, 2, cap, 4, 16)
    np.testing.assert_allclose(_np(tl), _np(jl), atol=tol, rtol=0)
    # the cache rows are the same values rounded to bf16: an input that
    # differs by an fp32 rounding may land one bf16 ulp (2^-8 relative)
    # away
    for name in ("k", "v"):
        np.testing.assert_allclose(_np(tc["segments"][0][name]),
                                   _np(jc["segments"][0][name]),
                                   atol=tol, rtol=2 ** -8)
    tok = _tokens((2, 1), seed=2)
    for step in range(4):
        jl, jc = jm.decode(jp, jnp.asarray(tok), jc, jpos + step,
                           compute_dtype=jdt)
        tl, tc = tm.decode(tp, torch.from_numpy(tok), tc, tpos + step,
                           compute_dtype=tdt)
        np.testing.assert_allclose(_np(tl), _np(jl), atol=tol, rtol=0)
        tok = np.array(jnp.argmax(jl[:, -1].astype(jnp.float32), -1))
        tok = tok[:, None]


def test_decode_fp32_cache_matches_jax(models):
    """With an fp32 cache neither package rounds the softmax: prefill and
    decode agree to the fp32 tolerance."""
    jm, jp, tm, tp = models
    toks = _tokens((2, 9), seed=3)
    jl, jc, jpos = jm.prefill(jp, jnp.asarray(toks), 16,
                              compute_dtype=jnp.float32,
                              cache_dtype=jnp.float32)
    tl, tc, tpos = tm.prefill(tp, torch.from_numpy(toks), 16,
                              compute_dtype=torch.float32,
                              cache_dtype=torch.float32)
    tok = _tokens((2, 1), seed=4)
    for step in range(3):
        jl, jc = jm.decode(jp, jnp.asarray(tok), jc, jpos + step,
                           compute_dtype=jnp.float32)
        tl, tc = tm.decode(tp, torch.from_numpy(tok), tc, tpos + step,
                           compute_dtype=torch.float32)
        np.testing.assert_allclose(_np(tl), _np(jl), atol=FP32_TOL,
                                   rtol=0)


def test_init_cache_defaults_to_bf16(models):
    _, _, tm, _ = models
    cache = tm.init_cache(3, 10, device="cpu")
    leaves = tree_leaves(cache)
    assert [t.dtype for t in leaves] == [torch.bfloat16] * 2
    assert leaves[0].shape == (2, 3, 10, 4, 16)
    assert not any(bool(t.any()) for t in leaves)


@pytest.mark.parametrize("change", [
    dict(family="moe"), dict(act="gelu"), dict(qk_norm=True)],
    ids=["family", "act", "qk_norm"])
def test_unported_configs_raise(change):
    """olmo smoke with one feature the port once refused, now ported: the
    MoE family (with a MoE config, d_ff 0), the GELU MLP, qk-norm. The
    forward logits and the MoE load-balance loss equal the JAX package's
    on the same weights (fp32). What the port once refused (expert
    parallelism, tensor / head padding, ROADMAP item 9b) is taken now:
    the model built at tp = 2 (4 heads divide it: nothing to pad) has the
    same spec and logits, and with moe_impl="ep" on a (1, 2) CPU mesh at
    a cf that drops nothing the logits equal the dense dispatch's (the
    dense families run their MLP either way). Padded heads are held in
    tests/test_torch_mesh_rules.py."""
    from repro.configs.base import MoEConfig as JMoEConfig
    from repro_torch.configs.base import MoEConfig
    jchange = dict(change)
    if change.get("family") == "moe":
        moe = dict(num_experts=4, top_k=2, d_ff_expert=32,
                   num_shared_experts=1, d_ff_shared=48)
        change = dict(change, d_ff=0, moe=MoEConfig(**moe))
        jchange = dict(jchange, d_ff=0, moe=JMoEConfig(**moe))
    jcfg = dataclasses.replace(jax_smoke_config("olmo-1b"),
                               vocab_size=VOCAB, **jchange)
    cfg = dataclasses.replace(smoke_config("olmo-1b"), vocab_size=VOCAB,
                              **change)
    jm, tm = jax_build_model(jcfg), build_model(cfg)
    jp = jax.jit(jm.init)(jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    toks = _tokens((2, 12), seed=6)
    (want, jaux) = jax.jit(lambda p, t: jm.apply(
        p, t, compute_dtype=jnp.float32))(jp, jnp.asarray(toks))
    got, aux = tm.apply(tp, torch.from_numpy(toks),
                        compute_dtype=torch.float32)
    np.testing.assert_allclose(_np(got)[..., :VOCAB], _np(want)[..., :VOCAB],
                               atol=FP32_TOL, rtol=0)
    assert float(aux) == pytest.approx(float(jaux), abs=FP32_TOL)
    from repro_torch.launch.mesh import make_mesh
    tp2 = build_model(cfg, tp=2)
    assert tp2.tp == 2 and tp2.num_params() == tm.num_params()
    again, _ = tp2.apply(tp, torch.from_numpy(toks),
                         compute_dtype=torch.float32)
    torch.testing.assert_close(again, got, rtol=0, atol=0)
    mesh = make_mesh((1, 2), ("data", "model"), devices=["cpu"] * 2)
    ep, ep_aux = tm.apply(tp, torch.from_numpy(toks), moe_impl="ep",
                          mesh=mesh, compute_dtype=torch.float32,
                          capacity_factor=64.0)
    dense, _ = tm.apply(tp, torch.from_numpy(toks),
                        compute_dtype=torch.float32, capacity_factor=64.0)
    np.testing.assert_allclose(_np(ep), _np(dense), atol=FP32_TOL, rtol=0)
    assert bool(torch.isfinite(ep_aux))


@pytest.mark.parametrize("change", [
    dict(sliding_window=8, global_attn_layers=(0,)), dict(meta_tokens=2),
    dict(norm="rmsnorm"), dict(tie_embeddings=False),
    pytest.param(dict(norm="layernorm"), id="layernorm")],
    ids=lambda c: next(iter(c)))
def test_ported_config_changes_match_jax(change):
    """olmo smoke with one feature that hymba or xlstm brought to the
    port: the forward logits equal the JAX package's on the same weights
    (fp32). A window of 8 over 12 tokens pads and spans two blocks; meta
    tokens are prepended and stripped; LayerNorm carries an affine."""
    jcfg = dataclasses.replace(jax_smoke_config("olmo-1b"),
                               vocab_size=VOCAB, **change)
    tcfg = dataclasses.replace(smoke_config("olmo-1b"), vocab_size=VOCAB,
                               **change)
    jm = jax_build_model(jcfg)
    jp = jax.jit(jm.init)(jax.random.PRNGKey(0))
    tm = build_model(tcfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    toks = _tokens((2, 12), seed=5)
    want, _ = jax.jit(lambda p, t: jm.apply(p, t, compute_dtype=jnp.float32))(
        jp, jnp.asarray(toks))
    got, _ = tm.apply(tp, torch.from_numpy(toks), compute_dtype=torch.float32)
    np.testing.assert_allclose(_np(got)[..., :VOCAB], _np(want)[..., :VOCAB],
                               atol=FP32_TOL, rtol=0)


def test_cuda_entry_points_raise_without_cuda(monkeypatch):
    """Entry points run on CUDA unless the CPU is asked for; without CUDA
    they raise instead of falling back."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tm = build_model(smoke_config("olmo-1b"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tm.init(seed=0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tm.init_cache(1, 8)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        params_from_numpy({"w": np.zeros(3, np.float32)})


@pytest.mark.parametrize("arch", ["olmo-1b", "qwen2-moe-a2.7b"])
def test_init_scales_in_place_to_the_formulas_values(arch):
    """`init` scales each truncated-normal draw in place (the largest leaf
    is never held twice); a seed still gives, leaf for leaf and bit for
    bit, `(trunc_normal * std).to(dtype)` drawn in the spec's leaf order,
    a stacked leaf (leading "layers" axis) one layer at a time, and bf16
    parameters are the fp32 ones rounded."""
    import math
    from repro_torch.models import param as P
    tm = build_model(dataclasses.replace(smoke_config(arch),
                                         vocab_size=VOCAB))
    got = tree_leaves(tm.init(seed=3, device="cpu"))
    half = tree_leaves(tm.init(seed=3, dtype=torch.bfloat16, device="cpu"))
    gen = torch.Generator().manual_seed(3)
    for s, g, h in zip(tree_leaves(tm.spec), got, half, strict=True):
        if s.init in ("normal", "embed"):
            fan_in = (s.shape[0] if len(s.shape) == 1
                      else math.prod(s.shape[:-1]))
            std = (s.scale / max(1.0, math.sqrt(fan_in))
                   if s.init == "normal" else s.scale * 0.02)
            if s.axes[:1] == ("layers",):
                want = torch.stack([P._trunc_normal(s.shape[1:], gen) * std
                                    for _ in range(s.shape[0])])
            else:
                want = P._trunc_normal(s.shape, gen) * std
        else:
            want = P._init_leaf(s, gen, torch.float32)
        assert torch.equal(g, want), s
        assert torch.equal(h, want.to(torch.bfloat16)), s
