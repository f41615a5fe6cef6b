"""Distribution's model half on the port (`repro_torch.distributed.sharding.
mesh_rules`, `batch_pspec`, `models.param.logical_to_pspec` /
`abstract_params`, `models.transformer.build_spec(ep=, tp=)`,
`layers.padded_heads` / `head_mask`, `moe.padded_experts`) held to the JAX
package's.

The rules read only a mesh's shape, so both packages get shape-only
stand-ins (as tests/test_sharding.py does). A pspec is a plain tuple in
the port; the reference's `PartitionSpec` compares as `tuple(pspec)`.
Spec trees compare leaf by leaf on shape, logical axes, init and scale
for every arch of the registry at full width. The padded starcoder2
model runs on bridged weights in fp32 (2e-4, the tolerance of
tests/test_kernels.py).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
pytest.importorskip("hypothesis")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from repro.configs import ARCH_IDS  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import smoke_config as jax_smoke_config  # noqa: E402
from repro.distributed import sharding as jsh  # noqa: E402
from repro.models import layers as jL  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import param as jP  # noqa: E402
from repro.models import transformer as jT  # noqa: E402
from repro.models.model import build_model as jax_build_model  # noqa: E402
from repro_torch.configs import get_config, smoke_config  # noqa: E402
from repro_torch.configs.base import (DENSE, ModelConfig,  # noqa: E402
                                      MoEConfig)
from repro_torch.distributed import sharding as tsh  # noqa: E402
from repro_torch.launch.mesh import make_production_mesh  # noqa: E402
from repro_torch.models import layers as tL  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models import param as tP  # noqa: E402
from repro_torch.models import transformer as tT  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402

FP32_TOL = 2e-4
SHAPES = {
    "16x16": {"data": 16, "model": 16},
    "2x16x16": {"pod": 2, "data": 16, "model": 16},
    "2x4": {"data": 2, "model": 4},
    "1x8": {"data": 1, "model": 8},
    "8x1": {"data": 8, "model": 1},
}


class FakeMesh:
    """Just enough mesh for mesh_rules: its shape dict."""

    def __init__(self, shape):
        self.shape = shape


def _flat(tree, prefix=""):
    """{path: leaf} of a tree of dicts and lists (a tuple is a leaf: a
    pspec)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    if isinstance(tree, list):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{prefix}{i}/"))
        return out
    return {prefix[:-1]: tree}


def _jax_flat(tree):
    """The reference's spec tree (Specs are not pytree leaves of their own
    there: they are flattened through `is_spec`) as {path: Spec}."""
    if isinstance(tree, jP.Spec):
        return tree
    if isinstance(tree, dict):
        return {k: _jax_flat(v) for k, v in tree.items()}
    return [_jax_flat(v) for v in tree]


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_mesh_rules_equal_the_reference(arch, shape):
    mesh = FakeMesh(SHAPES[shape])
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    for policy in ("tp", "zero"):
        for fsdp in (True, False):
            want = jsh.mesh_rules(mesh, jcfg, fsdp=fsdp, policy=policy)
            got = tsh.mesh_rules(mesh, cfg, fsdp=fsdp, policy=policy)
            assert got == want, (policy, fsdp)
            assert tsh.mesh_rules(mesh, fsdp=fsdp, policy=policy) == \
                jsh.mesh_rules(mesh, fsdp=fsdp, policy=policy)
    with pytest.raises(ValueError, match="policy"):
        tsh.mesh_rules(mesh, cfg, policy="dp")


@pytest.mark.parametrize("shape", list(SHAPES))
def test_batch_and_logical_pspecs_equal_the_reference(shape):
    mesh = FakeMesh(SHAPES[shape])
    assert tsh.batch_pspec(mesh) == tuple(jsh.batch_pspec(mesh))
    names = ("batch", "vocab", "mlp", "experts", "heads", "kv_heads",
             "fsdp", "seq", "layers", None, "unknown")
    for arch in ("starcoder2-3b", "hymba-1.5b", "chameleon-34b"):
        for policy in ("tp", "zero"):
            rules = jsh.mesh_rules(mesh, jax_get_config(arch), policy=policy)
            for i in range(len(names)):
                axes = names[i:] + names[:i]
                assert tP.logical_to_pspec(axes, rules) == \
                    tuple(jP.logical_to_pspec(axes, rules))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_spec_tree_equals_the_reference_at_every_padding(arch):
    """Every leaf's shape, logical axes, init and scale, at ep in {1, 4, 8}
    and tp in {1, 2, 16}: the padded experts and heads included."""
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    for ep in (1, 4, 8):
        for tp in (1, 2, 16):
            want = _flat(_jax_flat(jT.build_spec(jcfg, ep=ep, tp=tp)))
            got = _flat(tT.build_spec(cfg, ep=ep, tp=tp))
            assert sorted(got) == sorted(want), (ep, tp)
            for path, s in got.items():
                w = want[path]
                assert (s.shape, s.axes, s.init, s.scale) == \
                    (w.shape, w.axes, w.init, w.scale), (ep, tp, path)
            model = build_model(cfg, ep=ep, tp=tp)
            jmodel = jax_build_model(jcfg, ep=ep, tp=tp)
            assert model.num_params() == jmodel.num_params()
    for batch, cap in ((2, 64), (3, 40)):
        want = _flat(_jax_flat(jT.cache_spec(jcfg, batch, cap)))
        got = _flat(tT.cache_spec(cfg, batch, cap))
        assert sorted(got) == sorted(want)
        for path, s in got.items():
            assert (s.shape, s.axes, s.init) == \
                (want[path].shape, want[path].axes, want[path].init), path


def _cfg(H, K):
    return ModelConfig(name="x", family=DENSE, num_layers=1, d_model=64,
                       num_heads=H, num_kv_heads=K, d_ff=64, vocab_size=64)


@given(H=st.integers(1, 128), K=st.integers(1, 32),
       tp=st.sampled_from([1, 2, 3, 4, 6, 8, 16]))
@settings(max_examples=150, deadline=None)
def test_padded_heads_and_mask_equal_the_reference(H, K, tp):
    if H % K:
        H = K * max(1, H // K)     # GQA requires K | H
    from repro.configs.base import DENSE as JDENSE
    from repro.configs.base import ModelConfig as JModelConfig
    jcfg = JModelConfig(name="x", family=JDENSE, num_layers=1, d_model=64,
                        num_heads=H, num_kv_heads=K, d_ff=64, vocab_size=64)
    cfg = _cfg(H, K)
    Hp = tL.padded_heads(cfg, tp)
    assert Hp == jL.padded_heads(jcfg, tp)
    assert H <= Hp <= 1.5 * H and Hp % K == 0
    m, jm = tL.head_mask(cfg, Hp, torch.float32), \
        jL.head_mask(jcfg, Hp, jnp.float32)
    if jm is None:
        assert m is None
    else:
        np.testing.assert_array_equal(m.numpy(), np.asarray(jm))
        assert int(m.sum()) == H


@given(E=st.integers(1, 160), ep=st.integers(1, 32))
@settings(max_examples=150, deadline=None)
def test_padded_experts_equal_the_reference(E, ep):
    from repro.configs.base import MoEConfig as JMoEConfig
    cfg = dataclasses.replace(_cfg(4, 4), moe=MoEConfig(
        num_experts=E, top_k=1, d_ff_expert=8))
    jcfg = dataclasses.replace(jax_smoke_config("qwen3-moe-30b-a3b"),
                               moe=JMoEConfig(num_experts=E, top_k=1,
                                              d_ff_expert=8))
    got = tmoe.padded_experts(cfg, ep)
    assert got == jmoe.padded_experts(jcfg, ep)
    assert got % ep == 0 and E <= got < E + ep


def test_starcoder2_heads_padded_and_hymba_replicated():
    mesh = FakeMesh(SHAPES["16x16"])
    sc, hy = get_config("starcoder2-3b"), get_config("hymba-1.5b")
    assert tL.padded_heads(sc, 16) == 32                # 24 -> 32
    assert tsh.mesh_rules(mesh, sc)["heads"] == "model"
    assert tsh.mesh_rules(mesh, sc)["kv_heads"] is None  # 2 kv heads
    wq = tT.build_spec(sc, tp=16)["segments"][0]["attn"]["wq"]
    assert wq.shape == (30, 3072, 32, 128)
    assert tL.padded_heads(hy, 16) == 25                # 25 -> 80: too much
    assert tsh.mesh_rules(mesh, hy)["heads"] is None


@pytest.mark.parametrize("arch,multi_pod", [
    ("olmo-1b", False), ("starcoder2-3b", False), ("qwen2-moe-a2.7b", True),
    ("xlstm-350m", True)])
def test_abstract_params_blocks_on_a_production_mesh(arch, multi_pod):
    """The per-entry block of every leaf on the production mesh made of
    one repeated device: each dim over the ways of the mesh axes of the
    reference's pspec (rounded up where GSPMD pads), as `meta` tensors."""
    n = 512 if multi_pod else 256
    mesh = make_production_mesh(multi_pod, devices=["cpu"] * n)
    assert mesh.dims == ((2, 16, 16) if multi_pod else (16, 16))
    jmesh = FakeMesh(mesh.shape)
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    rules = tsh.mesh_rules(mesh, cfg)
    assert rules == jsh.mesh_rules(jmesh, jcfg)
    tp = 16 if rules["heads"] else 1
    model = build_model(cfg, ep=16, tp=tp)
    blocks = _flat(model.abstract_params(mesh, rules))
    pspecs = _flat(model.param_shardings(mesh, rules))
    want = _flat(_jax_flat(jT.build_spec(jcfg, ep=16, tp=tp)))
    for path, blk in blocks.items():
        w = want[path]
        pspec = tuple(jP.logical_to_pspec(w.axes, rules))
        assert pspecs[path] == pspec, path
        ways = [1 if e is None else int(np.prod(
            [mesh.shape[a] for a in (e if isinstance(e, tuple) else (e,))]))
            for e in pspec]
        assert blk.device.type == "meta" and blk.dtype == torch.float32
        assert tuple(blk.shape) == tuple(-(-d // k) for d, k in
                                         zip(w.shape, ways)), path
    cache = _flat(model.abstract_cache(16, 64, mesh, rules))
    assert all(t.device.type == "meta" and t.dtype == torch.bfloat16
               for t in cache.values())
    assert tP.param_bytes(model.spec) == 4 * model.num_params()


def test_production_mesh_needs_the_cards():
    """No device list: CUDA devices only, and this machine has none (or
    fewer than 256); it never drops to the CPU."""
    with pytest.raises(RuntimeError, match="CUDA devices"):
        make_production_mesh()
    with pytest.raises(RuntimeError, match="CUDA devices"):
        make_production_mesh(multi_pod=True)
    with pytest.raises(RuntimeError, match="devices"):
        make_production_mesh(devices=["cpu"] * 255)


def _padded_models(tp=3):
    """starcoder2 smoke (4 heads over 2 kv heads) built at a tp that pads
    it to 6 heads, in both packages, on the reference's weights."""
    jcfg = dataclasses.replace(jax_smoke_config("starcoder2-3b"),
                               vocab_size=64)
    cfg = dataclasses.replace(smoke_config("starcoder2-3b"), vocab_size=64)
    jm, tm = jax_build_model(jcfg, tp=tp), build_model(cfg, tp=tp)
    jp = jax.jit(jm.init)(jax.random.PRNGKey(0))
    return jm, jp, tm, params_from_numpy(jax.tree.map(np.asarray, jp),
                                         device="cpu")


def test_padded_heads_model_equals_the_reference():
    """Logits, prefill and three decode steps of the padded model equal
    the reference's padded model in fp32; the padded heads add nothing:
    their query and output weights can be anything."""
    jm, jp, tm, tp = _padded_models()
    assert tp["segments"][0]["attn"]["wq"].shape[2] == 6
    toks = np.random.default_rng(3).integers(0, 64, size=(2, 10))
    want, _ = jm.apply(jp, jnp.asarray(toks), compute_dtype=jnp.float32)
    got, _ = tm.apply(tp, torch.from_numpy(toks), compute_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy()[..., :64],
                               np.asarray(want)[..., :64], atol=FP32_TOL,
                               rtol=0)
    # the padded heads (G_pad = 3 per kv head, the last of each group)
    pad = ~tL.head_mask(tm.cfg, 6, torch.float32).bool()
    assert pad.tolist() == [False, False, True, False, False, True]
    tampered = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    for seg in tampered["segments"]:
        seg["attn"]["wq"][:, :, pad] = 7.0
        seg["attn"]["wo"][:, pad] = -3.0
    again, _ = tm.apply(tampered, torch.from_numpy(toks),
                        compute_dtype=torch.float32)
    torch.testing.assert_close(again, got, rtol=0, atol=0)
    # prefill and decode
    cap = 16
    jl, jc, jpos = jm.prefill(jp, jnp.asarray(toks), cap,
                              compute_dtype=jnp.float32,
                              cache_dtype=jnp.float32)
    tl, tc, tpos = tm.prefill(tp, torch.from_numpy(toks), cap,
                              compute_dtype=torch.float32,
                              cache_dtype=torch.float32)
    assert tpos == int(jpos)
    np.testing.assert_allclose(tl.numpy()[:, :64], np.asarray(jl)[:, :64],
                               atol=FP32_TOL, rtol=0)
    tok = np.asarray(jnp.argmax(jl[:, :64], -1))[:, None]
    for step in range(3):
        jl2, jc = jm.decode(jp, jnp.asarray(tok), jc, jpos + step,
                            compute_dtype=jnp.float32)
        tl2, tc = tm.decode(tp, torch.from_numpy(tok), tc, tpos + step,
                            compute_dtype=torch.float32)
        np.testing.assert_allclose(tl2.numpy()[..., :64],
                                   np.asarray(jl2)[..., :64],
                                   atol=FP32_TOL, rtol=0)
        tok = np.asarray(jnp.argmax(jl2[:, -1, :64], -1))[:, None]


def test_padded_heads_outputs_are_zero():
    """The masked attention output of a padded model: the padded heads'
    columns are exactly zero before the output projection, in the full
    attention, the windowed one and the decode."""
    _, _, tm, tp = _padded_models()
    cfg = tm.cfg
    p = {k: v[0] for k, v in tp["segments"][0]["attn"].items()}
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (2, 8, cfg.d_model)).astype(np.float32))
    pos = torch.arange(8).expand(2, 8)
    q, k, v = tL._qkv(cfg, p, x, pos)
    from repro_torch.kernels import ops
    o = tL._mask_heads(cfg, ops.attention(q, k, v, causal=True))
    pad = ~tL.head_mask(cfg, 6, torch.float32).bool()
    assert o.shape[2] == 6 and bool((o[:, :, pad] == 0).all())
    assert bool((o[:, :, ~pad] != 0).any())
    wo = p["wo"].clone()
    wo[pad] = 1e3
    full, _ = tL.attention_full(cfg, p, x, pos, causal=True)
    full2, _ = tL.attention_full(cfg, dict(p, wo=wo), x, pos, causal=True)
    win, _ = tL.attention_windowed(cfg, p, x, pos, window=4, meta=0)
    win2, _ = tL.attention_windowed(cfg, dict(p, wo=wo), x, pos, window=4,
                                    meta=0)
    torch.testing.assert_close(full2, full, rtol=0, atol=0)
    torch.testing.assert_close(win2, win, rtol=0, atol=0)
