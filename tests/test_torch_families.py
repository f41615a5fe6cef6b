"""The rest of the model registry held to the JAX package at smoke width:
stablelm-3b (LayerNorm, hd 16), llama3-8b (GQA 2), starcoder2-3b (the
GELU MLP), qwen3-moe-30b-a3b (MoE, qk-norm, hd 16 over d_model 64),
qwen2-moe-a2.7b (MoE with shared experts), hubert-xlarge (encoder: frame
embeddings in, non-causal attention, no RoPE) and chameleon-34b (VLM,
qk-norm). Vocabulary capped at 64 (padded to 128), as tests/test_models.py
`_tiny` caps it; the JAX `Model.init` weights are bridged into the port.

fp32 compute: logits within 2e-4 (tests/test_kernels.py's tolerance).
bf16 compute: within the 2e-2 of tests/test_torch_model.py; for the MoE
families where both packages route every (token, k) pair alike. A bf16
route may flip between the packages where two experts' router
probabilities nearly tie (the hidden states differ by bf16 roundings);
routing ranks are token-major, so the logits are held at every token
before the first flipped pair, and the flips are counted.
"""
import dataclasses

import numpy as np
import pytest
from config_parity import reference_fields

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCH_IDS as JAX_ARCH_IDS  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import smoke_config as jax_smoke_config  # noqa: E402
from repro.configs.base import TrainConfig as JTrainConfig  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models.model import build_model as jax_build_model  # noqa: E402
from repro.models.param import is_spec  # noqa: E402
from repro.serve.serve_step import \
    make_encode_step as jax_encode_step  # noqa: E402
from repro.serve.serve_step import \
    make_fleet_decode_step as jax_fleet_step  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro.train import train_step as jts  # noqa: E402
from repro_torch.configs import (ARCH_IDS, get_config,  # noqa: E402
                                 smoke_config)
from repro_torch.configs.base import TrainConfig  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.models.param import (Spec, tree_leaves,  # noqa: E402
                                      tree_map)
from repro_torch.serve.serve_step import (make_encode_step,  # noqa: E402
                                          make_fleet_decode_step)
from repro_torch.train import optimizer as topt  # noqa: E402
from repro_torch.train import train_step as tts  # noqa: E402

VOCAB = 64
NEW = ["stablelm-3b", "llama3-8b", "starcoder2-3b", "qwen3-moe-30b-a3b",
       "qwen2-moe-a2.7b", "hubert-xlarge", "chameleon-34b"]
MOE = ["qwen3-moe-30b-a3b", "qwen2-moe-a2.7b"]
FP32_TOL = 2e-4
BF16_TOL = 2e-2
# one fp32 train step (tests/test_torch_train.py): loss 1e-4; a parameter
# element is far when it moves by more than 16 ulp of its value plus 1e-7
STEP_LOSS_TOL = 1e-4
ENGINE_TCFG = dict(learning_rate=1e-3, b2=0.999, weight_decay=0.0,
                   warmup_steps=5, total_steps=100000, remat="none",
                   compute_dtype="float32")


@pytest.fixture(scope="module", params=NEW)
def models(request):
    arch = request.param
    jcfg = dataclasses.replace(jax_smoke_config(arch), vocab_size=VOCAB)
    tcfg = dataclasses.replace(smoke_config(arch), vocab_size=VOCAB)
    jm = jax_build_model(jcfg)
    jp = jax.jit(jm.init)(jax.random.PRNGKey(0))
    npp = jax.tree.map(np.asarray, jp)
    return jm, jp, npp, build_model(tcfg)


def _inputs(cfg, shape, seed=0):
    """Token ids, or frame embeddings for an embedding frontend."""
    rng = np.random.default_rng(seed)
    if cfg.embedding_frontend:
        return rng.standard_normal(shape + (cfg.d_model,)).astype(np.float32)
    return rng.integers(0, VOCAB, size=shape)


def _np(x):
    return x.detach().float().numpy() if torch.is_tensor(x) \
        else np.asarray(x, np.float32)


def _paths(tree, prefix=()):
    if isinstance(tree, dict):
        return {p: v for k in tree
                for p, v in _paths(tree[k], prefix + (k,)).items()}
    if isinstance(tree, (list, tuple)):
        return {p: v for i, t in enumerate(tree)
                for p, v in _paths(t, prefix + (i,)).items()}
    return {prefix: tree}


def test_registry_equals_the_reference():
    """ARCH_IDS in the reference's order; every published and smoke config
    field for field; `build_model` builds every arch's spec."""
    assert ARCH_IDS == JAX_ARCH_IDS
    for arch in ARCH_IDS:
        for get, jget in ((get_config, jax_get_config),
                          (smoke_config, jax_smoke_config)):
            assert reference_fields(get(arch), jget(arch)) == \
                dataclasses.asdict(jget(arch)), arch
        full = build_model(get_config(arch))
        assert full.num_params() == \
            jax_build_model(jax_get_config(arch)).num_params(), arch


def test_spec_trees_equal_the_reference(models):
    jm, _, npp, tm = models
    jspec, tspec = _paths(jm.spec), _paths(tm.spec)
    assert sorted(map(str, tspec)) == sorted(map(str, jspec))
    for path, s in tspec.items():
        assert isinstance(s, Spec) and is_spec(jspec[path])
        assert (s.shape, s.init, s.scale) == \
            (jspec[path].shape, jspec[path].init, jspec[path].scale), path
    bridged = _paths(params_from_numpy(npp, device="cpu"))
    assert sorted(map(str, bridged)) == sorted(map(str, tspec))
    for path, t in bridged.items():
        assert tuple(t.shape) == tspec[path].shape, path
    if tm.cfg.has_decode:
        jc, tc = _paths(jm.cache_spec(3, 20)), _paths(tm.cache_spec(3, 20))
        assert {p: s.shape for p, s in tc.items()} == \
            {p: s.shape for p, s in jc.items()}


def test_forward_fp32_matches_jax(models):
    jm, jp, npp, tm = models
    x = _inputs(tm.cfg, (2, 12), seed=1)
    want, jaux = jax.jit(lambda p, t: jm.apply(
        p, t, compute_dtype=jnp.float32))(jp, jnp.asarray(x))
    got, taux = tm.apply(params_from_numpy(npp, device="cpu"),
                         torch.from_numpy(x), compute_dtype=torch.float32)
    np.testing.assert_allclose(_np(got)[..., :VOCAB],
                               _np(want)[..., :VOCAB], atol=FP32_TOL, rtol=0)
    assert float(taux) == pytest.approx(float(jaux), abs=FP32_TOL)
    if tm.cfg.moe is not None:
        assert float(taux) > 0


class _Routes:
    """Records each MoE layer's top-k ids in both packages (the JAX
    reference runs eagerly under jax.disable_jit, so its layer scan is a
    Python loop with concrete values)."""

    def __init__(self, monkeypatch):
        self.jax, self.torch = [], []
        jroute, troute = jmoe._route, tmoe._route

        def jr(*a, **k):
            out = jroute(*a, **k)
            self.jax.append(np.asarray(out[1]))
            return out

        def tr(*a, **k):
            out = troute(*a, **k)
            self.torch.append(out[1].numpy())
            return out
        monkeypatch.setattr(jmoe, "_route", jr)
        monkeypatch.setattr(tmoe, "_route", tr)

    def first_flip(self):
        """Flattened index of the first token whose route differs in any
        layer (the token count when none does), and the flipped pairs."""
        t = self.jax[0].shape[0]
        first, pairs = t, 0
        for j, g in zip(self.jax, self.torch, strict=True):
            bad = (j != g).any(axis=1)
            pairs += int((j != g).sum())
            if bad.any():
                first = min(first, int(np.flatnonzero(bad)[0]))
        return first, pairs


def test_forward_bf16_matches_jax(models, monkeypatch):
    """bf16 compute: logits within 2e-2. MoE: routes recorded in both
    packages; every token before the first flipped (token, k) pair (in
    the token-major order of the dispatch ranks, so its routing, keep
    mask and attention prefix are equal) is held, and flips are at most
    a few pairs where the experts nearly tie."""
    jm, jp, npp, tm = models
    x = _inputs(tm.cfg, (2, 12), seed=1)
    tp = params_from_numpy(npp, device="cpu")
    if tm.cfg.moe is None:
        want, _ = jax.jit(lambda p, t: jm.apply(
            p, t, compute_dtype=jnp.bfloat16))(jp, jnp.asarray(x))
        got, _ = tm.apply(tp, torch.from_numpy(x),
                          compute_dtype=torch.bfloat16)
        np.testing.assert_allclose(_np(got)[..., :VOCAB],
                                   _np(want)[..., :VOCAB], atol=BF16_TOL,
                                   rtol=0)
        return
    routes = _Routes(monkeypatch)
    with jax.disable_jit():
        want, _ = jm.apply(jp, jnp.asarray(x), compute_dtype=jnp.bfloat16)
    got, _ = tm.apply(tp, torch.from_numpy(x), compute_dtype=torch.bfloat16)
    first, pairs = routes.first_flip()
    t = x.shape[0] * x.shape[1]
    assert pairs <= 0.05 * t * tm.cfg.moe.top_k * tm.cfg.num_layers, pairs
    w = _np(want)[..., :VOCAB].reshape(t, -1)[:first]
    g = _np(got)[..., :VOCAB].reshape(t, -1)[:first]
    np.testing.assert_allclose(g, w, atol=BF16_TOL, rtol=0)


def test_prefill_then_decode_matches_jax(models):
    """fp32 compute over an fp32 cache: the prefill's last logits, then
    three decode steps teacher-forced on the reference's tokens, B = 2 (a
    MoE decode's capacity is then 1 per expert, and pairs drop alike).
    The encoder has no decode step in either package."""
    jm, jp, npp, tm = models
    tp = params_from_numpy(npp, device="cpu")
    if not tm.cfg.has_decode:
        frames = _inputs(tm.cfg, (1, 4))
        cache = tm.init_cache(1, 8, torch.float32, "cpu")
        with pytest.raises(ValueError, match="encoder-only"):
            tm.decode(tp, torch.from_numpy(frames[:, :1]), cache, 4)
        with pytest.raises(ValueError, match="encoder-only"):
            jm.decode(jp, jnp.asarray(frames[:, :1]), None, 4)
        return
    toks = _inputs(tm.cfg, (2, 10), seed=2)
    cap = 16
    f32 = dict(compute_dtype=jnp.float32, cache_dtype=jnp.float32)
    jlast, jcache, jpos = jax.jit(
        lambda p, t: jm.prefill(p, t, cap, **f32))(jp, jnp.asarray(toks))
    tlast, tcache, tpos = tm.prefill(tp, torch.from_numpy(toks), cap,
                                     compute_dtype=torch.float32,
                                     cache_dtype=torch.float32)
    assert int(jpos) == tpos
    np.testing.assert_allclose(_np(tlast)[:, :VOCAB],
                               _np(jlast)[:, :VOCAB], atol=FP32_TOL, rtol=0)
    jdec = jax.jit(lambda p, t, c, q: jm.decode(p, t, c, q,
                                                compute_dtype=jnp.float32))
    tok = np.argmax(_np(jlast)[:, :VOCAB], -1)[:, None]
    for i in range(3):
        jl, jcache = jdec(jp, jnp.asarray(tok), jcache, tpos + i)
        tl, tcache = tm.decode(tp, torch.from_numpy(tok), tcache, tpos + i,
                               compute_dtype=torch.float32)
        np.testing.assert_allclose(_np(tl)[..., :VOCAB],
                                   _np(jl)[..., :VOCAB], atol=FP32_TOL,
                                   rtol=0, err_msg=f"step {i}")
        tok = np.argmax(_np(jl)[:, -1, :VOCAB], -1)[:, None]


def test_train_step_matches_jax(models):
    """One fp32 train step against the reference's `make_train_step` on
    the same weights and batch: loss, aux and grad norm, and the
    parameters after the step (under 1 % of elements farther than 16 ulp
    + 1e-7, the rule of tests/test_torch_train.py)."""
    jm, jp, npp, tm = models
    inputs = _inputs(tm.cfg, (4, 16), seed=3)
    labels = np.random.default_rng(4).integers(0, VOCAB, size=(4, 16))
    jstep = jax.jit(jts.make_train_step(jm, JTrainConfig(**ENGINE_TCFG)))
    tstep = tts.make_train_step(tm, TrainConfig(**ENGINE_TCFG))
    jstate, jmet = jstep({"params": jp, "opt": jopt.init_opt_state(jp)},
                         {"inputs": jnp.asarray(inputs),
                          "labels": jnp.asarray(labels)})
    tp = params_from_numpy(npp, device="cpu")
    tstate, tmet = tstep({"params": tp, "opt": topt.init_opt_state(tp)},
                         {"inputs": torch.from_numpy(inputs),
                          "labels": torch.from_numpy(labels)})
    assert float(tmet["loss"]) == pytest.approx(float(jmet["loss"]),
                                                abs=STEP_LOSS_TOL)
    assert float(tmet["aux"]) == pytest.approx(float(jmet["aux"]),
                                               abs=FP32_TOL)
    assert float(tmet["grad_norm"]) == pytest.approx(
        float(jmet["grad_norm"]), rel=1e-4)
    far = total = 0
    got = _paths(tstate["params"])
    for path, want in _paths(jstate["params"]).items():
        want = np.asarray(want)
        ulp = np.spacing(np.abs(want).astype(np.float32))
        far += int((np.abs(_np(got[path]) - want) > 16 * ulp + 1e-7).sum())
        total += want.size
    assert far <= 0.01 * total, (far, total)


def test_encode_step_matches_jax():
    """hubert-xlarge's encode step: frame embeddings in, logits out, at
    fp32 and bf16 compute."""
    arch = "hubert-xlarge"
    jcfg = dataclasses.replace(jax_smoke_config(arch), vocab_size=VOCAB)
    jm = jax_build_model(jcfg)
    jp = jax.jit(jm.init)(jax.random.PRNGKey(1))
    tm = build_model(dataclasses.replace(smoke_config(arch),
                                         vocab_size=VOCAB))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    frames = _inputs(tm.cfg, (3, 20), seed=5)
    for jdt, tdt, tol in ((jnp.float32, torch.float32, FP32_TOL),
                          (jnp.bfloat16, torch.bfloat16, BF16_TOL)):
        want = jax.jit(jax_encode_step(jm, compute_dtype=jdt))(
            jp, jnp.asarray(frames))
        got = make_encode_step(tm, compute_dtype=tdt)(
            tp, torch.from_numpy(frames))
        assert got.shape == (3, 20, 128)
        np.testing.assert_allclose(_np(got)[..., :VOCAB],
                                   _np(want)[..., :VOCAB], atol=tol, rtol=0)


ROWS = [0, 1, 2, 1, 0, 2, 1]
PROMPTS = [5, 9, 20, 14, 3, 30, 11]


@pytest.mark.parametrize("arch", MOE)
def test_fleet_step_matches_jax(arch):
    """The fleet decode step for MoE smoke students: three group models,
    seven lanes at staggered positions, fp32 over an fp32 pool, three
    ticks teacher-forced on the reference's tokens. The reference vmaps a
    B = 1 decode per lane (capacity 1, nothing drops); the port routes
    each group's lanes in one dispatch without drops: tokens equal, the
    cache rows the step wrote within 1e-5."""
    jcfg = dataclasses.replace(jax_smoke_config(arch), vocab_size=VOCAB)
    jm = jax_build_model(jcfg)
    tm = build_model(dataclasses.replace(smoke_config(arch),
                                         vocab_size=VOCAB))
    init = jax.jit(jm.init)
    jstack = jax.tree.map(lambda *x: jnp.stack(x),
                          *[init(jax.random.PRNGKey(s)) for s in range(3)])
    tstack = params_from_numpy(jax.tree.map(np.asarray, jstack),
                               device="cpu")
    cap = 48
    rng = np.random.default_rng(0)
    pool = tm.init_cache(len(ROWS), cap, torch.float32, "cpu")
    toks, poss = [], []
    for a, (r, n) in enumerate(zip(ROWS, PROMPTS)):
        params = tree_map(lambda t, r=r: t[r], tstack)
        prompt = torch.as_tensor(rng.integers(0, VOCAB, size=n))[None]
        last, c, pos = tm.prefill(params, prompt, cap,
                                  compute_dtype=torch.float32)
        for dst, src in zip(tree_leaves(pool), tree_leaves(c)):
            dst[:, a] = src[:, 0]
        toks.append(int(last[0].argmax()))
        poss.append(int(pos))
    jstep = jax.jit(jax_fleet_step(jm, compute_dtype=jnp.float32))
    tstep = make_fleet_decode_step(tm, compute_dtype=torch.float32)
    rows = jnp.asarray(ROWS, jnp.int32)
    jpool = jax.tree.map(lambda t: jnp.asarray(t.numpy()), pool)
    for tick in range(3):
        want, jpool = jstep(jstack, rows, jnp.asarray(toks, jnp.int32),
                            jpool, jnp.asarray(poss, jnp.int32))
        got, pool = tstep(tstack, ROWS, toks, pool, poss)
        assert got.tolist() == np.asarray(want).tolist(), tick
        for path, leaf in _paths(pool).items():
            np.testing.assert_allclose(_np(leaf), _np(_paths(jpool)[path]),
                                       atol=1e-5, rtol=1e-5, err_msg=path)
        toks = np.asarray(want).tolist()
        poss = [p + 1 for p in poss]


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "starcoder2-3b",
                                  "hubert-xlarge"])
def test_launcher_serves_every_decoder_and_refuses_the_encoder(arch):
    """`launch/serve.py --arch` takes every decoder of the registry (smoke
    width on the CPU here: every request served to its length) and
    refuses an encoder-only arch with the reference's message."""
    from repro_torch.launch import serve
    argv = ["--arch", arch, "--device", "cpu", "--requests", "3",
            "--num-slots", "2", "--prompt-len", "6", "--max-new", "4",
            "--capacity", "16"]
    if arch == "hubert-xlarge":
        with pytest.raises(SystemExit, match="encoder-only: no decode step"):
            serve.main(argv)
        return
    report = serve.main(argv)
    assert sorted(report["outputs"]) == ["req0", "req1", "req2"]
    assert all(len(t) == 4 for t in report["outputs"].values())
