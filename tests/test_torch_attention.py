"""The port's attention op held to the JAX package.

Inputs come from numpy with a fixed seed and go through the JAX oracle
`repro.kernels.ref.attention_ref`, the JAX Pallas kernel in interpret mode,
and the port's `repro_torch.kernels.ops.attention` (on the CPU: the plain
version). The CUDA kernel itself runs only on the card: `chip_smoke.py`
holds it to the plain version there, and the `gpu`-marked test below
does the same when a card is present.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.flash_attention import flash_attention as jflash  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402

# the tolerances of tests/test_kernels.py
TOL = {"float32": dict(atol=2e-4, rtol=2e-4),
       "bfloat16": dict(atol=2e-2, rtol=2e-2)}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}

# the shapes of tests/test_kernels.py; the appended-query layout (S < T)
# is only defined for causal attention
SHAPES = [
    (1, 128, 128, 4, 4, 64),      # MHA square
    (2, 64, 64, 4, 2, 32),        # GQA
    (1, 96, 96, 8, 1, 64),        # MQA, ragged S
    (1, 32, 128, 4, 2, 64),       # queries appended at end (decode-ish)
]
CASES = [(shape, causal, window)
         for shape in SHAPES
         for causal, window in [(True, 0), (True, 32), (False, 0)]
         if causal or shape[1] == shape[2]]


def _inputs(B, S, T, H, K, hd, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, S, H, hd), np.float32),
            rng.standard_normal((B, T, K, hd), np.float32),
            rng.standard_normal((B, T, K, hd), np.float32))


def _both(arrays, dtype):
    """The same numpy inputs as JAX arrays and torch tensors of `dtype`
    (both round fp32 -> bf16 to nearest even)."""
    js = [jnp.asarray(a, JDT[dtype]) for a in arrays]
    ts = [torch.from_numpy(a).to(TDT[dtype]) for a in arrays]
    return js, ts


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,causal,window", CASES,
                         ids=[f"{c[0]}-causal{c[1]}-w{c[2]}" for c in CASES])
def test_attention_matches_jax_oracle(shape, causal, window, dtype):
    (jq, jk, jv), (tq, tk, tv) = _both(_inputs(*shape), dtype)
    want = jref.attention_ref(jq, jk, jv, causal=causal, window=window)
    got = ops.attention(tq, tk, tv, causal=causal, window=window)
    assert got.dtype == TDT[dtype] and got.shape == tq.shape
    np.testing.assert_allclose(_np(got), _np(want), **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,causal,window", CASES,
                         ids=[f"{c[0]}-causal{c[1]}-w{c[2]}" for c in CASES])
def test_attention_matches_jax_pallas_interpret(shape, causal, window,
                                                dtype):
    (jq, jk, jv), (tq, tk, tv) = _both(_inputs(*shape, seed=1), dtype)
    want = jflash(jq, jk, jv, causal=causal, window=window, q_block=32,
                  kv_block=32, interpret=True)
    got = ops.attention(tq, tk, tv, causal=causal, window=window)
    np.testing.assert_allclose(_np(got), _np(want), **TOL[dtype])


def test_attention_impls_agree_on_cpu_and_count_no_launch():
    """On CPU tensors "auto" is the plain version: same bits, and the
    kernel's launch counter does not move."""
    _, (tq, tk, tv) = _both(_inputs(2, 64, 64, 4, 2, 32), "float32")
    before = flash_attention.launches
    auto = ops.attention(tq, tk, tv, causal=True)
    plain = ops.attention(tq, tk, tv, causal=True, impl="ref")
    assert torch.equal(auto, plain)
    assert flash_attention.launches == before
    with pytest.raises(ValueError, match="impl"):
        ops.attention(tq, tk, tv, impl="xla")


@pytest.mark.parametrize("pos", [0, 5, 23])
def test_decode_prefix_matches_masked_full_capacity(pos):
    """The port's decode attends over the cache prefix [:pos+1] with S=1;
    JAX `attention_decode` attends over the full capacity with keys t > pos
    masked. Same weights, input and fp32 cache: same output (tolerance of
    test_kernels.py) and the same new cache row."""
    import dataclasses

    from repro.configs import smoke_config
    from repro.models import layers as jL
    from config_parity import reference_fields
    from repro_torch.configs import smoke_config as torch_smoke_config
    from repro_torch.models import layers as tL

    cfg = dataclasses.replace(smoke_config("olmo-1b"), num_kv_heads=2)
    tcfg = dataclasses.replace(torch_smoke_config("olmo-1b"), num_kv_heads=2)
    assert reference_fields(tcfg, cfg) == dataclasses.asdict(cfg)
    B, cap, D = 3, 24, cfg.d_model
    H, K, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    rng = np.random.default_rng(pos)
    w = {"wq": (D, H, hd), "wk": (D, K, hd), "wv": (D, K, hd),
         "wo": (H, hd, D)}
    p = {k: rng.standard_normal(s, np.float32) / np.sqrt(D)
         for k, s in w.items()}
    x = rng.standard_normal((B, 1, D), np.float32)
    cache = {k: rng.standard_normal((B, cap, K, hd), np.float32)
             for k in ("k", "v")}
    jout, jcache = jL.attention_decode(
        cfg, {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
        {k: jnp.asarray(v) for k, v in cache.items()}, pos, window=0,
        meta=0)
    tcache = {k: torch.from_numpy(v.copy()) for k, v in cache.items()}
    tout, tcache = tL.attention_decode(
        tcfg, {k: torch.from_numpy(v) for k, v in p.items()},
        torch.from_numpy(x), tcache, pos, window=0, meta=0)
    np.testing.assert_allclose(tout.numpy(), _np(jout), **TOL["float32"])
    for k in ("k", "v"):
        np.testing.assert_allclose(tcache[k].numpy(), _np(jcache[k]),
                                   **TOL["float32"])


def test_plain_attention_rows_without_visible_keys():
    """S > T under causal masking: early queries see no key. The plain
    version follows the JAX oracle (uniform softmax over masked scores)."""
    (jq, jk, jv), (tq, tk, tv) = _both(_inputs(1, 8, 4, 2, 2, 16), "float32")
    want = jref.attention_ref(jq, jk, jv, causal=True)
    got = tref.attention_ref(tq, tk, tv, causal=True)
    np.testing.assert_allclose(_np(got), _np(want), **TOL["float32"])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_kernel_matches_plain_version(dtype):
    """The Hopper kernels against the plain version on the card (needs a
    CUDA device and nvcc; chip_smoke.py runs the full sweep): the sweep
    (fp32 on the CUDA-core kernel, bf16 on the tensor-core prefill) and
    decodes over strided cache prefixes (bf16 on the split-KV decode and
    its combine, fp32 q on the CUDA-core kernel). Every call counts one
    attention launch, and a split-KV call one combine launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.kernels.flash_attention import plan
    decodes = [((3, 1, 300, 8, 8, 128), 512),     # ragged last split
               ((2, 1, 777, 25, 5, 64), 1000),    # GQA 25/5
               ((2, 4, 600, 8, 2, 64), 800)]      # S 4 appended
    cases = [(_inputs(*shape), causal, window, None)
             for shape, causal, window in CASES]
    for (B, S, T, H, K, hd), cap in decodes:
        q, ck, cv = _inputs(B, S, cap, H, K, hd)
        cases.append(((q, ck, cv), True, 0, T))
    for arrays, causal, window, prefix in cases:
        tq, tk, tv = (torch.from_numpy(a).to(TDT[dtype]).cuda()
                      for a in arrays)
        if prefix is not None:
            tk, tv = tk[:, :prefix], tv[:, :prefix]     # strided views
        path = plan(tq, tk, tv).path
        assert path == ("cuda_core" if dtype == "float32" else
                        "prefill" if prefix is None else "split_decode")
        before = (flash_attention.launches, flash_attention.combine_launches)
        got = flash_attention(tq, tk, tv, causal=causal, window=window)
        assert (flash_attention.launches, flash_attention.combine_launches) \
            == (before[0] + 1, before[1] + (path == "split_decode"))
        want = tref.attention_ref(tq, tk, tv, causal=causal, window=window)
        np.testing.assert_allclose(_np(got.cpu()), _np(want.cpu()),
                                   **TOL[dtype])
