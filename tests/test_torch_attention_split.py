"""The split-KV decode's algorithm and the attention wrapper's `plan`.

`ref.split_attention_ref` (per-split partials, then the combine) is the
plain version of the CUDA split-KV decode and combine kernels; it is held
here to the JAX oracle `repro.kernels.ref.attention_ref` on numpy-seeded
inputs. `plan` decides in Python which kernel path a call takes and how
the decode cuts [0, T) into splits; these tests pin its decisions and
its grids at the serving shapes. The kernels themselves run only on the
card (`chip_smoke.py`, and the `gpu`-marked test in test_torch_attention.py).
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels.flash_attention import SMS, TILE, plan  # noqa: E402

TOL = {"float32": dict(atol=2e-4, rtol=2e-4),
       "bfloat16": dict(atol=2e-2, rtol=2e-2)}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
BF16 = torch.bfloat16

# (B, S, T, H, K, hd, causal, window, split)
SPLIT_CASES = {
    "one split, G1": (2, 1, 50, 4, 4, 32, True, 0, 64),
    "two splits, G2": (2, 1, 50, 4, 2, 32, True, 0, 25),
    "seven splits, G5, S3": (1, 3, 70, 10, 2, 16, True, 0, 10),
    "one key per split, MQA": (1, 2, 9, 4, 1, 16, True, 0, 1),
    "ragged last split, MQA G5": (2, 1, 100, 5, 1, 32, True, 0, 32),
    "window: splits before the first key": (1, 4, 120, 4, 2, 16, True, 20,
                                            16),
    "S > T: rows without keys": (1, 6, 3, 4, 2, 16, True, 0, 2),
    "non-causal, G2": (2, 5, 40, 10, 5, 8, False, 0, 7),
}


def _inputs(B, S, T, H, K, hd, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, S, H, hd), np.float32),
            rng.standard_normal((B, T, K, hd), np.float32),
            rng.standard_normal((B, T, K, hd), np.float32))


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _has_key(S, T, causal, window):
    """(S,) whether each query row sees at least one key."""
    i = np.arange(S)[:, None] + (T - S)
    j = np.arange(T)[None, :]
    vis = np.ones((S, T), bool)
    if causal:
        vis &= j <= i
        if window > 0:
            vis &= (i - j) < window
    return vis.any(axis=1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(SPLIT_CASES))
def test_split_attention_matches_jax_oracle(case, dtype):
    """Rows that see a key equal the oracle within the dtype's tolerance;
    rows that see none are 0 (the oracle's uniform average there is not
    the kernels' semantics)."""
    B, S, T, H, K, hd, causal, window, split = SPLIT_CASES[case]
    arrays = _inputs(B, S, T, H, K, hd, seed=len(case))
    jq, jk, jv = (jnp.asarray(a, JDT[dtype]) for a in arrays)
    tq, tk, tv = (torch.from_numpy(a).to(TDT[dtype]) for a in arrays)
    want = _f32(jref.attention_ref(jq, jk, jv, causal=causal, window=window))
    got = tref.split_attention_ref(tq, tk, tv, causal=causal, window=window,
                                   split=split)
    assert got.dtype == TDT[dtype] and got.shape == tq.shape
    seen = _has_key(S, T, causal, window)
    np.testing.assert_allclose(_f32(got)[:, seen], want[:, seen],
                               **TOL[dtype])
    assert not _f32(got)[:, ~seen].any()
    if case.startswith("window"):       # the case has empty splits
        _, ml = tref.split_attention_partials(tq, tk, tv, causal=causal,
                                              window=window, split=split)
        empty = torch.isinf(ml[..., 0]).all(dim=(1, 2, 3))
        assert bool(empty[0]) and not bool(empty[-1])
        assert bool((ml[empty][..., 1] == 0).all())


def test_split_partials_cover_every_key_once():
    """The partials of every split size recombine to the same output:
    the splits cover [0, T) without overlap."""
    arrays = _inputs(1, 2, 37, 4, 2, 16, seed=3)
    tq, tk, tv = (torch.from_numpy(a) for a in arrays)
    outs = [tref.split_attention_ref(tq, tk, tv, split=n)
            for n in (1, 5, 36, 37, 64)]
    for o in outs[1:]:
        np.testing.assert_allclose(o.numpy(), outs[0].numpy(), atol=1e-6,
                                   rtol=1e-6)
    part_o, part_ml = tref.split_attention_partials(tq, tk, tv, split=5)
    assert part_o.shape == (8, 1, 2, 4, 16) and part_ml.shape == (8, 1, 2,
                                                                  4, 2)


def test_combine_of_empty_splits_is_zero():
    """Splits that saw no key (m = -inf, l = 0) contribute nothing; a row
    whose every split is empty is 0, not NaN."""
    part_o = torch.zeros((3, 1, 1, 2, 4))
    part_ml = torch.zeros((3, 1, 1, 2, 2))
    part_ml[..., 0] = -math.inf
    part_o[1, ..., 1, :] = 6.0             # head 1: one split saw keys
    part_ml[1, ..., 1, 0] = 0.5
    part_ml[1, ..., 1, 1] = 2.0
    out = tref.combine_splits(part_o, part_ml, torch.float32)
    assert torch.equal(out[..., 0, :], torch.zeros_like(out[..., 0, :]))
    assert torch.equal(out[..., 1, :], torch.full_like(out[..., 1, :], 3.0))


def _tensors(B, S, H, K, hd, T, dtype=BF16, kv_dtype=None, cap=None):
    q = torch.empty((B, S, H, hd), dtype=dtype)
    cache = torch.empty((B, cap or T, K, hd), dtype=kv_dtype or dtype)
    return q, cache[:, :T], cache[:, :T]


@pytest.mark.parametrize("args,path", [
    ((4, 1, 16, 16, 128, 543), "split_decode"),       # olmo decode
    ((4, 1, 25, 5, 64, 1183), "split_decode"),        # hymba decode
    ((2, 4, 8, 2, 64, 600), "split_decode"),          # S x G = 16
    ((2, 4, 10, 2, 64, 600), "prefill"),              # S x G = 20
    ((1, 512, 16, 16, 128, 512), "prefill"),          # olmo prefill
    ((1, 200, 8, 2, 40, 200), "prefill"),             # hd 40: padded to 64
    ((1, 200, 8, 2, 32, 200), "prefill"),
])
def test_plan_path_bf16(args, path):
    assert plan(*_tensors(*args)).path == path


@pytest.mark.parametrize("q_dtype,kv_dtype,hd", [
    (torch.float32, torch.float32, 64),      # fp32: CUDA cores
    (torch.float32, BF16, 128),              # fp32 q over a bf16 cache
    (BF16, BF16, 18),                        # rows not 16-byte multiples
    (BF16, BF16, 36),
])
def test_plan_cuda_core_path(q_dtype, kv_dtype, hd):
    for S in (1, 100):
        got = plan(*_tensors(2, S, 4, 2, hd, 90, q_dtype, kv_dtype))
        assert got.path == "cuda_core" and got.splits == 0


def test_plan_unaligned_view_takes_cuda_core():
    """A bf16 view whose rows do not start on 16-byte boundaries cannot
    feed cp.async: the CUDA-core kernel (scalar loads) takes it."""
    q, k, v = _tensors(1, 1, 4, 4, 64, 100)
    flat = torch.empty(100 * 4 * 64 + 1, dtype=BF16)
    k_off = flat[1:].view(1, 100, 4, 64)
    assert plan(q, k_off, v).path == "cuda_core"
    assert plan(q, k, v).path == "split_decode"


@pytest.mark.parametrize("B,K,T", [(1, 1, 1), (1, 1, 63), (1, 1, 64),
                                   (1, 1, 65), (4, 16, 543), (4, 16, 1023),
                                   (4, 5, 1183), (1, 8, 5000),
                                   (8, 32, 4097), (2, 2, 130)])
def test_plan_splits_cover_keys_exactly(B, K, T):
    """Splits are whole tiles, non-empty, contiguous from 0 to T without
    overlap, and the grid has a block for every SM unless every split is
    already one tile."""
    p = plan(*_tensors(B, 1, K, K, 64, T))
    assert p.path == "split_decode"
    assert p.split % TILE == 0
    bounds = [(i * p.split, min(T, (i + 1) * p.split))   # the kernel's
              for i in range(p.splits)]
    assert bounds[0][0] == 0 and bounds[-1][1] == T
    assert all(a < b for a, b in bounds)
    assert all(b == a2 for (_, b), (a2, _) in zip(bounds, bounds[1:]))
    assert p.grid == p.splits * K * B
    tiles = math.ceil(T / TILE)
    assert p.grid >= min(SMS, tiles * K * B)


@pytest.mark.parametrize("args,grid,splits", [
    ((1, 512, 16, 16, 128, 512), 8 * 16, 0),           # olmo prefill
    ((1, 1152, 25, 5, 64, 1152), 18 * 25, 0),          # hymba prefill
    ((4, 1, 16, 16, 128, 543, BF16, None, 1024), 4 * 16 * 3, 3),
    ((4, 1, 25, 5, 64, 1183, BF16, None, 1312), 4 * 5 * 10, 10),
])
def test_plan_grid_at_serving_shapes(args, grid, splits):
    """olmo's prefill grid (128 blocks) gets two kv groups per block,
    hymba's (450) one; olmo's decode takes splits of 3 tiles, hymba's of
    2."""
    p = plan(*_tensors(*args))
    assert (p.grid, p.splits) == (grid, splits)
    assert p.groups == (2 if grid < 2 * SMS and p.path == "prefill" else 1)
