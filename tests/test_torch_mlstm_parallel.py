"""The chunkwise-parallel mLSTM of the `mlstm_scan` kernel's bf16 path,
held to the JAX package and to the port's plain versions.

`ref.mlstm_chunk_parallel` transcribes the tensor-core kernels' four
phases (gates and stabilisers, the masked (Q, Q) weights, the state walk
keeping each chunk's entry state, the outputs) in plain PyTorch. Inputs
come from numpy with a fixed seed and go through it, the port's
`mlstm_chunked` and `mlstm_recurrent`, the JAX oracle
`repro.kernels.ref.mlstm_recurrent` and the JAX Pallas kernel `mlstm_scan`
in interpret mode. In fp32 every form agrees within 2e-5 (absolute and
relative): the same function summed in another order. With `bf16_split`
(the kernel's three weighted operands as hi + lo bf16 halves) it agrees
with the fp32 plain version within the bf16 tolerance 2e-2. The wrapper's
`plan` and `scratch_bytes`, which decide and size the tensor-core path,
are checked on CPU tensors; the kernels themselves run only on the card
(`chip_smoke.py`, and the `gpu`-marked test of tests/test_torch_mlstm.py).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.mlstm_scan import mlstm_scan as jmlstm_scan  # noqa: E402
from repro_torch.kernels import mlstm_scan as ml_mod  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

# fp32: the chunkwise-parallel form against the other forms of the same
# function (sums in another order); bf16: tests/test_kernels.py's
TOL32 = dict(atol=2e-5, rtol=2e-5)
TOL16 = dict(atol=2e-2, rtol=2e-2)
j_recurrent = jax.jit(jref.mlstm_recurrent, static_argnames=("return_state",))

# (B, S, H, P, chunk, input-gate shift): S a multiple of the chunk, ragged
# S, S shorter than one chunk, and strongly negative input gates
CASES = [(1, 64, 2, 16, 16, 0.0),
         (2, 96, 2, 8, 32, 0.0),
         (1, 70, 3, 16, 32, 0.0),
         (2, 33, 1, 16, 32, 0.0),
         (1, 10, 2, 16, 64, 0.0),
         (1, 48, 2, 16, 16, -60.0)]
IDS = ["aligned", "aligned-B2", "ragged", "ragged-pad", "short", "neg-gates"]


def _inputs(B, S, H, P, shift=0.0, seed=0):
    """q, k, v normal; input gate 2 z + shift, forget gate 2 z + 1, fp32."""
    rng = np.random.default_rng(seed)
    f = np.float32
    return (rng.standard_normal((B, S, H, P)).astype(f),
            rng.standard_normal((B, S, H, P)).astype(f),
            rng.standard_normal((B, S, H, P)).astype(f),
            (2 * rng.standard_normal((B, S, H)) + shift).astype(f),
            (2 * rng.standard_normal((B, S, H)) + 1).astype(f))


def _t(arrays, dtype=torch.float32):
    return tuple(torch.from_numpy(a).to(dtype) for a in arrays)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("B,S,H,P,chunk,shift", CASES, ids=IDS)
def test_chunk_parallel_matches_every_form_in_fp32(B, S, H, P, chunk,
                                                   shift):
    arrays = _inputs(B, S, H, P, shift, seed=S + chunk)
    tin = _t(arrays)
    h, st = tref.mlstm_chunk_parallel(*tin, chunk=chunk, return_state=True)
    assert h.shape == (B, S, H, P) and h.dtype == torch.float32
    assert [tuple(x.shape) for x in st] == [(B, H, P, P), (B, H, P), (B, H)]
    assert all(bool(torch.isfinite(x).all()) for x in (h, *st))
    ch, cst = tref.mlstm_chunked(*tin, chunk=chunk, return_state=True)
    rh, rst = tref.mlstm_recurrent(*tin, return_state=True)
    jh, jst = j_recurrent(*(jnp.asarray(a) for a in arrays),
                          return_state=True)
    pallas = jmlstm_scan(*(jnp.asarray(a) for a in arrays), chunk=chunk,
                         interpret=True)
    for want in (ch, rh, jh, pallas):
        np.testing.assert_allclose(_np(h), _np(want), **TOL32)
    for wst in (cst, rst, jst):
        for a, w in zip(st, wst):
            np.testing.assert_allclose(_np(a), _np(w), **TOL32)


def test_negative_gates_drive_the_stabiliser_down():
    """With input gates near -60 the final m sits near -60 and e^{-m} is
    about 1e26; the parallel form still equals the oracle."""
    arrays = _inputs(1, 48, 2, 16, -60.0, seed=3)
    _, (_, _, m) = tref.mlstm_chunk_parallel(*_t(arrays), chunk=16,
                                             return_state=True)
    assert float(m.max()) < -40.0


@pytest.mark.parametrize("S,chunk", [(64, 16), (70, 32), (20, 64)])
def test_bf16_split_scheme_within_bf16_tolerance(S, chunk):
    """The kernel's rounding: q, k, v in bf16 (exact operands), the
    weighted operands as two bf16 halves. Against the fp32 plain version
    on the same bf16 inputs: within 2e-2, h and final state; and without
    the split (fp32 weighted operands) the parallel form is the plain
    version up to fp32 sums."""
    arrays = _inputs(2, S, 2, 64, seed=7)
    tin = _t(arrays, torch.bfloat16)
    h, st = tref.mlstm_chunk_parallel(*tin, chunk=chunk, bf16_split=True,
                                      return_state=True)
    assert h.dtype == torch.bfloat16
    want, wst = tref.mlstm_chunked(*(x.float() for x in tin), chunk=chunk,
                                   return_state=True)
    np.testing.assert_allclose(_np(h), _np(want), **TOL16)
    for a, w in zip(st, wst):
        np.testing.assert_allclose(_np(a), _np(w), **TOL16)
    h32 = tref.mlstm_chunk_parallel(*(x.float() for x in tin), chunk=chunk)
    np.testing.assert_allclose(_np(h32), _np(want), **TOL32)


def _views(B, S, H, P, dtype, offset=0):
    """q, k, v as thirds of one (B, S, H, 3P + offset) tensor, as the
    model's projection hands them over, and the two gates."""
    x = torch.zeros((B, S, H, 3 * P + offset), dtype=dtype)
    q, k, v = (x[..., offset + i * P: offset + (i + 1) * P] for i in range(3))
    g = torch.zeros((B, S, 2, H), dtype=dtype)
    return q, k, v, g[:, :, 0], g[:, :, 1]


def test_plan_routes_by_dtype_and_alignment():
    bf16 = torch.bfloat16
    TC, CC = ml_mod.TENSOR_CORE, ml_mod.CUDA_CORE
    assert ml_mod._check(*_views(1, 64, 4, 512, bf16), 64) == TC
    assert ml_mod._check(*_views(2, 33, 1, 16, bf16), 32) == TC
    assert ml_mod._check(*_views(1, 64, 4, 512, torch.float32), 64) == CC
    assert ml_mod._check(*_views(1, 16, 2, 12, bf16), 16) == CC   # P % 8
    q, k, v, ig, fg = _views(1, 16, 2, 16, bf16, offset=1)          # unaligned
    assert q.data_ptr() % 16 != 0
    assert ml_mod._check(q, k, v, ig, fg, 16) == CC
    # the tensor-core path needs no shared memory check: P = 2048 is fine
    assert ml_mod._check(*_views(1, 8, 1, 2048, bf16), 64) == TC
    with pytest.raises(ValueError, match="shared memory"):
        ml_mod._check(*_views(1, 8, 1, 2048, torch.float32), 64)


def test_scratch_bytes_at_xlstm_prefill_shape():
    """16 chunks of 64 over 4 heads of 512: the 15 chunk-entry states as
    hi/lo bf16 (60 MiB) dominate; the tile is 64 up to chunk 64, then
    128."""
    n = ml_mod.scratch_bytes(1, 1024, 4, 512, 64)
    states = 4 * 15 * 2 * 2 * 512 * 512
    W = 4 * 16 * 2 * 2 * 64 * 64
    # per-step gate terms, per-chunk scalars, row sums, own n of a chunk
    small = (5 * 4 * 4 * 1024 + 4 * 4 * 4 * 16 + 4 * 4 * 16 * 64
             + 4 * 4 * 16 * 512)
    assert n == states + W + 4 * 4 * 15 * 512 + small
    assert [ml_mod.tensor_core_tile(q) for q in (1, 64, 65, 128)] == \
        [64, 64, 128, 128]
    assert ml_mod.scratch_bytes(1, 10, 1, 16, 64) % 256 == 0
