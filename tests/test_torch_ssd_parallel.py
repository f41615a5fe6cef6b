"""The chunkwise-parallel SSD of the `ssd_scan` kernel's bf16 path, held to
the JAX package and to the port's plain versions.

`ref.ssd_chunk_parallel` transcribes the tensor-core kernels' phases (the
gates, the intra-chunk output and each chunk's own end state, the walk
keeping each chunk's entry state, the outputs) in plain PyTorch. Inputs
come from numpy with a fixed seed and go through it, the JAX chunked form
`repro.models.ssm.ssd_chunked`, the JAX Pallas kernel `ssd_scan` in
interpret mode, the JAX oracle `repro.kernels.ref.ssd_recurrent` and the
port's `ssd_chunked` and `ssd_recurrent`. In fp32 every form agrees within
2e-4, states included (tests/test_kernels.py's fp32 tolerance). With the
kernel's operand roundings (`ssd_scan.TC_OPERANDS`: W, B o w and the entry
state each as hi + lo bf16 halves) on bf16 inputs it agrees with the fp32
plain version within the bf16 tolerance 2e-2, also at hymba-1.5b's full
prefill shape, where one bf16 rounding of any of the three would not. The
wrapper's `plan` and `scratch_bytes`, which decide and size the
tensor-core path, are checked on CPU tensors; the kernels
themselves run only on the card (`chip_smoke.py`, and the `gpu`-marked
test of tests/test_torch_ssd.py).

    python tests/test_torch_ssd_parallel.py

prints, at hymba's full shape and chunks 64 and 128, the largest error of
every rounding scheme over the tolerance (1 is the bf16 tolerance).
"""
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.ssd_scan import ssd_scan as jssd_scan  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels import ssd_scan as ssd_mod  # noqa: E402

TOL32 = dict(atol=2e-4, rtol=2e-4)
TOL16 = dict(atol=2e-2, rtol=2e-2)
j_chunked = jax.jit(jssm.ssd_chunked,
                    static_argnames=("chunk", "return_state"))
j_recurrent = jax.jit(jref.ssd_recurrent, static_argnames=("return_state",))

# (B, S, H, P, N, chunk, A scale): S a multiple of the chunk, ragged S (70
# at chunk 64; 1000), S shorter than one chunk, strongly negative A, batch 2
CASES = [(1, 128, 2, 16, 16, 64, 1.0),
         (1, 70, 2, 16, 16, 64, 1.0),
         (1, 1000, 2, 8, 16, 128, 1.0),
         (1, 20, 3, 16, 8, 64, 1.0),
         (1, 96, 2, 16, 16, 32, 40.0),
         (2, 80, 2, 16, 32, 32, 1.0)]
IDS = ["aligned", "ragged-70", "ragged-1000", "short", "neg-A", "B2"]
HYMBA = (1, 1152, 50, 64, 16)


def _inputs(B, S, H, P, N, a_scale=1.0, seed=0, dtype=np.float32):
    """x, Bm, Cm normal; dt softplus of a normal; A = -a_scale exp(0.3 z);
    D = 1 + 0.1 z, as numpy fp32; with dtype bfloat16 x, dt, Bm and Cm are
    rounded to bf16 first (as the model hands them over)."""
    rng = np.random.default_rng(seed)
    f = np.float32

    def rnd(a):
        a = a.astype(f)
        if dtype == "bfloat16":
            a = np.asarray(jnp.asarray(a, jnp.bfloat16), f)
        return a

    x = rnd(rng.standard_normal((B, S, H, P)))
    dt = rnd(np.log1p(np.exp(rng.standard_normal((B, S, H)))))
    A = (-a_scale * np.exp(0.3 * rng.standard_normal(H))).astype(f)
    Bm, Cm = rnd(rng.standard_normal((B, S, N))), rnd(
        rng.standard_normal((B, S, N)))
    D = (1.0 + 0.1 * rng.standard_normal(H)).astype(f)
    return x, dt, A, Bm, Cm, D


def _t(arrays, dtype=torch.float32):
    """x, Bm and Cm in `dtype`, dt, A and D in fp32."""
    x, dt, A, Bm, Cm, D = (torch.from_numpy(np.array(a)) for a in arrays)
    return x.to(dtype), dt, A, Bm.to(dtype), Cm.to(dtype), D


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("B,S,H,P,N,chunk,a_scale", CASES, ids=IDS)
def test_chunk_parallel_matches_every_form_in_fp32(B, S, H, P, N, chunk,
                                                   a_scale):
    arrays = _inputs(B, S, H, P, N, a_scale, seed=S + chunk)
    tin = _t(arrays)
    y, st = tref.ssd_chunk_parallel(*tin, chunk=chunk, return_state=True)
    assert y.shape == (B, S, H, P) and y.dtype == torch.float32
    assert st.shape == (B, H, P, N) and st.dtype == torch.float32
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(st).all())
    jin = tuple(jnp.asarray(a) for a in arrays)
    jy, jst = j_chunked(*jin, chunk=chunk, return_state=True)
    ry, rst = j_recurrent(*jin, return_state=True)
    pallas = jssd_scan(*jin, chunk=chunk, interpret=True)
    cy, cst = tref.ssd_chunked(*tin, chunk=chunk, return_state=True)
    oy, ost = tref.ssd_recurrent(*tin, return_state=True)
    for want in (jy, ry, pallas, cy, oy):
        np.testing.assert_allclose(_np(y), _np(want), **TOL32)
    for want in (jst, rst, cst, ost):
        np.testing.assert_allclose(_np(st), _np(want), **TOL32)


@pytest.mark.parametrize("B,S,H,P,N,chunk,a_scale", CASES, ids=IDS)
def test_kernel_roundings_within_bf16_tolerance(B, S, H, P, N, chunk,
                                                a_scale):
    """bf16 x, B, C (exact operands) and the kernel's hi/lo halves of W,
    B o w and the entry state, against the fp32 forms on the same bf16
    inputs: the JAX chunked form, the JAX oracle and the port's chunked
    form, y and final state within 2e-2."""
    arrays = _inputs(B, S, H, P, N, a_scale, seed=S + chunk,
                     dtype="bfloat16")
    tin = _t(arrays, torch.bfloat16)
    y, st = tref.ssd_chunk_parallel(*tin, chunk=chunk,
                                    bf16_operands=ssd_mod.TC_OPERANDS,
                                    return_state=True)
    assert y.dtype == torch.bfloat16
    jin = tuple(jnp.asarray(a) for a in arrays)
    jy, jst = j_chunked(*jin, chunk=chunk, return_state=True)
    ry, rst = j_recurrent(*jin, return_state=True)
    cy, cst = tref.ssd_chunked(*_t(arrays), chunk=chunk, return_state=True)
    for want in (jy, ry, cy):
        np.testing.assert_allclose(_np(y), _np(want), **TOL16)
    for want in (jst, rst, cst):
        np.testing.assert_allclose(_np(st), _np(want), **TOL16)


def _hymba(seed=0):
    """hymba-1.5b's prefill shape (1, 1152, 50, 64), N 16, in bf16, drawn
    as chip_smoke.py draws them."""
    g = torch.Generator().manual_seed(seed)
    bf = torch.bfloat16
    B, S, H, P, N = HYMBA
    x = torch.randn((B, S, H, P), generator=g).to(bf)
    dt = torch.nn.functional.softplus(
        torch.randn((B, S, H), generator=g)).to(bf).float()
    A = -torch.exp(0.3 * torch.randn((H,), generator=g))
    Bm, Cm = torch.randn((B, S, 2 * N), generator=g).to(bf).chunk(2, -1)
    D = 1.0 + 0.1 * torch.randn((H,), generator=g)
    return x, dt, A, Bm, Cm, D


def _over_tolerance(got, want, tol=2e-2):
    """max |got - want| / (tol + tol |want|): <= 1 within tolerance."""
    g, w = got.float(), want.float()
    return float(((g - w).abs() / (tol + tol * w.abs())).max())


def rounding_errors(chunk, schemes, seed=0):
    """For each scheme (a mapping of `ref.SSD_OPERANDS` to None, "bf16" or
    "split"), the largest error of y and of the final state over the bf16
    tolerance, at hymba's full shape against `ssd_chunked` on the same
    inputs."""
    args = _hymba(seed)
    wy, wst = tref.ssd_chunked(*args, chunk=chunk, return_state=True)
    out = {}
    for how in schemes:
        y, st = tref.ssd_chunk_parallel(*args, chunk=chunk,
                                        bf16_operands=how, return_state=True)
        out[tuple(how.get(k) for k in tref.SSD_OPERANDS)] = (
            _over_tolerance(y, wy), _over_tolerance(st, wst))
    return out


@pytest.mark.parametrize("chunk", [64, 128])
def test_kernel_roundings_at_hymba_shape(chunk):
    """At (1, 1152, 50, 64), N 16: the kernel's scheme keeps y and the
    state within the bf16 tolerance; one bf16 rounding of any one of the
    three operands (the others split) would not, which is why each goes in
    as two halves."""
    single = [{**ssd_mod.TC_OPERANDS, k: "bf16"} for k in tref.SSD_OPERANDS]
    errs = rounding_errors(chunk, [ssd_mod.TC_OPERANDS] + single)
    ey, est = errs[tuple(ssd_mod.TC_OPERANDS[k] for k in tref.SSD_OPERANDS)]
    assert ey <= 1.0 and est <= 1.0, (ey, est)
    for how in single:
        key = tuple(how[k] for k in tref.SSD_OPERANDS)
        assert errs[key][0] > 1.0, (key, errs[key])


def test_unknown_operand_rejected():
    args = _t(_inputs(1, 8, 1, 8, 8))
    with pytest.raises(ValueError, match="unknown operands"):
        tref.ssd_chunk_parallel(*args, bf16_operands={"C": "bf16"})
    with pytest.raises(ValueError, match="rounding"):
        tref.ssd_chunk_parallel(*args, bf16_operands={"W": "fp8"})


# ---------------------------------------------------------------------------
# the wrapper's plan, scratch and grid
# ---------------------------------------------------------------------------
def _views(B, S, H, P, N, dtype, offset=0):
    """x (B, S, H, P) contiguous, Bm and Cm as the two halves of one (B, S,
    2N + offset) projection from `offset` on, as apply_mamba hands them
    over."""
    x = torch.zeros((B, S, H, P), dtype=dtype)
    bc = torch.zeros((B, S, 2 * N + offset), dtype=dtype)
    return x, bc[..., offset:offset + N], bc[..., offset + N:]


def test_plan_routes_by_dtype_alignment_and_shape():
    bf16, TC, CC = torch.bfloat16, ssd_mod.TENSOR_CORE, ssd_mod.CUDA_CORE
    assert ssd_mod.plan(*_views(1, 1152, 50, 64, 16, bf16), 64) == TC
    assert ssd_mod.plan(*_views(1, 1152, 50, 64, 16, bf16), 128) == TC
    assert ssd_mod.plan(*_views(2, 80, 1, 64, 8, bf16), 32) == TC
    assert ssd_mod.plan(*_views(1, 32, 4, 16, 32, bf16), 32) == TC
    assert ssd_mod.plan(*_views(1, 1152, 50, 64, 16, torch.float32),
                        64) == CC
    assert ssd_mod.plan(*_views(1, 16, 2, 12, 16, bf16), 16) == CC  # P % 8
    assert ssd_mod.plan(*_views(1, 16, 2, 16, 12, bf16), 16) == CC  # N % 8
    assert ssd_mod.plan(*_views(1, 16, 2, 16, 72, bf16), 16) == CC  # N > 64
    assert ssd_mod.plan(*_views(1, 300, 2, 16, 16, bf16), 256) == CC
    x, Bm, Cm = _views(1, 16, 2, 16, 16, bf16, offset=1)    # unaligned B, C
    assert Bm.data_ptr() % 16 and Bm.stride(1) % 8
    assert ssd_mod.plan(x, Bm, Cm, 16) == CC
    x = torch.zeros((1, 16, 2, 24), dtype=bf16)[..., :16]   # x row stride 24
    assert ssd_mod.plan(x, *_views(1, 16, 2, 16, 16, bf16)[1:], 16) == TC
    x = torch.zeros((1, 16, 2, 20), dtype=bf16)[..., :16]   # stride 20
    assert ssd_mod.plan(x, *_views(1, 16, 2, 16, 16, bf16)[1:], 16) == CC


def test_check_returns_the_plan():
    """_check raises what neither kernel takes and returns plan's path;
    the tensor-core path has no shared-memory limit on the chunk's P."""
    bf16 = torch.bfloat16
    x, Bm, Cm = _views(1, 8, 2, 256, 16, bf16)
    dt, A, D = torch.zeros((1, 8, 2)), torch.zeros(2), torch.zeros(2)
    assert ssd_mod._check(x, dt, A, Bm, Cm, D, 8) == ssd_mod.TENSOR_CORE
    assert ssd_mod._check(x.float(), dt, A, Bm.float(), Cm.float(), D, 8) \
        == ssd_mod.CUDA_CORE


def test_scratch_bytes_at_hymba_prefill_shape():
    """18 chunks of 64 over 50 heads of (64, 16): the chunk states (and
    then entry states), 3.7 MB, dominate; cum and dt per step of the chunk
    tiles, seg_end per chunk."""
    n = ssd_mod.scratch_bytes(1, 1152, 50, 64, 16, 64)
    assert n == 4 * 50 * 18 * 64 * 16 + 2 * 4 * 50 * 18 * 64 \
        + (-(-4 * 50 * 18 // 256) * 256)
    # chunk 40 runs on the 64-step tile (2 chunks), chunk 100 on the
    # 128-step one (1 chunk); each array rounded up to 256 bytes
    assert ssd_mod.scratch_bytes(1, 80, 1, 8, 8, 40) == 512 + 512 + 256 + 512
    assert ssd_mod.scratch_bytes(1, 80, 1, 8, 8, 100) == 512 + 512 + 256 + 256
    assert [ssd_mod.chunk_tile(q) for q in (1, 64, 65, 128)] == \
        [64, 64, 128, 128]
    assert all(ssd_mod.scratch_bytes(*s) % 256 == 0 for s in
               [(1, 10, 1, 16, 8, 64), (2, 1000, 3, 24, 40, 128)])


def main():
    schemes = [dict(zip(tref.SSD_OPERANDS, c)) for c in
               itertools.product([None, "bf16", "split"], repeat=3)]
    for chunk in (64, 128):
        for key, (ey, est) in rounding_errors(chunk, schemes).items():
            print(f"chunk {chunk} W={key[0]} Bw={key[1]} state={key[2]}: "
                  f"y {ey:.3f}, state {est:.3f} of the bf16 tolerance")


if __name__ == "__main__":
    main()
