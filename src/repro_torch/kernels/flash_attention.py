"""Flash attention: the hand-written Hopper kernels and their wrapper.

The kernels (`csrc/flash_attention.cu`, CUDA C++ for sm_90a) replace the
JAX package's Pallas TPU kernel `flash_attention`
(src/repro/kernels/flash_attention.py) and compute the same function as
`ref.attention_ref`; the source's header note says what bounds each path
and how it is laid out.

`plan(q, k, v)` picks the path in Python: the tensor-core prefill, the
split-KV decode (a second launch combines the splits), or the CUDA-core
kernel. `flash_attention(q, k, v)` launches it for CUDA tensors and raises
on anything the kernels do not take. For CPU tensors it computes the
plain version `ref.attention_ref` (the CPU tests' path); no CUDA call ever
falls back to it, and no call under autograd reaches either: with grad
mode on and an input that requires grad the wrapper raises (the kernel
has no backward). `flash_attention.launches` counts calls that launched
the attention kernel, `flash_attention.combine_launches` the split-KV
combine launches.
"""
from __future__ import annotations

import contextlib
import ctypes
import math
from typing import NamedTuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import attention_ref

SOURCE = "flash_attention.cu"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 128
# the kernel's path codes
PATHS = {"cuda_core": 0, "prefill": 1, "split_decode": 2}
TILE = 64          # query rows of a prefill block; keys of a kv tile
DECODE_ROWS = 16   # query rows (S x G) a split-KV block holds
SMS = 132          # streaming multiprocessors of an H100 SXM


class Plan(NamedTuple):
    """path: one of PATHS; groups: kv groups of 4 warps per prefill block
    (else 1); split: keys per split, a multiple of TILE (split_decode; else
    0); splits: their number (else 0), covering [0, T); grid: blocks of the
    attention launch."""
    path: str
    groups: int
    split: int
    splits: int
    grid: int


def _rows_16_bytes(t) -> bool:
    """t's rows start on 16-byte boundaries: aligned base and strides."""
    per = 16 // t.element_size()
    return t.data_ptr() % 16 == 0 and all(s % per == 0
                                          for s in t.stride()[:3])


def plan(q, k, v) -> Plan:
    """Which kernel path attention over these tensors takes, and its
    tiling. Tensor cores need bf16 q, k and v with 16-byte rows (hd a
    multiple of 8, aligned strides); then S x G query rows per kv head up
    to DECODE_ROWS take the split-KV decode, more take the prefill.
    Everything else (fp32 q, fp32 q over a bf16 cache, hd 18) takes the
    CUDA-core kernel. A prefill grid of fewer than 2 x SMS blocks gives
    each block two kv groups of 4 warps, which split its kv tiles. The
    decode cuts [0, T) into splits of whole tiles, as long as the grid
    still has a block for every SM: a split's block double-buffers its
    tiles, and on the card (`chip_smoke.sweep_attention_plans`) fewer,
    longer splits beat one tile per split at the serving shapes."""
    B, S, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    G = H // K
    tensor_cores = (q.dtype == k.dtype == v.dtype == torch.bfloat16
                    and hd % 8 == 0 and all(_rows_16_bytes(t)
                                            for t in (q, k, v)))
    if not tensor_cores:
        return Plan("cuda_core", 1, 0, 0,
                    math.ceil(S / (32 if S > 4 else 4)) * H * B)
    if S * G > DECODE_ROWS:
        grid = math.ceil(S / TILE) * H * B
        return Plan("prefill", 2 if grid < 2 * SMS else 1, 0, 0, grid)
    tiles = max(1, math.ceil(T / TILE))
    want = math.ceil(SMS / (B * K))
    split = TILE * max(1, tiles // want)
    splits = max(1, math.ceil(T / split))
    return Plan("split_decode", 1, split, splits, splits * K * B)


def _library():
    lib = _build.load(SOURCE)
    fn = lib.flash_attention_fwd
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_int] * 3 + [ctypes.c_void_p] * 4
                       + [ctypes.c_int] * 6 + [ctypes.c_longlong] * 12
                       + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 4)
        attrs = lib.flash_attention_attrs
        attrs.restype = ctypes.c_int
        attrs.argtypes = [ctypes.c_int, ctypes.c_int,
                          ctypes.POINTER(ctypes.c_int)]
    return lib


# the kernels `kernel_attributes` reports, by flash_attention_attrs' codes
_ATTR_CODES = {"cuda_core": 0, "prefill": 1, "split_decode": 2, "combine": 3,
               "prefill_2_groups": 4}


def kernel_attributes(kernel: str, hdp: int):
    """Registers per thread, static and dynamic shared memory bytes and
    local (spill) bytes per thread of one kernel (a key of _ATTR_CODES) at
    padded head dim `hdp` (32, 64 or 128), as the card reports them."""
    out = (ctypes.c_int * 4)()
    rc = _library().flash_attention_attrs(_ATTR_CODES[kernel], hdp, out)
    if rc != 0:
        raise RuntimeError(f"cudaFuncGetAttributes failed: CUDA error {rc}")
    return dict(zip(("registers", "static_smem", "dynamic_smem",
                     "local_bytes"), out))


def _check(q, k, v):
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dim() != 4:
            raise ValueError(f"{name} must be rank 4; got {tuple(t.shape)}")
        if t.dtype not in _DTYPES:
            raise TypeError(f"{name} dtype {t.dtype} not in float32/bfloat16")
        if t.stride(-1) != 1:
            raise ValueError(f"{name} must be contiguous in its last dim")
    B, S, H, hd = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != hd:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not fit together")
    if k.dtype != v.dtype:
        raise TypeError(f"k {k.dtype} and v {v.dtype} differ")
    if (q.dtype, k.dtype) == (torch.bfloat16, torch.float32):
        raise TypeError("bfloat16 q with float32 k/v is not supported")
    if H % k.shape[2]:
        raise ValueError(f"H={H} is not a multiple of K={k.shape[2]}")
    if hd > MAX_HEAD_DIM:
        raise ValueError(f"head_dim {hd} > {MAX_HEAD_DIM}")


def _check_lengths(q, k, v, lengths):
    """`lengths` is a (B,) int32 tensor on q's device, and the call is a
    decode: the prefill path takes no lengths."""
    if lengths.device != q.device:
        raise ValueError(f"lengths is on {lengths.device}, q on {q.device}")
    if lengths.shape != (q.shape[0],) or lengths.dtype != torch.int32:
        raise ValueError(f"lengths must be ({q.shape[0]},) int32; got "
                         f"{tuple(lengths.shape)} {lengths.dtype}")
    if plan(q, k, v).path == "prefill":
        raise ValueError(
            f"lengths is a decode's argument; q {tuple(q.shape)} over k "
            f"{tuple(k.shape)} takes the prefill path, which has none")


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    lengths=None):
    """q: (B, S, H, hd); k, v: (B, T, K, hd), H % K == 0, hd <= 128.

    Query i sits at absolute position i + (T - S) in the key space, as in
    `ref.attention_ref`. k and v may be strided views (a cache prefix);
    only their last dim must be contiguous. Returns (B, S, H, hd) in
    q.dtype. A row with no visible key is 0.

    `lengths` ((B,) int32 on q's device; a decode's only: the prefill
    path raises) gives each lane its own keys: lane b sees k[b, :lengths[b]]
    and its query i sits at position i + lengths[b] - S. k and v are then
    the whole cache (B, cap, K, hd), whose splits `plan` sizes by cap.
    """
    _build.refuse_grad("flash_attention", q, k, v)
    if lengths is not None:
        _check_lengths(q, k, v, lengths)
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window,
                             lengths=lengths)
    if q.device.type != "cuda":
        raise ValueError(f"no flash_attention for device {q.device}")
    _check(q, k, v)
    return _flash(q, k, v, causal, window, plan(q, k, v), lengths)


def _flash(q, k, v, causal, window, p: Plan, lengths=None):
    """Launch plan `p` (as `plan` makes it; `chip_smoke.py` also times
    others) on checked CUDA tensors, with per-lane `lengths` or none."""
    B, S, H, hd = q.shape
    out = torch.empty((B, S, H, hd), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    part_o = part_ml = 0
    if p.path == "split_decode":   # fp32 partials: o, then (m, l)
        rows = p.splits * B * S * H
        scratch = torch.empty(rows * (hd + 2), dtype=torch.float32,
                              device=q.device)
        part_o, part_ml = scratch.data_ptr(), scratch[rows * hd:].data_ptr()
    lib = _library()
    # entering a device context costs more host time than the launch
    here = q.device.index == torch.cuda.current_device()
    with contextlib.nullcontext() if here else torch.cuda.device(q.device):
        rc = lib.flash_attention_fwd(
            PATHS[p.path], _DTYPES[q.dtype], _DTYPES[k.dtype], q.data_ptr(),
            k.data_ptr(), v.data_ptr(), out.data_ptr(), B, S, k.shape[1], H,
            k.shape[2], hd, *q.stride()[:3], *k.stride()[:3],
            *v.stride()[:3], *out.stride()[:3], int(causal), int(window),
            p.groups, p.split, p.splits, part_o, part_ml,
            0 if lengths is None else lengths.data_ptr(),
            torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention {p.path} kernel launch "
                           f"failed: CUDA error {rc}")
    flash_attention.launches += 1
    if p.path == "split_decode":   # the same C call launched the combine
        flash_attention.combine_launches += 1
    return out


flash_attention.launches = 0
flash_attention.combine_launches = 0
