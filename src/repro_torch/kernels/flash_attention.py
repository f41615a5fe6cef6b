"""Flash attention: the hand-written Hopper kernel and its wrapper.

The kernel (`csrc/flash_attention.cu`, CUDA C++ for sm_90a) replaces the
JAX package's Pallas TPU kernel `flash_attention`
(src/repro/kernels/flash_attention.py) and computes the same function as
`ref.attention_ref`; the source's header note says what bounds it and how
it is laid out.

`flash_attention(q, k, v)` launches the kernel for CUDA tensors and raises
on anything the kernel does not take. For CPU tensors it computes the
plain version `ref.attention_ref` (the CPU tests' path); no CUDA call ever
falls back to it. `flash_attention.launches` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import attention_ref

SOURCE = "flash_attention.cu"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 128


def _library():
    lib = _build.load(SOURCE)
    fn = lib.flash_attention_fwd
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 4
                       + [ctypes.c_int] * 6 + [ctypes.c_longlong] * 12
                       + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    return lib


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


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0):
    """q: (B, S, H, hd); k, v: (B, T, K, hd), H % K == 0, hd <= 128.

    Query i sits at absolute position i + (T - S) in the key space, as in
    `ref.attention_ref`. k and v may be strided views (a cache prefix);
    only their last dim must be contiguous. Returns (B, S, H, hd) in
    q.dtype. A row with no visible key is 0.
    """
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"no flash_attention for device {q.device}")
    _check(q, k, v)
    B, S, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    out = torch.empty((B, S, H, hd), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.flash_attention_fwd(
            _DTYPES[q.dtype], _DTYPES[k.dtype], q.data_ptr(), k.data_ptr(),
            v.data_ptr(), out.data_ptr(), B, S, T, H, K, hd,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *out.stride()[:3], int(causal), int(window), stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {rc}")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
