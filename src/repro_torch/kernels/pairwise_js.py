"""Batched pairwise Jensen-Shannon divergence: the hand-written Hopper
kernel and its wrapper.

The kernel (`csrc/pairwise_js.cu`, CUDA C++ for sm_90a) replaces the JAX
package's Pallas TPU kernel `pairwise_js`
(src/repro/kernels/pairwise_js.py) and computes the same function as
`ref.pairwise_js_ref`: the (N, M) JS matrix between histogram rows, the
similarity engine behind the grouping shortlist. The source's header note
says what bounds it and how it is laid out.

`pairwise_js(p, q)` launches the kernel for CUDA tensors and raises on
anything the kernel does not take. For CPU tensors it computes the plain
version `ref.pairwise_js_ref` (the CPU tests' path); no CUDA call ever
falls back to it. `pairwise_js.launches` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import pairwise_js_ref

SOURCE = "pairwise_js.cu"
MAX_BUCKETS = 1024        # csrc/pairwise_js.cu kMaxBuckets
_F32 = torch.float32
_fn = None                # the bound C entry point, after the first call


def _kernel():
    global _fn
    if _fn is None:
        fn = _build.load(SOURCE).pairwise_js_fwd
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
                       + [ctypes.c_float, ctypes.c_void_p])
        _fn = fn
    return _fn


def _check(p, q):
    """Raise on what the kernel does not take (a few attribute reads: the
    grouper calls this once per request)."""
    if p.dtype is not _F32 or q.dtype is not _F32:
        raise TypeError(f"p {p.dtype} and q {q.dtype} must be float32")
    if p.dim() != 2 or q.dim() != 2 or p.shape[1] != q.shape[1]:
        raise ValueError(f"p must be (N, B) and q (M, B); got "
                         f"{tuple(p.shape)} and {tuple(q.shape)}")
    if q.device != p.device:
        raise ValueError(f"q is on {q.device}, p on {p.device}")
    if not (p.is_contiguous() and q.is_contiguous()):
        raise ValueError("p and q must be contiguous")
    if not 0 < p.shape[1] <= MAX_BUCKETS:
        raise ValueError(f"B={p.shape[1]} not in [1, {MAX_BUCKETS}]")


def pairwise_js(p, q, *, eps: float = 1e-12):
    """p: (N, B) and q: (M, B) nonneg histograms -> (N, M) fp32 JS.
    Empty N or M returns an empty (N, M) matrix without a launch."""
    dev = p.device
    if dev.type == "cpu":
        return pairwise_js_ref(p, q, eps=eps)
    if dev.type != "cuda":
        raise ValueError(f"no pairwise_js for device {dev}")
    _check(p, q)
    N, B = p.shape
    M = q.shape[0]
    out = torch.empty((N, M), dtype=_F32, device=dev)
    if N == 0 or M == 0:
        return out
    fn = _kernel()
    args = (p.data_ptr(), q.data_ptr(), out.data_ptr(), N, M, B, eps)
    stream = torch.cuda.current_stream(dev).cuda_stream
    if dev.index == torch.cuda.current_device():
        rc = fn(*args, stream)
    else:       # the kernel launches on the current device
        with torch.cuda.device(dev):
            rc = fn(*args, stream)
    if rc != 0:
        raise RuntimeError(f"pairwise_js kernel launch failed: CUDA error "
                           f"{rc}")
    pairwise_js.launches += 1
    return out


pairwise_js.launches = 0
