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


def _library():
    lib = _build.load(SOURCE)
    fn = lib.pairwise_js_fwd
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
                       + [ctypes.c_float, ctypes.c_void_p])
    return lib


def _check(p, q):
    if q.device != p.device:
        raise ValueError(f"q is on {q.device}, p on {p.device}")
    if p.dim() != 2 or q.dim() != 2 or p.shape[1] != q.shape[1]:
        raise ValueError(f"p must be (N, B) and q (M, B); got "
                         f"{tuple(p.shape)} and {tuple(q.shape)}")
    if p.dtype != torch.float32 or q.dtype != torch.float32:
        raise TypeError(f"p {p.dtype} and q {q.dtype} must be float32")
    if not (p.is_contiguous() and q.is_contiguous()):
        raise ValueError("p and q must be contiguous")
    if not 0 < p.shape[1] <= MAX_BUCKETS:
        raise ValueError(f"B={p.shape[1]} not in [1, {MAX_BUCKETS}]")


def pairwise_js(p, q, *, eps: float = 1e-12):
    """p: (N, B) and q: (M, B) nonneg histograms -> (N, M) fp32 JS.
    Empty N or M returns an empty (N, M) matrix without a launch."""
    if p.device.type == "cpu":
        return pairwise_js_ref(p, q, eps=eps)
    if p.device.type != "cuda":
        raise ValueError(f"no pairwise_js for device {p.device}")
    _check(p, q)
    N, B = p.shape
    M = q.shape[0]
    out = torch.empty((N, M), dtype=torch.float32, device=p.device)
    if out.numel() == 0:
        return out
    lib = _library()
    with torch.cuda.device(p.device):
        stream = torch.cuda.current_stream(p.device).cuda_stream
        rc = lib.pairwise_js_fwd(p.data_ptr(), q.data_ptr(), out.data_ptr(),
                                 N, M, B, eps, stream)
    if rc != 0:
        raise RuntimeError(f"pairwise_js kernel launch failed: CUDA error "
                           f"{rc}")
    pairwise_js.launches += 1
    return out


pairwise_js.launches = 0
