"""Fused fleet drift scoring: the hand-written Hopper kernel and its wrapper.

The kernel (`csrc/fleet_drift.cu`, CUDA C++ for sm_90a) replaces the JAX
package's Pallas TPU kernel `fleet_drift`
(src/repro/kernels/fleet_drift.py) and computes the same function as
`ref.fleet_drift_ref`: every stream's token histogram over `buckets` and
its Jensen-Shannon score against the stream's reference, in one launch.
The source's header note says what bounds it and how it is laid out.

`fleet_drift(tokens, ref, ...)` launches the kernel for CUDA tensors and
raises on anything the kernel does not take. For CPU tensors it computes
the plain version `ref.fleet_drift_ref` (the CPU tests' path); no CUDA
call ever falls back to it. `fleet_drift.launches` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import fleet_drift_ref

SOURCE = "fleet_drift.cu"
MAX_BUCKETS = 1536        # csrc/fleet_drift.cu kMaxBuckets


def _library():
    lib = _build.load(SOURCE)
    fn = lib.fleet_drift_fwd
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
                       + [ctypes.c_float, ctypes.c_void_p])
    return lib


def _check(tokens, ref, buckets: int, vocab: int):
    if ref.device != tokens.device:
        raise ValueError(f"ref is on {ref.device}, tokens on {tokens.device}")
    if tokens.dim() != 2 or ref.dim() != 2:
        raise ValueError(f"tokens must be (N, T) and ref (N, buckets); got "
                         f"{tuple(tokens.shape)} and {tuple(ref.shape)}")
    if tokens.dtype != torch.int32:
        raise TypeError(f"tokens dtype {tokens.dtype} is not int32 (cast on "
                        f"the host before the copy)")
    if ref.dtype != torch.float32:
        raise TypeError(f"ref dtype {ref.dtype} is not float32")
    if not (tokens.is_contiguous() and ref.is_contiguous()):
        raise ValueError("tokens and ref must be contiguous")
    if ref.shape != (tokens.shape[0], buckets):
        raise ValueError(f"ref {tuple(ref.shape)} is not (N={tokens.shape[0]}"
                         f", buckets={buckets})")
    if not 0 < buckets <= MAX_BUCKETS:
        raise ValueError(f"buckets {buckets} not in [1, {MAX_BUCKETS}]")
    if not 0 <= vocab < 2 ** 31:
        raise ValueError(f"vocab {vocab} not in [0, 2**31)")


def fleet_drift(tokens, ref, *, buckets: int, vocab: int = 0,
                eps: float = 1e-12):
    """tokens: (N, T) int; ref: (N, buckets) nonneg reference histograms.
    Returns (scores (N,) fp32, live hists (N, buckets) fp32).

    On a CUDA device tokens must be int32 and ref float32, both
    contiguous; N == 0 returns empty outputs without a launch.
    """
    if tokens.device.type == "cpu":
        return fleet_drift_ref(tokens, ref, buckets=buckets, vocab=vocab,
                               eps=eps)
    if tokens.device.type != "cuda":
        raise ValueError(f"no fleet_drift for device {tokens.device}")
    _check(tokens, ref, buckets, vocab)
    N, T = tokens.shape
    scores = torch.empty((N,), dtype=torch.float32, device=tokens.device)
    hists = torch.empty((N, buckets), dtype=torch.float32,
                        device=tokens.device)
    if N == 0:
        return scores, hists
    lib = _library()
    with torch.cuda.device(tokens.device):
        stream = torch.cuda.current_stream(tokens.device).cuda_stream
        rc = lib.fleet_drift_fwd(tokens.data_ptr(), ref.data_ptr(),
                                 scores.data_ptr(), hists.data_ptr(), N, T,
                                 buckets, vocab, eps, stream)
    if rc != 0:
        raise RuntimeError(f"fleet_drift kernel launch failed: CUDA error "
                           f"{rc}")
    fleet_drift.launches += 1
    return scores, hists


fleet_drift.launches = 0
