"""Fused fleet drift scoring: the hand-written Hopper kernel and its wrapper.

The kernel (`csrc/fleet_drift.cu`, CUDA C++ for sm_90a) replaces the JAX
package's Pallas TPU kernel `fleet_drift`
(src/repro/kernels/fleet_drift.py) and computes the same function as
`ref.fleet_drift_ref`: every stream's token histogram over `buckets` and
its Jensen-Shannon score against the stream's reference, in one launch.
The source's header note says what bounds it and how it is laid out.
`bucket_plan` computes, on the host, how the kernel finds a token's
bucket without a hardware division (a lookup table, or the reciprocal
of vocab or of B); a warp counts each row into one shared-memory counter
per bucket with atomics.

`fleet_drift(tokens, ref, ...)` launches the kernel for CUDA tensors and
raises on anything the kernel does not take. For CPU tensors it computes
the plain version `ref.fleet_drift_ref` (the CPU tests' path); no CUDA
call ever falls back to it. `fleet_drift.launches` counts kernel launches.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import fleet_drift_ref

SOURCE = "fleet_drift.cu"
MAX_BUCKETS = 1536
MAX_SMEM_BYTES = 232448   # csrc/fleet_drift.cu kMaxSmemBytes
WARPS = 8                 # csrc/fleet_drift.cu kWarps
# csrc/fleet_drift.cu BucketMode
WIDE, LUT, RECIP, MASK, MODR = range(5)
LUT_MAX_VOCAB = 4096      # the largest vocab whose table the kernel stages


class BucketPlan(NamedTuple):
    """How the kernel computes a token's bucket: `mode` (WIDE, LUT, RECIP,
    MASK or MODR), the reciprocal `magic` (RECIP, MODR) and the table
    `lut` of the vocab + 1 buckets of the clipped tokens (LUT)."""
    mode: int
    magic: int = 0
    lut: Optional[np.ndarray] = None


def reciprocal(d: int) -> int:
    """M = floor(2^64 / d) + 1: for 0 <= u < 2^32 and 2 <= d < 2^31,
    floor(u M / 2^64) = floor(u / d) exactly, since u (M d - 2^64) <= u d
    < 2^64."""
    if not 2 <= d < 2 ** 31:
        raise ValueError(f"no reciprocal for {d}")
    return (1 << 64) // d + 1


def bucket_table(buckets: int, vocab: int) -> np.ndarray:
    """The bucket of every clipped token 0 .. vocab, int32, as
    core.drift.batch_token_histogram tabulates it."""
    t = np.arange(vocab + 1, dtype=np.int64)
    return np.minimum(t * buckets // vocab, buckets - 1).astype(np.int32)


def bucket_plan(buckets: int, vocab: int) -> BucketPlan:
    """The kernel's bucket rule for (buckets, vocab): with a vocab, a table
    up to LUT_MAX_VOCAB, else the reciprocal of vocab where vocab * buckets
    < 2^32, else the 64-bit division; with vocab 0, a mask for a
    power-of-two `buckets` (1 included), else the reciprocal of
    `buckets`."""
    if vocab:
        if vocab <= LUT_MAX_VOCAB:
            return BucketPlan(LUT, lut=bucket_table(buckets, vocab))
        if vocab * buckets < 2 ** 32:
            return BucketPlan(RECIP, magic=reciprocal(vocab))
        return BucketPlan(WIDE)
    if buckets & (buckets - 1) == 0:
        return BucketPlan(MASK)
    return BucketPlan(MODR, magic=reciprocal(buckets))


def smem_bytes(buckets: int, lut_entries: int = 0) -> int:
    """Shared memory of one block (csrc smem_bytes): each warp's counters,
    one per bucket, and the lookup table."""
    return 4 * (WARPS * buckets + lut_entries)


_TABLES = {}


def _device_table(lut: np.ndarray, buckets: int, vocab: int, device):
    """The lookup table on `device`, uploaded once per (device, buckets,
    vocab)."""
    key = (str(device), buckets, vocab)
    t = _TABLES.get(key)
    if t is None:
        t = torch.from_numpy(lut).to(device)
        _TABLES[key] = t
    return t


def _library():
    lib = _build.load(SOURCE)
    fn = lib.fleet_drift_fwd
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_ulonglong,
                          ctypes.c_void_p, ctypes.c_void_p])
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
    dev = tokens.device
    scores = torch.empty((N,), dtype=torch.float32, device=dev)
    hists = torch.empty((N, buckets), dtype=torch.float32, device=dev)
    if N == 0:
        return scores, hists
    bp = bucket_plan(buckets, vocab)
    lut = None if bp.lut is None else _device_table(bp.lut, buckets, vocab,
                                                    dev)
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.fleet_drift_fwd(
            tokens.data_ptr(), ref.data_ptr(), scores.data_ptr(),
            hists.data_ptr(), N, T, buckets, vocab, eps, bp.mode, bp.magic,
            None if lut is None else lut.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"fleet_drift kernel launch failed: CUDA error "
                           f"{rc}")
    fleet_drift.launches += 1
    return scores, hists


fleet_drift.launches = 0
