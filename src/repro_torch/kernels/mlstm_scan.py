"""Chunkwise stabilised mLSTM scan: the hand-written Hopper kernel and its
wrapper.

The kernel (`csrc/mlstm_scan.cu`, CUDA C++ for sm_90a) replaces the JAX
package's Pallas TPU kernel `mlstm_scan` (src/repro/kernels/mlstm_scan.py)
and computes the same function as `ref.mlstm_chunked`, returning the final
(C, n, m) state as well; the source's header note says what bounds it and
how it is laid out. `plan` picks the path by dtype and layout: bf16 with
16-byte rows goes to the tensor-core kernels (four launches of one call,
the chunkwise-parallel form that `ref.mlstm_chunk_parallel` transcribes),
everything else to the CUDA-core kernel.

`mlstm_scan(q, k, v, igate, fgate)` launches the kernel for CUDA tensors
and raises on anything the kernel does not take. `init_state` (C0, n0,
m0) seeds the walk in place of the zero state (the sequence-parallel
mLSTM's output pass); without it the kernels run as before. For CPU tensors it
computes the plain version `ref.mlstm_chunked` (the CPU tests' path); no
CUDA call ever falls back to it, and no call under autograd reaches
either: with grad mode on and an input that requires grad the wrapper
raises (the kernel has no backward). `mlstm_scan.launches` counts calls
that launched the kernel (one per call, whichever path).
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import mlstm_chunked

SOURCE = "mlstm_scan.cu"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_SMEM_BYTES = 232448       # csrc/mlstm_scan.cu kMaxSmemBytes
MAX_CHUNK = 128               # the largest tile the kernel is built for
ROWS_PER_BLOCK = 32           # csrc/mlstm_scan.cu kPT
MAX_GRID_YZ = 65535
CUDA_CORE, TENSOR_CORE = 0, 1  # csrc/mlstm_scan.cu `path`


def chunk_tile(Q: int) -> int:
    """The kernel's row tile for a chunk of Q steps (csrc launch_tile)."""
    return next(t for t in (16, 32, 64, 128) if Q <= t)


def smem_bytes(Q: int, P: int) -> int:
    """Shared memory of one block (csrc/mlstm_scan.cu smem_floats) at the
    tile of a chunk of Q steps: its 32 rows of C and the normaliser, the q
    and k tiles (rows padded to 33 floats), the v columns twice, the
    (QT, QT + 1) weights and six (QT,) vectors, in fp32."""
    QT = chunk_tile(Q)
    return 4 * (P * 32 + P + 2 * QT * 33 + 2 * QT * 32 + QT * (QT + 1)
                + 6 * QT + 4)


def tensor_core_tile(Q: int) -> int:
    """The tensor-core path's chunk tile for a chunk of Q steps."""
    return 64 if Q <= 64 else 128


def scratch_bytes(B: int, S: int, H: int, P: int, Q: int,
                  seeded: bool = False) -> int:
    """Scratch of the tensor-core path (csrc/mlstm_scan.cu `carve`): per
    head five fp32 per-step gate arrays, four fp32 per-chunk ones, the row
    sums, W (hi, lo bf16) and own normaliser sum of every chunk, and n and
    C (hi, lo bf16) entering every chunk after the first (every chunk when
    an initial state seeds the walk); each rounded up to 256 bytes."""
    BH, nch, QT = B * H, -(-S // Q), tensor_core_tile(Q)
    Sp = nch * Q
    kept = nch if seeded else nch - 1
    sizes = [4 * BH * Sp] * 5 + [4 * BH * nch] * 4 + [
        4 * BH * nch * QT, 2 * BH * nch * 2 * QT * QT, 4 * BH * nch * P,
        4 * BH * kept * P, 2 * BH * kept * 2 * P * P]
    return sum(-(-n // 256) * 256 for n in sizes)


def plan(q, k, v, Q: int) -> int:
    """The path for these inputs: TENSOR_CORE for bf16 whose q, k, v rows
    are 16-byte aligned (P % 8 == 0, pointers at 16 bytes, strides in
    multiples of 8 elements) and whose grid fits; CUDA_CORE otherwise
    (fp32, or unaligned bf16), as flash_attention routes such rows."""
    B, S, H, P = q.shape
    if q.dtype != torch.bfloat16 or P % 8:
        return CUDA_CORE
    if B * H > MAX_GRID_YZ or -(-S // Q) > MAX_GRID_YZ:
        return CUDA_CORE
    for t in (q, k, v):
        if t.data_ptr() % 16 or any(st % 8 for st in t.stride()[:3]):
            return CUDA_CORE
    return TENSOR_CORE


def _library():
    lib = _build.load(SOURCE)
    fn = lib.mlstm_scan_fwd
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 13
                       + [ctypes.c_longlong] + [ctypes.c_int] * 5
                       + [ctypes.c_float]
                       + [ctypes.c_longlong] * 18 + [ctypes.c_void_p])
    return lib


def _check(q, k, v, igate, fgate, Q):
    """Raise on what neither kernel takes; return the path `plan` picks."""
    for name, t in (("k", k), ("v", v), ("igate", igate), ("fgate", fgate)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    if q.dim() != 4 or igate.dim() != 3:
        raise ValueError(f"want q, k, v (B,S,H,P) and gates (B,S,H); got q "
                         f"{tuple(q.shape)}, igate {tuple(igate.shape)}")
    B, S, H, P = q.shape
    if k.shape != q.shape or v.shape != q.shape \
            or igate.shape != (B, S, H) or fgate.shape != (B, S, H):
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)}, igate {tuple(igate.shape)}, "
                         f"fgate {tuple(fgate.shape)} do not fit together")
    if q.dtype not in _DTYPES:
        raise TypeError(f"q dtype {q.dtype} not in float32/bfloat16")
    for name, t in (("k", k), ("v", v), ("igate", igate), ("fgate", fgate)):
        if t.dtype != q.dtype:
            raise TypeError(f"{name} dtype {t.dtype} must be q's {q.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(-1) != 1:
            raise ValueError(f"{name} must be contiguous in its last dim")
    if not 1 <= Q <= MAX_CHUNK:
        raise ValueError(f"chunk {Q} not in [1, {MAX_CHUNK}]")
    if B * H > 2 ** 31 - 1 or -(-P // ROWS_PER_BLOCK) > 65535:
        raise ValueError(f"grid ({B * H}, {-(-P // ROWS_PER_BLOCK)}) too "
                         f"large")
    path = plan(q, k, v, Q)
    if path == CUDA_CORE and smem_bytes(Q, P) > MAX_SMEM_BYTES:
        raise ValueError(f"chunk {Q}, P {P} need {smem_bytes(Q, P)} bytes "
                         f"of shared memory > {MAX_SMEM_BYTES}")
    return path


def _initial_state(init_state, B, H, P, device):
    """The initial state as fp32 contiguous (C0 (B,H,P,P), n0 (B,H,P),
    m0 (B,H)) on `device`; raises on other shapes."""
    want = ((B, H, P, P), (B, H, P), (B, H))
    if len(init_state) != 3:
        raise ValueError("init_state is (C, n, m)")
    out = []
    for name, t, shape in zip(("C", "n", "m"), init_state, want):
        if tuple(t.shape) != shape:
            raise ValueError(f"init_state {name} {tuple(t.shape)}, want "
                             f"{shape}")
        if t.device != device:
            raise ValueError(f"init_state {name} is on {t.device}, q on "
                             f"{device}")
        out.append(t.to(torch.float32).contiguous())
    return out


def mlstm_scan(q, k, v, igate, fgate, *, chunk: int = 128,
               return_state: bool = False, init_state=None):
    """q, k, v: (B,S,H,P); igate, fgate: (B,S,H) raw preactivations, all in
    one dtype (fp32 or bf16). Chunks of min(chunk, S) steps. `init_state`,
    when given, is (C (B,H,P,P), n (B,H,P), m (B,H)), the state the walk
    starts from (cast to fp32), in place of C = 0, n = 0, m = -inf.

    Any of the five may be a strided view (the model's einsum outputs, the
    split gate projection); only the last dim of q, k and v must be
    contiguous. Returns h (B,S,H,P) in q.dtype, and with `return_state`
    also the final state (C (B,H,P,P), n (B,H,P), m (B,H)) in fp32.
    """
    _build.refuse_grad("mlstm_scan", q, k, v, igate, fgate,
                       *(init_state or ()))
    if q.device.type == "cpu":
        return mlstm_chunked(q, k, v, igate, fgate, chunk=chunk,
                             init_state=init_state,
                             return_state=return_state)
    if q.device.type != "cuda":
        raise ValueError(f"no mlstm_scan for device {q.device}")
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1; got {chunk}")
    B, S, H, P = q.shape
    Q = min(chunk, S) if S else 1
    path = _check(q, k, v, igate, fgate, Q)
    dev = q.device
    seed = (None if init_state is None
            else _initial_state(init_state, B, H, P, dev))
    h = torch.empty((B, S, H, P), dtype=q.dtype, device=dev)
    state = None
    if return_state:
        state = (torch.empty((B, H, P, P), dtype=torch.float32, device=dev),
                 torch.empty((B, H, P), dtype=torch.float32, device=dev),
                 torch.empty((B, H), dtype=torch.float32, device=dev))
    if h.numel() == 0:
        if state is not None:
            if seed is None:
                state[0].zero_()
                state[1].zero_()
                state[2].fill_(-math.inf)
            else:
                for out, s0 in zip(state, seed):
                    out.copy_(s0)
        return (h, state) if return_state else h
    lib = _library()
    C, n, m = state if state is not None else (None, None, None)
    C0, n0, m0 = seed if seed is not None else (None, None, None)
    scratch, nbytes = None, 0
    if path == TENSOR_CORE:
        nbytes = scratch_bytes(B, S, H, P, Q, seeded=seed is not None)
        scratch = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.mlstm_scan_fwd(
            _DTYPES[q.dtype], path, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            igate.data_ptr(), fgate.data_ptr(), h.data_ptr(),
            *(None if t is None else t.data_ptr()
              for t in (C, n, m, C0, n0, m0)),
            None if scratch is None else scratch.data_ptr(), nbytes,
            B, S, H, P, Q,
            1.0 / math.sqrt(P), *q.stride()[:3], *k.stride()[:3],
            *v.stride()[:3], *igate.stride(), *fgate.stride(),
            *h.stride()[:3], stream)
    if rc != 0:
        raise RuntimeError(f"mlstm_scan kernel launch failed: CUDA error {rc}")
    mlstm_scan.launches += 1
    return (h, state) if return_state else h


mlstm_scan.launches = 0
