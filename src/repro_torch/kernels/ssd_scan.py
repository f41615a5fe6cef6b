"""Mamba-2 SSD chunk scan: the hand-written Hopper kernel and its wrapper.

The kernel (`csrc/ssd_scan.cu`, CUDA C++ for sm_90a) replaces the JAX
package's Pallas TPU kernel `ssd_scan` (src/repro/kernels/ssd_scan.py) and
computes the same function as `ref.ssd_chunked`, returning the final
state as well; the source's header note says what bounds it and how it is
laid out. `plan` picks the path by dtype and layout: bf16 with 16-byte
rows goes to the tensor-core kernels (three launches of one call, the
chunkwise-parallel form that `ref.ssd_chunk_parallel` transcribes, with
the operand roundings of `TC_OPERANDS`), everything else to the CUDA-core
kernel.

`ssd_scan(x, dt, A, Bm, Cm, D)` launches the kernel for CUDA tensors and
raises on anything the kernel does not take. For CPU tensors it computes
the plain version `ref.ssd_chunked` (the CPU tests' path); no CUDA call
ever falls back to it, and no call under autograd reaches either: with
grad mode on and an input that requires grad the wrapper raises (the
kernel has no backward). `ssd_scan.launches` counts calls that launched the
kernel (one per call, whichever path); while the program's tracer is on,
`repro_torch.tracing` counts them by path too (`ecco.ssd_scan.cuda_core`,
`ecco.ssd_scan.tensor_core`), and each launch names its path as the `path`
attribute of the innermost open span (`ecco.mamba.scan` in the Mamba-2
mixer).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch import tracing
from repro_torch.kernels import _build
from repro_torch.kernels.ref import ssd_chunked

SOURCE = "ssd_scan.cu"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_SMEM_BYTES = 232448       # csrc/ssd_scan.cu kMaxSmemBytes
CUDA_CORE, TENSOR_CORE = 0, 1  # csrc/ssd_scan.cu `path`
PATHS = {CUDA_CORE: "cuda_core", TENSOR_CORE: "tensor_core"}
MAX_TC_CHUNK = 128             # the tensor-core path's largest chunk tile
MAX_TC_N = 64                  # its largest state dim
P_TILE = 64                    # csrc/ssd_scan.cu kPTile
MAX_GRID_YZ = 65535
# how the tensor-core kernels feed their three fp32 operands to bf16
# products (`ref.ssd_chunk_parallel`'s `bf16_operands`): each as hi + lo
# halves, since one bf16 rounding of any of them breaks the bf16 tolerance
# at hymba's width (tests/test_torch_ssd_parallel.py)
TC_OPERANDS = {"W": "split", "Bw": "split", "state": "split"}


def smem_bytes(Q: int, P: int, N: int) -> int:
    """Shared memory of one block (csrc/ssd_scan.cu smem_floats): the
    chunk's x, B and C (rows padded to N + 1), the (Q, Q) weights, the
    (N, P) state and four (Q,) vectors, in fp32."""
    return 4 * (Q * P + 2 * Q * (N + 1) + Q * Q + N * P + 4 * Q)


def chunk_tile(Q: int) -> int:
    """The tensor-core path's chunk tile for a chunk of Q steps."""
    return 64 if Q <= 64 else 128


def scratch_bytes(B: int, S: int, H: int, P: int, N: int, Q: int) -> int:
    """Scratch of the tensor-core path (csrc/ssd_scan.cu `carve`): per
    (batch, head) the cumsum of dt A and dt of every step of the chunk
    tiles, each chunk's seg_end, and each chunk's (P, N) state (its own
    end state, then its entry state), all fp32, each rounded up to 256
    bytes."""
    BH, nch = B * H, -(-S // Q)
    sizes = [4 * BH * nch * chunk_tile(Q)] * 2 + [4 * BH * nch,
                                                  4 * BH * nch * P * N]
    return sum(-(-n // 256) * 256 for n in sizes)


def plan(x, Bm, Cm, Q: int) -> int:
    """The path for these inputs: TENSOR_CORE for bf16 whose x, Bm and Cm
    rows the 16-byte copies can read (P and N multiples of 8, N <= 64,
    pointers at 16 bytes, strides in multiples of 8 elements), a chunk of
    at most 128 steps and a grid that fits; CUDA_CORE otherwise (fp32, or
    such bf16), as mlstm_scan and flash_attention route them."""
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    if x.dtype != torch.bfloat16 or P % 8 or N % 8 or N > MAX_TC_N:
        return CUDA_CORE
    if Q > MAX_TC_CHUNK or B * H > MAX_GRID_YZ \
            or -(-P // P_TILE) * H > MAX_GRID_YZ:
        return CUDA_CORE
    for t, dims in ((x, 3), (Bm, 2), (Cm, 2)):
        if t.data_ptr() % 16 or any(st % 8 for st in t.stride()[:dims]):
            return CUDA_CORE
    return TENSOR_CORE


def _library():
    lib = _build.load(SOURCE)
    fn = lib.ssd_scan_fwd
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 9
                       + [ctypes.c_longlong] + [ctypes.c_int] * 6
                       + [ctypes.c_longlong] * 13 + [ctypes.c_void_p])
    return lib


def _check(x, dt, A, Bm, Cm, D, Q):
    """Raise on what neither kernel takes; return the path `plan` picks."""
    for name, t in (("dt", dt), ("A", A), ("Bm", Bm), ("Cm", Cm), ("D", D)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    if x.dim() != 4 or dt.dim() != 3 or Bm.dim() != 3 or Cm.dim() != 3 \
            or A.dim() != 1 or D.dim() != 1:
        raise ValueError(f"want x (B,S,H,P), dt (B,S,H), A and D (H,), Bm "
                         f"and Cm (B,S,N); got x {tuple(x.shape)}, dt "
                         f"{tuple(dt.shape)}, A {tuple(A.shape)}, D "
                         f"{tuple(D.shape)}, Bm {tuple(Bm.shape)}, Cm "
                         f"{tuple(Cm.shape)}")
    B, S, H, P = x.shape
    N = Bm.shape[2]
    if dt.shape != (B, S, H) or A.shape != (H,) or D.shape != (H,) \
            or Bm.shape != (B, S, N) or Cm.shape != (B, S, N):
        raise ValueError(f"x {tuple(x.shape)}, dt {tuple(dt.shape)}, A "
                         f"{tuple(A.shape)}, D {tuple(D.shape)}, Bm "
                         f"{tuple(Bm.shape)}, Cm {tuple(Cm.shape)} do not "
                         f"fit together")
    if x.dtype not in _DTYPES:
        raise TypeError(f"x dtype {x.dtype} not in float32/bfloat16")
    if Bm.dtype != x.dtype or Cm.dtype != x.dtype:
        raise TypeError(f"Bm {Bm.dtype} and Cm {Cm.dtype} must be x's "
                        f"{x.dtype}")
    for name, t in (("dt", dt), ("A", A), ("D", D)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} dtype {t.dtype} must be float32")
    if not (A.is_contiguous() and D.is_contiguous()):
        raise ValueError("A and D must be contiguous")
    for name, t in (("x", x), ("Bm", Bm), ("Cm", Cm)):
        if t.stride(-1) != 1:
            raise ValueError(f"{name} must be contiguous in its last dim")
    if B > 65535:
        raise ValueError(f"batch {B} > 65535")
    path = plan(x, Bm, Cm, Q)
    if path == CUDA_CORE and smem_bytes(Q, P, N) > MAX_SMEM_BYTES:
        raise ValueError(f"chunk {Q}, P {P}, N {N} need "
                         f"{smem_bytes(Q, P, N)} bytes of shared memory > "
                         f"{MAX_SMEM_BYTES}")
    return path


def ssd_scan(x, dt, A, Bm, Cm, D, *, chunk: int = 128,
             return_state: bool = False):
    """x: (B,S,H,P); dt: (B,S,H) fp32 post-softplus; A, D: (H,) fp32;
    Bm, Cm: (B,S,N) in x's dtype. Chunks of min(chunk, S) steps.

    x, dt, Bm and Cm may be strided views (a split projection); only their
    last dim must be contiguous. Returns y (B,S,H,P) in x.dtype, and with
    `return_state` also the final state (B,H,P,N) fp32.
    """
    _build.refuse_grad("ssd_scan", x, dt, A, Bm, Cm, D)
    if x.device.type == "cpu":
        return ssd_chunked(x, dt, A, Bm, Cm, D, chunk=chunk,
                           return_state=return_state)
    if x.device.type != "cuda":
        raise ValueError(f"no ssd_scan for device {x.device}")
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1; got {chunk}")
    B, S, H, P = x.shape
    Q = min(chunk, S) if S else 1
    path = _check(x, dt, A, Bm, Cm, D, Q)
    N = Bm.shape[-1]
    dev = x.device
    y = torch.empty((B, S, H, P), dtype=x.dtype, device=dev)
    state = (torch.empty((B, H, P, N), dtype=torch.float32, device=dev)
             if return_state else None)
    if y.numel() == 0:
        if state is not None:
            state.zero_()
        return (y, state) if return_state else y
    lib = _library()
    scratch, nbytes = None, 0
    if path == TENSOR_CORE:
        nbytes = scratch_bytes(B, S, H, P, N, Q)
        scratch = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    with torch.cuda.device(dev):    # the kernels launch on the current one
        rc = lib.ssd_scan_fwd(
            _DTYPES[x.dtype], path, x.data_ptr(), dt.data_ptr(),
            A.data_ptr(), Bm.data_ptr(), Cm.data_ptr(), D.data_ptr(),
            y.data_ptr(), None if state is None else state.data_ptr(),
            None if scratch is None else scratch.data_ptr(), nbytes,
            B, S, H, P, N, Q, *x.stride()[:3], *dt.stride(),
            *Bm.stride()[:2], *Cm.stride()[:2], *y.stride()[:3],
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"ssd_scan kernel launch failed: CUDA error {rc}")
    ssd_scan.launches += 1
    tracing.count("ecco.ssd_scan." + PATHS[path])
    tracing.annotate(path=PATHS[path])
    return (y, state) if return_state else y


ssd_scan.launches = 0
