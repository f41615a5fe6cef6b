"""Mamba-2 SSD chunk scan: the hand-written Hopper kernel and its wrapper.

The kernel (`csrc/ssd_scan.cu`, CUDA C++ for sm_90a) replaces the JAX
package's Pallas TPU kernel `ssd_scan` (src/repro/kernels/ssd_scan.py) and
computes the same function as `ref.ssd_chunked`, returning the final
state as well; the source's header note says what bounds it and how it is
laid out.

`ssd_scan(x, dt, A, Bm, Cm, D)` launches the kernel for CUDA tensors and
raises on anything the kernel does not take. For CPU tensors it computes
the plain version `ref.ssd_chunked` (the CPU tests' path); no CUDA call
ever falls back to it. `ssd_scan.launches` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import ssd_chunked

SOURCE = "ssd_scan.cu"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_SMEM_BYTES = 232448       # csrc/ssd_scan.cu kMaxSmemBytes


def smem_bytes(Q: int, P: int, N: int) -> int:
    """Shared memory of one block (csrc/ssd_scan.cu smem_floats): the
    chunk's x, B and C (rows padded to N + 1), the (Q, Q) weights, the
    (N, P) state and four (Q,) vectors, in fp32."""
    return 4 * (Q * P + 2 * Q * (N + 1) + Q * Q + N * P + 4 * Q)


def _library():
    lib = _build.load(SOURCE)
    fn = lib.ssd_scan_fwd
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 8
                       + [ctypes.c_int] * 6 + [ctypes.c_longlong] * 13
                       + [ctypes.c_void_p])
    return lib


def _check(x, dt, A, Bm, Cm, D, Q):
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
    if smem_bytes(Q, P, N) > MAX_SMEM_BYTES:
        raise ValueError(f"chunk {Q}, P {P}, N {N} need "
                         f"{smem_bytes(Q, P, N)} bytes of shared memory > "
                         f"{MAX_SMEM_BYTES}")


def ssd_scan(x, dt, A, Bm, Cm, D, *, chunk: int = 128,
             return_state: bool = False):
    """x: (B,S,H,P); dt: (B,S,H) fp32 post-softplus; A, D: (H,) fp32;
    Bm, Cm: (B,S,N) in x's dtype. Chunks of min(chunk, S) steps.

    x, dt, Bm and Cm may be strided views (a split projection); only their
    last dim must be contiguous. Returns y (B,S,H,P) in x.dtype, and with
    `return_state` also the final state (B,H,P,N) fp32.
    """
    if x.device.type == "cpu":
        return ssd_chunked(x, dt, A, Bm, Cm, D, chunk=chunk,
                           return_state=return_state)
    if x.device.type != "cuda":
        raise ValueError(f"no ssd_scan for device {x.device}")
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1; got {chunk}")
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    Q = min(chunk, S)
    _check(x, dt, A, Bm, Cm, D, Q)
    y = torch.empty((B, S, H, P), dtype=x.dtype, device=x.device)
    state = (torch.empty((B, H, P, N), dtype=torch.float32, device=x.device)
             if return_state else None)
    if y.numel() == 0:
        if state is not None:
            state.zero_()
        return (y, state) if return_state else y
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.ssd_scan_fwd(
            _DTYPES[x.dtype], x.data_ptr(), dt.data_ptr(), A.data_ptr(),
            Bm.data_ptr(), Cm.data_ptr(), D.data_ptr(), y.data_ptr(),
            None if state is None else state.data_ptr(), B, S, H, P, N, Q,
            *x.stride()[:3], *dt.stride(), *Bm.stride()[:2],
            *Cm.stride()[:2], *y.stride()[:3], stream)
    if rc != 0:
        raise RuntimeError(f"ssd_scan kernel launch failed: CUDA error {rc}")
    ssd_scan.launches += 1
    return (y, state) if return_state else y


ssd_scan.launches = 0
