"""ssd_scan (`src/repro_torch/csrc/ssd_scan.cu`): the Mamba-2 chunked scan
of the hybrid's prefill. Each launch is recorded from the shapes it was
called with; its bound is the larger of its bytes over bandwidth and its
operations over the bf16 tensor cores' peak."""
from __future__ import annotations

TARGET = "repro_torch.kernels.ops:_ssd"
# the device functions, by the names the CUDA source gives them
DEVICE_NAMES = ("ssd_scan_kernel", "ssd_state_kernel", "ssd_walk_kernel",
                "ssd_out_kernel")


def record(args, kwargs):
    """(B, S, H, P, N, chunk) of `_ssd(x, dt, A, Bm, Cm, D, *, chunk,
    return_state)`: x (B, S, H, P), Bm (B, S, N)."""
    x, Bm = args[0], args[3]
    B, S, H, P = x.shape
    return (B, S, H, P, Bm.shape[-1], kwargs.get("chunk", 128))


def cost(rec, peaks):
    """(bytes, operations, peak FLOP/s) of one recorded launch."""
    return (*ssd_cost(*rec), peaks["bf16"])


def ssd_cost(B: int, S: int, H: int, P: int, N: int, Q: int):
    """(bytes, operations) the SSD scan must move and do in bf16 with the
    state out: x, dt, B, C, A, D read once, y and the fp32 state written
    once; per chunk of Q steps C_i . B_j over the causal triangle once
    (the heads share B and C) and per head W x over the triangle, C . state
    and the state update (Q N P multiply-adds each)."""
    nc, T = -(-S // Q), Q * (Q + 1) // 2
    nbytes = (2 * B * S * H * P * 2 + 4 * B * S * H + 2 * B * S * N * 2
              + 8 * H + 4 * B * H * P * N)
    return nbytes, 2 * B * nc * (T * N + H * (T * P + 2 * Q * N * P))
