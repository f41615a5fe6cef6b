"""flash_attention (`src/repro_torch/csrc/flash_attention.cu`): the
prefill, decode and fp32 attention of every model the port serves. Each
launch is recorded from the shapes it was called with; its bound is the
larger of its bytes over bandwidth and its operations over the peak of the
units doing them: fp32 queries run on the CUDA-core kernel, the rest on
bf16 tensor cores."""
from __future__ import annotations

from typing import Optional

TARGET = "repro_torch.kernels.ops:_flash"
# the device functions, by the names the CUDA source gives them
DEVICE_NAMES = ("attn_fwd_kernel", "attn_prefill_kernel",
                "attn_decode_split_kernel", "attn_decode_combine_kernel")


def record(args, kwargs):
    """(q shape, k shape, q's and k/v's element sizes, causal, a decode's
    per-lane key lengths or None) of `_flash(q, k, v, *, causal, window,
    lengths)`. The lengths stay a tensor, summed only when the stretch is
    read, so that recording makes the host wait for nothing."""
    q, k = args[0], args[1]
    return (tuple(q.shape), tuple(k.shape), q.element_size(),
            k.element_size(), kwargs.get("causal", True),
            kwargs.get("lengths"))


def cost(rec, peaks):
    """(bytes, operations, peak FLOP/s) of one recorded launch."""
    q_shape, k_shape, q_bytes, kv_bytes, causal, lengths = rec
    keys = None if lengths is None else int(lengths.sum())
    nbytes, flops = attention_cost(q_shape, k_shape, q_bytes, kv_bytes,
                                   causal=causal, keys=keys)
    return nbytes, flops, peaks["fp32"] if q_bytes == 4 else peaks["bf16"]


def attention_cost(q_shape, k_shape, q_bytes: int, kv_bytes: int, *,
                   causal: bool, keys: Optional[int] = None):
    """(bytes, operations) of one flash_attention call: q, k, v read once
    and o written once; QK^T and PV over the visible (query, key) pairs,
    2 operations per multiply-add. q (B, S, H, hd), k (B, T, K, hd). A
    causal call's queries are the last S positions of the T keys. `keys`:
    a decode's summed per-lane lengths (S = 1); the bytes then count only
    those K/V rows, and 4 bytes a lane for the lengths."""
    B, S, H, hd = q_shape
    T, K = k_shape[1], k_shape[2]
    if keys is not None:
        nbytes = (2 * B * S * H * hd * q_bytes + 4 * B
                  + 2 * keys * K * hd * kv_bytes)
        return nbytes, 4 * H * hd * keys
    if causal:
        pairs = S * (T - S) + S * (S + 1) // 2
    else:
        pairs = S * T
    nbytes = 2 * B * S * H * hd * q_bytes + 2 * B * T * K * hd * kv_bytes
    return nbytes, 4 * B * H * hd * pairs
