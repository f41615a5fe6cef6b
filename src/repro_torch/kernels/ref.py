"""Plain PyTorch versions of the port's kernels.

These are the definitions of correctness, mirroring the JAX package's
`kernels/ref.py` oracles: simple, materialize-everything implementations.
The CPU tests hold them to the JAX oracles, `chip_smoke.py` holds each
CUDA kernel to them on the card, and each kernel's wrapper falls to them
for a tensor that lies on the CPU.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30
F32 = torch.float32


def attention_ref(q, k, v, *, causal: bool = True, window: int = 0):
    """Materialized softmax attention with GQA.

    q: (B, S, H, hd); k, v: (B, T, K, hd) with H % K == 0.
    Query i sits at absolute position i + (T - S) in the key space.
    window > 0 limits key visibility to 0 <= qpos - j < window (causal
    sliding window). Scores and softmax in fp32. Returns (B, S, H, hd)
    in q.dtype.
    """
    B, S, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    G = H // K
    kk = k.repeat_interleave(G, dim=2)
    vv = v.repeat_interleave(G, dim=2)
    s = torch.einsum("bshd,bthd->bhst", q.to(F32), kk.to(F32))
    s = s / math.sqrt(hd)
    i = torch.arange(S, device=q.device)[:, None]
    j = torch.arange(T, device=q.device)[None, :]
    mask = torch.ones((S, T), dtype=torch.bool, device=q.device)
    if causal:
        qpos = i + (T - S)
        mask &= j <= qpos
        if window > 0:
            mask &= (qpos - j) < window
    s = torch.where(mask[None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhst,bthd->bshd", p, vv.to(F32))
    return o.to(q.dtype)
