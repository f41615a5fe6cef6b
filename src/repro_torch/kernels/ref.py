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


def _normalize(x, eps: float):
    x = x.to(F32) + eps
    return x / torch.sum(x, dim=-1, keepdim=True)


def pairwise_js_ref(p, q, *, eps: float = 1e-12):
    """Materialized (N, M, B) JS-divergence matrix between histogram rows.

    p: (N, B); q: (M, B), nonnegative (rows need not be normalized: the
    eps-shift + renormalize of core.drift.js_divergence). Returns (N, M)
    fp32 with out[i, j] = JS(p[i], q[j]).
    """
    pe = _normalize(p, eps)[:, None, :]                 # (N, 1, B)
    qe = _normalize(q, eps)[None, :, :]                 # (1, M, B)
    m = 0.5 * (pe + qe)                                 # (N, M, B)
    kl_pm = torch.sum(pe * torch.log(pe / m), dim=-1)
    kl_qm = torch.sum(qe * torch.log(qe / m), dim=-1)
    return 0.5 * (kl_pm + kl_qm)


def bucket_index(tokens, buckets: int, vocab: int = 0):
    """Bucket of every token, in int64: clip((t * buckets) // vocab) with
    floor division when a vocab is known (a token at exactly `vocab`
    lands in the top bucket), floor-modulo hashing when vocab == 0 (a
    negative token lands in [0, buckets))."""
    t = tokens.to(torch.int64)
    if vocab:
        return torch.clamp(torch.div(t * buckets, vocab,
                                     rounding_mode="floor"), 0, buckets - 1)
    return torch.remainder(t, buckets)


def fleet_drift_ref(tokens, ref, *, buckets: int, vocab: int = 0,
                    eps: float = 1e-12):
    """Fused drift scoring, the plain way.

    tokens: (N, T) int; ref: (N, buckets) nonneg reference histograms.
    Per stream i: histogram tokens[i] over `buckets` (bucket_index's
    rule), normalize, and score JS(hist_i, ref_i) with the eps-shift +
    renormalize of core.drift.js_divergence. Returns (scores (N,) fp32,
    hists (N, buckets) fp32).

    The histogram is one scatter_add_ over row-offset bucket indices,
    not an (N, T, buckets) one-hot, so it runs at fleet scale (a one-hot
    at 100k streams of 256 tokens over 64 buckets is 6.5 GB).
    """
    N = tokens.shape[0]
    dev = tokens.device
    if N == 0:
        return (torch.zeros((0,), dtype=F32, device=dev),
                torch.zeros((0, buckets), dtype=F32, device=dev))
    idx = bucket_index(tokens.reshape(N, -1), buckets, vocab)
    idx = idx + buckets * torch.arange(N, device=dev)[:, None]
    h = torch.zeros(N * buckets, dtype=F32, device=dev).scatter_add_(
        0, idx.reshape(-1), torch.ones(idx.numel(), dtype=F32, device=dev))
    h = h.reshape(N, buckets)
    h = h / torch.clamp(torch.sum(h, dim=-1, keepdim=True), min=1.0)
    p = _normalize(h, eps)
    q = _normalize(ref, eps)
    m = 0.5 * (p + q)
    kl_pm = torch.sum(p * torch.log(p / m), dim=-1)
    kl_qm = torch.sum(q * torch.log(q / m), dim=-1)
    return 0.5 * (kl_pm + kl_qm), h
