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


# ---------------------------------------------------------------------------
# SSD (Mamba-2): the chunked form and the token-by-token oracle
# ---------------------------------------------------------------------------
def ssd_chunked(x, dt, A, Bm, Cm, D, *, chunk: int = 64, init_state=None,
                return_state: bool = False):
    """Chunkwise SSD scan, the plain version of the `ssd_scan` kernel.

    x: (B,S,H,P), dt: (B,S,H) (post-softplus), A: (H,) negative,
    Bm, Cm: (B,S,N), D: (H,) skip. Chunks of Q = min(chunk, S) steps: the
    intra-chunk term (C B^T o L) x with L[i, j] = exp(cum_i - cum_j) dt_j
    for j <= i, the inter-chunk term exp(cum_i) C_i . state, and the state
    carried from chunk to chunk; a ragged tail is padded with dt = 0.
    fp32 math. Returns y (B,S,H,P) in x.dtype [, state (B,H,P,N) fp32].
    """
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    Q = min(chunk, S)
    pad = (-S) % Q
    x32, dt32 = x.to(F32), dt.to(F32)
    B32, C32 = Bm.to(F32), Cm.to(F32)
    if pad:
        x32 = torch.nn.functional.pad(x32, (0, 0, 0, 0, 0, pad))
        dt32 = torch.nn.functional.pad(dt32, (0, 0, 0, pad))
        B32 = torch.nn.functional.pad(B32, (0, 0, 0, pad))
        C32 = torch.nn.functional.pad(C32, (0, 0, 0, pad))
    n = x32.shape[1] // Q
    xc = x32.reshape(Bsz, n, Q, H, P)
    dtc = dt32.reshape(Bsz, n, Q, H)
    Bc = B32.reshape(Bsz, n, Q, N)
    Cc = C32.reshape(Bsz, n, Q, N)

    cum = torch.cumsum(dtc * A.to(F32), dim=2)               # (B,n,Q,H)
    seg_end = cum[:, :, -1, :]                               # (B,n,H)

    # intra-chunk; the mask selects 0 before the exponential, whose
    # argument is positive (and may overflow) above the diagonal
    li = cum[:, :, :, None, :] - cum[:, :, None, :, :]       # (B,n,Q,Q,H)
    mask = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()
    li = torch.where(mask[None, None, :, :, None], li, NEG_INF)
    Lmat = torch.exp(li) * dtc[:, :, None, :, :]
    CB = torch.einsum("bcis,bcjs->bcij", Cc, Bc)             # (B,n,Q,Q)
    y = torch.einsum("bcijh,bcjhp->bcihp", CB[..., None] * Lmat, xc)

    # each chunk's own end state, then the recurrence over chunks
    wj = torch.exp(seg_end[:, :, None, :] - cum) * dtc       # (B,n,Q,H)
    states = torch.einsum("bcjh,bcjs,bcjhp->bchps", wj, Bc, xc)
    st = (torch.zeros((Bsz, H, P, N), dtype=F32, device=x.device)
          if init_state is None else init_state.to(F32))
    prev = []
    for c in range(n):
        prev.append(st)
        st = torch.exp(seg_end[:, c])[:, :, None, None] * st + states[:, c]
    prev = torch.stack(prev, dim=1)                          # (B,n,H,P,N)
    y = y + torch.einsum("bcis,bchps->bcihp", Cc, prev) \
        * torch.exp(cum)[..., None]

    y = y.reshape(Bsz, n * Q, H, P) + x32 * D.to(F32)[None, None, :, None]
    y = y[:, :S].to(x.dtype)
    return (y, st) if return_state else y


def ssd_recurrent(x, dt, A, Bm, Cm, D, *, init_state=None,
                  return_state: bool = False):
    """Token-by-token SSD, the oracle.

    x: (B,S,H,P); dt: (B,S,H) post-softplus; A: (H,) negative;
    Bm, Cm: (B,S,N); D: (H,). Per step: state = exp(dt A) state +
    dt B (outer) x, y = C . state + D x, in fp32. Returns y (B,S,H,P) in
    x.dtype [, state (B,H,P,N) fp32].
    """
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    st = (torch.zeros((Bsz, H, P, N), dtype=F32, device=x.device)
          if init_state is None else init_state.to(F32))
    A32, D32 = A.to(F32), D.to(F32)
    ys = []
    for t in range(S):
        xt, dtt = x[:, t].to(F32), dt[:, t].to(F32)
        bt, ct = Bm[:, t].to(F32), Cm[:, t].to(F32)
        st = torch.exp(dtt * A32)[:, :, None, None] * st + torch.einsum(
            "bh,bn,bhp->bhpn", dtt, bt, xt)
        ys.append(torch.einsum("bn,bhpn->bhp", ct, st)
                  + xt * D32[None, :, None])
    y = torch.stack(ys, dim=1).to(x.dtype) if S else torch.zeros_like(x)
    return (y, st) if return_state else y
