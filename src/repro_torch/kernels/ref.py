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


def attention_ref(q, k, v, *, causal: bool = True, window: int = 0,
                  lengths=None):
    """Materialized softmax attention with GQA.

    q: (B, S, H, hd); k, v: (B, T, K, hd) with H % K == 0.
    Query i sits at absolute position i + (T - S) in the key space.
    window > 0 limits key visibility to 0 <= qpos - j < window (causal
    sliding window). `lengths` ((B,) ints) masks each lane's keys: lane b
    sees keys j < lengths[b], its query i at position i + lengths[b] - S.
    That is this function over k[b, :lengths[b]], and it is computed so,
    lane by lane, which makes each lane equal to it bit for bit (one
    product over the whole cache would sum in another order). Scores and
    softmax in fp32. Returns (B, S, H, hd) in q.dtype.
    """
    if lengths is not None:
        return torch.cat([
            attention_ref(q[b:b + 1], k[b:b + 1, :n], v[b:b + 1, :n],
                          causal=causal, window=window)
            for b, n in enumerate(lengths.tolist())])
    B, S, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    G = H // K
    kk = k.repeat_interleave(G, dim=2)
    vv = v.repeat_interleave(G, dim=2)
    s = torch.einsum("bshd,bthd->bhst", q.to(F32), kk.to(F32))
    s = s / math.sqrt(hd)
    mask = _visible(S, T, causal, window, q.device)
    s = torch.where(mask[None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhst,bthd->bshd", p, vv.to(F32))
    return o.to(q.dtype)


def _visible(S: int, T: int, causal: bool, window: int, device):
    """(S, T) key visibility of `attention_ref`."""
    i = torch.arange(S, device=device)[:, None]
    j = torch.arange(T, device=device)[None, :]
    mask = torch.ones((S, T), dtype=torch.bool, device=device)
    if causal:
        qpos = i + (T - S)
        mask &= j <= qpos
        if window > 0:
            mask &= (qpos - j) < window
    return mask


def split_attention_partials(q, k, v, *, causal: bool = True,
                             window: int = 0, split: int = 64):
    """The split-KV decode's first pass: for each split of `split` keys
    ([i split, (i + 1) split) of [0, T)), each query row's running max m
    of the scores in log2 units (scale * log2 e folded in; -inf where the
    split holds no visible key), l = sum 2^(x - m) over the split's
    visible keys, and o = sum 2^(x - m) v with the probabilities rounded
    to v's dtype first (as the kernel's bf16 PV product and the JAX
    model's `_gqa_out` round them). Returns part_o (splits, B, S, H, hd)
    and part_ml (splits, B, S, H, 2) = (m, l), fp32."""
    B, S, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    G = H // K
    kk = k.repeat_interleave(G, dim=2).to(F32)
    vv = v.repeat_interleave(G, dim=2)
    x = torch.einsum("bshd,bthd->bsht", q.to(F32), kk)
    x = x * (math.log2(math.e) / math.sqrt(hd))
    x = torch.where(_visible(S, T, causal, window, q.device)[None, :, None],
                    x, -math.inf)
    part_o, part_ml = [], []
    for t0 in range(0, T, split):
        xs = x[..., t0:t0 + split]
        m = xs.amax(dim=-1)
        p = torch.exp2(xs - torch.where(m == -math.inf, 0.0, m)[..., None])
        part_ml.append(torch.stack([m, p.sum(dim=-1)], dim=-1))
        part_o.append(torch.einsum("bsht,bthd->bshd",
                                   p.to(vv.dtype).to(F32),
                                   vv[:, t0:t0 + split].to(F32)))
    return torch.stack(part_o), torch.stack(part_ml)


def combine_splits(part_o, part_ml, dtype):
    """The split-KV decode's combine: o = sum_i o_i 2^(m_i - M) / sum_i
    l_i 2^(m_i - M) with M = max_i m_i; a row whose splits saw no visible
    key (M = -inf) is 0. Returns (B, S, H, hd) in `dtype`."""
    m, l = part_ml[..., 0], part_ml[..., 1]
    M = m.amax(dim=0)
    w = torch.where(M == -math.inf, 0.0, torch.exp2(m - M))
    L = (l * w).sum(dim=0)
    o = (part_o * w[..., None]).sum(dim=0)
    o = torch.where(L[..., None] > 0, o / L[..., None], 0.0)
    return o.to(dtype)


def split_attention_ref(q, k, v, *, causal: bool = True, window: int = 0,
                        split: int = 64):
    """Attention by the split-KV decode's algorithm, in plain PyTorch:
    `split_attention_partials` then `combine_splits`. Equal to
    `attention_ref` except that a row with no visible key is 0 and the
    probabilities are rounded to v's dtype before the PV product."""
    part_o, part_ml = split_attention_partials(q, k, v, causal=causal,
                                               window=window, split=split)
    return combine_splits(part_o, part_ml, q.dtype)


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


def _round_operand(x, how):
    """An fp32 operand as a tensor-core product receives it: unchanged
    (None), rounded once to bf16 ("bf16"), or as two bf16 halves hi =
    bf16(x), lo = bf16(x - hi), each a product of its own ("split")."""
    if how is None:
        return x
    hi = x.to(torch.bfloat16).to(F32)
    if how == "bf16":
        return hi
    if how == "split":
        return hi + (x - hi).to(torch.bfloat16).to(F32)
    raise ValueError(f"unknown rounding {how!r}; use None, 'bf16' or "
                     f"'split'")


SSD_OPERANDS = ("W", "Bw", "state")


def ssd_chunk_parallel(x, dt, A, Bm, Cm, D, *, chunk: int = 64,
                       bf16_operands=None, return_state: bool = False):
    """The chunkwise-parallel SSD of the `ssd_scan` kernel's bf16 path,
    step by step in plain PyTorch: the tests' transcript of the kernel.

    Same function as `ssd_chunked`, computed in the kernel's phases, each
    (batch, head, chunk) on its own except the walk:
      1. gates: cum, the in-chunk inclusive cumsum of dt A (dt = 0 past
         the sequence end), seg_end = cum at the chunk's last step, the
         chunk-end weights w_j = e^{seg_end - cum_j} dt_j;
      2. the intra-chunk output y_intra = W x with W_ij = (C_i . B_j)
         e^{cum_i - cum_j} dt_j (j <= i, masked before the exponential),
         and the chunk's own end state S_c = (B o w)^T x, (P, N) per head;
      3. the walk over the chunks, keeping each chunk's entry state:
         state_c = e^{seg_end_c} state_{c-1} + S_c;
      4. y = y_intra + e^{cum_i} (C_i . state_{c-1}) + D x.
    `bf16_operands` maps the three fp32 operands of the kernel's
    tensor-core products, "W" (of W x), "Bw" (B o w, of S_c) and "state"
    (the entry state, of C . state), to how the kernel feeds them: "bf16"
    (one rounding) or "split" (hi + lo bf16 halves); an operand it does
    not name stays fp32. x, B and C enter exactly (bf16 inputs); sums and
    everything else are fp32. Returns y (B,S,H,P) in x.dtype [, final
    state (B,H,P,N) fp32].
    """
    how = dict(bf16_operands or {})
    if set(how) - set(SSD_OPERANDS):
        raise ValueError(f"unknown operands {sorted(set(how) - set(SSD_OPERANDS))}"
                         f"; the kernel's are {SSD_OPERANDS}")
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    st = torch.zeros((Bsz, H, P, N), dtype=F32, device=x.device)
    if S == 0:
        y = torch.zeros_like(x)
        return (y, st) if return_state else y
    Q = min(chunk, S)
    pad = (-S) % Q
    pd = torch.nn.functional.pad
    xf, dtf, Bf, Cf = x.to(F32), dt.to(F32), Bm.to(F32), Cm.to(F32)
    if pad:
        xf = pd(xf, (0, 0, 0, 0, 0, pad))
        dtf = pd(dtf, (0, 0, 0, pad))
        Bf, Cf = pd(Bf, (0, 0, 0, pad)), pd(Cf, (0, 0, 0, pad))
    n = xf.shape[1] // Q
    xc = xf.reshape(Bsz, n, Q, H, P)
    dtc = dtf.reshape(Bsz, n, Q, H)
    Bc, Cc = Bf.reshape(Bsz, n, Q, N), Cf.reshape(Bsz, n, Q, N)

    # phase 1: gates
    cum = torch.cumsum(dtc * A.to(F32), dim=2)               # (B,n,Q,H)
    seg_end = cum[:, :, -1, :]                               # (B,n,H)
    w = torch.exp(seg_end[:, :, None, :] - cum) * dtc        # (B,n,Q,H)

    # phase 2: intra-chunk output and the chunk's own end state
    li = cum[:, :, :, None, :] - cum[:, :, None, :, :]       # (B,n,Q,Q,H)
    mask = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()
    li = torch.where(mask[None, None, :, :, None], li, NEG_INF)
    CB = torch.einsum("bcis,bcjs->bcij", Cc, Bc)             # (B,n,Q,Q)
    W = CB[..., None] * torch.exp(li) * dtc[:, :, None, :, :]
    y = torch.einsum("bcijh,bcjhp->bcihp", _round_operand(W, how.get("W")),
                     xc)
    Bw = _round_operand(Bc[:, :, :, None, :] * w[..., None], how.get("Bw"))
    local = torch.einsum("bcjhs,bcjhp->bchps", Bw, xc)       # (B,n,H,P,N)

    # phase 3: the walk, keeping each chunk's entry state
    prev = []
    for c in range(n):
        prev.append(st)
        st = torch.exp(seg_end[:, c])[:, :, None, None] * st + local[:, c]
    prev = _round_operand(torch.stack(prev, dim=1), how.get("state"))

    # phase 4: outputs
    y = y + torch.einsum("bcis,bchps->bcihp", Cc, prev) \
        * torch.exp(cum)[..., None]
    y = y + xc * D.to(F32)[None, None, None, :, None]
    y = y.reshape(Bsz, n * Q, H, P)[:, :S].to(x.dtype)
    return (y, st) if return_state else y


# ---------------------------------------------------------------------------
# mLSTM (xLSTM matrix memory): the chunked form and the token-by-token oracle
# ---------------------------------------------------------------------------
def _mlstm_init(B, H, P, device, init_state):
    """(C (B,H,P,P), n (B,H,P), m (B,H)) in fp32: zeros and m = -inf, or
    `init_state` cast to fp32."""
    if init_state is None:
        return (torch.zeros((B, H, P, P), dtype=F32, device=device),
                torch.zeros((B, H, P), dtype=F32, device=device),
                torch.full((B, H), -math.inf, dtype=F32, device=device))
    return tuple(s.to(F32) for s in init_state)


def mlstm_chunked(q, k, v, igate, fgate, *, chunk: int = 64, init_state=None,
                  return_state: bool = False):
    """Chunkwise stabilised mLSTM, the plain version of the `mlstm_scan`
    kernel.

    q, k, v: (B,S,H,P); igate, fgate: (B,S,H) raw preactivations. Chunks
    of Q = min(chunk, S) steps, b = the inclusive cumsum of log sigmoid(f)
    within a chunk; the (C, n, m) state is carried from chunk to chunk
    with the log-max stabiliser m, and
      h_i = (sum_{j<=i} (q_i . k_j) e^{b_i - b_j + i_j - m_i} v_j
             + e^{b_i + m_prev - m_i} C q_i) / max(|n_i . q_i|, e^{-m_i}).
    Steps past the sequence end get i = -1e30 and no decay (log sigmoid
    taken as 0), as the Pallas kernel masks them, so the final state
    equals `mlstm_recurrent`'s at every S. (The JAX package's XLA form
    pads the raw forget gate with 0, i.e. log sigmoid(0) = -0.693 per
    padded step, and decays its final state when S % chunk != 0; this
    version does not copy that.) fp32 math, q scaled by 1/sqrt(P).
    Returns h (B,S,H,P) in q.dtype [, (C (B,H,P,P), n (B,H,P), m (B,H))
    fp32].
    """
    B, S, H, P = q.shape
    C0, n0, m0 = _mlstm_init(B, H, P, q.device, init_state)
    if S == 0:
        h = torch.zeros_like(q)
        return (h, (C0, n0, m0)) if return_state else h
    Q = min(chunk, S)
    pad = (-S) % Q
    pd = torch.nn.functional.pad
    qf = q.to(F32) * (1.0 / math.sqrt(P))
    kf, vf = k.to(F32), v.to(F32)
    ig = igate.to(F32)
    lf = torch.nn.functional.logsigmoid(fgate.to(F32))
    if pad:
        qf, kf, vf = (pd(t, (0, 0, 0, 0, 0, pad)) for t in (qf, kf, vf))
        ig = pd(ig, (0, 0, 0, pad), value=-1e30)        # never written
        lf = pd(lf, (0, 0, 0, pad))                     # no decay
    n_ch = (S + pad) // Q
    qc = qf.reshape(B, n_ch, Q, H, P)
    kc = kf.reshape(B, n_ch, Q, H, P)
    vc = vf.reshape(B, n_ch, Q, H, P)
    ig = ig.reshape(B, n_ch, Q, H)
    b = torch.cumsum(lf.reshape(B, n_ch, Q, H), dim=2)  # inclusive
    b_last = b[:, :, -1, :]                             # (B,n,H)

    # the recurrence over chunks: a_j = i_j + (b_last - b_j) is the log
    # weight of step j toward the chunk end
    a = ig + (b_last[:, :, None, :] - b)                # (B,n,Q,H)
    a_max = a.amax(dim=2)
    C, nv, m = C0, n0, m0
    Cp, np_, mp = [], [], []
    for c in range(n_ch):
        Cp.append(C)
        np_.append(nv)
        mp.append(m)
        m_new = torch.maximum(b_last[:, c] + m, a_max[:, c])     # (B,H)
        w_old = torch.exp(b_last[:, c] + m - m_new)
        w_in = torch.exp(a[:, c] - m_new[:, None, :])            # (B,Q,H)
        C = w_old[:, :, None, None] * C + torch.einsum(
            "bqh,bqhp,bqhr->bhpr", w_in, vc[:, c], kc[:, c])
        nv = w_old[:, :, None] * nv + torch.einsum("bqh,bqhp->bhp", w_in,
                                                   kc[:, c])
        m = m_new
    Cp = torch.stack(Cp, dim=1)                          # (B,n,H,P,P)
    np_ = torch.stack(np_, dim=1)                        # (B,n,H,P)
    mp = torch.stack(mp, dim=1)                          # (B,n,H)

    # intra-chunk weights (masked before the exponential, whose argument
    # is positive above the diagonal) and the inter-chunk term
    d = b[:, :, :, None, :] - b[:, :, None, :, :] + ig[:, :, None, :, :]
    mask = torch.ones((Q, Q), dtype=torch.bool, device=q.device).tril()
    d = torch.where(mask[None, None, :, :, None], d, -math.inf)
    d_inter = b + mp[:, :, None, :]                      # (B,n,Q,H)
    m_loc = torch.clamp(torch.maximum(d.amax(dim=3), d_inter), min=-1e30)
    w_intra = torch.exp(d - m_loc[:, :, :, None, :])     # (B,n,Q,Q,H)
    w_inter = torch.exp(d_inter - m_loc)                 # (B,n,Q,H)
    wqk = torch.einsum("bnihp,bnjhp->bnijh", qc, kc) * w_intra
    h_num = torch.einsum("bnijh,bnjhp->bnihp", wqk, vc) + torch.einsum(
        "bnihr,bnhpr->bnihp", qc, Cp) * w_inter[..., None]
    nq = wqk.sum(dim=3) + torch.einsum("bnihp,bnhp->bnih", qc, np_) * w_inter
    denom = torch.maximum(nq.abs(), torch.exp(-m_loc))
    h = (h_num / denom[..., None]).reshape(B, n_ch * Q, H, P)[:, :S]
    h = h.to(q.dtype)
    return (h, (C, nv, m)) if return_state else h


def mlstm_recurrent(q, k, v, igate, fgate, *, init_state=None,
                    return_state: bool = False):
    """Token-by-token stabilised mLSTM, the oracle (arXiv:2405.04517 eq.
    19-27). q, k, v: (B,S,H,P); igate, fgate: (B,S,H) raw preactivations.
    Per step, in fp32: m' = max(log sigmoid(f) + m, i), C' = e^{log
    sigmoid(f) + m - m'} C + e^{i - m'} v k^T (n likewise with k),
    h = C' q / max(|n' . q|, e^{-m'}), q scaled by 1/sqrt(P). Returns
    h (B,S,H,P) in q.dtype [, (C, n, m) fp32]."""
    B, S, H, P = q.shape
    scale = 1.0 / math.sqrt(P)
    C, n, m = _mlstm_init(B, H, P, q.device, init_state)
    hs = []
    for t in range(S):
        lf = torch.nn.functional.logsigmoid(fgate[:, t].to(F32))
        it = igate[:, t].to(F32)
        m_new = torch.maximum(lf + m, it)
        w_old = torch.exp(lf + m - m_new)
        w_in = torch.exp(it - m_new)
        kt, vt = k[:, t].to(F32), v[:, t].to(F32)
        C = w_old[..., None, None] * C + w_in[..., None, None] * \
            torch.einsum("bhp,bhr->bhpr", vt, kt)
        n = w_old[..., None] * n + w_in[..., None] * kt
        qt = q[:, t].to(F32) * scale
        num = torch.einsum("bhpr,bhr->bhp", C, qt)
        den = torch.maximum(torch.einsum("bhp,bhp->bh", n, qt).abs(),
                            torch.exp(-m_new))
        hs.append(num / den[..., None])
        m = m_new
    h = torch.stack(hs, dim=1).to(q.dtype) if S else torch.zeros_like(q)
    return (h, (C, n, m)) if return_state else h


def mlstm_chunk_parallel(q, k, v, igate, fgate, *, chunk: int = 64,
                         bf16_split: bool = False,
                         return_state: bool = False):
    """The chunkwise-parallel mLSTM of the `mlstm_scan` kernel's bf16 path,
    step by step in plain PyTorch: the tests' transcript of the kernel.

    Same function as `mlstm_chunked`, computed in the kernel's four phases:
      0. gates and stabilisers, per head: b (the in-chunk cumsum of
         log sigmoid(f)), the chunk-end weights a_j = i_j + b_Q - b_j, the
         state stabiliser m_c = max(b_Q + m_{c-1}, max_j a_j) scanned over
         the chunks, and each row's m_i = max(b_i + max_{j<=i}(i_j - b_j),
         b_i + m_{c-1}, -1e30);
      1. per chunk, the masked weights W_ij = (q_i . k_j) e^{b_i - b_j +
         i_j - m_i} (j <= i) and their row sums;
      2. the state, walked over the chunks: C_c = e^{b_Q + m_{c-1} - m_c}
         C_{c-1} + sum_j (e^{a_j - m_c} v_j) k_j^T (n likewise with k),
         keeping each chunk's entry state C_{c-1}, n_{c-1};
      3. per chunk, h_i = (W v + beta_i q_i C_{c-1}^T) / max(|sum_j W_ij +
         beta_i q_i . n_{c-1}|, e^{-m_i}), beta_i = e^{b_i + m_{c-1} - m_i}.
    With `bf16_split` the three weighted operands of the kernel's
    tensor-core products, e^{a_j - m_c} v_j, C_{c-1} and W, become what
    the kernel feeds them as: two bf16 halves hi = bf16(x), lo = bf16(x -
    hi), each a product of its own (hi + lo is exact in fp32). One bf16
    rounding of any of the three moves h by more than the bf16 tolerance
    at xlstm-350m's width, where a small denominator magnifies the
    numerator's error. Everything else is fp32, as in the kernel. Returns
    h (B,S,H,P) in q.dtype [, (C, n, m) fp32].
    """
    B, S, H, P = q.shape
    C, nv, m = _mlstm_init(B, H, P, q.device, None)
    if S == 0:
        h = torch.zeros_like(q)
        return (h, (C, nv, m)) if return_state else h

    def rnd(x):
        if not bf16_split:
            return x
        hi = x.to(torch.bfloat16).to(F32)
        return hi + (x - hi).to(torch.bfloat16).to(F32)

    Q = min(chunk, S)
    pad = (-S) % Q
    pd = torch.nn.functional.pad
    qf, kf, vf = q.to(F32), k.to(F32), v.to(F32)
    ig = igate.to(F32)
    lf = torch.nn.functional.logsigmoid(fgate.to(F32))
    if pad:
        qf, kf, vf = (pd(t, (0, 0, 0, 0, 0, pad)) for t in (qf, kf, vf))
        ig = pd(ig, (0, 0, 0, pad), value=-1e30)
        lf = pd(lf, (0, 0, 0, pad))
    n_ch = (S + pad) // Q
    shape = (B, n_ch, Q, H)
    qc, kc, vc = (t.reshape(*shape, P) for t in (qf, kf, vf))
    ig = ig.reshape(shape)
    b = torch.cumsum(lf.reshape(shape), dim=2)
    b_last = b[:, :, -1, :]
    scale = 1.0 / math.sqrt(P)

    # phase 0: gates and stabilisers
    a = ig + (b_last[:, :, None, :] - b)
    a_max = a.amax(dim=2)
    m_prev, w_in, w_old = [], [], []
    for c in range(n_ch):
        m_new = torch.maximum(b_last[:, c] + m, a_max[:, c])
        m_prev.append(m)
        w_old.append(torch.exp(b_last[:, c] + m - m_new))
        w_in.append(torch.exp(a[:, c] - m_new[:, None, :]))
        m = m_new
    m_prev = torch.stack(m_prev, dim=1)                          # (B,n,H)
    m_row = torch.maximum(b + torch.cummax(ig - b, dim=2).values,
                          b + m_prev[:, :, None, :]).clamp(min=-1e30)
    beta = torch.exp(b + m_prev[:, :, None, :] - m_row)          # (B,n,Q,H)

    # phase 1: masked weights
    d = b[:, :, :, None, :] - b[:, :, None, :, :] + ig[:, :, None, :, :]
    mask = torch.ones((Q, Q), dtype=torch.bool, device=q.device).tril()
    d = torch.where(mask[None, None, :, :, None], d - m_row[:, :, :, None],
                    -math.inf)
    W = torch.einsum("bnihp,bnjhp->bnijh", qc, kc) * scale * torch.exp(d)
    rowsum = W.sum(dim=3)                                        # (B,n,Q,H)

    # phase 2: the state walk, keeping each chunk's entry state
    C_prev, n_prev = [], []
    for c in range(n_ch):
        C_prev.append(C)
        n_prev.append(nv)
        C = w_old[c][:, :, None, None] * C + torch.einsum(
            "bqhp,bqhr->bhpr", rnd(w_in[c][..., None] * vc[:, c]), kc[:, c])
        nv = w_old[c][:, :, None] * nv + torch.einsum(
            "bqh,bqhr->bhr", w_in[c], kc[:, c])
    C_prev = torch.stack(C_prev, dim=1)                          # (B,n,H,P,P)
    n_prev = torch.stack(n_prev, dim=1)                          # (B,n,H,P)

    # phase 3: outputs
    inter = torch.einsum("bnihr,bnhpr->bnihp", qc, rnd(C_prev)) * scale
    qn = torch.einsum("bnihr,bnhr->bnih", qc, n_prev) * scale
    num = torch.einsum("bnijh,bnjhp->bnihp", rnd(W), vc) \
        + beta[..., None] * inter
    den = torch.maximum((rowsum + beta * qn).abs(), torch.exp(-m_row))
    h = (num / den[..., None]).reshape(B, n_ch * Q, H, P)[:, :S]
    h = h.to(q.dtype)
    return (h, (C, nv, m)) if return_state else h
