"""The drift screen's reference in float64 on the host: each stream's
token histogram over `buckets` equal ranges of the vocabulary, and the
Jensen-Shannon divergence of a window's histogram against the stream's
reference histogram (both smoothed by eps and renormalised); a stream
drifts when its divergence exceeds the threshold."""
from __future__ import annotations

import numpy as np


def histogram(tokens: np.ndarray, buckets: int, vocab: int) -> np.ndarray:
    t = np.asarray(tokens, np.int64).reshape(-1)
    idx = np.clip(t * buckets // vocab, 0, buckets - 1)
    h = np.bincount(idx, minlength=buckets).astype(np.float64)
    return h / h.sum()


def js(p: np.ndarray, q: np.ndarray, eps: float = 1e-12) -> float:
    p = (p + eps) / (p + eps).sum()
    q = (q + eps) / (q + eps).sum()
    m = 0.5 * (p + q)
    return float(0.5 * np.sum(p * np.log(p / m))
                 + 0.5 * np.sum(q * np.log(q / m)))


def triggers(window_tokens: dict, reference_tokens: dict, *, buckets: int,
             vocab: int, threshold: float) -> set:
    """Streams whose window drifted from their reference."""
    out = set()
    for sid, toks in window_tokens.items():
        ref = histogram(reference_tokens[sid], buckets, vocab)
        if js(histogram(toks, buckets, vocab), ref) > threshold:
            out.add(sid)
    return out


def pairwise_js(p, q, dtype=None, eps: float = 1e-12):
    """(N, M) Jensen-Shannon divergences between the rows of p (N, B) and
    of q (M, B), each row eps-shifted and renormalised as `js` does, in
    float64 (`dtype` None) or, for the control, in `dtype` throughout."""
    import torch
    dt = torch.float64 if dtype is None else dtype
    p = torch.as_tensor(p).to(torch.float64)
    q = torch.as_tensor(q).to(torch.float64)
    pe = (p + eps) / (p + eps).sum(-1, keepdim=True)
    qe = (q + eps) / (q + eps).sum(-1, keepdim=True)
    pe, qe = pe.to(dt)[:, None, :], qe.to(dt)[None, :, :]
    m = 0.5 * (pe + qe)
    out = 0.5 * ((pe * torch.log(pe / m)).sum(-1)
                 + (qe * torch.log(qe / m)).sum(-1))
    return out.to(torch.float64)
