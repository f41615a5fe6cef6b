"""The yardstick's arithmetic, frozen here so that no later change to the
program moves it: the card's published peaks, a kernel's bound, the
operations and bytes of an attention or SSD call, and the model FLOPs of a
forward. The formulas are those of the repository's `chip_smoke.py`
(`peaks`, `_bound`, `time_attention`'s and `ssd_cost`'s counts), copied;
nothing here calls the program.
"""
from __future__ import annotations

import math
from typing import Optional

# data-sheet peaks (dense, at the full power limit): bytes/s of device
# memory, FLOP/s of bf16 tensor cores and of fp32 outside them; matched
# against the card's name, most specific first
PEAKS = (  # (name fragment, bytes/s, bf16 FLOP/s, fp32 FLOP/s)
    ("H200", 4.8e12, 989e12, 67e12),
    ("H100 NVL", 3.9e12, 835e12, 60e12),
    ("H100 PCIe", 2.0e12, 756e12, 51e12),
    ("H100", 3.35e12, 989e12, 67e12),          # SXM
)


def peaks(card: str) -> dict:
    """{"bytes": B/s, "bf16": FLOP/s, "fp32": FLOP/s} of the named card."""
    for frag, bw, bf16, fp32 in PEAKS:
        if frag in card:
            return {"bytes": bw, "bf16": bf16, "fp32": fp32}
    raise RuntimeError(f"no data-sheet peaks for card {card!r}")


def bound_s(nbytes: float, flops: float, flops_peak: float,
            bytes_peak: float) -> float:
    """The least time the card could take: the larger of bytes over
    bandwidth and operations over the peak of the units doing them."""
    return max(nbytes / bytes_peak, flops / flops_peak)


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
        nbytes = 2 * B * S * H * hd * q_bytes + 4 * B + 2 * keys * K * hd * kv_bytes
        return nbytes, 4 * H * hd * keys
    if causal:
        pairs = S * (T - S) + S * (S + 1) // 2
    else:
        pairs = S * T
    nbytes = 2 * B * S * H * hd * q_bytes + 2 * B * T * K * hd * kv_bytes
    return nbytes, 4 * B * H * hd * pairs


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


def matmul_params(cfg: dict) -> int:
    """Weights that a token multiplies through in one forward: every
    projection of every layer and the unembedding over the padded
    vocabulary (the program computes logits over all of it)."""
    d, L = cfg["d_model"], cfg["num_layers"]
    H, K = cfg["num_heads"], cfg["num_kv_heads"]
    hd = cfg.get("head_dim") or d // H
    per = d * (H + 2 * K) * hd + H * hd * d
    mult = 3 if cfg["act"] == "swiglu" else 2
    per += mult * d * cfg["d_ff"]
    if cfg.get("ssm"):
        di = cfg["ssm"]["expand"] * d
        heads = max(1, di // 64)
        per += d * 2 * di + di * 2 * cfg["ssm"]["state_dim"] + di * heads + di * d
    return L * per + d * padded_vocab(cfg["vocab_size"])


def padded_vocab(v: int) -> int:
    return ((v + 127) // 128) * 128


def attention_layers(cfg: dict):
    """(global layers, windowed layers) of a config."""
    L = cfg["num_layers"]
    if not cfg.get("sliding_window"):
        return L, 0
    g = len([i for i in cfg.get("global_attn_layers", ()) if i < L])
    return g, L - g


def window_pairs(S: int, window: int, meta: int) -> int:
    """Visible (query, key) pairs of causal attention over S positions in
    which key j is seen from query i when i - j < window or j < meta."""
    total = 0
    for i in range(S):
        seen = min(i + 1, window)
        extra = max(0, min(meta, i + 1 - window))
        total += seen + extra
    return total


def forward_flops(cfg: dict, batch: int, seq: int,
                  logit_rows: Optional[int] = None) -> float:
    """Model FLOPs of a forward of `batch` sequences of `seq` tokens from
    position 0 (meta tokens added where the config has them): the matmul
    weights, causal attention (windowed where the config says) and, for
    the hybrid, the SSD scan's operations. The unembedding counts at
    `logit_rows` positions a sequence: every prompt position by default
    (an eval or a train step needs them all), 1 for a prefill, whose
    answer needs only the last position's logits."""
    meta = cfg.get("meta_tokens", 0)
    S = seq + meta
    d, H = cfg["d_model"], cfg["num_heads"]
    hd = cfg.get("head_dim") or d // H
    rows = seq if logit_rows is None else logit_rows
    flops = 2.0 * batch * S * (matmul_params(cfg)
                               - d * padded_vocab(cfg["vocab_size"]))
    flops += 2.0 * batch * rows * d * padded_vocab(cfg["vocab_size"])
    g, w = attention_layers(cfg)
    flops += g * 4.0 * batch * H * hd * (S * (S + 1) // 2)
    if w:
        flops += w * 4.0 * batch * H * hd * window_pairs(
            S, cfg["sliding_window"], meta)
    if cfg.get("ssm"):
        di = cfg["ssm"]["expand"] * d
        heads = max(1, di // 64)
        flops += cfg["num_layers"] * ssd_cost(
            batch, S, heads, di // heads, cfg["ssm"]["state_dim"], 64)[1]
    return flops


def decode_flops(cfg: dict, positions) -> float:
    """Model FLOPs of one decode step of lanes at absolute `positions`
    (meta included): the matmul weights per lane and attention over each
    lane's visible keys."""
    d, H = cfg["d_model"], cfg["num_heads"]
    hd = cfg.get("head_dim") or d // H
    meta = cfg.get("meta_tokens", 0)
    g, w = attention_layers(cfg)
    flops = 2.0 * len(positions) * matmul_params(cfg)
    for p in positions:
        flops += g * 4.0 * H * hd * (p + 1)
        if w:
            win = cfg["sliding_window"]
            flops += w * 4.0 * H * hd * (min(p + 1, win)
                                         + max(0, min(meta, p + 1 - win)))
    return flops


def percentile(values, q: float) -> float:
    """The q-th percentile (0..100) by linear interpolation between the
    closest ranks, as numpy's default; inf where the rank falls on an
    inf (a missing answer)."""
    xs = sorted(values)
    if not xs:
        return math.nan
    k = (len(xs) - 1) * q / 100.0
    lo, hi = math.floor(k), math.ceil(k)
    if math.isinf(xs[hi]):
        return math.inf
    return xs[lo] + (xs[hi] - xs[lo]) * (k - lo)
