"""What the reference's model families share (`families/<name>.py`): the
lower-precision roundings of the control, a weight product, the norms,
rotary embeddings, causal (optionally windowed) multi-head attention, the
SwiGLU MLP, the layer walk over the weight tree's segments, and the
unembedding. Plain float32 PyTorch; nothing here imports the program.
"""
from __future__ import annotations

import math
from typing import Callable, Optional

import torch

F32 = torch.float32
Quant = Optional[Callable[[torch.Tensor], torch.Tensor]]


def fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded through float8 e4m3 with one scale per tensor (its
    largest magnitude at e4m3's largest value, 448), back in float32."""
    s = x.abs().amax().clamp(min=1e-30) / 448.0
    return (x / s).to(torch.float8_e4m3fn).to(F32) * s


def bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(F32)


def mm(x, w, quant: Quant):
    """x @ w, both operands through `quant` where it is given."""
    if quant is not None:
        x, w = quant(x), quant(w)
    return x @ w


def norm(cfg, p, x, eps=1e-5):
    """The configuration's norm: RMS, or LayerNorm with (`layernorm`) or
    without (`nonparam_ln`) its scale and bias."""
    if cfg["norm"] == "rmsnorm":
        return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) \
            * p["scale"]
    mu = x.mean(-1, keepdim=True)
    var = (x - mu).pow(2).mean(-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    if cfg["norm"] == "layernorm":
        y = y * p["scale"] + p["bias"]
    return y


def rms(x, eps=1e-6):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps)


def rope(x, pos, theta):
    """x (B, S, H, hd), pos (S,): rotate the two halves of hd together."""
    hd = x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=F32,
                                       device=x.device) / hd)
    ang = pos[:, None].to(F32) * inv                       # (S, hd/2)
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    a, b = x[..., :hd // 2], x[..., hd // 2:]
    return torch.cat([a * cos - b * sin, a * sin + b * cos], dim=-1)


def visible(S: int, window: int, meta: int, device):
    """(S, S) bool: key j seen from query i."""
    i = torch.arange(S, device=device)[:, None]
    j = torch.arange(S, device=device)[None, :]
    ok = j <= i
    if window:
        ok = ok & ((i - j < window) | (j < meta))
    return ok


def attention(cfg, p, h, pos, window, meta, quant: Quant):
    """Causal grouped-query attention of normed h (B, S, d), rotary where
    the configuration has `rope_theta`, over a sliding `window` (0: every
    key) that the first `meta` positions stay visible past."""
    B, S, d = h.shape
    H, K = cfg["num_heads"], cfg["num_kv_heads"]
    hd = cfg.get("head_dim") or d // H
    q = mm(h, p["wq"].reshape(d, H * hd), quant).view(B, S, H, hd)
    k = mm(h, p["wk"].reshape(d, K * hd), quant).view(B, S, K, hd)
    v = mm(h, p["wv"].reshape(d, K * hd), quant).view(B, S, K, hd)
    if cfg.get("rope_theta"):
        q = rope(q, pos, cfg["rope_theta"])
        k = rope(k, pos, cfg["rope_theta"])
    k = k.repeat_interleave(H // K, dim=2)
    v = v.repeat_interleave(H // K, dim=2)
    s = torch.einsum("bshd,bthd->bhst", q, k) / math.sqrt(hd)
    s = s.masked_fill(~visible(S, window, meta, h.device), -math.inf)
    o = torch.einsum("bhst,bthd->bshd", torch.softmax(s, dim=-1), v)
    return mm(o.reshape(B, S, H * hd), p["wo"].reshape(H * hd, d), quant)


def mlp(p, x, quant: Quant):
    """SwiGLU."""
    g = mm(x, p["w_gate"], quant)
    u = mm(x, p["w_up"], quant)
    return mm(torch.nn.functional.silu(g) * u, p["w_down"], quant)


def layers(cfg):
    """Per layer: (segment index, index in the segment, window). The
    weight tree stacks a run of layers with one window as a segment."""
    out, seg, i = [], 0, 0
    L = cfg["num_layers"]
    win = cfg.get("sliding_window", 0)
    glob = set(cfg.get("global_attn_layers", ()))
    prev = None
    for layer in range(L):
        w = win if win and layer not in glob else 0
        if prev is not None and w != prev:
            seg, i = seg + 1, 0
        out.append((seg, i, w))
        i += 1
        prev = w
    return out


def pick(tree, i):
    """Layer i of a segment's stacked weights, in float32."""
    if isinstance(tree, dict):
        return {k: pick(v, i) for k, v in tree.items()}
    return tree[i].to(F32)


def final_norm(cfg, params, x):
    return norm(cfg, {k: v.to(F32) for k, v in
                      params.get("final_norm", {}).items()}, x)


def logits(cfg, params, h: torch.Tensor, quant: Quant = None):
    """Logits over the vocabulary (padded rows left out) of hidden states
    h (..., d): the tied table, or the untied unembedding."""
    V = cfg["vocab_size"]
    emb = params["embed"]
    if "unembed" in emb:
        return mm(h, emb["unembed"][:, :V].to(F32), quant)
    return mm(h, emb["table"][:V].to(F32).T, quant)


# -- operation counts: the model FLOPs that `bench.core.yardstick` asks a
# family for, in the formulas of the repository's `chip_smoke.py`, copied

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


def decoder_params(cfg: dict, mixer: int = 0) -> int:
    """Weights that a token multiplies through in one forward of a decoder
    whose every layer has attention and an MLP, and `mixer` more weights a
    layer: every projection and the unembedding over the padded
    vocabulary (the program computes logits over all of it)."""
    d, L = cfg["d_model"], cfg["num_layers"]
    H, K = cfg["num_heads"], cfg["num_kv_heads"]
    hd = cfg.get("head_dim") or d // H
    per = d * (H + 2 * K) * hd + H * hd * d
    mult = 3 if cfg["act"] == "swiglu" else 2
    per += mult * d * cfg["d_ff"] + mixer
    return L * per + d * padded_vocab(cfg["vocab_size"])


def decoder_forward_flops(cfg: dict, params: int, batch: int, seq: int,
                          logit_rows: Optional[int]) -> float:
    """Model FLOPs of a forward of `batch` sequences of `seq` tokens from
    position 0 (meta tokens added where the config has them) through
    `params` matmul weights (`decoder_params`) and causal attention in
    every layer (windowed where the config says). The unembedding counts
    at `logit_rows` positions a sequence: every prompt position by default
    (an eval or a train step needs them all), 1 for a prefill, whose
    answer needs only the last position's logits."""
    meta = cfg.get("meta_tokens", 0)
    S = seq + meta
    d, H = cfg["d_model"], cfg["num_heads"]
    hd = cfg.get("head_dim") or d // H
    rows = seq if logit_rows is None else logit_rows
    flops = 2.0 * batch * S * (params - d * padded_vocab(cfg["vocab_size"]))
    flops += 2.0 * batch * rows * d * padded_vocab(cfg["vocab_size"])
    g, w = attention_layers(cfg)
    flops += g * 4.0 * batch * H * hd * (S * (S + 1) // 2)
    if w:
        flops += w * 4.0 * batch * H * hd * window_pairs(
            S, cfg["sliding_window"], meta)
    return flops


def decoder_decode_flops(cfg: dict, params: int, positions) -> float:
    """Model FLOPs of one decode step of lanes at absolute `positions`
    (meta included) through `params` matmul weights and attention over
    each lane's visible keys in every layer."""
    d, H = cfg["d_model"], cfg["num_heads"]
    hd = cfg.get("head_dim") or d // H
    meta = cfg.get("meta_tokens", 0)
    g, w = attention_layers(cfg)
    flops = 2.0 * len(positions) * params
    for p in positions:
        flops += g * 4.0 * H * hd * (p + 1)
        if w:
            win = cfg["sliding_window"]
            flops += w * 4.0 * H * hd * (min(p + 1, win)
                                         + max(0, min(meta, p + 1 - win)))
    return flops
