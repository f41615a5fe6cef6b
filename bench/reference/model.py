"""Plain float32 forwards of the benchmark's two model families, written
from the published descriptions and the configuration files alone:

* dense (OLMo): token embedding, then per layer a non-parametric (or RMS)
  norm, multi-head causal attention with rotary embeddings (the two halves
  of each head rotate together), a residual add, a norm, a SwiGLU MLP and
  a residual add; a final norm and the tied unembedding.
* hybrid (Hymba): learned meta tokens prepended to every sequence; per
  layer attention and a Mamba-2 head group run side by side on the same
  normed input, each output RMS-normed and scaled, their mean added to the
  residual; attention is causal over all keys in the global layers and
  over a sliding window plus the meta tokens in the others; the SSD scan
  is computed in its quadratic (attention-like) form in float32 with the
  cumulative decays summed in float64.

Weights come as a tree of tensors (keys and shapes as the benchmark made
them). `quant` (None for the reference itself) is applied to both
operands of every weight product: the control that puts a lower-precision
path in the program's place. Nothing here imports the program.
"""
from __future__ import annotations

import math
from typing import Callable, Optional

import torch
import torch.nn.functional as F

F32 = torch.float32
Quant = Optional[Callable[[torch.Tensor], torch.Tensor]]


def fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded through float8 e4m3 with one scale per tensor (its
    largest magnitude at e4m3's largest value, 448), back in float32."""
    s = x.abs().amax().clamp(min=1e-30) / 448.0
    return (x / s).to(torch.float8_e4m3fn).to(F32) * s


def bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(F32)


def _mm(x, w, quant: Quant):
    if quant is not None:
        x, w = quant(x), quant(w)
    return x @ w


def _norm(cfg, p, x, eps=1e-5):
    if cfg["norm"] == "rmsnorm":
        return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) \
            * p["scale"]
    mu = x.mean(-1, keepdim=True)
    var = (x - mu).pow(2).mean(-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    if cfg["norm"] == "layernorm":
        y = y * p["scale"] + p["bias"]
    return y


def _rms(x, eps=1e-6):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps)


def _rope(x, pos, theta):
    """x (B, S, H, hd), pos (S,): rotate the two halves of hd together."""
    hd = x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=F32,
                                       device=x.device) / hd)
    ang = pos[:, None].to(F32) * inv                       # (S, hd/2)
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    a, b = x[..., :hd // 2], x[..., hd // 2:]
    return torch.cat([a * cos - b * sin, a * sin + b * cos], dim=-1)


def _visible(S: int, window: int, meta: int, device):
    """(S, S) bool: key j seen from query i."""
    i = torch.arange(S, device=device)[:, None]
    j = torch.arange(S, device=device)[None, :]
    ok = j <= i
    if window:
        ok = ok & ((i - j < window) | (j < meta))
    return ok


def _attention(cfg, p, h, pos, window, meta, quant: Quant):
    B, S, d = h.shape
    H, K = cfg["num_heads"], cfg["num_kv_heads"]
    hd = cfg.get("head_dim") or d // H
    q = _mm(h, p["wq"].reshape(d, H * hd), quant).view(B, S, H, hd)
    k = _mm(h, p["wk"].reshape(d, K * hd), quant).view(B, S, K, hd)
    v = _mm(h, p["wv"].reshape(d, K * hd), quant).view(B, S, K, hd)
    if cfg.get("rope_theta"):
        q = _rope(q, pos, cfg["rope_theta"])
        k = _rope(k, pos, cfg["rope_theta"])
    k = k.repeat_interleave(H // K, dim=2)
    v = v.repeat_interleave(H // K, dim=2)
    s = torch.einsum("bshd,bthd->bhst", q, k) / math.sqrt(hd)
    s = s.masked_fill(~_visible(S, window, meta, h.device), -math.inf)
    o = torch.einsum("bhst,bthd->bshd", torch.softmax(s, dim=-1), v)
    return _mm(o.reshape(B, S, H * hd), p["wo"].reshape(H * hd, d), quant)


def _ssd(x, dt, A, Bm, Cm, D):
    """y_t = sum_{s<=t} (C_t . B_s) exp(sum_{r=s+1..t} dt_r A) dt_s x_s
    + D x_t per head, one sequence: x (S, H, P), dt (S, H), Bm, Cm
    (S, N)."""
    S = x.shape[0]
    cum = torch.cumsum(dt.double() * A.double(), dim=0)     # (S, H)
    seg = (cum[:, None, :] - cum[None, :, :]).permute(2, 0, 1)  # (H, t, s)
    causal = torch.ones(S, S, dtype=torch.bool, device=x.device).tril()
    decay = torch.exp(seg.masked_fill(~causal, -math.inf)).to(F32)
    w = decay * (Cm @ Bm.T)[None] * dt.T[:, None, :]        # (H, t, s)
    return torch.einsum("hts,shp->thp", w, x) + x * D[None, :, None]


def _mamba(cfg, p, h, quant: Quant):
    B, S, d = h.shape
    di = cfg["ssm"]["expand"] * d
    Hs = max(1, di // 64)
    P, N = di // Hs, cfg["ssm"]["state_dim"]
    xz = _mm(h, p["w_in"], quant)
    xin, z = xz[..., :di], xz[..., di:]
    W = p["conv"].shape[0]
    xp = F.pad(xin, (0, 0, W - 1, 0))
    u = F.silu(sum(xp[:, i:i + S] * p["conv"][i] for i in range(W)))
    bc = _mm(u, p["w_bc"], quant)
    dt = F.softplus(_mm(u, p["w_dt"], quant) + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    y = torch.stack([_ssd(u[b].view(S, Hs, P), dt[b], A, bc[b, :, :N],
                          bc[b, :, N:], p["D"]) for b in range(B)])
    y = _rms(y.reshape(B, S, di)) * p["out_norm"]
    return _mm(y * F.silu(z), p["w_out"], quant)


def _mlp(p, x, quant: Quant):
    g = _mm(x, p["w_gate"], quant)
    u = _mm(x, p["w_up"], quant)
    return _mm(F.silu(g) * u, p["w_down"], quant)


def _layers(cfg):
    """Per layer: (segment index, index in the segment, window)."""
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


def _pick(tree, i):
    if isinstance(tree, dict):
        return {k: _pick(v, i) for k, v in tree.items()}
    return tree[i].to(F32)


def hidden(cfg, params, tokens: torch.Tensor, quant: Quant = None):
    """The final-normed hidden states (B, S, d) of token ids (B, S), meta
    positions dropped."""
    meta = cfg.get("meta_tokens", 0)
    x = params["embed"]["table"][tokens].to(F32)
    if meta:
        m = params["meta"].to(F32)
        x = torch.cat([m.expand(x.shape[0], *m.shape), x], dim=1)
    S = x.shape[1]
    pos = torch.arange(S, device=x.device)
    hybrid = cfg["family"] == "hybrid"
    for seg, i, w in _layers(cfg):
        p = _pick(params["segments"][seg], i)
        h = _norm(cfg, p.get("ln1", {}), x)
        a = _attention(cfg, p["attn"], h, pos, w, meta, quant)
        if hybrid:
            s = _mamba(cfg, p["mamba"], h, quant)
            x = x + 0.5 * (_rms(a) * p["mix_a"] + _rms(s) * p["mix_s"])
        else:
            x = x + a
        x = x + _mlp(p["mlp"], _norm(cfg, p.get("ln2", {}), x), quant)
    return _norm(cfg, {k: v.to(F32) for k, v in
                       params.get("final_norm", {}).items()}, x)[:, meta:]


def logits(cfg, params, h: torch.Tensor, quant: Quant = None):
    """Logits over the vocabulary (padded rows left out) of hidden states
    h (..., d): the tied table, or the untied unembedding."""
    V = cfg["vocab_size"]
    emb = params["embed"]
    if "unembed" in emb:
        return _mm(h, emb["unembed"][:, :V].to(F32), quant)
    return _mm(h, emb["table"][:V].to(F32).T, quant)
