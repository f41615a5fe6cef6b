"""Transformer layers of olmo-1b: non-parametric LayerNorm, RoPE,
attention (full and decode-against-cache), the SwiGLU MLP, tied
embedding and unembedding.

Mirrors the JAX package's `models/layers.py` at the same names and
layouts: activations (B, S, D) or (B, S, H, hd), wq (D, H, hd),
wo (H, hd, D). Parameters are cast to the compute dtype per op (a no-op
when the caller already holds them in it); norms and softmax run in fp32.
Attention goes through `kernels.ops.attention`: the Hopper kernel for CUDA
tensors, the plain version for CPU tensors. The other norms, activations,
qk-norm, untied embeddings, sliding windows and meta tokens of the JAX
module arrive with the families that use them (ROADMAP.md, queue 1);
`transformer.check_ported` refuses such configs.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.param import Spec

NEG_INF = -1e30
F32 = torch.float32


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------
def norm_spec(cfg: ModelConfig):
    return {}                       # olmo: no learnable affine


def apply_norm(cfg: ModelConfig, params, x, eps: float = 1e-5):
    """Non-parametric LayerNorm in fp32 (population variance, as jnp.var)."""
    xf = x.to(F32)
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, correction=0)
    return ((xf - mu) * torch.rsqrt(var + eps)).to(x.dtype)


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------
def rope_freqs(head_dim: int, theta: float, device=None):
    exps = torch.arange(0, head_dim, 2, dtype=F32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x, positions, theta: float):
    """x: (..., S, H, hd); positions: broadcastable to (..., S). The two
    halves of hd rotate together (split, not interleaved)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                   # (hd/2,)
    angles = positions[..., :, None].to(F32) * freqs          # (..., S, hd/2)
    cos = torch.cos(angles)[..., None, :]                     # (..., S, 1, hd/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.to(F32).chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------
def attention_spec(cfg: ModelConfig):
    d, hd = cfg.d_model, cfg.resolved_head_dim
    H, K = cfg.num_heads, cfg.num_kv_heads
    return {
        "wq": Spec((d, H, hd)),
        "wk": Spec((d, K, hd)),
        "wv": Spec((d, K, hd)),
        "wo": Spec((H, hd, d), scale=1.0 / math.sqrt(2 * cfg.num_layers)),
    }


def _proj(x, w):
    """x (B,S,D) @ w (D, N, hd) -> (B, S, N, hd)."""
    D, N, hd = w.shape
    return (x @ w.to(x.dtype).reshape(D, N * hd)).unflatten(-1, (N, hd))


def _qkv(cfg: ModelConfig, p, x, positions):
    q = _proj(x, p["wq"])
    k = _proj(x, p["wk"])
    v = _proj(x, p["wv"])
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _out_proj(o, wo, dtype):
    """o (B,S,H,hd) @ wo (H, hd, D) -> (B, S, D)."""
    H, hd, D = wo.shape
    return o.to(dtype).flatten(-2) @ wo.to(dtype).reshape(H * hd, D)


def attention_full(cfg: ModelConfig, p, x, positions, *, causal: bool,
                   attn_impl: str = "auto"):
    """Full (possibly causal) attention over the whole sequence.
    x: (B,S,D). Returns (out (B,S,D), (k, v)) with k, v (B,S,K,hd) after
    RoPE, the rows prefill writes into the decode cache."""
    q, k, v = _qkv(cfg, p, x, positions)
    o = ops.attention(q, k, v, causal=causal, impl=attn_impl)
    return _out_proj(o, p["wo"], x.dtype), (k, v)


def attention_decode(cfg: ModelConfig, p, x, cache, pos: int, *,
                     window: int, meta: int, attn_impl: str = "auto"):
    """Single-token decode. x: (B,1,D); pos: absolute position of the new
    token; cache {"k","v": (B,cap,K,hd)}.

    The new K/V row is written into the cache IN PLACE at `pos` (the JAX
    version returns an updated copy); attention then runs over the cache
    prefix [:, :pos+1] with S=1, which is exactly the `t <= pos` key mask
    of the JAX version. Returns (out (B,1,D), cache).
    """
    if window > 0 or meta > 0:
        raise NotImplementedError(
            "sliding-window / meta-token decode is not ported yet "
            "(ROADMAP.md, queue 1)")
    B = x.shape[0]
    positions = torch.full((B, 1), pos, device=x.device)
    q, k, v = _qkv(cfg, p, x, positions)                 # k,v: (B,1,K,hd)
    ck, cv = cache["k"], cache["v"]
    ck[:, pos] = k[:, 0].to(ck.dtype)
    cv[:, pos] = v[:, 0].to(cv.dtype)
    o = ops.attention(q, ck[:, :pos + 1], cv[:, :pos + 1], causal=True,
                      impl=attn_impl)
    return _out_proj(o, p["wo"], x.dtype), cache


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------
def mlp_spec(cfg: ModelConfig):
    d, f = cfg.d_model, cfg.d_ff
    return {"w_gate": Spec((d, f)),
            "w_up": Spec((d, f)),
            "w_down": Spec((f, d), scale=1.0 / math.sqrt(2 * cfg.num_layers))}


def apply_mlp(cfg: ModelConfig, p, x):
    dt = x.dtype
    h = F.silu(x @ p["w_gate"].to(dt)) * (x @ p["w_up"].to(dt))
    return h @ p["w_down"].to(dt)


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------
def padded_vocab(cfg: ModelConfig) -> int:
    return ((cfg.vocab_size + 127) // 128) * 128


def embedding_spec(cfg: ModelConfig):
    return {"table": Spec((padded_vocab(cfg), cfg.d_model), "embed")}


def embed_tokens(p, tokens, dtype):
    return p["table"].to(dtype)[tokens]


def unembed(cfg: ModelConfig, p, x):
    logits = x @ p["table"].to(x.dtype).T        # tied embeddings
    V = padded_vocab(cfg)
    if V != cfg.vocab_size:   # mask padded vocab entries
        pad_mask = torch.arange(V, device=x.device) >= cfg.vocab_size
        logits = torch.where(pad_mask, NEG_INF,
                             logits.to(F32)).to(logits.dtype)
    return logits
