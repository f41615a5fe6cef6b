"""Transformer layers of the ported families: norms (LayerNorm with or
without an affine, RMSNorm, the per-head RMS qk-norm), RoPE, attention
(full, causal or not, sliding window with an always-visible meta-token
prefix, decode against a full or ring cache), the SwiGLU and GELU MLPs,
tied or untied embedding and unembedding, and granite-4.0-h's muP
multipliers (`embed`, `scale_queries`, `unembed`), each applied only where
the config sets it.

Mirrors the JAX package's `models/layers.py` at the same names and
layouts: activations (B, S, D) or (B, S, H, hd), wq (D, H, hd),
wo (H, hd, D). Parameters are cast to the compute dtype per op (a no-op
when the caller already holds them in it); norms and softmax run in fp32.
Full attention goes through `kernels.ops.attention`: the Hopper kernel
for CUDA tensors, the plain version for CPU tensors. Windowed attention
(blockwise window plus meta prefix) and ring-cache decode are plain
PyTorch, as the JAX package runs them in XLA.

Every spec names the reference's logical axes (`distributed.sharding.
mesh_rules` maps them onto a mesh). Tensor parallelism pads the query
heads per KV group (`padded_heads`) so the head axis divides the model
axis; the padded heads' outputs are zeroed before the output projection
(`_mask_heads`), as in the reference, so they add nothing and receive no
gradient.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

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
    d = cfg.d_model
    if cfg.norm == "rmsnorm":
        return {"scale": Spec((d,), (None,), "ones")}
    if cfg.norm == "layernorm":
        return {"scale": Spec((d,), (None,), "ones"),
                "bias": Spec((d,), (None,), "zeros")}
    if cfg.norm == "nonparam_ln":   # olmo: no learnable affine
        return {}
    raise ValueError(cfg.norm)


def apply_norm(cfg: ModelConfig, params, x, eps: float = 1e-5):
    """RMSNorm, or LayerNorm (population variance, as jnp.var) with an
    affine ("layernorm") or without ("nonparam_ln"), in fp32."""
    xf = x.to(F32)
    if cfg.norm == "rmsnorm":
        ms = xf.pow(2).mean(dim=-1, keepdim=True)
        y = xf * torch.rsqrt(ms + eps) * params["scale"].to(F32)
    else:
        mu = xf.mean(dim=-1, keepdim=True)
        var = xf.var(dim=-1, keepdim=True, correction=0)
        y = (xf - mu) * torch.rsqrt(var + eps)
        if cfg.norm == "layernorm":
            y = y * params["scale"].to(F32) + params["bias"].to(F32)
    return y.to(x.dtype)


def rms_head_norm(x, scale, eps: float = 1e-6):
    """qk-norm: RMS-normalize over head_dim in fp32 (chameleon / qwen3)."""
    xf = x.to(F32)
    ms = xf.pow(2).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps) * scale.to(F32)).to(x.dtype)


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
MAX_HEAD_PAD_RATIO = 1.5


def padded_heads(cfg: ModelConfig, tp: int) -> int:
    """Query-head count padded *per KV group* so the head axis shards
    `tp`-ways while keeping the GQA head -> kv mapping (head i uses kv
    head i // G_pad). cfg.num_heads unchanged when no padding is needed or
    when padding would waste more than MAX_HEAD_PAD_RATIO (the sharding
    policy then replicates heads instead, `mesh_rules`)."""
    H, K = cfg.num_heads, cfg.num_kv_heads
    if tp <= 1 or H % tp == 0:
        return H
    g = H // K
    while (K * g) % tp:
        g += 1
    H_pad = K * g
    return H_pad if H_pad <= MAX_HEAD_PAD_RATIO * H else H


def head_mask(cfg: ModelConfig, H_pad: int, dtype, device=None):
    """(H_pad,) 1/0 mask of real vs padded q heads; None when unpadded."""
    if H_pad == cfg.num_heads:
        return None
    G_pad = H_pad // cfg.num_kv_heads
    G = cfg.num_heads // cfg.num_kv_heads
    return (torch.arange(H_pad, device=device) % G_pad < G).to(dtype)


def _mask_heads(cfg: ModelConfig, o):
    """Zero the padded heads of o (..., H_pad, hd) so they add nothing to
    the output projection and receive no gradient."""
    m = head_mask(cfg, o.shape[-2], o.dtype, o.device)
    return o if m is None else o * m[:, None]


def attention_spec(cfg: ModelConfig, tp: int = 1):
    d, hd = cfg.d_model, cfg.resolved_head_dim
    H, K = padded_heads(cfg, tp), cfg.num_kv_heads
    spec = {
        "wq": Spec((d, H, hd), ("fsdp", "heads", None)),
        "wk": Spec((d, K, hd), ("fsdp", "kv_heads", None)),
        "wv": Spec((d, K, hd), ("fsdp", "kv_heads", None)),
        "wo": Spec((H, hd, d), ("heads", None, "fsdp"),
                   scale=1.0 / math.sqrt(2 * cfg.num_layers)),
    }
    if cfg.qk_norm:
        spec["q_norm"] = Spec((hd,), (None,), "ones")
        spec["k_norm"] = Spec((hd,), (None,), "ones")
    return spec


def _proj(x, w):
    """x (B,S,D) @ w (D, N, hd) -> (B, S, N, hd)."""
    D, N, hd = w.shape
    return (x @ w.to(x.dtype).reshape(D, N * hd)).unflatten(-1, (N, hd))


def uses_rope(cfg: ModelConfig) -> bool:
    """The JAX package's rule: RoPE only in causal non-encoder models
    with a rope_theta; and never where the config says "nope"."""
    return (bool(cfg.rope_theta) and cfg.family != "encoder" and cfg.causal
            and cfg.position_embedding_type != "nope")


def scale_queries(cfg: ModelConfig, q):
    """q scaled so that attention's 1 / sqrt(head_dim) comes to the
    config's `attention_multiplier` (muP: 1 / head_dim); q itself, and no
    op, where the config sets none. At granite's head dim 64 the factor is
    1/8, exact in any dtype."""
    m = cfg.attention_multiplier
    return q * (m * math.sqrt(q.shape[-1])) if m else q


def _qkv(cfg: ModelConfig, p, x, positions):
    """The projections, then qk-norm (where the config has it), then
    RoPE (under `uses_rope`), then the queries' muP scale."""
    q = _proj(x, p["wq"])
    k = _proj(x, p["wk"])
    v = _proj(x, p["wv"])
    if cfg.qk_norm:
        q = rms_head_norm(q, p["q_norm"])
        k = rms_head_norm(k, p["k_norm"])
    if uses_rope(cfg):
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return scale_queries(cfg, q), k, v


def _out_proj(o, wo, dtype):
    """o (B,S,H,hd) @ wo (H, hd, D) -> (B, S, D)."""
    H, hd, D = wo.shape
    return o.to(dtype).flatten(-2) @ wo.to(dtype).reshape(H * hd, D)


def _repeat_kv(k, H: int):
    """(B,T,K,hd) -> (B,T,H,hd), each KV head repeated H // K times."""
    K = k.shape[2]
    return k if K == H else k.repeat_interleave(H // K, dim=2)


def _gqa_scores(q, k):
    """q: (B,S,H,hd), k: (B,T,K,hd) -> scores (B,H,S,T) in fp32. The
    product runs in the promoted dtype of q and k, as jnp.einsum does."""
    dt = torch.promote_types(q.dtype, k.dtype)
    kk = _repeat_kv(k, q.shape[2])
    s = torch.einsum("bshd,bthd->bhst", q.to(dt), kk.to(dt)).to(F32)
    return s / math.sqrt(q.shape[-1])


def _gqa_out(probs, v, out_dtype):
    """probs: (B,H,S,T) fp32; v: (B,T,K,hd) -> (B,S,H,hd). The
    probabilities are rounded to v's dtype first, as in the JAX package."""
    vv = _repeat_kv(v, probs.shape[1])
    return torch.einsum("bhst,bthd->bshd", probs.to(vv.dtype),
                        vv).to(out_dtype)


def attention_full(cfg: ModelConfig, p, x, positions, *, causal: bool,
                   kernel_impl: str = "auto"):
    """Full (possibly causal) attention over the whole sequence.
    x: (B,S,D). Returns (out (B,S,D), (k, v)) with k, v (B,S,K,hd) after
    RoPE, the rows prefill writes into the decode cache."""
    q, k, v = _qkv(cfg, p, x, positions)
    o = _mask_heads(cfg, ops.attention(q, k, v, causal=causal,
                                       impl=kernel_impl))
    return _out_proj(o, p["wo"], x.dtype), (k, v)


def attention_windowed(cfg: ModelConfig, p, x, positions, *, window: int,
                       meta: int):
    """Exact sliding-window causal attention with an always-visible meta
    prefix, computed blockwise in O(S * (2*window + meta)), plain PyTorch.

    Visibility of key j from query i (i >= j): (i - j < window) OR
    (j < meta). The sequence is padded to a multiple of the window; each
    block of `window` queries attends to its own block and the one before,
    and to the meta rows the window does not already cover.
    Returns (out (B,S,D), (k, v)) with k, v (B,S,K,hd).
    """
    B, S, D = x.shape
    w = window
    q, k, v = _qkv(cfg, p, x, positions)
    H, hd = q.shape[2], q.shape[3]
    pad = (-S) % w
    n = (S + pad) // w
    kf, vf = _repeat_kv(k, H), _repeat_kv(v, H)          # flat heads
    if pad:
        q, kf, vf = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (q, kf, vf))
    qc = q.reshape(B, n, w, H, hd)
    kc = kf.reshape(B, n, w, H, hd)
    vc = vf.reshape(B, n, w, H, hd)
    # each block's keys: the previous block (zero for block 0), then its own
    kcat = torch.cat([F.pad(kc[:, :-1], (0, 0, 0, 0, 0, 0, 1, 0)), kc], 2)
    vcat = torch.cat([F.pad(vc[:, :-1], (0, 0, 0, 0, 0, 0, 1, 0)), vc], 2)
    scores = torch.einsum("bnahd,bnchd->bnhac", qc, kcat).to(F32)
    scores = scores / math.sqrt(hd)

    dev = x.device
    a = torch.arange(w, device=dev)
    cidx = torch.arange(2 * w, device=dev)
    ci = torch.arange(n, device=dev)
    rel = a[:, None] + w - cidx[None, :]                  # i - j
    win_ok = (rel >= 0) & (rel < w)                       # (w, 2w)
    key_abs = (ci[:, None] - 1) * w + cidx[None, :]       # (n, 2w)
    valid_key = (key_abs >= 0) & (key_abs < S)
    mask = win_ok[None] & valid_key[:, None, :]           # (n, w, 2w)
    scores = torch.where(mask[None, :, None], scores, NEG_INF)

    if meta > 0:
        # meta keys [0, meta) that the window does not cover: j <= i - w
        km, vm = kf[:, :meta], vf[:, :meta]
        ms = torch.einsum("bnahd,bmhd->bnham", qc, km).to(F32)
        ms = ms / math.sqrt(hd)
        q_abs = ci[:, None] * w + a[None, :]              # (n, w)
        j = torch.arange(meta, device=dev)
        mmask = j[None, None, :] <= (q_abs[..., None] - w)
        ms = torch.where(mmask[None, :, None], ms, NEG_INF)
        scores = torch.cat([ms, scores], dim=-1)
        vcat = torch.cat([vm[:, None].expand(B, n, meta, H, hd), vcat], 2)

    probs = torch.softmax(scores, dim=-1)
    o = torch.einsum("bnhac,bnchd->bnahd", probs.to(vcat.dtype), vcat)
    o = _mask_heads(cfg, o.reshape(B, n * w, H, hd)[:, :S])
    return _out_proj(o, p["wo"], x.dtype), (k, v)


class Lanes(NamedTuple):
    """Where each lane of a per-lane decode lives: `pos` (A,) int64, each
    lane's absolute position; `slots` (A,) int64, each lane's batch row of
    the cache, or None where lane a is row a of a cache of A rows (the
    fleet step's pool-wide layout, global layers only); `lengths` (N,)
    int32 over the cache's N rows, pos + 1 at a lane's row and 0 elsewhere,
    the keys each row of a global layer attends to. Made once per decode
    call (`lanes`, or the pool-wide step's own)."""
    pos: torch.Tensor
    slots: Optional[torch.Tensor]
    lengths: torch.Tensor


def lanes(pos, slots=None, rows: Optional[int] = None) -> Lanes:
    """`Lanes` for lanes at positions `pos` ((A,) int tensor), in cache
    rows `slots` of a cache of `rows` rows (None: rows 0..A-1 of A)."""
    if slots is None:
        slots = torch.arange(pos.shape[0], device=pos.device)
        rows = pos.shape[0]
    lengths = torch.zeros(rows, dtype=torch.int32, device=pos.device)
    lengths[slots] = (pos + 1).to(torch.int32)
    return Lanes(pos, slots, lengths)


def attention_decode(cfg: ModelConfig, p, x, cache, pos, *,
                     window: int, meta: int, kernel_impl: str = "auto"):
    """Single-token decode. x: (B,1,D); pos: absolute position of the new
    token (meta tokens included), an int for the whole batch or a (B,)
    int tensor, one position per lane. cache:
      full   : {"k","v": (B,cap,K,hd)}                  — global layers
      sliding: {"k","v": (B,wcap,K,hd), "mk","mv": (B,meta,K,hd)}

    The new K/V row is written into the cache IN PLACE (the JAX version
    returns an updated copy): at `pos` of a full cache, at slot
    pos % wcap of a ring. With an int `pos`, a full cache then attends
    through the kernel over the prefix [:, :pos+1] with S=1, which is
    exactly the `t <= pos` key mask of the JAX version; with per-lane
    positions through the kernel over the whole cache with each lane's
    own `lengths` (`decode_attend`). A ring attends, in plain PyTorch, to
    the slots whose stored position (the last one <= pos congruent to the
    slot) is a non-meta position inside the window, and to the meta rows.
    Returns (out (B,1,D), cache).
    """
    if torch.is_tensor(pos):
        q, k, v = _qkv(cfg, p, x, pos[:, None])
        o = decode_attend(q, k, v, cache, lanes(pos), window=window,
                          meta=meta, kernel_impl=kernel_impl)
        return _out_proj(_mask_heads(cfg, o), p["wo"], x.dtype), cache
    B = x.shape[0]
    positions = torch.full((B, 1), pos, device=x.device)
    q, k, v = _qkv(cfg, p, x, positions)                 # k,v: (B,1,K,hd)
    ck, cv = cache["k"], cache["v"]
    if window <= 0:
        ck[:, pos] = k[:, 0].to(ck.dtype)
        cv[:, pos] = v[:, 0].to(cv.dtype)
        o = ops.attention(q, ck[:, :pos + 1], cv[:, :pos + 1], causal=True,
                          impl=kernel_impl)
        return _out_proj(_mask_heads(cfg, o), p["wo"], x.dtype), cache

    wcap = ck.shape[1]
    slot = pos % wcap
    ck[:, slot] = k[:, 0].to(ck.dtype)
    cv[:, slot] = v[:, 0].to(cv.dtype)
    t = torch.arange(wcap, device=x.device)
    stored = pos - torch.remainder(pos - t, wcap)
    key_mask = (stored >= meta) & (stored <= pos) & (stored > pos - wcap)
    scores = torch.where(key_mask, _gqa_scores(q, ck), NEG_INF)
    vv = cv
    if meta > 0:
        scores = torch.cat([_gqa_scores(q, cache["mk"]), scores], dim=-1)
        vv = torch.cat([cache["mv"], cv], dim=1)
    o = _gqa_out(torch.softmax(scores, dim=-1), vv, x.dtype)
    o = _mask_heads(cfg, o)
    return _out_proj(o, p["wo"], x.dtype), cache


def decode_attend(q, k, v, cache, ln: Lanes, *, window: int, meta: int,
                  kernel_impl: str = "auto"):
    """The attention of a per-lane decode, after the projections: write
    each lane's new K/V row (q, k, v: (A,1,H|K,hd), RoPE applied) into its
    cache row `ln.slots[a]` (row a where `ln.slots` is None, and then no
    row of q is gathered or scattered) at its own position `ln.pos[a]`
    (slot pos % wcap of a ring), one indexed write per leaf, and attend.

    A global layer makes ONE attention call over the whole cache, each row
    with its own `ln.lengths` (rows that hold no lane see no key and their
    query is 0): the kernel on the card, its plain version on the CPU. A
    ring attends in plain PyTorch, each lane's `stored` positions and key
    mask built from its own position. Returns o (A,1,H,hd) in q.dtype."""
    pos, slots = ln.pos, ln.slots
    ck, cv = cache["k"], cache["v"]
    if window <= 0 and slots is None:
        at = pos.view(-1, 1, 1, 1).expand(-1, 1, *ck.shape[2:])
        ck.scatter_(1, at, k.to(ck.dtype))
        cv.scatter_(1, at, v.to(cv.dtype))
        return ops.attention(q, ck, cv, causal=True, lengths=ln.lengths,
                             impl=kernel_impl)
    if window <= 0:
        ck[slots, pos] = k[:, 0].to(ck.dtype)
        cv[slots, pos] = v[:, 0].to(cv.dtype)
        qq = q.new_zeros((ck.shape[0],) + tuple(q.shape[1:]))
        qq[slots] = q
        return ops.attention(qq, ck, cv, causal=True, lengths=ln.lengths,
                             impl=kernel_impl)[slots]

    wcap = ck.shape[1]
    ck[slots, torch.remainder(pos, wcap)] = k[:, 0].to(ck.dtype)
    cv[slots, torch.remainder(pos, wcap)] = v[:, 0].to(cv.dtype)
    kk, vv = ck[slots], cv[slots]
    t = torch.arange(wcap, device=q.device)[None]
    pp = pos[:, None]
    stored = pp - torch.remainder(pp - t, wcap)            # (A, wcap)
    key_mask = (stored >= meta) & (stored <= pp) & (stored > pp - wcap)
    scores = torch.where(key_mask[:, None, None, :], _gqa_scores(q, kk),
                         NEG_INF)
    if meta > 0:
        scores = torch.cat([_gqa_scores(q, cache["mk"][slots]), scores],
                           dim=-1)
        vv = torch.cat([cache["mv"][slots], vv], dim=1)
    return _gqa_out(torch.softmax(scores, dim=-1), vv, q.dtype)


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------
def mlp_spec(cfg: ModelConfig):
    d, f = cfg.d_model, cfg.d_ff
    down = Spec((f, d), ("mlp", "fsdp"),
                scale=1.0 / math.sqrt(2 * cfg.num_layers))
    if cfg.act == "swiglu":
        return {"w_gate": Spec((d, f), ("fsdp", "mlp")),
                "w_up": Spec((d, f), ("fsdp", "mlp")),
                "w_down": down}
    return {"w_in": Spec((d, f), ("fsdp", "mlp")), "w_down": down}


class _Silu(torch.autograd.Function):
    """`F.silu` whose backward is the formula autograd uses when it
    records the backward (`infinitely_differentiable_silu_backward`):
    torch.func transforms always record it, while `torch.autograd.grad`
    without create_graph would take the fused `silu_backward`, which
    rounds differently. With it the train step's gradients are the same
    bit for bit on either engine (`train.train_step.grad_and_value`)."""

    @staticmethod
    def forward(x):
        return F.silu(x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(inputs[0])

    @staticmethod
    def backward(ctx, grad):
        x, = ctx.saved_tensors
        sig = torch.sigmoid(x)
        return grad * sig * (1.0 + x * (1.0 - sig))


def silu(x):
    """SiLU for every model of the port (`_Silu` where grad mode is on)."""
    return _Silu.apply(x) if torch.is_grad_enabled() else F.silu(x)


def apply_mlp(cfg: ModelConfig, p, x):
    """SwiGLU, or GELU with jax.nn.gelu's default tanh approximation."""
    dt = x.dtype
    if cfg.act == "swiglu":
        h = silu(x @ p["w_gate"].to(dt)) * (x @ p["w_up"].to(dt))
    else:
        h = F.gelu(x @ p["w_in"].to(dt), approximate="tanh")
    return h @ p["w_down"].to(dt)


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------
def padded_vocab(cfg: ModelConfig) -> int:
    return ((cfg.vocab_size + 127) // 128) * 128


def embedding_spec(cfg: ModelConfig):
    """The table (and an untied unembedding). Under an embedding multiplier
    (muP) the table is drawn at 1 / multiplier of the usual scale, so that
    the multiplied rows enter the residual stream at the scale of every
    other family's: with random weights a tied table drawn at the usual
    scale would make each position's own token the greedy answer by ~30
    standard deviations of the other logits (granite-4.0-h-micro)."""
    V = padded_vocab(cfg)
    spec = {"table": Spec((V, cfg.d_model), ("vocab", "fsdp"), "embed",
                          1.0 / cfg.embedding_multiplier)}
    if not cfg.tie_embeddings:
        spec["unembed"] = Spec((cfg.d_model, V), ("fsdp", "vocab"), "embed")
    return spec


def embed_tokens(p, tokens, dtype):
    """The table's rows for `tokens`. `F.embedding` is the same gather as
    indexing, but its backward on the card sums each row's gradients after
    a sort (deterministic), where indexing's `index_put_(accumulate=True)`
    adds them with atomics, whose order is the scheduler's."""
    return F.embedding(tokens, p["table"].to(dtype))


def embed(cfg: ModelConfig, p, tokens, dtype):
    """The model's input rows for `tokens` (`embed_tokens`), times the
    config's `embedding_multiplier` where it sets one: every path's
    embedding (forward, prefill, decode and both fleet ticks)."""
    x = embed_tokens(p, tokens, dtype)
    m = cfg.embedding_multiplier
    return x * m if m != 1.0 else x


def unembed(cfg: ModelConfig, p, x):
    """Logits over the padded vocabulary (the padding masked), divided by
    the config's `logits_scaling` where it sets one."""
    if cfg.tie_embeddings:
        logits = x @ p["table"].to(x.dtype).T
    else:
        logits = x @ p["unembed"].to(x.dtype)
    if cfg.logits_scaling != 1.0:
        logits = logits / cfg.logits_scaling
    V = padded_vocab(cfg)
    if V != cfg.vocab_size:   # mask padded vocab entries
        pad_mask = torch.arange(V, device=x.device) >= cfg.vocab_size
        logits = torch.where(pad_mask, NEG_INF,
                             logits.to(F32)).to(logits.dtype)
    return logits
