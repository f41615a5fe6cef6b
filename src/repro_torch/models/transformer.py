"""Model assembly for the dense family: layer plan, spec trees, forward /
prefill / decode.

Mirrors the JAX package's `models/transformer.py`. A model is a sequence
of segments, runs of homogeneous layers whose parameters are stacked on a
leading layer axis (`params["segments"][i]`, as in the JAX tree); the JAX
`lax.scan` over a segment's layers is a Python loop here. What olmo-1b
does not use (other families, norms, activations, qk-norm, untied
embeddings, sliding windows, meta tokens) arrives with the slices that
need it (ROADMAP.md, queue 1).
"""
from __future__ import annotations

from typing import List

import torch

from repro_torch.configs.base import DENSE, ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.param import Spec, tree_map


def check_ported(cfg: ModelConfig):
    """Raise NotImplementedError for a config that uses anything the port
    does not have yet."""
    missing = [what for what, absent in [
        (f"family {cfg.family!r}", cfg.family != DENSE),
        (f"norm {cfg.norm!r}", cfg.norm != "nonparam_ln"),
        (f"activation {cfg.act!r}", cfg.act != "swiglu"),
        ("untied embeddings", not cfg.tie_embeddings),
        ("qk-norm", cfg.qk_norm),
        ("non-causal attention", not cfg.causal),
        ("an embedding frontend", cfg.embedding_frontend),
        ("sliding-window attention", cfg.sliding_window),
        ("meta tokens", cfg.meta_tokens),
    ] if absent]
    if missing:
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(missing)} not ported yet "
            f"(ROADMAP.md, queue 1)")


def layer_plan(cfg: ModelConfig) -> List[int]:
    """Layer count of each segment. The JAX version groups consecutive
    layers by attention window; with full attention everywhere (the only
    pattern ported) that is one segment of all layers."""
    check_ported(cfg)
    return [cfg.num_layers]


# ---------------------------------------------------------------------------
# Specs
# ---------------------------------------------------------------------------
def _stack_spec(spec_tree, count: int):
    return tree_map(lambda s: Spec((count,) + s.shape, s.init, s.scale),
                    spec_tree)


def _block_spec(cfg: ModelConfig):
    return {
        "ln1": L.norm_spec(cfg),
        "attn": L.attention_spec(cfg),
        "ln2": L.norm_spec(cfg),
        "mlp": L.mlp_spec(cfg),
    }


def build_spec(cfg: ModelConfig):
    """Full parameter spec tree of a dense architecture."""
    spec = {"embed": L.embedding_spec(cfg),
            "final_norm": L.norm_spec(cfg)}
    spec["segments"] = [_stack_spec(_block_spec(cfg), n)
                        for n in layer_plan(cfg)]
    return spec


def cache_spec(cfg: ModelConfig, batch: int, cap: int):
    """Spec tree of the decode cache at static capacity `cap`: per segment
    k, v of shape (layers, batch, cap, K, hd)."""
    K, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    segs = []
    for n in layer_plan(cfg):
        shape = (n, batch, cap, K, hd)
        segs.append({"k": Spec(shape, "zeros"), "v": Spec(shape, "zeros")})
    return {"segments": segs}


# ---------------------------------------------------------------------------
# Block forward / decode
# ---------------------------------------------------------------------------
def _layer(segp, i: int):
    """Parameters of layer `i` of a stacked segment (views, no copy)."""
    return tree_map(lambda t: t[i], segp)


def _block_forward(cfg: ModelConfig, p, x, positions, *, attn_impl: str):
    h = L.apply_norm(cfg, p["ln1"], x)
    attn_out, kv = L.attention_full(cfg, p["attn"], h, positions,
                                    causal=True, attn_impl=attn_impl)
    x = x + attn_out
    h2 = L.apply_norm(cfg, p["ln2"], x)
    return x + L.apply_mlp(cfg, p["mlp"], h2), kv


def _block_decode(cfg: ModelConfig, p, x, cache, pos: int, *,
                  attn_impl: str):
    h = L.apply_norm(cfg, p["ln1"], x)
    attn_out, _ = L.attention_decode(cfg, p["attn"], h, cache, pos,
                                     window=0, meta=0, attn_impl=attn_impl)
    x = x + attn_out
    h2 = L.apply_norm(cfg, p["ln2"], x)
    return x + L.apply_mlp(cfg, p["mlp"], h2)


# ---------------------------------------------------------------------------
# Public model functions
# ---------------------------------------------------------------------------
def forward(cfg: ModelConfig, params, inputs, *,
            compute_dtype=torch.bfloat16, collect_cache: bool = False,
            attn_impl: str = "auto"):
    """Full-sequence forward. inputs: int tokens (B,S).
    Returns (logits (B,S,V), aux, caches|None); aux is 0 for the dense
    family, caches a list per segment of {"k","v": (n,B,S,K,hd)}."""
    x = L.embed_tokens(params["embed"], inputs, compute_dtype)
    B, S = inputs.shape
    positions = torch.arange(S, device=x.device).expand(B, S)
    caches = []
    for n, segp in zip(layer_plan(cfg), params["segments"]):
        ks, vs = [], []
        for i in range(n):
            x, (k, v) = _block_forward(cfg, _layer(segp, i), x, positions,
                                       attn_impl=attn_impl)
            if collect_cache:
                ks.append(k)
                vs.append(v)
        if collect_cache:
            caches.append({"k": torch.stack(ks), "v": torch.stack(vs)})
    x = L.apply_norm(cfg, params["final_norm"], x)
    logits = L.unembed(cfg, params["embed"], x)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return logits, aux, (caches if collect_cache else None)


def prefill(cfg: ModelConfig, params, inputs, cap: int, *,
            compute_dtype=torch.bfloat16, cache_dtype=torch.bfloat16,
            attn_impl: str = "auto"):
    """Run the full prompt and build a decode cache of static capacity
    `cap`. Returns (last_logits (B,V), cache_tree, next_pos)."""
    logits, _, kv_caches = forward(cfg, params, inputs,
                                   compute_dtype=compute_dtype,
                                   collect_cache=True, attn_impl=attn_impl)
    S = inputs.shape[1]
    n = min(S, cap)
    segs = []
    for kv in kv_caches:
        c = {}
        for name in ("k", "v"):
            full = kv[name]                       # (n_layers, B, S, K, hd)
            buf = torch.zeros(full.shape[:2] + (cap,) + full.shape[3:],
                              dtype=cache_dtype, device=full.device)
            buf[:, :, :n] = full[:, :, :n]
            c[name] = buf
        segs.append(c)
    return logits[:, -1], {"segments": segs}, S


def decode_step(cfg: ModelConfig, params, token, cache, pos: int, *,
                compute_dtype=torch.bfloat16, attn_impl: str = "auto"):
    """One-token decode. token: (B,1) int; pos: absolute position of the
    token. The cache is updated in place. Returns (logits (B,1,V), cache).
    """
    x = L.embed_tokens(params["embed"], token, compute_dtype)
    for n, segp, segc in zip(layer_plan(cfg), params["segments"],
                             cache["segments"]):
        for i in range(n):
            x = _block_decode(cfg, _layer(segp, i), x,
                              {"k": segc["k"][i], "v": segc["v"][i]}, pos,
                              attn_impl=attn_impl)
    x = L.apply_norm(cfg, params["final_norm"], x)
    logits = L.unembed(cfg, params["embed"], x)
    return logits, cache
