"""Model assembly for every family of the registry (dense, MoE, hybrid,
xLSTM, encoder, VLM): layer plan, spec trees, forward / prefill / decode.

Mirrors the JAX package's `models/transformer.py`. A model is a sequence
of segments whose parameters are stacked on a leading layer axis
(`params["segments"][i]`, as in the JAX tree); the JAX `lax.scan` over a
segment's layers is a Python loop here. For the attention families a
segment is a run of consecutive blocks with the same attention window; a
hybrid (hymba) block runs attention and Mamba heads side by side on the
same normed input and mixes their RMS-normed outputs, and meta tokens are
prepended to every sequence. The xLSTM family alternates mLSTM and sLSTM
blocks (`models/xlstm.py`), one segment per run of each kind; its prefill
builds the recurrent decode cache (`_prefill_recurrent`) and its decode
ignores the position. A MoE block replaces the MLP with `models/moe.py`'s
dense dispatch and sums its load-balance loss over the layers into `aux`;
an encoder (hubert) attends without a causal mask and without RoPE and,
like any config with `embedding_frontend`, takes float frame embeddings
(B, S, d_model) for tokens. The mamba_hybrid family (granite-4.0-h) makes
each layer one kind, by its `attn_layers`: an attention block, or a
Mamba-2 layer (`mamba2_layer`: `ssm.apply_mamba2` then the MLP), one
segment per run of a kind; its muP multipliers scale the embedding, each
residual branch (`_residual`), the attention scores and the logits, each
only where the config sets it.

Distribution's model half, as in the reference: `build_spec(ep=, tp=)`
pads the experts to a multiple of `ep` and the query heads per KV group
for `tp`; with a `mesh` (`launch.mesh.FleetMesh`), `moe_impl="ep"` runs
each MoE block expert-parallel (`moe.apply_moe_ep`) and `ssm_impl=
"seqpar"` each mLSTM block sequence-parallel over the model axis
(`xlstm.apply_mlstm_block_seqpar`, in the forward and the prefill);
without a mesh both run the single-device paths, as the reference's do.
`ShardCtx(mesh, rules)` stands where the reference constrains shardings:
one controller has no partitioner to hint, so it checks that every
logical axis it is given maps to axes the mesh has and changes no value.

`kernel_impl` ("auto" or "ref") is handed to every kernel op of a call:
"ref" runs the plain versions on any device (the card's kernel-vs-plain
comparisons).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import List

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts,
                                    noop_context_fn)

from repro_torch.configs.base import (HYBRID, MAMBA_HYBRID, MOE, SSM,
                                      ModelConfig)
from repro_torch.models import layers as L
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models import xlstm as xlstm_lib
from repro_torch.models.param import Spec, tree_map


MOE_IMPLS = ("dense", "ep")
SSM_IMPLS = ("gspmd", "seqpar")


def check_ported(*, moe_impl: str = "dense", ssm_impl: str = "gspmd"):
    """Raise ValueError for an implementation name that neither package
    knows."""
    if moe_impl not in MOE_IMPLS:
        raise ValueError(f"unknown moe_impl {moe_impl!r}; use one of "
                         f"{MOE_IMPLS}")
    if ssm_impl not in SSM_IMPLS:
        raise ValueError(f"unknown ssm_impl {ssm_impl!r}; use one of "
                         f"{SSM_IMPLS}")


@dataclasses.dataclass(frozen=True)
class Segment:
    kind: str          # "block" | "mlstm" | "slstm" | "mamba2"
    count: int
    window: int = 0    # 0 = full attention (block kind only)


def layer_plan(cfg: ModelConfig) -> List[Segment]:
    """The xLSTM family: a repeating unit of (slstm_every - 1) mLSTM blocks
    then one sLSTM block (xlstm-350m: mLSTM x1, sLSTM x1, twelve times), or
    mLSTM blocks only when slstm_every does not divide the depth. The
    mamba_hybrid family: consecutive layers grouped by kind (granite-4.0-h
    at 20 layers: mamba2 x5, block x1, mamba2 x9, block x1, mamba2 x4).
    The attention families: consecutive layers grouped by attention window
    (hymba: global x1, window x14, global x1, window x15, global x1)."""
    if cfg.family == MAMBA_HYBRID:
        segs: List[Segment] = []
        for i in range(cfg.num_layers):
            kind = "block" if i in cfg.attn_layers else "mamba2"
            if segs and segs[-1].kind == kind:
                segs[-1] = Segment(kind, segs[-1].count + 1)
            else:
                segs.append(Segment(kind, 1))
        return segs
    if cfg.family == SSM:
        e = cfg.ssm.slstm_every
        if e > 0 and cfg.num_layers % e == 0:
            unit = [Segment("mlstm", e - 1)] if e > 1 else []
            unit.append(Segment("slstm", 1))
            return unit * (cfg.num_layers // e)
        return [Segment("mlstm", cfg.num_layers)]
    segs: List[Segment] = []
    for i in range(cfg.num_layers):
        w = (cfg.sliding_window
             if cfg.sliding_window and i not in cfg.global_attn_layers
             else 0)
        if segs and segs[-1].window == w:
            segs[-1] = Segment("block", segs[-1].count + 1, w)
        else:
            segs.append(Segment("block", 1, w))
    return segs


# ---------------------------------------------------------------------------
# Specs
# ---------------------------------------------------------------------------
def _stack_spec(spec_tree, count: int):
    return tree_map(lambda s: Spec((count,) + s.shape, ("layers",) + s.axes,
                                   s.init, s.scale), spec_tree)


def _block_spec(cfg: ModelConfig, ep: int = 1, tp: int = 1):
    spec = {
        "ln1": L.norm_spec(cfg),
        "attn": L.attention_spec(cfg, tp),
        "ln2": L.norm_spec(cfg),
    }
    if cfg.family == MOE:
        spec["moe"] = moe_lib.moe_spec(cfg, ep)
    else:
        spec["mlp"] = L.mlp_spec(cfg)
    if cfg.family == HYBRID:
        spec["mamba"] = ssm_lib.mamba_spec(cfg)
        spec["mix_a"] = Spec((cfg.d_model,), (None,), "ones")
        spec["mix_s"] = Spec((cfg.d_model,), (None,), "ones")
    return spec


def build_spec(cfg: ModelConfig, *, ep: int = 1, tp: int = 1):
    """Full parameter spec tree of an architecture. `ep` pads MoE expert
    counts to the EP divisor; `tp` pads GQA head groups to the TP divisor
    (`layers.padded_heads`)."""
    spec = {"embed": L.embedding_spec(cfg),
            "final_norm": L.norm_spec(cfg)}
    if cfg.meta_tokens:
        spec["meta"] = Spec((cfg.meta_tokens, cfg.d_model), (None, "fsdp"),
                            "embed")
    spec["segments"] = [
        _stack_spec(_segment_spec(cfg, seg.kind, ep, tp), seg.count)
        for seg in layer_plan(cfg)]
    return spec


def _segment_spec(cfg: ModelConfig, kind: str, ep: int = 1, tp: int = 1):
    if kind == "mlstm":
        return xlstm_lib.mlstm_block_spec(cfg)
    if kind == "slstm":
        return xlstm_lib.slstm_block_spec(cfg)
    if kind == "mamba2":
        return {"ln1": L.norm_spec(cfg), "mamba": ssm_lib.mamba2_spec(cfg),
                "ln2": L.norm_spec(cfg), "mlp": L.mlp_spec(cfg)}
    return _block_spec(cfg, ep, tp)


def cache_spec(cfg: ModelConfig, batch: int, cap: int):
    """Spec tree of the decode cache at static capacity `cap` (absolute
    positions, meta tokens included). Per segment: k, v of shape
    (layers, batch, kv_cap, K, hd), kv_cap = cap for global layers and
    min(window, cap) for a ring; a ring with meta tokens adds mk, mv
    (layers, batch, meta, K, hd); a hybrid block adds its Mamba cache
    {"conv" (layers, batch, W-1, di), "state" (layers, batch, H, P, N)}.
    An mLSTM segment: C (layers, batch, H, P, P), n (layers, batch, H, P),
    m (layers, batch, H) "neg_inf", conv (layers, batch, W-1, di); an sLSTM
    segment: h, c, n, m (layers, batch, H, P), m "neg_inf", conv (layers,
    batch, W-1, D); a Mamba-2 segment: conv (layers, batch, W-1, conv
    channels), state (layers, batch, H, P, N) "zeros_fp32", kept in fp32
    whatever the pool's dtype. `cap` does not enter the recurrent caches."""
    K, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    meta = cfg.meta_tokens
    segs = []
    for seg in layer_plan(cfg):
        n, w = seg.count, seg.window
        if seg.kind != "block":
            segs.append(_recurrent_cache_spec(cfg, seg.kind, n, batch))
            continue
        kv_cap = cap if w == 0 else min(w, cap)
        kv_axes = ("layers", "batch", None, "kv_heads", None)
        c = {"k": Spec((n, batch, kv_cap, K, hd), kv_axes, "zeros"),
             "v": Spec((n, batch, kv_cap, K, hd), kv_axes, "zeros")}
        if w > 0 and meta:
            c["mk"] = Spec((n, batch, meta, K, hd), kv_axes, "zeros")
            c["mv"] = Spec((n, batch, meta, K, hd), kv_axes, "zeros")
        if cfg.family == HYBRID:
            di, Hs, P = ssm_lib.mamba_heads(cfg)
            c["mamba"] = {
                "conv": Spec((n, batch, cfg.ssm.conv_width - 1, di),
                             ("layers", "batch", None, "mlp"), "zeros"),
                "state": Spec((n, batch, Hs, P, cfg.ssm.state_dim),
                              ("layers", "batch", None, "mlp", None),
                              "zeros")}
        segs.append(c)
    return {"segments": segs}


def _recurrent_cache_spec(cfg: ModelConfig, kind: str, n: int, batch: int):
    W = cfg.ssm.conv_width
    if kind == "mamba2":
        _, H, P, N, conv = ssm_lib.mamba2_dims(cfg)
        return {"conv": Spec((n, batch, W - 1, conv),
                             ("layers", "batch", None, "mlp"), "zeros"),
                "state": Spec((n, batch, H, P, N),
                              ("layers", "batch", None, "mlp", None),
                              "zeros_fp32")}
    if kind == "mlstm":
        di, H, P = xlstm_lib.mlstm_heads(cfg)
        lbh = ("layers", "batch", "heads")
        return {"C": Spec((n, batch, H, P, P), lbh + (None, None), "zeros"),
                "n": Spec((n, batch, H, P), lbh + (None,), "zeros"),
                "m": Spec((n, batch, H), lbh, "neg_inf"),
                "conv": Spec((n, batch, W - 1, di),
                             ("layers", "batch", None, "mlp"), "zeros")}
    H = cfg.num_heads
    P = cfg.d_model // H
    lbh = ("layers", "batch", "heads", None)
    return {"h": Spec((n, batch, H, P), lbh, "zeros"),
            "c": Spec((n, batch, H, P), lbh, "zeros"),
            "n": Spec((n, batch, H, P), lbh, "zeros"),
            "m": Spec((n, batch, H, P), lbh, "neg_inf"),
            "conv": Spec((n, batch, W - 1, cfg.d_model),
                         ("layers", "batch", None, None), "zeros")}


# ---------------------------------------------------------------------------
# Block forward / decode
# ---------------------------------------------------------------------------
def _layer(tree, i: int):
    """Layer `i` of a stacked segment's parameters or cache (views, no
    copy: in-place writes reach the stack)."""
    return tree_map(lambda t: t[i], tree)


def _layers(tree, n: int):
    """The n layers of a stacked segment's parameters, each leaf unbound
    once (views, as `_layer`'s). Under autograd one unbind's backward
    stacks the layers' gradients, where n selects would each add a
    zero-padded gradient of the whole stack."""
    unbound = tree_map(lambda t: t.unbind(0), tree)

    def pick(t, i):
        if isinstance(t, dict):
            return {k: pick(v, i) for k, v in t.items()}
        if isinstance(t, list):
            return [pick(v, i) for v in t]
        return t[i]
    return [pick(unbound, i) for i in range(n)]


def _rms(x, eps: float = 1e-6):
    xf = x.to(torch.float32)
    return (xf * torch.rsqrt(xf.pow(2).mean(-1, keepdim=True) + eps)
            ).to(x.dtype)


def _residual(cfg: ModelConfig, x, y):
    """x plus a residual branch y, times the config's muP
    `residual_multiplier` where it sets one (one fused add)."""
    m = cfg.residual_multiplier
    return x + y if m == 1.0 else torch.add(x, y, alpha=m)


def _mix(cfg: ModelConfig, p, x, attn_out, ssm_out):
    """Residual update of a block: attention alone, or (hybrid) the mean
    of the RMS-normed attention and Mamba outputs, each scaled."""
    if cfg.family != HYBRID:
        return _residual(cfg, x, attn_out)
    na = _rms(attn_out) * p["mix_a"].to(x.dtype)
    ns = _rms(ssm_out) * p["mix_s"].to(x.dtype)
    return x + 0.5 * (na + ns)


# ---------------------------------------------------------------------------
# Sharding context
# ---------------------------------------------------------------------------
class ShardCtx:
    """Where the reference applies `with_sharding_constraint` from logical
    axis names. One controller has no partitioner to hint: a call checks
    that each named axis maps (through `rules`) to axes the mesh has and
    returns `x` unchanged; a None mesh makes it a no-op."""

    def __init__(self, mesh=None, rules=None):
        self.mesh = mesh
        self.rules = rules or {}

    def __call__(self, x, *axes):
        if self.mesh is None:
            return x
        for name in axes:
            entry = self.rules.get(name) if name is not None else None
            for a in (entry if isinstance(entry, tuple) else (entry,)):
                if a is not None and a not in self.mesh.shape:
                    raise ValueError(f"logical axis {name!r} maps to {a!r}, "
                                     f"not an axis of the mesh "
                                     f"{dict(self.mesh.shape)}")
        return x


NULL_CTX = ShardCtx()


def _batch_axes(mesh):
    return tuple(a for a in ("pod", "data") if a in mesh.shape)


def _ffn(cfg: ModelConfig, p, h2, capacity_factor: float,
         moe_impl: str = "dense", mesh=None):
    """The block's second half on the normed residual: the MLP, or (MoE)
    the dense expert dispatch, or with `moe_impl="ep"` and a mesh the
    expert-parallel one. Returns (y, aux)."""
    if cfg.family != MOE:
        return L.apply_mlp(cfg, p["mlp"], h2), None
    if moe_impl == "ep" and mesh is not None:
        return moe_lib.apply_moe_ep(
            cfg, p["moe"], h2, mesh, capacity_factor=capacity_factor,
            batch_axes=_batch_axes(mesh),
            fsdp_axis="data" if "data" in mesh.shape else None)
    return moe_lib.apply_moe_dense(cfg, p["moe"], h2,
                                   capacity_factor=capacity_factor)


def _block_forward(cfg: ModelConfig, p, x, positions, *, window: int,
                   collect_cache: bool, kernel_impl: str,
                   capacity_factor: float, moe_impl: str = "dense",
                   mesh=None, ctx: ShardCtx = NULL_CTX):
    h = L.apply_norm(cfg, p["ln1"], x)
    if window > 0:
        attn_out, (k, v) = L.attention_windowed(
            cfg, p["attn"], h, positions, window=window,
            meta=cfg.meta_tokens)
    else:
        attn_out, (k, v) = L.attention_full(cfg, p["attn"], h, positions,
                                            causal=cfg.causal,
                                            kernel_impl=kernel_impl)
    attn_out = ctx(attn_out, "batch", None, None)
    cache = {"k": k, "v": v} if collect_cache else None
    ssm_out = None
    if cfg.family == HYBRID:
        res = ssm_lib.apply_mamba(cfg, p["mamba"], h,
                                  return_cache=collect_cache,
                                  kernel_impl=kernel_impl)
        if collect_cache:
            ssm_out, cache["mamba"] = res
        else:
            ssm_out = res
    x = _mix(cfg, p, x, attn_out, ssm_out)
    y, aux = _ffn(cfg, p, L.apply_norm(cfg, p["ln2"], x), capacity_factor,
                  moe_impl, mesh)
    return ctx(_residual(cfg, x, y), "batch", None, None), cache, aux


def _block_decode(cfg: ModelConfig, p, x, cache, pos, *, window: int,
                  kernel_impl: str, capacity_factor: float,
                  moe_impl: str = "dense", mesh=None):
    h = L.apply_norm(cfg, p["ln1"], x)
    attn_out, _ = L.attention_decode(cfg, p["attn"], h, cache, pos,
                                     window=window, meta=cfg.meta_tokens,
                                     kernel_impl=kernel_impl)
    ssm_out = None
    if cfg.family == HYBRID:
        ssm_out, _ = ssm_lib.apply_mamba_step(cfg, p["mamba"], h,
                                              cache["mamba"])
    x = _mix(cfg, p, x, attn_out, ssm_out)
    y, _ = _ffn(cfg, p, L.apply_norm(cfg, p["ln2"], x), capacity_factor,
                moe_impl, mesh)
    return _residual(cfg, x, y)


def mamba2_layer(cfg: ModelConfig, p, x, *, cache=None,
                 collect_cache: bool = False, kernel_impl: str = "auto"):
    """A Mamba-2 layer: x + the mixer of its norm, then + the MLP of its
    norm, each branch through `_residual`. With `cache` ({"conv",
    "state"} of one layer) one decode step of x (B,1,D), its rows written
    in place; else the full sequence, with `collect_cache` also returning
    the decode cache. Returns (x, cache | None)."""
    h = L.apply_norm(cfg, p["ln1"], x)
    c = None
    if cache is not None:
        y, _ = ssm_lib.apply_mamba2_step(cfg, p["mamba"], h, cache)
    elif collect_cache:
        y, c = ssm_lib.apply_mamba2(cfg, p["mamba"], h, return_cache=True,
                                    kernel_impl=kernel_impl)
    else:
        y = ssm_lib.apply_mamba2(cfg, p["mamba"], h,
                                 kernel_impl=kernel_impl)
    x = _residual(cfg, x, y)
    h2 = L.apply_norm(cfg, p["ln2"], x)
    return _residual(cfg, x, L.apply_mlp(cfg, p["mlp"], h2)), c


# ---------------------------------------------------------------------------
# Layer bodies and remat
# ---------------------------------------------------------------------------
REMATS = ("none", "dots", "full")

# the matrix products that remat="dots" keeps for the backward, as
# `jax.checkpoint_policies.checkpoint_dots` keeps the dot_generals
_DOT_OPS = frozenset((torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
                      torch.ops.aten.bmm.default,
                      torch.ops.aten.baddbmm.default))


def _layer_forward(cfg: ModelConfig, seg: Segment, lp, x, *, positions,
                   collect_cache: bool, kernel_impl: str,
                   capacity_factor: float, moe_impl: str, mesh, ssm_impl: str,
                   ctx: ShardCtx):
    """One layer of `seg` on x: (x, cache | None, aux | None), the body
    the reference scans over the segment's layers."""
    if seg.kind == "mlstm" and ssm_impl == "seqpar" and mesh is not None:
        return xlstm_lib.apply_mlstm_block_seqpar(
            cfg, lp, x, mesh, batch_axes=_batch_axes(mesh),
            kernel_impl=kernel_impl), None, None
    if seg.kind == "mlstm":
        return xlstm_lib.apply_mlstm_block(cfg, lp, x,
                                           kernel_impl=kernel_impl) + (None,)
    if seg.kind == "slstm":
        return xlstm_lib.apply_slstm_block(cfg, lp, x) + (None,)
    if seg.kind == "mamba2":
        return mamba2_layer(cfg, lp, x, collect_cache=collect_cache,
                            kernel_impl=kernel_impl) + (None,)
    return _block_forward(cfg, lp, x, positions, window=seg.window,
                          collect_cache=collect_cache,
                          kernel_impl=kernel_impl,
                          capacity_factor=capacity_factor, moe_impl=moe_impl,
                          mesh=mesh, ctx=ctx)


def _dots_policy(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOT_OPS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat_wrap(body, remat: str):
    """The reference's `_remat_wrap` on one layer's body: "none" keeps
    every activation the backward needs; "full" keeps only the body's
    inputs and runs it again in the backward; "dots" keeps the outputs of
    the matrix products (`_DOT_OPS`) and recomputes the rest. The
    recompute sees the same inputs and draws no random numbers (the
    models have no dropout), so it is exact: the MoE route's stable-sort
    tie order and the EP moves repeat, and the train route's plain forms
    (`impl="autograd"`) run again. Checkpointing works through saved-
    tensor hooks, which `torch.func` transforms refuse: differentiate a
    rematerialised forward with `torch.autograd.grad`
    (`train.train_step.grad_and_value`)."""
    if remat not in REMATS:
        raise ValueError(f"unknown remat {remat!r}; use one of {REMATS}")
    if remat == "none":
        return body
    context_fn = (functools.partial(create_selective_checkpoint_contexts,
                                    _dots_policy)
                  if remat == "dots" else noop_context_fn)

    def wrapped(*args, **kwargs):
        return checkpoint(body, *args, use_reentrant=False,
                          preserve_rng_state=False, context_fn=context_fn,
                          **kwargs)
    return wrapped


# ---------------------------------------------------------------------------
# Public model functions
# ---------------------------------------------------------------------------
def _embed(cfg: ModelConfig, params, inputs, compute_dtype):
    """Token ids (B,S) through the table (`layers.embed`), or (embedding
    frontend) float embeddings (B,S,D) cast to the compute dtype."""
    if cfg.embedding_frontend:
        return inputs.to(compute_dtype)
    return L.embed(cfg, params["embed"], inputs, compute_dtype)


def forward(cfg: ModelConfig, params, inputs, *,
            compute_dtype=torch.bfloat16, collect_cache: bool = False,
            kernel_impl: str = "auto", capacity_factor: float = 1.25,
            ctx: ShardCtx = NULL_CTX, moe_impl: str = "dense", mesh=None,
            ssm_impl: str = "gspmd", remat: str = "none"):
    """Full-sequence forward. inputs: int tokens (B,S), or float embeds
    (B,S,D) when cfg.embedding_frontend. Meta tokens are prepended
    internally and stripped from the logits. With a `mesh`, `moe_impl=
    "ep"` runs the MoE blocks expert-parallel and `ssm_impl="seqpar"` the
    mLSTM blocks sequence-parallel. `remat` ("none", "dots", "full")
    rematerialises each layer's body in the backward (`_remat_wrap`).
    Returns (logits (B,S,V), aux, caches|None); aux is the MoE
    load-balance loss summed over the layers (0 for the other families),
    caches (attention families only: the xLSTM prefill builds
    its recurrent cache in `_prefill_recurrent`) a list per segment of
    {"k","v": (n,B,S+meta,K,hd)} [+ "mamba": {"conv","state"} stacked over
    the segment's layers], or for a Mamba-2 segment {"conv","state"}."""
    x = _embed(cfg, params, inputs, compute_dtype)
    B = x.shape[0]
    meta = cfg.meta_tokens
    if meta:
        x = torch.cat([params["meta"].to(compute_dtype).expand(
            B, meta, cfg.d_model), x], dim=1)
    S = x.shape[1]
    positions = torch.arange(S, device=x.device).expand(B, S)
    x = ctx(x, "batch", "seq", None)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    caches = []
    for seg, segp in zip(layer_plan(cfg), params["segments"]):
        body = _remat_wrap(functools.partial(
            _layer_forward, cfg, seg, positions=positions,
            collect_cache=collect_cache, kernel_impl=kernel_impl,
            capacity_factor=capacity_factor, moe_impl=moe_impl, mesh=mesh,
            ssm_impl=ssm_impl, ctx=ctx), remat)
        layer_caches = []
        for lp in _layers(segp, seg.count):
            x, c, aux_l = body(lp, x)
            if aux_l is not None:
                aux = aux + aux_l
            layer_caches.append(c)
        if collect_cache:
            caches.append(_stack_layers(layer_caches))
    x = L.apply_norm(cfg, params["final_norm"], x)
    logits = L.unembed(cfg, params["embed"], x[:, meta:])
    logits = ctx(logits, "batch", None, "vocab")
    return logits, aux, (caches if collect_cache else None)


def _stack_layers(trees):
    """A list of per-layer cache trees -> one tree stacked on dim 0."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack_layers([t[k] for t in trees]) for k in first}
    return torch.stack(trees)


def prefill(cfg: ModelConfig, params, inputs, cap: int, *,
            compute_dtype=torch.bfloat16, cache_dtype=torch.bfloat16,
            kernel_impl: str = "auto", capacity_factor: float = 1.25,
            ctx: ShardCtx = NULL_CTX, moe_impl: str = "dense", mesh=None,
            ssm_impl: str = "gspmd"):
    """Run the full prompt and build a decode cache of static capacity
    `cap` (absolute positions, meta tokens included). K/V go to the cache
    in `cache_dtype`; the Mamba cache keeps its conv rows in the compute
    dtype and its state in fp32, as in the JAX package (the serving pool
    casts every leaf on write); a Mamba-2 segment's cache is its layers'
    conv rows and fp32 states. Returns (last_logits (B,V), cache_tree,
    next_pos = S + meta). The xLSTM family goes to `_prefill_recurrent`."""
    if cfg.family == SSM:
        return _prefill_recurrent(cfg, params, inputs,
                                  compute_dtype=compute_dtype,
                                  kernel_impl=kernel_impl, mesh=mesh,
                                  ssm_impl=ssm_impl)
    logits, _, kv_caches = forward(cfg, params, inputs,
                                   compute_dtype=compute_dtype,
                                   collect_cache=True,
                                   kernel_impl=kernel_impl,
                                   capacity_factor=capacity_factor, ctx=ctx,
                                   moe_impl=moe_impl, mesh=mesh)
    S_tot = inputs.shape[1] + cfg.meta_tokens
    segs = []
    for seg, kv in zip(layer_plan(cfg), kv_caches):
        if seg.kind == "mamba2":                  # {"conv", "state"}
            segs.append(kv)
            continue
        k, v = kv["k"], kv["v"]                   # (n, B, S_tot, K, hd)
        if seg.window == 0:
            n = min(S_tot, cap)
            c = {}
            for name, full in (("k", k), ("v", v)):
                buf = torch.zeros(full.shape[:2] + (cap,) + full.shape[3:],
                                  dtype=cache_dtype, device=full.device)
                buf[:, :, :n] = full[:, :, :n]
                c[name] = buf
        else:
            c = _ring_from_full(k, v, min(seg.window, cap), cfg.meta_tokens,
                                S_tot, cache_dtype)
        if cfg.family == HYBRID:
            c["mamba"] = kv["mamba"]
        segs.append(c)
    return logits[:, -1], {"segments": segs}, S_tot


def _ring_from_full(k, v, w: int, meta: int, S_tot: int, cache_dtype):
    """Full (n,B,S_tot,K,hd) K/V -> a ring of width w (slot s holds the
    last position <= S_tot - 1 congruent to s mod w, attention_decode's
    slot convention) plus the meta rows as mk, mv. Slots no position has
    reached hold row 0; decode masks them by their stored position."""
    idx = torch.arange(w, device=k.device)
    p_last = S_tot - 1
    stored = torch.clamp(p_last - torch.remainder(p_last - idx, w),
                         0, S_tot - 1)
    c = {"k": k[:, :, stored].to(cache_dtype),
         "v": v[:, :, stored].to(cache_dtype)}
    if meta:
        c["mk"] = k[:, :, :meta].to(cache_dtype)
        c["mv"] = v[:, :, :meta].to(cache_dtype)
    return c


def _prefill_recurrent(cfg: ModelConfig, params, inputs, *, compute_dtype,
                       kernel_impl: str, mesh=None, ssm_impl: str = "gspmd"):
    """xLSTM prefill: the full prompt through every block, each returning
    its final recurrent state and conv rows (mLSTM state from `ops.mlstm`,
    fp32; conv rows in the compute dtype), stacked per segment; with
    `ssm_impl="seqpar"` and a mesh the mLSTM blocks run sequence-parallel
    over its model axis. Returns (last_logits (B,V), cache_tree,
    next_pos = S)."""
    x = L.embed(cfg, params["embed"], inputs, compute_dtype)
    seqpar = ssm_impl == "seqpar" and mesh is not None
    segs = []
    for seg, segp in zip(layer_plan(cfg), params["segments"]):
        states = []
        for i in range(seg.count):
            if seg.kind == "mlstm" and seqpar:
                x, st = xlstm_lib.apply_mlstm_block_seqpar(
                    cfg, _layer(segp, i), x, mesh,
                    batch_axes=_batch_axes(mesh), want_state=True,
                    kernel_impl=kernel_impl)
            elif seg.kind == "mlstm":
                x, st = xlstm_lib.mlstm_block_states(
                    cfg, _layer(segp, i), x, kernel_impl=kernel_impl)
            else:
                x, st = xlstm_lib.slstm_block_states(cfg, _layer(segp, i), x)
            states.append(st)
        segs.append(_stack_layers(states))
    x = L.apply_norm(cfg, params["final_norm"], x)
    logits = L.unembed(cfg, params["embed"], x[:, -1:])
    return logits[:, -1], {"segments": segs}, inputs.shape[1]


def decode_step(cfg: ModelConfig, params, token, cache, pos, *,
                compute_dtype=torch.bfloat16, kernel_impl: str = "auto",
                capacity_factor: float = 1.25, ctx: ShardCtx = NULL_CTX,
                moe_impl: str = "dense", mesh=None):
    """One-token decode. token: (B,1) int; pos: absolute position of the
    token (meta tokens included; the xLSTM family does not read it), an
    int for the batch or a (B,) int tensor on the device, one per lane:
    each lane then takes its own RoPE position, writes its K/V row at its
    own position and attends to its own prefix (`layers.decode_attend`).
    The cache is updated in place. A MoE block routes the B tokens
    together, with the reference's capacity drops (expert-parallel with
    `moe_impl="ep"` and a mesh).
    Returns (logits (B,1,V), cache)."""
    if cfg.embedding_frontend:
        raise ValueError("encoder-only arch has no decode step")
    x = ctx(L.embed(cfg, params["embed"], token, compute_dtype),
            "batch", None, None)
    for seg, segp, segc in zip(layer_plan(cfg), params["segments"],
                               cache["segments"]):
        for i in range(seg.count):
            lp, lc = _layer(segp, i), _layer(segc, i)
            if seg.kind == "mlstm":
                x, _ = xlstm_lib.apply_mlstm_block(cfg, lp, x, cache=lc)
            elif seg.kind == "slstm":
                x, _ = xlstm_lib.apply_slstm_block(cfg, lp, x, cache=lc)
            elif seg.kind == "mamba2":
                x, _ = mamba2_layer(cfg, lp, x, cache=lc)
            else:
                x = _block_decode(cfg, lp, x, lc, pos, window=seg.window,
                                  kernel_impl=kernel_impl,
                                  capacity_factor=capacity_factor,
                                  moe_impl=moe_impl, mesh=mesh)
    x = L.apply_norm(cfg, params["final_norm"], x)
    logits = ctx(L.unembed(cfg, params["embed"], x), "batch", None, "vocab")
    return logits, cache
