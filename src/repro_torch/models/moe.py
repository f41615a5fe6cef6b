"""Mixture-of-Experts: top-k routing with capacity-based dispatch, as in
the JAX package's `models/moe.py`.

`apply_moe_dense` is the reference's dense path in plain PyTorch: route
each token to its top-k experts, rank every (token, k) pair within its
expert, drop the pairs beyond the expert's capacity, run each expert's
SwiGLU on an (E, C, d) buffer (batched products), gather back and weight.
The reference computes MoE in XLA, outside any Pallas kernel, and so
does the port: no hand-written kernel is involved.

Where a port can part from the reference quietly, this one follows it:
  * top-k ties go to the lower expert index first, as `lax.top_k` does
    (a stable descending sort, then the first k);
  * the capacity is `max(1, int(t * top_k / num_experts * cf))` in the
    reference's order of operations (the `int()` truncates);
  * slot ranks are an exclusive running count over the (t*k) pairs in
    token-major order, so the same pairs drop;
  * a dropped pair adds 0 at slot capacity - 1, as `.at[].add(mode=
    "drop")` does, through an out-of-place `index_put(accumulate=True)`
    that `torch.func.grad_and_value` differentiates;
  * router logits, softmax and the shared-expert gate are fp32.

`apply_moe_dropless` is the fleet decode's: each token routed as if
alone (the reference vmaps a B = 1 decode per lane, where the capacity
is 1 per expert and no pair can drop). The expert-parallel path
(`apply_moe_ep`) waits for distribution's model half (ROADMAP.md queue 1
item 9b).
Experts are padded to a multiple of the EP shard count (1 until then);
padded experts get -inf router logits.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.param import Spec

NEG_INF = -1e30
F32 = torch.float32


def padded_experts(cfg: ModelConfig, ep: int = 1) -> int:
    e = cfg.moe.num_experts
    return ((e + ep - 1) // ep) * ep


def moe_spec(cfg: ModelConfig, ep: int = 1):
    m = cfg.moe
    d, f = cfg.d_model, m.d_ff_expert
    E = padded_experts(cfg, ep)
    down = 1.0 / math.sqrt(2 * cfg.num_layers)
    spec = {
        "router": Spec((d, E)),
        "wg": Spec((E, d, f)),
        "wu": Spec((E, d, f)),
        "wd": Spec((E, f, d), scale=down),
    }
    if m.num_shared_experts:
        fs = m.d_ff_shared
        spec.update({
            "shared_wg": Spec((d, fs)),
            "shared_wu": Spec((d, fs)),
            "shared_wd": Spec((fs, d), scale=down),
            "shared_gate": Spec((d, 1)),
        })
    return spec


# ---------------------------------------------------------------------------
# Routing
# ---------------------------------------------------------------------------
def _route(cfg: ModelConfig, p, x2d):
    """x2d: (t, d) -> (weights (t,k) fp32, ids (t,k) int64, aux_loss
    fp32 scalar)."""
    m = cfg.moe
    E = p["router"].shape[1]
    logits = x2d.to(F32) @ p["router"].to(F32)
    if E != m.num_experts:   # mask padded experts
        pad = torch.arange(E, device=x2d.device) >= m.num_experts
        logits = torch.where(pad, NEG_INF, logits)
    probs = torch.softmax(logits, dim=-1)
    # lax.top_k's order: larger first, ties to the lower index
    srt, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_w, top_ids = srt[:, :m.top_k], idx[:, :m.top_k]
    top_w = top_w / top_w.sum(dim=-1, keepdim=True)       # renormalize
    # Switch-style load-balance auxiliary loss over real experts
    first = _one_hot(top_ids[:, 0], E).to(F32)
    frac_tokens = first.mean(dim=0)
    mean_probs = probs.mean(dim=0)
    aux = m.num_experts * torch.sum(frac_tokens * mean_probs)
    return top_w, top_ids, aux


def _one_hot(ids, E: int):
    """(n,) ints -> (n, E) bool, without reading the ids' values on the
    host (F.one_hot checks them), so it also runs on `meta` tensors."""
    return ids[:, None] == torch.arange(E, device=ids.device)


def _dispatch_slots(ids, E: int, capacity: int):
    """Rank each (token, k) pair within its expert; drop beyond capacity.

    ids: (t, k) int. Returns (slot (t,k), keep (t,k) bool)."""
    t, k = ids.shape
    flat = ids.reshape(-1)
    oneh = _one_hot(flat, E).to(torch.int64)               # (t*k, E)
    ranks = torch.cumsum(oneh, dim=0) - oneh               # exclusive
    slot = torch.gather(ranks, 1, flat[:, None])[:, 0]
    keep = slot < capacity
    return slot.reshape(t, k), keep.reshape(t, k)


def _expert_ffn(cfg: ModelConfig, wg, wu, wd, xbuf):
    """xbuf: (E, C, d) -> (E, C, d). SwiGLU per expert."""
    dt = xbuf.dtype
    g = torch.bmm(xbuf, wg.to(dt))
    u = torch.bmm(xbuf, wu.to(dt))
    return torch.bmm(F.silu(g) * u, wd.to(dt))


def _shared_expert(cfg: ModelConfig, p, x2d):
    dt = x2d.dtype
    g = x2d @ p["shared_wg"].to(dt)
    u = x2d @ p["shared_wu"].to(dt)
    y = (F.silu(g) * u) @ p["shared_wd"].to(dt)
    gate = torch.sigmoid(x2d.to(F32) @ p["shared_gate"].to(F32))
    return y * gate.to(dt)


def capacity_of(cfg: ModelConfig, t: int, capacity_factor: float) -> int:
    """The reference's per-expert capacity for t tokens."""
    m = cfg.moe
    return max(1, int(t * m.top_k / m.num_experts * capacity_factor))


def _moe(cfg: ModelConfig, p, x, capacity: int):
    """The dispatch, experts and combine at a given capacity.
    x: (B,S,D) -> (y, aux_loss)."""
    B, S, D = x.shape
    m = cfg.moe
    E = p["router"].shape[1]
    x2d = x.reshape(-1, D)
    t = x2d.shape[0]
    top_w, top_ids, aux = _route(cfg, p, x2d)
    slot, keep = _dispatch_slots(top_ids, E, capacity)

    # scatter tokens into the (E, C, d) buffer; a dropped pair adds 0 at
    # slot capacity - 1
    safe_slot = torch.where(keep, slot, capacity - 1).reshape(-1)
    ids = top_ids.reshape(-1)
    upd = torch.where(keep[..., None], x2d[:, None, :], 0).reshape(-1, D)
    xbuf = torch.zeros((E, capacity, D), dtype=x.dtype, device=x.device)
    xbuf = xbuf.index_put((ids, safe_slot), upd, accumulate=True)

    ybuf = _expert_ffn(cfg, p["wg"], p["wu"], p["wd"], xbuf)

    # gather back, weight, and sum over k
    y_pairs = ybuf[ids, safe_slot].reshape(t, m.top_k, D)
    y_pairs = torch.where(keep[..., None], y_pairs, 0)
    y = torch.sum(y_pairs * top_w[..., None].to(x.dtype), dim=1)
    if m.num_shared_experts:
        y = y + _shared_expert(cfg, p, x2d)
    return y.reshape(B, S, D), aux


def apply_moe_dense(cfg: ModelConfig, p, x, *,
                    capacity_factor: float = 1.25):
    """x: (B,S,D) -> (y, aux_loss); pairs beyond each expert's capacity
    for the B*S tokens drop, as in the reference."""
    t = x.shape[0] * x.shape[1]
    return _moe(cfg, p, x, capacity_of(cfg, t, capacity_factor))


def apply_moe_dropless(cfg: ModelConfig, p, x):
    """x: (B,S,D) -> y, every token routed as if it were alone: a token's
    k experts are distinct, so alone it never exceeds a capacity of 1 and
    no pair drops. A capacity of B*S keeps every pair in one dispatch."""
    return _moe(cfg, p, x, x.shape[0] * x.shape[1])[0]


def apply_moe_ep(*args, **kwargs):
    raise NotImplementedError(
        "moe_impl='ep' (expert parallelism) not ported yet (ROADMAP.md "
        "queue 1 item 9b, distribution's model half)")
