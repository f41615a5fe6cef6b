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
    that autograd differentiates;
  * router logits, softmax and the shared-expert gate are fp32.

`apply_moe_dropless` is the fleet decode's: each token routed as if
alone (the reference vmaps a B = 1 decode per lane, where the capacity
is 1 per expert and no pair can drop).

`apply_moe_ep` is the reference's GShard-style expert parallelism over a
(data, model) mesh (`launch.mesh.FleetMesh`), its `shard_map` body run
once per entry on that entry's device: each entry routes its own slice
of its data row's tokens, sends an (E, C, D) buffer grouped by
destination, and the all_to_all is the move of block j of every source to
entry j; entry j runs its E / M local experts, the buffers go back the
same way, and the model axis' results are concatenated. Experts are
padded to a multiple of the EP shard count (`padded_experts`); padded
experts get -inf router logits, so they are never routed.
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import silu
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
        "router": Spec((d, E), (None, None)),
        "wg": Spec((E, d, f), ("experts", "fsdp", None)),
        "wu": Spec((E, d, f), ("experts", "fsdp", None)),
        "wd": Spec((E, f, d), ("experts", None, "fsdp"), scale=down),
    }
    if m.num_shared_experts:
        fs = m.d_ff_shared
        spec.update({
            "shared_wg": Spec((d, fs), ("fsdp", "mlp")),
            "shared_wu": Spec((d, fs), ("fsdp", "mlp")),
            "shared_wd": Spec((fs, d), ("mlp", "fsdp"), scale=down),
            "shared_gate": Spec((d, 1), (None, None)),
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
    return torch.bmm(silu(g) * u, wd.to(dt))


def _shared_expert(cfg: ModelConfig, p, x2d):
    dt = x2d.dtype
    g = x2d @ p["shared_wg"].to(dt)
    u = x2d @ p["shared_wu"].to(dt)
    y = (silu(g) * u) @ p["shared_wd"].to(dt)
    gate = torch.sigmoid(x2d.to(F32) @ p["shared_gate"].to(F32))
    return y * gate.to(dt)


def capacity_of(cfg: ModelConfig, t: int, capacity_factor: float) -> int:
    """The reference's per-expert capacity for t tokens."""
    m = cfg.moe
    return max(1, int(t * m.top_k / m.num_experts * capacity_factor))


def _scatter(x2d, ids, slot, keep, E: int, capacity: int):
    """The (E, C, D) dispatch buffer of the (token, k) pairs: pair (t, k)
    at [ids, slot] where kept; a dropped pair adds 0 at slot capacity - 1,
    as the reference's `.at[].add(mode="drop")` does. Returns (buffer,
    the flat safe slots)."""
    D = x2d.shape[-1]
    safe_slot = torch.where(keep, slot, capacity - 1).reshape(-1)
    upd = torch.where(keep[..., None], x2d[:, None, :], 0).reshape(-1, D)
    buf = torch.zeros((E, capacity, D), dtype=x2d.dtype, device=x2d.device)
    return buf.index_put((ids.reshape(-1), safe_slot), upd,
                         accumulate=True), safe_slot


def _combine(ybuf, ids, safe_slot, keep, top_w, dtype):
    """Gather each pair's expert output back, zero the dropped pairs,
    weight and sum over k. Returns (t, D)."""
    t, k = keep.shape
    y_pairs = ybuf[ids.reshape(-1), safe_slot].reshape(t, k, -1)
    y_pairs = torch.where(keep[..., None], y_pairs, 0)
    return torch.sum(y_pairs * top_w[..., None].to(dtype), dim=1)


def _moe(cfg: ModelConfig, p, x, capacity: int):
    """The dispatch, experts and combine at a given capacity.
    x: (B,S,D) -> (y, aux_loss)."""
    B, S, D = x.shape
    m = cfg.moe
    E = p["router"].shape[1]
    x2d = x.reshape(-1, D)
    top_w, top_ids, aux = _route(cfg, p, x2d)
    slot, keep = _dispatch_slots(top_ids, E, capacity)
    xbuf, safe_slot = _scatter(x2d, top_ids, slot, keep, E, capacity)
    ybuf = _expert_ffn(cfg, p["wg"], p["wu"], p["wd"], xbuf)
    y = _combine(ybuf, top_ids, safe_slot, keep, top_w, x.dtype)
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


def ep_capacity(cfg: ModelConfig, t_m: int, E: int,
                capacity_factor: float) -> int:
    """The EP path's capacity per (expert, source entry) for an entry's
    t_m tokens over E (padded) experts, as the reference writes it:
    max(1, ceil(t_m * k / E * cf)). (The dense path's `capacity_of` is
    int(t * k / num_experts * cf); each keeps its own formula.)"""
    return max(1, int(math.ceil(t_m * cfg.moe.top_k / E * capacity_factor)))


def _ep_row(cfg: ModelConfig, p, x_loc, mesh, where: dict, model_axis: str,
            capacity_factor: float, trace):
    """One data row of the EP `shard_map`: x_loc (B_loc, S, D) on the
    row's home device -> (y (B_loc, S, D) on that device, the row's aux,
    the model-axis mean of its entries' aux)."""
    m = cfg.moe
    B_loc, S, D = x_loc.shape
    M = mesh.shape[model_axis]
    E = p["wg"].shape[0]
    E_loc = E // M
    devs = [mesh.device_at(**where, **{model_axis: j}) for j in range(M)]
    t_all = B_loc * S
    x2d = x_loc.reshape(t_all, D)
    # pad the token axis so every model entry owns an equal slice
    t_m = max(1, -(-t_all // M))
    pad = t_m * M - t_all
    if pad:
        x2d = torch.cat([x2d, x2d.new_zeros((pad, D))])
    C = ep_capacity(cfg, t_m, E, capacity_factor)

    sends, routes, auxes = [], [], []
    for j, dev in enumerate(devs):
        xm = x2d[j * t_m:(j + 1) * t_m].to(dev)
        top_w, top_ids, aux = _route(cfg, {"router": p["router"].to(dev)},
                                     xm)
        slot, keep = _dispatch_slots(top_ids, E, C)
        tok_valid = (j * t_m + torch.arange(t_m, device=dev)) < t_all
        keep = keep & tok_valid[:, None]
        sbuf, safe_slot = _scatter(xm, top_ids, slot, keep, E, C)
        sends.append(sbuf.reshape(M, E_loc, C, D))
        routes.append((top_w, top_ids, safe_slot, keep))
        auxes.append(aux)
        if trace is not None:
            trace.append({**where, model_axis: j, "ids": top_ids,
                          "slot": slot, "keep": keep, "capacity": C})

    backs = [[None] * M for _ in range(M)]
    for i, dev in enumerate(devs):
        # all_to_all: entry i receives block i of every source, (M, E_loc,
        # C, D) -> its local experts' rows (E_loc, M * C, D)
        rbuf = torch.stack([sends[j][i].to(dev) for j in range(M)])
        rbuf = rbuf.transpose(0, 1).reshape(E_loc, M * C, D)
        # the FSDP gather of the local expert block over the data axis is
        # the block itself: the controller holds every expert whole (a
        # view on the entry's own device)
        lo, hi = i * E_loc, (i + 1) * E_loc
        wg, wu, wd = (p[w][lo:hi].to(dev) for w in ("wg", "wu", "wd"))
        ybuf = _expert_ffn(cfg, wg, wu, wd, rbuf)
        ybuf = ybuf.reshape(E_loc, M, C, D).transpose(0, 1)
        for j in range(M):
            backs[j][i] = ybuf[j]

    home = x_loc.device
    ys = []
    for j, dev in enumerate(devs):
        # all_to_all back: entry j gathers its pairs' outputs from every
        # expert entry, (M, E_loc, C, D) -> (E, C, D)
        back = torch.stack([b.to(dev) for b in backs[j]]).reshape(E, C, D)
        top_w, top_ids, safe_slot, keep = routes[j]
        ys.append(_combine(back, top_ids, safe_slot, keep, top_w,
                           x_loc.dtype).to(home))
    # all_gather over the model axis; the padding rows go
    y = torch.cat(ys)[:t_all].reshape(B_loc, S, D)
    aux = torch.stack([a.to(home) for a in auxes]).mean()
    return y, aux


def apply_moe_ep(cfg: ModelConfig, p, x, mesh, *,
                 capacity_factor: float = 1.25, batch_axes=("data",),
                 fsdp_axis="data", model_axis: str = "model", trace=None):
    """GShard-style EP. x: (B,S,D), its batch split over `batch_axes`
    (one data row per position over them) and replicated over the model
    axis; experts split over the model axis, E / M per entry. Per entry:
    route its token slice, capacity C = max(1, ceil(t_m k / E cf)) per
    (expert, source), all_to_all the (E, C, D) send buffer, run the local
    experts, all_to_all back, weight and sum over k; the model axis'
    results are concatenated. aux is each entry's `_route` aux averaged
    over the model axis, then over the batch axes (padded token rows
    count in it, as in the reference). Shared experts run outside, on the
    whole x. `fsdp_axis` is taken for the reference's signature: the
    controller holds each expert block whole, so its FSDP gather is the
    block. Autograd flows through every move.

    `trace`, when a list, receives one dict per entry: its mesh position,
    routed ids, dispatch slots, keep mask and capacity (the tests' view
    of the per-entry dispatch). Returns (y (B,S,D), aux)."""
    del fsdp_axis
    B, S, D = x.shape
    M = mesh.shape[model_axis]
    E = p["wg"].shape[0]
    if E % M:
        raise ValueError(f"{E} experts do not split over {M} model entries; "
                         f"build the model with ep={M}")
    rows = list(mesh.positions(tuple(batch_axes)))
    if B % len(rows):
        raise ValueError(f"batch {B} does not split over {len(rows)} data "
                         f"rows")
    B_loc = B // len(rows)
    ys, auxes = [], []
    for r, where in enumerate(rows):
        y, aux = _ep_row(cfg, p, x[r * B_loc:(r + 1) * B_loc], mesh, where,
                         model_axis, capacity_factor, trace)
        ys.append(y)
        auxes.append(aux)
    y = torch.cat(ys) if len(ys) > 1 else ys[0]
    # the reference's pmean over each batch axis in turn: every row holds
    # as many entries, so that is the mean over the rows
    aux = torch.stack(auxes).mean()
    if cfg.moe.num_shared_experts:
        y = y + _shared_expert(cfg, p, x.reshape(-1, D)).reshape(B, S, D)
    return y, aux

