"""The reference's expert-parallel MoE, entry by entry, from its own pure
functions (`repro.models.moe._route`, `_dispatch_slots`, `_expert_ffn`,
`_shared_expert`), without a device mesh.

`apply_moe_ep` in the JAX package runs one `shard_map` body per entry of
a (data, model) mesh; this module runs that body's steps for each entry
in turn on the CPU's one device: the token slice, the routing, the EP
capacity max(1, ceil(t_m k / E cf)), the (E, C, D) send buffer, the
all_to_all (entry i receives block i of every source), the local
experts, the all_to_all back, the combine, the all_gather over the model
axis and the aux means. The port's tests hold `repro_torch.models.moe.
apply_moe_ep` to it.
"""
import functools
import math

import jax
import jax.numpy as jnp

from repro.models import moe as jmoe


def oracle_ep(cfg, p, x, data: int, model: int, capacity_factor: float,
              trace=None):
    """x: (B,S,D) jnp. Returns (y (B,S,D), aux); `trace`, when a list,
    receives each entry's {"data", "model", "ids", "slot", "keep",
    "capacity"} in row-major order. Compiled once per configuration."""
    y, aux, entries = _oracle(cfg, p, x, data, model, capacity_factor)
    if trace is not None:
        t_m = max(1, -(-(x.shape[0] // data) * x.shape[1] // model))
        C = ep_capacity(cfg, t_m, p["wg"].shape[0], capacity_factor)
        for i, (ids, slot, keep) in enumerate(entries):
            trace.append({"data": i // model, "model": i % model, "ids": ids,
                          "slot": slot, "keep": keep, "capacity": C})
    return y, aux


def ep_capacity(cfg, t_m, E, capacity_factor):
    return max(1, int(math.ceil(t_m * cfg.moe.top_k / E * capacity_factor)))


@functools.partial(jax.jit, static_argnums=(0, 3, 4, 5))
def _oracle(cfg, p, x, data, model, capacity_factor):
    trace = []
    m = cfg.moe
    B, S, D = x.shape
    M = model
    E = p["wg"].shape[0]
    E_loc = E // M
    B_loc = B // data
    ys, row_aux = [], []
    for r in range(data):
        x_loc = x[r * B_loc:(r + 1) * B_loc]
        t_all = B_loc * S
        x2d = x_loc.reshape(t_all, D)
        t_m = max(1, -(-t_all // M))
        pad = t_m * M - t_all
        if pad:
            x2d = jnp.concatenate([x2d, jnp.zeros((pad, D), x2d.dtype)], 0)
        C = ep_capacity(cfg, t_m, E, capacity_factor)
        sends, routes, auxes = [], [], []
        for j in range(M):
            xm = x2d[j * t_m:(j + 1) * t_m]
            tok_valid = j * t_m + jnp.arange(t_m) < t_all
            top_w, top_ids, aux = jmoe._route(cfg, {"router": p["router"]},
                                              xm)
            slot, keep = jmoe._dispatch_slots(top_ids, E, C)
            keep = keep & tok_valid[:, None]
            sbuf = jnp.zeros((E, C, D), x.dtype)
            safe = jnp.where(keep, slot, C - 1)
            upd = jnp.where(keep[..., None], xm[jnp.broadcast_to(
                jnp.arange(t_m)[:, None], top_ids.shape)], 0).reshape(-1, D)
            sbuf = sbuf.at[top_ids.reshape(-1), safe.reshape(-1)].add(
                upd, mode="drop")
            sends.append(sbuf.reshape(M, E_loc, C, D))
            routes.append((top_w, top_ids, safe, keep))
            auxes.append(aux)
            trace.append((top_ids, slot, keep))
        ybufs = []
        for i in range(M):
            rbuf = jnp.stack([sends[j][i] for j in range(M)])
            rbuf = rbuf.transpose(1, 0, 2, 3).reshape(E_loc, M * C, D)
            lo, hi = i * E_loc, (i + 1) * E_loc
            yb = jmoe._expert_ffn(cfg, p["wg"][lo:hi], p["wu"][lo:hi],
                                  p["wd"][lo:hi], rbuf)
            ybufs.append(yb.reshape(E_loc, M, C, D).transpose(1, 0, 2, 3))
        ym = []
        for j in range(M):
            back = jnp.stack([ybufs[i][j] for i in range(M)]).reshape(E, C, D)
            top_w, top_ids, safe, keep = routes[j]
            yp = back[top_ids.reshape(-1), safe.reshape(-1)]
            yp = jnp.where(keep.reshape(-1)[:, None], yp, 0)
            yp = yp.reshape(t_m, m.top_k, D)
            ym.append(jnp.sum(yp * top_w[..., None].astype(x.dtype), axis=1))
        ys.append(jnp.concatenate(ym)[:t_all].reshape(x_loc.shape))
        row_aux.append(jnp.mean(jnp.stack(auxes)))
    y = jnp.concatenate(ys, 0)
    aux = jnp.mean(jnp.stack(row_aux))
    if m.num_shared_experts:
        y = y + jmoe._shared_expert(cfg, p, x.reshape(-1, D)).reshape(B, S, D)
    return y, aux, trace


def patched_apply_moe_ep(cfg, p, x, mesh, *, capacity_factor=1.25,
                         batch_axes=("data",), fsdp_axis="data",
                         model_axis="model"):
    """`oracle_ep` under the reference's `apply_moe_ep` signature, for a
    shape-only mesh with one batch axis ("data") or none: what the
    reference's model forward calls when monkeypatched in."""
    data = mesh.shape.get("data", 1) if batch_axes else 1
    return oracle_ep(cfg, p, x, data, mesh.shape[model_axis],
                     capacity_factor)
