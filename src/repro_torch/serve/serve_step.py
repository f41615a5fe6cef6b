"""Serving step factories, as in the JAX package's `serve/serve_step.py`:
prefill (prompt -> cache + first token), decode (one token against a
static-capacity cache), the fleet decode (one token for lanes that
query different group models at different positions) and the encode step
of encoder-only archs (frames -> logits). Greedy sampling, argmax in
fp32.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from repro_torch.configs.base import HYBRID, MOE
from repro_torch.models import layers as L
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models import transformer as T
from repro_torch.models import xlstm as xlstm_lib
from repro_torch.models.model import Model
from repro_torch.models.param import tree_leaves, tree_map


def make_prefill_step(model: Model, cap: int, *, mesh=None, rules=None,
                      moe_impl: str = "dense", compute_dtype=torch.bfloat16,
                      ssm_impl: str = "gspmd"):
    def prefill_step(params, inputs):
        last_logits, cache, pos = model.prefill(
            params, inputs, cap, compute_dtype=compute_dtype, mesh=mesh,
            rules=rules, moe_impl=moe_impl, ssm_impl=ssm_impl)
        tok = last_logits.to(torch.float32).argmax(dim=-1)
        return tok, cache, pos

    return prefill_step


def make_decode_step(model: Model, *, mesh=None, rules=None,
                     moe_impl: str = "dense", compute_dtype=torch.bfloat16):
    def decode_step(params, token, cache, pos):
        logits, new_cache = model.decode(params, token, cache, pos,
                                         compute_dtype=compute_dtype,
                                         mesh=mesh, rules=rules,
                                         moe_impl=moe_impl)
        nxt = logits[:, -1].to(torch.float32).argmax(dim=-1)
        return nxt[:, None], new_cache

    return decode_step


def make_encode_step(model: Model, *, mesh=None, rules=None,
                     compute_dtype=torch.bfloat16):
    """Encoder-only archs: the full-sequence forward, returning logits."""
    def encode_step(params, inputs):
        logits, _ = model.apply(params, inputs, compute_dtype=compute_dtype,
                                mesh=mesh, rules=rules)
        return logits

    return encode_step


def make_fleet_decode_step(model: Model, *, compute_dtype=torch.bfloat16):
    """One decode step for a pool of slots that serve different models:
    each lane reads its own params row of a stacked per-group params tree
    and decodes at its own absolute position, so one step advances every
    active request of the fleet whatever group it queries and however far
    along it is.

    Returns fn(params_stack, rows, tokens, cache, pos, slots=None) ->
    (next (A,) int64 on the cache's device, cache):
      * params_stack — leaves (groups, ...), the serving store's stack
      * rows         — (A,) ints, the params row of each lane
      * tokens       — (A,) ints, each lane's last emitted token
      * cache        — a pool cache tree (leaves (layers, N, ...)), updated
                       in place
      * pos          — (A,) ints, each lane's absolute position
      * slots        — (A,) ints, each lane's row of the cache's N; None:
                       lane a is row a of a cache of exactly A rows, the
                       JAX step's contract
    rows, tokens, pos and slots are host sequences (lists or numpy).

    The JAX step gathers a whole params tree per lane and vmaps the B=1
    decode. Here the lanes are grouped by row, and each group's
    projections, MLP, norms and recurrent steps are products on a view of
    its row (no params copy); each global-attention layer makes ONE
    attention call over all lanes, each with its own key length
    (`layers.decode_attend`). Per-lane math is the B=1 decode's, so the
    tokens are those of decoding each slot alone (tests/test_torch_fleet_
    decode.py: exactly in fp32, under the lead rule in bf16). A MoE block
    routes each lane as the B=1 decode does, alone, where no pair drops
    (`moe.apply_moe_dropless`), not with the capacity of the group's
    lanes taken together."""
    def fleet_decode_step(params_stack, rows, tokens, cache, pos,
                          slots=None):
        logits, cache = fleet_decode_logits(
            model, params_stack, rows, tokens, cache, pos, slots,
            compute_dtype=compute_dtype)
        return logits[:, 0].to(torch.float32).argmax(dim=-1), cache

    return fleet_decode_step


def _group_spans(rows: np.ndarray
                 ) -> Tuple[np.ndarray, List[Tuple[int, int, int]]]:
    """Lane order grouped by params row (stable), and each group's (row,
    first, end) in that order."""
    order = np.argsort(rows, kind="stable")
    srt = rows[order]
    cut = np.flatnonzero(np.diff(srt)) + 1
    starts = np.concatenate([[0], cut]).astype(int)
    ends = np.concatenate([cut, [len(srt)]]).astype(int)
    return order, [(int(srt[a]), int(a), int(b))
                   for a, b in zip(starts, ends)]


def _lane_rows(tree, sel):
    """The cache rows `sel` of a layer's cache tree (leaves (N, ...)): a
    view for a slice, a copy for an index tensor; and the function that
    writes a copy back after an in-place step."""
    sub = tree_map(lambda c: c[sel], tree)
    if isinstance(sel, slice):
        return sub, lambda: None

    def write_back():
        for dst, src in zip(tree_leaves(tree), tree_leaves(sub)):
            dst[sel] = src
    return sub, write_back


def _cat(parts):
    return parts[0] if len(parts) == 1 else torch.cat(parts)


@torch.no_grad()
def fleet_decode_logits(model: Model, params_stack, rows, tokens, cache, pos,
                        slots=None, *, compute_dtype=torch.bfloat16):
    """The fleet step's logits (A, 1, V) in lane order, and the cache
    (updated in place); `make_fleet_decode_step` takes their argmax."""
    cfg = model.cfg
    rows = np.asarray(rows, np.int64)
    dev = tree_leaves(cache)[0].device
    N = tree_leaves(cache)[0].shape[1]
    slots = (np.arange(rows.shape[0]) if slots is None
             else np.asarray(slots, np.int64))
    order, spans = _group_spans(rows)
    s_slots = slots[order]
    # one upload for the tick: tokens, positions and cache rows in group
    # order
    lane = torch.as_tensor(np.stack([np.asarray(tokens, np.int64)[order],
                                     np.asarray(pos, np.int64)[order],
                                     s_slots]), device=dev)
    tok, lane_pos, lane_slot = lane[0], lane[1], lane[2]
    ln = L.lanes(lane_pos, lane_slot, N)
    # each group's cache rows: a slice where they are contiguous
    sel = []
    for _, a, b in spans:
        s = s_slots[a:b]
        sel.append(slice(int(s[0]), int(s[0]) + (b - a))
                   if np.array_equal(s, np.arange(s[0], s[0] + b - a))
                   else lane_slot[a:b])
    plan = T.layer_plan(cfg)
    group_params = [tree_map(lambda t, r=r: t[r], params_stack)
                    for r, _, _ in spans]
    layer_params = [[T._layers(gp["segments"][i], seg.count)
                     for i, seg in enumerate(plan)] for gp in group_params]

    x = _cat([L.embed_tokens(gp["embed"], tok[a:b, None], compute_dtype)
              for gp, (_, a, b) in zip(group_params, spans)])
    for si, seg in enumerate(plan):
        segc = cache["segments"][si]
        for li in range(seg.count):
            lc = T._layer(segc, li)
            lps = [lp[si][li] for lp in layer_params]
            if seg.kind == "block":
                x = _fleet_block(cfg, lps, spans, sel, x, lc, ln,
                                 window=seg.window)
            else:
                x = _fleet_recurrent(cfg, seg.kind, lps, spans, sel, x, lc)
    logits = _cat([
        L.unembed(cfg, gp["embed"],
                  L.apply_norm(cfg, gp["final_norm"], x[a:b]))
        for gp, (_, a, b) in zip(group_params, spans)])
    out = torch.empty_like(logits)
    out[torch.as_tensor(order, device=dev)] = logits
    return out, cache


def _fleet_block(cfg, lps, spans, sel, x, lc, ln, *, window):
    """One attention-family block over every lane: per group the norms,
    projections, qk-norm, Mamba step and MLP (or MoE) on its row's
    weights; RoPE (which reads no weights) and one attention call for all
    lanes."""
    hs, qkv = [], []
    for lp, (_, a, b) in zip(lps, spans):
        h = L.apply_norm(cfg, lp["ln1"], x[a:b])
        hs.append(h)
        q, k, v = (L._proj(h, lp["attn"][w]) for w in ("wq", "wk", "wv"))
        if cfg.qk_norm:
            q = L.rms_head_norm(q, lp["attn"]["q_norm"])
            k = L.rms_head_norm(k, lp["attn"]["k_norm"])
        qkv.append((q, k, v))
    q, k, v = (_cat([t[i] for t in qkv]) for i in range(3))
    if L.uses_rope(cfg):
        pos = ln.pos[:, None]
        q = L.apply_rope(q, pos, cfg.rope_theta)
        k = L.apply_rope(k, pos, cfg.rope_theta)
    o = L.decode_attend(q, k, v, lc, ln, window=window, meta=cfg.meta_tokens)
    outs = []
    for lp, h, s, (_, a, b) in zip(lps, hs, sel, spans):
        xg = x[a:b]
        attn_out = L._out_proj(L._mask_heads(cfg, o[a:b]),
                               lp["attn"]["wo"], xg.dtype)
        ssm_out = None
        if cfg.family == HYBRID:
            mc, write_back = _lane_rows(lc["mamba"], s)
            ssm_out, _ = ssm_lib.apply_mamba_step(cfg, lp["mamba"], h, mc)
            write_back()
        xg = T._mix(cfg, lp, xg, attn_out, ssm_out)
        h2 = L.apply_norm(cfg, lp["ln2"], xg)
        outs.append(xg + (moe_lib.apply_moe_dropless(cfg, lp["moe"], h2)
                          if cfg.family == MOE
                          else L.apply_mlp(cfg, lp["mlp"], h2)))
    return _cat(outs)


def _fleet_recurrent(cfg, kind, lps, spans, sel, x, lc):
    """One xLSTM block over every lane: per group its row's weights and its
    lanes' states."""
    step = (xlstm_lib.apply_mlstm_block if kind == "mlstm"
            else xlstm_lib.apply_slstm_block)
    outs = []
    for lp, s, (_, a, b) in zip(lps, sel, spans):
        sub, write_back = _lane_rows(lc, s)
        y, _ = step(cfg, lp, x[a:b], cache=sub)
        write_back()
        outs.append(y)
    return _cat(outs)
