"""Serving step factories, as in the JAX package's `serve/serve_step.py`:
prefill (prompt -> cache + first token), decode (one token against a
static-capacity cache), the fleet decode (one token for lanes that
query different group models at different positions) and the encode step
of encoder-only archs (frames -> logits). Greedy sampling, argmax in
fp32.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch import tracing
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

    Returns a `FleetDecodeStep`, fn(params_stack, rows, tokens, cache, pos,
    slots=None, groups=None) -> (next (A,) int64 on the cache's device,
    cache):
      * params_stack — leaves (groups, ...), the serving store's stack
      * rows         — (A,) ints, the params row of each lane
      * tokens       — (A,) ints, each lane's last emitted token
      * cache        — a pool cache tree (leaves (layers, N, ...)), updated
                       in place
      * pos          — (A,) ints, each lane's absolute position
      * slots        — (A,) ints, each lane's row of the cache's N; None:
                       lane a is row a of a cache of exactly A rows, the
                       JAX step's contract
      * groups       — the params rows the step computes, a superset of
                       `rows` (the plane passes the store's live rows, so
                       that the set stays fixed while lanes come and go);
                       None: the lanes' own rows
    rows, tokens, pos, slots and groups are host sequences (lists, ranges
    or numpy).

    The JAX step gathers a whole params tree per lane and vmaps the B=1
    decode. Here each global-attention layer makes ONE attention call over
    the whole pool, each row with its own key length
    (`layers.decode_attend`), and the weights are read in one of two
    layouts, chosen from the model's layer plan (`pool_wide`):
      * pool-wide (every segment a global-attention block or Mamba-2
        mixers, the family neither MoE nor hybrid: olmo, the registry's
        other dense attention families, and granite-4.0-h's mamba_hybrid
        family): every row of the pool decodes, in slot order,
        whether or not a lane holds it. Each group of `groups` runs its
        norms, projections, out-projection, MLP and head over all N rows,
        and each row takes its own group's result through `torch.where` on
        its params row, so another group's values never enter it, finite or
        not. A row without a lane has key length 0 and writes its K/V into
        its own free row. A Mamba-2 layer steps every row's state once,
        each row with its own group's A and D, after each group's
        in-projection and conv over all rows; a row without a lane steps
        its free row's state, which its next prefill overwrites. At decode
        a group's GEMM over N <= 64 rows is
        bound by reading the group's weights once, so the rows of the other
        groups cost about nothing; in exchange every shape is fixed by the
        pool and the groups, and on the card the step is captured as CUDA
        graphs and replayed (`_PoolGraphs`). On the CPU the same ops run
        one by one.
      * grouped (MoE, whose `moe.apply_moe_dropless` sizes its dispatch by
        the lanes it is given; hybrid, whose Mamba step writes its state
        rows per group; xLSTM's recurrent blocks likewise; windowed rings):
        the lanes are grouped by row, and each group's projections, MLP,
        norms and recurrent steps are products on a view of its row (no
        params copy), eagerly.
    Per-lane math is the B=1 decode's, so the tokens are those of decoding
    each slot alone (tests/test_torch_fleet_decode.py: exactly in fp32,
    under the lead rule in bf16). A MoE block routes each lane as the B=1
    decode does, alone, where no pair drops (`moe.apply_moe_dropless`),
    not with the capacity of the group's lanes taken together."""
    return FleetDecodeStep(model, compute_dtype)


def pool_wide(cfg) -> bool:
    """Whether the fleet step decodes the whole pool in slot order (every
    segment a global-attention block or Mamba-2 mixers, the family neither
    MoE nor hybrid; so never for the xLSTM family, whose recurrent blocks
    step per group) rather than grouping the lanes by params row."""
    return cfg.family not in (MOE, HYBRID) and all(
        (seg.kind == "block" and seg.window <= 0) or seg.kind == "mamba2"
        for seg in T.layer_plan(cfg))


class FleetDecodeStep:
    """The fleet decode step (`make_fleet_decode_step`). `graphed` says
    whether its last call replayed CUDA graphs, `captures` how many sets
    of graphs it has captured.

    A pool-wide step on the card captures its graphs at the first call for
    a key: the groups, and the identity of every tensor of the params
    stack and of the cache. That call runs op by op on a side stream (the
    warm-up a capture needs) and is not graphed; the calls after it replay.
    A store that grows or reallocates, or a change of groups, gives a new
    key: the old graphs, and the tensors they read, are dropped and the
    step captures again. An install into an existing row writes in place,
    so the graphs serve the new weights."""

    def __init__(self, model: Model, compute_dtype=torch.bfloat16):
        self.model = model
        self.compute_dtype = compute_dtype
        self.pool_wide = pool_wide(model.cfg)
        self.graphed = False
        self.captures = 0
        self._graphs: Optional[_PoolGraphs] = None
        self._stream = None

    @torch.no_grad()
    def __call__(self, params_stack, rows, tokens, cache, pos, slots=None,
                 groups=None):
        self.graphed = False
        if not (self.pool_wide and tree_leaves(cache)[0].is_cuda):
            logits, cache = fleet_decode_logits(
                self.model, params_stack, rows, tokens, cache, pos, slots,
                compute_dtype=self.compute_dtype, groups=groups)
            return logits[:, 0].to(torch.float32).argmax(dim=-1), cache
        groups = _groups(rows, groups)
        up = _pool_inputs(rows, tokens, pos, slots, cache)
        lanes = up[4, :len(rows)]
        g = self._graphs
        if g is not None and g.serves(groups, params_stack, cache):
            self.graphed = True
            return g.replay(up)[lanes], cache
        self._graphs = None
        return self._capture(params_stack, groups, cache, up)[lanes], cache

    def _capture(self, params_stack, groups, cache, up):
        """The first call for a key: the tick op by op on a side stream,
        then its graphs captured there. Returns the tick's argmax."""
        dev = up.device
        if self._stream is None:
            self._stream = torch.cuda.Stream(dev)
        main = torch.cuda.current_stream(dev)
        self._stream.wait_stream(main)
        with torch.cuda.stream(self._stream):
            s = _pool_eager(self.model, params_stack, groups, cache, up,
                            self.compute_dtype)
            with tracing.span("ecco.tick.capture"):
                self._graphs = _PoolGraphs(self.model, params_stack, groups,
                                           cache, self.compute_dtype)
        main.wait_stream(self._stream)
        self.captures += 1
        return s.next


def _groups(rows, groups) -> Tuple[int, ...]:
    have = {int(r) for r in rows}
    if groups is None:
        return tuple(sorted(have))
    groups = tuple(int(g) for g in groups)
    if not have <= set(groups):
        raise ValueError(f"lanes' params rows {sorted(have - set(groups))} "
                         f"are not among groups {groups}")
    return groups


def _pool_inputs(rows, tokens, pos, slots, cache):
    """A pool-wide tick's inputs in one upload, (5, N) int64 on the cache's
    device, by cache row: the token, the position, the params row (-1
    where no lane sits), the keys the row attends to (position + 1; 0
    where no lane sits), and in the first A entries the lanes' cache
    rows."""
    leaf = tree_leaves(cache)[0]
    A = len(rows)
    slots = np.arange(A) if slots is None else np.asarray(slots, np.int64)
    host = np.zeros((5, leaf.shape[1]), np.int64)
    host[2] = -1
    host[0, slots] = np.asarray(tokens, np.int64)
    host[1, slots] = np.asarray(pos, np.int64)
    host[2, slots] = np.asarray(rows, np.int64)
    host[3, slots] = host[1, slots] + 1
    host[4, :A] = slots
    return torch.as_tensor(host, device=leaf.device)


class _Pool:
    """What the stages of a pool-wide decode hand each other: the tick's
    `inputs` by cache row (`tok`, `pos`, `rows`), the masks that pick the
    rows of each group after the first, the residual stream `x`, the
    projections of the layer in flight `qkv`, its attention's output `o`,
    and at the end the `logits` and their argmax `next`."""

    def __init__(self, inputs, groups):
        self.inputs = inputs
        self.tok, self.pos, self.rows = inputs[0], inputs[1], inputs[2]
        self.groups = groups
        self.masks = self.x = self.qkv = self.o = None
        self.logits = self.next = None

    def select(self, vals):
        """Each row's entry of its own group's value (`vals` in the order
        of `groups`)."""
        out = vals[0]
        for m, v in zip(self.masks, vals[1:]):
            out = torch.where(m.view((-1,) + (1,) * (v.dim() - 1)), v, out)
        return out


def _pool_params(model, params_stack, groups, cache):
    """Each group's params tree (views of its row), and per layer in plan
    order (its kind, each group's layer params, the layer's cache)."""
    gps = [tree_map(lambda t, r=r: t[r], params_stack) for r in groups]
    layers = []
    for si, seg in enumerate(T.layer_plan(model.cfg)):
        lps = [T._layers(gp["segments"][si], seg.count) for gp in gps]
        for li in range(seg.count):
            layers.append((seg.kind, [lp[li] for lp in lps],
                           T._layer(cache["segments"][si], li)))
    return gps, layers


def _norms(cfg, ps, x):
    """Each group's norm of x (`ps`: each group's norm params); computed
    once where the norm has no weights."""
    if not tree_leaves(ps[0]):
        return [L.apply_norm(cfg, ps[0], x)] * len(ps)
    return [L.apply_norm(cfg, p, x) for p in ps]


def _pool_embed(cfg, s, gps, dtype):
    s.masks = [s.rows == g for g in s.groups[1:]]
    s.x = s.select([L.embed(cfg, gp["embed"], s.tok[:, None], dtype)
                    for gp in gps])


def _pool_pre(cfg, s, lps):
    """A layer up to its attention: each group's norm, projections and
    qk-norm, each row's own, and RoPE at each row's position."""
    qkv = []
    for lp, h in zip(lps, _norms(cfg, [lp["ln1"] for lp in lps], s.x)):
        a = lp["attn"]
        q, k, v = (L._proj(h, a[w]) for w in ("wq", "wk", "wv"))
        if cfg.qk_norm:
            q = L.rms_head_norm(q, a["q_norm"])
            k = L.rms_head_norm(k, a["k_norm"])
        qkv.append((q, k, v))
    q, k, v = (s.select([t[i] for t in qkv]) for i in range(3))
    if L.uses_rope(cfg):
        q = L.apply_rope(q, s.pos[:, None], cfg.rope_theta)
        k = L.apply_rope(k, s.pos[:, None], cfg.rope_theta)
    s.qkv = (L.scale_queries(cfg, q), k, v)


def _pool_attend(qkv, lc, ln):
    """Each row's K/V written into its own cache row at its position, and
    one attention call over the whole pool, each row over its own keys
    (none where no lane sits: its output is 0)."""
    return L.decode_attend(*qkv, lc, ln, window=0, meta=0)


def _pool_post(cfg, s, lps):
    """A layer after its attention: each group's out-projection and MLP,
    each row's own, added to the residual stream."""
    o = L._mask_heads(cfg, s.o)
    _pool_mlp(cfg, s, lps, T._residual(cfg, s.x, s.select([
        L._out_proj(o, lp["attn"]["wo"], s.x.dtype) for lp in lps])))


def _pool_mlp(cfg, s, lps, x):
    """x plus each group's MLP of its norm, each row's own, as the
    residual stream."""
    hs = _norms(cfg, [lp["ln2"] for lp in lps], x)
    s.x = T._residual(cfg, x, s.select([L.apply_mlp(cfg, lp["mlp"], h)
                                        for lp, h in zip(lps, hs)]))


def _pool_mamba2(cfg, s, lps, lc):
    """A Mamba-2 layer over every row, under the span `ecco.tick.mamba`:
    each group's norm, in-projection and conv, each row's own; one state
    step with each row's own A and D, its conv rows and state written in
    place; each group's gated norm, out-projection and MLP, each row's
    own (`ssm.apply_mamba2_step` and `transformer.mamba2_layer` per
    row)."""
    with tracing.span("ecco.tick.mamba"):
        hs = _norms(cfg, [lp["ln1"] for lp in lps], s.x)
        ins = [ssm_lib._mamba2_in(cfg, lp["mamba"], h, lc["conv"])
               for lp, h in zip(lps, hs)]
        z, xs, Bm, Cm, dt, conv = (s.select([t[i] for t in ins])
                                   for i in range(6))
        rows = s.x.shape[0]
        A = s.select([-torch.exp(lp["mamba"]["A_log"].float()).expand(
            rows, -1) for lp in lps])
        D = s.select([lp["mamba"]["D"].expand(rows, -1) for lp in lps])
        y, state = ssm_lib.ssd_step(xs[:, 0], dt[:, 0], A, Bm[:, 0],
                                    Cm[:, 0], D, lc["state"])
        lc["conv"].copy_(conv)
        lc["state"].copy_(state)
        y = y.flatten(-2)[:, None]
        x = T._residual(cfg, s.x, s.select([
            ssm_lib._mamba2_out(lp["mamba"], y, z) for lp in lps]))
    _pool_mlp(cfg, s, lps, x)


def _pool_pieces(cfg, s, gps, layers, compute_dtype):
    """The tick as the pieces between its attention calls, and each global
    layer's cache: a piece runs up to the next global layer's projections
    (`_pool_pre`), that layer's attention runs between two pieces, and the
    next piece starts with its out-projection (`_pool_post`); Mamba-2
    layers lie inside the pieces, the embedding in the first, the head in
    the last."""
    pieces, caches = [], []
    steps = [lambda: _pool_embed(cfg, s, gps, compute_dtype)]
    for kind, lps, lc in layers:
        if kind == "mamba2":
            steps.append(lambda lps=lps, lc=lc: _pool_mamba2(cfg, s, lps, lc))
            continue
        steps.append(lambda lps=lps: _pool_pre(cfg, s, lps))
        pieces.append(steps)
        caches.append(lc)
        steps = [lambda lps=lps: _pool_post(cfg, s, lps)]
    steps.append(lambda: _pool_head(cfg, s, gps))
    pieces.append(steps)
    return [lambda st=st: [f() for f in st] for st in pieces], caches


def _pool_head(cfg, s, gps):
    hs = _norms(cfg, [gp["final_norm"] for gp in gps], s.x)
    s.logits = s.select([L.unembed(cfg, gp["embed"], h)
                         for gp, h in zip(gps, hs)])
    s.next = s.logits[:, 0].to(torch.float32).argmax(dim=-1)


def _pool_lanes(s, up):
    """The tick's `layers.Lanes`: row r is lane r, at the position `s`
    holds, over a `lengths` tensor of the tick's own (a wrapper of the
    attention may keep it)."""
    return L.Lanes(s.pos, None, up[3].to(torch.int32))


def _pool_eager(model, params_stack, groups, cache, up, compute_dtype):
    """The pool-wide step op by op (`up`: `_pool_inputs`)."""
    cfg = model.cfg
    s = _Pool(up[:3], groups)
    ln = _pool_lanes(s, up)
    gps, layers = _pool_params(model, params_stack, groups, cache)
    pieces, caches = _pool_pieces(cfg, s, gps, layers, compute_dtype)
    with tracing.span("ecco.tick.layers"):
        for piece, lc in zip(pieces, caches):
            piece()
            s.o = _pool_attend(s.qkv, lc, ln)
        pieces[-1]()
    return s


class _PoolGraphs:
    """The pool-wide step for one key as CUDA graphs, one a piece between
    two attention calls (`_pool_pieces`): the embedding and the layers up
    to the first global layer's attention; a global layer's out-projection
    and MLP with the layers up to the next one's attention; the last, the
    final norm, the unembedding and the argmax. All share one memory pool,
    and read the tick's inputs from one static buffer.

    The K/V writes and the attention run between the replays, eagerly
    (`layers.decode_attend`): the kernel's launches stay visible to its
    wrapper (`flash_attention.launches` and whatever wraps
    `kernels.ops._flash` count one per global layer a tick, as before),
    and each call takes the tick's own `lengths` tensor. Its output is
    copied into the buffer the next graph reads."""

    def __init__(self, model, params_stack, groups, cache, compute_dtype):
        cfg = model.cfg
        leaf = tree_leaves(cache)[0]
        self.key = (groups, tree_leaves(params_stack), tree_leaves(cache))
        s = self.s = _Pool(torch.zeros((3, leaf.shape[1]), dtype=torch.int64,
                                       device=leaf.device), groups)
        gps, layers = _pool_params(model, params_stack, groups, cache)
        pieces, self.caches = _pool_pieces(cfg, s, gps, layers,
                                           compute_dtype)
        pool = torch.cuda.graph_pool_handle()
        self.graphs, self.qkvs = [], []
        for piece in pieces:
            g = torch.cuda.CUDAGraph()
            g.capture_begin(pool=pool)
            try:
                piece()
            finally:
                g.capture_end()
            self.graphs.append(g)
            if len(self.qkvs) < len(self.caches):
                self.qkvs.append(s.qkv)
                if s.o is None:
                    s.o = torch.empty_like(s.qkv[0])

    def serves(self, groups, params_stack, cache) -> bool:
        g, p, c = self.key
        return g == groups and _same(p, tree_leaves(params_stack)) \
            and _same(c, tree_leaves(cache))

    def replay(self, up):
        """One tick (`up`: `_pool_inputs`); returns the argmax of every
        row, a buffer that the next replay overwrites."""
        s = self.s
        s.inputs.copy_(up[:3])
        ln = _pool_lanes(s, up)
        with tracing.span("ecco.tick.layers"):
            for g, qkv, lc in zip(self.graphs, self.qkvs, self.caches):
                g.replay()
                s.o.copy_(_pool_attend(qkv, lc, ln))
            self.graphs[-1].replay()
        return s.next


def _same(a, b) -> bool:
    return len(a) == len(b) and all(x is y for x, y in zip(a, b))


@torch.no_grad()
def fleet_decode_logits(model: Model, params_stack, rows, tokens, cache, pos,
                        slots=None, *, compute_dtype=torch.bfloat16,
                        groups=None):
    """The fleet step's logits (A, 1, V) in lane order, and the cache
    (updated in place), op by op in the step's layout (`pool_wide`);
    `make_fleet_decode_step` takes their argmax."""
    if not pool_wide(model.cfg):
        return _grouped_logits(model, params_stack, rows, tokens, cache, pos,
                               slots, compute_dtype=compute_dtype)
    up = _pool_inputs(rows, tokens, pos, slots, cache)
    s = _pool_eager(model, params_stack, _groups(rows, groups), cache, up,
                    compute_dtype)
    return s.logits[up[4, :len(rows)]], cache


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


def _grouped_logits(model: Model, params_stack, rows, tokens, cache, pos,
                    slots=None, *, compute_dtype=torch.bfloat16):
    """The grouped layout's logits (A, 1, V) in lane order, and the cache
    (updated in place)."""
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

    x = _cat([L.embed(cfg, gp["embed"], tok[a:b, None], compute_dtype)
              for gp, (_, a, b) in zip(group_params, spans)])
    with tracing.span("ecco.tick.layers"):
        for si, seg in enumerate(plan):
            segc = cache["segments"][si]
            for li in range(seg.count):
                lc = T._layer(segc, li)
                lps = [lp[si][li] for lp in layer_params]
                if seg.kind == "block":
                    x = _fleet_block(cfg, lps, spans, sel, x, lc, ln,
                                     window=seg.window)
                else:
                    x = _fleet_recurrent(cfg, seg.kind, lps, spans, sel, x,
                                         lc)
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
    o = L.decode_attend(L.scale_queries(cfg, q), k, v, lc, ln,
                        window=window, meta=cfg.meta_tokens)
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
        outs.append(T._residual(cfg, xg, (
            moe_lib.apply_moe_dropless(cfg, lp["moe"], h2)
            if cfg.family == MOE else L.apply_mlp(cfg, lp["mlp"], h2))))
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
