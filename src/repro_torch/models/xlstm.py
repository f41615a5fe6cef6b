"""xLSTM blocks of the SSM family: mLSTM (matrix memory, chunkwise
parallel) and sLSTM (scalar memory, strictly recurrent), arXiv:2405.04517.

Mirrors the JAX package's `models/xlstm.py` at the same names, shapes and
parameter trees. The mLSTM block's full-sequence scan goes through
`kernels.ops.mlstm` (the Hopper kernel `mlstm_scan` for CUDA tensors, the
plain chunked form `ref.mlstm_chunked` for CPU tensors), which also
returns the final (C, n, m) state for the prefill's decode cache. The
decode step `mlstm_step` and the sLSTM recurrence `slstm_scan` are plain
PyTorch, as the JAX package runs them in XLA: the sLSTM input gates are
projected for the whole sequence before its loop, and each step is one
batched product (`baddbmm`) plus the elementwise math.

The prefill state is the token-by-token recurrence's at every sequence
length. (The JAX `mlstm_chunked` decays its final state over the padded
steps of a ragged last chunk; ROADMAP.md, queue 3.) Decode updates the
cache IN PLACE (the JAX version returns new arrays): the serving loop
decodes contiguous slots on a view of its pool and keeps no returned
cache.

The sequence-parallel mLSTM (`apply_mlstm_block_seqpar`) runs the
reference's `shard_map` body once per entry of the mesh's model axis, on
that entry's device: the token-local projections and conv on its
sequence shard (with the left neighbour's last W-1 raw tokens as the
conv's halo), a summary pass (`mlstm_state_summary`: the state its shard
reaches from zero, through `ops.mlstm`, the kernel on the card), the
combine of the summaries before it (`combine_mlstm_states`), and the
output pass seeded with that prefix state (`ops.mlstm(init_state=...)`,
the kernel again). The port's summary is the token recurrence's state at
every shard length; the reference's decays over the padding of a ragged
last chunk (ROADMAP.md, defects of the reference), so at ragged shards
the port's seqpar equals the port's unsharded block, not the reference's.

Stabilisation follows the paper: running log-max state m with
  m_t = max(logsig(f) + m_{t-1}, i_t)
  C_t = exp(logsig(f) + m_{t-1} - m_t) C_{t-1} + exp(i_t - m_t) v k^T
  h_t = (C_t q_t) / max(|n_t . q_t|, exp(-m_t))
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import apply_norm, silu
from repro_torch.models.param import Spec, tree_map
from repro_torch.models.ssm import _causal_conv

F32 = torch.float32


def mlstm_heads(cfg: ModelConfig):
    """(inner width di = expand d_model, heads H, head dim P = di / H)."""
    di = cfg.ssm.expand * cfg.d_model
    return di, cfg.num_heads, di // cfg.num_heads


# ---------------------------------------------------------------------------
# Cells
# ---------------------------------------------------------------------------
def mlstm_step(q, k, v, igate, fgate, state):
    """Decode step. q,k,v: (B,H,P); gates (B,H); state (C,n,m) ->
    (h (B,H,P) in q.dtype, new state (C,n,m) fp32)."""
    C, nvec, m = (s.to(F32) for s in state)
    scale = 1.0 / math.sqrt(q.shape[-1])
    qf = q.to(F32) * scale
    kf, vf = k.to(F32), v.to(F32)
    lf = F.logsigmoid(fgate.to(F32))
    ig = igate.to(F32)
    m_new = torch.maximum(lf + m, ig)
    w_old = torch.exp(lf + m - m_new)
    w_in = torch.exp(ig - m_new)
    C_new = w_old[..., None, None] * C + w_in[..., None, None] * \
        torch.einsum("bhp,bhr->bhpr", vf, kf)
    n_new = w_old[..., None] * nvec + w_in[..., None] * kf
    num = torch.einsum("bhpr,bhr->bhp", C_new, qf)
    den = torch.maximum(torch.einsum("bhp,bhp->bh", n_new, qf).abs(),
                        torch.exp(-m_new))
    h = (num / den[..., None]).to(q.dtype)
    return h, (C_new, n_new, m_new)


def slstm_scan(x_gates, r_weights, H: int, init_state=None):
    """x_gates: (B,S,4,H,P) input-driven gate preactivations (i,f,z,o);
    r_weights: (4,H,P,P) recurrent block-diagonal weights, applied as
    "bhp,ghpr->bghr" (p contracts, r is the output). Returns h (B,S,H,P)
    fp32 and the final state (h, c, n, m), each (B,H,P) fp32."""
    B, S, _, Hh, P = x_gates.shape
    dev = x_gates.device
    if init_state is None:
        h = torch.zeros((Hh, B, P), dtype=F32, device=dev)
        c = torch.zeros_like(h)
        n = torch.zeros_like(h)
        m = torch.full_like(h, -math.inf)
    else:
        h, c, n, m = (s.to(F32).transpose(0, 1) for s in init_state)
    # one batched product per step: per head (B, P) @ (P, 4P), the four
    # gates side by side in the output, added to the step's input gates
    rw = r_weights.to(F32).permute(1, 2, 0, 3).reshape(Hh, P, 4 * P)
    xg = x_gates.to(F32).permute(1, 3, 0, 2, 4).reshape(S, Hh, B, 4 * P)
    hs = []            # stacked at the end: an out= write has no backward
    for t in range(S):
        g = torch.baddbmm(xg[t], h, rw)                  # (H, B, 4P)
        it, ft, zt, ot = g.split(P, dim=-1)
        lf_m = F.logsigmoid(ft) + m
        m_new = torch.maximum(lf_m, it)
        i_p = torch.exp(it - m_new)
        f_p = torch.exp(lf_m - m_new)
        c = torch.addcmul(f_p * c, i_p, torch.tanh(zt))
        n = torch.addcmul(i_p, f_p, n)
        h = torch.sigmoid(ot) * c / torch.clamp(n, min=1.0)
        hs.append(h)
        m = m_new
    state = tuple(s.transpose(0, 1) for s in (h, c, n, m))
    return torch.stack(hs).permute(2, 0, 1, 3), state


# ---------------------------------------------------------------------------
# Block specs
# ---------------------------------------------------------------------------
def _ln_spec(d: int):
    return {"scale": Spec((d,), (None,), "ones"),
            "bias": Spec((d,), (None,), "zeros")}


def mlstm_block_spec(cfg: ModelConfig):
    d = cfg.d_model
    di, H, P = mlstm_heads(cfg)
    return {
        "norm": _ln_spec(d),
        "w_up": Spec((d, 2 * di), ("fsdp", "mlp")),
        "conv": Spec((cfg.ssm.conv_width, di), (None, "mlp")),
        "wq": Spec((di, H, P), ("mlp", "heads", None)),
        "wk": Spec((di, H, P), ("mlp", "heads", None)),
        "wv": Spec((di, H, P), ("mlp", "heads", None)),
        "w_if": Spec((di, 2, H), ("mlp", None, None)),
        "b_if": Spec((2, H), (None, None), "zeros"),
        "gn": Spec((di,), (None,), "ones"),
        "w_down": Spec((di, d), ("mlp", "fsdp"),
                       scale=1.0 / math.sqrt(2 * cfg.num_layers)),
    }


def slstm_block_spec(cfg: ModelConfig):
    d = cfg.d_model
    H = cfg.num_heads
    P = d // H
    ff = int(4 * d * 2 / 3)
    ff = ((ff + 63) // 64) * 64
    return {
        "norm": _ln_spec(d),
        "conv": Spec((cfg.ssm.conv_width, d), (None, None)),
        "w_gates": Spec((d, 4, H, P), (None, None, "heads", None)),
        "r_gates": Spec((4, H, P, P), (None, "heads", None, None),
                        scale=0.5),
        "b_gates": Spec((4, H, P), (None, "heads", None), "zeros"),
        "gn": Spec((d,), (None,), "ones"),
        "ffn": {"w_gate": Spec((d, ff), ("fsdp", "mlp")),
                "w_up": Spec((d, ff), ("fsdp", "mlp")),
                "w_down": Spec((ff, d), ("mlp", "fsdp"),
                               scale=1.0 / math.sqrt(2 * cfg.num_layers))},
    }


# ---------------------------------------------------------------------------
# Block applications
# ---------------------------------------------------------------------------
def _group_norm(p, h, dt):
    """The blocks' "group norm": one RMS over the whole width, eps 1e-6,
    scaled by p["gn"], in fp32."""
    hf = h.to(F32)
    return (hf * torch.rsqrt(hf.pow(2).mean(-1, keepdim=True) + 1e-6)
            * p["gn"].to(F32)).to(dt)


def _mlstm_up(cfg: ModelConfig, p, x):
    """Pre-norm and up-projection of an mLSTM block: (the conv's raw input
    ux_raw, the output gate's z), each (B,S,di)."""
    xin = apply_norm(cfg, p["norm"], x)
    return (xin @ p["w_up"].to(x.dtype)).chunk(2, dim=-1)


def _mlstm_proj(p, ux_raw, conv_cache=None):
    """The causal conv (its window's first W-1 rows from `conv_cache`,
    zeros when None) and the q, k, v and gate projections. Returns (q, k,
    v (B,S,H,P), ig, fg (B,S,H) views of one projection, the conv's new
    cache: its last W-1 raw inputs)."""
    dt = ux_raw.dtype
    ux, new_conv = _causal_conv(ux_raw, p["conv"], cache=conv_cache)
    ux = silu(ux)
    q = torch.einsum("bse,ehp->bshp", ux, p["wq"].to(dt))
    k = torch.einsum("bse,ehp->bshp", ux, p["wk"].to(dt))
    v = torch.einsum("bse,ehp->bshp", ux, p["wv"].to(dt))
    gates = torch.einsum("bse,egh->bsgh", ux, p["w_if"].to(dt)) \
        + p["b_if"].to(dt)
    return q, k, v, gates[:, :, 0], gates[:, :, 1], new_conv


def _mlstm_in(cfg: ModelConfig, p, x, conv_cache=None):
    """Pre-norm, up-projection, causal conv and the q, k, v and gate
    projections of an mLSTM block. Returns (q, k, v (B,S,H,P), ig, fg
    (B,S,H) views of one projection, z (B,S,di), the conv's new cache:
    its last W-1 raw inputs)."""
    ux_raw, z = _mlstm_up(cfg, p, x)
    q, k, v, ig, fg, new_conv = _mlstm_proj(p, ux_raw, conv_cache)
    return q, k, v, ig, fg, z, new_conv


def _mlstm_out(p, x, h, z):
    """Group norm, output gate, down-projection and residual."""
    B, S, di = z.shape
    dt = x.dtype
    h = _group_norm(p, h.reshape(B, S, di), dt) * silu(z)
    return x + h @ p["w_down"].to(dt)


def apply_mlstm_block(cfg: ModelConfig, p, x, *, chunk: int = 64,
                      cache=None, kernel_impl: str = "auto"):
    """Pre-LN mLSTM block. x: (B,S,D) -> (out, cache or None).

    Without a cache, the full sequence through `ops.mlstm(impl=
    kernel_impl)`. With a cache {"C","n","m","conv"} (x: (B,1,D)), one
    decode step whose new state and conv rows are written into the cache
    in place (cast to each leaf's dtype, as the JAX serving pool casts on
    write); the cache is returned."""
    conv_cache = None if cache is None else cache["conv"]
    q, k, v, ig, fg, z, new_conv = _mlstm_in(cfg, p, x, conv_cache)
    if cache is None:
        h = ops.mlstm(q, k, v, ig, fg, chunk=chunk, impl=kernel_impl)
        return _mlstm_out(p, x, h, z), None
    state = (cache["C"], cache["n"], cache["m"])
    h, (C, n, m) = mlstm_step(q[:, 0], k[:, 0], v[:, 0], ig[:, 0],
                              fg[:, 0], state)
    for name, new in (("C", C), ("n", n), ("m", m), ("conv", new_conv)):
        cache[name].copy_(new)
    return _mlstm_out(p, x, h[:, None], z), cache


def mlstm_block_states(cfg: ModelConfig, p, x, *, chunk: int = 64,
                       kernel_impl: str = "auto"):
    """Full-sequence mLSTM block that also returns the decode cache
    {"C" (B,H,P,P), "n" (B,H,P), "m" (B,H) fp32, "conv" (B,W-1,di) in x's
    dtype}."""
    q, k, v, ig, fg, z, conv = _mlstm_in(cfg, p, x)
    h, (C, n, m) = ops.mlstm(q, k, v, ig, fg, chunk=chunk, return_state=True,
                             impl=kernel_impl)
    return _mlstm_out(p, x, h, z), {"C": C, "n": n, "m": m, "conv": conv}


# ---------------------------------------------------------------------------
# Sequence-parallel mLSTM block
# ---------------------------------------------------------------------------
def mlstm_state_summary(k, v, igate, fgate, *, chunk: int = 64,
                        impl: str = "auto"):
    """State-only pass: the (C, n, m) state a zero-initialised mLSTM
    reaches after consuming the sequence, through `ops.mlstm(...,
    return_state=True)` (the kernel on the card; any q gives the same
    state, k stands in for it), and the total log-decay b_total (B,H), the
    sum of log sigmoid(f) over the steps. The per-shard summary of the
    sequence-parallel form. k, v: (B,S,H,P); gates: (B,S,H). Returns
    ((C, n, m), b_total), fp32."""
    _, state = ops.mlstm(k, k, v, igate, fgate, chunk=chunk,
                         return_state=True, impl=impl)
    return state, F.logsigmoid(fgate.to(F32)).sum(dim=1)


def combine_mlstm_states(s1, b2, s2):
    """Sequential combine: state s1, then a segment with total decay b2
    whose zero-initialised state is s2. All in the paper's log-max frame."""
    C1, n1, m1 = s1
    C2, n2, m2 = s2
    m_new = torch.maximum(b2 + m1, m2)
    m_new = torch.clamp(m_new, min=-1e30)        # both -inf: stay finite
    w1 = torch.exp(b2 + m1 - m_new)
    w2 = torch.exp(m2 - m_new)
    C = w1[..., None, None] * C1 + w2[..., None, None] * C2
    n = w1[..., None] * n1 + w2[..., None] * n2
    return (C, n, m_new)


def apply_mlstm_block_seqpar(cfg: ModelConfig, p, x, mesh, *,
                             seq_axis: str = "model",
                             batch_axes=("data",), chunk: int = 64,
                             want_state: bool = False,
                             kernel_impl: str = "auto"):
    """The mLSTM block sequence-parallel over `seq_axis` of `mesh`.

    x: (B,S,D) on its home device; the batch splits over `batch_axes`
    (one data row per position over them), the sequence into M equal
    shards over the seq axis. Per entry, on its device: the token-local
    norm, up-projection and gate projections of its shard, the causal
    conv with the left neighbour's last W-1 raw tokens as halo (zeros on
    entry 0), and the summary pass. The summaries are gathered and each
    entry takes the combine of the ones before it, in order from the zero
    state (a running combine passed from entry to entry: the reference's
    all_gather and masked scan give each entry this same sequence of
    combines). The output pass runs from that prefix
    (`ops.mlstm(init_state=...)`). `kernel_impl` goes to both passes.

    Returns out (B,S,D) on x's device, and with `want_state` also the
    full-sequence decode cache {"C","n","m","conv"} from the last entry:
    the state its seeded pass ends in, and its last W-1 raw tokens."""
    M = mesh.shape[seq_axis]
    W = cfg.ssm.conv_width
    B, S, D = x.shape
    rows = list(mesh.positions(tuple(batch_axes)))
    if B % len(rows) or S % M:
        raise ValueError(f"x {tuple(x.shape)} does not split into "
                         f"{len(rows)} data rows and {M} sequence shards")
    B_loc, S_loc = B // len(rows), S // M
    _, H, P = mlstm_heads(cfg)
    home = x.device
    outs, caches = [], []
    for r, where in enumerate(rows):
        devs = [mesh.device_at(**where, **{seq_axis: j}) for j in range(M)]
        xs = [x[r * B_loc:(r + 1) * B_loc, j * S_loc:(j + 1) * S_loc].to(d)
              for j, d in enumerate(devs)]
        ps = [tree_map(lambda t, d=d: t.to(d), p) for d in devs]
        ups = [_mlstm_up(cfg, pj, xj) for pj, xj in zip(ps, xs)]
        proj, summaries = [], []
        for j, dev in enumerate(devs):
            ux_raw = ups[j][0]
            # ppermute: the left neighbour's last W-1 raw tokens
            halo = (ux_raw.new_zeros((B_loc, W - 1, ux_raw.shape[-1]))
                    if j == 0 else ups[j - 1][0][:, -(W - 1):].to(dev))
            q, k, v, ig, fg, _ = _mlstm_proj(ps[j], ux_raw, halo)
            proj.append((q, k, v, ig, fg))
            summaries.append(mlstm_state_summary(k, v, ig, fg, chunk=chunk,
                                                 impl=kernel_impl))
        prefix = (torch.zeros((B_loc, H, P, P), dtype=F32, device=devs[0]),
                  torch.zeros((B_loc, H, P), dtype=F32, device=devs[0]),
                  torch.full((B_loc, H), -math.inf, dtype=F32,
                             device=devs[0]))
        row_out = []
        for j, dev in enumerate(devs):
            if j:
                (C, n, m), btot = summaries[j - 1]
                prefix = combine_mlstm_states(
                    tuple(t.to(dev) for t in prefix), btot.to(dev),
                    tuple(t.to(dev) for t in (C, n, m)))
            last = want_state and j == M - 1
            res = ops.mlstm(*proj[j], chunk=chunk, init_state=prefix,
                            return_state=last, impl=kernel_impl)
            h = res[0] if last else res
            row_out.append(_mlstm_out(ps[j], xs[j], h, ups[j][1]).to(home))
            if last:
                C, n, m = (t.to(home) for t in res[1])
                caches.append({"C": C, "n": n, "m": m,
                               "conv": ups[j][0][:, -(W - 1):].to(home)})
        outs.append(torch.cat(row_out, dim=1))
    out = torch.cat(outs) if len(outs) > 1 else outs[0]
    if not want_state:
        return out
    cache = caches[0] if len(caches) == 1 else {
        k: torch.cat([c[k] for c in caches]) for k in caches[0]}
    return out, cache


def _slstm_gates(cfg: ModelConfig, p, x, conv_cache=None):
    """Pre-norm, causal conv and the input gate preactivations
    (B,S,4,H,P): the conv feeds i and f, the normed input z and o (per
    the paper's Fig. 10). Returns (gates, the conv's new cache: its last
    W-1 inputs)."""
    dt = x.dtype
    xin = apply_norm(cfg, p["norm"], x)
    xc, new_conv = _causal_conv(xin, p["conv"], cache=conv_cache)
    xc = silu(xc)
    wg = p["w_gates"].to(dt)
    g_if = torch.einsum("bsd,dghp->bsghp", xc, wg[:, :2])
    g_zo = torch.einsum("bsd,dghp->bsghp", xin, wg[:, 2:])
    gates = torch.cat([g_if, g_zo], dim=2) + p["b_gates"].to(dt)
    return gates, new_conv


def _slstm_out(cfg: ModelConfig, p, x, hs):
    """Group norm and residual, then the gated FFN on the same pre-norm
    parameters."""
    B, S, D = x.shape
    dt = x.dtype
    x = x + _group_norm(p, hs.reshape(B, S, D).to(dt), dt)
    xin2 = apply_norm(cfg, p["norm"], x)
    f = p["ffn"]
    hh = silu(xin2 @ f["w_gate"].to(dt)) * (xin2 @ f["w_up"].to(dt))
    return x + hh @ f["w_down"].to(dt)


def apply_slstm_block(cfg: ModelConfig, p, x, *, cache=None):
    """Pre-LN sLSTM block + gated FFN. x: (B,S,D) -> (out, cache or None).
    With a cache {"h","c","n","m","conv"}, the scan starts from its state,
    and the new state and conv rows are written into it in place (cast to
    each leaf's dtype); the cache is returned."""
    conv_cache = None if cache is None else cache["conv"]
    gates, new_conv = _slstm_gates(cfg, p, x, conv_cache)
    state = None if cache is None else tuple(
        cache[k] for k in ("h", "c", "n", "m"))
    hs, new_state = slstm_scan(gates, p["r_gates"], cfg.num_heads,
                               init_state=state)
    out = _slstm_out(cfg, p, x, hs)
    if cache is None:
        return out, None
    for name, new in zip(("h", "c", "n", "m", "conv"),
                         new_state + (new_conv,)):
        cache[name].copy_(new)
    return out, cache


def slstm_block_states(cfg: ModelConfig, p, x):
    """Full-sequence sLSTM block that also returns the decode cache
    {"h","c","n","m" (B,H,P) fp32, "conv" (B,W-1,D) in x's dtype}."""
    gates, conv = _slstm_gates(cfg, p, x)
    hs, (h, c, n, m) = slstm_scan(gates, p["r_gates"], cfg.num_heads)
    return _slstm_out(cfg, p, x, hs), {"h": h, "c": c, "n": n, "m": m,
                                       "conv": conv}


# ---------------------------------------------------------------------------
# Decode caches
# ---------------------------------------------------------------------------
def mlstm_init_cache(cfg: ModelConfig, batch: int, dtype, device=None):
    """A fresh single-layer mLSTM cache: C, n zero and m = -inf in fp32,
    the conv rows zero in `dtype`."""
    di, H, P = mlstm_heads(cfg)
    return {"C": torch.zeros((batch, H, P, P), dtype=F32, device=device),
            "n": torch.zeros((batch, H, P), dtype=F32, device=device),
            "m": torch.full((batch, H), -math.inf, dtype=F32, device=device),
            "conv": torch.zeros((batch, cfg.ssm.conv_width - 1, di),
                                dtype=dtype, device=device)}


def slstm_init_cache(cfg: ModelConfig, batch: int, dtype, device=None):
    """A fresh single-layer sLSTM cache: h, c, n zero and m = -inf in
    fp32, the conv rows zero in `dtype`."""
    d, H = cfg.d_model, cfg.num_heads
    P = d // H
    z = {k: torch.zeros((batch, H, P), dtype=F32, device=device)
         for k in ("h", "c", "n")}
    z["m"] = torch.full((batch, H, P), -math.inf, dtype=F32, device=device)
    z["conv"] = torch.zeros((batch, cfg.ssm.conv_width - 1, d), dtype=dtype,
                            device=device)
    return z
