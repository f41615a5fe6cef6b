"""The mamba_hybrid family (IBM Granite 4.0-H: granite-4.0-h-micro), written
from its published description (model_type granitemoehybrid):

* embedding: x = embedding_multiplier * E[tokens] (12);
* each layer one kind, attention at `attn_layers` and a Mamba-2 mixer
  elsewhere: x += residual_multiplier * Mixer(RMSNorm(x)), then
  x += residual_multiplier * W_down(silu(W_gate h) * W_up h), h = RMSNorm(x);
  every RMSNorm with eps 1e-5;
* attention: causal grouped-query softmax of q.k * attention_multiplier
  (1/64, not 1/sqrt(64)), no positional encoding (NoPE);
* Mamba-2 mixer: [z | xBC | dt] = h W_in; xBC = silu(depthwise causal conv
  of width 4 over xBC, plus its bias); x, B, C = xBC split (one B/C group);
  dt = softplus(dt + dt_bias); A = -exp(A_log); per head
  s_t = exp(dt_t A) s_{t-1} + dt_t x_t B_t^T and y_t = s_t C_t + D x_t,
  here in the quadratic form of `hybrid._ssd`; out = RMSNorm(y * silu(z))
  W_out over all d_inner channels;
* logits: RMSNorm(x) E^T / logits_scaling (8).

Departures from the published model: the benchmark's configuration runs
the first 20 of its 40 layers (two whole periods of the pattern, stage one
of a two-stage pipeline) and keeps the tied table as this stage's head so
that served tokens can be checked; weights are random. The scan's chunk
(the published mamba_chunk_size 256) does not enter: the quadratic form
is exact. Plain float32 PyTorch; nothing here imports the program.

The weight tree is the port's: `segments[k]` stacks a run of layers of
one kind, an attention run as {"ln1", "attn", "ln2", "mlp"}, a Mamba-2 run
as {"ln1", "mamba", "ln2", "mlp"} with "mamba" {"w_in", "conv", "conv_b",
"dt_bias", "A_log", "D", "norm", "w_out"}.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from bench.kernels.ssd_scan import ssd_cost
from bench.reference import common as C
from bench.reference.families.hybrid import _ssd

CHUNK = 64       # the program's scan chunk, for the scan's count


def _dims(cfg):
    """(d_inner, heads, head dim, state, conv channels)."""
    s = cfg["ssm"]
    di = s["expand"] * cfg["d_model"]
    P, N = s.get("head_dim", 64), s["state_dim"]
    return di, di // P, P, N, di + 2 * s.get("n_groups", 1) * N


def layers(cfg):
    """Per layer: (segment index, index in the segment, is attention)."""
    attn = set(cfg["attn_layers"])
    out, seg, i, prev = [], 0, 0, None
    for layer in range(cfg["num_layers"]):
        kind = layer in attn
        if prev is not None and kind != prev:
            seg, i = seg + 1, 0
        out.append((seg, i, kind))
        i += 1
        prev = kind
    return out


def _attention(cfg, p, h, quant):
    B, S, d = h.shape
    H, K = cfg["num_heads"], cfg["num_kv_heads"]
    hd = cfg.get("head_dim") or d // H
    q = C.mm(h, p["wq"].reshape(d, H * hd), quant).view(B, S, H, hd)
    k = C.mm(h, p["wk"].reshape(d, K * hd), quant).view(B, S, K, hd)
    v = C.mm(h, p["wv"].reshape(d, K * hd), quant).view(B, S, K, hd)
    k = k.repeat_interleave(H // K, dim=2)
    v = v.repeat_interleave(H // K, dim=2)
    s = torch.einsum("bshd,bthd->bhst", q, k) * cfg["attention_multiplier"]
    s = s.masked_fill(~C.visible(S, 0, 0, h.device), -float("inf"))
    o = torch.einsum("bhst,bthd->bshd", torch.softmax(s, dim=-1), v)
    return C.mm(o.reshape(B, S, H * hd), p["wo"].reshape(H * hd, d), quant)


def _mamba2(cfg, p, h, quant):
    B, S, _ = h.shape
    di, H, P, N, conv = _dims(cfg)
    zxbc = C.mm(h, p["w_in"], quant)
    z, xbc, dt = zxbc[..., :di], zxbc[..., di:di + conv], zxbc[..., di + conv:]
    W = p["conv"].shape[0]
    xp = F.pad(xbc, (0, 0, W - 1, 0))
    xbc = sum(xp[:, i:i + S] * p["conv"][i] for i in range(W))
    if "conv_b" in p:
        xbc = xbc + p["conv_b"]
    xbc = F.silu(xbc)
    x, Bm, Cm = xbc[..., :di], xbc[..., di:di + N], xbc[..., di + N:]
    dt = F.softplus(dt + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    y = torch.stack([_ssd(x[b].reshape(S, H, P), dt[b], A, Bm[b], Cm[b],
                          p["D"]) for b in range(B)]).reshape(B, S, di)
    g = y * F.silu(z)
    g = g * torch.rsqrt(g.pow(2).mean(-1, keepdim=True) + 1e-5) * p["norm"]
    return C.mm(g, p["w_out"], quant)


def hidden(cfg, params, tokens: torch.Tensor, quant: C.Quant = None):
    """The final-normed hidden states (B, S, d) of token ids (B, S)."""
    x = params["embed"]["table"][tokens].to(C.F32) \
        * cfg["embedding_multiplier"]
    rm = cfg["residual_multiplier"]
    for seg, i, attn in layers(cfg):
        p = C.pick(params["segments"][seg], i)
        h = C.norm(cfg, p["ln1"], x)
        x = x + rm * (_attention(cfg, p["attn"], h, quant) if attn
                      else _mamba2(cfg, p["mamba"], h, quant))
        x = x + rm * C.mlp(p["mlp"], C.norm(cfg, p["ln2"], x), quant)
    return C.final_norm(cfg, params, x)


def logits(cfg, params, h: torch.Tensor, quant: C.Quant = None):
    """The tied table's logits (padded rows left out), over
    logits_scaling."""
    return C.logits(cfg, params, h, quant) / cfg["logits_scaling"]


# -- operation counts (`bench.core.yardstick`): every weight product, the
# attention of the attention layers and the SSD scan of the others

def _layer_weights(cfg, attn: bool) -> int:
    d, H, K = cfg["d_model"], cfg["num_heads"], cfg["num_kv_heads"]
    hd = cfg.get("head_dim") or d // H
    n = 3 * d * cfg["d_ff"]
    if attn:
        return n + d * (H + 2 * K) * hd + H * hd * d
    di, heads, _, _, conv = _dims(cfg)
    return n + d * (di + conv + heads) + di * d


def _attn_layers(cfg) -> int:
    return sum(1 for _, _, a in layers(cfg) if a)


def matmul_params(cfg) -> int:
    return sum(_layer_weights(cfg, a) for _, _, a in layers(cfg)) \
        + cfg["d_model"] * C.padded_vocab(cfg["vocab_size"])


def forward_flops(cfg, batch: int, seq: int, logit_rows=None) -> float:
    d, H = cfg["d_model"], cfg["num_heads"]
    hd = cfg.get("head_dim") or d // H
    vd = d * C.padded_vocab(cfg["vocab_size"])
    rows = seq if logit_rows is None else logit_rows
    g = _attn_layers(cfg)
    di, heads, P, N, _ = _dims(cfg)
    return (2.0 * batch * seq * (matmul_params(cfg) - vd)
            + 2.0 * batch * rows * vd
            + g * 4.0 * batch * H * hd * (seq * (seq + 1) // 2)
            + (cfg["num_layers"] - g)
            * ssd_cost(batch, seq, heads, P, N, CHUNK)[1])


def decode_flops(cfg, positions) -> float:
    """Every weight product, attention over each lane's keys in the
    attention layers, and per Mamba-2 layer the state update and its read
    (2 H P N multiply-adds a lane)."""
    d, H = cfg["d_model"], cfg["num_heads"]
    hd = cfg.get("head_dim") or d // H
    g = _attn_layers(cfg)
    _, heads, P, N, _ = _dims(cfg)
    flops = 2.0 * len(positions) * matmul_params(cfg)
    flops += (cfg["num_layers"] - g) * 4.0 * heads * P * N * len(positions)
    return flops + sum(g * 4.0 * H * hd * (p + 1) for p in positions)
