"""The hybrid (Hymba), written from its published description: learned
meta tokens prepended to every sequence; per layer attention and a
Mamba-2 head group run side by side on the same normed input, each output
RMS-normed and scaled, their mean added to the residual, then a SwiGLU
MLP; attention is causal over all keys in the global layers and over a
sliding window plus the meta tokens in the others; the SSD scan is
computed in its quadratic (attention-like) form in float32 with the
cumulative decays summed in float64. The unembedding is `common.logits`;
the operation counts are the plain decoder's of `common` with the Mamba
projections and the SSD scan's operations added."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from bench.kernels.ssd_scan import ssd_cost
from bench.reference import common as C


def _ssm(cfg):
    """(d_inner, heads) of the Mamba mixer: heads of 64."""
    di = cfg["ssm"]["expand"] * cfg["d_model"]
    return di, max(1, di // 64)


def matmul_params(cfg) -> int:
    d = cfg["d_model"]
    di, heads = _ssm(cfg)
    return C.decoder_params(cfg, d * 2 * di + di * 2 * cfg["ssm"]["state_dim"]
                            + di * heads + di * d)


def forward_flops(cfg, batch: int, seq: int, logit_rows=None) -> float:
    di, heads = _ssm(cfg)
    S = seq + cfg.get("meta_tokens", 0)
    return C.decoder_forward_flops(cfg, matmul_params(cfg), batch, seq,
                                   logit_rows) + cfg["num_layers"] * ssd_cost(
        batch, S, heads, di // heads, cfg["ssm"]["state_dim"], 64)[1]


def decode_flops(cfg, positions) -> float:
    return C.decoder_decode_flops(cfg, matmul_params(cfg), positions)


def _ssd(x, dt, A, Bm, Cm, D):
    """y_t = sum_{s<=t} (C_t . B_s) exp(sum_{r=s+1..t} dt_r A) dt_s x_s
    + D x_t per head, one sequence: x (S, H, P), dt (S, H), Bm, Cm
    (S, N)."""
    S = x.shape[0]
    cum = torch.cumsum(dt.double() * A.double(), dim=0)     # (S, H)
    seg = (cum[:, None, :] - cum[None, :, :]).permute(2, 0, 1)  # (H, t, s)
    causal = torch.ones(S, S, dtype=torch.bool, device=x.device).tril()
    decay = torch.exp(seg.masked_fill(~causal, -math.inf)).to(C.F32)
    w = decay * (Cm @ Bm.T)[None] * dt.T[:, None, :]        # (H, t, s)
    return torch.einsum("hts,shp->thp", w, x) + x * D[None, :, None]


def _mamba(cfg, p, h, quant: C.Quant):
    B, S, d = h.shape
    di = cfg["ssm"]["expand"] * d
    Hs = max(1, di // 64)
    P, N = di // Hs, cfg["ssm"]["state_dim"]
    xz = C.mm(h, p["w_in"], quant)
    xin, z = xz[..., :di], xz[..., di:]
    W = p["conv"].shape[0]
    xp = F.pad(xin, (0, 0, W - 1, 0))
    u = F.silu(sum(xp[:, i:i + S] * p["conv"][i] for i in range(W)))
    bc = C.mm(u, p["w_bc"], quant)
    dt = F.softplus(C.mm(u, p["w_dt"], quant) + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    y = torch.stack([_ssd(u[b].view(S, Hs, P), dt[b], A, bc[b, :, :N],
                          bc[b, :, N:], p["D"]) for b in range(B)])
    y = C.rms(y.reshape(B, S, di)) * p["out_norm"]
    return C.mm(y * F.silu(z), p["w_out"], quant)


def hidden(cfg, params, tokens: torch.Tensor, quant: C.Quant = None):
    """The final-normed hidden states (B, S, d) of token ids (B, S), meta
    positions dropped."""
    meta = cfg.get("meta_tokens", 0)
    x = params["embed"]["table"][tokens].to(C.F32)
    if meta:
        m = params["meta"].to(C.F32)
        x = torch.cat([m.expand(x.shape[0], *m.shape), x], dim=1)
    pos = torch.arange(x.shape[1], device=x.device)
    for seg, i, w in C.layers(cfg):
        p = C.pick(params["segments"][seg], i)
        h = C.norm(cfg, p.get("ln1", {}), x)
        a = C.attention(cfg, p["attn"], h, pos, w, meta, quant)
        s = _mamba(cfg, p["mamba"], h, quant)
        x = x + 0.5 * (C.rms(a) * p["mix_a"] + C.rms(s) * p["mix_s"])
        x = x + C.mlp(p["mlp"], C.norm(cfg, p.get("ln2", {}), x), quant)
    return C.final_norm(cfg, params, x)[:, meta:]
