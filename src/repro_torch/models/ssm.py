"""Mamba-2-style selective state-space (SSD) heads of hymba's SSM path.

Mirrors the JAX package's `models/ssm.py` at the same names and shapes:
x (B, S, H, P) heads; Bm/Cm (B, S, N) shared across heads (one group);
dt (B, S, H); A (H,) negative scalars. The chunked scan of a full
sequence goes through `kernels.ops.ssd` (the Hopper kernel `ssd_scan` for
CUDA tensors, the plain chunked form `ssd_chunked` for CPU tensors); the
decode step is plain PyTorch, as in the JAX package, which has no kernel
for one step.

Decode updates the cache IN PLACE (the JAX version returns new arrays):
the serving loop decodes contiguous slots on a view of its pool and keeps
no returned cache.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.kernels.ref import ssd_chunked  # noqa: F401  (re-export)
from repro_torch.models.layers import silu
from repro_torch.models.param import Spec

F32 = torch.float32


def ssd_step(x, dt, A, Bm, Cm, D, state):
    """Single decode step. x: (B,H,P), dt: (B,H), Bm/Cm: (B,N),
    state: (B,H,P,N) -> (y (B,H,P) in x.dtype, new_state fp32)."""
    dt32 = dt.to(F32)
    decay = torch.exp(dt32 * A.to(F32)[None, :])[:, :, None, None]
    upd = torch.einsum("bh,bn,bhp->bhpn", dt32, Bm.to(F32), x.to(F32))
    new_state = decay * state.to(F32) + upd
    y = torch.einsum("bn,bhpn->bhp", Cm.to(F32), new_state)
    y = y + x.to(F32) * D.to(F32)[None, :, None]
    return y.to(x.dtype), new_state


# ---------------------------------------------------------------------------
# Mamba head-group layer (hymba SSM path)
# ---------------------------------------------------------------------------
def mamba_heads(cfg: ModelConfig):
    """(d_inner, heads of dim 64, head dim P)."""
    di = cfg.ssm.expand * cfg.d_model
    H = max(1, di // 64)
    return di, H, di // H


def mamba_spec(cfg: ModelConfig):
    d = cfg.d_model
    s = cfg.ssm
    di, H, _ = mamba_heads(cfg)
    N = s.state_dim
    return {
        "w_in": Spec((d, 2 * di), ("fsdp", "mlp")),        # x path + gate
        "conv": Spec((s.conv_width, di), (None, "mlp"), "normal", 1.0),
        "w_bc": Spec((di, 2 * N), ("mlp", None)),
        "w_dt": Spec((di, H), ("mlp", None)),
        "dt_bias": Spec((H,), (None,), "zeros"),
        "A_log": Spec((H,), (None,), "zeros"),             # A = -exp(A_log)
        "D": Spec((H,), (None,), "ones"),
        "w_out": Spec((di, d), ("mlp", "fsdp"),
                      scale=1.0 / math.sqrt(2 * cfg.num_layers)),
        "out_norm": Spec((di,), (None,), "ones"),
    }


def _causal_conv(x, w, cache=None):
    """x: (B,S,di); w: (W,di) depthwise. Returns (y, new_cache (B,W-1,di)):
    the last W-1 inputs, the rows the next step's window needs."""
    W = w.shape[0]
    if cache is None:
        xp = F.pad(x, (0, 0, W - 1, 0))
    else:
        xp = torch.cat([cache.to(x.dtype), x], dim=1)
    new_cache = xp[:, -(W - 1):] if W > 1 else None
    S = x.shape[1]
    out = 0
    for i in range(W):                   # W stacked shifts (W is tiny)
        out = out + xp[:, i:i + S, :] * w[i].to(x.dtype)
    return out, new_cache


def _project(cfg: ModelConfig, p, xin):
    """Bm, Cm (..., N) in xin's dtype and dt (..., H) fp32 after softplus,
    from the conv's activated output xin (..., di)."""
    dt_ = xin.dtype
    Bm, Cm = (xin @ p["w_bc"].to(dt_)).chunk(2, dim=-1)
    dt = F.softplus((xin @ p["w_dt"].to(dt_)).to(F32)
                    + p["dt_bias"].to(F32))
    return Bm, Cm, dt


def _out(p, y, z):
    """RMS out-norm (eps 1e-6), gate, output projection. y, z: (..., di)."""
    dt_ = z.dtype
    yf = y.to(F32)
    y = (yf * torch.rsqrt(yf.pow(2).mean(-1, keepdim=True) + 1e-6)
         * p["out_norm"].to(F32)).to(dt_)
    return (y * silu(z)) @ p["w_out"].to(dt_)


def apply_mamba(cfg: ModelConfig, p, x, *, chunk: int = 64,
                return_cache: bool = False, kernel_impl: str = "auto"):
    """Full-sequence mamba head-group. x: (B,S,D) -> (B,S,D)
    [, decode cache {"conv" (B,W-1,di) in x's dtype, "state" (B,H,P,N)
    fp32}]. The scan runs through `ops.ssd(impl=kernel_impl)`, which also
    returns the final state for the cache."""
    B, S, D = x.shape
    di, H, P = mamba_heads(cfg)
    xin_raw, z = (x @ p["w_in"].to(x.dtype)).chunk(2, dim=-1)
    xin, _ = _causal_conv(xin_raw, p["conv"])
    xin = silu(xin)
    Bm, Cm, dt = _project(cfg, p, xin)
    A = -torch.exp(p["A_log"].to(F32))
    out = ops.ssd(xin.reshape(B, S, H, P), dt, A, Bm, Cm, p["D"],
                  chunk=chunk, return_state=return_cache, impl=kernel_impl)
    y, state = out if return_cache else (out, None)
    out = _out(p, y.reshape(B, S, di), z)
    if return_cache:
        W = cfg.ssm.conv_width
        return out, {"conv": xin_raw[:, -(W - 1):], "state": state}
    return out


def mamba_init_cache(cfg: ModelConfig, batch: int, dtype, device=None):
    """A zeroed single-layer Mamba cache: conv rows in `dtype`, the state
    in fp32."""
    di, H, P = mamba_heads(cfg)
    s = cfg.ssm
    return {"conv": torch.zeros((batch, s.conv_width - 1, di), dtype=dtype,
                                device=device),
            "state": torch.zeros((batch, H, P, s.state_dim), dtype=F32,
                                 device=device)}


def apply_mamba_step(cfg: ModelConfig, p, x, cache):
    """Decode step. x: (B,1,D) -> (y (B,1,D), cache). The cache's "conv"
    and "state" are overwritten in place (cast to their own dtype, as the
    JAX serving pool casts the returned state on write)."""
    B, _, D = x.shape
    di, H, P = mamba_heads(cfg)
    xin, z = (x @ p["w_in"].to(x.dtype)).chunk(2, dim=-1)
    xin, new_conv = _causal_conv(xin, p["conv"], cache=cache["conv"])
    xin = silu(xin)[:, 0]                                  # (B,di)
    Bm, Cm, dt = _project(cfg, p, xin)
    A = -torch.exp(p["A_log"].to(F32))
    y, new_state = ssd_step(xin.reshape(B, H, P), dt, A, Bm, Cm, p["D"],
                            cache["state"])
    cache["conv"].copy_(new_conv)
    cache["state"].copy_(new_state)
    return _out(p, y.reshape(B, 1, di), z), cache
