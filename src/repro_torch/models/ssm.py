"""Mamba-2-style selective state-space (SSD) heads of hymba's SSM path, and
the Mamba-2 mixer as published (granite-4.0-h's layers of that kind).

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

The two mixers differ where hymba's departs from Mamba-2: hymba projects
x and the gate z, convolves x alone (no bias), projects B, C and dt from
the conv's output, and norms y before gating it; Mamba-2 projects z, xBC
and dt at once, convolves x, B and C together (with a bias where the
config has one), and gates y before its RMSNorm over all d_inner channels
(eps 1e-5). The JAX package has no Mamba-2 mixer: tests/test_torch_granite.py
holds it to a plain float32 transcription of the published equations.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch import tracing
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.kernels.ref import ssd_chunked  # noqa: F401  (re-export)
from repro_torch.models.layers import silu
from repro_torch.models.param import Spec

F32 = torch.float32


def ssd_step(x, dt, A, Bm, Cm, D, state):
    """Single decode step. x: (B,H,P), dt: (B,H), Bm/Cm: (B,N), A/D: (H,)
    or each row's own (B,H), state: (B,H,P,N) -> (y (B,H,P) in x.dtype,
    new_state fp32)."""
    dt32 = dt.to(F32)
    decay = torch.exp(dt32 * A.to(F32))[:, :, None, None]
    upd = torch.einsum("bh,bn,bhp->bhpn", dt32, Bm.to(F32), x.to(F32))
    new_state = decay * state.to(F32) + upd
    y = torch.einsum("bn,bhpn->bhp", Cm.to(F32), new_state)
    y = y + x.to(F32) * D.to(F32)[..., None]
    return y.to(x.dtype), new_state


# ---------------------------------------------------------------------------
# Mamba head-group layer (hymba SSM path)
# ---------------------------------------------------------------------------
def mamba_heads(cfg: ModelConfig):
    """(d_inner, heads of dim `ssm.head_dim` (64), head dim P)."""
    di = cfg.ssm.expand * cfg.d_model
    H = max(1, di // cfg.ssm.head_dim)
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


# ---------------------------------------------------------------------------
# Mamba-2 mixer (granite-4.0-h)
# ---------------------------------------------------------------------------
# the prefill scan's chunk, hymba's: the published 256 would need 614 KiB
# of shared memory in the CUDA-core kernel at state 128; the chunk does not
# change the function (`ref.ssd_chunked` equals the recurrence)
CHUNK = 64


def mamba2_dims(cfg: ModelConfig):
    """(d_inner, heads, head dim P, state N, conv channels): x, B and C go
    through the conv together."""
    s = cfg.ssm
    if s.n_groups != 1:
        raise NotImplementedError(
            f"the Mamba-2 mixer computes one B/C group (granite-4.0-h's); "
            f"got n_groups {s.n_groups}")
    di = s.expand * cfg.d_model
    return di, di // s.head_dim, s.head_dim, s.state_dim, di + 2 * s.state_dim


def mamba2_spec(cfg: ModelConfig):
    d = cfg.d_model
    di, H, _, _, conv = mamba2_dims(cfg)
    spec = {
        "w_in": Spec((d, di + conv + H), ("fsdp", "mlp")),  # z | xBC | dt
        "conv": Spec((cfg.ssm.conv_width, conv), (None, "mlp"), "normal",
                     1.0),
        "dt_bias": Spec((H,), (None,), "zeros"),
        "A_log": Spec((H,), (None,), "zeros"),             # A = -exp(A_log)
        "D": Spec((H,), (None,), "ones"),
        "norm": Spec((di,), (None,), "ones"),
        "w_out": Spec((di, d), ("mlp", "fsdp"),
                      scale=1.0 / math.sqrt(2 * cfg.num_layers)),
    }
    if cfg.ssm.conv_bias:
        spec["conv_b"] = Spec((conv,), ("mlp",), "zeros")
    return spec


def _mamba2_in(cfg: ModelConfig, p, h, conv_cache=None):
    """The in-projection, the conv over xBC (from `conv_cache`'s rows at a
    decode step) and its activation: z (B,S,di) and x (B,S,H,P), Bm, Cm
    (B,S,N) in h's dtype, dt (B,S,H) fp32 after softplus, and the conv's
    next cache rows (B,W-1,conv)."""
    di, H, P, N, conv = mamba2_dims(cfg)
    z, xbc, dt = (h @ p["w_in"].to(h.dtype)).split([di, conv, H], dim=-1)
    xbc, new_conv = _causal_conv(xbc, p["conv"], cache=conv_cache)
    if "conv_b" in p:
        xbc = xbc + p["conv_b"].to(h.dtype)
    x, Bm, Cm = silu(xbc).split([di, N, N], dim=-1)
    dt = F.softplus(dt.to(F32) + p["dt_bias"].to(F32))
    return z, x.unflatten(-1, (H, P)), Bm, Cm, dt, new_conv


def _mamba2_out(p, y, z, eps: float = 1e-5):
    """y * silu(z), RMS-normed over all d_inner channels in fp32, then the
    out-projection. y, z: (..., di)."""
    g = y.to(F32) * silu(z.to(F32))
    g = g * torch.rsqrt(g.pow(2).mean(-1, keepdim=True) + eps) \
        * p["norm"].to(F32)
    return g.to(z.dtype) @ p["w_out"].to(z.dtype)


def apply_mamba2(cfg: ModelConfig, p, h, *, return_cache: bool = False,
                 kernel_impl: str = "auto"):
    """The Mamba-2 mixer over a full sequence of normed h (B,S,D) ->
    (B,S,D) [, decode cache {"conv" (B,W-1,conv) in h's dtype, "state"
    (B,H,P,N) fp32}]. The scan runs through `ops.ssd(impl=kernel_impl)`
    under the span `ecco.mamba.scan`."""
    B, S, _ = h.shape
    z, x, Bm, Cm, dt, conv = _mamba2_in(cfg, p, h)
    A = -torch.exp(p["A_log"].to(F32))
    # the kernel names its path on the span when it launches (ssd_scan)
    with tracing.span("ecco.mamba.scan", rows=B, length=S, N=Bm.shape[-1],
                      path="plain"):
        out = ops.ssd(x, dt, A, Bm, Cm, p["D"], chunk=CHUNK,
                      return_state=return_cache, impl=kernel_impl)
    y, state = out if return_cache else (out, None)
    out = _mamba2_out(p, y.flatten(-2), z)
    return (out, {"conv": conv, "state": state}) if return_cache else out


def apply_mamba2_step(cfg: ModelConfig, p, h, cache):
    """Decode step of normed h (B,1,D) -> (y (B,1,D), cache); the cache's
    "conv" rows and fp32 "state" are overwritten in place."""
    z, x, Bm, Cm, dt, new_conv = _mamba2_in(cfg, p, h, cache["conv"])
    A = -torch.exp(p["A_log"].to(F32))
    y, new_state = ssd_step(x[:, 0], dt[:, 0], A, Bm[:, 0], Cm[:, 0],
                            p["D"], cache["state"])
    cache["conv"].copy_(new_conv)
    cache["state"].copy_(new_state)
    return _mamba2_out(p, y.flatten(-2)[:, None], z), cache
