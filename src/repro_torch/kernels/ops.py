"""Public kernel entry points with backend dispatch.

Every op takes `impl`:
  * "auto" — the tensor's device decides: a CUDA tensor goes to the
             hand-written Hopper kernel (or the call raises), a CPU tensor
             to the plain version. There is no capability-based fallback.
  * "ref"  — the plain PyTorch version (`ref.py`) on any device; only the
             tests and `chip_smoke.py` ask for it.

The ops of the JAX package's `kernels/ops.py` that this port has not
reached yet (`pairwise_js`, `fleet_drift`, `ssd`, `mlstm`) are queued in
ROADMAP.md.
"""
from __future__ import annotations

from repro_torch.kernels import ref as _ref
from repro_torch.kernels.flash_attention import flash_attention as _flash


def attention(q, k, v, *, causal: bool = True, window: int = 0,
              impl: str = "auto"):
    """Flash attention. q: (B,S,H,hd); k,v: (B,T,K,hd), H % K == 0."""
    if impl == "ref":
        return _ref.attention_ref(q, k, v, causal=causal, window=window)
    if impl == "auto":
        return _flash(q, k, v, causal=causal, window=window)
    raise ValueError(f"unknown attention impl {impl!r}; use 'auto' or 'ref'")
