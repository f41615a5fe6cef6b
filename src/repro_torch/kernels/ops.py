"""Public kernel entry points with backend dispatch.

Every op takes `impl`:
  * "auto" — the tensor's device decides: a CUDA tensor goes to the
             hand-written Hopper kernel (or the call raises), a CPU tensor
             to the plain version. There is no capability-based fallback.
  * "ref"  — the plain PyTorch version (`ref.py`) on any device; only the
             tests and `chip_smoke.py` ask for it.

The signatures are those of the JAX package's `kernels/ops.py` without
its `mesh`/`shard` arguments (sharding comes with the port's distribution
module). Its ops that this port has not reached yet (`ssd`, `mlstm`) are
queued in ROADMAP.md.
"""
from __future__ import annotations

from repro_torch.kernels import ref as _ref
from repro_torch.kernels.flash_attention import flash_attention as _flash
from repro_torch.kernels.fleet_drift import fleet_drift as _fdrift
from repro_torch.kernels.pairwise_js import pairwise_js as _pjs

IMPLS = ("auto", "ref")


def _unknown(op: str, impl: str):
    return ValueError(f"unknown {op} impl {impl!r}; use 'auto' or 'ref'")


def attention(q, k, v, *, causal: bool = True, window: int = 0,
              impl: str = "auto"):
    """Flash attention. q: (B,S,H,hd); k,v: (B,T,K,hd), H % K == 0."""
    if impl == "ref":
        return _ref.attention_ref(q, k, v, causal=causal, window=window)
    if impl == "auto":
        return _flash(q, k, v, causal=causal, window=window)
    raise _unknown("attention", impl)


def pairwise_js(p, q, *, eps: float = 1e-12, impl: str = "auto"):
    """(N, M) Jensen-Shannon divergence matrix. p: (N, B); q: (M, B).

    The drift-signature similarity engine for fleet-scale grouping: one
    call scores every request histogram against every candidate stream
    signature (core.signature_index.SignatureIndex)."""
    if impl == "ref":
        return _ref.pairwise_js_ref(p, q, eps=eps)
    if impl == "auto":
        return _pjs(p, q, eps=eps)
    raise _unknown("pairwise_js", impl)


def fleet_drift(tokens, ref, *, buckets: int, vocab: int = 0,
                eps: float = 1e-12, impl: str = "auto"):
    """Fused fleet drift scoring. tokens: (N, T) int; ref: (N, buckets).

    One call histograms every stream's live window and scores it with
    Jensen-Shannon divergence against that stream's reference — the
    batched replacement for the per-stream token_histogram +
    js_divergence loop (core.drift.FleetDriftDetector). Returns
    (scores (N,) fp32, live hists (N, buckets) fp32)."""
    if impl == "ref":
        return _ref.fleet_drift_ref(tokens, ref, buckets=buckets,
                                    vocab=vocab, eps=eps)
    if impl == "auto":
        return _fdrift(tokens, ref, buckets=buckets, vocab=vocab, eps=eps)
    raise _unknown("fleet_drift", impl)
