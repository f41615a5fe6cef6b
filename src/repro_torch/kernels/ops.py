"""Public kernel entry points with backend dispatch.

Every op takes `impl`:
  * "auto"     — the tensor's device decides: a CUDA tensor goes to the
                 hand-written Hopper kernel (or the call raises), a CPU
                 tensor to the plain version. There is no capability-based
                 fallback. The kernels have no backward pass, so "auto"
                 raises a ValueError when grad mode is on and a floating
                 input requires grad, on every device: a kernel's output
                 would carry no `grad_fn` and cut the gradient.
  * "autograd" — the differentiable plain forms on any device, for the
                 train step (`train/train_step.py`): `ref.attention_ref`,
                 and the chunked `ref.ssd_chunked` / `ref.mlstm_chunked`
                 (not the token-by-token oracles, far too slow to train at
                 1024 steps). `attention`, `ssd` and `mlstm` only.
  * "ref"      — the plain version (`ref.py`) on any device; only the
                 tests and `chip_smoke.py` ask for it. For `ssd` and
                 `mlstm` that is the token-by-token oracle.

"autograd" is not a fallback. The JAX package trains through XLA, not
through its Pallas kernels, none of which has a backward pass: its
`SharedEngine` step differentiates `attention_full` and the chunked
`ssd_chunked` / `mlstm_chunked` forms. The port's train step names the
same plain forms at its call site, and its eval forwards (under
`torch.no_grad()`) take "auto", the kernels.

The signatures are those of the JAX package's `kernels/ops.py` without
its `mesh`/`shard` arguments (sharding comes with the port's distribution
module); `ssd` and `mlstm` add `return_state` for the prefill's decode
cache. Every op of the JAX module has its kernel here.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref as _ref
from repro_torch.kernels.flash_attention import flash_attention as _flash
from repro_torch.kernels.fleet_drift import fleet_drift as _fdrift
from repro_torch.kernels.mlstm_scan import mlstm_scan as _mlstm
from repro_torch.kernels.pairwise_js import pairwise_js as _pjs
from repro_torch.kernels.ssd_scan import ssd_scan as _ssd

IMPLS = ("auto", "autograd", "ref")
AUTOGRAD = "autograd"


def _unknown(op: str, impl: str, impls=("auto", "ref")):
    return ValueError(f"unknown {op} impl {impl!r}; use one of {impls}")


def attention(q, k, v, *, causal: bool = True, window: int = 0,
              lengths=None, impl: str = "auto"):
    """Flash attention. q: (B,S,H,hd); k,v: (B,T,K,hd), H % K == 0.
    `lengths` ((B,) int32, a decode's): lane b sees keys t < lengths[b]."""
    if impl in ("ref", AUTOGRAD):
        return _ref.attention_ref(q, k, v, causal=causal, window=window,
                                  lengths=lengths)
    if impl == "auto":
        return _flash(q, k, v, causal=causal, window=window,
                      lengths=lengths)
    raise _unknown("attention", impl, IMPLS)


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


def ssd(x, dt, A, Bm, Cm, D, *, chunk: int = 128, return_state: bool = False,
        impl: str = "auto"):
    """Chunkwise SSD. x: (B,S,H,P); dt: (B,S,H); A,D: (H,); Bm,Cm: (B,S,N).

    Returns y (B,S,H,P) in x.dtype [, final state (B,H,P,N) fp32]. "auto"
    hands dt, A and D to the kernel in fp32 (the math is fp32 either way);
    "autograd" is the chunked form `ref.ssd_chunked`, "ref" the
    token-by-token oracle `ref.ssd_recurrent`."""
    if impl == "ref":
        return _ref.ssd_recurrent(x, dt, A, Bm, Cm, D,
                                  return_state=return_state)
    if impl == AUTOGRAD:
        return _ref.ssd_chunked(x, dt, A, Bm, Cm, D, chunk=chunk,
                                return_state=return_state)
    if impl == "auto":
        f32 = torch.float32
        return _ssd(x, dt.to(f32), A.to(f32), Bm, Cm, D.to(f32), chunk=chunk,
                    return_state=return_state)
    raise _unknown("ssd", impl, IMPLS)


def mlstm(q, k, v, igate, fgate, *, chunk: int = 128,
          return_state: bool = False, impl: str = "auto"):
    """Chunkwise mLSTM. q,k,v: (B,S,H,P); gates: (B,S,H) raw, q's dtype.

    Returns h (B,S,H,P) in q.dtype [, final state (C (B,H,P,P), n (B,H,P),
    m (B,H)) fp32]. "auto" runs the `mlstm_scan` kernel on a CUDA tensor and
    the plain chunked form `ref.mlstm_chunked` on a CPU tensor;
    "autograd" is `ref.mlstm_chunked` on any device, "ref" the
    token-by-token oracle `ref.mlstm_recurrent`."""
    if impl == "ref":
        return _ref.mlstm_recurrent(q, k, v, igate, fgate,
                                    return_state=return_state)
    if impl == AUTOGRAD:
        return _ref.mlstm_chunked(q, k, v, igate, fgate, chunk=chunk,
                                  return_state=return_state)
    if impl == "auto":
        return _mlstm(q, k, v, igate, fgate, chunk=chunk,
                      return_state=return_state)
    raise _unknown("mlstm", impl, IMPLS)
