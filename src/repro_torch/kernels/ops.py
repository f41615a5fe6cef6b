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

The signatures are those of the JAX package's `kernels/ops.py`; `ssd` and
`mlstm` add `return_state` for the prefill's decode cache. Every op of the
JAX module has its kernel here.

The fleet row-axis ops (`pairwise_js`, `fleet_drift`) also take `mesh`, a
`launch.mesh.FleetMesh`. With a mesh the row axis is padded with zero
rows to a multiple of the device count and the SAME wrapper runs once per
contiguous block, on that block's device (`distributed.sharding.
split_rows`): every row's math is unchanged, so the sharded result is
bit-identical to one call, and each block on a CUDA device is one counted
launch of the kernel. The blocks' results are concatenated on the mesh's
first device with the padding sliced off.
"""
from __future__ import annotations

import torch

from repro_torch.distributed.sharding import join_rows, split_rows
from repro_torch.kernels import ref as _ref
from repro_torch.kernels.flash_attention import flash_attention as _flash
from repro_torch.kernels.fleet_drift import fleet_drift as _fdrift
from repro_torch.kernels.mlstm_scan import mlstm_scan as _mlstm
from repro_torch.kernels.pairwise_js import pairwise_js as _pjs
from repro_torch.kernels.ssd_scan import ssd_scan as _ssd
from repro_torch.launch.mesh import on_device

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


def pairwise_js(p, q, *, eps: float = 1e-12, impl: str = "auto",
                mesh=None, shard: str = "rows"):
    """(N, M) Jensen-Shannon divergence matrix. p: (N, B); q: (M, B).

    The drift-signature similarity engine for fleet-scale grouping: one
    call scores every request histogram against every candidate stream
    signature (core.signature_index.SignatureIndex).

    With `mesh`, one side is block-sharded across devices and the other
    copied to each: shard="rows" splits p (each block an (N/D, M)
    stripe), shard="cols" splits q (an (N, M/D) stripe; what the
    signature index uses, since its fleet axis is q). Under shard="cols"
    `q` may also be the list of its blocks already on their devices (the
    index's device mirror); the result then keeps every block's columns,
    padding included."""
    if impl not in ("auto", "ref"):
        raise _unknown("pairwise_js", impl)

    def local(pp, qq):
        if impl == "ref":
            return _ref.pairwise_js_ref(pp, qq, eps=eps)
        return _pjs(pp, qq, eps=eps)

    if mesh is None:
        return local(p, q)
    if shard == "cols":
        if isinstance(q, (list, tuple)):
            blocks, m = list(q), sum(b.shape[0] for b in q)
        else:
            blocks, m = split_rows(q, mesh), q.shape[0]
        parts = []
        for b in blocks:
            with on_device(b.device):
                parts.append(local(p.to(b.device), b))
        return join_rows(parts, m, mesh.devices[0], dim=1)
    if shard != "rows":
        raise ValueError(f"shard must be 'rows' or 'cols'; got {shard!r}")
    parts = []
    for b in split_rows(p, mesh):
        with on_device(b.device):
            parts.append(local(b, q.to(b.device)))
    return join_rows(parts, p.shape[0], mesh.devices[0])


def fleet_drift(tokens, ref, *, buckets: int, vocab: int = 0,
                eps: float = 1e-12, impl: str = "auto", mesh=None):
    """Fused fleet drift scoring. tokens: (N, T) int; ref: (N, buckets).

    One call histograms every stream's live window and scores it with
    Jensen-Shannon divergence against that stream's reference — the
    batched replacement for the per-stream token_histogram +
    js_divergence loop (core.drift.FleetDriftDetector). Returns
    (scores (N,) fp32, live hists (N, buckets) fp32).

    With `mesh`, the stream rows are block-sharded: each device scores
    its own contiguous row block (tokens and references) with the same
    kernel (histogram + JS are row-local)."""
    if impl not in ("auto", "ref"):
        raise _unknown("fleet_drift", impl)

    def local(tok, r):
        if impl == "ref":
            return _ref.fleet_drift_ref(tok, r, buckets=buckets, vocab=vocab,
                                        eps=eps)
        return _fdrift(tok, r, buckets=buckets, vocab=vocab, eps=eps)

    if mesh is None:
        return local(tokens, ref)
    scores, hists = [], []
    for tok, r in zip(split_rows(tokens, mesh), split_rows(ref, mesh)):
        with on_device(tok.device):
            s, h = local(tok, r)
        scores.append(s)
        hists.append(h)
    home, n = mesh.devices[0], tokens.shape[0]
    return join_rows(scores, n, home), join_rows(hists, n, home)


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
          return_state: bool = False, init_state=None, impl: str = "auto"):
    """Chunkwise mLSTM. q,k,v: (B,S,H,P); gates: (B,S,H) raw, q's dtype;
    `init_state` an optional (C (B,H,P,P), n (B,H,P), m (B,H)) fp32 state
    to start from (the zero state when None).

    Returns h (B,S,H,P) in q.dtype [, final state (C (B,H,P,P), n (B,H,P),
    m (B,H)) fp32]. "auto" runs the `mlstm_scan` kernel on a CUDA tensor and
    the plain chunked form `ref.mlstm_chunked` on a CPU tensor;
    "autograd" is `ref.mlstm_chunked` on any device, "ref" the
    token-by-token oracle `ref.mlstm_recurrent`."""
    if impl == "ref":
        return _ref.mlstm_recurrent(q, k, v, igate, fgate,
                                    init_state=init_state,
                                    return_state=return_state)
    if impl == AUTOGRAD:
        return _ref.mlstm_chunked(q, k, v, igate, fgate, chunk=chunk,
                                  init_state=init_state,
                                  return_state=return_state)
    if impl == "auto":
        return _mlstm(q, k, v, igate, fgate, chunk=chunk,
                      return_state=return_state, init_state=init_state)
    raise _unknown("mlstm", impl, IMPLS)
