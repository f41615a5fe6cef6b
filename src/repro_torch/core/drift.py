"""Data-drift signatures and detection.

A stream's observable signature is its recent token histogram (over
hashed vocab buckets). Drift score = Jensen-Shannon divergence between
the live window histogram and the reference (deployment-time) histogram.
A request fires when the score crosses `threshold` (the paper cites
[4, 21, 40] for the trigger; any detector plugs in here).

Two granularities:
  * `DriftDetector` — one stream, the scalar reference semantics.
  * `FleetDriftDetector` — the whole fleet in dense (N, buckets)
    arrays, one vectorized scoring call per window, trigger decisions
    bit-identical to running a `DriftDetector` per stream.

The numpy/float64 code here is the JAX package's, copied as it is: it
decides triggers, and the port must match the reference bit for bit.
Only the fleet detector's fp32 screen is the port's own, a call of
`kernels.ops.fleet_drift` on the detector's device.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.rows import RowRegistry
from repro_torch.kernels import ops


def token_histogram(tokens, buckets: int = 64, vocab: Optional[int] = None
                    ) -> np.ndarray:
    t = np.asarray(tokens).reshape(-1)
    if vocab:
        # tokens at exactly `vocab` (or beyond) would land in bucket
        # `buckets`, growing the histogram to buckets+1 and breaking
        # shape agreement with the reference in js_divergence
        idx = np.clip((t * buckets) // vocab, 0, buckets - 1)
    else:
        idx = t % buckets
    h = np.bincount(idx.astype(np.int64), minlength=buckets).astype(np.float64)
    s = h.sum()
    return h / s if s else h


#: rows per chunk in the batched histogram / JS paths. Chunking keeps
#: the integer index temporaries inside the cache hierarchy instead of
#: first-touch-faulting hundreds of MB of fresh pages per fleet call;
#: 1024 rows keeps each chunk's temporaries (~3 MB) cache-resident.
_CHUNK_ROWS = 1024
#: largest vocab for which a bucket lookup table is built (int32 LUT of
#: vocab+1 entries; 4 MB at the 1M cap).
_LUT_VOCAB_MAX = 1 << 20


def batch_token_histogram(tokens, buckets: int = 64,
                          vocab: Optional[int] = None) -> np.ndarray:
    """(N, ...) tokens -> (N, buckets) float64; row i is bit-identical
    to token_histogram(tokens[i], buckets, vocab) (integer bincounts,
    then the same float64 normalization).

    Processed in row chunks with an int32 bucket LUT: identical counts
    (the LUT tabulates the same `clip((t*buckets)//vocab)` map), but
    the scatter temporaries stay cache-sized, so cost is linear in N
    up to 100k+ rows."""
    t = np.asarray(tokens)
    n = t.shape[0]
    if n == 0:
        return np.zeros((0, buckets), np.float64)
    t = t.reshape(n, -1)
    lut = None
    if vocab and vocab <= _LUT_VOCAB_MAX:
        lut = np.minimum(
            (np.arange(vocab + 1, dtype=np.int64) * buckets) // vocab,
            buckets - 1).astype(np.int32)
    out = np.empty((n, buckets), np.float64)
    offs = None
    for lo in range(0, n, _CHUNK_ROWS):
        tc = t[lo:lo + _CHUNK_ROWS]
        m = tc.shape[0]
        if lut is not None:
            idx = lut[np.clip(tc, 0, vocab)]
        elif vocab:
            idx = np.clip((tc * buckets) // vocab,
                          0, buckets - 1).astype(np.int32)
        else:
            idx = (tc % buckets).astype(np.int32)
        if offs is None or offs.shape[0] != m:
            offs = (buckets * np.arange(m, dtype=np.int32))[:, None]
        h = np.bincount((idx + offs).reshape(-1), minlength=m * buckets)
        h = h.astype(np.float64).reshape(m, buckets)
        s = h.sum(axis=1, keepdims=True)
        out[lo:lo + m] = np.divide(h, s, out=h, where=s != 0)
    return out      # zero-sum rows keep their raw (zero) counts


def js_divergence(p: np.ndarray, q: np.ndarray, eps: float = 1e-12) -> float:
    p = p + eps
    q = q + eps
    p = p / p.sum()
    q = q / q.sum()
    m = 0.5 * (p + q)
    kl = lambda a, b: float(np.sum(a * np.log(a / b)))
    return 0.5 * kl(p, m) + 0.5 * kl(q, m)


def js_divergence_rows(p: np.ndarray, q: np.ndarray,
                       eps: float = 1e-12) -> np.ndarray:
    """Row-for-row JS: out[i] = js_divergence(p[i], q[i]), bit-identical
    (same float64 ops in the same order; numpy's pairwise axis reduction
    over a contiguous row matches the 1-D reduction of the scalar path).
    Row-chunked for the same page-fault reason as
    batch_token_histogram — each row's math is independent, so chunking
    cannot change any value.
    """
    p = np.asarray(p, np.float64)
    q = np.asarray(q, np.float64)
    if p.ndim <= 1 or p.shape[0] <= _CHUNK_ROWS:
        return _js_rows_block(p, q, eps)
    out = np.empty(p.shape[0], np.float64)
    for lo in range(0, p.shape[0], _CHUNK_ROWS):
        hi = lo + _CHUNK_ROWS
        out[lo:hi] = _js_rows_block(p[lo:hi], q[lo:hi], eps)
    return out


def _js_rows_block(p: np.ndarray, q: np.ndarray, eps: float) -> np.ndarray:
    p = p + eps
    q = q + eps
    p = p / p.sum(axis=-1, keepdims=True)
    q = q / q.sum(axis=-1, keepdims=True)
    m = 0.5 * (p + q)
    kl_pm = np.sum(p * np.log(p / m), axis=-1)
    kl_qm = np.sum(q * np.log(q / m), axis=-1)
    return 0.5 * kl_pm + 0.5 * kl_qm


@dataclasses.dataclass
class DriftDetector:
    threshold: float = 0.25
    buckets: int = 64
    vocab: Optional[int] = None
    reference: Optional[np.ndarray] = None
    last_score: float = 0.0
    last_hist: Optional[np.ndarray] = None   # latest window signature

    def set_reference(self, tokens):
        self.reference = token_histogram(tokens, self.buckets, self.vocab)

    def observe(self, tokens) -> bool:
        """Returns True if drift detected on this window of tokens."""
        h = token_histogram(tokens, self.buckets, self.vocab)
        self.last_hist = h
        if self.reference is None:
            self.reference = h
            return False
        self.last_score = js_divergence(h, self.reference)
        return self.last_score > self.threshold

    def rebase(self, tokens):
        """After retraining completes, the new data becomes the reference."""
        self.set_reference(tokens)


class FleetDriftDetector:
    """Drift detection for the whole fleet in one vectorized call.

    Holds dense (N, buckets) reference and live histograms keyed by
    stream id (rows are swap-compacted on removal, so arrays stay
    dense under camera churn). `observe` replaces the controller's
    per-stream `token_histogram` + `js_divergence` Python loop.

    Exactness: histograms are always exact (integer bincounts +
    float64 normalization, bit-identical to token_histogram).
    Scoring backends (`impl`):
      * "exact"  — float64 numpy rowwise JS; scores AND trigger
        decisions bit-identical to a per-stream DriftDetector. Runs on
        the host only.
      * "auto" / "ref" — the fused kernels.ops.fleet_drift call (fp32)
        on `device` screens the fleet ("auto": the hand-written
        `fleet_drift` kernel on a CUDA device; "ref": the plain
        version), then every stream whose fp32 score lands above
        `threshold - band` is rescored in exact float64 and decided
        there. fp32 JS error is ~1e-7 at drift shapes, orders below the
        default band, so trigger decisions (and the scores/signatures
        of every potentially-triggered stream) remain bit-identical to
        the scalar path while far-from-threshold streams only pay fp32.
    The reference and live histograms stay on the host; a kernel mode
    copies each window's tokens (as int32) and references (as fp32) to
    the device and the fp32 scores back.
    """

    def __init__(self, threshold: float = 0.25, buckets: int = 64,
                 vocab: Optional[int] = None, *, impl: str = "exact",
                 band: float = 1e-4, device="cuda"):
        if impl != "exact" and impl not in ops.IMPLS:
            raise ValueError(f"unknown drift impl {impl!r}; use 'exact' "
                             f"or one of {ops.IMPLS}")
        self.threshold = float(threshold)
        self.buckets = int(buckets)
        self.vocab = vocab
        self.impl = impl
        self.band = float(band)
        # the exact path never leaves the host; a kernel mode runs on
        # `device`, which must exist
        self.device = (torch.device(device) if impl == "exact"
                       else resolve_device(device))
        self._rows = RowRegistry()           # id -> row churn discipline
        cap = self._rows.capacity
        self._ref = np.zeros((cap, self.buckets), np.float64)
        self._has_ref = np.zeros(cap, bool)
        self._live = np.zeros((cap, self.buckets), np.float64)
        self._scores = np.zeros(cap, np.float64)

    # -- membership (camera churn) ---------------------------------------
    def __len__(self) -> int:
        return len(self._rows)

    def __contains__(self, stream_id: str) -> bool:
        return stream_id in self._rows

    @property
    def stream_ids(self) -> List[str]:
        return self._rows.ids

    def _sync_capacity(self):
        """Amortized doubling (via the registry): per-stream appends
        stay O(1) so building a 10k-camera fleet doesn't reallocate the
        dense arrays 10k times."""
        cap = self._ref.shape[0]
        new = self._rows.capacity
        if new <= cap:
            return
        pad = new - cap
        self._ref = np.concatenate(
            [self._ref, np.zeros((pad, self.buckets), np.float64)])
        self._live = np.concatenate(
            [self._live, np.zeros((pad, self.buckets), np.float64)])
        self._has_ref = np.concatenate([self._has_ref,
                                        np.zeros(pad, bool)])
        self._scores = np.concatenate([self._scores,
                                       np.zeros(pad, np.float64)])

    def add_stream(self, stream_id: str) -> int:
        row, new = self._rows.add(stream_id)
        self._sync_capacity()
        if new:
            self._ref[row] = 0.0
            self._live[row] = 0.0
            self._has_ref[row] = False
            self._scores[row] = 0.0
        return row

    def remove_stream(self, stream_id: str):
        """Swap-with-last removal keeps the live rows dense (capacity
        is retained; rows beyond len(self) are garbage)."""
        mv = self._rows.remove(stream_id)
        if mv is None or mv[0] == mv[1]:
            return
        row, last = mv
        self._ref[row] = self._ref[last]
        self._live[row] = self._live[last]
        self._has_ref[row] = self._has_ref[last]
        self._scores[row] = self._scores[last]

    # -- references -------------------------------------------------------
    def set_reference(self, stream_id: str, tokens):
        row = self.add_stream(stream_id)
        self._ref[row] = token_histogram(tokens, self.buckets, self.vocab)
        self._has_ref[row] = True

    def set_references(self, stream_ids: Sequence[str], tokens):
        """Batched warmup: tokens is (N, ...) aligned with stream_ids."""
        self._rows.reserve(len(stream_ids))
        self._sync_capacity()
        hists = batch_token_histogram(tokens, self.buckets, self.vocab)
        for sid, h in zip(stream_ids, hists):
            row = self.add_stream(sid)
            self._ref[row] = h
            self._has_ref[row] = True

    def rebase(self, stream_id: str, tokens):
        """After retraining, the new data becomes the reference."""
        self.set_reference(stream_id, tokens)

    # -- per-stream state accessors ---------------------------------------
    def score(self, stream_id: str) -> float:
        return float(self._scores[self._rows[stream_id]])

    def hist(self, stream_id: str) -> np.ndarray:
        """Latest live window signature (float64, exact)."""
        return self._live[self._rows[stream_id]].copy()

    def reference(self, stream_id: str) -> Optional[np.ndarray]:
        row = self._rows[stream_id]
        return self._ref[row].copy() if self._has_ref[row] else None

    # -- the batched window call -------------------------------------------
    def observe(self, stream_ids: Sequence[str], tokens) -> List[str]:
        """One fleet call per window. tokens: (N, ...) aligned with
        stream_ids. Streams without a reference adopt their live
        histogram as reference and never trigger (scalar semantics).
        Returns the list of triggered stream ids, in stream_ids order.
        """
        n = len(stream_ids)
        if n == 0:
            return []
        # contiguous fast path: the window loop observes the full
        # fleet in row order, where rows are the [0, n) prefix —
        # slice views replace the per-id dict lookups and the O(n)
        # fancy-indexed ref gather (both cache-miss-bound at 10k+
        # rows). Same elements, same order, so identical floats.
        contig = self._rows.is_row_order(stream_ids)
        if contig:
            rows = np.arange(n)
        else:
            known = self._rows.rows_of(stream_ids)   # no-churn path
            rows = (np.asarray(known) if known is not None else
                    np.array([self.add_stream(s) for s in stream_ids]))
        hists = batch_token_histogram(tokens, self.buckets, self.vocab)
        if contig:
            self._live[:n] = hists
            # copy: the adopt-reference write below must not leak into
            # this call's trigger mask (scalar semantics: a stream
            # never triggers on its reference-adopting window)
            has_ref = self._has_ref[:n].copy()
        else:
            self._live[rows] = hists
            has_ref = self._has_ref[rows]

        scores = np.zeros(n, np.float64)
        if has_ref.any():
            if contig and has_ref.all():
                sub = slice(None)
                refs = self._ref[:n]                 # view, no copy
                sel_h = hists
            else:
                sub = np.nonzero(has_ref)[0]
                refs = self._ref[rows[sub]]
                sel_h = hists[sub]
            if self.impl == "exact":
                scores[sub] = js_divergence_rows(sel_h, refs)
            else:
                fs = self._screen(np.asarray(tokens).reshape(n, -1)[sub],
                                  refs)
                # decisions live in the exact float64 world: rescore
                # every stream the fp32 screen puts near/above the
                # threshold (fp32 error << band)
                near = np.nonzero(fs > self.threshold - self.band)[0]
                if near.size:
                    fs[near] = js_divergence_rows(sel_h[near],
                                                  refs[near])
                scores[sub] = fs

        # first observation becomes the reference (DriftDetector.observe)
        new = rows[~has_ref]
        if new.size:
            self._ref[new] = hists[~has_ref]
            self._has_ref[new] = True
        if contig:
            self._scores[:n] = scores
        else:
            self._scores[rows] = scores
        trig = scores > self.threshold
        trig &= has_ref
        return [sid for sid, t in zip(stream_ids, trig) if t]

    def _screen(self, toks: np.ndarray, refs: np.ndarray) -> np.ndarray:
        """fp32 fleet_drift scores of `toks` (n, T) against `refs`
        (n, buckets), as float64 on the host. Tokens are cast to int32
        on the host before the copy, as the reference casts them (half
        the bytes of int64), and made contiguous (`toks` may be a
        fancy-indexed row subset)."""
        t = torch.from_numpy(np.ascontiguousarray(toks, np.int32))
        r = torch.from_numpy(np.ascontiguousarray(refs, np.float32))
        fs, _ = ops.fleet_drift(t.to(self.device), r.to(self.device),
                                buckets=self.buckets,
                                vocab=int(self.vocab or 0), impl=self.impl)
        return fs.cpu().numpy().astype(np.float64)

    # -- snapshot / restore (elastic window rollback) ----------------------
    def state_dict(self) -> dict:
        """Host-side copy of all mutable state (dense prefix only);
        `load_state_dict` restores it exactly. Used by the elastic
        runtime to re-run a window after a mid-window device loss."""
        live = len(self._rows)
        return {"ids": self._rows.ids,
                "ref": self._ref[:live].copy(),
                "has_ref": self._has_ref[:live].copy(),
                "live": self._live[:live].copy(),
                "scores": self._scores[:live].copy()}

    def load_state_dict(self, state: dict):
        align = self._rows.align
        self._rows = RowRegistry(align=align)
        self._rows.reserve(len(state["ids"]))
        self._sync_capacity()
        for i, sid in enumerate(state["ids"]):
            row = self.add_stream(sid)
            assert row == i
        live = len(state["ids"])
        self._ref[:live] = state["ref"]
        self._has_ref[:live] = state["has_ref"]
        self._live[:live] = state["live"]
        self._scores[:live] = state["scores"]
