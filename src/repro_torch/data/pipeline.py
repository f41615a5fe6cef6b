"""Rate-limited group batcher — the data plane between streams and jobs.

Implements the paper's transmission-to-training handoff at system level:
each stream's delivered tokens (bounded by its realized GAIMD
bandwidth, repro_torch.core.gaimd) land in a per-group ring buffer;
`group_batch()` then draws a training batch that is *balanced across
members* (the paper's f*/n_j scaling), optionally attaching teacher soft
labels.

Pure host-side Python/NumPy by design: this layer feeds the device,
it never runs on it. A copy of the JAX package's `data/pipeline.py`:
equal seeds draw equal batches.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np


@dataclasses.dataclass
class StreamBuffer:
    """Per-stream ring buffer of delivered (tokens [, soft-label]) rows."""
    seq_len: int
    capacity: int = 512
    tokens: Optional[np.ndarray] = None      # (n, S)
    soft: Optional[np.ndarray] = None        # (n, S, V) teacher labels
    delivered_total: int = 0
    dropped_total: int = 0

    def push(self, toks: np.ndarray, soft: Optional[np.ndarray] = None):
        toks = np.asarray(toks).reshape(-1, self.seq_len)
        self.delivered_total += toks.shape[0]
        if self.tokens is None:
            self.tokens = toks
            self.soft = soft
        else:
            self.tokens = np.concatenate([self.tokens, toks])
            if soft is not None and self.soft is not None:
                self.soft = np.concatenate([self.soft, soft])
        if self.tokens.shape[0] > self.capacity:
            cut = self.tokens.shape[0] - self.capacity
            self.dropped_total += cut
            self.tokens = self.tokens[cut:]
            if self.soft is not None:
                self.soft = self.soft[cut:]

    def __len__(self) -> int:
        return 0 if self.tokens is None else self.tokens.shape[0]


class GroupPipeline:
    """Aggregates member buffers of one retraining job and serves
    member-balanced batches."""

    def __init__(self, seq_len: int, *, capacity_per_stream: int = 512,
                 seed: int = 0):
        self.seq_len = seq_len
        self.capacity = capacity_per_stream
        self.buffers: Dict[str, StreamBuffer] = {}
        self.rng = np.random.default_rng(seed)

    def ensure(self, stream_id: str) -> StreamBuffer:
        if stream_id not in self.buffers:
            self.buffers[stream_id] = StreamBuffer(
                self.seq_len, self.capacity)
        return self.buffers[stream_id]

    def deliver(self, stream_id: str, toks: np.ndarray,
                *, bandwidth_tokens: Optional[int] = None,
                soft: Optional[np.ndarray] = None):
        """Push a window of sampled sequences, truncated to the stream's
        bandwidth budget (tokens deliverable this window)."""
        toks = np.asarray(toks).reshape(-1, self.seq_len)
        if bandwidth_tokens is not None:
            n = max(0, bandwidth_tokens // self.seq_len)
            if soft is not None:
                soft = soft[:n]
            toks = toks[:n]
        if toks.shape[0]:
            self.ensure(stream_id).push(toks, soft)

    def drop_stream(self, stream_id: str):
        self.buffers.pop(stream_id, None)

    def total_rows(self) -> int:
        return sum(len(b) for b in self.buffers.values())

    def group_batch(self, batch: int, *, with_soft: bool = False
                    ) -> Optional[dict]:
        """Member-balanced sample of `batch` sequences. Returns
        {"inputs","labels"[,"teacher_logits"]} or None when empty."""
        live = {k: b for k, b in self.buffers.items() if len(b)}
        if not live:
            return None
        per = max(1, batch // len(live))
        rows, softs = [], []
        for b in live.values():
            idx = self.rng.integers(0, len(b), size=min(per, len(b)))
            rows.append(b.tokens[idx])
            if with_soft and b.soft is not None:
                softs.append(b.soft[idx])
        toks = np.concatenate(rows)
        if toks.shape[0] < batch:
            # top up from the pooled rows so short buffers don't shrink
            # the batch (with replacement; the pool is small by design)
            pool = np.concatenate([b.tokens for b in live.values()])
            extra = self.rng.integers(0, pool.shape[0],
                                      size=batch - toks.shape[0])
            toks = np.concatenate([toks, pool[extra]])
        toks = toks[:batch]
        out = {"inputs": toks, "labels": toks}
        if with_soft and softs:
            out["teacher_logits"] = np.concatenate(softs)[:batch]
        return out

    def stats(self) -> dict:
        return {k: {"rows": len(b), "delivered": b.delivered_total,
                    "dropped": b.dropped_total}
                for k, b in self.buffers.items()}
