"""Synthetic drifting token streams with controllable cross-stream
correlation — the CARLA substitute.

Each *region* owns a latent domain trajectory (a sequence of domain
switches over time). A stream belongs to a region and follows the
region's trajectory with a per-stream lag and noise, so streams in the
same region experience *correlated drift* (the paper's premise), while
streams in different regions drift independently.

A *domain* d is a seeded random bigram language: next ~ Cat(P_d[prev]).
P_d = softmax(E_d E_d^T / tau) over a shared vocab, so a student model
genuinely has to adapt its predictions when the domain switches, and a
"teacher" with access to P_d provides ground-truth soft labels
(the paper's high-accuracy teacher annotating frames).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


class DomainBank:
    """Shared collection of bigram domains over one vocab."""

    def __init__(self, vocab: int, num_domains: int, *, dim: int = 8,
                 tau: float = 0.15, seed: int = 0):
        self.vocab = vocab
        self.num_domains = num_domains
        rng = np.random.default_rng(seed)
        self.P = np.zeros((num_domains, vocab, vocab), np.float64)
        for d in range(num_domains):
            E = rng.normal(size=(vocab, dim))
            logits = E @ E.T / (tau * np.sqrt(dim))
            # kill self-transitions: the raw Gram diagonal (|E_i|^2) would
            # make chains collapse into constant runs, turning the task
            # into trivial copying and starving the drift detector of
            # distributional signal
            np.fill_diagonal(logits, -np.inf)
            logits -= logits.max(axis=1, keepdims=True)
            p = np.exp(logits)
            self.P[d] = p / p.sum(axis=1, keepdims=True)

    def sample(self, domain: int, rng: np.random.Generator, batch: int,
               seq_len: int, mix_with: Optional[int] = None,
               mix_frac: float = 0.0) -> np.ndarray:
        """Sample (batch, seq_len) token sequences from a domain (optionally
        a mixture during gradual drift)."""
        P = self.P[domain]
        if mix_with is not None and mix_frac > 0:
            P = (1 - mix_frac) * P + mix_frac * self.P[mix_with]
        out = np.empty((batch, seq_len), np.int64)
        tok = rng.integers(0, self.vocab, size=batch)
        cum = np.cumsum(P, axis=1)
        for s in range(seq_len):
            out[:, s] = tok
            u = rng.random(batch)
            # vectorized per-row searchsorted: left insertion point ==
            # count of cum-cells strictly below the draw (data
            # generation dominates fleet benchmarks at 10k streams; the
            # per-row Python np.searchsorted loop was the hot spot)
            tok = (cum[tok] < u[:, None]).sum(axis=1)
            tok = np.minimum(tok, self.vocab - 1)
        return out

    def soft_labels(self, domain: int, tokens: np.ndarray) -> np.ndarray:
        """Ground-truth next-token distribution (the perfect teacher).
        tokens: (B,S) -> (B,S,V)."""
        return self.P[domain][tokens]


@dataclasses.dataclass
class Region:
    """Latent domain trajectory shared by co-located streams."""
    region_id: str
    schedule: List[Tuple[float, int]]     # (switch_time, domain) sorted

    def domain_at(self, t: float) -> int:
        d = self.schedule[0][1]
        for ts, dom in self.schedule:
            if t >= ts:
                d = dom
            else:
                break
        return d


class Stream:
    """One camera-equivalent: emits token batches from its region's
    current domain (with lag/noise), carries spatial metadata."""

    def __init__(self, stream_id: str, bank: DomainBank, region: Region,
                 loc: Sequence[float], *, lag: float = 0.0,
                 noise_domain_prob: float = 0.0, seed: int = 0):
        self.stream_id = stream_id
        self.bank = bank
        self.region = region
        self.loc = tuple(loc)
        self.lag = lag
        self.noise_domain_prob = noise_domain_prob
        self.rng = np.random.default_rng(seed)

    def domain_at(self, t: float) -> int:
        d = self.region.domain_at(t - self.lag)
        if self.noise_domain_prob and self.rng.random() < self.noise_domain_prob:
            d = int(self.rng.integers(0, self.bank.num_domains))
        return d

    def sample(self, t: float, batch: int, seq_len: int) -> np.ndarray:
        return self.bank.sample(self.domain_at(t), self.rng, batch, seq_len)

    def sample_labeled(self, t: float, batch: int, seq_len: int):
        toks = self.sample(t, batch, seq_len)
        soft = self.bank.soft_labels(self.domain_at(t), toks)
        return toks, soft


def make_fleet(*, vocab: int = 64, num_domains: int = 6, dim: int = 4,
               regions: int = 2, streams_per_region: int = 3,
               region_spread: float = 10.0, region_distance: float = 1000.0,
               switch_times: Sequence[float] = (100.0,),
               seed: int = 0) -> Tuple[DomainBank, List[Stream]]:
    """Build a fleet with correlated drift inside regions. Each region
    switches domains at `switch_times` (staggered by region).

    vocab=64/dim=8 calibrates domain difficulty so a smoke-scale student
    approaches the Bayes ceiling within ~1 retraining window — matching
    the paper's lightweight-model regime (fast adaptation possible, drift
    costly if unhandled)."""
    bank = DomainBank(vocab, num_domains, dim=dim, seed=seed)
    rng = np.random.default_rng(seed + 1)
    streams: List[Stream] = []
    for r in range(regions):
        doms = rng.permutation(num_domains)
        sched = [(0.0, int(doms[0]))]
        for i, ts in enumerate(switch_times):
            sched.append((ts + 5.0 * r, int(doms[(i + 1) % num_domains])))
        region = Region(f"region{r}", sched)
        cx, cy = r * region_distance, 0.0
        for s in range(streams_per_region):
            loc = (cx + rng.uniform(-region_spread, region_spread),
                   cy + rng.uniform(-region_spread, region_spread))
            streams.append(Stream(
                f"cam{r}_{s}", bank, region, loc,
                lag=rng.uniform(0.0, 2.0), seed=seed + 10 * r + s))
    return bank, streams
