"""The camera fleet a run replays: seeded bigram domains over the model's
vocabulary, regions whose domain switches at fixed times, and streams
(cameras) that follow their region with a lag. A frozen copy of the
program's scenario generator (`repro_torch/data/streams.py` `DomainBank`,
`Region`, `Stream`; `data/scenarios.py` `drift_wave`), with two changes
that keep the draws' distribution and cut their cost: the bank keeps each
domain's cumulative transition table (the sampler's only input) instead of
recomputing it per draw, and one bank serves every episode of a run, each
episode placing its own regions and streams from its own seed. Its
streams have the interface the controller reads (`stream_id`, `loc`,
`sample`).
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np


class DomainBank:
    """Seeded random bigram languages over one vocabulary: domain d draws
    next ~ Cat(P_d[prev]) with P_d = softmax(E_d E_d^T / tau), no
    self-transitions."""

    def __init__(self, vocab: int, num_domains: int, *, dim: int = 4,
                 tau: float = 0.15, seed: int = 0):
        self.vocab = vocab
        self.num_domains = num_domains
        rng = np.random.default_rng(seed)
        self.cum = np.zeros((num_domains, vocab, vocab), np.float64)
        for d in range(num_domains):
            E = rng.normal(size=(vocab, dim))
            logits = E @ E.T / (tau * np.sqrt(dim))
            np.fill_diagonal(logits, -np.inf)
            logits -= logits.max(axis=1, keepdims=True)
            p = np.exp(logits)
            p /= p.sum(axis=1, keepdims=True)
            np.cumsum(p, axis=1, out=self.cum[d])

    def sample(self, domain: int, rng: np.random.Generator, batch: int,
               seq_len: int) -> np.ndarray:
        cum = self.cum[domain]
        out = np.empty((batch, seq_len), np.int64)
        tok = rng.integers(0, self.vocab, size=batch)
        for s in range(seq_len):
            out[:, s] = tok
            u = rng.random(batch)
            tok = (cum[tok] < u[:, None]).sum(axis=1)
            tok = np.minimum(tok, self.vocab - 1)
        return out


class Region:
    """A latent domain trajectory shared by co-located streams."""

    def __init__(self, region_id: str, schedule: List[Tuple[float, int]]):
        self.region_id = region_id
        self.schedule = schedule

    def domain_at(self, t: float) -> int:
        d = self.schedule[0][1]
        for ts, dom in self.schedule:
            if t >= ts:
                d = dom
            else:
                break
        return d


class Stream:
    """One camera: token batches from its region's current domain, with a
    lag. Every draw it hands out is also kept in `emitted`, so that a
    check can trace the rows a job trained on back to a camera."""

    def __init__(self, stream_id: str, bank: DomainBank, region: Region,
                 loc: Sequence[float], *, lag: float = 0.0, seed: int = 0):
        self.stream_id = stream_id
        self.bank = bank
        self.region = region
        self.loc = tuple(loc)
        self.lag = lag
        self.rng = np.random.default_rng(seed)
        self.emitted: List[np.ndarray] = []

    def domain_at(self, t: float) -> int:
        return self.region.domain_at(t - self.lag)

    def sample(self, t: float, batch: int, seq_len: int) -> np.ndarray:
        out = self.bank.sample(self.domain_at(t), self.rng, batch, seq_len)
        self.emitted.append(out)
        return out


def drift_wave(bank: DomainBank, *, regions: int, streams_per_region: int,
               wave_start: float, wave_step: float, seed: int
               ) -> List[Stream]:
    """A drift front sweeps across regions in spatial order: region r
    switches domain at wave_start + r * wave_step."""
    rng = np.random.default_rng(seed + 1)
    streams: List[Stream] = []
    for r in range(regions):
        doms = rng.permutation(bank.num_domains)
        region = Region(f"region{r}", [(0.0, int(doms[0])),
                                       (wave_start + r * wave_step,
                                        int(doms[1]))])
        for s in range(streams_per_region):
            loc = (r * 1000.0 + rng.uniform(-10.0, 10.0),
                   rng.uniform(-10.0, 10.0))
            streams.append(Stream(f"cam{r}_{s}", bank, region, loc,
                                  lag=rng.uniform(0.0, 2.0),
                                  seed=seed + 10 * r + s))
    return streams
