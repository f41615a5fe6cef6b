"""Straggler detection and mitigation for micro-window scheduling,
ported from the JAX package's `distributed/stragglers.py` as it is.

ECCO time-shares the accelerator across group-retraining jobs in micro-
windows. A straggling job (slow host ingest, contended slice, failing
NIC) stretches its micro-windows and starves the schedule. Mitigation is
*quota re-normalization*: each job's micro-window is a step quota, and
jobs whose measured step time exceeds  median * threshold  get their
quota shrunk proportionally so wall-clock stays bounded — the allocator
then sees a smaller AccGain for the straggler and de-prioritizes it,
which is exactly the paper's own feedback loop doing double duty as
straggler mitigation.

Pure control-plane host code; consumed by the controller (through the
allocator's duck-typed `stragglers=`) and the fault-tolerance tests.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np


@dataclasses.dataclass
class StepStats:
    times: List[float] = dataclasses.field(default_factory=list)

    def push(self, dt: float, *, cap: int = 64):
        self.times.append(dt)
        if len(self.times) > cap:
            self.times = self.times[-cap:]

    @property
    def mean(self) -> float:
        return float(np.mean(self.times)) if self.times else 0.0


class StragglerPolicy:
    def __init__(self, *, threshold: float = 2.0, min_quota_frac: float = 0.25,
                 window: int = 16):
        self.threshold = threshold
        self.min_quota_frac = min_quota_frac
        self.window = window
        self.stats: Dict[str, StepStats] = {}
        self.flagged: Dict[str, int] = {}

    def record(self, job_id: str, step_time: float):
        self.stats.setdefault(job_id, StepStats()).push(step_time,
                                                        cap=self.window)

    def median_step_time(self) -> float:
        means = [s.mean for s in self.stats.values() if s.times]
        return float(np.median(means)) if means else 0.0

    def is_straggler(self, job_id: str) -> bool:
        med = self.median_step_time()
        s = self.stats.get(job_id)
        if not s or not s.times or med <= 0:
            return False
        return s.mean > self.threshold * med

    def quota(self, job_id: str, base_quota: int) -> int:
        """Steps this job may run in its next micro-window. Stragglers
        get base * median/mean (bounded below) so wall time per
        micro-window stays ~constant across jobs."""
        med = self.median_step_time()
        s = self.stats.get(job_id)
        if not s or not s.times or med <= 0:
            return base_quota
        ratio = med / max(s.mean, 1e-9)
        if s.mean > self.threshold * med:
            self.flagged[job_id] = self.flagged.get(job_id, 0) + 1
            ratio = max(self.min_quota_frac, ratio)
            return max(1, int(round(base_quota * ratio)))
        return base_quota

    def report(self) -> dict:
        med = self.median_step_time()
        return {
            "median_step_time": med,
            "jobs": {
                j: {"mean": s.mean,
                    "straggler": self.is_straggler(j),
                    "times_flagged": self.flagged.get(j, 0)}
                for j, s in self.stats.items()
            },
        }
