"""What one run leaves for the metric readers and for the result line."""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

from bench.core.trace import Stretch


@dataclasses.dataclass
class Query:
    """One stream query of a serving run (times in seconds from the
    window's start)."""
    rid: str
    group: str
    due: float
    enqueued: Optional[float] = None
    admitted: Optional[float] = None
    done: Optional[float] = None
    tokens: Optional[List[int]] = None
    prompt: Optional[object] = None      # the prompt's token ids
    at_close: int = 0                    # tokens served by the close

    def latency(self, end: float) -> float:
        """Due to last token; a query still in flight at `end` counts at
        its age then."""
        if self.done is not None and self.done <= end:
            return self.done - self.due
        return end - self.due


@dataclasses.dataclass
class Check:
    """One number compared, beside its limit (it passes at or under it).
    A name with a dot (`control.<number>`, `half.<number>`) is a reading of
    the control or of a planted fault, which `bench/control.py` asks for
    and which does not decide `correct`."""
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return (not math.isnan(self.value)) and self.value <= self.limit


@dataclasses.dataclass
class Run:
    cell: str
    config: dict
    traffic: dict
    setup_s: float = 0.0
    window_s: float = 0.0
    attempted: int = 0
    failed: int = 0
    # serving runs
    queries: List[Query] = dataclasses.field(default_factory=list)
    ticks: List[Tuple[int, float]] = dataclasses.field(default_factory=list)
    # retraining runs: each window's (start, end)
    windows: List[Tuple[float, float]] = dataclasses.field(
        default_factory=list)
    # a traced run's spans around calls into the program's layers
    # (bench/core/trace.py `Spans`): (label, start, end, seconds, extra)
    spans: List[tuple] = dataclasses.field(default_factory=list)
    stretch: Optional[Stretch] = None
    peaks: Optional[dict] = None
    memory_peak_bytes: int = 0
    checks: List[Check] = dataclasses.field(default_factory=list)
    notes: Dict[str, object] = dataclasses.field(default_factory=dict)

    @property
    def correct(self) -> bool:
        mine = [c for c in self.checks if "." not in c.name]
        return bool(mine) and all(c.ok for c in mine)

    def in_window(self) -> List[Query]:
        return [q for q in self.queries if q.due < self.window_s]
