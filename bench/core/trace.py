"""The traced stretch of a `--trace 1` run: torch.profiler over a part of
the measured window, the benchmark's own spans around the program's
layers, and the launches of the hand-written kernels, one file each under
`bench/kernels/`. Nothing here is switched on in a `--trace 0` run.

The profiler has dropped the first launches of a session on the card
(PERF.md), so a stretch opens with a warm-up step that it discards, as
`chip_smoke.py`'s `_device_ms` does.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import importlib
import time
from typing import Dict, List, Tuple

import torch

from bench.core import spec


@dataclasses.dataclass
class Stretch:
    """What one traced stretch saw."""
    wall_s: float = 0.0
    busy_s: float = 0.0
    kernels: Dict[str, Tuple[int, float]] = dataclasses.field(
        default_factory=dict)          # name -> (launches, device seconds)
    idle_gaps: List[Tuple[str, float]] = dataclasses.field(
        default_factory=list)
    # kernel file's name -> each launch's record (`bench/kernels/<name>.py`)
    launches: Dict[str, list] = dataclasses.field(default_factory=dict)
    flops: float = 0.0                 # model FLOPs the stretch did

    def device_s(self, names) -> Tuple[int, float]:
        n, t = 0, 0.0
        for key, (c, s) in self.kernels.items():
            if any(k in key for k in names):
                n += c
                t += s
        return n, t


class Recorder:
    """Wraps the port's op of each kernel file (`bench/kernels/<name>.py`,
    its `TARGET`) and records each launch (its `record(args, kwargs)`)
    under the file's name while `on`."""

    def __init__(self):
        self.on = False
        self.launches: Dict[str, list] = collections.defaultdict(list)
        self._undo = []

    def install(self):
        for name, k in spec.kernels().items():
            where, attr = k.TARGET.split(":")
            mod = importlib.import_module(where)
            op = getattr(mod, attr)
            setattr(mod, attr, self._recorded(name, k.record, op))
            self._undo.append(lambda m=mod, a=attr, f=op: setattr(m, a, f))

    def _recorded(self, name, record, op):
        def recorded(*args, **kwargs):
            if self.on:
                self.launches[name].append(record(args, kwargs))
            return op(*args, **kwargs)
        return recorded

    def uninstall(self):
        for f in reversed(self._undo):
            f()
        self._undo.clear()


class Spans:
    """Spans around calls into the program's layers, each (label, host
    start, host end, seconds, extra). On the card the seconds are the
    device time between two CUDA events recorded around the call, read
    once the window has closed, so that no span makes the host wait; on
    the CPU they are the host clock's. The profiler sees the label too."""

    def __init__(self):
        self.items: list = []
        self.cuda = torch.cuda.is_available()

    @contextlib.contextmanager
    def __call__(self, label: str, **extra):
        ev = None
        if self.cuda:
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record()
        t0 = time.perf_counter()
        with torch.profiler.record_function(label):
            yield
        if ev is not None:
            ev[1].record()
        self.items.append((label, t0, time.perf_counter(), ev, extra))

    def clear(self):
        self.items.clear()

    def resolve(self, t0: float = 0.0) -> list:
        """(label, start, end, seconds, extra), times from `t0`."""
        _sync()
        return [(label, a - t0, b - t0,
                 ev[0].elapsed_time(ev[1]) / 1e3 if ev else b - a, extra)
                for label, a, b, ev, extra in self.items]


def _sync():
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def _activities():
    from torch.profiler import ProfilerActivity
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return acts


def prime():
    """One empty profiler session. A process's first session takes seconds
    to start (the profiler's and CUPTI's own set-up); a traced run primes
    it in set-up, so that the stretch it profiles later starts at once."""
    from torch.profiler import profile
    with profile(activities=_activities()):
        torch.zeros(1, device="cuda" if torch.cuda.is_available()
                    else "cpu").add_(1)
    _sync()


class Profile:
    """torch.profiler around a stretch: `warm()` ends the discarded
    warm-up step, `stop()` the recorded one."""

    def __init__(self, recorder: Recorder):
        from torch.profiler import profile, schedule
        self.rec = recorder
        self.prof = profile(activities=_activities(),
                            schedule=schedule(wait=0, warmup=1, active=1))
        self.t0 = None
        self.wall = None
        self.flops = 0.0

    def start(self):
        _sync()
        self.prof.__enter__()

    def warm(self):
        _sync()
        self.prof.step()
        self.rec.on = True
        self.t0 = time.perf_counter()

    def stop(self):
        """Ends the stretch. The profiler parses its events as it stops,
        which takes seconds: callers stop it where no measured work waits
        (after a retraining window, after a serving window's close).
        `result()` reads them."""
        if self.t0 is None:               # closed during the warm-up step
            self.warm()
        _sync()
        self.wall = time.perf_counter() - self.t0
        self.rec.on = False
        self.prof.__exit__(None, None, None)
        self.launches = dict(self.rec.launches)
        self.rec.launches.clear()

    def result(self) -> "Stretch":
        return read(self.prof, self.wall, self.launches, self.flops)


def _kernel(e) -> bool:
    """A device event that is work: a kernel or a copy, not the GPU-side
    mirror of a host annotation (the benchmark's spans, the profiler's
    steps)."""
    return (e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)
            and not e.name.startswith(("bench.", "ProfilerStep")))


def read(prof, wall: float, launches: Dict[str, list],
         flops: float) -> Stretch:
    """Busy time, kernel sums and the longest idle gaps of a profile."""
    events = prof.events()
    dev, host = [], []
    for e in events:
        if _kernel(e):
            dev.append((e.time_range.start, e.time_range.end, e.name))
        elif e.device_type == torch.autograd.DeviceType.CPU and \
                e.name.startswith("bench."):
            host.append((e.time_range.start, e.time_range.end, e.name))
    dev.sort()
    kernels: Dict[str, list] = collections.defaultdict(lambda: [0, 0.0])
    busy, end, gaps = 0.0, None, []
    for a, b, name in dev:
        k = kernels[name]
        k[0] += 1
        k[1] += (b - a) / 1e6
        if end is None:
            busy += b - a
            end = b
        elif b > end:
            if a > end:
                gaps.append((end, a))
            busy += b - max(a, end)
            end = b
    by_host: Dict[str, float] = collections.defaultdict(float)
    host.sort(key=lambda h: h[1] - h[0])          # innermost span first
    for a, b in gaps:
        mid = (a + b) / 2
        label = next((n for s, e, n in host if s <= mid <= e), "other")
        by_host[label] += (b - a) / 1e6
    return Stretch(wall_s=wall, busy_s=busy / 1e6,
                   kernels={k: (v[0], v[1]) for k, v in kernels.items()},
                   idle_gaps=sorted(by_host.items(), key=lambda x: -x[1]),
                   launches=launches, flops=flops)


def breakdown(st: Stretch) -> dict:
    """The ten device operations that took most time, and the ten
    longest summed idle gaps by the span the host was in."""
    ops = sorted(((k, v[1]) for k, v in st.kernels.items()),
                 key=lambda x: -x[1])[:10]
    return {"device_ops": [[k[:120], s] for k, s in ops],
            "idle_gaps": [[k, s] for k, s in st.idle_gaps[:10]]}
