"""The program's own spans (`repro_torch.tracing`, every name `ecco.`) in a
traced run: where the device sat idle under each of them, and the
per-layer metrics that read them. `bench/spans.py` runs a cell with the
program's tracer on and fills what these readers take:

* `run.program_spans`: the spans the program recorded, each (name, id,
  parent, start, end, seconds, attrs), times in seconds from the window's
  start;
* `run.stretch.program_gaps`: seconds of device idle time in the profiled
  stretch whose midpoint falls inside a host event named `ecco.*`, added
  once to each distinct name that encloses it (`gaps`);
* `run.stretch.program_counts`: the number of such host events of each
  name in the stretch.

A run without them (every run of `bench/run.py`, which leaves the
program's tracer off) reads None from each reader, as the other readers do
where a run holds nothing to read.
"""
from __future__ import annotations

import bisect
import collections
import statistics
from typing import Dict, Tuple

import torch

PREFIX = "ecco."


def _device_work(e) -> bool:
    """A kernel or copy on the card, not the mirror of a host annotation
    (the benchmark's spans, the program's, the profiler's steps)."""
    return (e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)
            and not e.name.startswith(("bench.", PREFIX, "ProfilerStep")))


def gaps(events) -> Tuple[Dict[str, float], Dict[str, int]]:
    """(program_gaps, program_counts) of a profile's events: the device's
    idle gaps (between the end of all work so far and the next start)
    attributed to every distinct `ecco.` name of the host events that
    enclose the gap's midpoint, in seconds; and the count of those host
    events by name."""
    dev, host = [], []
    for e in events:
        if _device_work(e):
            dev.append((e.time_range.start, e.time_range.end))
        elif e.device_type == torch.autograd.DeviceType.CPU and \
                e.name.startswith(PREFIX):
            host.append((e.time_range.start, e.time_range.end, e.name))
    dev.sort()
    mids, lens, end = [], [], None
    for a, b in dev:
        if end is not None and a > end:
            mids.append((a + end) / 2)
            lens.append((a - end) / 1e6)
        end = b if end is None else max(end, b)
    inside: Dict[str, set] = collections.defaultdict(set)
    counts: Dict[str, int] = collections.Counter()
    for a, b, name in host:
        counts[name] += 1
        lo, hi = bisect.bisect_left(mids, a), bisect.bisect_right(mids, b)
        inside[name].update(range(lo, hi))
    return ({n: sum(lens[i] for i in idx) for n, idx in inside.items()},
            dict(counts))


def _spans(run, name):
    return [s for s in (getattr(run, "program_spans", None) or ())
            if s[0] == name]


def _stretch(run):
    st = run.stretch
    g = getattr(st, "program_gaps", None)
    c = getattr(st, "program_counts", None)
    return (g, c) if g is not None and c is not None else (None, None)


def update_ms(run):
    """Device time of the train step's AdamW update (`ecco.train.update`)
    over the measured windows, per window."""
    upd = [s for s in _spans(run, "ecco.train.update")
           if 0.0 <= s[3] <= run.window_s]
    if not run.windows or not upd:
        return None
    return 1e3 * sum(s[5] for s in upd) / len(run.windows)


def _gap_per_window(run, name):
    g, c = _stretch(run)
    if g is None or not c.get("ecco.window"):
        return None
    return 1e3 * g.get(name, 0.0) / c["ecco.window"]


def update_gap_ms(run):
    """Device idle time under the AdamW update, per window the profiled
    stretch holds."""
    return _gap_per_window(run, "ecco.train.update")


def grads_gap_ms(run):
    """Device idle time under the gradients' forward and backward, per
    window the profiled stretch holds."""
    return _gap_per_window(run, "ecco.train.grads")


def queue_wait_ms(run):
    """Median time a query due in the window waited in the plane's queue,
    from its enqueue to its admission."""
    due = {q.rid for q in run.in_window()}
    w = [s[4] - s[3] for s in _spans(run, "ecco.query.queue")
         if s[6].get("key") in due and not s[6].get("dropped")]
    return 1e3 * statistics.median(w) if w else None


def prefill_gap_ms(run):
    """Device idle time under the batched prefills, per prefill."""
    g, c = _stretch(run)
    if g is None or not c.get("ecco.prefill"):
        return None
    return 1e3 * g.get("ecco.prefill", 0.0) / c["ecco.prefill"]


def tick_layers_gap_ms(run):
    """Device idle time under the fleet tick's layer loop, per tick."""
    g, c = _stretch(run)
    if g is None or not c.get("ecco.tick"):
        return None
    return 1e3 * g.get("ecco.tick.layers", 0.0) / c["ecco.tick"]
