"""The program's span record: named intervals at the port's layer
boundaries (a retraining window and its six steps, the trainer's eval
forwards and micro-windows, the train step's gradients and update, a
query's wait in the serving plane's queue, its batched prefill, the decode
tick), for an operator or a benchmark that asks where a window's or a
query's time goes. This is not the golden traces of `testing/trace.py`,
which record the controller's decisions and are compared against the JAX
package's; nothing here changes a decision or a token.

Tracing is off by default. Off, `span` returns one shared no-op context
after a single check of a module flag, and `begin` / `end` return at once.
On (`enable()`), a span records its name, an integer id, the id of the
span open around it, its host start and end (`time.perf_counter()`) and
its attributes, and enters `torch.profiler.record_function(name)`, so
that a profiled run sees it on the kernels' clock. `span(...,
device=True)` also records a pair of CUDA events on the current stream,
read only in `collect()`, so that no span makes the host wait; where CUDA
is not initialised it falls back to the host clock. `begin` / `end` record
a span that opens in one call and closes in another, keyed by a request
id (a query's wait in the queue): they enter no `record_function`, since
the host is not inside them. `annotate` adds attributes to the innermost
open span, for what is known only inside it. `count(name)` adds one to a
named counter (a kernel's launches by path) while tracing is on;
`counters()` returns them and clears them.

Spans stay in memory until `collect()` returns and clears them. The record
is one per process, as the profiler is; the port drives it from one
thread.
"""
from __future__ import annotations

import collections
import itertools
import time
from typing import Dict, List, NamedTuple, Optional

import torch


class Span(NamedTuple):
    name: str
    id: int
    parent: Optional[int]     # the id of the span open around it
    start: float              # host clock, time.perf_counter()
    end: float
    seconds: float            # device time for a device span on the card
    attrs: dict


class _Null:
    """The context `span` returns while tracing is off."""
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL = _Null()
_on = False
_ids = itertools.count(1)
_stack: List["_Live"] = []              # the open spans, innermost last
_done: list = []                        # (Span fields, CUDA events or None)
_open: Dict[tuple, tuple] = {}          # (name, key) -> (start, attrs)
_counts: Dict[str, int] = collections.Counter()


def enable():
    global _on
    _on = True


def disable():
    """Stops recording; waits begun and not ended are forgotten."""
    global _on
    _on = False
    _open.clear()


def enabled() -> bool:
    return _on


class _Live:
    __slots__ = ("name", "attrs", "device", "id", "parent", "t0", "ev",
                 "rf")

    def __init__(self, name, device, attrs):
        self.name, self.device, self.attrs = name, device, attrs

    def __enter__(self):
        self.parent = _stack[-1].id if _stack else None
        self.id = next(_ids)
        _stack.append(self)
        self.ev = None
        if self.device and torch.cuda.is_initialized():
            self.ev = (torch.cuda.Event(enable_timing=True),
                       torch.cuda.Event(enable_timing=True))
            self.ev[0].record()
        self.rf = torch.profiler.record_function(self.name)
        self.rf.__enter__()
        self.t0 = time.perf_counter()

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        self.rf.__exit__(*exc)
        if self.ev is not None:
            self.ev[1].record()
        _stack.pop()
        _done.append(((self.name, self.id, self.parent, self.t0, t1),
                      self.ev, self.attrs))
        return False


def span(name: str, device: bool = False, **attrs):
    """A context manager that records `name` around its body while tracing
    is on (see the module docstring)."""
    if not _on:
        return _NULL
    return _Live(name, device, attrs)


def annotate(**attrs):
    """Adds `attrs` to the innermost open span, for what is known only
    inside it (whether a tick replayed graphs); nothing while tracing is
    off or no span is open."""
    if _on and _stack:
        _stack[-1].attrs.update(attrs)


def begin(name: str, key, **attrs):
    """Opens `name` for request `key`; `end(name, key)` closes it."""
    if _on:
        _open[(name, key)] = (time.perf_counter(), attrs)


def end(name: str, key, **attrs):
    """Closes the `name` that `begin` opened for `key`, with `key` and both
    calls' `attrs` as its attributes; a key never begun (tracing was off
    then) records nothing."""
    if not _on:
        return
    got = _open.pop((name, key), None)
    if got is not None:
        t0, a = got
        _done.append(((name, next(_ids), None, t0, time.perf_counter()),
                      None, {"key": key, **a, **attrs}))


def count(name: str, n: int = 1):
    """Adds `n` to the counter `name` while tracing is on."""
    if _on:
        _counts[name] += n


def counters() -> Dict[str, int]:
    """The counters since the last call, and clears them."""
    out = dict(_counts)
    _counts.clear()
    return out


def collect() -> List[Span]:
    """The spans finished since the last call, in the order they ended,
    and clears them. Reads the device spans' CUDA events, after waiting
    for the device."""
    done = list(_done)
    _done.clear()
    if any(ev is not None for _, ev, _ in done):
        torch.cuda.synchronize()
    out = []
    for (name, sid, parent, a, b), ev, attrs in done:
        s = ev[0].elapsed_time(ev[1]) / 1e3 if ev is not None else b - a
        out.append(Span(name, sid, parent, a, b, s, attrs))
    return out
