"""The arithmetic of the metric readers (`bench/metrics/<name>.py`), each
of which names one of these for its metric. Each returns None where the
run holds nothing to read."""
from __future__ import annotations

import functools
import math
import statistics

from bench.core import spec
from bench.core import yardstick as Y


def setup_s(run):
    return run.setup_s


def window_ms(run):
    """The whole measured time over the retraining windows it held."""
    if not run.windows:
        return None
    return 1e3 * run.window_s / len(run.windows)


def query_p95_ms(run):
    """95th percentile of due-to-last-token latency over every query due
    in the window: one in flight at the close at its age then, one never
    answered as missing (infinite)."""
    qs = run.in_window()
    if not qs:
        return None
    lat = [math.inf if q.tokens is None else q.latency(run.window_s)
           for q in qs]
    return 1e3 * Y.percentile(lat, 95)


def queries_per_s(run):
    """Queries' worth of answer tokens served in the window over its
    length: a query completed in it counts whole, one in flight at the
    close by the share of its answer served by then. (Counting only
    whole queries steps by a whole admission wave where a closed loop's
    queries move in lockstep.)"""
    if not run.queries:
        return None
    n = 0.0
    for q in run.queries:
        if q.done is not None and q.done <= run.window_s:
            n += 1.0
        elif q.tokens is not None:
            n += q.at_close / len(q.tokens)
    return n / run.window_s


def _spans_per_window(run, label):
    if not run.windows or not run.spans:
        return None
    return 1e3 * sum(s for n, _, _, s, _ in run.spans if n == label) \
        / len(run.windows)


def eval_ms(run):
    """Device time of the trainer's eval forwards, per window."""
    return _spans_per_window(run, "bench.eval")


def train_ms(run):
    """Device time of the trainer's micro-windows, per window."""
    return _spans_per_window(run, "bench.train")


def control_ms(run):
    """A window's time outside the trainer's eval forwards and
    micro-windows, per window."""
    if not run.windows or not run.spans:
        return None
    inside = sum(s for n, _, _, s, _ in run.spans
                 if n in ("bench.eval", "bench.train"))
    total = sum(b - a for a, b in run.windows)
    return 1e3 * (total - inside) / len(run.windows)


def admit_wait_ms(run):
    """Median time from a query's due time to its admission."""
    w = [q.admitted - q.due for q in run.in_window()
         if q.admitted is not None]
    return 1e3 * statistics.median(w) if w else None


def prefill_ms(run):
    """Device time of the batched prefills over the queries they
    admitted (a traced run's spans)."""
    pre = [(s, x["queries"]) for n, _, _, s, x in run.spans
           if n == "bench.prefill"]
    n = sum(k for _, k in pre)
    return 1e3 * sum(s for s, _ in pre) / n if n else None


def tick_ms(run):
    """Median of the plane's own tick clock over the window's ticks."""
    if not run.ticks:
        return None
    return 1e3 * statistics.median(t for _, t in run.ticks)


def roofline_pct(run, kernel: str):
    """Every launch of `kernel` (`bench/kernels/<kernel>.py`) in the
    profiled stretch: the bound on its work, from its own shapes, summed,
    over the device time of the kernel's device functions."""
    st = run.stretch
    if st is None or not st.launches.get(kernel) or run.peaks is None:
        return None
    k = spec.kernel(kernel)
    n, dev_s = st.device_s(k.DEVICE_NAMES)
    if not dev_s:
        return None
    pk = run.peaks
    bound = 0.0
    for rec in st.launches[kernel]:
        nbytes, flops, peak = k.cost(rec, pk)
        bound += Y.bound_s(nbytes, flops, peak, pk["bytes"])
    return 100.0 * bound / dev_s


def roofline(kernel: str):
    """`read(run)` of `kernel`'s roofline share, for a metric file."""
    return functools.partial(roofline_pct, kernel=kernel)


def idle_pct(run):
    st = run.stretch
    if st is None or st.wall_s <= 0 or not st.kernels:
        return None
    return 100.0 * (1.0 - st.busy_s / st.wall_s)


def mfu_pct(run):
    """Model FLOPs of the profiled stretch, counted from shapes, over its
    wall time at the bf16 dense peak."""
    st = run.stretch
    if st is None or st.wall_s <= 0 or not st.flops or run.peaks is None:
        return None
    return 100.0 * st.flops / (st.wall_s * run.peaks["bf16"])
