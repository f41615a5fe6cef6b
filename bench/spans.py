"""One cell of BENCHMARK.json run as `bench/run.py --trace 1` runs it, with
the program's own tracer (`repro_torch.tracing`) on from set-up to the end
of the run:

    python3 bench/spans.py --workload <cell> --seed <n> --seconds <s>

It prints the traced result line of `bench/run.py`, with one more key,
`program`: the readings of the program's spans (`bench/core/program.py`)
for the cell's end-to-end metric (`.window`, `.p95` or `.qps`), the
device's idle seconds in the profiled stretch under each `ecco.` span and
the count of each, and each span's summed seconds over the measured
window. `bench/run.py` leaves the tracer off, so its `--trace 1` line has
none of these.
"""
from __future__ import annotations

import argparse
import collections
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from bench import run as R  # noqa: E402
from bench.core import device as D  # noqa: E402
from bench.core import program as P  # noqa: E402
from bench.core import spec  # noqa: E402
from bench.core import trace as T  # noqa: E402
from bench.core import yardstick as Y  # noqa: E402

METRICS = ("update_ms.window", "update_gap_ms.window", "grads_gap_ms.window",
           "queue_wait_ms.p95", "prefill_gap_ms.p95",
           "tick_layers_gap_ms.p95", "tick_layers_gap_ms.qps")
SUFFIX = {"window_ms": ".window", "query_p95_ms": ".p95",
          "queries_per_s": ".qps"}


def traced(cell, seed: int, seconds: float, dev=None):
    """The cell's traced run with the program's tracer on; the run carries
    `program_spans` and its stretch `program_gaps` / `program_counts`."""
    from repro_torch import tracing
    read = T.read

    def read_with_program(prof, *a, **k):
        st = read(prof, *a, **k)
        st.program_gaps, st.program_counts = P.gaps(prof.events())
        return st
    T.read = read_with_program
    tracing.collect()
    tracing.enable()
    try:
        run = R.driver(cell.traffic["kind"]).run(cell, seed, seconds, True,
                                                 dev=dev)
    finally:
        tracing.disable()
        T.read = read
    run.program_spans = _from_t0(run, tracing.collect())
    return run


def _from_t0(run, spans) -> list:
    """Span times in seconds from the window's start: a serving run notes
    its start; a retraining run's measured windows are its last ones."""
    t0 = run.notes.get("t0")
    if t0 is None:
        wins = [s for s in spans if s.name == "ecco.window"]
        if not run.windows or len(wins) < len(run.windows):
            return []
        t0 = wins[-len(run.windows)].start - run.windows[0][0]
    return [s._replace(start=s.start - t0, end=s.end - t0) for s in spans]


def program_line(cell, run) -> dict:
    mine = tuple(SUFFIX[m.name] for m in cell.metrics
                 if m.end_to_end and m.name in SUFFIX
                 and m.applies_to(cell.name))
    metrics = {}
    for name in METRICS:
        if name.endswith(mine):
            value = spec.reader(name, cell.root)(run)
            if value is not None:
                metrics[name] = value
    seconds = collections.defaultdict(float)
    for s in run.program_spans:
        if 0.0 <= s.start <= run.window_s:
            seconds[s.name] += s.seconds
    st = run.stretch
    return {"metrics": metrics,
            "idle_s": getattr(st, "program_gaps", None),
            "counts": getattr(st, "program_counts", None),
            "window_s_by_span": dict(seconds),
            "generator_late_ms": run.notes.get("generator_late_ms")}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    cell = spec.cell(args.workload)
    D.require_cuda(cell.chips)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = D.card()
    run = traced(cell, args.seed, args.seconds)
    run.peaks = Y.peaks(card["kind"])
    bad = D.forbidden_modules()
    if bad:
        print(f"bench: modules of JAX or the JAX package are loaded: {bad}",
              file=sys.stderr)
        return 3
    line = R.result(cell, run, True, card)
    line["program"] = program_line(cell, run)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except D.NoDevice as e:
        print(str(e), file=sys.stderr)
        sys.exit(2)
