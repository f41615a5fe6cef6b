"""The rate sweep that places an open-loop cell's rate: the cell's traffic
at each given rate for `--seconds`, printing per rate the queries offered
and completed a second, the median and 95th-percentile latency over each
half of the window (a backlog that grows shows as a second half slower
than the first) and the queries still queued or in flight at the close.
Run once when a cell is defined; the cell's file then holds 0.8 of the
highest rate sustained. Not run by the benchmark's runs.

    python3 bench/sweep.py --workload olmo-1b.query-burst --rates 32,40,48,56 --seconds 20
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from bench.core import device as D  # noqa: E402
from bench.core import spec  # noqa: E402
from bench.core import yardstick as Y  # noqa: E402
from bench.drivers import serve  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--seed", type=int, default=4000000001)
    args = ap.parse_args(argv)
    cell = spec.cell(args.workload)
    D.require_cuda(cell.chips)
    card = D.card()
    cell.traffic["check_queries"] = 4
    for rate in (float(r) for r in args.rates.split(",")):
        cell.traffic["rate"] = rate
        run = serve.run(cell, args.seed, args.seconds, False)
        qs = run.in_window()
        half = args.seconds / 2
        lat = [q.latency(run.window_s) for q in qs]
        first = [x for q, x in zip(qs, lat) if q.due < half]
        second = [x for q, x in zip(qs, lat) if q.due >= half]
        done = sum(1 for q in qs if q.done is not None
                   and q.done <= run.window_s)
        print(json.dumps({
            "workload": cell.name, "rate": rate, "card": card,
            "offered_per_s": len(qs) / args.seconds,
            "completed_per_s": done / args.seconds,
            "p50_ms": 1e3 * Y.percentile(lat, 50),
            "p95_ms": 1e3 * Y.percentile(lat, 95),
            "p95_first_half_ms": 1e3 * Y.percentile(first, 95),
            "p95_second_half_ms": 1e3 * Y.percentile(second, 95),
            "open_at_close": len(qs) - done,
            "tick_ms_median": 1e3 * float(np.median([t for _, t in
                                                     run.ticks])),
            "correct": run.correct}), flush=True)
        del run
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
