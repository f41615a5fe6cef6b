"""The benchmark of the PyTorch/CUDA port of ECCO (`src/repro_torch`).

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

runs one cell of BENCHMARK.json on the CUDA device(s) of this machine:
sets the program up from the seed, measures for `--seconds`, decides
`correct` against the plain reference in `bench/reference`, and prints one
JSON line last on standard output. With `--trace 0` its metrics are the
cell's end-to-end metrics; with `--trace 1` the per-layer ones, read from
a profiled stretch of the window and the benchmark's own spans. The
numbers compared for `correct` are printed last on standard error and
last in the result line, each beside its limit.

It exits with status 2 and prints no result when the cell's CUDA devices
are missing, and with status 3 when a module of JAX or of the JAX package
is loaded once the window has closed.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from bench.core import device as D  # noqa: E402
from bench.core import spec  # noqa: E402
from bench.core import trace as T  # noqa: E402
from bench.core import yardstick as Y  # noqa: E402

DRIVERS = {"serve": "bench.drivers.serve", "retrain": "bench.drivers.retrain"}


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def driver(kind: str):
    import importlib
    return importlib.import_module(DRIVERS[kind])


def result(cell, run, trace: bool, card: dict) -> dict:
    """The result line: correct, attempted, failed, metrics, device, the
    breakdown of a traced run, and last the numbers compared."""
    dev = {"platform": "gpu", "kind": card["kind"], "count": cell.chips,
           "memory_peak_bytes": run.memory_peak_bytes,
           "power_limit": card["power_limit"]}
    out = {"correct": run.correct, "attempted": run.attempted,
           "failed": run.failed,
           "metrics": spec.read_metrics(cell, run, trace=trace),
           "device": dev}
    if trace and run.stretch is not None:
        dev["busy_s"] = run.stretch.busy_s
        dev["window_s"] = run.stretch.wall_s
        out["breakdown"] = T.breakdown(run.stretch)
    out["checks"] = {c.name: {"value": c.value, "limit": c.limit}
                     for c in run.checks}
    return out


def main(argv=None) -> int:
    args = parse(argv)
    cell = spec.cell(args.workload)
    D.require_cuda(cell.chips)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = D.card()
    run = driver(cell.traffic["kind"]).run(
        cell, args.seed, args.seconds, bool(args.trace))
    run.peaks = Y.peaks(card["kind"])
    bad = D.forbidden_modules()
    if bad:
        print(f"bench: modules of JAX or the JAX package are loaded: {bad}",
              file=sys.stderr)
        return 3
    line = result(cell, run, bool(args.trace), card)
    for k, v in run.notes.items():
        if k != "t0":
            print(f"bench: {k} {v}", file=sys.stderr)
    print(f"bench: {card['kind']}, power limit {card['power_limit']}, "
          f"set-up {run.setup_s:.3f} s", file=sys.stderr)
    for c in run.checks:
        print(f"bench: check {c.name} {c.value!r} limit {c.limit!r} "
              f"{'ok' if c.ok else 'FAILED'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except D.NoDevice as e:
        print(str(e), file=sys.stderr)
        sys.exit(2)
