"""The readings that a cell's limits are set from, on the card at the
cell's own size: for each seed, a short run of the cell (the driver's own
set-up, window and check) whose check, on the first `--control` seeds,
also reads the control (the reference put in the program's place in the
next precision down) and planted faults. Not run by the benchmark's runs.

    python3 bench/control.py --workload <cell> --seeds 11,12,13 --seconds 8 \
        [--control 3]

prints one JSON line per seed: {"seed", "checks": {name: value}}.
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

import torch  # noqa: E402

from bench.core import device as D  # noqa: E402
from bench.core import spec  # noqa: E402
from bench.run import driver  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--control", type=int, default=None,
                    help="read the control on the first N seeds only "
                         "(default: every seed)")
    args = ap.parse_args(argv)
    cell = spec.cell(args.workload)
    D.require_cuda(cell.chips)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = D.card()
    drv = driver(cell.traffic["kind"])
    for k, seed in enumerate(int(s) for s in args.seeds.split(",")):
        control = args.control is None or k < args.control
        run = drv.run(cell, seed, args.seconds, False, control=control)
        print(json.dumps({"workload": cell.name, "seed": seed,
                          "card": card, "setup_s": run.setup_s,
                          "memory_peak_bytes": run.memory_peak_bytes,
                          "correct": run.correct, "notes": {
                              k: v for k, v in run.notes.items()
                              if k != "t0"},
                          "checks": {c.name: c.value for c in run.checks}}),
              flush=True)
        del run
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    return 0


if __name__ == "__main__":
    sys.exit(main())
