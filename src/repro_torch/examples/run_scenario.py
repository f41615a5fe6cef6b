"""Run any fleet scenario under any framework on the port and dump its
trace, as the JAX package's `examples/run_scenario.py` does.

    PYTHONPATH=src python -m repro_torch.examples.run_scenario \
        camera_churn ecco
    PYTHONPATH=src python -m repro_torch.examples.run_scenario \
        flash_crowd recl --windows 6 --out trace.json
    PYTHONPATH=src python -m repro_torch.examples.run_scenario \
        drift_wave ecco --tiny --device cpu

The scenario library (`repro_torch.data.scenarios`) covers drift waves,
diurnal recurrence, camera churn, flash crowds, bandwidth contention and
the hostile scenarios; the trace JSON is the format of the golden traces
(`repro_torch.testing.trace`). Runs on the card unless given `--device
cpu`; `--tiny` stops after two windows.
"""
from __future__ import annotations

import argparse

from repro_torch import resolve_device
from repro_torch.core.baselines import FRAMEWORKS
from repro_torch.data.scenarios import SCENARIOS, build_scenario
from repro_torch.testing import trace as T

TINY_WINDOWS = 2


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("scenario", choices=sorted(SCENARIOS))
    ap.add_argument("framework", nargs="?", default="ecco",
                    choices=sorted(FRAMEWORKS))
    ap.add_argument("--windows", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", help="write the trace JSON here")
    ap.add_argument("--tiny", action="store_true",
                    help=f"stop after {TINY_WINDOWS} windows (fast pass)")
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' must be asked for")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    sc = build_scenario(args.scenario, seed=args.seed)
    windows = args.windows
    if args.tiny:
        windows = min(windows or sc.windows, TINY_WINDOWS)
    caps = f", {len(sc.local_caps)} uplink caps" if sc.local_caps else ""
    churn = f", {len(sc.churn)} churn events" if sc.churn else ""
    print(f"scenario {sc.name}: {len(sc.streams)} streams, "
          f"{sc.windows} windows{caps}{churn}; on {device}")

    trace = {}
    ctl = T.run_scenario(args.framework, sc, windows=windows, trace=trace,
                         device=device, window_micro=4, micro_steps=2,
                         train_batch=8, p_drop=0.5)
    for w in trace["windows"]:
        accs = {k: v for k, v in w["acc"].items() if v is not None}
        mean = sum(accs.values()) / len(accs) if accs else float("nan")
        print(f"[t={w['t']:5.1f}] groups={w['groups']} "
              f"events={len(w['events'])} mean_acc={mean:.3f}")
    print(f"\nfinal mean accuracy ({args.framework}): "
          f"{ctl.mean_accuracy(last_k=2):.3f}")
    if args.out:
        T.save_trace(trace, args.out)
        print(f"trace written to {args.out}")
    return trace


if __name__ == "__main__":
    main()
