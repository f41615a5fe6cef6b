"""Quickstart: the ECCO loop on the port, window by window.

Builds a 4-stream fleet with correlated drift, runs the full ECCO control
loop (drift detection -> grouping -> Alg. 1 GPU allocation -> GAIMD
transmission -> group retraining) for a few windows, and prints the
grouping and accuracy trace, as the JAX package's `examples/quickstart.py`
does. Runs on the card unless given `--device cpu`.

    PYTHONPATH=src python -m repro_torch.examples.quickstart
    PYTHONPATH=src python -m repro_torch.examples.quickstart --device cpu
"""
from __future__ import annotations

import argparse
import dataclasses

from repro_torch import resolve_device
from repro_torch.configs import smoke_config
from repro_torch.core.controller import ControllerConfig, ECCOController
from repro_torch.core.trainer import SharedEngine
from repro_torch.data.streams import make_fleet


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' must be asked for")
    ap.add_argument("--windows", type=int, default=6)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    # 1. a lightweight student family (reduced olmo)
    cfg = dataclasses.replace(smoke_config("olmo-1b"), vocab_size=64)
    engine = SharedEngine(cfg, device=device)
    print(f"student: {cfg.name} ({engine.model.num_params():,} params) "
          f"on {device}")

    # 2. a fleet: 2 regions x 2 streams, drift hits each region at t=10
    _, streams = make_fleet(regions=2, streams_per_region=2,
                            switch_times=(10.0,), seed=0)
    print(f"fleet: {[s.stream_id for s in streams]}")

    # 3. the ECCO controller
    cc = ControllerConfig(window_micro=8, micro_steps=4, train_batch=16,
                          p_drop=0.5, shared_bandwidth=1e9)
    ctl = ECCOController(engine, streams, cc, seed=0)
    ctl.warmup()

    # 4. run retraining windows
    for w in range(args.windows):
        wm = ctl.run_window()
        accs = {k: round(v, 2) for k, v in wm.per_stream_acc.items()}
        print(f"[window {w}] groups={wm.groups} acc={accs}")

    print(f"\nfinal mean accuracy: {ctl.mean_accuracy(last_k=2):.3f}")
    print(f"grouping events: {ctl.grouper.events}")
    return ctl


if __name__ == "__main__":
    main()
