"""Continuous serving example: retrain, then serve.

A group model is retrained on a drifted stream, offered to the fleet
serving plane's validation gate against the model it replaces, and then
serves batched generation requests from the committed snapshot: the
"updated model back to the devices" half of the ECCO loop, plus
server-side shadow serving. The JAX package's
`examples/serve_continuous.py` serves through `ServeLoop`; this one goes
through `FleetServePlane`, the path `ControllerConfig.serve` drives. Runs
on the card unless given `--device cpu`.

    PYTHONPATH=src python -m repro_torch.examples.serve_continuous
    PYTHONPATH=src python -m repro_torch.examples.serve_continuous \
        --device cpu
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np

from repro_torch import resolve_device
from repro_torch.configs import smoke_config
from repro_torch.core.grouping import Request
from repro_torch.core.trainer import RetrainJob, SharedEngine
from repro_torch.data.streams import DomainBank
from repro_torch.serve.plane import FleetServePlane, ServeConfig


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' must be asked for")
    ap.add_argument("--rounds", type=int, default=8,
                    help="retraining micro-windows")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    vocab = 64
    cfg = dataclasses.replace(smoke_config("olmo-1b"), vocab_size=vocab)
    engine = SharedEngine(cfg, device=device)
    bank = DomainBank(vocab, 4, dim=4, seed=0)
    rng = np.random.default_rng(0)
    plane = FleetServePlane(engine, ServeConfig(num_slots=4, capacity=64,
                                                max_new=12))

    # 1. the group's current model serves until a retrained one passes
    dom = 1
    toks = bank.sample(dom, rng, 8, 32)
    job = RetrainJob(engine, Request("cam0", 0.0, (0, 0), toks, 0.0,
                                     train_data=toks),
                     micro_steps=4, batch=16, seed=0)
    held_out = bank.sample(dom, rng, 16, 32)
    d = plane.publish("group0", job.serving_snapshot(), held_out)
    print(f"seeded group0: acc={d.candidate_acc:.3f}")

    # 2. retrain the group model on the drifted domain
    print(f"retraining group model on drifted domain on {device}...")
    for _ in range(args.rounds):
        job.ingest(bank.sample(dom, rng, 8, 32))
        job.train_micro()

    # 3. the validated hot swap
    d = plane.publish("group0", job.serving_snapshot(), held_out)
    print(f"swap group0: cand={d.candidate_acc:.3f} "
          f"inc={d.incumbent_acc:.3f} -> "
          f"{'accepted' if d.accepted else 'rejected'}")

    # 4. serve batched requests from the committed snapshot
    prompts = {f"req{i}": bank.sample(dom, rng, 1, 16)[0]
               for i in range(8)}
    t0 = time.perf_counter()
    for rid, prompt in prompts.items():
        plane.enqueue(rid, "group0", prompt)
    ticks = plane.pump()
    dt = time.perf_counter() - t0
    outputs = plane.drain()
    total = sum(len(v) for v in outputs.values())
    print(f"served {len(outputs)} requests / {total} tokens in {dt:.2f}s "
          f"({total / dt:.0f} tok/s, {ticks} ticks, 4-slot pool)")

    # 5. sanity: generated continuations follow the drifted bigram
    hit = n = 0
    for rid, out in outputs.items():
        prev = int(prompts[rid][-1])
        for t in out:
            hit += bank.P[dom][prev].argmax() == t
            prev = int(t)
            n += 1
    print(f"generated tokens matching the domain's argmax transition: "
          f"{hit / n:.2f} (drifted-domain fidelity)")
    return {"outputs": outputs, "gate": d, "fidelity": hit / n}


if __name__ == "__main__":
    main()
