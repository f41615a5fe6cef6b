"""ECCO continuous-learning launcher, ported from the JAX package's
`launch/train.py`.

Runs the full control loop (drift detection -> dynamic grouping -> GPU
allocation (Alg. 1) -> GAIMD transmission control -> group retraining)
over a synthetic fleet, with checkpointing and an optional simulated
failure and recovery:

    PYTHONPATH=src python -m repro_torch.launch.train --arch olmo-1b \
        --framework ecco --windows 12 --streams-per-region 3 --regions 2

`--scale smoke` (the default) runs the reduced same-family config,
`--scale full` the published one. `--framework` selects ECCO or a paper
baseline, so end-to-end comparisons (paper Fig. 6/7) run from one entry
point. It runs on CUDA unless `--device cpu` is given, and raises when
CUDA is missing. Weights are random, drawn from `--seed`.

`--ckpt-dir` saves the first job's state every `--ckpt-every` windows
(`distributed.checkpoint.AsyncCheckpointer`); `--fail-at-window W`, with
a checkpoint directory, restores that job from the latest checkpoint
before window W, writing through the JobBank, as the reference does.
"""
from __future__ import annotations

import argparse
import json
import time

from repro_torch import resolve_device


def build_controller(args, engine, streams):
    from repro_torch.core.baselines import FRAMEWORKS
    from repro_torch.core.controller import ControllerConfig
    cc = ControllerConfig(
        window_micro=args.window_micro,
        seq_len=args.seq_len,
        sample_rate=args.sample_rate,
        shared_bandwidth=args.shared_bandwidth,
        drift_threshold=args.drift_threshold,
        micro_steps=args.micro_steps,
        train_batch=args.train_batch,
    )
    return FRAMEWORKS[args.framework](engine, streams, cc, seed=args.seed)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="olmo-1b")
    ap.add_argument("--scale", choices=["smoke", "full"], default="smoke",
                    help="smoke: reduced same-family config; full: "
                         "published dims")
    ap.add_argument("--framework", default="ecco",
                    choices=["ecco", "naive", "ekya", "recl"])
    ap.add_argument("--windows", type=int, default=10)
    ap.add_argument("--regions", type=int, default=2)
    ap.add_argument("--streams-per-region", type=int, default=3)
    ap.add_argument("--vocab", type=int, default=None,
                    help="synthetic stream vocab (defaults to model's)")
    ap.add_argument("--seq-len", type=int, default=32)
    ap.add_argument("--sample-rate", type=int, default=8)
    ap.add_argument("--window-micro", type=int, default=8)
    ap.add_argument("--micro-steps", type=int, default=4)
    ap.add_argument("--train-batch", type=int, default=8)
    ap.add_argument("--shared-bandwidth", type=float, default=64.0)
    ap.add_argument("--drift-threshold", type=float, default=0.25)
    ap.add_argument("--switch-time", type=float, default=10.0)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=4,
                    help="checkpoint job states every N windows")
    ap.add_argument("--fail-at-window", type=int, default=None,
                    help="simulate a failure: drop job state and restore "
                         "from the last checkpoint")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--json-out", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.ckpt_every < 1:
        raise ValueError(f"--ckpt-every must be at least 1; got "
                         f"{args.ckpt_every}")
    device = resolve_device(args.device)

    import dataclasses

    from repro_torch.configs import get_config, smoke_config
    from repro_torch.core import trainer
    from repro_torch.data.streams import make_fleet

    cfg = (smoke_config(args.arch) if args.scale == "smoke"
           else get_config(args.arch))
    vocab = args.vocab or min(cfg.vocab_size, 64)
    if vocab != cfg.vocab_size:
        cfg = dataclasses.replace(cfg, vocab_size=vocab)
    engine = trainer.SharedEngine(cfg, device=device)
    print(f"arch={cfg.name} family={cfg.family} "
          f"params={engine.model.num_params():,} device={device}")

    _, streams = make_fleet(
        vocab=vocab, regions=args.regions,
        streams_per_region=args.streams_per_region,
        switch_times=(args.switch_time,), seed=args.seed)
    ctl = build_controller(args, engine, streams)

    ckpt = None
    if args.ckpt_dir:
        from repro_torch.distributed.checkpoint import AsyncCheckpointer
        ckpt = AsyncCheckpointer(args.ckpt_dir)

    ctl.warmup()
    t0 = time.time()
    for w in range(args.windows):
        if args.fail_at_window is not None and w == args.fail_at_window \
                and ckpt is not None and ctl.jobs:
            # simulate losing the job's device state mid-run; the restore
            # writes through the JobBank and the next fleet call flushes
            # it to the device
            from repro_torch.distributed.checkpoint import (latest_step,
                                                            restore_job)
            ckpt.wait()
            step = latest_step(args.ckpt_dir)
            if step is not None:
                j = ctl.jobs[0]
                extra = restore_job(args.ckpt_dir, step, j)
                print(f"[w{w}] recovered job {j.job_id} from "
                      f"checkpoint step {step} (window {extra.get('window')})")
        wm = ctl.run_window()
        accs = {k: round(v, 3) for k, v in wm.per_stream_acc.items()}
        print(f"[w{w}] t={wm.t:6.1f} groups={wm.groups} acc={accs}")
        if ckpt is not None and ctl.jobs and (w + 1) % args.ckpt_every == 0:
            ckpt.save_async(w, ctl.jobs[0].state, extra={"window": w})
    if ckpt is not None:
        ckpt.wait()

    elapsed = time.time() - t0
    final = ctl.mean_accuracy(last_k=2)
    print(f"done: {args.windows} windows in {elapsed:.1f}s  "
          f"final mean accuracy={final:.3f}")
    if args.json_out:
        hist = [{"t": wm.t, "acc": wm.per_stream_acc,
                 "groups": wm.groups} for wm in ctl.history]
        with open(args.json_out, "w") as f:
            json.dump({"framework": args.framework, "arch": cfg.name,
                       "final_acc": final, "history": hist}, f, indent=1)
    return final


if __name__ == "__main__":
    main()
