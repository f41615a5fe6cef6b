"""End to end on the port: train a student with group retraining for a
few hundred steps, with teacher distillation, checkpointing, and a
failure / recovery drill, as the JAX package's
`examples/train_group_retraining.py` does.

By default it builds a ~100M-class config (a scaled-down olmo: 8 layers,
d_model 512) and runs 200 optimizer steps of group retraining. `--tiny`
drops to the smoke config and at most 60 steps, a fast pass. Runs on the
card unless given `--device cpu`.

    PYTHONPATH=src python -m repro_torch.examples.train_group_retraining
    PYTHONPATH=src python -m repro_torch.examples.train_group_retraining \
        --tiny --device cpu
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
import time

import numpy as np

from repro_torch import resolve_device
from repro_torch.configs import smoke_config
from repro_torch.configs.base import DENSE, ModelConfig, TrainConfig
from repro_torch.core.grouping import Request
from repro_torch.core.trainer import RetrainJob, SharedEngine
from repro_torch.data.streams import DomainBank
from repro_torch.distributed.checkpoint import (AsyncCheckpointer,
                                                latest_step, restore_job)
from repro_torch.models.param import tree_map


def build_100m() -> ModelConfig:
    return ModelConfig(
        name="olmo-100m", family=DENSE, num_layers=8, d_model=512,
        num_heads=8, num_kv_heads=8, d_ff=2048, vocab_size=8192,
        norm="nonparam_ln", act="swiglu", rope_theta=10000.0)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--tiny", action="store_true",
                    help="smoke-scale model (fast pass)")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "ecco_e2e_ckpt"))
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' must be asked for")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    if args.tiny:
        cfg = dataclasses.replace(smoke_config("olmo-1b"), vocab_size=256)
        steps = min(args.steps, 60)
    else:
        cfg = build_100m()
        steps = args.steps
    vocab = min(cfg.vocab_size, 256)
    cfg = dataclasses.replace(cfg, vocab_size=vocab)

    tcfg = TrainConfig(learning_rate=1e-3, b2=0.999, weight_decay=0.0,
                       warmup_steps=10, total_steps=max(steps, 100),
                       remat="none")
    engine = SharedEngine(cfg, tcfg, device=device)
    print(f"model: {cfg.name}  params={engine.model.num_params():,}  "
          f"on {device}")

    # three correlated streams form one group retraining job
    bank = DomainBank(vocab, 4, dim=4, seed=0)
    rng = np.random.default_rng(0)
    dom = 0

    def req(sid):
        toks = bank.sample(dom, rng, 8, 32)
        return Request(stream_id=sid, t=0.0, loc=(0, 0),
                       subsamples=toks, acc=0.0, train_data=toks)

    micro_steps = 5
    job = RetrainJob(engine, req("cam0"), micro_steps=micro_steps,
                     batch=16, seed=0)
    job.add_member(req("cam1"))
    job.add_member(req("cam2"))

    ckpt = AsyncCheckpointer(args.ckpt_dir, keep=2)
    ev = bank.sample(dom, rng, 32, 32)
    t0 = time.perf_counter()
    done = micro = 0
    while done < steps:
        # fresh correlated inflow from all three members each "window"
        for _ in range(3):
            job.ingest(bank.sample(dom, rng, 4, 32))
        job.train_micro()
        micro += 1
        done += micro_steps
        if micro % 5 == 0:
            acc = job.eval_on(ev)
            dt = time.perf_counter() - t0
            print(f"step {done:4d}  acc={acc:.3f}  "
                  f"({dt:5.1f}s, {done * 16 * 32 / dt:,.0f} tok/s)")
            ckpt.save_async(done, job.state, extra={"acc": float(acc)})

    # failure drill: clobber the job state, restore from the checkpoint
    # (restore_job writes through the JobBank; the device row is flushed
    # by the next train / eval call)
    ckpt.wait()
    step = latest_step(args.ckpt_dir)
    print(f"\nsimulating failure; restoring from checkpoint step {step}")
    job.state = tree_map(np.zeros_like, job.state)
    extra = restore_job(args.ckpt_dir, step, job)
    acc = job.eval_on(ev)
    print(f"restored: acc={acc:.3f} (checkpointed acc={extra['acc']:.3f})")
    if abs(acc - extra["acc"]) >= 1e-3:
        raise RuntimeError("restore mismatch")
    print("recovery verified")
    return {"step": step, "acc": acc, "checkpointed_acc": extra["acc"]}


if __name__ == "__main__":
    main()
