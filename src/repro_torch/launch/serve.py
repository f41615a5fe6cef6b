"""Continuous-serving launcher: batched requests against one group model
using the slot-pool KV cache, on the GPU.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch olmo-1b \
        --full --requests 8 --num-slots 4 --prompt-len 512 --max-new 32 \
        --capacity 1024
    PYTHONPATH=src python -m repro_torch.launch.serve --arch hymba-1.5b \
        --full --requests 8 --num-slots 4 --prompt-len 1024 --max-new 32 \
        --capacity 1056
    PYTHONPATH=src python -m repro_torch.launch.serve --arch xlstm-350m \
        --full --requests 8 --num-slots 4 --prompt-len 1024 --max-new 32 \
        --capacity 1056

`--capacity` is a request's prompt + generation budget; the pool adds the
model's meta tokens (hymba: 128); xlstm-350m's recurrent cache does not
grow with it, but admission still checks it. Without `--full` it serves the
smoke-scale config (vocabulary capped at 256), as the JAX launcher does;
`--full` serves the published config. It
runs on CUDA unless `--device cpu` is given, and raises when CUDA is
missing. Weights are random, drawn from `--seed`. The JAX launcher's
`--fleet` path (two group models behind the swap gate) arrives with the
serving plane (ROADMAP.md, queue 1).
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np

from repro_torch import resolve_device


def _run_single(args, model, params, pending):
    from repro_torch.serve.kvcache import ServeLoop

    loop = ServeLoop(model, params, num_slots=args.num_slots,
                     capacity=args.capacity, max_new=args.max_new)
    prefill_s, tick_s = [], []
    t0 = time.perf_counter()
    ticks = 0
    done = {}
    # submit and tick both end in a device -> host copy of the emitted
    # tokens, so host clocks around them time finished device work
    while pending or loop.mgr.active():
        while pending and loop.mgr.free_slots():     # admit as many as fit
            rid, prompt = pending.pop(0)
            ts = time.perf_counter()
            loop.submit(rid, prompt)
            prefill_s.append(time.perf_counter() - ts)
            print(f"admitted {rid} (util={loop.mgr.utilization():.2f})")
        if loop.mgr.active():
            ts = time.perf_counter()
            loop.tick()
            tick_s.append(time.perf_counter() - ts)
        done.update(loop.drain())
        ticks += 1
        if ticks > 10000:
            raise RuntimeError("serve loop did not drain")
    done.update(loop.drain())
    return {"outputs": done, "ticks": len(tick_s),
            "seconds": time.perf_counter() - t0, "prefill_s": prefill_s,
            "tick_s": tick_s, "decode_calls": loop.decode_calls}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="olmo-1b",
                    help="olmo-1b, hymba-1.5b or xlstm-350m")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--num-slots", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=24)
    ap.add_argument("--capacity", type=int, default=128)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' must be asked for")
    ap.add_argument("--full", action="store_true",
                    help="serve the published config, full vocabulary")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    from repro_torch.configs import get_config, smoke_config
    from repro_torch.models.model import build_model

    if args.full:
        cfg = get_config(args.arch)
    else:
        cfg = smoke_config(args.arch)
        cfg = dataclasses.replace(cfg, vocab_size=min(cfg.vocab_size, 256))

    rng = np.random.default_rng(args.seed)
    pending = [(f"req{i}", rng.integers(0, cfg.vocab_size,
                                        size=args.prompt_len))
               for i in range(args.requests)]

    model = build_model(cfg)
    params = model.init(seed=args.seed, device=device)
    report = _run_single(args, model, params, pending)

    done, dt = report["outputs"], report["seconds"]
    total_tokens = sum(len(v) for v in done.values())
    print(f"served {len(done)} requests, {total_tokens} tokens "
          f"in {dt:.2f}s ({total_tokens / dt:.1f} tok/s) over "
          f"{report['ticks']} ticks on {device}")
    for rid in sorted(done):
        print(f"  {rid}: {done[rid][:8]}...")
    return report


if __name__ == "__main__":
    main()
