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
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch qwen2-moe-a2.7b --full --requests 8 --num-slots 4 \
        --prompt-len 512 --max-new 32 --capacity 1024

`--arch` takes every decoder of the registry (`repro_torch.configs`);
hubert-xlarge, encoder-only, has no decode step and is refused.

`--fleet` serves the same requests through the fleet serving plane
instead (`repro_torch.serve.plane`): two group models from seeds 0 and 1
published through the swap gate, a candidate from seed 2 offered to the
first group, the requests alternating between the groups and decoded in
shared ticks (one fleet-step call per tick for any group mix), and a
window report with qps, tick percentiles and the gate's counters: the
path `ControllerConfig.serve` drives inside `ECCOController.run_window`.

    PYTHONPATH=src python -m repro_torch.launch.serve --fleet --full \
        --requests 8 --num-slots 8 --prompt-len 512 --max-new 32 \
        --capacity 1024

`--capacity` is a request's prompt + generation budget; the pool adds the
model's meta tokens (hymba: 128); xlstm-350m's recurrent cache does not
grow with it, but admission still checks it. Without `--full` it serves the
smoke-scale config (vocabulary capped at 256), as the JAX launcher does;
`--full` serves the published config. It
runs on CUDA unless `--device cpu` is given, and raises when CUDA is
missing. Weights are random, drawn from `--seed` straight into the
serving dtype, bf16 (`models.param.init_params`: each stacked leaf a
layer at a time in fp32, scaled and rounded), so no fp32 tree is ever
held: qwen3-moe-30b-a3b's and chameleon-34b's fp32 parameters (122.1 and
137.2 GB) would not fit one card, their bf16 ones (61.1 and 68.6 GB) do.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

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


def _run_fleet(args, cfg, engine, pending):
    """Two-group fleet serving with the validated hot swap."""
    from repro_torch.serve.plane import FleetServePlane, ServeConfig

    plane = FleetServePlane(engine, ServeConfig(
        num_slots=args.num_slots, capacity=args.capacity,
        max_new=args.max_new, prompt_len=args.prompt_len))
    rng = np.random.default_rng(args.seed)
    sample = rng.integers(0, cfg.vocab_size, size=(4, 16))
    for g, seed in (("groupA", 0), ("groupB", 1)):
        d = plane.publish(g, engine.model.init(seed=seed,
                                               device=engine.device), sample)
        print(f"seeded {g}: acc={d.candidate_acc:.3f}")
    # a second publish rides the gate: accepted only if the candidate
    # holds up on the held-out sample (ties accept at margin 0.0)
    d = plane.publish("groupA", engine.model.init(seed=2,
                                                  device=engine.device),
                      sample)
    print(f"swap groupA: cand={d.candidate_acc:.3f} "
          f"inc={d.incumbent_acc:.3f} -> "
          f"{'accepted' if d.accepted else 'rejected'}")

    t0 = time.perf_counter()
    for i, (rid, prompt) in enumerate(pending):
        plane.enqueue(rid, ("groupA", "groupB")[i % 2], prompt)
    ticks = plane.pump()
    done = plane.drain()
    rep = plane.window_report()
    print(f"gate: seeded={rep['swap_seeded']} "
          f"accepted={rep['swap_accepted']} "
          f"rejected={rep['swap_rejected']}")
    print(f"qps={rep['qps']:.1f} p50_tick={rep['p50_tick_ms']:.1f}ms "
          f"p99_tick={rep['p99_tick_ms']:.1f}ms")
    return {"outputs": done, "ticks": ticks,
            "seconds": time.perf_counter() - t0, "report": rep,
            "tick_log": list(plane.tick_log),
            "prefill_calls": plane.prefill_calls}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="olmo-1b",
                    help="a decoder of the registry: olmo-1b, stablelm-3b, "
                         "llama3-8b, starcoder2-3b, xlstm-350m, "
                         "qwen3-moe-30b-a3b, qwen2-moe-a2.7b, hymba-1.5b "
                         "or chameleon-34b")
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
    ap.add_argument("--fleet", action="store_true",
                    help="serve through the fleet plane (two group "
                         "models, swap gate, shared ticks)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    from repro_torch.configs import get_config, smoke_config
    from repro_torch.models.model import build_model

    if args.full:
        cfg = get_config(args.arch)
    else:
        cfg = smoke_config(args.arch)
    if not cfg.has_decode:
        raise SystemExit(f"{args.arch} is encoder-only: no decode step "
                         "(see DESIGN.md §Arch-applicability)")
    if not args.full:
        cfg = dataclasses.replace(cfg, vocab_size=min(cfg.vocab_size, 256))

    rng = np.random.default_rng(args.seed)
    pending = [(f"req{i}", rng.integers(0, cfg.vocab_size,
                                        size=args.prompt_len))
               for i in range(args.requests)]

    if args.fleet:
        from repro_torch.core.trainer import SharedEngine
        report = _run_fleet(args, cfg, SharedEngine(cfg, device=device),
                            pending)
    else:
        model = build_model(cfg)
        t0 = time.perf_counter()
        params = model.init(seed=args.seed, dtype=torch.bfloat16,
                            device=device)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        init_s = time.perf_counter() - t0
        print(f"initialised {model.num_params():,} parameters in bf16 in "
              f"{init_s:.2f}s")
        report = dict(_run_single(args, model, params, pending),
                      init_s=init_s)

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
