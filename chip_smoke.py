#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Phases, in order; the script exits non-zero at the first failure:

1. torch/CUDA versions and the card's name and power limit (nvidia-smi).
2. Build every CUDA kernel of the port from this checkout (one nvcc per
   source, all started together) and print the build seconds and the
   compiler's register / spill report.
3. Hold each kernel against its plain PyTorch version on the card: the
   tests/test_kernels.py sweep plus the serving shapes (bf16 prefill
   (1, 512, 16, 16, 128) causal; decode S=1 over a strided prefix of a
   (4, 1024, 16, 128) bf16 cache). Tolerance fp32 2e-4, bf16 2e-2.
4. Serve olmo-1b at full width through `repro_torch.launch.serve.main`
   (8 requests, 4 slots, 512-token prompts, 32 new tokens, random weights
   from seed 0). Launch counters are set to 0 just before and read just
   after; each layer's attention must have gone through the kernel once
   per prefill and once per decode call.
   Then a short torch.profiler window over one prefill and a few decode
   ticks: device busy share and the kernels that take most device time.
5. Full-width prefill last-token logits, kernel path vs plain path, same
   weights, bf16 compute.
6. Time each kernel, its plain version and one PyTorch library call
   computing the same function (a yardstick the port never calls) at the
   serving shapes, with CUDA events after warm-up, rotating input buffers
   so that L2 does not hold them; print each beside the kernel's bound
   from its bytes and operations and the data-sheet peaks of the card.
7. One `{"kernels": [...]}` JSON line, the nvidia-smi line again, and as
   the last line `{"ok": true, "device": {...}}`.

It needs one CUDA card and exits non-zero without one, and in a directory
that does not hold the repository's `src/`.
"""
from __future__ import annotations

import concurrent.futures
import json
import math
import os
import re
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

if not torch.cuda.is_available():
    sys.exit("chip_smoke: no CUDA device; this script runs on the card")

import torch.nn.functional as F  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.flash_attention import SOURCE as FA_SOURCE  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.kernels.ref import attention_ref  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.models.param import tree_map  # noqa: E402

DEV = torch.device("cuda")
TOL = {torch.float32: 2e-4, torch.bfloat16: 2e-2}
# full-width prefill logits, kernel path vs plain path, bf16 compute. The
# two paths round each attention output to bf16 identically except where
# their fp32 sums straddle a rounding boundary; such one-ulp flips enter
# the bf16 residual stream and propagate through 16 layers. 0.1 is about
# 13 bf16 ulps at |logit| in [1, 2).
LOGIT_TOL = 0.1

ARCH = "olmo-1b"
SERVE_ARGS = ["--arch", ARCH, "--full", "--requests", "8", "--num-slots",
              "4", "--prompt-len", "512", "--max-new", "32", "--capacity",
              "1024", "--seed", "0"]
PROMPT, MAX_NEW, SLOTS, CAP = 512, 32, 4, 1024
DECODE_T = PROMPT + MAX_NEW - 1      # longest cache prefix a decode reads

# data-sheet peaks (dense): bytes/s of device memory, FLOP/s of bf16
# tensor cores and of fp32 outside them; matched against nvidia-smi's name
PEAKS = [  # (name fragment, bytes/s, bf16 FLOP/s, fp32 FLOP/s)
    ("H200", 4.8e12, 989e12, 67e12),
    ("H100 NVL", 3.9e12, 835e12, 60e12),
    ("H100 PCIe", 2.0e12, 756e12, 51e12),
    ("H100", 3.35e12, 989e12, 67e12),          # SXM
]

# every kernel of the port: (name, source, TPU kernel it replaces)
KERNELS = [("flash_attention", FA_SOURCE,
            "src/repro/kernels/flash_attention.py:107")]


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def peaks(card: str):
    for frag, bw, bf16, fp32 in PEAKS:
        if frag in card:
            return {"bytes": bw, torch.bfloat16: bf16, torch.float32: fp32}
    raise RuntimeError(f"no data-sheet peaks for card {card!r}")


# ---------------------------------------------------------------------------
# phase 2: build
# ---------------------------------------------------------------------------
def build_all():
    t0 = time.perf_counter()
    sources = sorted({src for _, src, _ in KERNELS})
    with concurrent.futures.ThreadPoolExecutor(len(sources)) as ex:
        libs = list(ex.map(_build.build, sources))
    dt = time.perf_counter() - t0
    print(f"[build] {len(libs)} source(s) in {dt:.2f}s: "
          f"{[str(p.name) for p in libs]}")
    for src, lib in zip(sources, libs):
        log = lib.with_suffix(".log").read_text()
        regs = re.findall(r"Used (\d+) registers", log)
        spills = sum(int(n) for n in re.findall(r"(\d+) bytes spill", log))
        print(f"[build] {src}: registers per instantiation "
              f"{'/'.join(regs)}; spill bytes {spills}")
    return dt


# ---------------------------------------------------------------------------
# phase 3: kernel vs plain version
# ---------------------------------------------------------------------------
def _randn(shape, dtype, gen):
    return torch.randn(shape, generator=gen, device=DEV).to(dtype)


def _check(name, got, want, tol):
    torch.cuda.synchronize()
    g, w = got.float(), want.float()
    err = float((g - w).abs().max())
    ok = bool(torch.isfinite(g).all()) and bool(
        ((g - w).abs() <= tol + tol * w.abs()).all())
    print(f"[check] {name}: max_abs_err={err:.3e} tol={tol:g} "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: kernel disagrees with plain version")
    return err


def check_attention():
    gen = torch.Generator(device=DEV).manual_seed(0)
    sweep = [(1, 128, 128, 4, 4, 64), (2, 64, 64, 4, 2, 32),
             (1, 96, 96, 8, 1, 64), (1, 32, 128, 4, 2, 64)]
    for dtype in (torch.float32, torch.bfloat16):
        for B, S, T, H, K, hd in sweep:
            for causal, window in ((True, 0), (True, 32), (False, 0)):
                if not causal and S != T:
                    continue
                q = _randn((B, S, H, hd), dtype, gen)
                k = _randn((B, T, K, hd), dtype, gen)
                v = _randn((B, T, K, hd), dtype, gen)
                _check(f"sweep {str(dtype)[6:]} B{B} S{S} T{T} H{H} K{K} "
                       f"hd{hd} causal={causal} window={window}",
                       flash_attention(q, k, v, causal=causal,
                                       window=window),
                       attention_ref(q, k, v, causal=causal, window=window),
                       TOL[dtype])
    # head_dim 18 is not a multiple of 16 bytes: the scalar load path
    for dtype in (torch.float32, torch.bfloat16):
        q = _randn((2, 40, 4, 18), dtype, gen)
        k = _randn((2, 72, 2, 18), dtype, gen)
        v = _randn((2, 72, 2, 18), dtype, gen)
        _check(f"scalar loads {str(dtype)[6:]} B2 S40 T72 H4 K2 hd18 causal",
               flash_attention(q, k, v), attention_ref(q, k, v), TOL[dtype])
    serving = []
    bf16 = torch.bfloat16
    q, k, v = (_randn((1, PROMPT, 16, 128), bf16, gen) for _ in range(3))
    serving.append(_check(
        "serving prefill bf16 (1,512,16,16,128) causal",
        flash_attention(q, k, v), attention_ref(q, k, v), TOL[bf16]))
    ck, cv = (_randn((SLOTS, CAP, 16, 128), bf16, gen) for _ in range(2))
    for qdt in (bf16, torch.float32):
        q = _randn((SLOTS, 1, 16, 128), qdt, gen)
        kp, vp = ck[:, :DECODE_T], cv[:, :DECODE_T]   # strided views
        assert not kp.is_contiguous()
        err = _check(f"serving decode q {str(qdt)[6:]} over bf16 cache "
                     f"prefix (4,{DECODE_T}/{CAP},16,128)",
                     flash_attention(q, kp, vp), attention_ref(q, kp, vp),
                     TOL[qdt])
        if qdt == bf16:
            serving.append(err)
    return max(serving)


# ---------------------------------------------------------------------------
# phase 4: serve olmo-1b at full width
# ---------------------------------------------------------------------------
def serve_full_width():
    cfg = get_config(ARCH)
    flash_attention.launches = 0
    report = serve.main(SERVE_ARGS)
    torch.cuda.synchronize()
    launches = {"flash_attention": flash_attention.launches}
    out = report["outputs"]
    assert len(out) == 8, sorted(out)
    for rid, toks in out.items():
        assert len(toks) == MAX_NEW, (rid, len(toks))
        assert all(0 <= t < cfg.vocab_size for t in toks), rid
    prefills = len(report["prefill_s"])
    want = cfg.num_layers * (prefills + report["decode_calls"])
    print(f"[serve] flash_attention launches={launches['flash_attention']} "
          f"(prefills={prefills}, decode calls={report['decode_calls']}, "
          f"layers={cfg.num_layers}: expected {want})")
    assert launches["flash_attention"] == want, launches
    n_tok = sum(len(v) for v in out.values())
    tick_ms = sorted(1e3 * t for t in report["tick_s"])
    pre_ms = sorted(1e3 * t for t in report["prefill_s"])
    print(f"[serve] prefill ms (512 tokens): median={np.median(pre_ms):.3f} "
          f"min={pre_ms[0]:.3f} max={pre_ms[-1]:.3f} (first includes "
          f"warm-up)")
    print(f"[serve] decode ms per tick (4 slots): "
          f"median={np.median(tick_ms):.3f} min={tick_ms[0]:.3f} "
          f"max={tick_ms[-1]:.3f} over {len(tick_ms)} ticks")
    print(f"[serve] {n_tok} tokens in {report['seconds']:.3f}s: "
          f"{n_tok / report['seconds']:.1f} tokens/s end to end")
    return launches


def _device_busy_ms(prof):
    """Union of the device intervals of the kernels a profile saw (ms)."""
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, end = 0.0, -math.inf
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy / 1e3, len(spans)


def profile_serving():
    """Where a steady decode tick and a prefill spend their time: device
    busy share under torch.profiler (CUDA activity only) and the kernels
    that take most device time."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serve.kvcache import ServeLoop
    cfg = get_config(ARCH)
    model = build_model(cfg)
    loop = ServeLoop(model, model.init(seed=0, device=DEV),
                     num_slots=SLOTS, capacity=CAP, max_new=MAX_NEW)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab_size, size=PROMPT)
               for _ in range(SLOTS + 1)]
    for i in range(SLOTS - 1):
        loop.submit(f"p{i}", prompts[i])
    for _ in range(2):                                  # warm
        loop.tick()
    runs = {}
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        loop.submit("p_last", prompts[-1])
        runs["prefill (1 x 512 tokens)"] = (prof, time.perf_counter() - t0)
    ticks = 4
    with profile(activities=[ProfilerActivity.CUDA]) as prof2:
        t0 = time.perf_counter()
        for _ in range(ticks):
            loop.tick()
        runs[f"decode tick ({SLOTS} slots, 2 positions), mean of {ticks}"] = (
            prof2, (time.perf_counter() - t0) / ticks)
    for name, (pr, wall) in runs.items():
        n = ticks if name.startswith("decode") else 1
        busy, kernels = _device_busy_ms(pr)
        wall_ms = 1e3 * wall
        if kernels == 0:
            print(f"[profile] {name}: the profiler saw no device time; "
                  f"idle share not measured")
            continue
        print(f"[profile] {name}: wall {wall_ms:.3f} ms, device busy "
              f"{busy / n:.3f} ms, idle share {1 - busy / n / wall_ms:.3f} "
              f"({kernels // n} kernels per call)")
        top = sorted(pr.key_averages(), key=lambda e: -e.device_time_total)
        for e in top[:6]:
            print(f"[profile]   {e.device_time_total / 1e3 / n:8.3f} ms "
                  f"x{e.count // n:<4} {e.key[:90]}")


# ---------------------------------------------------------------------------
# phase 5: full-width logits, kernel path vs plain path
# ---------------------------------------------------------------------------
def compare_logits():
    model = build_model(get_config(ARCH))
    params = tree_map(lambda t: t.to(torch.bfloat16),
                      model.init(seed=0, device=DEV))
    rng = np.random.default_rng(1)
    x = torch.as_tensor(rng.integers(0, model.cfg.vocab_size,
                                     size=(1, PROMPT)), device=DEV)
    before = flash_attention.launches
    got, _, _ = model.prefill(params, x, CAP, compute_dtype=torch.bfloat16)
    assert flash_attention.launches == before + model.cfg.num_layers
    want, _, _ = model.prefill(params, x, CAP, compute_dtype=torch.bfloat16,
                               attn_impl="ref")
    torch.cuda.synchronize()
    V = model.cfg.vocab_size
    g, w = got[:, :V].float(), want[:, :V].float()
    assert bool(torch.isfinite(g).all()), "non-finite logits"
    err = float((g - w).abs().max())
    same = int(g.argmax()) == int(w.argmax())
    print(f"[logits] full-width prefill last-token logits, kernel vs plain: "
          f"max_abs_err={err:.4e} (|logit| max {float(w.abs().max()):.3f}) "
          f"tol={LOGIT_TOL} argmax_equal={same}")
    assert err <= LOGIT_TOL, err
    return err


# ---------------------------------------------------------------------------
# phase 6: timing
# ---------------------------------------------------------------------------
def _time_ms(fn, sets, iters=50, warmup=5):
    """Mean ms per call over `iters` calls cycling through input `sets`
    (enough of them that L2 does not hold the inputs of the next call)."""
    for i in range(warmup):
        fn(*sets[i % len(sets)])
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(*sets[i % len(sets)])
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _bound(nbytes, flops, dtype, pk):
    t_bytes = nbytes / pk["bytes"] * 1e3
    t_ops = flops / pk[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_attention(pk):
    bf16 = torch.bfloat16
    gen = torch.Generator(device=DEV).manual_seed(2)
    el = 2                                        # bytes per bf16 element
    rows = {}

    # prefill: q, k, v (1, 512, 16, 128), causal
    B, S, H, hd = 1, PROMPT, 16, 128
    sets = [tuple(_randn((B, S, H, hd), bf16, gen) for _ in range(3))
            for _ in range(8)]
    sdpa_sets = [tuple(t.transpose(1, 2).contiguous() for t in s)
                 for s in sets]
    pairs = S * (S + 1) // 2                      # visible (query, key)
    nbytes = 4 * B * S * H * hd * el              # q, k, v read; o written
    flops = 4 * B * H * pairs * hd                # QK^T and PV
    rows["prefill"] = dict(
        shape="q,k,v (1,512,16,128) bf16 causal",
        ms=_time_ms(lambda q, k, v: flash_attention(q, k, v), sets),
        plain_ms=_time_ms(lambda q, k, v: attention_ref(q, k, v), sets),
        library_ms=_time_ms(lambda q, k, v: F.scaled_dot_product_attention(
            q, k, v, is_causal=True), sdpa_sets),
        bound=_bound(nbytes, flops, bf16, pk))

    # decode: q (4, 1, 16, 128) over a (4, DECODE_T) prefix of the cache
    T = DECODE_T
    caches = [(_randn((SLOTS, 1, H, hd), bf16, gen),
               _randn((SLOTS, CAP, H, hd), bf16, gen),
               _randn((SLOTS, CAP, H, hd), bf16, gen)) for _ in range(6)]
    sets = [(q, k[:, :T], v[:, :T]) for q, k, v in caches]
    sdpa_sets = [tuple(t.transpose(1, 2).contiguous() for t in s)
                 for s in sets]
    nbytes = (2 * SLOTS * H * hd + 2 * SLOTS * T * H * hd) * el
    flops = 4 * SLOTS * H * T * hd
    rows["decode"] = dict(
        shape=f"q (4,1,16,128) over k,v prefix (4,{T}/{CAP},16,128) bf16",
        ms=_time_ms(lambda q, k, v: flash_attention(q, k, v), sets),
        plain_ms=_time_ms(lambda q, k, v: attention_ref(q, k, v), sets),
        library_ms=_time_ms(lambda q, k, v: F.scaled_dot_product_attention(
            q, k, v), sdpa_sets),
        bound=_bound(nbytes, flops, bf16, pk))

    for name, r in rows.items():
        bms, by = r["bound"]
        print(f"[time] flash_attention {name} {r['shape']}: kernel "
              f"{r['ms']:.4f} ms | plain {r['plain_ms']:.4f} ms | sdpa "
              f"{r['library_ms']:.4f} ms | bound {bms:.4f} ms ({by}) | "
              f"kernel at {100 * bms / r['ms']:.1f}% of bound")
    return rows


def _timing_keys(r):
    bms, by = r["bound"]
    return {"ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": bms,
            "bound_by": by, "library_ms": r["library_ms"]}


def main():
    print(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} devices {torch.cuda.device_count()}")
    smi = nvidia_smi()
    print(f"[env] nvidia-smi: {smi}")
    card = torch.cuda.get_device_name(0)
    pk = peaks(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    build_all()
    max_err = check_attention()
    launches = serve_full_width()
    profile_serving()
    compare_logits()
    rows = time_attention(pk)

    kernels = []
    for name, source, replaces in KERNELS:
        entry = {"name": name, "route": "cuda",
                 "source": f"src/repro_torch/csrc/{source}",
                 "replaces": replaces, "launches": launches[name],
                 "max_abs_err": max_err}
        entry.update(_timing_keys(rows["prefill"]))
        entry["shape"] = rows["prefill"]["shape"]
        entry["decode"] = dict(_timing_keys(rows["decode"]),
                               shape=rows["decode"]["shape"])
        kernels.append(entry)
    for e in kernels:
        assert all(math.isfinite(e[k]) for k in
                   ("ms", "plain_ms", "bound_ms", "library_ms")), e
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
