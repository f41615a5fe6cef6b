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
import dataclasses
import json
import math
import os
import re
import subprocess
import sys
import time
import zlib

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

if not torch.cuda.is_available():
    sys.exit("chip_smoke: no CUDA device; this script runs on the card")

import torch.nn.functional as F  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.drift import (FleetDriftDetector,  # noqa: E402
                                    batch_token_histogram,
                                    js_divergence_rows, token_histogram)
from repro_torch.core.grouping import Grouper, Request  # noqa: E402
from repro_torch.core.signature_index import SignatureIndex  # noqa: E402
from repro_torch.data.scenarios import build_scenario  # noqa: E402
from repro_torch.data.streams import DomainBank, Region  # noqa: E402
from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.kernels.flash_attention import SOURCE as FA_SOURCE  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.kernels.fleet_drift import SOURCE as FD_SOURCE  # noqa: E402
from repro_torch.kernels.fleet_drift import fleet_drift  # noqa: E402
from repro_torch.kernels.pairwise_js import SOURCE as PJ_SOURCE  # noqa: E402
from repro_torch.kernels.pairwise_js import pairwise_js  # noqa: E402
from repro_torch.kernels.ref import (attention_ref,  # noqa: E402
                                     fleet_drift_ref, pairwise_js_ref)
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
            "src/repro/kernels/flash_attention.py:107"),
           ("fleet_drift", FD_SOURCE, "src/repro/kernels/fleet_drift.py:86"),
           ("pairwise_js", PJ_SOURCE, "src/repro/kernels/pairwise_js.py:54")]
# kernels that no single PyTorch call computes: their library time is null
NO_LIBRARY_CALL = ("fleet_drift", "pairwise_js")

# drift plane: 100,000 streams, each window 8 sequences x 32 tokens (the
# controller's defaults), 64 buckets over the fleets' 64-token vocabulary,
# 64 regions of which half switch domain between windows 1 and 2
DRIFT_N, DRIFT_T, BUCKETS, DRIFT_VOCAB = 100_000, 8 * 32, 64, 64
DRIFT_REGIONS, DRIFT_WINDOWS, SWITCH_T = 64, 3, 15.0
THRESHOLD, BAND = 0.25, 1e-4          # FleetDriftDetector's defaults
OLMO_VOCAB = 50_304
# fp32 kernel tolerances of tests/test_fleet_drift.py and test_kernels.py
DRIFT_SCORE_TOL, DRIFT_HIST_TOL, PJS_TOL = 1e-5, 1e-6, 1e-5
# grouping plane: flash_crowd_10k's join storm through the shortlist
JOINERS, SHORTLIST_K = 10_000, 2


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


def _check(name, got, want, tol, rtol=None):
    """|got - want| <= tol + rtol |want| elementwise (rtol defaults to
    tol), and got finite; returns the largest absolute error."""
    torch.cuda.synchronize()
    rtol = tol if rtol is None else rtol
    g, w = got.float(), want.float()
    err = float((g - w).abs().max()) if g.numel() else 0.0
    ok = bool(torch.isfinite(g).all()) and bool(
        ((g - w).abs() <= tol + rtol * w.abs()).all())
    print(f"[check] {name}: max_abs_err={err:.3e} atol={tol:g} "
          f"rtol={rtol:g} {'ok' if ok else 'FAIL'}")
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


def _check_drift(name, toks, ref, buckets, vocab):
    """fleet_drift kernel vs plain version on the card (int32 tokens,
    fp32 reference), and the kernel's scores vs the float64 host scores
    of core.drift (must be within band / 10); returns the largest
    kernel-vs-plain error."""
    t = torch.as_tensor(np.ascontiguousarray(toks, np.int32), device=DEV)
    r = torch.as_tensor(np.ascontiguousarray(ref, np.float32), device=DEV)
    s, h = fleet_drift(t, r, buckets=buckets, vocab=vocab)
    ws, wh = fleet_drift_ref(t, r, buckets=buckets, vocab=vocab)
    err = max(_check(f"{name} scores", s, ws, DRIFT_SCORE_TOL, 0.0),
              _check(f"{name} hists", h, wh, DRIFT_HIST_TOL, 0.0))
    exact = js_divergence_rows(batch_token_histogram(toks, buckets, vocab),
                               np.asarray(ref, np.float64))
    err64 = float(np.abs(s.cpu().numpy().astype(np.float64) - exact).max()) \
        if len(exact) else 0.0
    print(f"[check] {name} scores vs float64 host: max_abs_err="
          f"{err64:.3e} (must be < band/10 = {BAND / 10:g})")
    if not err64 < BAND / 10:
        raise AssertionError(f"{name}: fp32 scores too far from float64")
    return err


def check_fleet_drift():
    """The CPU test sweep (tests/test_fleet_drift.py: tokens up to and
    including vocab, a zero-sum reference row), its edges, then the drift
    plane's full shape and uniform tokens over olmo-1b's vocabulary and
    with modulo hashing. Tolerance: scores 1e-5, hists 1e-6 absolute."""
    rng = np.random.default_rng(0)
    errs = []

    def run(name, toks, ref, buckets, vocab):
        errs.append(_check_drift(name, toks, ref, buckets, vocab))

    for N, T, B, vocab in [(1, 32, 64, 64), (5, 64, 64, 64),
                           (33, 48, 64, 64), (100, 16, 128, 256),
                           (17, 64, 64, 0), (9, 37, 64, 64)]:
        toks = rng.integers(0, (vocab or B) + 1, size=(N, T))
        ref = rng.random((N, B)).astype(np.float32)
        ref[0] = 0.0
        run(f"fleet_drift sweep N{N} T{T} B{B} vocab{vocab}", toks, ref, B,
            vocab)
    toks = rng.integers(-200, 200, size=(23, 40))
    run("fleet_drift negative tokens, vocab 0 (floor modulo)", toks,
        rng.random((23, 64)), 64, 0)
    run("fleet_drift T=0", np.zeros((4, 0), np.int64), rng.random((4, 64)),
        64, 64)
    s, h = fleet_drift(torch.zeros((0, 8), dtype=torch.int32, device=DEV),
                       torch.zeros((0, 64), device=DEV), buckets=64, vocab=64)
    assert s.shape == (0,) and h.shape == (0, 64)
    full = (DRIFT_N, DRIFT_T)
    ref = rng.random((DRIFT_N, BUCKETS))
    run(f"fleet_drift full shape {full} B{BUCKETS} vocab{DRIFT_VOCAB}",
        rng.integers(0, DRIFT_VOCAB + 1, size=full), ref, BUCKETS,
        DRIFT_VOCAB)
    run(f"fleet_drift full shape {full} uniform tokens, vocab {OLMO_VOCAB}",
        rng.integers(0, OLMO_VOCAB, size=full), ref, BUCKETS, OLMO_VOCAB)
    run(f"fleet_drift full shape {full} uniform tokens, vocab 0",
        rng.integers(0, OLMO_VOCAB, size=full), ref, BUCKETS, 0)
    return max(errs)


def index_capacity(rows: int) -> int:
    """Capacity a SignatureIndex (default 64, doubling) reaches at `rows`
    live rows."""
    cap = 64
    while cap < rows:
        cap *= 2
    return cap


def check_pairwise_js(cap):
    """The CPU test sweep (tests/test_kernels.py, an all-zero row), empty
    inputs, then one request and 32 requests against a capacity block
    whose inactive rows are all zero, as the index passes it. Tolerance
    1e-5 absolute."""
    rng = np.random.default_rng(1)
    errs = []
    for N, M, B in [(3, 5, 64), (1, 7, 64), (9, 1, 128), (17, 13, 128),
                    (100, 73, 64)]:
        p = torch.as_tensor(rng.random((N, B), np.float32), device=DEV)
        p[0] = 0.0
        q = torch.as_tensor(rng.random((M, B), np.float32), device=DEV)
        errs.append(_check(f"pairwise_js sweep N{N} M{M} B{B}",
                           pairwise_js(p, q), pairwise_js_ref(p, q),
                           PJS_TOL, 0.0))
    e = torch.zeros((0, 64), device=DEV)
    o = torch.ones((3, 64), device=DEV)
    assert pairwise_js(o, e).shape == (3, 0)
    assert pairwise_js(e, o).shape == (0, 3)
    assert pairwise_js(e, e).shape == (0, 0)
    q = rng.random((cap, BUCKETS), np.float32)
    q[rng.random(cap) < 0.4] = 0.0
    q = torch.as_tensor(q, device=DEV)
    full = []
    for N in (1, 32):
        p = torch.as_tensor(rng.random((N, BUCKETS), np.float32), device=DEV)
        full.append(_check(f"pairwise_js ({N}, {cap}) B{BUCKETS}",
                           pairwise_js(p, q), pairwise_js_ref(p, q),
                           PJS_TOL, 0.0))
    return max(errs + full)


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
# phase 6: the drift plane at fleet scale
# ---------------------------------------------------------------------------
def drift_fleet(seed=0):
    """DRIFT_N streams in make_fleet's layout (vocab 64, 6 domains of dim
    4) over DRIFT_REGIONS regions, half of which switch domain at SWITCH_T.
    Each region's window is one vectorised DomainBank.sample call (a
    per-stream loop would take longer than the kernel work). Returns
    (ids, [reference window, window 1, ...]) with (N, DRIFT_T) int64
    token arrays."""
    bank = DomainBank(DRIFT_VOCAB, 6, dim=4, seed=seed)
    rng = np.random.default_rng(seed + 1)
    sizes = [DRIFT_N // DRIFT_REGIONS + (r < DRIFT_N % DRIFT_REGIONS)
             for r in range(DRIFT_REGIONS)]
    regions = []
    for r in range(DRIFT_REGIONS):
        doms = rng.permutation(6)
        sched = [(0.0, int(doms[0]))]
        if r % 2:
            sched.append((SWITCH_T, int(doms[1])))
        regions.append(Region(f"region{r}", sched))
    ids = [f"cam{r}_{s}" for r, n in enumerate(sizes) for s in range(n)]
    seqs = DRIFT_T // 32
    wins = []
    for w in range(DRIFT_WINDOWS + 1):
        wins.append(np.concatenate([
            bank.sample(reg.domain_at(10.0 * w), rng, n * seqs, 32).reshape(
                n, DRIFT_T) for reg, n in zip(regions, sizes)]))
    return ids, wins


def _median_ms(xs):
    return 1e3 * float(np.median(xs))


def drift_plane():
    """FleetDriftDetector at DRIFT_N streams: impl="auto" on the card
    against impl="exact" on the host over DRIFT_WINDOWS windows. Equal
    triggers, bit-identical live histograms, bit-identical scores where
    the kernel screen put a stream within `band` of the threshold (the
    float64 rescore), within 1e-5 elsewhere. One kernel launch per window
    that scored a stream. Then the split of one observe."""
    t0 = time.perf_counter()
    ids, wins = drift_fleet()
    print(f"[drift] fleet of {len(ids)} streams x {DRIFT_T} tokens, "
          f"{DRIFT_WINDOWS} windows + reference, drawn in "
          f"{time.perf_counter() - t0:.2f}s")
    kern = FleetDriftDetector(THRESHOLD, BUCKETS, DRIFT_VOCAB, impl="auto",
                              band=BAND, device="cuda")
    exact = FleetDriftDetector(THRESHOLD, BUCKETS, DRIFT_VOCAB,
                               impl="exact", band=BAND)
    for det in (kern, exact):
        det.set_references(ids, wins[0])
    fleet_drift.launches = 0
    results = []
    for toks in wins[1:]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trig_k = kern.observe(ids, toks)
        t_k = time.perf_counter() - t0
        t0 = time.perf_counter()
        trig_e = exact.observe(ids, toks)
        t_e = time.perf_counter() - t0
        results.append((trig_k, trig_e, kern.state_dict(),
                        exact.state_dict(), t_k, t_e))
    launches = fleet_drift.launches
    torch.cuda.synchronize()
    for w, (trig_k, trig_e, sk, se, t_k, t_e) in enumerate(results, 1):
        near = sk["scores"] > THRESHOLD - BAND        # rescored in float64
        far_err = float(np.abs(sk["scores"] - se["scores"])[~near].max())
        same_hist = bool((sk["live"] == se["live"]).all())
        same_near = bool((sk["scores"][near] == se["scores"][near]).all())
        in_band = int(((sk["scores"] > THRESHOLD - BAND)
                       & (sk["scores"] <= THRESHOLD + BAND)).sum())
        print(f"[drift] window {w}: triggered {len(trig_k)} (exact "
              f"{len(trig_e)}), rescored {int(near.sum())} ({in_band} "
              f"within band of the threshold), hists bit-identical "
              f"{same_hist}, rescored scores bit-identical {same_near}, "
              f"largest error elsewhere {far_err:.3e}; observe "
              f"{1e3 * t_k:.3f} ms (exact path {1e3 * t_e:.3f} ms)")
        if not (trig_k == trig_e and same_hist and same_near
                and far_err <= DRIFT_SCORE_TOL):
            raise AssertionError(f"drift window {w}: kernel path differs "
                                 f"from the exact path")
    assert sum(len(r[0]) for r in results) > 0, "no stream drifted"
    print(f"[drift] fleet_drift launches={launches} (expected "
          f"{DRIFT_WINDOWS}: one per window that scored a stream)")
    assert launches == DRIFT_WINDOWS, launches
    split = observe_split(exact.state_dict()["ref"], wins[1:])
    split["total"] = _median_ms([r[4] for r in results])
    split["exact_total"] = _median_ms([r[5] for r in results])
    print("[drift] one observe at {} streams, median of {} windows (ms): "
          "host histogram {hist:.3f} | copy to the card {copy:.3f} (int32 "
          "cast {cast:.3f}, transfer {h2d:.3f}) | kernel {kernel:.4f} | "
          "scores back {d2h:.3f} | rescore {rescore:.3f} | observe total "
          "{total:.3f} (exact path {exact_total:.3f})".format(
              DRIFT_N, DRIFT_WINDOWS, **split))
    windows = [torch.as_tensor(w.astype(np.int32), device=DEV)
               for w in wins[1:]]
    refs = torch.as_tensor(exact.state_dict()["ref"].astype(np.float32),
                           device=DEV)
    return launches, split, windows, refs


def observe_split(refs64, windows):
    """Median ms of each step that a kernel-mode observe takes, timed one
    by one on the same windows: host histogram, int32 cast and transfer
    to the card, the kernel (CUDA events), scores back, float64 rescore
    of the streams the screen puts within band."""
    steps = {k: [] for k in ("hist", "cast", "h2d", "kernel", "d2h",
                             "rescore")}
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    for toks in windows:
        t0 = time.perf_counter()
        hists = batch_token_histogram(toks, BUCKETS, DRIFT_VOCAB)
        t1 = time.perf_counter()
        t32 = np.ascontiguousarray(toks, np.int32)
        r32 = np.ascontiguousarray(refs64, np.float32)
        t2 = time.perf_counter()
        td = torch.from_numpy(t32).to(DEV)
        rd = torch.from_numpy(r32).to(DEV)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        start.record()
        fs, _ = fleet_drift(td, rd, buckets=BUCKETS, vocab=DRIFT_VOCAB)
        end.record()
        torch.cuda.synchronize()
        t4 = time.perf_counter()
        fs = fs.cpu().numpy().astype(np.float64)
        t5 = time.perf_counter()
        near = np.nonzero(fs > THRESHOLD - BAND)[0]
        fs[near] = js_divergence_rows(hists[near], refs64[near])
        t6 = time.perf_counter()
        for k, v in (("hist", t1 - t0), ("cast", t2 - t1), ("h2d", t3 - t2),
                     ("kernel", start.elapsed_time(end) / 1e3),
                     ("d2h", t5 - t4), ("rescore", t6 - t5)):
            steps[k].append(v)
    out = {k: _median_ms(v) for k, v in steps.items()}
    out["copy"] = out["cast"] + out["h2d"]
    return out


# ---------------------------------------------------------------------------
# phase 7: the grouping plane under flash_crowd_10k's join storm
# ---------------------------------------------------------------------------
def _unit(key: str) -> float:
    """A deterministic number in [0, 1) from a string (no salted hash)."""
    return zlib.crc32(key.encode()) / 2 ** 32


class DetJob:
    """A duck-typed retraining job whose accuracy on a request's samples
    is a fixed function of (job, samples): both runs of the storm see the
    same accuracies (the port's trainer is not there yet)."""

    def __init__(self, req, counter):
        self.job_id = f"dj{counter[0]}"
        counter[0] += 1
        self.members = [req]

    def eval_on(self, samples):
        return _unit(f"{self.job_id}/{samples}")

    def add_member(self, req):
        self.members.append(req)

    def remove_member(self, sid):
        self.members = [m for m in self.members if m.stream_id != sid]


def storm_requests(joiners=None):
    """flash_crowd_10k's cohort as grouping requests: each joiner asks at
    its join window with its location, its first window's exact
    histogram as signature, and a fixed accuracy in [0, 0.5)."""
    sc = build_scenario("flash_crowd_10k", joiners=joiners or JOINERS)
    window = sc.churn[0].window
    now = window * sc.window_seconds
    reqs = []
    for ev in sc.events_at(window):
        st = ev.stream
        sig = token_histogram(st.sample(now, DRIFT_T // 32, 32), BUCKETS,
                              sc.bank.vocab)
        reqs.append(Request(stream_id=st.stream_id, t=now, loc=st.loc,
                            subsamples=st.stream_id,
                            acc=0.5 * _unit(f"acc/{st.stream_id}"), sig=sig))
    return reqs


def _storm_grouper(impl):
    counter = [0]
    return Grouper(new_job_fn=lambda r: DetJob(r, counter),
                   index=SignatureIndex(BUCKETS, impl=impl, device="cuda"),
                   shortlist_k=SHORTLIST_K)


def grouping_storm():
    """Every joiner through Grouper.group_request with the index on the
    card at shortlist_k=2, once through the kernel and once through the
    plain version, request by request in lockstep: event lists and
    partitions must be equal. One pairwise_js launch per request that
    reached the shortlist (the index held at least one job)."""
    t0 = time.perf_counter()
    reqs = storm_requests()
    print(f"[group] {len(reqs)} join requests of flash_crowd_10k drawn in "
          f"{time.perf_counter() - t0:.2f}s")
    gk, gr = _storm_grouper("auto"), _storm_grouper("ref")
    jobs_k, jobs_r = [], []
    reached, t_k, t_r, gaps = 0, [], [], []
    pairwise_js.launches = 0
    t_all = time.perf_counter()
    for req in reqs:
        reached += bool(jobs_k)
        gap = _shortlist_gap(gk, req)
        if gap is not None:
            gaps.append(gap)
        t0 = time.perf_counter()
        gk.group_request(jobs_k, req)
        t1 = time.perf_counter()
        gr.group_request(jobs_r, dataclasses.replace(req))
        t2 = time.perf_counter()
        t_k.append(t1 - t0)
        t_r.append(t2 - t1)
        if gk.events[-1] != gr.events[-1]:
            _explain_divergence(gk, gr, req)
    launches = pairwise_js.launches
    seconds = time.perf_counter() - t_all
    part_k = sorted(sorted(m.stream_id for m in j.members) for j in jobs_k)
    part_r = sorted(sorted(m.stream_id for m in j.members) for j in jobs_r)
    assert gk.events == gr.events and part_k == part_r
    kinds = {}
    for e in gk.events:
        kinds[e["kind"]] = kinds.get(e["kind"], 0) + 1
    print(f"[group] events identical to the plain path: {len(gk.events)} "
          f"({kinds}); {len(jobs_k)} jobs, partitions identical; index "
          f"capacity {gk.index.capacity}")
    print(f"[group] pairwise_js launches={launches} (expected {reached}: "
          f"requests that reached the shortlist)")
    assert launches == reached > 0, (launches, reached)
    gaps = np.asarray(gaps)
    print(f"[group] shortlist near-ties: {gaps.size} requests had more "
          f"passing jobs than k={SHORTLIST_K}; the gap between the k-th and "
          f"next job minimum (plain version, float64 of fp32) was below "
          f"1e-5 / 1e-6 / 1e-7 in {int((gaps < 1e-5).sum())} / "
          f"{int((gaps < 1e-6).sum())} / {int((gaps < 1e-7).sum())} of "
          f"them; smallest {gaps.min() if gaps.size else math.nan:.3e}")
    copies = []
    for _ in range(20):          # the block the index copies per request
        t0 = time.perf_counter()
        torch.from_numpy(gk.index._sig).to(DEV)
        torch.cuda.synchronize()
        copies.append(time.perf_counter() - t0)
    stats = {"launches": launches, "capacity": gk.index.capacity,
             "ms": _median_ms(t_k), "plain_ms": _median_ms(t_r),
             "copy_ms": _median_ms(copies), "seconds": seconds}
    print(f"[group] ms per request, median: kernel path {stats['ms']:.3f}, "
          f"plain path {stats['plain_ms']:.3f}; of it the copy of the "
          f"({stats['capacity']}, {BUCKETS}) signature block to the card "
          f"{stats['copy_ms']:.3f}; the phase (both storms and the census) "
          f"took {seconds:.1f}s")
    return stats


def _job_minima(index, sig, impl):
    """The shortlist's ranking values: per job (ascending key), the least
    JS between `sig` and a member signature, as SignatureIndex computes
    them with pairwise_js `impl`."""
    rows_sorted, starts, seg_keys, meta = index._segments()
    q = torch.as_tensor(np.asarray(sig, np.float32)[None], device=DEV)
    d = ops.pairwise_js(q, torch.as_tensor(index._sig, device=DEV),
                        impl=impl)[0].double().cpu().numpy()
    return seg_keys, np.minimum.reduceat(
        np.where(meta[3], d[rows_sorted], np.inf), starts)


def _shortlist_gap(grouper, req):
    """Before `req` is grouped: when more jobs pass the prefilter than
    the shortlist holds, the gap between the k-th and the next smallest
    job minimum (plain version, so no kernel launch is counted); a gap
    below the kernels' rounding difference can flip the shortlist."""
    idx = grouper.index
    keys = idx.candidate_jobs(req.t, req.loc, eps_t=grouper.eps_t,
                              delta_loc=grouper.delta_loc,
                              exclude_job=req.last_job)
    if len(keys) <= SHORTLIST_K:
        return None
    seg_keys, jobmin = _job_minima(idx, req.sig, "ref")
    v = np.sort(jobmin[np.searchsorted(seg_keys, keys)])
    return v[SHORTLIST_K] - v[SHORTLIST_K - 1]


def _explain_divergence(gk, gr, req):
    """The two paths decided one request differently: print each path's
    smallest job minima of the JS row (the shortlist is the first
    SHORTLIST_K of them) and stop."""
    for name, g in (("kernel", gk), ("plain", gr)):
        _, jobmin = _job_minima(g.index, req.sig, g.index.impl)
        print(f"[group] divergence at {req.stream_id}: {name} path event "
              f"{g.events[-1]}; smallest job minima after it "
              f"{np.sort(jobmin)[:SHORTLIST_K + 2].tolist()}")
    raise AssertionError(f"grouping diverged at request {req.stream_id}")


# ---------------------------------------------------------------------------
# phase 8: timing
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


def _device_ms(fn, sets, kernel, iters=20):
    """Mean device time (ms) of one launch of the CUDA kernel named
    `kernel`, under torch.profiler (CUDA activity only) over `iters` calls
    of `fn`: the kernel alone, without the host's time to launch it,
    which CUDA events around a short kernel measure instead. The profiler
    on the card may drop some launches' records; the mean is over those
    it kept, and the count is printed when it kept fewer than `iters`."""
    from torch.profiler import ProfilerActivity, profile
    for i in range(3):
        fn(*sets[i % len(sets)])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(iters):
            fn(*sets[i % len(sets)])
        torch.cuda.synchronize()
    evs = [e for e in prof.key_averages() if kernel in e.key]
    count = sum(e.count for e in evs)
    if not 0 < count <= iters:
        raise AssertionError(f"profiler saw {count} launches of {kernel} "
                             f"in {iters} calls")
    if count < iters:
        print(f"[time] the profiler kept {count} of {iters} launches of "
              f"{kernel}")
    return sum(e.device_time_total for e in evs) / count / 1e3


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
        device_ms=_device_ms(lambda q, k, v: flash_attention(q, k, v), sets,
                             "attn_fwd_kernel"),
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
        device_ms=_device_ms(lambda q, k, v: flash_attention(q, k, v), sets,
                             "attn_fwd_kernel"),
        plain_ms=_time_ms(lambda q, k, v: attention_ref(q, k, v), sets),
        library_ms=_time_ms(lambda q, k, v: F.scaled_dot_product_attention(
            q, k, v), sdpa_sets),
        bound=_bound(nbytes, flops, bf16, pk))

    for name, r in rows.items():
        _print_time(f"flash_attention {name}", r)
    return rows


def time_fleet_drift(pk, windows, refs):
    """fleet_drift at the drift plane's shape, rotating over its windows
    (each 102 MB of tokens, past L2). Bytes: tokens and reference read,
    hists and scores written, 4NT + 8NB + 4N. Operations: one bucket
    increment per token and about 12 per (row, bucket) for the two
    normalisations and the two KL terms (each log counted as one)."""
    N, T = windows[0].shape
    B = refs.shape[1]
    sets = [(w, refs) for w in windows]

    def kern(t, r):
        return fleet_drift(t, r, buckets=B, vocab=DRIFT_VOCAB)

    def plain(t, r):
        return fleet_drift_ref(t, r, buckets=B, vocab=DRIFT_VOCAB)

    r = dict(shape=f"tokens ({N},{T}) int32, ref ({N},{B}) fp32, vocab "
                   f"{DRIFT_VOCAB}",
             ms=_time_ms(kern, sets),
             device_ms=_device_ms(kern, sets, "fleet_drift_kernel"),
             plain_ms=_time_ms(plain, sets, iters=10),
             library_ms=None,
             bound=_bound(4 * N * T + 8 * N * B + 4 * N,
                          N * T + 12 * N * B, torch.float32, pk))
    _print_time("fleet_drift", r)
    return r


def time_pairwise_js(pk, cap):
    """pairwise_js at the grouper's shape (1 request against the index's
    capacity block) and at 32 requests, rotating 16 input sets (64 MB, past
    L2). Bytes 4(NB + MB + NM); operations about 5 N M B, each log counted
    as one (the Pallas form's count: the least work for this function)."""
    gen = torch.Generator(device=DEV).manual_seed(5)
    q_sets = []
    for _ in range(16):
        q = torch.rand((cap, BUCKETS), generator=gen, device=DEV)
        q[torch.rand(cap, generator=gen, device=DEV) < 0.4] = 0.0
        q_sets.append(q)
    rows = {}
    for N in (1, 32):
        sets = [(torch.rand((N, BUCKETS), generator=gen, device=DEV), q)
                for q in q_sets]
        M, B = cap, BUCKETS
        rows[N] = dict(
            shape=f"p ({N},{B}), q ({M},{B}) fp32",
            ms=_time_ms(pairwise_js, sets),
            device_ms=_device_ms(pairwise_js, sets, "pairwise_js_kernel"),
            plain_ms=_time_ms(pairwise_js_ref, sets, iters=10),
            library_ms=None,
            bound=_bound(4 * (N * B + M * B + N * M), 5 * N * M * B,
                         torch.float32, pk))
        _print_time("pairwise_js", rows[N])
    return rows


def _print_time(name, r):
    bms, by = r["bound"]
    lib = "none" if r["library_ms"] is None else f"{r['library_ms']:.4f} ms"
    print(f"[time] {name} {r['shape']}: kernel {r['ms']:.4f} ms per call "
          f"({r['device_ms']:.4f} ms on the device) | plain "
          f"{r['plain_ms']:.4f} ms | library {lib} | bound {bms:.4f} ms "
          f"({by}) | kernel at {100 * bms / r['device_ms']:.1f}% of bound")


def _timing_keys(r):
    bms, by = r["bound"]
    return {"ms": r["ms"], "device_ms": r["device_ms"],
            "plain_ms": r["plain_ms"], "bound_ms": bms, "bound_by": by,
            "library_ms": r["library_ms"]}


def _entry(name, source, replaces, launches, err, row, **extra):
    entry = {"name": name, "route": "cuda",
             "source": f"src/repro_torch/csrc/{source}",
             "replaces": replaces, "launches": launches,
             "max_abs_err": err, **_timing_keys(row), "shape": row["shape"]}
    for key, sub in extra.items():
        entry[key] = dict(_timing_keys(sub), shape=sub["shape"])
    return entry


def main():
    print(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} devices {torch.cuda.device_count()}")
    smi = nvidia_smi()
    print(f"[env] nvidia-smi: {smi}")
    card = torch.cuda.get_device_name(0)
    pk = peaks(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    build_all()
    cap = index_capacity(JOINERS)
    err = {"flash_attention": check_attention()}
    err["fleet_drift"] = check_fleet_drift()
    err["pairwise_js"] = check_pairwise_js(cap)
    launches = serve_full_width()
    profile_serving()
    compare_logits()
    launches["fleet_drift"], split, windows, refs = drift_plane()
    storm = grouping_storm()
    launches["pairwise_js"] = storm["launches"]
    assert storm["capacity"] == cap, (storm["capacity"], cap)
    att = time_attention(pk)
    fd = time_fleet_drift(pk, windows, refs)
    pj = time_pairwise_js(pk, cap)
    print(f"[drift] kernel share of one observe at {DRIFT_N} streams: "
          f"{100 * fd['ms'] / split['total']:.2f}%")
    print(f"[group] kernel share of one grouping request: "
          f"{100 * pj[1]['ms'] / storm['ms']:.2f}% ({pj[1]['ms']:.4f} of "
          f"{storm['ms']:.3f} ms)")

    src = {name: (source, replaces) for name, source, replaces in KERNELS}
    kernels = [
        _entry("flash_attention", *src["flash_attention"],
               launches["flash_attention"], err["flash_attention"],
               att["prefill"], decode=att["decode"]),
        _entry("fleet_drift", *src["fleet_drift"], launches["fleet_drift"],
               err["fleet_drift"], fd),
        _entry("pairwise_js", *src["pairwise_js"], launches["pairwise_js"],
               err["pairwise_js"], pj[1], requests_32=pj[32]),
    ]
    assert [e["name"] for e in kernels] == [k[0] for k in KERNELS]
    for e in kernels:
        assert e["launches"] > 0, e
        assert all(math.isfinite(e[k]) for k in
                   ("ms", "device_ms", "plain_ms", "bound_ms",
                    "max_abs_err")), e
        if e["name"] in NO_LIBRARY_CALL:
            assert e["library_ms"] is None, e
        else:
            assert math.isfinite(e["library_ms"]), e
    print(f"[env] chip_smoke ran {time.perf_counter() - t_start:.1f}s after "
          f"start-up")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
