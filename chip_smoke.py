#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Phases, in order; the script exits non-zero at the first failure:

1. torch/CUDA versions and the card's name and power limit (nvidia-smi).
2. Build every CUDA kernel of the port from this checkout (one nvcc per
   source, all started together) and print the build seconds and the
   compiler's register / spill report; then the SASS's tensor-core
   instructions (HMMA) of flash_attention's, mlstm_scan's and ssd_scan's
   kernels, required in their bf16 products and absent from their
   CUDA-core kernels.
3. Hold each kernel against its plain PyTorch version on the card: for
   flash_attention the tests/test_kernels.py sweep plus the serving shapes
   of olmo-1b (bf16 prefill (1, 512, 16, 16, 128) causal; decode S=1 over
   a strided prefix of a (4, 1024, 16, 128) bf16 cache) and of hymba-1.5b
   (GQA 25/5 at head_dim 64: prefill (1, 1152) causal; decode over a
   strided prefix of a (4, 1184, 5, 64) cache) and the training plane's
   eval forward (64, 256, 16, 16, 128) causal in fp32 and bf16; for
   ssd_scan the six
   cases of tests/test_kernels.py and hymba's prefill shape (1, 1152, 50,
   64, N 16) at chunks 64 and 128, final state included, bf16 on the
   tensor-core path and fp32 on the CUDA-core kernel (also against the
   token-by-token oracle), then on tensor cores a ragged S, S shorter
   than the chunk and batch 2; for mlstm_scan
   the six cases of tests/test_kernels.py, xlstm-350m's prefill shape (1,
   1024, 4, 512) bf16 at chunk 64 (output and final state), a ragged
   S = 1000 with the state also against the token-by-token oracle, and
   the full shape in fp32 against the oracle, and in bf16 the tensor-core
   path's 128-step tile at chunk 128 (S 1024) and chunk 96 (ragged S
   1000, state also against the oracle); for fleet_drift and
   pairwise_js their CPU sweeps and the planes' full shapes (fleet_drift
   also on uniform tokens over olmo's vocabulary, with modulo hashing at
   64 and 48 buckets, and on the drift plane's bigram tokens). Tolerance
   fp32 2e-4, bf16 2e-2 (drift and JS 1e-5 / 1e-6 absolute).
4. Serve olmo-1b, hymba-1.5b and xlstm-350m at full width through
   `repro_torch.launch.serve.main` (8 requests, 4 slots, 32 new tokens,
   random weights from seed 0; olmo 512-token prompts, hymba and xlstm
   1024-token prompts, so with its 128 meta tokens hymba's windowed
   layers' ring has wrapped at prefill). Launch counters are set to 0 just
   before each run and read just after: every global-attention layer must
   have gone through flash_attention once per prefill and once per decode
   call, every hymba layer's Mamba heads through ssd_scan once per
   prefill, and every xlstm mLSTM block through mlstm_scan once per
   prefill (12 x 8 = 96). Then for each a short torch.profiler window over
   one prefill and a few decode ticks: device busy share and the kernels
   that take most device time; for hymba also the device time of the
   plain windowed attention, for xlstm that of the plain sLSTM scan.
5. Full-width prefill last-token logits, kernel path vs plain path, same
   weights, bf16 compute, for the three models; for hymba and xlstm also
   fp32 compute.
6. The drift plane at 100,000 streams and flash_crowd_10k's join storm
   through the grouper, each kernel path against its exact or plain path;
   the storm keeps the index's signature block on the card and counts its
   full-block and dirty-row uploads.
6b. Train olmo-1b at full width through the training plane
   (`repro_torch.core.trainer`, random weights from seeds 0 and 1, nothing
   cut): two RetrainJobs in a capacity-2 JobBank (28.24 GB of fp32 state
   on the card), batch 8 x 256, 4 steps a micro-window. One warm-up and
   three timed micro-windows of `train_micro_many` (ms, tokens trained/s,
   each step's loss and grad norm, all finite), one profiled (device
   busy, idle share, kernels; no flash_attention launch: the train
   forward takes the autograd route); peak device memory beside the
   bank's bytes. eval_jobs at fp32 (the CUDA-core attention kernel) and
   bf16 (the tensor-core prefill), 16 flash_attention launches a
   forward, on eval rows whose tokens 1..64 are the plain route's own
   greedy continuation; the logits of that call are kept and held to the
   plain route's on the same rows: the largest difference within
   GAP_LIMIT, every argmax flip where the plain top-1 leads by at most
   twice it, at least half the generated positions hit on both routes.
   Then job 0's micro-window twice in one call, on its row and on a twin
   made from that row and rng, under
   torch.use_deterministic_algorithms(True): the rows equal bit for bit.
   Then one micro-window of hymba-1.5b and xlstm-350m at
   smoke width on the card and on the CPU (the autograd route through
   ssd_chunked / mlstm_chunked): losses finite and within 2e-2.
6c. ECCO's window loop (`repro_torch.core.controller`, through
   `repro_torch.testing.trace`) on the benign golden scenario (drift_wave,
   2 regions x 2 streams, 3 windows) and controller config. (a) At smoke
   width from the reference's initial weights
   (tests/fixtures/golden_engine_init.npz), fp32 compute, TF32 off, under
   ecco, naive, ekya and recl, on the card (flash_attention on every eval
   forward) and on the CPU: `compare` finds no difference, groups and
   events equal; ecco again on the card with drift_impl="auto" and a
   top-2 shortlist: the same trace, fleet_drift once a window,
   pairwise_js once per grouping request that met a job. (b) The four
   goldens at their own configuration (bf16 compute) on the card: each
   framework's `compare` differences against tests/golden/, counted, not
   asserted. (c) olmo-1b at full width (its vocabulary cut to the
   scenario's 64), random weights, bf16 compute, ecco with the kernel
   routes, a JobBank of 4 rows, invariants on: ms, micro-windows and
   tokens trained per window, each kernel's launches against the count
   reckoned from the eval forwards and the grouping requests, the last
   window profiled, peak memory beside the bank's bytes; losses finite,
   triggers equal to an exact host detector's, no host copy of a job's
   state.
7. Time each kernel, its plain version and one PyTorch library call
   computing the same function (a yardstick the port never calls) at the
   serving shapes, with CUDA events after warm-up, rotating input buffers
   so that L2 does not hold them; print each beside the kernel's bound
   from its bytes and operations and the data-sheet peaks of the card
   (mlstm_scan and ssd_scan: on bf16 tensor cores, and on fp32 CUDA cores
   beside it, with each of their kernels' device time). Then the
   alternatives that `[sweep]` measures: flash_attention's plans.
8. One `{"kernels": [...]}` JSON line (flash_attention's entry also
   counts the training phase's eval launches; flash_attention's,
   fleet_drift's and pairwise_js's the full-width window loop's as
   `window_launches`), the nvidia-smi line again,
   and as the last line `{"ok": true, "device": {...}}`.

Every phase prints its seconds (`[phase]`).

It needs one CUDA card and exits non-zero without one, and in a directory
that does not hold the repository's `src/`.
"""
from __future__ import annotations

import collections
import concurrent.futures
import contextlib
import dataclasses
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time
import zlib

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))
# cuBLAS is deterministic only with a fixed workspace, set before CUDA
# starts; the training phase's determinism check needs it
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import numpy as np  # noqa: E402
import torch  # noqa: E402

if not torch.cuda.is_available():
    sys.exit("chip_smoke: no CUDA device; this script runs on the card")

import torch.nn.functional as F  # noqa: E402

from repro_torch.configs import get_config, smoke_config  # noqa: E402
from repro_torch.configs.base import TrainConfig  # noqa: E402
from repro_torch.core.baselines import FRAMEWORKS  # noqa: E402
from repro_torch.core.controller import ControllerConfig  # noqa: E402
from repro_torch.core.drift import (FleetDriftDetector,  # noqa: E402
                                    batch_token_histogram,
                                    js_divergence_rows, token_histogram)
from repro_torch.core.grouping import Grouper, Request  # noqa: E402
from repro_torch.core.signature_index import SignatureIndex  # noqa: E402
from repro_torch.core.trainer import (JobBank, RetrainJob,  # noqa: E402
                                      SharedEngine, _hit_mean)
from repro_torch.data.scenarios import build_scenario  # noqa: E402
from repro_torch.data.streams import DomainBank, Region  # noqa: E402
from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.kernels.flash_attention import SOURCE as FA_SOURCE  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    TILE as FA_TILE, _flash as fa_launch_plan, flash_attention,
    kernel_attributes as fa_attributes, plan as fa_plan)
from repro_torch.kernels.fleet_drift import SOURCE as FD_SOURCE  # noqa: E402
from repro_torch.kernels.fleet_drift import fleet_drift  # noqa: E402
from repro_torch.kernels.mlstm_scan import SOURCE as ML_SOURCE  # noqa: E402
from repro_torch.kernels.mlstm_scan import (  # noqa: E402
    TENSOR_CORE as ML_TENSOR_CORE, mlstm_scan, plan as ml_plan)
from repro_torch.kernels.pairwise_js import SOURCE as PJ_SOURCE  # noqa: E402
from repro_torch.kernels.pairwise_js import pairwise_js  # noqa: E402
from repro_torch.kernels.ref import (attention_ref,  # noqa: E402
                                     fleet_drift_ref, mlstm_chunked,
                                     mlstm_recurrent, pairwise_js_ref,
                                     split_attention_ref, ssd_chunked,
                                     ssd_recurrent)
from repro_torch.kernels.ssd_scan import SOURCE as SSD_SOURCE  # noqa: E402
from repro_torch.kernels.ssd_scan import (  # noqa: E402
    CUDA_CORE as SSD_CUDA_CORE, TENSOR_CORE as SSD_TENSOR_CORE, ssd_scan,
    plan as ssd_plan)
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models.convert import load_params_npz  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.models.param import tree_leaves, tree_map  # noqa: E402
from repro_torch.models.transformer import layer_plan  # noqa: E402
from repro_torch.models.xlstm import slstm_scan  # noqa: E402
from repro_torch.testing import trace as wtrace  # noqa: E402
from repro_torch.testing.invariants import InvariantChecker  # noqa: E402

DEV = torch.device("cuda")
TOL = {torch.float32: 2e-4, torch.bfloat16: 2e-2}
# full-width prefill logits, kernel path vs plain path, bf16 compute. The
# two paths round each kernel's output to bf16 identically except where
# their fp32 sums straddle a rounding boundary; such one-ulp flips enter
# the bf16 residual stream and propagate through the layers. 0.1 is about
# 13 bf16 ulps at |logit| in [1, 2).
LOGIT_TOL = 0.1

# the two serving paths: olmo-1b (dense) and hymba-1.5b (hybrid, 128 meta
# tokens, window 1024): 8 requests, 4 slots, 32 new tokens each
ARCH, HYMBA, XLSTM = "olmo-1b", "hymba-1.5b", "xlstm-350m"
REQUESTS, SLOTS, MAX_NEW = 8, 4, 32
SERVING = {ARCH: dict(prompt=512, capacity=1024),
           HYMBA: dict(prompt=1024, capacity=1056),
           XLSTM: dict(prompt=1024, capacity=1056)}
PROMPT, CAP = SERVING[ARCH]["prompt"], SERVING[ARCH]["capacity"]
DECODE_T = PROMPT + MAX_NEW - 1      # longest cache prefix a decode reads
# hymba: prefill sequence (prompt + meta), pool capacity (+ meta), the
# longest cache prefix a decode reads, and apply_mamba's chunk
HY_META = get_config(HYMBA).meta_tokens
HY_S = SERVING[HYMBA]["prompt"] + HY_META
HY_CAP = SERVING[HYMBA]["capacity"] + HY_META
HY_DECODE_T = HY_S + MAX_NEW - 1
SSD_CHUNK = 64
# xlstm-350m: 1024-token prompts; mLSTM heads 4 of 2048 / 4 = 512, the
# chunk of apply_mlstm_block; a ragged length for the final-state check
XL_PROMPT, XL_RAGGED, XL_HEADS, XL_P, MLSTM_CHUNK = 1024, 1000, 4, 512, 64

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
           ("pairwise_js", PJ_SOURCE, "src/repro/kernels/pairwise_js.py:54"),
           ("ssd_scan", SSD_SOURCE, "src/repro/kernels/ssd_scan.py:80"),
           ("mlstm_scan", ML_SOURCE, "src/repro/kernels/mlstm_scan.py:106")]
# flash_attention's CUDA kernels per path, as the profiler names them
FA_KERNELS = {"cuda_core": ("attn_fwd_kernel",),
              "prefill": ("attn_prefill_kernel",),
              "split_decode": ("attn_decode_split_kernel",
                               "attn_decode_combine_kernel")}
# mlstm_scan's CUDA kernels per path, as the profiler names them: the
# bf16 tensor-core path's four launches, the CUDA-core kernel
ML_TC_KERNELS = ("mlstm_gate_kernel", "mlstm_qk_kernel", "mlstm_state_kernel",
                 "mlstm_out_kernel")
ML_CC_KERNELS = ("mlstm_scan_kernel",)
# ssd_scan's: the bf16 tensor-core path's three launches, the CUDA-core
# kernel
SSD_TC_KERNELS = ("ssd_state_kernel", "ssd_walk_kernel", "ssd_out_kernel")
SSD_CC_KERNELS = ("ssd_scan_kernel",)
# kernels that no single PyTorch call computes: their library time is null
NO_LIBRARY_CALL = ("fleet_drift", "pairwise_js", "ssd_scan", "mlstm_scan")

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
# training plane: olmo-1b at full width, two jobs in a capacity-2 bank
# (the reference's first capacity of 4 would hold 56.5 GB of fp32 state),
# pools of 64 rows x 256 tokens, batch 8, 4 steps a micro-window
TRAIN_JOBS, TRAIN_ROWS, TRAIN_SEQ = 2, 64, 256
TRAIN_BATCH, TRAIN_MICRO, TRAIN_WINDOWS = 8, 4, 3
# eval rows: tokens 1..TRAIN_GEN generated greedily by the plain route;
# the largest eval logit difference, kernel vs plain route, allowed per
# precision (readings 7.2e-6 fp32, 6.25e-2 bf16 = one bf16 step at
# |logit| 8..16, on an H100 80GB HBM3 at 700 W; PERF.md)
TRAIN_GEN = 64
GAP_LIMIT = {"fp32": 1e-4, "bf16": 0.25}
# window loop: the golden drift_wave fleet (2 regions x 2 streams, 3
# windows) and controller config. Smoke width starts from the
# reference's initial weights; full width from random weights in a bank
# of 4 rows (12.89 GB each): 3 live jobs, and in the window where a job
# dies as its last member is evicted, that job's row, which frees only
# once the window lets go of the job, beside the new job the evicted
# member makes (a 3-row bank overflowed there on an H100 80GB HBM3 at
# 700 W). A fresh state is made outside training, so the peak is the
# bank plus the larger of a fresh state and a train step's working set
WINDOW_INIT = os.path.join(HERE, "tests", "fixtures",
                           "golden_engine_init.npz")
WINDOW_FP32 = dict(learning_rate=1e-3, b2=0.999, weight_decay=0.0,
                   warmup_steps=5, total_steps=100000, remat="none",
                   compute_dtype="float32")
WINDOW_BANK = 4
WINDOW_ACC_GAP = 1e-4       # (a): card vs CPU per-stream accuracies
WINDOW_KERNELS = (flash_attention, fleet_drift, pairwise_js)


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
    top = float(w.abs().max()) if w.numel() else 0.0
    print(f"[check] {name}: max_abs_err={err:.3e} (max |plain| {top:.3g}) "
          f"atol={tol:g} rtol={rtol:g} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: kernel disagrees with plain version")
    return err


def _attn_case(name, q, k, v, path, causal=True, window=0, plain=None):
    """One flash_attention case on the path `plan` must pick, held to the
    plain version (`attention_ref`, or `plain` where rows see no key:
    the kernel's 0 is `split_attention_ref`'s); returns the error."""
    pl = fa_plan(q, k, v)
    assert pl.path == path, (name, pl.path, path)
    if path == "prefill":
        path += f", {pl.groups} kv group{'s' * (pl.groups > 1)}"
    want = (plain or attention_ref)(q, k, v, causal=causal, window=window)
    return _check(f"{name} [{path}]",
                  flash_attention(q, k, v, causal=causal, window=window),
                  want, TOL[q.dtype])


def check_attention():
    """flash_attention against its plain version: the tests/test_kernels.py
    sweep and hd 18 (scalar loads) in both dtypes, then the tensor-core
    paths in bf16 (prefill at hd 32, 40, 64, 128, S not a multiple of 64,
    appended queries, window 32, non-causal, GQA 25/5, rows with no
    visible key, with two kv groups per block and, on grids of 2 x 132
    blocks or more, one; split-KV decode over strided cache views with
    ragged last splits, splits of several tiles, and S = 4 appended
    queries with a window, so splits before the first visible key), then
    the serving shapes, the training plane's eval shapes (fp32 on the
    CUDA-core kernel, bf16 on the tensor-core prefill) and the window
    loop's (fp32). Returns the largest error at those shapes."""
    gen = torch.Generator(device=DEV).manual_seed(0)
    sweep = [(1, 128, 128, 4, 4, 64), (2, 64, 64, 4, 2, 32),
             (1, 96, 96, 8, 1, 64), (1, 32, 128, 4, 2, 64)]
    for dtype in (torch.float32, torch.bfloat16):
        path = "cuda_core" if dtype == torch.float32 else "prefill"
        for B, S, T, H, K, hd in sweep:
            for causal, window in ((True, 0), (True, 32), (False, 0)):
                if not causal and S != T:
                    continue
                q = _randn((B, S, H, hd), dtype, gen)
                k = _randn((B, T, K, hd), dtype, gen)
                v = _randn((B, T, K, hd), dtype, gen)
                _attn_case(f"sweep {str(dtype)[6:]} B{B} S{S} T{T} H{H} K{K} "
                           f"hd{hd} causal={causal} window={window}",
                           q, k, v, path, causal, window)
    # head_dim 18 is not a multiple of 16 bytes: the scalar load path
    for dtype in (torch.float32, torch.bfloat16):
        q = _randn((2, 40, 4, 18), dtype, gen)
        k = _randn((2, 72, 2, 18), dtype, gen)
        v = _randn((2, 72, 2, 18), dtype, gen)
        _attn_case(f"scalar loads {str(dtype)[6:]} B2 S40 T72 H4 K2 hd18 "
                   f"causal", q, k, v, "cuda_core")
    bf16 = torch.bfloat16
    for B, S, T, H, K, hd, causal, window, plain, what in [
            (2, 200, 200, 8, 2, 32, True, 0, None, "S % 64 != 0"),
            (2, 200, 200, 8, 2, 40, True, 0, None, "padded hd"),
            (2, 200, 200, 8, 2, 64, True, 0, None, "S % 64 != 0"),
            (2, 200, 200, 8, 2, 128, True, 0, None, "S % 64 != 0"),
            (2, 100, 300, 8, 4, 64, True, 0, None, "appended queries"),
            (1, 90, 333, 4, 2, 128, True, 32, None, "appended, window 32"),
            (1, 256, 256, 4, 2, 128, True, 32, None, "window 32"),
            (2, 150, 150, 4, 1, 64, False, 0, None, "non-causal MQA"),
            (1, 70, 200, 4, 4, 64, False, 0, None, "non-causal S < T"),
            (1, 300, 300, 25, 5, 64, True, 0, None, "GQA 25/5"),
            (1, 80, 40, 4, 2, 64, True, 0, split_attention_ref,
             "S > T: rows without keys are 0"),
            (2, 600, 600, 16, 4, 128, True, 100, None, "window 100"),
            (1, 1000, 1000, 20, 5, 64, False, 0, None, "non-causal"),
            (1, 1100, 600, 16, 4, 64, True, 0, split_attention_ref,
             "S > T: rows without keys are 0")]:
        q = _randn((B, S, H, hd), bf16, gen)
        k = _randn((B, T, K, hd), bf16, gen)
        v = _randn((B, T, K, hd), bf16, gen)
        _attn_case(f"tensor cores B{B} S{S} T{T} H{H} K{K} hd{hd} "
                   f"causal={causal} window={window} ({what})", q, k, v,
                   "prefill", causal, window, plain)
    # split-KV decode over strided prefixes of a cache
    for B, S, cap, T, H, K, hd, window, plain, what in [
            (3, 1, 512, 300, 8, 8, 128, 0, None, "ragged last split"),
            (4, 1, 1024, 700, 16, 16, 128, 0, None,
             "multi-tile splits, ragged"),
            (2, 1, 1000, 777, 25, 5, 64, 0, None, "GQA 25/5, ragged"),
            (2, 1, 1000, 777, 25, 5, 64, 32, None, "window 32"),
            (3, 2, 256, 129, 4, 1, 32, 0, None, "MQA S 2, hd 32"),
            (2, 4, 800, 600, 8, 2, 64, 100, None,
             "S 4 appended, window 100: splits before the first key"),
            (2, 6, 64, 3, 4, 2, 64, 0, split_attention_ref,
             "S > T: rows without keys are 0")]:
        q = _randn((B, S, H, hd), bf16, gen)
        ck, cv = (_randn((B, cap, K, hd), bf16, gen) for _ in range(2))
        kp, vp = ck[:, :T], cv[:, :T]
        assert not kp.is_contiguous()
        pl = fa_plan(q, kp, vp)
        _attn_case(f"split decode B{B} S{S} T{T}/{cap} H{H} K{K} hd{hd} "
                   f"window={window} ({what}; {pl.splits} splits of "
                   f"{pl.split})", q, kp, vp, "split_decode", True, window,
                   plain)
    serving = []
    q, k, v = (_randn((1, PROMPT, 16, 128), bf16, gen) for _ in range(3))
    serving.append(_attn_case(
        "serving prefill bf16 (1,512,16,16,128) causal", q, k, v,
        "prefill"))
    ck, cv = (_randn((SLOTS, CAP, 16, 128), bf16, gen) for _ in range(2))
    for qdt in (bf16, torch.float32):
        q = _randn((SLOTS, 1, 16, 128), qdt, gen)
        kp, vp = ck[:, :DECODE_T], cv[:, :DECODE_T]   # strided views
        assert not kp.is_contiguous()
        err = _attn_case(f"serving decode q {str(qdt)[6:]} over bf16 cache "
                         f"prefix (4,{DECODE_T}/{CAP},16,128)", q, kp, vp,
                         "split_decode" if qdt == bf16 else "cuda_core")
        if qdt == bf16:
            serving.append(err)
    # hymba's global layers: GQA group 5 at head_dim 64, S + meta = 1152
    q = _randn((1, HY_S, 25, 64), bf16, gen)
    k, v = (_randn((1, HY_S, 5, 64), bf16, gen) for _ in range(2))
    serving.append(_attn_case(
        f"hymba prefill bf16 q (1,{HY_S},25,64) k,v (1,{HY_S},5,64) causal",
        q, k, v, "prefill"))
    ck, cv = (_randn((SLOTS, HY_CAP, 5, 64), bf16, gen) for _ in range(2))
    q = _randn((SLOTS, 1, 25, 64), bf16, gen)
    kp, vp = ck[:, :HY_DECODE_T], cv[:, :HY_DECODE_T]
    assert not kp.is_contiguous()
    serving.append(_attn_case(
        f"hymba decode q (4,1,25,64) over bf16 cache prefix "
        f"(4,{HY_DECODE_T}/{HY_CAP},5,64)", q, kp, vp, "split_decode"))
    # the training plane's evals: one job's 8 members of 8 rows flattened
    # into one forward, olmo-1b's 16 heads at head_dim 128
    for dtype, path in ((torch.float32, "cuda_core"), (bf16, "prefill")):
        q, k, v = (_randn((8 * TRAIN_BATCH, TRAIN_SEQ, 16, 128), dtype, gen)
                   for _ in range(3))
        serving.append(_attn_case(
            f"train-plane eval {str(dtype)[6:]} (64,{TRAIN_SEQ},16,16,128) "
            f"causal", q, k, v, path))
    # the window loop's evals: 8 members flattened into one forward of
    # the scenario's 32 tokens, 16 or 8 rows a member, fp32 on the
    # CUDA-core kernel
    for rows in (128, 64):
        q, k, v = (_randn((rows, 32, 16, 128), torch.float32, gen)
                   for _ in range(3))
        serving.append(_attn_case(
            f"window eval fp32 ({rows},32,16,16,128) causal", q, k, v,
            "cuda_core"))
    return max(serving)


def _sass_counts(source):
    """Tensor-core (HMMA) and fp32 FMA (FFMA) instruction counts of each
    kernel in the built library of `source`, from `cuobjdump -sass` (or,
    without cuobjdump, the PTX's mma.sync / fma.rn.f32); returns
    ({mangled kernel name: {"HMMA": n, "FFMA": n}}, what was read)."""
    lib = _build.library_path(source)
    tool = shutil.which("cuobjdump") or os.path.join(
        os.path.dirname(_build.nvcc_path()), "cuobjdump")
    counts = {}
    if os.path.exists(tool):
        sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                              text=True, check=True, timeout=120).stdout
        name = None
        for line in sass.splitlines():
            m = re.search(r"Function : (\S+)", line)
            if m:
                name = m.group(1)
                counts[name] = {"HMMA": 0, "FFMA": 0}
            elif name:
                for op in ("HMMA", "FFMA"):
                    if re.search(rf"\b{op}\b", line):
                        counts[name][op] += 1
        return counts, "cuobjdump -sass"
    ptx = lib.with_suffix(".ptx")
    subprocess.run([_build.nvcc_path(), "-gencode",
                    "arch=compute_90a,code=compute_90a", "-std=c++17", "-O3",
                    "-ptx", "-o", str(ptx), str(_build.CSRC / source)],
                   check=True, timeout=300)
    name = None
    for line in ptx.read_text().splitlines():
        m = re.match(r"\.visible \.entry (\S+)\(|\.entry (\S+)\(",
                     line.strip())
        if m:
            name = m.group(1) or m.group(2)
            counts[name] = {"HMMA": 0, "FFMA": 0}
        elif name:
            counts[name]["HMMA"] += "mma.sync" in line
            counts[name]["FFMA"] += "fma.rn.f32" in line
    return counts, "PTX (mma.sync as HMMA, fma.rn.f32 as FFMA)"


def _sass_by_kind(source, kinds):
    """HMMA per kernel kind (summed over its instantiations), printing each
    instantiation's HMMA and FFMA counts."""
    counts, how = _sass_counts(source)
    hmma = {}
    for name, c in sorted(counts.items()):
        kind = next((k for k in kinds if k in name), None)
        if kind is None:
            continue
        hmma[kind] = hmma.get(kind, 0) + c["HMMA"]
        args = name.split(kind, 1)[1].split("EEv")[0]   # template arguments
        print(f"[sass] {how}: {kind}{args}: HMMA {c['HMMA']}, FFMA "
              f"{c['FFMA']}")
    return hmma


def tensor_core_report():
    """The built flash_attention, mlstm_scan and ssd_scan libraries' SASS:
    tensor-core (HMMA) and fp32 FMA (FFMA) instruction counts of each
    kernel, which must show HMMA in flash_attention's prefill and
    split-decode kernels, in mlstm_scan's bf16 products (q k^T, the state
    walk, the output) and in ssd_scan's (the chunk states, the output),
    and none in the three CUDA-core kernels; then flash_attention's
    registers and shared memory as the card reports them."""
    hmma = _sass_by_kind(FA_SOURCE, ("attn_prefill_kernel",
                                     "attn_decode_split_kernel",
                                     "attn_decode_combine_kernel",
                                     "attn_fwd_kernel"))
    assert hmma.get("attn_prefill_kernel", 0) > 0, hmma
    assert hmma.get("attn_decode_split_kernel", 0) > 0, hmma
    assert hmma.get("attn_fwd_kernel", 1) == 0, hmma
    ml = _sass_by_kind(ML_SOURCE, ML_TC_KERNELS + ML_CC_KERNELS)
    for kind in ("mlstm_qk_kernel", "mlstm_state_kernel", "mlstm_out_kernel"):
        assert ml.get(kind, 0) > 0, ml
    assert ml.get("mlstm_scan_kernel", 1) == 0, ml
    hmma.update(ml)
    ssd = _sass_by_kind(SSD_SOURCE, SSD_TC_KERNELS + SSD_CC_KERNELS)
    for kind in ("ssd_state_kernel", "ssd_out_kernel"):
        assert ssd.get(kind, 0) > 0, ssd
    assert ssd.get("ssd_scan_kernel", 1) == 0, ssd
    hmma.update(ssd)
    for kernel in ("prefill", "prefill_2_groups", "split_decode", "combine",
                   "cuda_core"):
        for hdp in ((32, 64, 128) if kernel != "combine" else (128,)):
            a = fa_attributes(kernel, hdp)
            print(f"[sass] flash_attention {kernel} hd<={hdp}: "
                  f"{a['registers']} registers, shared memory "
                  f"{a['static_smem']} static + {a['dynamic_smem']} dynamic "
                  f"bytes, {a['local_bytes']} local bytes per thread")
    return hmma


def _ssd_inputs(B, S, H, P, N, dtype, gen):
    """x, dt (softplus of a normal, rounded to `dtype` as the JAX sweep
    makes it, handed over in fp32), A = -exp(0.3 z), Bm and Cm as the two
    halves of one (B, S, 2N) projection (strided views, as apply_mamba
    passes them), D = 1 + 0.1 z."""
    x = _randn((B, S, H, P), dtype, gen)
    dt = F.softplus(_randn((B, S, H), torch.float32, gen)).to(dtype).float()
    A = -torch.exp(0.3 * _randn((H,), torch.float32, gen))
    Bm, Cm = _randn((B, S, 2 * N), dtype, gen).chunk(2, dim=-1)
    D = 1.0 + 0.1 * _randn((H,), torch.float32, gen)
    return x, dt, A, Bm, Cm, D


def _ssd_case(name, args, chunk, path, oracle=False):
    """One ssd_scan case on the path `plan` must pick, output and final
    state held to `ssd_chunked` (and with `oracle` also to the
    token-by-token `ssd_recurrent`); returns the largest error."""
    x, Bm, Cm = args[0], args[3], args[4]
    Q = min(chunk, x.shape[1])
    assert ssd_plan(x, Bm, Cm, Q) == path, (name, path)
    tag = "tensor_core" if path == SSD_TENSOR_CORE else "cuda_core"
    tol = TOL[x.dtype]
    y, st = ssd_scan(*args, chunk=chunk, return_state=True)
    wy, wst = ssd_chunked(*args, chunk=chunk, return_state=True)
    errs = [_check(f"{name} [{tag}] y", y, wy, tol),
            _check(f"{name} [{tag}] state", st, wst, tol)]
    if oracle:
        ry, rst = ssd_recurrent(*args, return_state=True)
        errs += [_check(f"{name} [{tag}] y vs token-by-token oracle", y, ry,
                        tol),
                 _check(f"{name} [{tag}] state vs oracle", st, rst, tol)]
    return max(errs)


def check_ssd():
    """ssd_scan against its plain version `ssd_chunked`, output and final
    state: the six cases of tests/test_kernels.py::test_ssd_kernel_sweep
    (bf16 on the tensor-core path, fp32 on the CUDA-core kernel), then
    hymba's prefill shape at apply_mamba's chunk (64) and the Pallas
    kernel's default (128), bf16 on tensor cores and fp32 on the CUDA-core
    kernel, fp32 also against the token-by-token oracle; then on tensor
    cores a ragged S (1000 at chunk 64, 1070 at chunk 128), S shorter than
    the chunk (40 at 64), batch 2 and an odd head count (25: the output
    kernel's last pair of heads has one) at hymba's width, states
    included.
    Returns the largest error at hymba's shape and chunk, bf16."""
    gen = torch.Generator(device=DEV).manual_seed(4)
    TC, CC = SSD_TENSOR_CORE, SSD_CUDA_CORE
    for dtype in (torch.float32, torch.bfloat16):
        path = TC if dtype == torch.bfloat16 else CC
        for B, S, H, P, N, chunk in [(1, 64, 2, 32, 16, 16),
                                     (2, 80, 1, 64, 8, 32),
                                     (1, 32, 4, 16, 32, 32)]:
            _ssd_case(f"ssd_scan sweep {str(dtype)[6:]} B{B} S{S} H{H} P{P} "
                      f"N{N} chunk{chunk}",
                      _ssd_inputs(B, S, H, P, N, dtype, gen), chunk, path)
    shape = (1, HY_S, 50, 64, 16)
    errs = {}
    for dtype in (torch.bfloat16, torch.float32):
        path = TC if dtype == torch.bfloat16 else CC
        args = _ssd_inputs(*shape, dtype, gen)
        for chunk in (SSD_CHUNK, 128):
            errs[dtype, chunk] = _ssd_case(
                f"ssd_scan hymba {str(dtype)[6:]} {shape} chunk{chunk}",
                args, chunk, path,
                oracle=dtype == torch.float32 and chunk == SSD_CHUNK)
    for B, S, H, chunk in ((1, 1000, 50, SSD_CHUNK), (1, 1070, 50, 128),
                           (1, 40, 50, SSD_CHUNK), (2, HY_S, 50, SSD_CHUNK),
                           (1, HY_S, 25, SSD_CHUNK)):
        _ssd_case(f"ssd_scan bf16 B{B} S{S} H{H} P64 N16 chunk{chunk}",
                  _ssd_inputs(B, S, H, 64, 16, torch.bfloat16, gen), chunk,
                  TC)
    return errs[torch.bfloat16, SSD_CHUNK]


def _mlstm_inputs(B, S, H, P, dtype, gen):
    """q, k, v normal; input gate 2 z, forget gate 2 z + 1 (the JAX
    sweep's draws), all in `dtype`. q, k and v are the three thirds of one
    (B, S, H, 3P) tensor and the gates the two halves of one (B, S, 2, H)
    tensor, so every input is a strided view, as the model passes them."""
    q, k, v = _randn((B, S, H, 3 * P), dtype, gen).chunk(3, dim=-1)
    g = torch.randn((B, S, 2, H), generator=gen, device=DEV) * 2
    g[:, :, 1] += 1
    g = g.to(dtype)
    return q, k, v, g[:, :, 0], g[:, :, 1]


def check_mlstm():
    """mlstm_scan against its plain version `mlstm_chunked`, output and
    final state: the six cases of tests/test_kernels.py::
    test_mlstm_kernel_sweep, xlstm-350m's prefill shape (1, 1024, 4, 512)
    bf16 at apply_mlstm_block's chunk (64), a ragged S = 1000 at that width
    with the state also against the token-by-token oracle, and the full
    shape in fp32 against the oracle. Then in bf16 the tensor-core path's
    128-step tile, which chunks of 65 to 128 steps take (the kernel's
    default chunk is 128): chunk 128 at S = 1024, and chunk 96 at the
    ragged S = 1000, its state also against the oracle. Returns the
    largest error at the prefill shape, bf16, chunk 64."""
    gen = torch.Generator(device=DEV).manual_seed(8)
    for dtype in (torch.float32, torch.bfloat16):
        for B, S, H, P, chunk in [(1, 64, 2, 32, 16), (2, 96, 3, 16, 32),
                                  (1, 33, 1, 64, 32)]:
            args = _mlstm_inputs(B, S, H, P, dtype, gen)
            h, st = mlstm_scan(*args, chunk=chunk, return_state=True)
            wh, wst = mlstm_chunked(*args, chunk=chunk, return_state=True)
            name = (f"mlstm_scan sweep {str(dtype)[6:]} B{B} S{S} H{H} P{P} "
                    f"chunk{chunk}")
            _check(f"{name} h", h, wh, TOL[dtype])
            for leaf, a, w in zip("Cnm", st, wst):
                _check(f"{name} state {leaf}", a, w, TOL[dtype])
    bf16 = torch.bfloat16
    for S, dtype, chunk in ((XL_PROMPT, bf16, MLSTM_CHUNK),
                            (XL_PROMPT, torch.float32, MLSTM_CHUNK),
                            (XL_RAGGED, bf16, MLSTM_CHUNK),
                            (XL_PROMPT, bf16, 128), (XL_RAGGED, bf16, 96)):
        shape = (1, S, XL_HEADS, XL_P)
        args = _mlstm_inputs(*shape, dtype, gen)
        if dtype == bf16:
            assert ml_plan(*args[:3], chunk) == ML_TENSOR_CORE
        h, st = mlstm_scan(*args, chunk=chunk, return_state=True)
        wh, wst = mlstm_chunked(*args, chunk=chunk, return_state=True)
        name = f"mlstm_scan xlstm {str(dtype)[6:]} {shape} chunk{chunk}"
        e = [_check(f"{name} h", h, wh, TOL[dtype])]
        e += [_check(f"{name} state {leaf}", a, w, TOL[dtype])
              for leaf, a, w in zip("Cnm", st, wst)]
        if (S, dtype, chunk) == (XL_PROMPT, bf16, MLSTM_CHUNK):
            errs = e
        if S == XL_PROMPT and dtype == bf16:
            continue
        # fp32 at the prefill shape and the ragged length: also the oracle
        rh, rst = mlstm_recurrent(*args, return_state=True)
        if dtype == torch.float32:
            _check(f"{name} h vs token-by-token oracle", h, rh, TOL[dtype])
        for leaf, a, w in zip("Cnm", st, rst):
            _check(f"{name} state {leaf} vs token-by-token oracle", a, w,
                   TOL[dtype])
    return max(errs)


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
    plane's full shape and uniform tokens over olmo-1b's vocabulary, with
    modulo hashing and over every int32 at vocab 2^31 - 1 (the 64-bit
    division). Tolerance: scores 1e-5, hists 1e-6 absolute."""
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
    run(f"fleet_drift full shape {full} uniform tokens, vocab 0, 48 "
        f"buckets (reciprocal modulo)",
        rng.integers(-OLMO_VOCAB, OLMO_VOCAB, size=full),
        rng.random((DRIFT_N, 48)), 48, 0)
    run(f"fleet_drift full shape {full} uniform int32 tokens, vocab 2^31 - 1 "
        f"(64-bit division)",
        rng.integers(-2 ** 31, 2 ** 31, size=full), ref, BUCKETS,
        2 ** 31 - 1)
    _, wins = drift_fleet(n_windows=1)
    run(f"fleet_drift full shape {full} the drift plane's bigram tokens",
        wins[1], ref, BUCKETS, DRIFT_VOCAB)
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
# phase 4: serve olmo-1b, hymba-1.5b and xlstm-350m at full width
# ---------------------------------------------------------------------------
def serve_args(arch):
    sv = SERVING[arch]
    return ["--arch", arch, "--full", "--requests", str(REQUESTS),
            "--num-slots", str(SLOTS), "--prompt-len", str(sv["prompt"]),
            "--max-new", str(MAX_NEW), "--capacity", str(sv["capacity"]),
            "--seed", "0"]


SERVING_KERNELS = (flash_attention, ssd_scan, mlstm_scan)


def reset_launches():
    for k in SERVING_KERNELS:
        k.launches = 0
    flash_attention.combine_launches = 0


def launch_counts():
    counts = {k.__name__: k.launches for k in SERVING_KERNELS}
    counts["flash_attention_combine"] = flash_attention.combine_launches
    return counts


def expected_launches(cfg, prefills, decode_calls):
    """flash_attention: every global-attention layer once per prefill and
    once per decode call (windowed layers attend in plain PyTorch), and
    its split-KV combine once per decode call (bf16 decode over S x G <= 16
    query rows per kv head: olmo's 1, hymba's 5);
    ssd_scan: every hybrid layer's Mamba heads once per prefill;
    mlstm_scan: every mLSTM block once per prefill (decode steps both
    states in plain PyTorch)."""
    plan = layer_plan(cfg)
    global_layers = sum(s.count for s in plan
                        if s.kind == "block" and s.window == 0)
    ssd_layers = cfg.num_layers if cfg.family == "hybrid" else 0
    mlstm_layers = sum(s.count for s in plan if s.kind == "mlstm")
    return {"flash_attention": global_layers * (prefills + decode_calls),
            "flash_attention_combine": global_layers * decode_calls,
            "ssd_scan": ssd_layers * prefills,
            "mlstm_scan": mlstm_layers * prefills}


def serve_full_width(arch):
    cfg = get_config(arch)
    reset_launches()
    report = serve.main(serve_args(arch))
    torch.cuda.synchronize()
    launches = launch_counts()
    out = report["outputs"]
    assert len(out) == REQUESTS, sorted(out)
    for rid, toks in out.items():
        assert len(toks) == MAX_NEW, (rid, len(toks))
        assert all(0 <= t < cfg.vocab_size for t in toks), rid
    prefills = len(report["prefill_s"])
    want = expected_launches(cfg, prefills, report["decode_calls"])
    print(f"[serve] {arch}: launches {launches} (prefills={prefills}, "
          f"decode calls={report['decode_calls']}: expected {want})")
    assert launches == want, (launches, want)
    n_tok = sum(len(v) for v in out.values())
    tick_ms = sorted(1e3 * t for t in report["tick_s"])
    pre_ms = sorted(1e3 * t for t in report["prefill_s"])
    print(f"[serve] {arch}: prefill ms ({SERVING[arch]['prompt']} tokens): "
          f"median={np.median(pre_ms):.3f} min={pre_ms[0]:.3f} "
          f"max={pre_ms[-1]:.3f} (first includes warm-up)")
    print(f"[serve] {arch}: decode ms per tick ({SLOTS} slots): "
          f"median={np.median(tick_ms):.3f} min={tick_ms[0]:.3f} "
          f"max={tick_ms[-1]:.3f} over {len(tick_ms)} ticks")
    print(f"[serve] {arch}: {n_tok} tokens in {report['seconds']:.3f}s: "
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


def profile_serving(arch):
    """Where a steady decode tick and a prefill spend their time: device
    busy share under torch.profiler (CUDA activity only) and the kernels
    that take most device time."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serve.kvcache import ServeLoop
    cfg = get_config(arch)
    prompt, cap = SERVING[arch]["prompt"], SERVING[arch]["capacity"]
    model = build_model(cfg)
    loop = ServeLoop(model, model.init(seed=0, device=DEV),
                     num_slots=SLOTS, capacity=cap, max_new=MAX_NEW)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab_size, size=prompt)
               for _ in range(SLOTS + 1)]
    for i in range(SLOTS - 1):
        loop.submit(f"p{i}", prompts[i])
    for _ in range(2):                                  # warm
        loop.tick()
    runs = {}
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        loop.submit("p_last", prompts[-1])
        runs[f"prefill (1 x {prompt} tokens)"] = (prof,
                                                   time.perf_counter() - t0)
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
            print(f"[profile] {arch} {name}: the profiler saw no device "
                  f"time; idle share not measured")
            continue
        print(f"[profile] {arch} {name}: wall {wall_ms:.3f} ms, device busy "
              f"{busy / n:.3f} ms, idle share {1 - busy / n / wall_ms:.3f} "
              f"({kernels // n} kernels per call)")
        top = sorted(pr.key_averages(), key=lambda e: -e.device_time_total)
        for e in top[:6]:
            print(f"[profile]   {e.device_time_total / 1e3 / n:8.3f} ms "
                  f"x{e.count // n:<4} {e.key[:90]}")
        for kname, parts in (("ssd_scan", SSD_TC_KERNELS + SSD_CC_KERNELS),
                             ("mlstm_scan", ML_TC_KERNELS + ML_CC_KERNELS)):
            ev = [e for e in pr.key_averages()
                  if any(k in e.key for k in parts)]
            if ev:
                print(f"[profile]   {kname} kernels: "
                      f"{sum(e.device_time_total for e in ev) / 1e3 / n:.3f}"
                      f" ms of the device busy {busy / n:.3f} ms")
    if cfg.family == "hybrid":
        profile_windowed_attention(cfg, loop.params)
    if cfg.family == "ssm":
        profile_slstm_scan(cfg, loop.params)


def profile_windowed_attention(cfg, params):
    """Device time (CUDA events) of the plain windowed attention at
    hymba's prefill shape: one layer's call, and the prefill's windowed
    layers together."""
    seg = next(i for i, s in enumerate(layer_plan(cfg)) if s.window)
    p = {k: v[0] for k, v in params["segments"][seg]["attn"].items()}
    gen = torch.Generator(device=DEV).manual_seed(6)
    x = _randn((1, HY_S, cfg.d_model), torch.bfloat16, gen)
    pos = torch.arange(HY_S, device=DEV)[None]

    def call():
        return L.attention_windowed(cfg, p, x, pos, window=cfg.sliding_window,
                                    meta=cfg.meta_tokens)

    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    ms = _time_ms(lambda: call(), [()], iters=10, warmup=2)
    peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 20
    n = sum(s.count for s in layer_plan(cfg) if s.window)
    print(f"[profile] {cfg.name} plain attention_windowed at (1, {HY_S}, "
          f"{cfg.d_model}) bf16: {ms:.3f} ms per layer call (CUDA events), "
          f"{n} windowed layers = {n * ms:.3f} ms per prefill; peak "
          f"{peak:.0f} MiB of temporaries per call")


def profile_slstm_scan(cfg, params):
    """Time (CUDA events) of the plain sLSTM recurrence at xlstm-350m's
    prefill shape: one layer's `slstm_scan` call (1024 steps, each a
    batched product and the elementwise math), and the prefill's sLSTM
    layers together."""
    seg = next(i for i, s in enumerate(layer_plan(cfg)) if s.kind == "slstm")
    rw = params["segments"][seg]["r_gates"][0]
    H, P = cfg.num_heads, cfg.d_model // cfg.num_heads
    gen = torch.Generator(device=DEV).manual_seed(9)
    g = _randn((1, XL_PROMPT, 4, H, P), torch.bfloat16, gen)
    ms = _time_ms(lambda: slstm_scan(g, rw, H), [()], iters=3, warmup=1)
    n = sum(s.count for s in layer_plan(cfg) if s.kind == "slstm")
    print(f"[profile] {cfg.name} plain slstm_scan at gates (1, {XL_PROMPT}, "
          f"4, {H}, {P}) bf16: {ms:.3f} ms per layer call (CUDA events, "
          f"{ms / XL_PROMPT * 1e3:.1f} us per step), {n} sLSTM layers = "
          f"{n * ms:.3f} ms per prefill")


# ---------------------------------------------------------------------------
# phase 5: full-width logits, kernel path vs plain path
# ---------------------------------------------------------------------------
def compare_logits(arch, dtype=torch.bfloat16):
    """Full-width prefill last-token logits, kernel path vs plain path, on
    the same weights at compute `dtype`; within LOGIT_TOL."""
    model = build_model(get_config(arch))
    cfg = model.cfg
    params = tree_map(lambda t: t.to(dtype), model.init(seed=0, device=DEV))
    prompt, cap = SERVING[arch]["prompt"], SERVING[arch]["capacity"]
    rng = np.random.default_rng(1)
    x = torch.as_tensor(rng.integers(0, cfg.vocab_size, size=(1, prompt)),
                        device=DEV)
    cap += cfg.meta_tokens
    reset_launches()
    got, _, _ = model.prefill(params, x, cap, compute_dtype=dtype)
    launches = launch_counts()
    assert launches == expected_launches(cfg, 1, 0), launches
    want, _, _ = model.prefill(params, x, cap, compute_dtype=dtype,
                               kernel_impl="ref")
    torch.cuda.synchronize()
    V = cfg.vocab_size
    g, w = got[:, :V].float(), want[:, :V].float()
    assert bool(torch.isfinite(g).all()), "non-finite logits"
    err = float((g - w).abs().max())
    same = int(g.argmax()) == int(w.argmax())
    print(f"[logits] {arch} full-width prefill last-token logits, kernel vs "
          f"plain, {str(dtype)[6:]} compute: max_abs_err={err:.4e} (|logit| "
          f"max {float(w.abs().max()):.3f}) tol={LOGIT_TOL} "
          f"argmax_equal={same}")
    assert err <= LOGIT_TOL, err
    return err


# ---------------------------------------------------------------------------
# phase 6: the drift plane at fleet scale
# ---------------------------------------------------------------------------
def drift_fleet(seed=0, n_windows=DRIFT_WINDOWS):
    """DRIFT_N streams in make_fleet's layout (vocab 64, 6 domains of dim
    4) over DRIFT_REGIONS regions, half of which switch domain at SWITCH_T.
    Each region's window is one vectorised DomainBank.sample call (a
    per-stream loop would take longer than the kernel work). Returns
    (ids, [reference window, window 1, ... window n_windows]) with
    (N, DRIFT_T) int64 token arrays."""
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
    for w in range(n_windows + 1):
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
# phase 6: the grouping plane under flash_crowd_10k's join storm
# ---------------------------------------------------------------------------
def _unit(key: str) -> float:
    """A deterministic number in [0, 1) from a string (no salted hash)."""
    return zlib.crc32(key.encode()) / 2 ** 32


class DetJob:
    """A duck-typed retraining job whose accuracy on a request's samples
    is a fixed function of (job, samples): both runs of the storm see the
    same accuracies without training 10,000 models."""

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
    index = SignatureIndex(BUCKETS, impl=impl, device="cuda")
    if impl == "ref":
        # the plain path scores against the host block, copied whole to the
        # card per request (the feed before the mirror), so it shares no
        # mirror with the kernel path: a stale mirror row shows as a
        # divergence of the two paths
        index.device_signatures = lambda: torch.from_numpy(index._sig).to(
            index.device)
    return Grouper(new_job_fn=lambda r: DetJob(r, counter), index=index,
                   shortlist_k=SHORTLIST_K)


def grouping_storm():
    """Every joiner through Grouper.group_request with the index on the
    card at shortlist_k=2, once through the kernel and once through the
    plain version, request by request in lockstep: event lists and
    partitions must be equal. One pairwise_js launch per request that
    reached the shortlist (the index held at least one job). The kernel
    path's signature block lives on the card: at most one full-block
    upload per growth of the capacity plus the first, dirty rows
    otherwise (the host time of each upload is kept), and after every
    upload the mirror equals the host block (checked outside the
    request's time). The plain path scores against the host block itself,
    copied whole per request."""
    t0 = time.perf_counter()
    reqs = storm_requests()
    print(f"[group] {len(reqs)} join requests of flash_crowd_10k drawn in "
          f"{time.perf_counter() - t0:.2f}s")
    gk, gr = _storm_grouper("auto"), _storm_grouper("ref")
    idx = gk.index
    t_up = []                    # host time of each dirty-row upload
    t_chk = [0.0]                # the current request's mirror check
    upload = idx.device_signatures

    def checked_upload():
        t0 = time.perf_counter()
        out = upload()
        t1 = time.perf_counter()
        t_up.append(t1 - t0)
        assert torch.equal(out, torch.from_numpy(idx._sig).to(out.device)), \
            f"signature mirror stale after upload {len(t_up)}"
        t_chk[0] += time.perf_counter() - t1
        return out

    idx.device_signatures = checked_upload
    jobs_k, jobs_r = [], []
    reached, t_k, t_r, gaps = 0, [], [], []
    pairwise_js.launches = 0
    t_all = time.perf_counter()
    for req in reqs:
        reached += bool(jobs_k)
        gap = _shortlist_gap(gk, req)
        if gap is not None:
            gaps.append(gap)
        t_chk[0] = 0.0
        t0 = time.perf_counter()
        gk.group_request(jobs_k, req)
        t1 = time.perf_counter()
        gr.group_request(jobs_r, dataclasses.replace(req))
        t2 = time.perf_counter()
        t_k.append(t1 - t0 - t_chk[0])
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
    growths = int(math.log2(idx.capacity // 64))
    print(f"[group] signature block on the card: {idx.full_uploads} "
          f"full-block uploads ({growths} growths of the capacity, 64 to "
          f"{idx.capacity}), {idx.rows_uploaded} dirty rows uploaded in "
          f"{len(t_up)} shortlist calls, the mirror equal to the host block "
          f"after each")
    assert idx.full_uploads <= 1 + growths, (idx.full_uploads, growths)
    stats = {"launches": launches, "capacity": idx.capacity,
             "ms": _median_ms(t_k), "plain_ms": _median_ms(t_r),
             "upload_ms": _median_ms(t_up), "seconds": seconds,
             "full_uploads": idx.full_uploads,
             "rows_uploaded": idx.rows_uploaded}
    print(f"[group] ms per request, median: kernel path {stats['ms']:.3f}, "
          f"plain path (the whole ({idx.capacity}, {BUCKETS}) block copied "
          f"per request) {stats['plain_ms']:.3f}; of the kernel path the "
          f"host's upload of the dirty rows {stats['upload_ms']:.4f}; "
          f"the phase (both storms and the census) took {seconds:.1f}s")
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
# phase 6b: train olmo-1b at full width through the training plane
# ---------------------------------------------------------------------------
def _bank_row(bank, idx):
    """Slot `idx`'s state leaves, as views of the resident stack."""
    return tree_leaves(bank.row_device(idx))


def _row_paths(bank):
    """Each leaf's path in the state tree, in `_bank_row`'s order."""
    paths = []

    def walk(t, pre):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, pre + (k,))
        elif isinstance(t, list):
            for i, v in enumerate(t):
                walk(v, pre + (i,))
        else:
            paths.append("/".join(map(str, pre)))
    walk(bank.row_device(0), ())
    return paths


def _deterministic(fn, *args):
    """fn(*args) under torch.use_deterministic_algorithms(True), which
    raises on any op without a deterministic implementation."""
    torch.use_deterministic_algorithms(True)
    out = fn(*args)
    torch.use_deterministic_algorithms(False)
    return out


def _micro_window(engine, jobs):
    """One train_micro_many call between CUDA events: (ms, metrics)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    mets = engine.train_micro_many(jobs)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end), mets


def _job_params(engine, job, cd):
    """The job's params as the evals read them: its row of the bank's
    stack cast to compute dtype `cd`."""
    return tree_map(lambda x: x[job._slot.idx],
                    engine.bank.params_stack_compute(cd))


def _greedy_rows(engine, job, precision, seed):
    """(TRAIN_BATCH, TRAIN_SEQ) eval rows of uniform tokens whose tokens
    1..TRAIN_GEN are the plain route's greedy continuation of token 0,
    for the job's params at `precision`. The plain route's argmax hits at
    those positions (up to rounding between forward shapes), so an eval
    route that is wrong loses hits there. One forward per generated
    token, over the prefix only: a causal model's position t sees tokens
    0..t."""
    cd = {"fp32": torch.float32, "bf16": torch.bfloat16}[precision]
    rows = torch.as_tensor(np.random.default_rng(seed).integers(
        0, engine.cfg.vocab_size, size=(TRAIN_BATCH, TRAIN_SEQ)), device=DEV)
    params = _job_params(engine, job, cd)
    with torch.no_grad():
        for t in range(TRAIN_GEN):
            logits, _ = engine.model.apply(params, rows[:, :t + 1],
                                           compute_dtype=cd,
                                           kernel_impl="ref")
            rows[:, t + 1] = logits[:, t].float().argmax(-1)
    return rows.cpu().numpy()


def _eval_logits(engine, job, precision, impl):
    """The (rows, S-1) fp32 logits of the member's rows in the forward
    `batched_accuracy` runs for a one-member job (the member's rows padded
    with zero rows to 8 members), through kernel route `impl`."""
    subs = np.asarray(job.members[0].subsamples)
    b = subs.shape[0]
    tk = np.zeros((8 * b,) + subs.shape[1:], subs.dtype)
    tk[:b] = subs
    cd = {"fp32": torch.float32, "bf16": torch.bfloat16}[precision]
    with torch.no_grad():
        logits, _ = engine.model.apply(_job_params(engine, job, cd),
                                       torch.as_tensor(tk, device=DEV),
                                       compute_dtype=cd, kernel_impl=impl)
    return logits[:b, :-1].float()


def _kept_logits(apply, rows, keep):
    """`apply` (a Model.apply) that also keeps, in `keep`, an fp32 copy of
    the first `rows` rows of each call's logits at positions 0..S-2."""
    def kept(*args, **kwargs):
        out = apply(*args, **kwargs)
        keep.append(out[0][:rows, :-1].to(torch.float32, copy=True))
        return out
    return kept


def _compare_eval(job, acc, lk, lr, precision):
    """One job's eval on the kernel route (`acc` from eval_jobs, `lk` the
    logits that call computed) against the plain route's logits `lr` on
    the same rows: the largest logit difference within GAP_LIMIT, every
    argmax flip where the plain top-1 leads by at most twice it, and the
    generated positions hit on both routes."""
    labels = torch.as_tensor(np.asarray(job.members[0].subsamples)[:, 1:],
                             device=DEV)
    ak, ap = lk.argmax(-1), lr.argmax(-1)
    hk, hp = int((ak == labels).sum()), int((ap == labels).sum())
    gap = float((lk - lr).abs().max())
    diff = ak != ap
    top2 = lr[diff].topk(2, dim=-1).values
    leads = (top2[:, 0] - top2[:, 1]).tolist()
    acc_plain = float((ap == labels).float().mean())
    print(f"[train]   {job.job_id} {precision}: accuracy {acc!r} kernel route"
          f" (eval_jobs), {acc_plain!r} plain route; hits {hk} / {hp} of "
          f"{labels.numel()} positions ({TRAIN_BATCH * TRAIN_GEN} "
          f"generated); largest logit difference {gap:.3e} (limit "
          f"{GAP_LIMIT[precision]:g}, max |plain| "
          f"{float(lr.abs().max()):.3g}); {int(diff.sum())} argmax flips, "
          f"plain top-1 leads {sorted(leads)[:8]}")
    # the kept logits are the ones eval_jobs scored
    assert float((ak == labels).float().mean()) == acc, acc
    assert gap <= GAP_LIMIT[precision], (gap, precision)
    assert all(x <= 2 * gap for x in leads), leads
    floor = TRAIN_BATCH * TRAIN_GEN // 2
    assert hk >= floor and hp >= floor, (hk, hp, floor)


def train_full_width():
    """olmo-1b at full width (16 layers, d_model 2048, vocabulary 50,304,
    random weights from seeds 0 and 1) trained through the port's
    training plane: two RetrainJobs of one SharedEngine (its default
    TrainConfig: bf16 compute over fp32 masters, lr 1e-3, b2 0.999) in a
    capacity-2 JobBank, each pool 64 rows of 256 uniform tokens, batch 8,
    4 steps a micro-window. Timed micro-windows, one of them profiled;
    eval_jobs at fp32 and bf16 through flash_attention (16 launches a
    forward) on rows whose first tokens are the plain route's own greedy
    continuation, against the plain route on the same rows; then the same
    micro-window run twice, job 0 and a twin made from its row and rng,
    under torch.use_deterministic_algorithms(True), the two rows equal
    bit for bit. Returns the flash_attention launches of the evals."""
    from torch.profiler import ProfilerActivity, profile

    cfg = get_config(ARCH)
    engine = SharedEngine(cfg, device=DEV)
    engine.bank = JobBank(engine, capacity=TRAIN_JOBS)
    torch.cuda.reset_peak_memory_stats()
    jobs, pools = [], []
    for seed in range(TRAIN_JOBS):
        rng = np.random.default_rng(seed)
        pools.append(rng.integers(0, cfg.vocab_size,
                                  size=(TRAIN_ROWS, TRAIN_SEQ)))
        subs = rng.integers(0, cfg.vocab_size, size=(TRAIN_BATCH, TRAIN_SEQ))
        jobs.append(RetrainJob(
            engine, Request(stream_id=f"cam{seed}", t=0.0, loc=(0.0, 0.0),
                            subsamples=subs, acc=0.0, train_data=pools[-1]),
            micro_steps=TRAIN_MICRO, batch=TRAIN_BATCH, seed=seed))
    bank = engine.bank
    n_params = engine.model.num_params()
    reckoned = bank.capacity * bank.state_row_nbytes
    print(f"[train] {ARCH}: {n_params:,} parameters; one job's state "
          f"(params, mu, nu fp32 + count) {bank.state_row_nbytes / 1e9:.2f} "
          f"GB; the bank's {bank.capacity} rows {reckoned / 1e9:.2f} GB on "
          f"the card; host mirror "
          f"{'not allocated' if bank._host is None else 'allocated'}")
    assert bank.state_row_nbytes == 12 * n_params + 4, bank.state_row_nbytes
    # the jobs' fresh states were written on the card: no host mirror
    assert bank._host is None
    alloc_peak = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    tokens = TRAIN_JOBS * TRAIN_MICRO * TRAIN_BATCH * TRAIN_SEQ
    reset_launches()
    ms, _ = _micro_window(engine, jobs)                  # warm-up
    print(f"[train] warm-up micro-window {ms:.1f} ms")
    window_ms = []
    for w in range(TRAIN_WINDOWS):
        ms, mets = _micro_window(engine, jobs)
        window_ms.append(ms)
        print(f"[train] micro-window {w}: {ms:.1f} ms, {tokens} tokens, "
              f"{tokens / ms * 1e3:.0f} tokens trained/s (train_micro_many, "
              f"{TRAIN_JOBS} jobs x {TRAIN_MICRO} steps x {TRAIN_BATCH} x "
              f"{TRAIN_SEQ})")
        for job in jobs:
            m = {k: mets[job.job_id][k].tolist() for k in ("loss",
                                                           "grad_norm")}
            print(f"[train]   {job.job_id}: loss "
                  f"{[round(x, 5) for x in m['loss']]} grad norm "
                  f"{[round(x, 5) for x in m['grad_norm']]}")
            assert all(math.isfinite(x) for x in m["loss"] + m["grad_norm"])
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.train_micro_many(jobs)
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    busy, kernels = _device_busy_ms(prof)
    attn = [e.key for e in prof.key_averages() if "attn_" in e.key]
    mean_ms = sum(window_ms) / len(window_ms)
    print(f"[train] profiled micro-window: wall {wall:.1f} ms, device busy "
          f"{busy:.1f} ms, {kernels} kernels; idle share {1 - busy / wall:.3f}"
          f" of the profiled wall (an upper bound: the profiler slows the "
          f"host), {1 - busy / mean_ms:.3f} of the unprofiled windows' mean "
          f"{mean_ms:.1f} ms")
    top = sorted(prof.key_averages(), key=lambda e: -e.device_time_total)
    for e in top[:6]:
        print(f"[train]   {e.device_time_total / 1e3:8.1f} ms x{e.count:<5} "
              f"{e.key[:90]}")
    launches = launch_counts()
    assert launches["flash_attention"] == 0 and not attn, (launches, attn)
    print(f"[train] flash_attention launches in training: "
          f"{launches['flash_attention']} (the autograd route)")
    train_peak = torch.cuda.max_memory_allocated()
    print(f"[train] peak device memory {train_peak / 1e9:.2f} GB while "
          f"training ({alloc_peak / 1e9:.2f} GB while the jobs were "
          f"allocated, a fresh 14.12 GB state beside the bank) beside the "
          f"bank's reckoned {reckoned / 1e9:.2f} GB")

    # evals: flash_attention on every forward of eval_jobs, whose logits
    # are kept and held to the plain route's on the same rows
    forwards = len(jobs)        # one member a job: one forward a job
    eval_launches = 0
    for precision in ("fp32", "bf16"):
        t0 = time.perf_counter()
        for n, job in enumerate(jobs):
            job.members[0].subsamples = _greedy_rows(engine, job, precision,
                                                     100 + n)
        t_gen = time.perf_counter() - t0
        engine.eval_jobs(jobs, precision=precision)       # warm-up
        torch.cuda.synchronize()
        keep = []
        engine.model.apply = _kept_logits(engine.model.apply, TRAIN_BATCH,
                                          keep)
        reset_launches()
        t0 = time.perf_counter()
        accs = engine.eval_jobs(jobs, precision=precision)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        n = flash_attention.launches
        del engine.model.apply          # back to the class's method
        want = cfg.num_layers * forwards
        reset_launches()
        t0 = time.perf_counter()
        plain = [_eval_logits(engine, job, precision, "ref") for job in jobs]
        torch.cuda.synchronize()
        ms_plain = 1e3 * (time.perf_counter() - t0)
        print(f"[train] eval_jobs {precision}: {ms:.1f} ms per call "
              f"({forwards} forwards of ({8 * TRAIN_BATCH}, {TRAIN_SEQ}) "
              f"rows), flash_attention launches {n} (expected {want}); the "
              f"plain route's forwards {ms_plain:.1f} ms, launches "
              f"{flash_attention.launches}; eval rows generated in "
              f"{t_gen:.1f}s")
        assert n == want and flash_attention.launches == 0, (n, want)
        assert len(keep) == forwards, len(keep)
        eval_launches += n
        for job, acc, lk, lr in zip(jobs, accs, keep, plain):
            _compare_eval(job, acc, lk, lr, precision)
        del keep, plain

    # determinism: job 0's micro-window twice, on its own row and on a
    # twin made from that row, its pool and its rng, in one call under
    # deterministic algorithms; the two rows must end equal bit for bit
    t0 = time.perf_counter()
    jobs.pop().release()
    bank.compact()
    job = jobs[0]
    twin = RetrainJob(
        engine, Request(stream_id="cam0-twin", t=0.0, loc=(0.0, 0.0),
                        subsamples=job.members[0].subsamples, acc=0.0,
                        train_data=pools[0]),
        micro_steps=TRAIN_MICRO, batch=TRAIN_BATCH,
        init_state_tree=bank.row_device(job._slot.idx))
    twin.rng.bit_generator.state = job.rng.bit_generator.state
    mets = _deterministic(engine.train_micro_many, [job, twin])
    for path, a, b in zip(_row_paths(bank), _bank_row(bank, job._slot.idx),
                          _bank_row(bank, twin._slot.idx)):
        assert torch.equal(a, b), \
            f"leaf {path} differs first between the two runs"
    la, lb = mets[job.job_id]["loss"], mets[twin.job_id]["loss"]
    assert torch.equal(la, lb) and la.numel() == TRAIN_MICRO, (la, lb)
    assert bank._host is None           # no row crossed to the host
    print(f"[train] the same micro-window twice (job 0 and its twin, "
          f"deterministic algorithms on): rows equal bit for bit over "
          f"{len(_row_paths(bank))} leaves, losses "
          f"{[round(x, 5) for x in la.tolist()]}; "
          f"{time.perf_counter() - t0:.1f}s; host mirror never allocated")
    return eval_launches


def train_smoke_families():
    """hymba-1.5b and xlstm-350m at their smoke widths: one
    train_micro_many on the card through the autograd route (ssd_chunked,
    mlstm_chunked), and the same micro-window on the CPU from the same
    state and seed; the step losses finite and within 2e-2."""
    for arch in (HYMBA, XLSTM):
        cfg = smoke_config(arch)
        rng = np.random.default_rng(7)
        data = rng.integers(0, cfg.vocab_size, size=(32, 64))
        state = None
        losses = []
        for dev in (DEV, torch.device("cpu")):
            eng = SharedEngine(cfg, device=dev)
            if state is None:
                state = eng.fresh_state(0)
            job = RetrainJob(
                eng, Request(stream_id="s", t=0.0, loc=(0.0, 0.0),
                             subsamples=data[:8], acc=0.0, train_data=data),
                micro_steps=TRAIN_MICRO, batch=TRAIN_BATCH, seed=0,
                init_state_tree=tree_map(lambda x: x.to(dev), state))
            losses.append(eng.train_micro_many([job])[
                job.job_id]["loss"].cpu())
        card, cpu = losses
        diff = float((card - cpu).abs().max())
        print(f"[train] {arch} smoke micro-window on the card: losses "
              f"{[round(x, 5) for x in card.tolist()]}, on the CPU "
              f"{[round(x, 5) for x in cpu.tolist()]}, max difference "
              f"{diff:.2e}")
        assert torch.isfinite(card).all() and diff <= 2e-2, diff


# ---------------------------------------------------------------------------
# phase 6c: the window loop
# ---------------------------------------------------------------------------
def _reset_window_launches():
    for k in WINDOW_KERNELS:
        k.launches = 0


def _window_launches():
    return {k.__name__: k.launches for k in WINDOW_KERNELS}


def _js_requests(events, members):
    """Grouping requests among `events` (one window's, in order) that met
    one or more jobs: each makes one pairwise_js call when the shortlist
    is on. `members` (job -> set of streams) is carried across windows."""
    n = 0
    for e in events:
        if e["kind"] in ("join", "new"):
            n += any(members.values())
            members.setdefault(e["job"], set()).add(e["stream"])
        elif e["kind"] == "evict":
            members[e["job"]].discard(e["stream"])
    return n


def window_smoke():
    """(a) The four benign goldens' scenario and controller at smoke width
    from the reference's initial weights, fp32 compute (TF32 off), on the
    card (flash_attention on every eval forward) and on the CPU (plain
    kernels): `compare` empty, groups and events equal. Then ecco on the
    card with drift_impl="auto" and a top-2 shortlist: the same trace,
    fleet_drift once a window, pairwise_js once per grouping request that
    met a job."""
    init = {0: load_params_npz(WINDOW_INIT)}
    tcfg = TrainConfig(**WINDOW_FP32)
    engines = [(dev, wtrace.make_engine_for(wtrace.golden_scenario(),
                                            tcfg=tcfg, init_params=init,
                                            device=dev))
               for dev in (DEV, torch.device("cpu"))]
    card_traces = {}
    for fw in wtrace.GOLDEN_FRAMEWORKS:
        secs, traces = [], []
        for dev, eng in engines:
            t0 = time.perf_counter()
            traces.append(wtrace.golden_trace(fw, eng, device=dev))
            secs.append(time.perf_counter() - t0)
        card, cpu = traces
        diffs = wtrace.compare(card, cpu)
        acc_gap = max(abs(a - b) for wc, wp in zip(card["windows"],
                                                   cpu["windows"])
                      for a, b in zip(wc["acc"].values(), wp["acc"].values())
                      if a is not None and b is not None)
        print(f"[window] (a) {fw} fp32, card vs CPU: {len(diffs)} diffs, "
              f"largest accuracy gap {acc_gap!r} (limit {WINDOW_ACC_GAP:g})"
              f"; {secs[0]:.1f}s on the "
              f"card, {secs[1]:.1f}s on the CPU; groups "
              f"{card['windows'][-1]['groups']}")
        assert not diffs, diffs
        # accuracies are kept to 4 digits and one hit moves a stream's by
        # 1/(rows x 31) > 2e-4: a gap under 1e-4 is equal hits
        assert acc_gap <= WINDOW_ACC_GAP, (fw, acc_gap)
        for wc, wp in zip(card["windows"], cpu["windows"]):
            assert wc["groups"] == wp["groups"]
            assert wc["events"] == wp["events"]
        card_traces[fw] = card
    _reset_window_launches()
    auto = wtrace.golden_trace("ecco", engines[0][1], device=DEV,
                               drift_impl="auto", shortlist_k=2)
    got = _window_launches()
    want_js = _js_requests([e for w in auto["windows"] for e in w["events"]],
                           {})
    print(f"[window] (a) ecco with drift_impl=auto, shortlist_k=2 on the "
          f"card: trace {'equal to' if auto == card_traces['ecco'] else 'NOT'}"
          f" the exact path's; fleet_drift launches {got['fleet_drift']} "
          f"(one a window: {len(auto['windows'])}), pairwise_js "
          f"{got['pairwise_js']} (requests that met a job: {want_js})")
    assert auto == card_traces["ecco"]
    assert got["fleet_drift"] == len(auto["windows"]), got
    assert got["pairwise_js"] == want_js > 0, (got, want_js)


def window_goldens():
    """(b) The four benign goldens at their own configuration (the
    engine's default bf16 compute over fp32 masters) on the card, from the
    reference's initial weights: each framework's number of `compare`
    differences against tests/golden/trace_<fw>.json and the first, not
    asserted (the goldens' floats follow the reference's bf16 rounding)."""
    eng = wtrace.make_engine_for(
        wtrace.golden_scenario(),
        init_params={0: load_params_npz(WINDOW_INIT)}, device=DEV)
    out = {}
    for fw in wtrace.GOLDEN_FRAMEWORKS:
        got = wtrace.golden_trace(fw, eng, device=DEV)
        diffs = wtrace.compare(got, wtrace.load_trace(wtrace.golden_path(
            os.path.join(HERE, "tests", "golden"), fw)))
        structural = [d for d in diffs if ".groups" in d or ".events" in d
                      or "count" in d or "meta" in d]
        print(f"[window] (b) {fw} bf16 vs tests/golden/trace_{fw}.json: "
              f"{len(diffs)} diffs ({len(structural)} structural)"
              + (f"; first: {diffs[0]}" if diffs else ""))
        out[fw] = len(diffs)
    return out


def _window_gemm_rate(cfg, shapes, prof):
    """The profiled window's fp32 eval GEMMs: their operations reckoned
    from the eval forwards' shapes (M = rows x S a forward; per layer
    q, k, v, o and SwiGLU's gate, up, down, N x K from the config; the
    tied head d_model x vocab), their launches and device time as the
    profiler read them, and the rate that makes."""
    assert cfg.act == "swiglu", cfg.act
    hd = cfg.head_dim or cfg.d_model // cfg.num_heads
    per_layer = (cfg.d_model * hd * 2 * (cfg.num_heads + cfg.num_kv_heads)
                 + 3 * cfg.d_model * cfg.d_ff)
    tokens = sum(rows * seq for rows, seq in shapes)
    flop = 2 * tokens * (cfg.num_layers * per_layer
                         + cfg.d_model * cfg.vocab_size)
    gemms = sorted((e for e in prof.key_averages()
                    if "gemm" in e.key and "bf16" not in e.key
                    and ("f32" in e.key or "sgemm" in e.key)),
                   key=lambda e: -e.device_time_total)
    ms = sum(e.device_time_total for e in gemms) / 1e3
    n = sum(e.count for e in gemms)
    print(f"[window] (c) profiled window's fp32 GEMM kernels (the evals' "
          f"and any other): {n} launches, {ms:.1f} ms on the device; the "
          f"eval forwards' {7 * cfg.num_layers * len(shapes)} layer GEMMs "
          f"and {len(shapes)} heads over {len(shapes)} forwards "
          f"{dict(collections.Counter(shapes))}, {tokens} tokens, make "
          f"{flop / 1e12:.2f} TFLOP from the shapes: at most "
          f"{flop / ms / 1e9 if ms else float('nan'):.1f} TFLOP/s (the "
          f"data sheet's fp32 peak "
          f"{peaks(torch.cuda.get_device_name(0))[torch.float32] / 1e12:g})")
    for e in gemms:
        print(f"[window]   {e.device_time_total / 1e3:8.1f} ms x{e.count:<5} "
              f"{e.key[:90]}")


def _window_evals_held(engine, ctl):
    """One eval_jobs call over the window loop's live jobs at the loop's
    shapes and precision, every forward through flash_attention held to
    the plain route on the same params and rows: the largest logit
    difference within GAP_LIMIT, every argmax flip where the plain top-1
    leads by at most twice it, and each job's accuracy the one its
    kernel-route logits give (over the vocabulary; the padded columns
    hold -1e30 on both routes)."""
    precision, vocab = ctl.cc.job_precision, engine.cfg.vocab_size
    held, apply = [], engine.model.apply

    def held_apply(params, toks, **kw):
        out = apply(params, toks, **kw)
        plain = apply(params, toks, **dict(kw, kernel_impl="ref"))
        held.append((toks, out[0][:, :-1, :vocab].float(),
                     plain[0][:, :-1, :vocab].float()))
        return out
    engine.model.apply = held_apply
    _reset_window_launches()
    accs = engine.eval_jobs(ctl.jobs)
    launches = flash_attention.launches
    del engine.model.apply              # back to the class's method
    assert len(held) == len(ctl.jobs), (len(held), len(ctl.jobs))
    assert launches == len(held) * engine.cfg.num_layers, launches
    for job, acc, (toks, lk, lr) in zip(ctl.jobs, accs, held):
        labels = toks[:, 1:]
        gap = float((lk - lr).abs().max())
        ak, ap = lk.argmax(-1), lr.argmax(-1)
        diff = ak != ap
        top2 = lr[diff].topk(2, dim=-1).values
        leads = (top2[:, 0] - top2[:, 1]).tolist()
        b = len(job.members[0].subsamples)
        hit = (ak == labels).float().reshape(-1, b * labels.shape[1])
        # eval_jobs averages the members' fp32 accuracies in float64
        mine = float(np.mean(_hit_mean(
            hit[:len(job.members)].sum(1).cpu().numpy(),
            hit.shape[1]).astype(np.float64)))
        print(f"[window] (c) eval_jobs {job.job_id} {precision} "
              f"{tuple(toks.shape)}: accuracy {acc!r} (from the kernel "
              f"route's logits {mine!r}); largest logit difference to the "
              f"plain route {gap:.3e} (limit {GAP_LIMIT[precision]:g}, max "
              f"|plain| {float(lr.abs().max()):.3g}); {int(diff.sum())} "
              f"argmax flips, plain top-1 leads {sorted(leads)[:8]}")
        assert bool(torch.isfinite(lk).all()), job.job_id
        assert gap <= GAP_LIMIT[precision], (gap, precision)
        assert all(x <= 2 * gap for x in leads), leads
        assert mine == acc, (mine, acc)


def window_full_width():
    """(c) olmo-1b at full width (its vocabulary cut to the scenario's 64,
    as make_engine_for does), random weights from seed 0, the engine's
    default bf16 compute over fp32 masters, on the golden drift_wave
    scenario and controller config under ecco with drift_impl="auto", a
    top-2 shortlist, a JobBank of 4 rows and the invariants checked on
    every window. Per window: ms, micro-windows and tokens trained, each
    kernel's launches beside the count reckoned from the eval forwards
    and the grouping requests, groups and events; the last window under
    torch.profiler. Checks: invariants, finite losses, triggers equal to
    an exact host detector's, no host copy of a job's state. Returns the
    three kernels' launches over the run."""
    from torch.profiler import ProfilerActivity, profile

    sc = wtrace.golden_scenario()
    assert not (sc.churn or sc.bandwidth or sc.profile), sc.name
    cfg = dataclasses.replace(get_config(ARCH), vocab_size=sc.bank.vocab)
    torch.cuda.reset_peak_memory_stats()
    engine = SharedEngine(cfg, device=DEV)
    engine.bank = bank = JobBank(engine, capacity=WINDOW_BANK)

    def no_growth(need):
        if need > bank.capacity:
            raise RuntimeError(
                f"the window loop made a job for slot {need}, past the "
                f"bank's {bank.capacity} rows: at full width a grown bank "
                f"does not fit beside training")
    bank._grow_to = no_growth
    shapes, trained = [], []        # each eval forward's (rows, S)
    hits = engine._forward_hits

    def counted_forward(params, toks, precision):
        shapes.append(tuple(toks.shape))
        return hits(params, toks, precision)
    engine._forward_hits = counted_forward
    train = engine.train_micro_many

    def recorded_train(jobs):
        rows = {j.job_id: min(j.batch, len(j.pool)) * (j.pool.seq or 0)
                * j.micro_steps for j in jobs}
        mets = train(jobs)
        trained.extend((rows[jid], m) for jid, m in mets.items())
        return mets
    engine.train_micro_many = recorded_train

    kw = dict(window_seconds=sc.window_seconds,
              shared_bandwidth=sc.shared_bandwidth, local_caps=sc.local_caps)
    kw.update(wtrace.GOLDEN_CONTROLLER, drift_impl="auto", shortlist_k=2)
    ctl = FRAMEWORKS["ecco"](engine, list(sc.streams), ControllerConfig(**kw))
    ctl.warmup()
    exact = FleetDriftDetector(threshold=ctl.cc.drift_threshold,
                               buckets=ctl.cc.sig_buckets,
                               vocab=cfg.vocab_size, device="cpu")
    exact.load_state_dict(ctl.fleet.state_dict())
    observe, triggers = ctl.fleet.observe, []

    def shadowed(ids, toks):
        got = observe(ids, toks)
        triggers.append((got, exact.observe(ids, toks)))
        return got
    ctl.fleet.observe = shadowed
    checker = InvariantChecker(label="full width/ecco")
    members, totals, jobname = {}, dict.fromkeys(_window_launches(), 0), {}
    row = 12 * engine.model.num_params() + 4     # params, mu, nu, count
    print(f"[window] (c) {ARCH} at full width ({engine.model.num_params():,}"
          f" parameters, vocabulary {cfg.vocab_size}), a bank of "
          f"{bank.capacity} rows x {row / 1e9:.2f} GB; naive, ekya and recl make four one-stream jobs, which "
          f"at full width do not fit beside training: they run at smoke "
          f"width only ((a), (b))")
    for w in range(sc.windows):
        _reset_window_launches()
        shapes[:], trained[:] = [], []
        checker.before_window(ctl)
        n_ev = len(ctl.grouper.events)
        last = w == sc.windows - 1
        torch.cuda.synchronize()
        with (profile(activities=[ProfilerActivity.CUDA]) if last
              else contextlib.nullcontext()) as prof:
            t0 = time.perf_counter()
            wm = ctl.run_window()
            torch.cuda.synchronize()
            ms = 1e3 * (time.perf_counter() - t0)
        events = ctl.grouper.events[n_ev:]
        checker.after_window(ctl, wm, events)
        rec = wtrace._window_record(ctl, wm, events, jobname)
        got = _window_launches()
        want = {"flash_attention": len(shapes) * cfg.num_layers,
                "fleet_drift": 1,
                "pairwise_js": _js_requests(rec["events"], members)}
        for k in totals:
            totals[k] += got[k]
        tokens = sum(t for t, _ in trained)
        losses = [x for _, m in trained for x in m["loss"].tolist()]
        print(f"[window] (c) window {w}{' (profiled)' if last else ''}: "
              f"{ms:.1f} ms; {len(trained)} micro-windows, {tokens} tokens "
              f"trained; {len(shapes)} eval forwards "
              f"{dict(collections.Counter(shapes))}; launches {got} "
              f"(reckoned {want}); jobs {len(ctl.jobs)}; groups "
              f"{rec['groups']}; events "
              f"{[(e['kind'], e['stream'], e['job']) for e in rec['events']]}"
              f"; losses {[round(x, 4) for x in losses]}")
        assert got == want, (got, want)
        assert losses and all(math.isfinite(x) for x in losses), losses
    busy, kernels = _device_busy_ms(prof)
    _window_gemm_rate(cfg, shapes, prof)
    if kernels:
        print(f"[window] (c) profiled window: device busy {busy:.1f} ms of "
              f"{ms:.1f} ms, {kernels} kernels, idle share "
              f"{1 - busy / ms:.3f} (an upper bound: the profiler slows the "
              f"host)")
    else:
        print("[window] (c) the profiler saw no device time; idle share "
              "not measured")
    top = sorted(prof.key_averages(), key=lambda e: -e.device_time_total)
    for e in top[:5]:
        print(f"[window]   {e.device_time_total / 1e3:8.1f} ms x{e.count:<5} "
              f"{e.key[:90]}")
    for got, want in triggers:
        assert got == want, (got, want)
    _window_evals_held(engine, ctl)
    assert all(n > 0 for n in totals.values()), totals
    assert bank._host is None           # no job's state crossed to the host
    assert checker.windows_checked == sc.windows
    assert bank.state_row_nbytes == row, (bank.state_row_nbytes, row)
    print(f"[window] (c) peak device memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB beside the "
          f"bank's reckoned {bank.capacity * bank.state_row_nbytes / 1e9:.2f}"
          f" GB; triggers {[sorted(g) for g, _ in triggers]} equal to the "
          f"exact host path's; invariants held on {checker.windows_checked} "
          f"windows; host mirror never allocated")
    return totals


# ---------------------------------------------------------------------------
# phase 7: timing
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


def _device_ms(fn, sets, kernels=None, iters=20, bound_ms=None):
    """Mean device time (ms) of one call of `fn` under torch.profiler (CUDA
    activity only) over `iters` calls: for each CUDA kernel whose name
    holds one of `kernels` (a name or a tuple of names; every kernel the
    calls launched when None), the mean time of its launches, summed over
    the kernels, each of which a call launches once. That is the device
    work alone, without the host's time to launch it, which CUDA events
    around a short call measure instead.

    The profiler on the card has dropped the first launches' records of a
    session, and has read less time than the card could take; so a session
    records only after a warm-up step, and is kept only when it holds every
    launch of each kernel and its sum is not under `bound_ms` (the least
    time the card could take for the call's work, where given). A
    session that is not kept is profiled again, up to three times; after
    that the device time is `_time_ms`'s mean of 50 calls back to back
    between two CUDA events: the device's time with any gaps between the
    calls (an upper bound), printed as such."""
    from torch.profiler import ProfilerActivity, profile, schedule
    if isinstance(kernels, str):
        kernels = (kernels,)
    for i in range(3):
        fn(*sets[i % len(sets)])
    torch.cuda.synchronize()
    for _ in range(3):
        # a warm-up step of `iters` calls that the profiler drops, then the
        # step it records
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1)) as prof:
            for step in range(2):
                if step:
                    prof.step()
                for i in range(iters):
                    fn(*sets[i % len(sets)])
                torch.cuda.synchronize()
        evs = [e for e in prof.key_averages() if e.device_time_total > 0]
        names = kernels or tuple(e.key for e in evs)
        total, parts, why = 0.0, [], None
        for name in names:
            mine = [e for e in evs if name in e.key]
            count = sum(e.count for e in mine)
            if count != iters:
                why = f"{count} of {iters} launches of {name[:60]}"
                break
            part = sum(e.device_time_total for e in mine) / count / 1e3
            parts.append(f"{name[:40]} {part:.4f}")
            total += part
        if why is None and not names:
            why = "no kernel"
        if why is None and bound_ms is not None and total < bound_ms:
            why = f"{total:.4f} ms, under the {bound_ms:.4f} ms bound"
        if why is None:
            break
        print(f"[time] a profiler session kept {why}; profiling again")
    else:
        ms = _time_ms(fn, sets)
        print(f"[time] no profiler session kept; device time from CUDA "
              f"events around 50 calls back to back: {ms:.4f} ms")
        return ms
    if kernels is None:
        print(f"[time]   library kernels: "
              f"{[(e.key[:60], e.count) for e in evs]}")
    elif len(names) > 1:
        print(f"[time]   device ms per kernel: {'; '.join(parts)}")
    return total


def _bound(nbytes, flops, dtype, pk):
    t_bytes = nbytes / pk["bytes"] * 1e3
    t_ops = flops / pk[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _attention_row(shape, sets, sdpa_sets, prefill, nbytes, flops, dtype,
                   pk):
    """Causal attention as serving calls it, by the kernel, the plain
    version and SDPA (the yardstick the port never calls) on the same
    inputs: per call (CUDA events) and on the device (the kernels of the
    path `plan` picks, every kernel SDPA launches). SDPA's causal mask is
    aligned top-left, so a decode row (S = 1, every key visible) calls it
    without one."""
    path = fa_plan(*sets[0]).path

    def kern(q, k, v):
        return flash_attention(q, k, v)

    def lib(q, k, v):
        return F.scaled_dot_product_attention(q, k, v, is_causal=prefill)

    bound = _bound(nbytes, flops, dtype, pk)
    return dict(
        shape=f"{shape} [{path}]", path=path,
        ms=_time_ms(kern, sets),
        device_ms=_device_ms(kern, sets, FA_KERNELS[path],
                             bound_ms=bound[0]),
        plain_ms=_time_ms(attention_ref, sets),
        library_ms=_time_ms(lib, sdpa_sets),
        library_device_ms=_device_ms(lib, sdpa_sets, bound_ms=bound[0]),
        bound=bound)


def time_attention(pk):
    """flash_attention at the four bf16 serving shapes (olmo and hymba,
    prefill and decode) and the two fp32 ones (olmo prefill in fp32, and
    fp32 q over olmo's bf16 cache), rotating 6-8 input sets so that L2
    does not hold them. SDPA gets q, k, v in its (B, H, S, hd) layout,
    hymba's k, v repeated to 25 heads and, for fp32 q, the bf16 cache
    widened to fp32, all beforehand. Bytes: q, k, v read once, o written
    once; operations: QK^T and PV over the visible (query, key) pairs."""
    bf16, f32 = torch.bfloat16, torch.float32
    gen = torch.Generator(device=DEV).manual_seed(2)
    rows = {}

    def sdpa(sets_, G=1, dtype=None):
        return [tuple(t.repeat_interleave(G if i else 1, 2).transpose(1, 2)
                      .to(dtype or t.dtype).contiguous()
                      for i, t in enumerate(s)) for s in sets_]

    def prefill(name, S, H, K, hd, dtype):
        sets = [(_randn((1, S, H, hd), dtype, gen),
                 _randn((1, S, K, hd), dtype, gen),
                 _randn((1, S, K, hd), dtype, gen)) for _ in range(8)]
        el = sets[0][0].element_size()
        pairs = S * (S + 1) // 2                  # visible (query, key)
        rows[name] = _attention_row(
            f"q (1,{S},{H},{hd}), k,v (1,{S},{K},{hd}) {str(dtype)[6:]} "
            f"causal", sets, sdpa(sets, H // K), True,
            2 * S * (H + K) * hd * el, 4 * H * pairs * hd, dtype, pk)

    def decode(name, T, cap, H, K, hd, qdt):
        caches = [(_randn((SLOTS, 1, H, hd), qdt, gen),
                   _randn((SLOTS, cap, K, hd), bf16, gen),
                   _randn((SLOTS, cap, K, hd), bf16, gen)) for _ in range(6)]
        sets = [(q, k[:, :T], v[:, :T]) for q, k, v in caches]
        el = torch.finfo(qdt).bits // 8
        rows[name] = _attention_row(
            f"q ({SLOTS},1,{H},{hd}) {str(qdt)[6:]} over bf16 k,v prefix "
            f"({SLOTS},{T}/{cap},{K},{hd})", sets, sdpa(sets, H // K, qdt),
            False, 2 * SLOTS * H * hd * el + 2 * SLOTS * T * K * hd * 2,
            4 * SLOTS * H * T * hd, qdt, pk)

    prefill("prefill", PROMPT, 16, 16, 128, bf16)
    decode("decode", DECODE_T, CAP, 16, 16, 128, bf16)
    prefill("hymba_prefill", HY_S, 25, 5, 64, bf16)
    decode("hymba_decode", HY_DECODE_T, HY_CAP, 25, 5, 64, bf16)
    prefill("prefill_fp32", PROMPT, 16, 16, 128, f32)
    decode("decode_fp32_q", DECODE_T, CAP, 16, 16, 128, f32)
    for name, r in rows.items():
        _print_time(f"flash_attention {name}", r)
    return rows


def sweep_attention_plans():
    """The device time of other plans than `plan`'s at the four bf16
    serving shapes, each held to the plain version first: the prefill with
    one and two kv groups per block, the decode with splits of 1, 2, 3, 4
    and 6 tiles. It is the measurement behind `plan`'s rules."""
    bf16 = torch.bfloat16
    gen = torch.Generator(device=DEV).manual_seed(11)
    shapes = {"olmo prefill": (1, PROMPT, PROMPT, 16, 16, 128, None),
              "hymba prefill": (1, HY_S, HY_S, 25, 5, 64, None),
              "olmo decode": (SLOTS, 1, DECODE_T, 16, 16, 128, CAP),
              "hymba decode": (SLOTS, 1, HY_DECODE_T, 25, 5, 64, HY_CAP)}
    for name, (B, S, T, H, K, hd, cap) in shapes.items():
        sets = []
        for _ in range(6):
            q = _randn((B, S, H, hd), bf16, gen)
            k, v = (_randn((B, cap or T, K, hd), bf16, gen)
                    for _ in range(2))
            sets.append((q, k[:, :T], v[:, :T]))
        chosen = fa_plan(*sets[0])
        if chosen.path == "prefill":
            variants = [chosen._replace(groups=g) for g in (1, 2)]
        else:
            variants = []
            for tiles in (1, 2, 3, 4, 6):
                split = tiles * FA_TILE
                splits = math.ceil(T / split)
                variants.append(chosen._replace(
                    split=split, splits=splits, grid=splits * K * B))
        want = attention_ref(*sets[0])
        for pl in variants:
            def call(q, k, v, pl=pl):
                return fa_launch_plan(q, k, v, True, 0, pl)
            tag = (f"flash_attention {name}: groups {pl.groups}, split "
                   f"{pl.split}, splits {pl.splits}, grid {pl.grid}")
            _check(f"sweep {tag}", call(*sets[0]), want, TOL[bf16])
            ms = _device_ms(call, sets, FA_KERNELS[pl.path], iters=40)
            mark = " (plan's choice)" if pl == chosen else ""
            print(f"[sweep] {tag}: {ms:.4f} ms on the device{mark}")


def ssd_cost(B, S, H, P, N, Q):
    """(bytes, operations) the SSD scan must move and do at these shapes in
    bf16 with the state out: x, dt, B, C, A, D read once, y and the fp32
    state written once; per chunk of Q steps C_i . B_j over the causal
    triangle T = Q (Q + 1) / 2 once (the heads share B and C), and per head
    W x over the triangle, C . state and the state update (Q N P
    multiply-adds each): 2 nc (T N + H (T P + 2 Q N P)), an exponential
    counted as nothing."""
    nc, T = -(-S // Q), Q * (Q + 1) // 2
    nbytes = (2 * B * S * H * P * 2 + 4 * B * S * H + 2 * B * S * N * 2
              + 8 * H + 4 * B * H * P * N)
    return nbytes, 2 * B * nc * (T * N + H * (T * P + 2 * Q * N * P))


def time_ssd(pk):
    """ssd_scan at hymba's prefill shape, bf16, apply_mamba's chunk, final
    state out, rotating 10 input sets (77 MB of x, past L2); the device
    time sums the tensor-core path's three kernels, each printed. Bounds
    from `ssd_cost` by the units the kernel uses: its products on bf16
    tensor cores (the share), and beside it the fp32 CUDA-core bound that
    the CUDA-core kernel is held to."""
    bf16 = torch.bfloat16
    gen = torch.Generator(device=DEV).manual_seed(7)
    B, S, H, P, N = 1, HY_S, 50, 64, 16
    Q = SSD_CHUNK
    sets = [_ssd_inputs(B, S, H, P, N, bf16, gen) for _ in range(10)]
    assert ssd_plan(sets[0][0], sets[0][3], sets[0][4], Q) == SSD_TENSOR_CORE
    nbytes, flops = ssd_cost(B, S, H, P, N, Q)
    bound = _bound(nbytes, flops, bf16, pk)

    def kern(*a):
        return ssd_scan(*a, chunk=Q, return_state=True)

    def plain(*a):
        return ssd_chunked(*a, chunk=Q, return_state=True)

    r = dict(shape=f"x ({B},{S},{H},{P}) bf16, N {N}, chunk {Q}, state out",
             ms=_time_ms(kern, sets),
             device_ms=_device_ms(kern, sets, SSD_TC_KERNELS,
                                  bound_ms=bound[0]),
             plain_ms=_time_ms(plain, sets, iters=10),
             library_ms=None,
             bound=bound,
             bound_cuda_core=_bound(nbytes, flops, torch.float32, pk))
    bcc, bycc = r["bound_cuda_core"]
    print(f"[time] ssd_scan least work: {nbytes / 1e6:.2f} MB, "
          f"{flops / 1e6:.1f} MFLOP; bound on bf16 tensor cores "
          f"{r['bound'][0]:.4f} ms ({r['bound'][1]}), on fp32 CUDA cores "
          f"{bcc:.4f} ms ({bycc}, kernel at {100 * bcc / r['device_ms']:.1f}% "
          f"of it)")
    _print_time("ssd_scan", r)
    return r


def time_fleet_drift(pk, windows, refs):
    """fleet_drift at the drift plane's shape, rotating over its windows
    (each 102 MB of tokens, past L2). Bytes: tokens and reference read,
    hists and scores written, 4NT + 8NB + 4N. Operations: one bucket
    increment per token and about 12 per (row, bucket) for the two
    normalisations and the two KL terms (each log counted as one)."""
    N, T = windows[0].shape
    B = refs.shape[1]
    sets = [(w, refs) for w in windows]
    bound = _bound(4 * N * T + 8 * N * B + 4 * N, N * T + 12 * N * B,
                   torch.float32, pk)

    def kern(t, r):
        return fleet_drift(t, r, buckets=B, vocab=DRIFT_VOCAB)

    def plain(t, r):
        return fleet_drift_ref(t, r, buckets=B, vocab=DRIFT_VOCAB)

    r = dict(shape=f"tokens ({N},{T}) int32, ref ({N},{B}) fp32, vocab "
                   f"{DRIFT_VOCAB}",
             ms=_time_ms(kern, sets),
             device_ms=_device_ms(kern, sets, "fleet_drift_kernel",
                                  bound_ms=bound[0]),
             plain_ms=_time_ms(plain, sets, iters=10),
             library_ms=None,
             bound=bound)
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
        bound = _bound(4 * (N * B + M * B + N * M), 5 * N * M * B,
                       torch.float32, pk)
        rows[N] = dict(
            shape=f"p ({N},{B}), q ({M},{B}) fp32",
            ms=_time_ms(pairwise_js, sets),
            device_ms=_device_ms(pairwise_js, sets, "pairwise_js_kernel",
                                 bound_ms=bound[0]),
            plain_ms=_time_ms(pairwise_js_ref, sets, iters=10),
            library_ms=None,
            bound=bound)
        _print_time("pairwise_js", rows[N])
    return rows


def mlstm_cost(B, S, H, P, Q):
    """(bytes, operations) the mLSTM scan must move and do at these
    shapes in bf16 with the state out: q, k, v and the two gates read
    once, h and the fp32 state (C, n, m) written once; per chunk of L
    steps and head, the causal q k^T and w v triangles (L (L + 1) / 2 P
    multiply-adds each), q C^T and the state update (L P^2 each), q . n
    and the normaliser update (L P each), an exponential counted as
    nothing."""
    nbytes = 2 * (4 * B * S * H * P + 2 * B * S * H) + 4 * B * H * (
        P * P + P + 1)
    macs = 0
    for t0 in range(0, S, Q):
        L = min(Q, S - t0)
        macs += L * (L + 1) * P + 2 * L * P * P + 2 * L * P
    return nbytes, 2 * B * H * macs


def time_mlstm(pk):
    """mlstm_scan at xlstm-350m's prefill shape, bf16, apply_mlstm_block's
    chunk, state out, rotating 10 input sets (126 MB of q, k and v, past
    L2); the device time sums the tensor-core path's four kernels. Bounds
    from `mlstm_cost` by the units the kernel uses: its products on bf16
    tensor cores (the share), and beside it the fp32 CUDA-core bound that
    PR 14's kernel was held to."""
    bf16 = torch.bfloat16
    gen = torch.Generator(device=DEV).manual_seed(10)
    B, S, H, P, Q = 1, XL_PROMPT, XL_HEADS, XL_P, MLSTM_CHUNK
    sets = [_mlstm_inputs(B, S, H, P, bf16, gen) for _ in range(10)]
    assert ml_plan(*sets[0][:3], Q) == ML_TENSOR_CORE
    nbytes, flops = mlstm_cost(B, S, H, P, Q)
    bound = _bound(nbytes, flops, bf16, pk)

    def kern(*a):
        return mlstm_scan(*a, chunk=Q, return_state=True)

    def plain(*a):
        return mlstm_chunked(*a, chunk=Q, return_state=True)

    r = dict(shape=f"q,k,v ({B},{S},{H},{P}) bf16, chunk {Q}, state out",
             ms=_time_ms(kern, sets),
             device_ms=_device_ms(kern, sets, ML_TC_KERNELS,
                                  bound_ms=bound[0]),
             plain_ms=_time_ms(plain, sets, iters=10),
             library_ms=None,
             bound=bound,
             bound_cuda_core=_bound(nbytes, flops, torch.float32, pk))
    bcc, bycc = r["bound_cuda_core"]
    print(f"[time] mlstm_scan least work: {nbytes / 1e6:.2f} MB, "
          f"{flops / 1e9:.3f} GFLOP; bound on bf16 tensor cores "
          f"{r['bound'][0]:.4f} ms ({r['bound'][1]}), on fp32 CUDA cores "
          f"{bcc:.4f} ms ({bycc}, kernel at {100 * bcc / r['device_ms']:.1f}% "
          f"of it)")
    _print_time("mlstm_scan", r)
    return r


def _print_time(name, r):
    bms, by = r["bound"]
    lib = "none" if r["library_ms"] is None else f"{r['library_ms']:.4f} ms"
    if r.get("library_device_ms") is not None:
        lib += (f" ({r['library_device_ms']:.4f} ms on the device; kernel "
                f"{r['device_ms'] / r['library_device_ms']:.2f}x of it)")
    print(f"[time] {name} {r['shape']}: kernel {r['ms']:.4f} ms per call "
          f"({r['device_ms']:.4f} ms on the device) | plain "
          f"{r['plain_ms']:.4f} ms | library {lib} | bound {bms:.4f} ms "
          f"({by}) | kernel at {100 * bms / r['device_ms']:.1f}% of bound")


def _timing_keys(r):
    bms, by = r["bound"]
    # no time under the least the card could take (_device_ms keeps none)
    assert r["device_ms"] >= bms and r["ms"] >= bms, r
    keys = {"ms": r["ms"], "device_ms": r["device_ms"],
            "plain_ms": r["plain_ms"], "bound_ms": bms, "bound_by": by,
            "library_ms": r["library_ms"]}
    if "library_device_ms" in r:
        keys["library_device_ms"] = r["library_device_ms"]
    return keys


def _entry(name, source, replaces, launches, err, row, **extra):
    entry = {"name": name, "route": "cuda",
             "source": f"src/repro_torch/csrc/{source}",
             "replaces": replaces, "launches": launches,
             "max_abs_err": err, **_timing_keys(row), "shape": row["shape"]}
    for key, sub in extra.items():
        entry[key] = dict(_timing_keys(sub), shape=sub["shape"])
    return entry


def phase(name, fn, *args):
    t0 = time.perf_counter()
    out = fn(*args)
    print(f"[phase] {name}: {time.perf_counter() - t0:.1f}s")
    return out


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

    phase("build", build_all)
    hmma = phase("tensor-core report", tensor_core_report)
    cap = index_capacity(JOINERS)
    err = {"flash_attention": phase("check flash_attention",
                                    check_attention)}
    err["ssd_scan"] = phase("check ssd_scan", check_ssd)
    err["mlstm_scan"] = phase("check mlstm_scan", check_mlstm)
    err["fleet_drift"] = phase("check fleet_drift", check_fleet_drift)
    err["pairwise_js"] = phase("check pairwise_js", check_pairwise_js, cap)
    launches = phase(f"serve {ARCH}", serve_full_width, ARCH)
    phase(f"profile {ARCH}", profile_serving, ARCH)
    phase(f"logits {ARCH}", compare_logits, ARCH)
    hymba = phase(f"serve {HYMBA}", serve_full_width, HYMBA)
    launches["ssd_scan"] = hymba["ssd_scan"]
    phase(f"profile {HYMBA}", profile_serving, HYMBA)
    phase(f"logits {HYMBA}", compare_logits, HYMBA)
    # the same weights in fp32: how much of the bf16 difference is rounding
    phase(f"logits {HYMBA} fp32", compare_logits, HYMBA, torch.float32)
    xl = phase(f"serve {XLSTM}", serve_full_width, XLSTM)
    # 12 mLSTM blocks, each through the kernel once per prefill
    assert xl == {"flash_attention": 0, "flash_attention_combine": 0,
                  "ssd_scan": 0, "mlstm_scan": 12 * REQUESTS}, xl
    launches["mlstm_scan"] = xl["mlstm_scan"]
    phase(f"logits {XLSTM}", compare_logits, XLSTM)
    phase(f"logits {XLSTM} fp32", compare_logits, XLSTM, torch.float32)
    torch.cuda.empty_cache()
    launches["fleet_drift"], split, windows, refs = phase("drift plane",
                                                          drift_plane)
    storm = phase("grouping storm", grouping_storm)
    launches["pairwise_js"] = storm["launches"]
    assert storm["capacity"] == cap, (storm["capacity"], cap)
    torch.cuda.empty_cache()
    train_eval = phase(f"train {ARCH}", train_full_width)
    torch.cuda.empty_cache()
    phase("train smoke families", train_smoke_families)
    torch.cuda.empty_cache()
    phase("window smoke", window_smoke)
    phase("window goldens", window_goldens)
    torch.cuda.empty_cache()
    window = phase(f"window {ARCH}", window_full_width)
    torch.cuda.empty_cache()
    att = phase("time flash_attention", time_attention, pk)
    phase("sweep flash_attention plans", sweep_attention_plans)
    fd = phase("time fleet_drift", time_fleet_drift, pk, windows, refs)
    pj = phase("time pairwise_js", time_pairwise_js, pk, cap)
    ssd = phase("time ssd_scan", time_ssd, pk)
    ml = phase("time mlstm_scan", time_mlstm, pk)
    # the profiler's last user: the trace of an xlstm prefill holds some
    # 220,000 kernel records, and profiled timings after it on the card
    # saw no kernel records at all
    phase(f"profile {XLSTM}", profile_serving, XLSTM)
    print(f"[drift] kernel share of one observe at {DRIFT_N} streams: "
          f"{100 * fd['ms'] / split['total']:.2f}%")
    print(f"[group] kernel share of one grouping request: "
          f"{100 * pj[1]['ms'] / storm['ms']:.2f}% ({pj[1]['ms']:.4f} of "
          f"{storm['ms']:.3f} ms)")

    src = {name: (source, replaces) for name, source, replaces in KERNELS}
    kernels = [
        dict(_entry("flash_attention", *src["flash_attention"],
                    launches["flash_attention"], err["flash_attention"],
                    att["prefill"], decode=att["decode"],
                    hymba_prefill=att["hymba_prefill"],
                    hymba_decode=att["hymba_decode"],
                    prefill_fp32=att["prefill_fp32"],
                    decode_fp32_q=att["decode_fp32_q"]),
             combine_launches=launches["flash_attention_combine"],
             hymba_launches=hymba["flash_attention"],
             hymba_combine_launches=hymba["flash_attention_combine"],
             train_eval_launches=train_eval,
             window_launches=window["flash_attention"],
             tensor_core_hmma=hmma),
        dict(_entry("fleet_drift", *src["fleet_drift"],
                    launches["fleet_drift"], err["fleet_drift"], fd),
             window_launches=window["fleet_drift"]),
        dict(_entry("pairwise_js", *src["pairwise_js"],
                    launches["pairwise_js"], err["pairwise_js"], pj[1],
                    requests_32=pj[32]),
             storm_full_uploads=storm["full_uploads"],
             storm_rows_uploaded=storm["rows_uploaded"],
             window_launches=window["pairwise_js"]),
        dict(_entry("ssd_scan", *src["ssd_scan"], launches["ssd_scan"],
                    err["ssd_scan"], ssd),
             bound_cuda_core_ms=ssd["bound_cuda_core"][0]),
        dict(_entry("mlstm_scan", *src["mlstm_scan"], launches["mlstm_scan"],
                    err["mlstm_scan"], ml),
             bound_cuda_core_ms=ml["bound_cuda_core"][0]),
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
