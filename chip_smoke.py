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
   strided prefix of a (4, 1184, 5, 64) cache), the training plane's
   eval forward (64, 256, 16, 16, 128) causal in fp32 and bf16, a decode
   of 128 splits (MQA over 8192 keys), and the fleet tick's decode with
   per-lane `lengths` over the whole pool (olmo's (32, 1024, 16, 128) and
   hymba's (32, 1184, 5, 64) bf16 caches with lengths 1..capacity on the
   split-KV decode, fp32 q over olmo's on the CUDA-core kernel, and four
   lanes whose splits lie past their lengths, lanes of length 0
   included); for ssd_scan the six
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
   `repro_torch.launch.serve.main` (8 requests, xlstm 4, in 4 slots, 32
   new tokens, random weights from seed 0; olmo 512-token prompts, hymba and xlstm
   1024-token prompts, so with its 128 meta tokens hymba's windowed
   layers' ring has wrapped at prefill). Launch counters are set to 0 just
   before each run and read just after: every global-attention layer must
   have gone through flash_attention once per prefill and once per decode
   call, every hymba layer's Mamba heads through ssd_scan once per
   prefill, and every xlstm mLSTM block through mlstm_scan once per
   prefill (12 x 4 = 48). Then for each a short torch.profiler window over
   one prefill and a few decode ticks (xlstm's slots filled from 64-token
   prompts: its recurrent tick costs the same at any position): device
   busy share and the kernels
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
   asserted, with cuBLAS's reduced-precision bf16 reductions on and off;
   the first float of ecco's window 0 that parts card vs CPU; the CPU's
   instruction set and the torch and jax versions. (c) olmo-1b at full width (its vocabulary cut to the
   scenario's 64), random weights, bf16 compute, ecco with the kernel
   routes, a JobBank of 4 rows, invariants on: ms, micro-windows and
   tokens trained per window, each kernel's launches against the count
   reckoned from the eval forwards and the grouping requests, the last
   window profiled, peak memory beside the bank's bytes; losses finite,
   triggers equal to an exact host detector's, no host copy of a job's
   state.
6d. The fleet serving plane (`repro_torch.serve.plane`). (a) olmo-1b at
   its published config, random weights: three groups seeded from seeds
   0-2 (4 fp32 store rows, 18.8 GB, and their bf16 copy), a seed-3
   candidate through the gate on an (8, 256) sample that the first
   group's model continued, then 48 queries (16
   a group, prompts of 512 and 384 tokens in turn) through 32 slots of
   1024 positions, 32 new tokens. Counters set to 0 just before the pump
   and read just after: 16 flash_attention launches and 16 combines per
   tick, 16 launches per batched prefill. ms per tick (median, p99),
   lanes per tick, tokens/s, the gate's decision, peak memory beside the
   store's bytes, one profiled tick (busy, idle share, kernels); one lane
   per group held to a solo `ServeLoop` decode of its row where the solo
   top-1 leads by more than FLEET_LEAD. (b) At smoke width: ecco's window
   loop with `serve` on from the reference's initial weights in fp32, on
   the card and on the CPU, and on the card with `serve` off: decisions
   equal across the three, serve reports but their clock readings equal
   card vs CPU; hymba and xlstm through the fleet step card vs CPU (fp32
   logits within FLEET_SMOKE_TOL, bf16 tokens where the CPU's top-1
   leads); `launch.serve --fleet` and `examples.serve_continuous` on the
   card.
6f. The rest of the model registry (`[families]`, after 6d; garbage
   collected until nothing is freed first). (a) qwen2-moe-a2.7b at its
   published config (24 layers, 60 experts top-4 and 4 shared, 14.32 B
   parameters, 57.3 GB in fp32) through `repro_torch.launch.serve.main`
   with olmo-1b's serving arguments: launches 24 per prefill and per
   decode call, combines 24 per decode call, ms per prefill and tick,
   tokens/s, peak memory beside the 57.3 GB; then prefill last-token
   logits kernel vs plain route within LOGIT_TOL, with the (token, k)
   routes that differ between the routes counted per layer. (b)
   llama3-8b, starcoder2-3b and stablelm-3b at their published configs
   the same way, 2 requests in 2 slots, 8 new tokens. (c) hubert-xlarge's
   encode step on (4, 1024, 1280) frames: 48 non-causal flash_attention
   launches, ms per encode, logits kernel vs plain. (d) qwen3-moe-30b-a3b
   and chameleon-34b at smoke width card vs CPU (their fp32 parameters do
   not fit one card), and the fleet decode step of a qwen2-moe smoke
   student card vs CPU. `check_attention` also holds head_dim 80 (prefill
   causal and non-causal, hubert's encode, split-KV decode) and GQA
   groups 4 / 8 / 12 (prefill and split-KV decode); `[time]` adds
   qwen2-moe's prefill and decode (olmo-1b's shapes) and hubert's encode.
6e. Roofline-metered windows, run between 6c and 6d (`[meter]`;
   `repro_torch.launch.roofline` and the controller's metering). (a) The
   golden scenario under ecco at
   smoke width with the zoo-big / zoo-small tiers of
   benchmarks/bench_heterogeneity.py, bf16 screens with an fp32 rescore
   margin, a budget that puts the first job on zoo-big and later ones
   on zoo-small, priced with the tests' fixed-seconds table and with the
   H100 CostTable, card vs CPU: groups, events, tiers and the roofline
   reports equal, the bf16 screens' accuracies within 0.01. (b) olmo-1b at its published config (vocabulary 64)
   with xlstm-350m at its published config as the zoo tier, bf16
   screens, the H100 CostTable, 3 windows: per window the modeled
   ledger beside the measured ms, micro-windows and tokens trained, the
   tiers, the fp32 rescores, launches of flash_attention (olmo's evals),
   mlstm_scan (xlstm's), fleet_drift and pairwise_js equal to their
   reckoning, peak memory beside the banks' bytes; beside (c)'s
   unmetered fp32 windows; each tier's eval forwards held to the plain
   route once, in the first window it has live jobs. (c) `repro_torch.launch.train.main` on the
   card at smoke scale for 2 windows.
6g. The fleet planes under a device mesh (`[mesh]`, after 6f;
   `repro_torch.launch.mesh`, `distributed/`). (a) On a 4-entry fleet mesh
   whose entries are all this card: fleet_drift at 99,999 streams x 256
   tokens (64 buckets, vocab 64) and pairwise_js (32, 16,383) with the
   requests' rows and with the fleet's rows sharded; each call launches
   its kernel once per block (4), is bit-identical to the unsharded call
   and within the checks' tolerances of the plain version; ms per call
   beside the unsharded call's. (b) olmo-1b at full width (vocabulary 64),
   fp32, two windows of ecco with the kernel routes unsharded and on a
   2-entry mesh (the 4-row bank in 2 blocks): decisions and floats equal,
   fleet_drift and pairwise_js launched once per block where the
   unsharded run launches once, flash_attention as often. (c) The elastic
   recovery at smoke width: ecco on 4 entries loses 2 in its second
   window and re-runs it on 2; the history equals the card's unsharded
   run that never failed exactly and the CPU's in decisions (accuracies
   and shares within WINDOW_ACC_GAP). (d) One full-width olmo-1b job
   state (14.12 GB) saved from its bank row, the row zeroed, restored
   through the bank: bit for bit; GB, save and restore seconds.
6h. Distribution's model half on one card (`[model_mesh]`, after 6g;
   meshes of repeated entries of this card). (a) qwen2-moe-a2.7b at its
   published config, bf16, built with its 60 experts split over a (data
   1, model 4) mesh, 15 an entry, `moe_impl="ep"`: a 512-token prefill
   and 8 decode ticks, kernel route vs plain route at cf 1.25 (prefill
   logits within LOGIT_TOL; keep masks and slots equal on every dispatch
   whose routes agree, the rest counted), flash_attention launches held
   to the reckoning; at a cf that drops nothing EP vs the dense dispatch
   within LOGIT_TOL; ms per prefill and tick EP beside dense, peak memory
   beside 57.3 GB. (b) xlstm-350m, fp32, the prefill of 1024 tokens with
   `ssm_impl="seqpar"` on (model 4) vs unsharded: logits and every cache
   leaf within 1e-4 relative (C and n in the invariant frame), 8 decode
   ticks' top-1 equal where it leads by more than 1e-2, 96 mlstm_scan
   launches (12 layers x 4 entries x 2 passes). (c) The seeded
   mlstm_scan at (1, 256 and 200, 4, 512), bf16 and fp32, from a real
   state, vs `mlstm_recurrent(init_state=...)`; no state and the zero
   state bit for bit equal. (d) starcoder2-3b at tp 16 (32 q heads over 2
   kv heads, GQA group 16): prefill logits kernel vs plain, the padded
   heads masked to zero. (e) `pod_mean_compressed` over 2 pod entries on
   olmo-1b's gradient shapes: equal to the CPU's bit for bit, GB/s.
6i. The last modules. `[families]` (e), after `[families]`:
   qwen3-moe-30b-a3b and chameleon-34b at their published configs
   through `launch.serve.main`, initialised straight in bf16 a layer at
   a time (61.1 and 68.6 GB), 2 requests in 2 slots, 512-token prompts,
   8 new tokens; flash_attention's launches held to 48 x (prefills +
   decode calls) and the combines, the init's seconds, peak memory, the
   prefill logits kernel vs plain within LOGIT_TOL and qwen3's route
   flips per layer; each model freed before the next. `[remat]`:
   olmo-1b at full width, one train step's forward and backward at
   batch 8 x 256 under remat none / dots / full: loss and gradients equal
   to none's bit for bit (deterministic algorithms), ms per step, peak
   memory, full's under none's. `[dryrun]`: the dry run of every
   (arch, shape) cell on the single mesh, a CPU process per arch (one
   thread each, CUDA hidden, as many at once as the host has cores but
   one, the card idle meanwhile): each cell's status, flops per device,
   dominant term, bound, memory and seconds, the skip cells the
   reference's; then olmo-1b prefill_32k at batch 1 on the card (16
   flash_attention launches): the dry run's FLOPs less its plain
   attention held to the card run's count, the bound on the card's work
   (attention over the causal keys) and the dry run's own bound against
   the measured ms, its memory estimate against the peak.
7. Time each kernel, its plain version and one PyTorch library call
   computing the same function (a yardstick the port never calls) at the
   serving shapes, with CUDA events after warm-up, rotating input buffers
   so that L2 does not hold them; print each beside the kernel's bound
   from its bytes and operations and the data-sheet peaks of the card
   (mlstm_scan and ssd_scan: on bf16 tensor cores, and on fp32 CUDA cores
   beside it, with each of their kernels' device time; flash_attention
   also at the fleet tick's ragged lengths, whose bound counts the keys
   the lanes' lengths hold). Then the alternatives that `[sweep]`
   measures: flash_attention's plans.
8. One `{"kernels": [...]}` JSON line (flash_attention's entry also
   counts the training phase's eval launches, the full-width fleet
   pump's as `fleet_launches` and `fleet_combine_launches`;
   flash_attention's, fleet_drift's and pairwise_js's the full-width
   window loop's as `window_launches`, and with mlstm_scan's the
   full-width metered windows' as `meter_launches`; flash_attention's
   also `[families]`' as `families_launches` and
   `families_combine_launches`, and its qwen2-moe and hubert time rows;
   flash_attention's, fleet_drift's and pairwise_js's `[mesh]` (b) and
   (c) launches as `mesh_launches`, and fleet_drift's and pairwise_js's
   (a) calls as `mesh_call` / `mesh_call_rows` / `mesh_call_cols`;
   flash_attention's `[model_mesh]` (a) and (d) launches and mlstm_scan's
   (b) as `model_mesh_launches`, flash_attention's GQA-16 and window-eval
   time rows, mlstm_scan's seeded and metered-eval rows; flash_attention's
   `[families]` (e) launches as `families_large_launches` and
   `families_large_combine_launches` and the `[dryrun]` card cell's as
   `dryrun_cell_launches`),
   the nvidia-smi line
   again,
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
import gc
import itertools
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

from repro_torch.configs import SHAPES, get_config, smoke_config  # noqa: E402
from repro_torch.configs.base import TrainConfig  # noqa: E402
from repro_torch.core import trainer as _trainer  # noqa: E402
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
from repro_torch.data.streams import (DomainBank, Region,  # noqa: E402
                                      make_fleet)
from repro_torch.examples import serve_continuous  # noqa: E402
from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.kernels.flash_attention import SOURCE as FA_SOURCE  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    TILE as FA_TILE, _flash as fa_launch_plan, flash_attention,
    kernel_attributes as fa_attributes, plan as fa_plan)
from repro_torch.kernels.fleet_drift import SOURCE as FD_SOURCE  # noqa: E402
from repro_torch.kernels.fleet_drift import fleet_drift  # noqa: E402
from repro_torch.kernels.mlstm_scan import SOURCE as ML_SOURCE  # noqa: E402
from repro_torch.kernels.mlstm_scan import (  # noqa: E402
    CUDA_CORE as ML_CUDA_CORE, TENSOR_CORE as ML_TENSOR_CORE, mlstm_scan,
    plan as ml_plan)
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
from repro_torch.distributed.sharding import mesh_rules  # noqa: E402
from repro_torch.launch import dryrun as dry  # noqa: E402
from repro_torch.launch import roofline as RL  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch.mesh import make_fleet_mesh, make_mesh  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models.convert import load_params_npz  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.models.param import tree_leaves, tree_map  # noqa: E402
from repro_torch.models.transformer import layer_plan  # noqa: E402
from repro_torch.models.xlstm import slstm_scan  # noqa: E402
from repro_torch.serve.kvcache import ServeLoop  # noqa: E402
from repro_torch.serve.plane import (TIMING_KEYS as SERVE_TIMING,  # noqa: E402
                                     FleetServePlane, ServeConfig)
from repro_torch.serve.serve_step import fleet_decode_logits  # noqa: E402
from repro_torch.testing import trace as wtrace  # noqa: E402
from repro_torch.testing.invariants import InvariantChecker  # noqa: E402
from repro_torch.train.train_step import (grad_and_value,  # noqa: E402
                                          make_loss_fn)

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
# xlstm-350m serves one wave (its plain sLSTM prefill takes about 3.7 s a
# request on the card), and its profiled ticks decode slots filled from
# short prompts: a recurrent decode tick costs the same at any position
XL_REQUESTS, XL_WARM_PROMPT = SLOTS, 64
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

# fleet serving plane ([fleet] (a)): olmo-1b at its published config, three
# group models (seeds 0, 1, 2; the store's 4 fp32 rows hold 18.8 GB) and a
# candidate (seed 3) offered to the first group's gate on an (8, 256)
# sample (224 random tokens a row and the group's own 32-token greedy
# continuation); 32 slots of 1024 positions (16 layers x 2 x 1024 x 2048 x 2 B a
# slot: 4.3 GB of bf16 pool), 32 new tokens; 48 queries, 16 a group, with
# prompts of 512 and 384 tokens in turn, so that lanes sit at two
# positions in a tick and slots recycle. Transcripts are held to solo
# decodes where the solo top-1 leads by more than FLEET_LEAD
FLEET_SLOTS, FLEET_QUERIES, FLEET_PROMPTS = 32, 48, (512, 384)
FLEET_SEEDS, FLEET_CANDIDATE, FLEET_SAMPLE = (0, 1, 2), 3, (8, 256)
FLEET_LEAD = 1e-2
# [fleet] (b): the fleet step at smoke width, card vs CPU: three groups,
# seven lanes in a permuted subset of nine slots at staggered positions
FLEET_ROWS = [0, 1, 2, 1, 0, 2, 1]
FLEET_SMOKE_PROMPTS = [5, 9, 20, 14, 3, 30, 11]
FLEET_SMOKE_SLOTS = [5, 0, 3, 6, 2, 8, 1]
FLEET_SMOKE_CAP, FLEET_SMOKE_TICKS = 48, 3
# fp32 logits, card vs CPU, at smoke width: the kernels' and the plain
# versions' fp32 sums differ in order only
FLEET_SMOKE_TOL = 1e-3

# [families]: (a) qwen2-moe-a2.7b at its published config with olmo-1b's
# serving arguments (14.32 B parameters, 57.3 GB in fp32); (b) the dense
# configs with 2 requests in 2 slots, 8 new tokens, 512-token prompts of
# 1024 positions; (c) hubert-xlarge's encode on (4, 1024, 1280) frames;
# (d) qwen3-moe-30b-a3b and chameleon-34b at smoke width (their fp32
# parameters, 122 and 137 GB, do not fit), card vs CPU
QWEN2 = "qwen2-moe-a2.7b"
FAM_DENSE = ("llama3-8b", "starcoder2-3b", "stablelm-3b")
FAM_SMOKE = ("qwen3-moe-30b-a3b", "chameleon-34b")
FAM_PROMPT, FAM_CAP, FAM_SLOTS, FAM_NEW = 512, 1024, 2, 8
for _arch in (QWEN2,) + FAM_DENSE:
    SERVING[_arch] = dict(prompt=FAM_PROMPT, capacity=FAM_CAP)
HUBERT, HU_FRAMES = "hubert-xlarge", (4, 1024)
QWEN2_FP32_GB = 57.3
# (e): the two configs whose fp32 trees (122.1 and 137.2 GB) do not fit
# one card serve at their published configs in bf16 (61.1 and 68.6 GB),
# initialised straight in bf16 a layer at a time, with llama3-8b's cut
FAM_LARGE = ("qwen3-moe-30b-a3b", "chameleon-34b")
for _arch in FAM_LARGE:
    SERVING[_arch] = dict(prompt=FAM_PROMPT, capacity=FAM_CAP)

# [remat]: olmo-1b at full width, one train step's forward and backward
# at [train]'s batch (8 x 256) under each remat, bf16 compute over fp32
# masters (the default TrainConfig but for remat)
REMATS = ("none", "dots", "full")
# [dryrun]: the port's dry run over the 10 archs x 4 shapes on the single
# (16 x 16) mesh, run on the CPU in a process per arch (one thread each;
# CUDA hidden from them; the slowest archs first), and olmo-1b
# prefill_32k cut to batch 1 run for real; the reference's skip cells:
# every full-attention arch at long_500k, and the encoder's decode
DRYRUN_DIR = os.path.join(HERE, "build", "dryrun_single")
DRYRUN_ORDER = ("qwen2-moe-a2.7b", "qwen3-moe-30b-a3b", "xlstm-350m",
                "hymba-1.5b", "olmo-1b", "chameleon-34b", "hubert-xlarge",
                "llama3-8b", "starcoder2-3b", "stablelm-3b")
DRYRUN_SKIPS = ({(a, "long_500k") for a in (
    "olmo-1b", "stablelm-3b", "llama3-8b", "starcoder2-3b",
    "qwen3-moe-30b-a3b", "qwen2-moe-a2.7b", "hubert-xlarge",
    "chameleon-34b")} | {("hubert-xlarge", "decode_32k")})
DRYRUN_TIMEOUT = 900
DRYRUN_ROWS = 256          # query rows the long prefill's check holds
DRYRUN_FLOPS_RTOL = 0.05   # the card cell's count: tests/test_torch_roofline
DRYRUN_Q_SCALE = 4.0       # the long prefill's check: scores ~ N(0, 16)

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
WINDOW_MS = []              # (c)'s windows, for [meter]'s comparison


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
    loop's (fp32; the metered window's bf16 screens and fp32 rescores).
    Returns the largest error at those shapes."""
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
             "S > T: rows without keys are 0"),
            (2, 1, 8256, 8192, 8, 1, 128, 0, None,
             "MQA over 8192 keys: 128 splits in the combine")]:
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
    # the window loop's evals: up to 8 members flattened into one forward
    # of the scenario's 32 tokens, 16 or 8 rows a member, fp32 on the
    # CUDA-core kernel; the metered window's bf16 screens on the
    # tensor-core prefill at those shapes, and its fp32 rescores of one
    # member, 16 or 8 rows, on the CUDA-core kernel
    for rows, dtype in itertools.product((128, 64, 16, 8),
                                         (torch.float32, bf16)):
        path = "cuda_core" if dtype == torch.float32 else "prefill"
        q, k, v = (_randn((rows, 32, 16, 128), dtype, gen)
                   for _ in range(3))
        serving.append(_attn_case(
            f"window eval {str(dtype)[6:]} ({rows},32,16,16,128) causal",
            q, k, v, path))
    serving += check_attention_lengths(gen)
    serving += check_attention_families(gen)
    return max(serving)


def check_attention_families(gen):
    """The new families' shapes ([families]), bf16: head_dim 80
    (stablelm-3b, hubert-xlarge; padded to 128 inside the kernel) on the
    prefill, causal and non-causal, and on the split-KV decode; GQA groups
    of 4, 8 and 12 (llama3-8b, qwen3-moe / chameleon, starcoder2-3b) on
    the split-KV decode at head_dim 128 and on the prefill; hubert's
    encode (4, 1024, 16, 16, 80) non-causal. Decodes over strided
    prefixes of a cache as the families' serving makes them (2 slots,
    FAM_PROMPT + FAM_NEW - 1 keys of FAM_CAP). Returns the errors."""
    bf16 = torch.bfloat16
    T = FAM_PROMPT + FAM_NEW - 1
    errs = []
    for B, S, H, K, hd, causal, what in [
            (1, FAM_PROMPT, 32, 32, 80, True, "stablelm prefill, hd 80"),
            (1, 300, 32, 32, 80, False, "hd 80 non-causal"),
            (HU_FRAMES[0], HU_FRAMES[1], 16, 16, 80, False,
             "hubert encode, hd 80"),
            (1, FAM_PROMPT, 32, 8, 128, True, "llama3 prefill, G 4"),
            (1, FAM_PROMPT, 32, 4, 128, True, "qwen3-moe prefill, G 8"),
            (1, FAM_PROMPT, 64, 8, 128, True, "chameleon prefill, G 8"),
            (1, FAM_PROMPT, 24, 2, 128, True, "starcoder2 prefill, G 12")]:
        q = _randn((B, S, H, hd), bf16, gen)
        k, v = (_randn((B, S, K, hd), bf16, gen) for _ in range(2))
        errs.append(_attn_case(
            f"families {what}: q ({B},{S},{H},{hd}) k,v ({B},{S},{K},{hd}) "
            f"causal={causal}", q, k, v, "prefill", causal))
    for H, K, hd, what in [(32, 32, 80, "stablelm decode, hd 80"),
                           (32, 8, 128, "llama3 decode, G 4"),
                           (32, 4, 128, "qwen3-moe decode, G 8"),
                           (64, 8, 128, "chameleon decode, G 8"),
                           (24, 2, 128, "starcoder2 decode, G 12")]:
        q = _randn((FAM_SLOTS, 1, H, hd), bf16, gen)
        ck, cv = (_randn((FAM_SLOTS, FAM_CAP, K, hd), bf16, gen)
                  for _ in range(2))
        kp, vp = ck[:, :T], cv[:, :T]
        assert not kp.is_contiguous()
        pl = fa_plan(q, kp, vp)
        errs.append(_attn_case(
            f"families {what}: q ({FAM_SLOTS},1,{H},{hd}) over bf16 cache "
            f"prefix ({FAM_SLOTS},{T}/{FAM_CAP},{K},{hd}) ({pl.splits} "
            f"splits of {pl.split})", q, kp, vp, "split_decode"))
    # the [dryrun] card cell's prefill, olmo-1b prefill_32k at batch 1,
    # held on the first DRYRUN_ROWS query rows (their keys alone) and the
    # last (every key; all 32768 rows would need 69 GB of fp32 scores). q
    # scaled by DRYRUN_Q_SCALE peaks the softmax: a row's largest of ~32k
    # scores leads the next by about 1, so the outputs are O(1) (unit
    # scores would average ~32k values to ~0.01, under the tolerance) and
    # a key block missed or added, or the diagonal misplaced, moves every
    # row whose leading keys it holds by O(1)
    S = SHAPES["prefill_32k"].seq_len
    q = _randn((1, S, 16, 128), bf16, gen) * DRYRUN_Q_SCALE
    k, v = (_randn((1, S, 16, 128), bf16, gen) for _ in range(2))
    assert fa_plan(q, k, v).path == "prefill"
    got = flash_attention(q, k, v)
    n = DRYRUN_ROWS
    errs.append(_check(
        f"dryrun cell prefill: q x {DRYRUN_Q_SCALE:g}, k, v (1,{S},16,128) "
        f"causal, the first {n} query rows [prefill]", got[:, :n],
        attention_ref(q[:, :n], k[:, :n], v[:, :n]), TOL[bf16]))
    errs.append(_check(
        f"dryrun cell prefill: q x {DRYRUN_Q_SCALE:g}, k, v (1,{S},16,128) "
        f"causal, the last {n} query rows [prefill]", got[:, -n:],
        attention_ref(q[:, -n:], k, v), TOL[bf16]))
    return errs


def ragged_lengths(B, cap, gen):
    """B per-lane key lengths spread from 1 to `cap` in a shuffled order,
    int32 on the card: the fleet tick's lanes at their positions."""
    n = torch.linspace(1, cap, B, device=DEV).round().to(torch.int32)
    return n[torch.randperm(B, generator=gen, device=DEV)]


def _lengths_case(name, q, k, v, lengths, path):
    """flash_attention with per-lane `lengths` over the whole cache on the
    path `plan` must pick, held to `attention_ref(lengths=)` (each lane
    over its own prefix; a lane of length 0 is 0 in both)."""
    pl = fa_plan(q, k, v)
    assert pl.path == path, (name, pl.path, path)
    return _check(f"{name} [{path}, {pl.splits} split(s) of {pl.split}]",
                  flash_attention(q, k, v, lengths=lengths),
                  attention_ref(q, k, v, lengths=lengths), TOL[q.dtype])


def check_attention_lengths(gen):
    """The fleet decode's attention: one call over the whole pool, each
    lane with its own key length. olmo-1b's tick over a (32, 1024, 16, 128)
    bf16 cache and hymba-1.5b's global layers over (32, 1184, 5, 64),
    lengths ragged from 1 to the capacity (split-KV decode), fp32 q over
    olmo's cache (CUDA-core kernel); then 4 lanes, where the splits are
    several and some lie past a lane's length, with lanes of length 0 (pool
    rows that hold no lane). Returns the errors."""
    bf16 = torch.bfloat16
    errs = []
    for B, cap, H, K, hd, qdt, path, lengths, what in [
            (FLEET_SLOTS, CAP, 16, 16, 128, bf16, "split_decode", None,
             "olmo fleet tick"),
            (FLEET_SLOTS, HY_CAP, 25, 5, 64, bf16, "split_decode", None,
             "hymba fleet tick, global layers"),
            (FLEET_SLOTS, CAP, 16, 16, 128, torch.float32, "cuda_core", None,
             "olmo fleet tick, fp32 q"),
            (4, CAP, 16, 16, 128, bf16, "split_decode", [0, 1, 700, CAP],
             "splits past a lane's length"),
            (4, HY_CAP, 25, 5, 64, bf16, "split_decode", [5, HY_CAP, 0, 129],
             "GQA 25/5, splits past a lane's length"),
            (4, CAP, 16, 16, 128, torch.float32, "cuda_core",
             [0, 1, 700, CAP], "fp32 q, a lane of length 0")]:
        q = _randn((B, 1, H, hd), qdt, gen)
        ck, cv = (_randn((B, cap, K, hd), bf16, gen) for _ in range(2))
        n = (ragged_lengths(B, cap, gen) if lengths is None else
             torch.tensor(lengths, dtype=torch.int32, device=DEV))
        errs.append(_lengths_case(
            f"lengths {what}: q ({B},1,{H},{hd}) {str(qdt)[6:]} over bf16 "
            f"cache ({B},{cap},{K},{hd}), lengths {int(n.min())}.."
            f"{int(n.max())}", q, ck, cv, n, path))
    return errs


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
        ops = {op: re.compile(rf"\b{op}\b") for op in ("HMMA", "FFMA")}
        for line in sass.splitlines():
            if "Function : " in line:
                name = re.search(r"Function : (\S+)", line).group(1)
                counts[name] = {"HMMA": 0, "FFMA": 0}
            elif name:
                for op, pat in ops.items():
                    # the substring test first: a regex per line and op
                    # took seconds over the libraries' SASS
                    if op in line and pat.search(line):
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
    ragged S = 1000, its state also against the oracle. Last, the
    metered window's eval shapes (B, 32, 4, 512), B 128, 64, 16 and 8 in
    both dtypes. Returns the largest error at the prefill
    shape, bf16, chunk 64."""
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
    # the metered window's xlstm-350m evals: up to 8 members flattened
    # into one forward of the scenario's 32 tokens at apply_mlstm_block's
    # chunk (one chunk of 32 steps), bf16 screens on the tensor cores and
    # fp32 rescores of one member on the CUDA cores
    for B, dtype in itertools.product((128, 64, 16, 8),
                                      (bf16, torch.float32)):
        shape = (B, 32, XL_HEADS, XL_P)
        args = _mlstm_inputs(*shape, dtype, gen)
        assert ml_plan(*args[:3], min(MLSTM_CHUNK, 32)) == (
            ML_TENSOR_CORE if dtype == bf16 else ML_CUDA_CORE)
        h, st = mlstm_scan(*args, chunk=MLSTM_CHUNK, return_state=True)
        wh, wst = mlstm_chunked(*args, chunk=MLSTM_CHUNK, return_state=True)
        name = (f"mlstm_scan metered eval {str(dtype)[6:]} {shape} "
                f"chunk{MLSTM_CHUNK}")
        _check(f"{name} h", h, wh, TOL[dtype])
        for leaf, a, w in zip("Cnm", st, wst):
            _check(f"{name} state {leaf}", a, w, TOL[dtype])
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
def serve_args(arch, requests=REQUESTS, slots=SLOTS, max_new=MAX_NEW):
    sv = SERVING[arch]
    return ["--arch", arch, "--full", "--requests", str(requests),
            "--num-slots", str(slots), "--prompt-len", str(sv["prompt"]),
            "--max-new", str(max_new), "--capacity", str(sv["capacity"]),
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


def serve_full_width(arch, requests=REQUESTS, slots=SLOTS, max_new=MAX_NEW):
    cfg = get_config(arch)
    reset_launches()
    report = serve.main(serve_args(arch, requests, slots, max_new))
    torch.cuda.synchronize()
    launches = launch_counts()
    out = report["outputs"]
    assert len(out) == requests, sorted(out)
    for rid, toks in out.items():
        assert len(toks) == max_new, (rid, len(toks))
        assert all(0 <= t < cfg.vocab_size for t in toks), rid
    prefills = len(report["prefill_s"])
    print(f"[serve] {arch}: parameters initialised in bf16 in "
          f"{report['init_s']:.2f}s")
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
    print(f"[serve] {arch}: decode ms per tick ({slots} slots): "
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
    # the loop serves bf16 copies: drawn in bf16 they are the fp32 draws
    # rounded, and the fp32 tree (qwen2-moe-a2.7b's 57.3 GB) never
    # sits beside them
    loop = ServeLoop(model, model.init(seed=0, dtype=torch.bfloat16,
                                       device=DEV),
                     num_slots=SLOTS, capacity=cap, max_new=MAX_NEW)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab_size, size=prompt)
               for _ in range(SLOTS + 1)]
    warm = XL_WARM_PROMPT if cfg.family == "ssm" else prompt
    for i in range(SLOTS - 1):
        loop.submit(f"p{i}", prompts[i][:warm])
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
        # averaged once: over an xlstm prefill's 210,000 kernel records
        # each key_averages() pass takes seconds
        avgs = pr.key_averages()
        top = sorted(avgs, key=lambda e: -e.device_time_total)
        for e in top[:6]:
            print(f"[profile]   {e.device_time_total / 1e3 / n:8.3f} ms "
                  f"x{e.count // n:<4} {e.key[:90]}")
        for kname, parts in (("ssd_scan", SSD_TC_KERNELS + SSD_CC_KERNELS),
                             ("mlstm_scan", ML_TC_KERNELS + ML_CC_KERNELS)):
            ev = [e for e in avgs if any(k in e.key for k in parts)]
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


def _cpu_isa() -> str:
    """The host CPU's model and its bf16 / AVX-512 / AMX features."""
    model, flags = "?", set()
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name") and model == "?":
                    model = line.split(":", 1)[1].strip()
                elif line.startswith("flags") and not flags:
                    flags = set(line.split(":", 1)[1].split())
    except OSError:
        pass
    keep = sorted(f for f in flags if f.startswith(("avx512", "amx"))
                  or f in ("avx2", "avx_vnni", "fma"))
    return (f"{model}; torch CPU capability "
            f"{torch.backends.cpu.get_cpu_capability()}; {' '.join(keep)}")


def _package_version(name: str) -> str:
    """An installed package's version, read from its metadata without
    importing it (the port never imports jax)."""
    import importlib.metadata
    try:
        return importlib.metadata.version(name)
    except importlib.metadata.PackageNotFoundError:
        return "not installed"


def _golden_diffs(eng):
    out = {}
    for fw in wtrace.GOLDEN_FRAMEWORKS:
        got = wtrace.golden_trace(fw, eng, device=DEV)
        diffs = wtrace.compare(got, wtrace.load_trace(wtrace.golden_path(
            os.path.join(HERE, "tests", "golden"), fw)))
        structural = [d for d in diffs if ".groups" in d or ".events" in d
                      or "count" in d or "meta" in d]
        out[fw] = (len(diffs), len(structural), diffs[:1])
    return out


def _window0_floats(dev):
    """ecco's window 0 at the golden configuration (bf16 compute) from the
    reference's initial weights on `dev`: in order, each micro-window's
    losses and each eval forward's hits, as host arrays."""
    eng = wtrace.make_engine_for(
        wtrace.golden_scenario(),
        init_params={0: load_params_npz(WINDOW_INIT)}, device=dev)
    recs = []
    hits, train = eng._forward_hits, eng.train_micro_many

    def rec_hits(params, toks, precision):
        h = hits(params, toks, precision)
        recs.append((f"eval hits {tuple(toks.shape)} {precision}",
                     h.cpu().numpy()))
        return h

    def rec_train(jobs):
        mets = train(jobs)
        recs.extend(("micro-window losses", m["loss"].float().cpu().numpy())
                    for m in mets.values())
        return mets
    eng._forward_hits, eng.train_micro_many = rec_hits, rec_train
    wtrace.run_scenario("ecco", wtrace.golden_scenario(), engine=eng,
                        windows=1, device=dev, **wtrace.GOLDEN_CONTROLLER)
    return recs


def window_goldens():
    """(b) The four benign goldens at their own configuration (the
    engine's default bf16 compute over fp32 masters) on the card, from the
    reference's initial weights: each framework's number of `compare`
    differences against tests/golden/trace_<fw>.json and the first, not
    asserted (the goldens' floats follow the reference's bf16 rounding),
    with cuBLAS's reduced-precision bf16 reductions allowed (PyTorch's
    default) and refused; then the first float of ecco's window 0 (a
    micro-window's losses or an eval's hits, in order) that parts between
    the card and the CPU; and the environment of both."""
    print(f"[window] (b) environment: CPU {_cpu_isa()}; torch "
          f"{torch.__version__}, jax {_package_version('jax')}")
    eng = wtrace.make_engine_for(
        wtrace.golden_scenario(),
        init_params={0: load_params_npz(WINDOW_INIT)}, device=DEV)
    matmul = torch.backends.cuda.matmul
    default = matmul.allow_bf16_reduced_precision_reduction
    out = {}
    try:
        for reduced in (True, False):
            matmul.allow_bf16_reduced_precision_reduction = reduced
            got = _golden_diffs(eng)
            for fw, (n, st, first) in got.items():
                print(f"[window] (b) {fw} bf16 vs tests/golden/trace_{fw}"
                      f".json, reduced-precision bf16 reductions "
                      f"{'on' if reduced else 'off'}: {n} diffs ({st} "
                      f"structural)" + (f"; first: {first[0]}" if first
                                        else ""))
            out[reduced] = {fw: v[0] for fw, v in got.items()}
    finally:
        matmul.allow_bf16_reduced_precision_reduction = default
    print(f"[window] (b) diff counts (ecco, naive, ekya, recl): reduced "
          f"on {list(out[True].values())}, off {list(out[False].values())}")
    card, cpu = _window0_floats(DEV), _window0_floats(torch.device("cpu"))
    for i, ((kc, ac), (kp, ap)) in enumerate(zip(card, cpu)):
        if kc != kp or ac.shape != ap.shape or not np.array_equal(ac, ap):
            where = (np.argwhere(ac != ap)[0].tolist()
                     if ac.shape == ap.shape else "shape")
            pick = tuple(where) if isinstance(where, list) else ()
            print(f"[window] (b) ecco window 0: the first float that parts "
                  f"card vs CPU is record {i} of {len(card)} ({kc}) at "
                  f"{where}: card {ac[pick]!r}, CPU {ap[pick]!r}"
                  + (f"; losses card {ac.tolist()} CPU {ap.tolist()}"
                     if kc.startswith("micro") else
                     f"; {int((ac != ap).sum())} of {ac.size} hits differ"))
            break
    else:
        print(f"[window] (b) ecco window 0: card and CPU equal in all "
              f"{len(card)} records (micro-window losses, eval hits)")
    return out[True]


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


def _window_evals_held(engine, jobs, kernel, layers, tag):
    """One eval_jobs call over `jobs` (live jobs of `engine`) at the
    loop's shapes and each job's precision, every forward through
    `kernel` (`layers` launches a forward) held to the plain route on
    the same params and rows: the largest logit difference within
    GAP_LIMIT, every argmax flip where the plain top-1 leads by at most
    twice it, and each job's accuracy the one its kernel-route logits
    give (over the vocabulary; the padded columns hold -1e30 on both
    routes)."""
    vocab = engine.cfg.vocab_size
    held, apply = [], engine.model.apply

    def held_apply(params, toks, **kw):
        out = apply(params, toks, **kw)
        plain = apply(params, toks, **dict(kw, kernel_impl="ref"))
        held.append((toks, out[0][:, :-1, :vocab].float(),
                     plain[0][:, :-1, :vocab].float()))
        return out
    engine.model.apply = held_apply
    kernel.launches = 0
    accs = engine.eval_jobs(jobs)
    launches = kernel.launches
    del engine.model.apply              # back to the class's method
    assert len(held) == len(jobs), (len(held), len(jobs))
    assert launches == len(held) * layers, (launches, len(held), layers)
    for job, acc, (toks, lk, lr) in zip(jobs, accs, held):
        precision = job.precision
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
        print(f"{tag} eval_jobs {engine.cfg.name} {job.job_id} {precision} "
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
        WINDOW_MS.append(ms)
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
    assert all(j.precision == ctl.cc.job_precision for j in ctl.jobs)
    _window_evals_held(engine, ctl.jobs, flash_attention, cfg.num_layers,
                       "[window] (c)")
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
# phase 6e: roofline-metered windows
# ---------------------------------------------------------------------------
METER_KERNELS = (flash_attention, fleet_drift, pairwise_js, mlstm_scan)
METER_MARGIN = 0.2      # fp32 rescore margin of the bf16 screens
METER_ACC_GAP = 0.01    # (a): card vs CPU per-stream bf16-screen accuracies
# full width: only the first job's fair share affords olmo-1b (the budget
# is chosen so), so its bank holds 2 rows (12.89 GB each: the job's and a
# dying one's); every later job trains xlstm-350m, 4 rows
METER_BANK, METER_ZOO_BANK = 2, 4


def _meter_kw(sc, **kw):
    out = dict(window_seconds=sc.window_seconds,
               shared_bandwidth=sc.shared_bandwidth, local_caps=sc.local_caps)
    out.update(wtrace.GOLDEN_CONTROLLER)
    out.update(kw)
    return out


def meter_budget(engines, table, precision, sc):
    """A budget at which the first job's fair share, budget / window_micro,
    affords the costliest tier's micro-window and a later job's, budget /
    (window_micro x (jobs + 1)), only the cheapest's: window_micro x (the
    two tiers' micro-window seconds summed). Returns (budget, {tier:
    micro-window seconds})."""
    probe = FRAMEWORKS["ecco"](engines[0], [], ControllerConfig(
        **_meter_kw(sc, cost_table=table)))
    micro = {e.cfg.name: probe._micro_seconds(e.cfg, precision)
             for e in engines}
    hi, lo = max(micro.values()), min(micro.values())
    wm = probe.cc.window_micro
    budget = wm * (hi + lo)
    assert budget / wm >= hi and lo <= budget / (2 * wm) < hi, micro
    return budget, micro


def run_metered(engines, dev, table, budget, *, checker=True,
                on_window=None, **kw):
    """ecco over the golden scenario, engines[0] primary and the rest its
    zoo, under `budget` priced by `table`; invariants on. Returns the
    controller, the trace and each canonical job's tier."""
    sc = wtrace.golden_scenario()
    cc = ControllerConfig(**_meter_kw(sc, cost_table=table,
                                      roofline_budget=budget, **kw))
    ctl = FRAMEWORKS["ecco"](engines[0], list(sc.streams), cc,
                             zoo=list(engines[1:]))
    ctl.warmup()
    chk = InvariantChecker(bank_exact=False, label=f"meter {dev}")
    trace, names, tier = {"windows": []}, {}, {}
    for w in range(sc.windows):
        chk.before_window(ctl)
        n_ev = len(ctl.grouper.events)
        t0 = time.perf_counter()
        wm = ctl.run_window()
        if dev.type == "cuda":
            torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        events = ctl.grouper.events[n_ev:]
        chk.after_window(ctl, wm, events)
        rec = wtrace._window_record(ctl, wm, events, names)
        trace["windows"].append(rec)
        # a comprehension: a loop variable would keep a job that dies in
        # the next window alive through that window's invariant check
        tier.update({wtrace._canon(names, j.job_id): j.engine.cfg.name
                     for j in ctl.jobs})
        if on_window is not None:
            on_window(w, ctl, wm, rec, ms, tier)
    assert chk.windows_checked == sc.windows
    return ctl, trace, tier


def meter_smoke():
    """(a) The golden scenario under ecco at smoke width with a budget
    that binds, the zoo-big / zoo-small tiers, bf16 screens with an fp32
    rescore margin, fp32 training from one set of initial weights per
    tier: on the card (flash_attention on the evals: bf16 on the
    tensor-core prefill, the rescores fp32 on the CUDA-core kernel) and
    on the CPU, priced once with the tests' fixed-seconds table and once
    with the H100 CostTable. Groups, events, each job's tier and the
    roofline reports equal card vs CPU; the screens' accuracy gap under
    METER_ACC_GAP."""
    from repro_torch.launch.roofline import CostTable
    sc = wtrace.golden_scenario()
    tcfg = TrainConfig(**WINDOW_FP32)
    inits = [{0: tree_map(lambda x: x.numpy(), SharedEngine(
        c, tcfg, device="cpu").fresh_state(0)["params"])}
        for c in wtrace.zoo_tiers()]
    for name, table in [("fixed-seconds",
                         wtrace.FixedTable({"zoo-small": 0.25})),
                        ("H100 CostTable", CostTable())]:
        runs = []
        for dev in (DEV, torch.device("cpu")):
            engines = [SharedEngine(c, tcfg, init_params=i, device=dev)
                       for c, i in zip(wtrace.zoo_tiers(), inits)]
            budget, micro = meter_budget(engines, table, "bf16", sc)
            t0 = time.perf_counter()
            ctl, trace, tier = run_metered(
                engines, dev, table, budget, job_precision="bf16",
                rescore_margin=METER_MARGIN)
            runs.append((ctl, trace, tier, time.perf_counter() - t0))
        (cc, ct, ctier, cs), (pc, pt, ptier, ps) = runs
        reports = [[wm.roofline for wm in c.history] for c in (cc, pc)]
        diffs = wtrace.compare(ct, pt)
        gap = max((abs(a - b) for wc, wp in zip(ct["windows"], pt["windows"])
                   for a, b in zip(wc["acc"].values(), wp["acc"].values())
                   if a is not None and b is not None), default=0.0)
        print(f"[meter] (a) {name}: budget {budget!r} s, micro-window s "
              f"{micro}; tiers {ctier}; rescores card {cc.grouper.rescores}"
              f" CPU {pc.grouper.rescores}; card vs CPU {len(diffs)} "
              f"compare diffs, largest bf16-screen accuracy gap {gap!r}; "
              f"{cs:.1f}s on the card, {ps:.1f}s on the CPU")
        for w, rep in enumerate(reports[0]):
            print(f"[meter] (a)   window {w}: {rep}")
        assert ctier == ptier and set(ctier.values()) == {"zoo-big",
                                                          "zoo-small"}
        assert gap < METER_ACC_GAP, (gap, METER_ACC_GAP)
        for wc, wp in zip(ct["windows"], pt["windows"]):
            assert wc["groups"] == wp["groups"], (wc["groups"], wp["groups"])
            assert wc["events"] == wp["events"]
        assert reports[0] == reports[1], reports
        assert all(r is not None for r in reports[0])


def _mlstm_layers(cfg):
    return sum(s.count for s in layer_plan(cfg) if s.kind == "mlstm")


def meter_full_width():
    """(b) olmo-1b at its published config (vocabulary cut to the
    scenario's 64) with one zoo tier, xlstm-350m at its published config
    (vocab 64), random weights, bf16 training over fp32 masters; ecco on
    the golden scenario with drift_impl="auto", a top-2 shortlist,
    job_precision="bf16" with an fp32 rescore margin, priced by the H100
    CostTable under a budget at which the first job affords olmo-1b and
    every later one only xlstm-350m; invariants on, 3 windows. Per
    window: the modeled ledger by kind beside the measured ms, micro-
    windows and tokens trained, each job's tier, the fp32 rescores taken,
    each kernel's launches beside the count reckoned from the eval
    forwards and the grouping requests, peak memory beside the banks'
    bytes. In the first window in which a tier has live jobs, one more
    eval_jobs call over them, each forward held to the plain route
    (_window_evals_held). Returns the four kernels' launches over the
    run."""
    from repro_torch.launch.roofline import CostTable
    while gc.collect():          # [window]'s bank outlives it otherwise
        pass
    torch.cuda.empty_cache()
    sc = wtrace.golden_scenario()
    cfgs = [dataclasses.replace(get_config(a), vocab_size=sc.bank.vocab)
            for a in (ARCH, XLSTM)]
    engines = [SharedEngine(c, device=DEV) for c in cfgs]
    rows = [12 * e.model.num_params() + 4 for e in engines]
    caps = (METER_BANK, METER_ZOO_BANK)
    reckoned = sum(r * c for r, c in zip(rows, caps)) + rows[0]
    total = torch.cuda.get_device_properties(0).total_memory
    print(f"[meter] (b) reckoned before the run: {ARCH} bank {caps[0]} x "
          f"{rows[0] / 1e9:.2f} GB, {XLSTM} bank {caps[1]} x "
          f"{rows[1] / 1e9:.2f} GB, a fresh {ARCH} state {rows[0] / 1e9:.2f}"
          f" GB: {reckoned / 1e9:.2f} GB of {total / 1e9:.2f} GB "
          f"(memory in use now {torch.cuda.memory_allocated() / 1e9:.2f} GB)")
    assert reckoned < 0.85 * total, reckoned
    torch.cuda.reset_peak_memory_stats()
    forwards, trained = [], []       # (engine name, rows, precision)
    split = collections.Counter()    # host-clock ms per (engine, pass)
    for e, cap in zip(engines, caps):
        e.bank = bank = JobBank(e, capacity=cap)

        def no_growth(need, bank=bank):
            if need > bank.capacity:
                raise RuntimeError(f"{bank.engine.cfg.name}: a job for "
                                   f"slot {need}, past {bank.capacity} rows")
        bank._grow_to = no_growth
        hits, train = e._forward_hits, e.train_micro_many

        def counted(params, toks, precision, e=e, hits=hits):
            forwards.append((e.cfg.name, tuple(toks.shape), precision))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = hits(params, toks, precision)
            torch.cuda.synchronize()
            split[e.cfg.name, "eval"] += 1e3 * (time.perf_counter() - t0)
            return out

        def recorded(jobs, e=e, train=train):
            n = {j.job_id: min(j.batch, len(j.pool)) * (j.pool.seq or 0)
                 * j.micro_steps for j in jobs}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            mets = train(jobs)
            torch.cuda.synchronize()
            split[e.cfg.name, "train"] += 1e3 * (time.perf_counter() - t0)
            trained.extend((e.cfg.name, n[k], m) for k, m in mets.items())
            return mets
        e._forward_hits, e.train_micro_many = counted, recorded
    table = CostTable()
    budget, micro = meter_budget(engines, table, "bf16", sc)
    print(f"[meter] (b) budget {budget!r} modeled s a window; one "
          f"micro-window (2 train steps at batch 8, 2 evals at batch 16, "
          f"seq 32, bf16) {micro} s on the H100 CostTable")
    members, totals = {}, dict.fromkeys((k.__name__ for k in METER_KERNELS),
                                        0)
    layers = {cfgs[0].name: cfgs[0].num_layers,
              cfgs[1].name: _mlstm_layers(cfgs[1])}
    window_ms, held = [], set()

    def report(w, ctl, wm, rec, ms, tier):
        got = {k.__name__: k.launches for k in METER_KERNELS}
        by = collections.Counter(n for n, _, _ in forwards)
        want = {"flash_attention": by[cfgs[0].name] * layers[cfgs[0].name],
                "mlstm_scan": by[cfgs[1].name] * layers[cfgs[1].name],
                "fleet_drift": 1,
                "pairwise_js": _js_requests(rec["events"], members)}
        for k in totals:
            totals[k] += got[k]
        losses = [x for _, _, m in trained for x in m["loss"].tolist()]
        rep = wm.roofline
        print(f"[meter] (b) window {w}: {ms:.1f} ms measured, "
              f"{1e3 * rep['spent']:.3f} ms modeled "
              f"{ {k: round(1e3 * v, 3) for k, v in rep['by_kind'].items()} }"
              f" of {1e3 * rep['total']:.3f}; notes {rep['notes']}; "
              f"{len(trained)} micro-windows "
              f"{dict(collections.Counter(n for n, _, _ in trained))}, "
              f"{sum(t for _, t, _ in trained)} tokens trained; eval "
              f"forwards {dict(collections.Counter(forwards))}; tiers "
              f"{tier}; fp32 rescores so far {ctl.grouper.rescores}; "
              f"launches {got} (reckoned {want}); groups {rec['groups']}; "
              f"peak {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
        print(f"[meter] (b) window {w} host-clock split, ms: "
              f"{ {f'{n} {k}': round(v, 1) for (n, k), v in split.items()} }"
              f", the rest {ms - sum(split.values()):.1f}")
        assert got == want, (got, want)
        assert all(math.isfinite(x) for x in losses), losses
        window_ms.append(ms)
        # the first window in which a tier has live jobs: those jobs once
        # more, every forward held to the plain route (launches for the
        # comparison, after this window's counts were read)
        for e, kernel in zip(engines, (flash_attention, mlstm_scan)):
            jobs = [j for j in ctl.jobs if j.engine is e]
            if jobs and e.cfg.name not in held:
                assert all(j.precision == "bf16" for j in jobs)
                _window_evals_held(e, jobs, kernel, layers[e.cfg.name],
                                   f"[meter] (b) window {w}")
                held.add(e.cfg.name)
        forwards[:], trained[:] = [], []
        split.clear()
        for k in METER_KERNELS:
            k.launches = 0

    for k in METER_KERNELS:
        k.launches = 0
    ctl, trace, tier = run_metered(
        engines, DEV, table, budget, on_window=report, drift_impl="auto",
        shortlist_k=2, job_precision="bf16", rescore_margin=METER_MARGIN)
    banks = sum(e.bank.capacity * e.bank.state_row_nbytes for e in engines)
    print(f"[meter] (b) windows {[round(x, 1) for x in window_ms]} ms "
          f"metered with bf16 screens, beside [window] (c)'s unmetered fp32 "
          f"windows {[round(x, 1) for x in WINDOW_MS]} ms in this run; peak "
          f"device memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB "
          f"beside the banks' {banks / 1e9:.2f} GB; tiers {tier}")
    assert set(tier.values()) == {cfgs[0].name, cfgs[1].name}, tier
    assert tier["g0"] == cfgs[0].name, tier      # the first job's share
    assert all(n > 0 for n in totals.values()), totals
    assert all(e.bank._host is None for e in engines)
    assert held == {e.cfg.name for e in engines}, held
    return totals


def meter_launcher():
    """(c) `repro_torch.launch.train.main` on the card at smoke scale, two
    windows, the fleet's regions switching domain at t = 5 so that the
    second window has groups to score: its windows printed, a finite
    final accuracy."""
    from repro_torch.launch import train as launch_train
    t0 = time.perf_counter()
    final = launch_train.main(["--windows", "2", "--switch-time", "5"])
    print(f"[meter] (c) launch.train on the card: 2 windows in "
          f"{time.perf_counter() - t0:.1f}s, final mean accuracy {final!r}")
    assert math.isfinite(final), final


# ---------------------------------------------------------------------------
# phase 6d: the fleet serving plane
# ---------------------------------------------------------------------------
def _solo_leads(model, params, prompt, tokens, cap):
    """A solo `ServeLoop` of one slot on `params` (bf16 compute and pool)
    driven through `tokens`, the fleet's transcript of `prompt`: per
    emitted token the solo argmax and its lead over the second logit."""
    loop = ServeLoop(model, params, num_slots=1, capacity=cap,
                     max_new=len(tokens))
    with torch.no_grad():
        last, cache, pos = model.prefill(
            loop.params, torch.as_tensor(prompt, device=DEV)[None],
            loop.mgr.capacity)
        loop.mgr.write_prefill(0, cache, pos)
        logits = [last[0]]
        for i, tok in enumerate(tokens[:-1]):
            lg, _ = model.decode(loop.params,
                                 torch.tensor([[tok]], device=DEV),
                                 loop.mgr.cache, pos + i)
            logits.append(lg[0, -1])
    top2 = torch.stack(logits).float()[:, :model.cfg.vocab_size].topk(2)
    lead = top2.values[:, 0] - top2.values[:, 1]
    return top2.indices[:, 0].tolist(), lead.tolist()


def fleet_full_width():
    """[fleet] (a): olmo-1b at its published config served through
    `FleetServePlane`: three groups seeded ungated, a candidate through
    the gate, 48 queries in 32 slots. Counters set to 0 just before the
    pump and read just after: each tick one flash_attention launch (and
    one combine) per layer, 16, beside 16 per batched prefill. ms per tick,
    lanes per tick, tokens/s, peak memory beside the store's bytes; one
    profiled tick; one lane per group held to a solo decode of its row."""
    from torch.profiler import ProfilerActivity, profile
    cfg = get_config(ARCH)
    vocab = cfg.vocab_size
    layers = expected_launches(cfg, 0, 1)["flash_attention"]   # 16
    # the earlier phases' planes hold their states in reference cycles,
    # and a job's finalizer keeps its bank for one collection more
    while gc.collect():
        pass
    torch.cuda.empty_cache()
    print(f"[fleet] (a) device memory in use at the start: "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB")
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    engine = SharedEngine(cfg, device=DEV)
    plane = FleetServePlane(engine, ServeConfig(
        num_slots=FLEET_SLOTS, capacity=CAP, max_new=MAX_NEW))
    rng = np.random.default_rng(30)
    groups = [f"g{s}" for s in FLEET_SEEDS]
    t0 = time.perf_counter()
    for gid, seed in zip(groups, FLEET_SEEDS):
        d = plane.publish(gid, engine.model.init(seed=seed, device=DEV),
                          rng.integers(0, vocab, size=FLEET_SAMPLE))
        assert d.seeded and d.accepted, d
    # the gate's held-out sample: random prompts that the first group's
    # model continued greedily for MAX_NEW tokens (served by the plane),
    # so that the incumbent's accuracy is not 0
    rows, seq = FLEET_SAMPLE
    prompts = rng.integers(0, vocab, size=(rows, seq - MAX_NEW))
    for i, p in enumerate(prompts):
        plane.enqueue(f"s{i}", groups[0], p)
    plane.pump()
    cont = plane.drain()
    plane.window_report()
    sample = np.concatenate([prompts, np.stack(
        [cont[f"s{i}"] for i in range(rows)])], axis=1)
    gate = plane.publish(groups[0], engine.model.init(
        seed=FLEET_CANDIDATE, device=DEV), sample)
    nb = plane.store.nbytes()
    row_bytes = sum(x.numel() * 4 for x in tree_leaves(
        plane.store.row(groups[0])))
    print(f"[fleet] (a) {ARCH}: 3 groups seeded and the seed-"
          f"{FLEET_CANDIDATE} candidate gated in {time.perf_counter() - t0:.1f}"
          f"s: candidate acc {gate.candidate_acc!r} vs incumbent "
          f"{gate.incumbent_acc!r} on an {FLEET_SAMPLE} sample -> "
          f"{'accepted' if gate.accepted else 'rejected'}; store "
          f"{plane.store.reg.capacity} fp32 rows {nb['rows'] / 1e9:.2f} GB "
          f"+ bf16 copy {nb['compute'] / 1e9:.2f} GB, pool "
          f"{sum(x.numel() * x.element_size() for x in tree_leaves(plane.mgr.cache)) / 1e9:.2f} GB")
    assert nb["rows"] == plane.store.reg.capacity * row_bytes == 4 * row_bytes
    # the incumbent hits its own continuation; the swap follows the rule
    assert not gate.seeded and gate.incumbent_acc > 0, gate
    assert gate.accepted == (gate.candidate_acc >= gate.incumbent_acc), gate
    queries = [(f"q{i}", groups[i % 3],
                rng.integers(0, vocab, size=FLEET_PROMPTS[(i // 3) % 2]))
               for i in range(FLEET_QUERIES)]
    for rid, gid, prompt in queries:
        plane.enqueue(rid, gid, prompt)
    torch.cuda.synchronize()
    calls0 = plane.prefill_calls
    reset_launches()
    t0 = time.perf_counter()
    ticks = plane.pump()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    prefills = plane.prefill_calls - calls0
    rep = plane.window_report()
    out = plane.drain()
    assert sorted(out) == sorted(q[0] for q in queries), sorted(out)
    for rid, toks in out.items():
        assert len(toks) == MAX_NEW and all(0 <= t < vocab for t in toks), rid
    per_tick = (launches["flash_attention"] - layers * prefills) / ticks
    print(f"[fleet] (a) {ARCH}: {ticks} ticks, {prefills} batched prefills;"
          f" launches {launches}: {per_tick:g} flash_attention launches per "
          f"tick ({layers} layers), "
          f"{launches['flash_attention_combine'] / ticks:g} combines per "
          f"tick")
    assert per_tick == layers
    assert launches["flash_attention_combine"] == layers * ticks, launches
    assert launches["flash_attention"] == layers * (prefills + ticks)
    log = plane.tick_log[-ticks:]
    lanes = [n for n, _ in log]
    tick_ms = np.array([1e3 * t for _, t in log])
    n_tok = sum(len(v) for v in out.values())
    print(f"[fleet] (a) {ARCH}: ms per tick median {np.median(tick_ms):.3f}"
          f" p99 {np.percentile(tick_ms, 99):.3f} min {tick_ms.min():.3f} "
          f"max {tick_ms.max():.3f} (first includes warm-up); lanes per tick"
          f" {min(lanes)}..{max(lanes)} (mean {np.mean(lanes):.1f}); "
          f"{n_tok} tokens of {len(out)} queries in {wall:.3f}s: "
          f"{n_tok / wall:.1f} tokens/s end to end ({rep['tokens']} decoded "
          f"in ticks, qps {rep['qps']:.2f})")
    peak = torch.cuda.max_memory_allocated() - base
    print(f"[fleet] (a) {ARCH}: peak device memory {peak / 1e9:.2f} GB "
          f"beside the store's {(nb['rows'] + nb['compute']) / 1e9:.2f} GB")
    # one profiled tick of a full pool at two positions
    for i in range(FLEET_SLOTS):
        plane.enqueue(f"p{i}", groups[i % 3],
                      rng.integers(0, vocab, size=FLEET_PROMPTS[i % 2]))
    plane.pump(max_ticks=2)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        ts = time.perf_counter()
        plane.tick()
        torch.cuda.synchronize()
        tick_wall = 1e3 * (time.perf_counter() - ts)
    busy, kernels = _device_busy_ms(prof)
    if kernels:
        print(f"[fleet] (a) profiled tick ({len(plane.mgr.active())} lanes "
              f"after it): wall {tick_wall:.3f} ms, device busy {busy:.3f} "
              f"ms, idle share {1 - busy / tick_wall:.3f}, {kernels} kernels")
        for e in sorted(prof.key_averages(),
                        key=lambda e: -e.device_time_total)[:6]:
            print(f"[fleet]   {e.device_time_total / 1e3:8.3f} ms "
                  f"x{e.count:<4} {e.key[:90]}")
    else:
        print("[fleet] (a) the profiler saw no device time; idle share not "
              "measured")
    plane.pump()
    plane.drain()
    plane.window_report()
    # one lane per group against a solo decode of its serving row
    decided = 0
    for gid in groups:
        rid, _, prompt = next(q for q in queries if q[1] == gid)
        top, lead = _solo_leads(engine.model, plane.store.compute_row(gid),
                                prompt, out[rid], CAP)
        for step, (t, want, gap) in enumerate(zip(out[rid], top, lead)):
            if gap > FLEET_LEAD:
                assert t == want, (gid, rid, step, out[rid], top, lead)
                decided += 1
        print(f"[fleet] (a) {gid} {rid}: fleet transcript held to the solo "
              f"decode at {sum(g > FLEET_LEAD for g in lead)} of {MAX_NEW} "
              f"steps (smallest lead {min(lead):.4f})")
    assert decided >= 3 * MAX_NEW // 2, decided
    del plane, engine
    while gc.collect():
        pass
    print(f"[fleet] (a) device memory in use after the plane: "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB")
    return launches["flash_attention"], launches["flash_attention_combine"]


def _canon_decisions(history):
    """Groups, shares and accuracies per window, job ids renamed by first
    appearance."""
    names = {}
    out = []
    for wm in history:
        nm = {j: names.setdefault(j, f"g{len(names)}") for j in wm.groups}
        out.append((wm.t, {nm[j]: sorted(m) for j, m in wm.groups.items()},
                    {names.setdefault(j, f"g{len(names)}"): v
                     for j, v in wm.shares.items()},
                    {s: (None if math.isnan(a) else a)
                     for s, a in wm.per_stream_acc.items()}))
    return out, names


def _canon_serve(history, names):
    out = []
    for wm in history:
        s = {k: v for k, v in wm.serve.items() if k not in SERVE_TIMING}
        s["staleness"] = {names[k]: v for k, v in s["staleness"].items()}
        s["gate"] = [dict(g, group_id=names[g["group_id"]],
                          incumbent_acc=(None if math.isnan(
                              g["incumbent_acc"]) else g["incumbent_acc"]))
                     for g in s["gate"]]
        out.append(s)
    return out


def _fleet_pool(model, stack, dtype):
    """FLEET_ROWS' lanes prefilled on the CPU by their groups' models into
    FLEET_SMOKE_SLOTS of a pool of 9 slots. Returns (pool, tokens,
    positions)."""
    cap = FLEET_SMOKE_CAP + model.cfg.meta_tokens
    pool = model.init_cache(9, cap, dtype, "cpu")
    rng = np.random.default_rng(31)
    toks, poss = [], []
    for slot, r, n in zip(FLEET_SMOKE_SLOTS, FLEET_ROWS, FLEET_SMOKE_PROMPTS):
        params = tree_map(lambda t, r=r: t[r], stack)
        last, c, pos = model.prefill(
            params, torch.as_tensor(rng.integers(0, 64, size=n))[None], cap,
            compute_dtype=dtype)
        for dst, src in zip(tree_leaves(pool), tree_leaves(c)):
            dst[:, slot] = src[:, 0].to(dst.dtype)
        toks.append(int(last[0].float().argmax()))
        poss.append(int(pos))
    return pool, toks, poss


def fleet_step_smoke(arch):
    """The fleet decode step at smoke width, card vs CPU, from one cache
    prefilled on the CPU: FLEET_SMOKE_TICKS ticks teacher-forced on the
    CPU's tokens, fp32 (logits within FLEET_SMOKE_TOL) and bf16 (tokens
    equal where the CPU's top-1 leads by more than FLEET_LEAD);
    flash_attention once per global layer per tick on the card."""
    cfg = dataclasses.replace(smoke_config(arch), vocab_size=64)
    model = build_model(cfg)
    stack = tree_map(lambda *t: torch.stack(t),
                     *[model.init(seed=s, device="cpu") for s in range(3)])
    glob = sum(s.count for s in layer_plan(cfg)
               if s.kind == "block" and s.window == 0)
    for dtype in (torch.float32, torch.bfloat16):
        st = tree_map(lambda t: t.to(dtype), stack)
        cpu_pool, toks, poss = _fleet_pool(model, st, dtype)
        card_pool = tree_map(lambda t: t.to(DEV, copy=True), cpu_pool)
        card_st = tree_map(lambda t: t.to(DEV), st)
        worst, decided, compared, launches = 0.0, 0, 0, 0
        for _ in range(FLEET_SMOKE_TICKS):
            want, _ = fleet_decode_logits(model, st, FLEET_ROWS, toks,
                                          cpu_pool, poss, FLEET_SMOKE_SLOTS,
                                          compute_dtype=dtype)
            before = flash_attention.launches
            got, _ = fleet_decode_logits(model, card_st, FLEET_ROWS, toks,
                                         card_pool, poss, FLEET_SMOKE_SLOTS,
                                         compute_dtype=dtype)
            launches += flash_attention.launches - before
            w, g = want[:, 0, :64].float(), got[:, 0, :64].float().cpu()
            worst = max(worst, float((w - g).abs().max()))
            top2 = w.topk(2)
            lead = (top2.values[:, 0] - top2.values[:, 1]).tolist()
            for a, (tw, tg, ld) in enumerate(zip(w.argmax(-1).tolist(),
                                                 g.argmax(-1).tolist(),
                                                 lead)):
                compared += 1
                if ld > FLEET_LEAD:
                    assert tw == tg, (arch, dtype, a, lead)
                    decided += 1
            toks, poss = w.argmax(-1).tolist(), [p + 1 for p in poss]
        print(f"[fleet] (b) {arch} smoke fleet step {str(dtype)[6:]}, card "
              f"vs CPU over {FLEET_SMOKE_TICKS} ticks: largest logit gap "
              f"{worst:.3e}; tokens equal at {decided} of {compared} lanes "
              f"where the CPU's top-1 leads by more than {FLEET_LEAD:g}; "
              f"flash_attention {launches} launches ({glob} global layer(s) "
              f"x {FLEET_SMOKE_TICKS} ticks)")
        assert launches == glob * FLEET_SMOKE_TICKS, launches
        assert decided >= compared // 2, (decided, compared)
        if dtype == torch.float32:
            assert worst <= FLEET_SMOKE_TOL, worst


def fleet_smoke():
    """[fleet] (b): the window loop with serving on at smoke width from the
    reference's initial weights in fp32 (the serving plane at its bf16
    default), ecco on the golden scenario on the card and on the CPU, and
    on the card with serving off: every window's decisions equal across the
    three, the serve reports (but their clock readings) equal card vs CPU.
    Then hymba and xlstm through the fleet step card vs CPU, and the
    launcher's --fleet path and the serve_continuous example on the card."""
    init = {0: load_params_npz(WINDOW_INIT)}
    tcfg = TrainConfig(**WINDOW_FP32)
    scfg = ServeConfig(num_slots=8, capacity=32, max_new=4, prompt_len=8,
                       queries_per_stream=2)
    runs = {}
    for tag, dev, sc in (("card", DEV, scfg), ("cpu", torch.device("cpu"),
                                               scfg), ("off", DEV, None)):
        eng = wtrace.make_engine_for(wtrace.golden_scenario(), tcfg=tcfg,
                                     init_params=init, device=dev)
        reset_launches()
        t0 = time.perf_counter()
        runs[tag] = wtrace.run_scenario(
            "ecco", wtrace.golden_scenario(), engine=eng, seed=0, device=dev,
            serve=sc, **wtrace.GOLDEN_CONTROLLER)
        print(f"[fleet] (b) window loop ecco, serve "
              f"{'on' if sc else 'off'}, on the {tag if sc else 'card'}: "
              f"{time.perf_counter() - t0:.1f}s, flash_attention "
              f"{flash_attention.launches} launches")
    (card, names), (cpu, cnames), (off, _) = (
        _canon_decisions(runs[k].history) for k in ("card", "cpu", "off"))
    assert card == cpu == off, "serving moved a decision"
    sc_card = _canon_serve(runs["card"].history, names)
    sc_cpu = _canon_serve(runs["cpu"].history, cnames)
    print(f"[fleet] (b) decisions equal card / CPU / serve off; serve "
          f"reports card vs CPU {'equal' if sc_card == sc_cpu else 'DIFFER'}:"
          f" queries {[s['queries'] for s in sc_card]}, gate "
          f"{[[(g['group_id'], g['accepted']) for g in s['gate']] for s in sc_card]}")
    assert sc_card == sc_cpu, (sc_card, sc_cpu)
    assert sum(s["queries"] for s in sc_card) > 0
    for arch in (HYMBA, XLSTM):
        fleet_step_smoke(arch)
    report = serve.main(["--fleet", "--requests", "6", "--max-new", "8",
                         "--capacity", "64", "--prompt-len", "24"])
    assert len(report["outputs"]) == 6 and report["report"]["swap_seeded"] == 2
    ex = serve_continuous.main([])
    assert len(ex["outputs"]) == 8 and ex["gate"].accepted, ex["gate"]
    print(f"[fleet] (b) launcher --fleet and serve_continuous on the card: "
          f"{report['ticks']} ticks; the retrained candidate "
          f"{ex['gate'].candidate_acc:.3f} vs {ex['gate'].incumbent_acc:.3f},"
          f" fidelity {ex['fidelity']:.2f}")


# ---------------------------------------------------------------------------
# phase 6f: the rest of the model registry
# ---------------------------------------------------------------------------
def _free_device():
    """Collect until nothing is freed (the earlier planes hold their
    states in reference cycles), then return the cached blocks."""
    while gc.collect():
        pass
    torch.cuda.empty_cache()


@contextlib.contextmanager
def _recorded_routes():
    """Each MoE layer's top-k ids (t, k), as `moe._route` returns them."""
    from repro_torch.models import moe
    ids, route = [], moe._route

    def record(*args, **kwargs):
        out = route(*args, **kwargs)
        ids.append(out[1])
        return out
    moe._route = record
    try:
        yield ids
    finally:
        moe._route = route


def family_logits(arch):
    """Full-width prefill last-token logits of a FAM_PROMPT-token prompt,
    kernel route vs plain route, bf16 compute, on parameters initialised
    in bf16 (the fp32 init rounded: tests/test_torch_model.py), within
    LOGIT_TOL; for a MoE model also the (token, k) routes that differ
    between the two routes, per layer. Returns (error, flips per layer)."""
    model = build_model(get_config(arch))
    cfg = model.cfg
    params = model.init(seed=0, dtype=torch.bfloat16, device=DEV)
    x = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab_size, size=(1, FAM_PROMPT)), device=DEV)
    with torch.no_grad():
        reset_launches()
        with _recorded_routes() as kernel_ids:
            got, _, _ = model.prefill(params, x, FAM_CAP)
        launches = launch_counts()
        assert launches == expected_launches(cfg, 1, 0), launches
        with _recorded_routes() as plain_ids:
            want, _, _ = model.prefill(params, x, FAM_CAP, kernel_impl="ref")
    torch.cuda.synchronize()
    flips = [int((a != b).sum()) for a, b in zip(kernel_ids, plain_ids,
                                                  strict=True)]
    V = cfg.vocab_size
    g, w = got[:, :V].float(), want[:, :V].float()
    assert bool(torch.isfinite(g).all()), "non-finite logits"
    err = float((g - w).abs().max())
    moe = (f"; routes differing per layer (of {FAM_PROMPT} x "
           f"{cfg.moe.top_k}): {flips}" if cfg.moe else "")
    print(f"[families] {arch} full-width prefill last-token logits, kernel "
          f"vs plain, bf16: max_abs_err={err:.4e} (|logit| max "
          f"{float(w.abs().max()):.3f}) tol={LOGIT_TOL} argmax_equal="
          f"{int(g.argmax()) == int(w.argmax())}{moe}")
    assert err <= LOGIT_TOL, (err, flips)
    return err, flips


def hubert_encode():
    """[families] (c): hubert-xlarge's `make_encode_step` at its published
    config on (4, 1024, 1280) frames drawn from seed 0, bf16 parameters
    and compute: one non-causal flash_attention launch per layer (48, the
    prefill path at head_dim 80), ms per encode, the logits held to the
    plain route's within LOGIT_TOL. Returns the launches."""
    from repro_torch.serve.serve_step import make_encode_step
    model = build_model(get_config(HUBERT))
    cfg = model.cfg
    params = model.init(seed=0, dtype=torch.bfloat16, device=DEV)
    gen = torch.Generator(device=DEV).manual_seed(0)
    frames = torch.randn(HU_FRAMES + (cfg.d_model,), generator=gen,
                         device=DEV)
    encode = make_encode_step(model)
    with torch.no_grad():
        reset_launches()
        got = encode(params, frames)
        torch.cuda.synchronize()
        launches = launch_counts()
        assert launches["flash_attention"] == cfg.num_layers == 48, launches
        assert launches["flash_attention_combine"] == 0, launches
        ms = _time_ms(lambda: encode(params, frames), [()], iters=5,
                      warmup=1)
        want, _ = model.apply(params, frames, kernel_impl="ref")
    V = cfg.vocab_size
    g, w = got[..., :V].float(), want[..., :V].float()
    assert g.shape == HU_FRAMES + (V,) and bool(torch.isfinite(g).all())
    err = float((g - w).abs().max())
    flips = float((g.argmax(-1) != w.argmax(-1)).float().mean())
    print(f"[families] (c) {HUBERT} encode {HU_FRAMES + (cfg.d_model,)} "
          f"frames: {launches['flash_attention']} flash_attention launches "
          f"(non-causal, head_dim 80); {ms:.3f} ms per encode (CUDA "
          f"events, 5 calls); logits kernel vs plain max_abs_err={err:.4e} "
          f"(|logit| max {float(w.abs().max()):.3f}) tol={LOGIT_TOL}, "
          f"argmax differs at {100 * flips:.3f}% of frames")
    assert err <= LOGIT_TOL, err
    return launches["flash_attention"]


def families_smoke():
    """[families] (d): qwen3-moe-30b-a3b and chameleon-34b at smoke width
    (vocabulary 64), the same weights on the card and on the CPU: the
    forward (one flash_attention launch per layer on the card), then a
    prefill and three decode steps teacher-forced on the CPU's tokens,
    fp32 logits within FLEET_SMOKE_TOL, bf16 forward's gap printed. Then
    the fleet decode step for a qwen2-moe smoke student, card vs CPU
    (`fleet_step_smoke`)."""
    f32 = torch.float32
    for arch in FAM_SMOKE:
        cfg = dataclasses.replace(smoke_config(arch), vocab_size=64)
        model = build_model(cfg)
        cpu = model.init(seed=0, device="cpu")
        card = tree_map(lambda t: t.to(DEV), cpu)
        x = torch.as_tensor(np.random.default_rng(2).integers(0, 64,
                                                              size=(2, 24)))
        gaps = {}
        for dtype in (f32, torch.bfloat16):
            want, _ = model.apply(cpu, x, compute_dtype=dtype)
            before = flash_attention.launches
            got, _ = model.apply(card, x.to(DEV), compute_dtype=dtype)
            assert flash_attention.launches - before == cfg.num_layers
            gaps[str(dtype)[6:]] = float(
                (got.float().cpu() - want.float())[..., :64].abs().max())
        kw = dict(compute_dtype=f32, cache_dtype=f32)
        wl, wc, pos = model.prefill(cpu, x, 32, **kw)
        gl, gc_, _ = model.prefill(card, x.to(DEV), 32, **kw)
        worst = float((gl.cpu() - wl)[:, :64].abs().max())
        tok = wl[:, :64].argmax(-1, keepdim=True)
        for i in range(3):
            wl, wc = model.decode(cpu, tok, wc, pos + i, compute_dtype=f32)
            gl, gc_ = model.decode(card, tok.to(DEV), gc_, pos + i,
                                   compute_dtype=f32)
            worst = max(worst, float((gl.cpu() - wl)[..., :64].abs().max()))
            tok = wl[:, -1, :64].argmax(-1, keepdim=True)
        print(f"[families] (d) {arch} smoke, card vs CPU: forward logit gap "
              f"fp32 {gaps['float32']:.3e}, bf16 {gaps['bfloat16']:.3e}; "
              f"fp32 prefill + 3 decode steps {worst:.3e} (tol "
              f"{FLEET_SMOKE_TOL:g})")
        assert gaps["float32"] <= FLEET_SMOKE_TOL and worst <= \
            FLEET_SMOKE_TOL, (gaps, worst)
    fleet_step_smoke(QWEN2)


def families():
    """[families]: the registry beyond the three families served above.
    (a) qwen2-moe-a2.7b at its published config through
    `repro_torch.launch.serve.main` with olmo-1b's serving arguments
    (`serve_full_width`: launches held to `expected_launches`, 24 a
    prefill and 24 a decode call, ms per prefill and tick, tokens/s),
    peak device memory beside its 57.3 GB of fp32 parameters, then
    `family_logits` with its route flips; (b) llama3-8b, starcoder2-3b
    and stablelm-3b the same way with 2 requests in 2 slots and 8 new
    tokens; (c) `hubert_encode`; (d) `families_smoke`. (a) also profiles
    a qwen2-moe prefill and decode ticks (`profile_serving`). Returns the
    flash_attention launches and combines of (a)-(c)."""
    _free_device()
    print(f"[families] device memory in use at the start: "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB")
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    total = collections.Counter(serve_full_width(QWEN2))
    peak = (torch.cuda.max_memory_allocated() - base) / 1e9
    n = build_model(get_config(QWEN2)).num_params()
    print(f"[families] (a) {QWEN2}: {n / 1e9:.2f} B parameters, "
          f"{4 * n / 1e9:.2f} GB in fp32 (reckoned {QWEN2_FP32_GB} GB); "
          f"peak device memory over the launcher's run {peak:.2f} GB (the "
          f"bf16 tree, initialised a layer at a time, the bf16 pool of "
          f"{SLOTS} x {FAM_CAP})")
    _free_device()
    profile_serving(QWEN2)
    _free_device()
    family_logits(QWEN2)
    for arch in FAM_DENSE:
        _free_device()
        total.update(serve_full_width(arch, FAM_SLOTS, FAM_SLOTS, FAM_NEW))
        _free_device()
        family_logits(arch)
    _free_device()
    total["flash_attention"] += hubert_encode()
    _free_device()
    families_smoke()
    return total["flash_attention"], total["flash_attention_combine"]


def families_large():
    """[families] (e): qwen3-moe-30b-a3b and chameleon-34b at their
    published configs through `launch.serve.main`, which initialises them
    straight in bf16, a stacked leaf one layer at a time (61.1 and 68.6 GB;
    their fp32 trees, 122.1 and 137.2 GB, would not fit), with llama3-8b's
    cut (2 requests, 2 slots, 512-token prompts, 8 new tokens): launches
    held to `expected_launches` (48 layers x (prefills + decode calls),
    and the combines), the init's seconds, peak device memory over the
    run; then `family_logits`, the prefill logits kernel vs plain route
    and qwen3's route flips per layer. Each model is freed before the
    next. Returns the flash_attention launches and combines."""
    total = collections.Counter()
    for arch in FAM_LARGE:
        _free_device()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        total.update(serve_full_width(arch, FAM_SLOTS, FAM_SLOTS, FAM_NEW))
        peak = (torch.cuda.max_memory_allocated() - base) / 1e9
        n = build_model(get_config(arch)).num_params()
        print(f"[families] (e) {arch}: {n / 1e9:.2f} B parameters, "
              f"{2 * n / 1e9:.2f} GB in bf16 ({4 * n / 1e9:.1f} GB in fp32); "
              f"peak device memory over the launcher's run {peak:.2f} GB "
              f"(the bf16 tree, one layer's fp32 draw during the init, "
              f"the bf16 pool of {FAM_SLOTS} x {FAM_CAP})")
        _free_device()
        family_logits(arch)
    _free_device()
    return total["flash_attention"], total["flash_attention_combine"]


# ---------------------------------------------------------------------------
# phase 6i: remat and the dry run
# ---------------------------------------------------------------------------
def remat_full_width():
    """[remat]: olmo-1b at full width, one train step's forward and
    backward (`train_step.grad_and_value` over `make_loss_fn`; AdamW,
    which remat does not touch, left out) at batch 8 x 256 under remat
    none / dots / full, bf16 compute over fp32 masters: the loss and the
    largest gradient difference against none's (under deterministic
    algorithms: none, both held bit for bit), ms per step (CUDA events, 3
    calls after one), and the peak device memory over the step above
    what was allocated before it (parameters and none's kept gradients).
    No flash_attention launch: the train route runs the plain forms.
    Returns {remat: (ms, peak GB)}."""
    cfg = get_config(ARCH)
    model = build_model(cfg)
    _free_device()
    params = model.init(seed=0, device=DEV)
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, size=(TRAIN_BATCH, TRAIN_SEQ)), device=DEV)
    batch = {"inputs": toks, "labels": toks}
    steps = {r: grad_and_value(make_loss_fn(model, TrainConfig(remat=r)))
             for r in REMATS}
    steps["none"](params, batch)                      # warm-up
    reset_launches()
    out, want = {}, None
    for remat in REMATS:
        _free_device()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        grads, (loss, _) = _deterministic(steps[remat], params, batch)
        torch.cuda.synchronize()
        peak = (torch.cuda.max_memory_allocated() - base) / 1e9
        if want is None:
            want, diff = (grads, loss), 0.0
        else:
            diff = max(float((g - w).abs().max()) for g, w in
                       zip(tree_leaves(grads), tree_leaves(want[0])))
        del grads
        ms = _time_ms(lambda: steps[remat](params, batch), [()], iters=3,
                      warmup=1)
        out[remat] = (ms, peak)
        print(f"[remat] {ARCH} batch {TRAIN_BATCH} x {TRAIN_SEQ}, remat "
              f"{remat}: loss {float(loss):.6f} (none's "
              f"{float(want[1]):.6f}), largest |grad - none's| {diff:.3e}; "
              f"{ms:.1f} ms a forward + backward; peak {peak:.2f} GB over "
              f"the step")
        assert torch.isfinite(loss) and torch.equal(loss, want[1]), remat
        assert diff == 0.0, (remat, diff)
    assert launch_counts()["flash_attention"] == 0, launch_counts()
    assert out["full"][1] < out["none"][1], out
    del want, params
    _free_device()
    return out


def _dryrun_arch(arch):
    """One arch's four cells in a process of its own on one CPU thread,
    with CUDA hidden from it; returns (arch, exit code, seconds)."""
    env = dict(os.environ, PYTHONPATH=os.path.join(HERE, "src"),
               CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
    out = os.path.join(DRYRUN_DIR, f"{arch}.json")
    t0 = time.perf_counter()
    with open(out + ".log", "w") as log:
        rc = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             arch, "--mesh", "single", "--out", out], cwd=HERE, env=env,
            stdout=log, stderr=subprocess.STDOUT,
            timeout=DRYRUN_TIMEOUT).returncode
    return arch, rc, time.perf_counter() - t0


def dryrun_cells():
    """[dryrun]: the dry run's 40 cells (10 archs x 4 shapes, single
    mesh, tp policy, remat full), one process per arch, as many at once
    as the host has cores but one, while the card idles (no phase is
    timed beside them): each cell's status, flops per device, dominant
    term and seconds; the skip cells must be the reference's
    (DRYRUN_SKIPS), every other cell priced (the MoE cells
    expert-parallel)."""
    shutil.rmtree(DRYRUN_DIR, ignore_errors=True)
    os.makedirs(DRYRUN_DIR)
    t0 = time.perf_counter()
    workers = max(1, min(len(DRYRUN_ORDER), (os.cpu_count() or 2) - 1))
    with concurrent.futures.ThreadPoolExecutor(workers) as pool:
        runs = list(pool.map(_dryrun_arch, DRYRUN_ORDER))
    waited = time.perf_counter() - t0
    results = []
    for arch, rc, secs in runs:
        assert rc == 0, f"the dry run of {arch} exited {rc}; see " \
            f"{DRYRUN_DIR}/{arch}.json.log"
        print(f"[dryrun] {arch}: its process {secs:.1f} s")
        with open(os.path.join(DRYRUN_DIR, f"{arch}.json")) as f:
            results += json.load(f)
    cells = {(r["arch"], r["shape"]) for r in results}
    assert len(results) == 40 and len(cells) == 40, len(results)
    for r in results:
        if r["status"] != "ok":
            print(f"[dryrun] {r['arch']} x {r['shape']}: {r['status']}")
            continue
        print(f"[dryrun] {r['arch']} x {r['shape']}: ok, "
              f"flops/dev={r['flops_per_device']:.4e} dominant="
              f"{r['dominant']} bound={1e3 * r['step_time_bound_s']:.3f} "
              f"ms moe_impl={r['moe_impl']} peak="
              f"{r['memory']['peak_estimate_bytes'] / 1e9:.2f} GB/dev; "
              f"{r['t_lower_s'] + r['t_compile_s'] + r['t_layer_costs_s']:.1f}"
              f" s")
    skips = {(r["arch"], r["shape"]) for r in results
             if r["status"].startswith("skip")}
    assert skips == DRYRUN_SKIPS, sorted(skips ^ DRYRUN_SKIPS)
    assert all(r["status"] == "ok" for r in results
               if (r["arch"], r["shape"]) not in skips)
    assert all(r["moe_impl"] == "ep" for r in results if r["status"] == "ok"
               and r["arch"] in ("qwen3-moe-30b-a3b", "qwen2-moe-a2.7b"))
    print(f"[dryrun] 40 cells, {len(skips)} skipped as the reference "
          f"skips them, in {waited:.1f} s over {workers} processes at once")


def dryrun_card_cell(pk):
    """[dryrun] (card): olmo-1b prefill_32k cut to batch 1 (from 32), the
    dry run's count of it on one entry (`dryrun.step_cost`) against the
    card: fp32 parameters (the tp policy's serving dtype), bf16 compute,
    one prefill through flash_attention (16 launches). The card run is
    counted by the same counters on CUDA tensors, to which the kernel is
    invisible, so the count is held on that part alone: the dry run's
    count less its plain attention (`attention_ref` counted on `meta` at
    the layer's shapes, every key, as the plain route computes it)
    against the card's count, within DRYRUN_FLOPS_RTOL. The kernel's
    work is what this causal run needs, 4 H hd S (S + 1) / 2 a layer (each
    query row's visible keys), and the bound on the card's work is that
    plus the counted part over the bf16 peak, or the dry run's bytes over
    HBM, the larger; beside it the dry run's own bound (every key) and
    the measured ms (CUDA events, 3 prefills after one). The dry run's
    memory estimate (parameters + cache + the largest layer's
    allocations + the last logits) against the peak over init and
    prefill. Returns the launches of the counted prefill."""
    cfg = get_config(ARCH)
    model = build_model(cfg)
    S = SHAPES["prefill_32k"].seq_len
    H, hd, L = cfg.num_heads, cfg.resolved_head_dim, cfg.num_layers
    mesh1 = make_mesh((1, 1), ("data", "model"), devices=["meta"])
    cost = dry.step_cost(cfg, "prefill", 1, S, mesh=mesh1,
                         rules=mesh_rules(mesh1, cfg))
    qm = torch.empty((1, S, H, hd), dtype=torch.bfloat16, device="meta")
    plain_attn = L * RL._count(lambda: attention_ref(qm, qm, qm))[0]
    dry_counted = cost["flops"] - plain_attn
    dry_bound_ms = 1e3 * max(cost["bytes"] / pk["bytes"],
                             cost["flops"] / pk[torch.bfloat16])
    n = model.num_params()
    est = (4 * n + RL._tree_bytes(model.cache_spec(1, S))
           + cost["temp_bytes"] + 4 * cfg.vocab_size) / 1e9
    _free_device()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    params = model.init(seed=0, device=DEV)
    x = torch.as_tensor(np.random.default_rng(7).integers(
        0, cfg.vocab_size, size=(1, S)), device=DEV)
    reset_launches()
    with torch.no_grad():
        counted, _, _, (last, _, _) = RL._count(
            lambda: model.prefill(params, x, S))
    torch.cuda.synchronize()
    peak = (torch.cuda.max_memory_allocated() - base) / 1e9
    launches = launch_counts()
    assert launches["flash_attention"] == L, launches
    assert bool(torch.isfinite(last).all()), "non-finite logits"
    kernel = L * 4 * H * hd * S * (S + 1) // 2
    card = counted + kernel
    terms = {"bytes": cost["bytes"] / pk["bytes"],
             "operations": card / pk[torch.bfloat16]}
    by = max(terms, key=terms.get)
    bound_ms = 1e3 * terms[by]
    with torch.no_grad():
        ms = _time_ms(lambda: model.prefill(params, x, S), [()], iters=3,
                      warmup=1)
    ratio = dry_counted / counted
    print(f"[dryrun] card cell {ARCH} prefill_32k at batch 1: the counted "
          f"part, dry run {dry_counted:.4e} FLOPs (its {cost['flops']:.4e} "
          f"less {plain_attn:.4e} of plain attention over every key) "
          f"against the card's {counted:.4e}, ratio {ratio:.4f} (limit "
          f"{DRYRUN_FLOPS_RTOL:g}); the card's work {card:.4e} FLOPs with "
          f"flash_attention's {kernel:.4e} over the causal keys; bound "
          f"{bound_ms:.3f} ms (by {by}) on that work against {ms:.3f} ms "
          f"measured ({100 * bound_ms / ms:.1f} %); the dry run's own "
          f"bound {dry_bound_ms:.3f} ms (every key); memory estimate "
          f"{est:.2f} GB against a peak of {peak:.2f} GB over init and "
          f"prefill; {launches['flash_attention']} flash_attention "
          f"launches")
    assert abs(ratio - 1.0) <= DRYRUN_FLOPS_RTOL, ratio
    del params, last
    _free_device()
    return launches["flash_attention"]


# ---------------------------------------------------------------------------
# phase 6g: the fleet planes under a device mesh
# ---------------------------------------------------------------------------
MESH_N = 4                  # (a), (c): entries of the one-card fleet mesh
MESH_FD_N = 99_999          # (a): fleet_drift streams, not a multiple of 4
MESH_PJS = (32, 16_383)     # (a): pairwise_js requests x fleet rows
MESH_FULL = 2               # (b): entries of the full-width mesh
MESH_WINDOWS = 2            # (b): windows a run
MESH_FAIL = (2, 4)          # (c): devices lost, at the window's 4th barrier
MESH_CC = dict(window_micro=6, micro_steps=4, train_batch=16,
               drift_threshold=0.25, p_drop=0.5, shared_bandwidth=1e9)
MESH_FLEET = dict(vocab=64, regions=2, streams_per_region=2, dim=4,
                  switch_times=(5.0,), seed=1)
MESH_DIR = os.path.join(HERE, "build", "mesh_ckpt")


def card_mesh(n):
    """A fleet mesh of `n` entries, every one this card."""
    dev = torch.device("cuda", torch.cuda.current_device())
    return make_fleet_mesh(n, devices=[dev] * n)


def _mesh_call(name, kernel, fn, one, sharded, plain, tols):
    """One sharded call: the kernel's launches counted around it (one per
    block), its outputs bit for bit against the unsharded call's and within
    `tols` of the plain version's; then the ms per call of both, CUDA
    events over 20 calls. Returns the (a) record."""
    want = fn(one)
    kernel.launches = 0
    got = fn(sharded)
    launches = kernel.launches
    assert launches == MESH_N, (name, launches)
    for g, w in zip(got, want):
        assert torch.equal(g, w), f"{name}: sharded != one call"
    err = max(_check(f"mesh {name} {i}", g, p, tol, 0.0)
              for i, (g, p, tol) in enumerate(zip(got, plain, tols)))
    ms_one = _time_ms(lambda: fn(one), [()], iters=20)
    ms_mesh = _time_ms(lambda: fn(sharded), [()], iters=20)
    print(f"[mesh] (a) {name} on {MESH_N} entries of one card: bit-identical"
          f" to one call, {launches} launches a call, max_abs_err vs plain "
          f"{err:.3e}; {ms_mesh:.4f} ms per call sharded, {ms_one:.4f} "
          f"unsharded ({ms_mesh / ms_one:.2f}x)")
    return {"ms": ms_mesh, "unsharded_ms": ms_one,
            "launches_per_call": launches, "max_abs_err": err}


def mesh_kernels():
    """(a) fleet_drift at 99,999 streams x 256 tokens (64 buckets, vocab
    64: 102 MB of tokens, 26 MB of references) and pairwise_js (32,
    16,383) with p's rows and q's rows sharded, each over a 4-entry mesh
    of this card: one launch per block, bit-identical to one call, within
    the checks' tolerances of the plain version."""
    mesh = card_mesh(MESH_N)
    rng = np.random.default_rng(23)
    toks = torch.as_tensor(rng.integers(0, DRIFT_VOCAB + 1, size=(
        MESH_FD_N, DRIFT_T)).astype(np.int32), device=DEV)
    ref = torch.as_tensor(rng.random((MESH_FD_N, BUCKETS), np.float32),
                          device=DEV)
    kw = dict(buckets=BUCKETS, vocab=DRIFT_VOCAB)
    out = {"fleet_drift": _mesh_call(
        f"fleet_drift ({MESH_FD_N}, {DRIFT_T})", fleet_drift,
        lambda m: ops.fleet_drift(toks, ref, mesh=m, **kw), None, mesh,
        fleet_drift_ref(toks, ref, **kw), (DRIFT_SCORE_TOL, DRIFT_HIST_TOL))}
    n, m = MESH_PJS
    p = torch.as_tensor(rng.random((n, BUCKETS), np.float32), device=DEV)
    q = rng.random((m, BUCKETS), np.float32)
    q[rng.random(m) < 0.4] = 0.0
    q = torch.as_tensor(q, device=DEV)
    plain = (pairwise_js_ref(p, q),)
    out["pairwise_js"] = {shard: _mesh_call(
        f"pairwise_js ({n}, {m}) shard={shard}", pairwise_js,
        lambda mm, s=shard: (ops.pairwise_js(p, q, mesh=mm, shard=s),),
        None, mesh, plain, (PJS_TOL,)) for shard in ("rows", "cols")}
    return out


def _mesh_history_equal(a, b, tag):
    """Two controllers' histories, decisions and floats, exactly."""
    assert len(a) == len(b), tag
    for w, (wa, wb) in enumerate(zip(a, b)):
        at = f"{tag} window {w}"
        assert wa.t == wb.t, at
        assert wa.groups == wb.groups, (at, wa.groups, wb.groups)
        assert list(wa.per_stream_acc) == list(wb.per_stream_acc), at
        for k, v in wa.per_stream_acc.items():
            u = wb.per_stream_acc[k]
            assert v == u or (math.isnan(v) and math.isnan(u)), (at, k, v, u)
        assert wa.shares == wb.shares, at
        assert wa.bandwidth == wb.bandwidth, at
        assert wa.delivered == wb.delivered, at


def mesh_full_width():
    """(b) olmo-1b at full width (vocabulary 64), random weights from seed
    0, fp32 compute, ecco with drift_impl="auto" and a top-2 shortlist on
    the golden scenario, two windows unsharded and two on a 2-entry mesh
    of this card (the bank's 4 rows in 2 blocks): decisions and floats
    equal, fleet_drift and pairwise_js launched once per block where the
    unsharded run launches once, flash_attention as often. Returns the
    mesh run's launches."""
    cfg = dataclasses.replace(get_config(ARCH), vocab_size=64)
    runs = {}
    for name, mesh in (("unsharded", None), ("mesh", card_mesh(MESH_FULL))):
        _free_device()
        sc = wtrace.golden_scenario()
        _trainer._job_counter.n = 0
        engine = SharedEngine(cfg, TrainConfig(**WINDOW_FP32), device=DEV)
        engine.bank = JobBank(engine, capacity=WINDOW_BANK)
        kw = dict(window_seconds=sc.window_seconds,
                  shared_bandwidth=sc.shared_bandwidth,
                  local_caps=sc.local_caps)
        kw.update(wtrace.GOLDEN_CONTROLLER, drift_impl="auto", shortlist_k=2)
        ctl = FRAMEWORKS["ecco"](engine, list(sc.streams),
                                 ControllerConfig(**kw), mesh=mesh)
        assert engine.bank.capacity == WINDOW_BANK
        ctl.warmup()
        _reset_window_launches()
        ms = []
        for _ in range(MESH_WINDOWS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ctl.run_window()
            torch.cuda.synchronize()
            ms.append(1e3 * (time.perf_counter() - t0))
        got = _window_launches()
        runs[name] = (list(ctl.history), got)
        print(f"[mesh] (b) {ARCH} full width fp32, {name}"
              f"{'' if mesh is None else f' ({mesh.size} entries)'}: "
              f"windows {[round(x, 1) for x in ms]} ms; launches {got}; "
              f"groups {ctl.history[-1].groups}; peak "
              f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
        del ctl, engine
    (one, l1), (sharded, lm) = runs["unsharded"], runs["mesh"]
    _mesh_history_equal(one, sharded, "[mesh] (b)")
    assert lm["flash_attention"] == l1["flash_attention"] > 0, (l1, lm)
    assert lm["fleet_drift"] == MESH_FULL * l1["fleet_drift"] > 0, (l1, lm)
    assert lm["pairwise_js"] == MESH_FULL * l1["pairwise_js"], (l1, lm)
    print(f"[mesh] (b) decisions and floats equal over {MESH_WINDOWS} "
          f"windows")
    return lm


def _mesh_controller(framework, engine, **kw):
    """tests/test_torch_elastic.py's fleet and controller, with the kernel
    routes on (drift_impl="auto", a top-2 shortlist)."""
    _trainer._job_counter.n = 0
    _, streams = make_fleet(**MESH_FLEET)
    cc = ControllerConfig(**MESH_CC, drift_impl="auto", shortlist_k=2)
    return FRAMEWORKS[framework](engine, streams, cc, seed=0, **kw)


def mesh_elastic():
    """(c) The elastic recovery of tests/test_torch_elastic.py at smoke
    width on the card with the kernel routes on, fp32 from the
    reference's initial weights: ecco on
    a 4-entry mesh of this card loses 2 entries at window 2's 4th barrier
    and re-runs on 2. Its history equals the card's unsharded run that
    never failed, exactly, and the CPU's in decisions, with accuracies
    and shares within WINDOW_ACC_GAP. Returns the elastic run's
    launches."""
    from repro_torch.distributed.elastic import FleetElastic
    init = {0: load_params_npz(WINDOW_INIT)}
    cfg = dataclasses.replace(smoke_config(ARCH), vocab_size=64)

    def engine(dev):
        return SharedEngine(cfg, TrainConfig(**WINDOW_FP32), device=dev,
                            init_params=init)
    shutil.rmtree(MESH_DIR, ignore_errors=True)
    cpu = _mesh_controller("ecco", engine(torch.device("cpu")))
    cpu.run(3)
    card = _mesh_controller("ecco", engine(DEV))
    card.run(3)
    el = FleetElastic(MESH_DIR, mesh=card_mesh(MESH_N))
    ctl = _mesh_controller("ecco", engine(DEV), elastic=el)
    _reset_window_launches()
    ctl.warmup()
    ctl.run_window()
    el.schedule_failure(MESH_FAIL[0], after_barriers=MESH_FAIL[1])
    ctl.run_window()
    ctl.run_window()
    got = _window_launches()
    shutil.rmtree(MESH_DIR, ignore_errors=True)
    assert len(el.recoveries) == 1, el.recoveries
    plan = el.recoveries[0]
    assert (plan.old_mesh_shape, plan.new_mesh_shape) == (
        (MESH_N,), (MESH_N - MESH_FAIL[0],)), plan
    assert ctl.mesh.size == ctl.engine.bank.mesh.size == MESH_N - MESH_FAIL[0]
    _mesh_history_equal(card.history, ctl.history, "[mesh] (c)")
    gap = 0.0
    for wc, wp in zip(ctl.history, cpu.history):
        assert wc.t == wp.t and wc.groups == wp.groups, (wc, wp)
        assert wc.delivered == wp.delivered
        gap = max([gap] + [abs(a - b) for a, b in zip(
            list(wc.per_stream_acc.values()) + list(wc.shares.values()),
            list(wp.per_stream_acc.values()) + list(wp.shares.values()))
            if not (math.isnan(a) and math.isnan(b))])
    assert gap <= WINDOW_ACC_GAP, gap
    assert got["flash_attention"] > 0, got
    print(f"[mesh] (c) ecco at smoke width fp32, {MESH_N} entries lose "
          f"{MESH_FAIL[0]} in the second window, at its barrier "
          f"{MESH_FAIL[1]}: "
          f"{len(el.recoveries)} recovery {plan.old_mesh_shape} -> "
          f"{plan.new_mesh_shape}; history equal to the card's run that "
          f"never failed; card vs CPU decisions equal, largest accuracy / "
          f"share gap {gap!r}; launches {got}; groups "
          f"{ctl.history[-1].groups}")
    return got


def mesh_checkpoint():
    """(d) One full-width olmo-1b job state (14.12 GB of fp32 params and
    AdamW moments) saved from its bank row, the row zeroed
    (`invalidate_device`), and restored through the bank on the card:
    every leaf equal to a fresh draw of the same seed, bit for bit. Prints
    the GB, the save and the restore seconds (the host's disk and
    np.save, not the card)."""
    from repro_torch.distributed import checkpoint as ckpt
    _free_device()
    cfg = get_config(ARCH)
    engine = SharedEngine(cfg, device=DEV)
    engine.bank = bank = JobBank(engine, capacity=1)
    req = Request(stream_id="ckpt", t=0.0, loc=(0.0, 0.0),
                  subsamples=np.zeros((1, 8), np.int64), acc=0.0)
    job = RetrainJob(engine, req, seed=0)
    gb = bank.state_row_nbytes / 1e9
    free = shutil.disk_usage(os.path.dirname(MESH_DIR)
                             if os.path.isdir(os.path.dirname(MESH_DIR))
                             else HERE).free / 1e9
    print(f"[mesh] (d) one {ARCH} job state of {gb:.2f} GB; {free:.1f} GB "
          f"free on the checkout's disk")
    shutil.rmtree(MESH_DIR, ignore_errors=True)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ckpt.save(MESH_DIR, 0, bank.row_device(job._slot.idx))
        save_s = time.perf_counter() - t0
        bank.invalidate_device()
        assert not any(bool(x.any()) for x in
                       tree_leaves(bank.row_device(job._slot.idx)))
        t0 = time.perf_counter()
        ckpt.restore_job(MESH_DIR, 0, job, devices=DEV)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(MESH_DIR, ignore_errors=True)
    assert bank._host is None           # written on the card, not the mirror
    want = engine.fresh_state(0)
    got = bank.row_device(job._slot.idx)
    same = [torch.equal(a, b) for a, b in zip(
        _trainer._flatten(got), _trainer._flatten(want))]
    assert all(same), f"{same.count(False)} leaves differ"
    print(f"[mesh] (d) {gb:.2f} GB saved in {save_s:.2f} s "
          f"({gb / save_s:.2f} GB/s), restored through the bank in "
          f"{restore_s:.2f} s ({gb / restore_s:.2f} GB/s); {len(same)} "
          f"leaves equal bit for bit")
    del job, engine, bank, want, got
    return {"gb": gb, "save_s": save_s, "restore_s": restore_s}


def mesh():
    """[mesh]: (a)-(d); returns the kernels' records and launches."""
    calls = mesh_kernels()
    launches = dict(mesh_full_width())
    for k, v in mesh_elastic().items():
        launches[k] += v
    _free_device()
    ck = mesh_checkpoint()
    _free_device()
    return calls, launches, ck


# ---------------------------------------------------------------------------
# phase 6h: distribution's model half on one card
# ---------------------------------------------------------------------------
MM_EP = 4                   # (a): model entries of the EP mesh (15 experts)
MM_TICKS = 8                # (a): decode ticks after the prefill
MM_CF, MM_NO_DROP_CF = 1.25, 16.0   # (a): 16 holds every token's pairs
MM_SEQ = 4                  # (b): sequence shards of the seqpar mesh
MM_REL = 1e-4               # (b): fp32, relative to the largest |value|
MM_LEAD = 1e-2              # (b): decode tokens held where top-1 leads
MM_SEEDED = ((256, torch.bfloat16), (256, torch.float32),
             (200, torch.bfloat16), (200, torch.float32))   # (c): S, dtype
MM_SEED_PREFIX = 128        # (c): steps whose state seeds the scan
MM_TP = 16                  # (d): starcoder2-3b's 24 heads padded to 32
MM_PODS = 2                 # (e): pod entries of the compressed mean


def card_model_mesh(shape, axes):
    """A model mesh of `shape` over `axes`, every entry this card."""
    from repro_torch.launch.mesh import make_mesh
    dev = torch.device("cuda", torch.cuda.current_device())
    return make_mesh(shape, axes, devices=[dev] * math.prod(shape))


@contextlib.contextmanager
def _ep_traces():
    """Each `apply_moe_ep` call's per-entry dispatch (its `trace`): routed
    ids, slots, keep masks and capacity, a list per call."""
    from repro_torch.models import moe
    traces, ep = [], moe.apply_moe_ep

    def record(*args, **kwargs):
        t = []
        out = ep(*args, trace=t, **kwargs)
        traces.append(t)
        return out
    moe.apply_moe_ep = record
    try:
        yield traces
    finally:
        moe.apply_moe_ep = ep


def _mm_run(model, params, x, cap, tokens=None, **kw):
    """A prefill of x and MM_TICKS decode ticks, greedy, or teacher-forced
    on `tokens` (the input of each tick). Returns (prefill last-token
    logits, each tick's logits, the ticks' input tokens, ms of the
    prefill, ms per tick) by CUDA events."""
    V = model.cfg.vocab_size
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    with torch.no_grad():
        ev[0].record()
        last, cache, pos = model.prefill(params, x, cap, **kw)
        ev[1].record()
        ticks, inputs = [], []
        tok = last[:, :V].argmax(-1, keepdim=True)
        for i in range(MM_TICKS):
            if tokens is not None:
                tok = tokens[i]
            inputs.append(tok)
            lg, cache = model.decode(params, tok, cache, pos + i, **kw)
            ticks.append(lg[:, -1])
            tok = lg[:, -1, :V].argmax(-1, keepdim=True)
        ev[2].record()
    torch.cuda.synchronize()
    return (last, ticks, inputs, ev[0].elapsed_time(ev[1]),
            ev[1].elapsed_time(ev[2]) / MM_TICKS)


def model_mesh_ep():
    """[model_mesh] (a): qwen2-moe-a2.7b at its published config, bf16
    parameters and compute as in [families], expert-parallel on a (data 1,
    model 4) mesh of this card (15 experts an entry): a FAM_PROMPT-token
    prefill and MM_TICKS decode ticks. At cf 1.25, kernel route vs
    kernel_impl="ref" (teacher-forced on the kernel route's tokens):
    prefill logits within LOGIT_TOL, and each entry's keep mask equal
    wherever the two routes routed its tokens alike (the routes that
    differ, counted). flash_attention launches held to the reckoning.
    At a cf that drops nothing, EP vs the dense dispatch: logits within
    LOGIT_TOL. ms per prefill and per tick, EP beside dense; peak memory
    beside QWEN2_FP32_GB. Returns the kernel run's launches."""
    bf16 = torch.bfloat16
    cfg = get_config(QWEN2)
    model = build_model(cfg, ep=MM_EP)
    E = model.spec["segments"][0]["moe"]["wg"].shape[1]
    # full width: 60 experts split 15 an entry, none padded
    assert E % MM_EP == 0 and E - cfg.moe.num_experts < MM_EP
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    params = model.init(seed=0, dtype=bf16, device=DEV)
    mesh = card_model_mesh((1, MM_EP), ("data", "model"))
    x = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab_size, size=(1, FAM_PROMPT)), device=DEV)
    V = cfg.vocab_size
    ep = dict(mesh=mesh, moe_impl="ep", capacity_factor=MM_CF)
    reset_launches()
    with _ep_traces() as kt:
        k_last, k_ticks, toks, _, _ = _mm_run(model, params, x, FAM_CAP,
                                              **ep)
    launches = launch_counts()
    want = expected_launches(cfg, 1, MM_TICKS)
    assert launches == want, (launches, want)
    peak = (torch.cuda.max_memory_allocated() - base) / 1e9
    with _ep_traces() as rt:
        r_last, r_ticks, _, _, _ = _mm_run(model, params, x, FAM_CAP,
                                           tokens=toks, kernel_impl="ref",
                                           **ep)
    assert len(kt) == len(rt) == cfg.num_layers * (1 + MM_TICKS)
    same = differ = 0
    for kc, rc in zip(kt, rt):
        assert len(kc) == len(rc) == MM_EP
        for a, b in zip(kc, rc):
            assert a["capacity"] == b["capacity"]
            if torch.equal(a["ids"], b["ids"]):
                assert torch.equal(a["keep"], b["keep"]) and torch.equal(
                    a["slot"], b["slot"]), "keep masks differ on equal routes"
                same += 1
            else:
                differ += 1
    dropped = sum(int((~e["keep"]).sum()) for e in kt[0])
    err = float((k_last[:, :V].float() - r_last[:, :V].float()).abs().max())
    tick_err = max(float((a[:, :V].float() - b[:, :V].float()).abs().max())
                   for a, b in zip(k_ticks, r_ticks))
    C = kt[0][0]["capacity"]
    print(f"[model_mesh] (a) {QWEN2} EP on (data 1, model {MM_EP}) of this "
          f"card, cf {MM_CF} (capacity {C} per expert and source entry): "
          f"prefill logits kernel vs plain max_abs_err={err:.4e} tol="
          f"{LOGIT_TOL}; ticks {tick_err:.4e}; keep masks equal on all "
          f"{same} (call, layer, entry) dispatches whose routes agree, "
          f"routes differ on {differ}; {dropped} (token, k) pairs of layer "
          f"0's prefill dropped; launches {launches}")
    assert err <= LOGIT_TOL, err
    # EP vs the dense dispatch at a cf that drops nothing
    nd = dict(mesh=mesh, capacity_factor=MM_NO_DROP_CF)
    e_last, e_ticks, _, _, _ = _mm_run(model, params, x, FAM_CAP,
                                       moe_impl="ep", **nd)
    d_last, d_ticks, _, _, _ = _mm_run(model, params, x, FAM_CAP,
                                       tokens=toks, moe_impl="dense", **nd)
    nd_err = float((e_last[:, :V].float() - d_last[:, :V].float())
                   .abs().max())
    print(f"[model_mesh] (a) cf {MM_NO_DROP_CF} (no drops): EP vs dense "
          f"dispatch prefill logits max_abs_err={nd_err:.4e} tol="
          f"{LOGIT_TOL}")
    assert nd_err <= LOGIT_TOL, nd_err
    times = {}
    for impl in ("ep", "dense"):
        kw = dict(mesh=mesh, moe_impl=impl, capacity_factor=MM_CF)
        _mm_run(model, params, x, FAM_CAP, **kw)               # warm
        runs = [_mm_run(model, params, x, FAM_CAP, **kw)[3:]
                for _ in range(2)]
        times[impl] = (min(r[0] for r in runs), min(r[1] for r in runs))
    print(f"[model_mesh] (a) ms per {FAM_PROMPT}-token prefill / per tick "
          f"(batch 1, best of 2, CUDA events): EP {times['ep'][0]:.2f} / "
          f"{times['ep'][1]:.2f}, dense {times['dense'][0]:.2f} / "
          f"{times['dense'][1]:.2f}; peak device memory over the init and "
          f"the EP run {peak:.2f} GB (from {base / 1e9:.2f} GB) beside "
          f"{QWEN2_FP32_GB} GB of fp32 parameters "
          f"({model.num_params() * 2 / 1e9:.2f} GB in bf16)")
    return launches


def _rel(a, b):
    """max |a - b| over max |b|."""
    a, b = a.float(), b.float()
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)


def model_mesh_seqpar():
    """[model_mesh] (b): xlstm-350m at its published config, fp32, the
    prefill of an XL_PROMPT-token prompt with ssm_impl="seqpar" on a
    (model 4) mesh of this card (shards of 256 steps, 4 chunks of 64) vs
    the unsharded prefill: last logits and every mLSTM layer's C, n (in
    the invariant frame of the larger m), m and conv within MM_REL of the
    largest value; the sLSTM caches likewise; then MM_TICKS decode ticks
    from each cache, teacher-forced on the unsharded run's tokens, equal
    in top-1 wherever the unsharded top-1 leads by more than MM_LEAD.
    mlstm_scan launches 12 layers x 4 entries x 2 passes. Returns them."""
    f32 = torch.float32
    cfg = get_config(XLSTM)
    model = build_model(cfg)
    params = model.init(seed=0, device=DEV)
    mesh = card_model_mesh((MM_SEQ,), ("model",))
    x = torch.as_tensor(np.random.default_rng(3).integers(
        0, cfg.vocab_size, size=(1, XL_PROMPT)), device=DEV)
    kw = dict(compute_dtype=f32, cache_dtype=f32)
    cap = XL_PROMPT + MM_TICKS
    layers = sum(s.count for s in layer_plan(cfg) if s.kind == "mlstm")
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    with torch.no_grad():
        reset_launches()
        ev[0].record()
        l1, c1, p1 = model.prefill(params, x, cap, mesh=mesh,
                                   ssm_impl="seqpar", **kw)
        ev[1].record()
        torch.cuda.synchronize()
        launches = launch_counts()
        l0, c0, p0 = model.prefill(params, x, cap, **kw)
        ev[2].record()
    torch.cuda.synchronize()
    assert launches["mlstm_scan"] == layers * MM_SEQ * 2, launches
    assert p0 == p1 == XL_PROMPT
    errs = {"logits": _rel(l1, l0)}
    for i, (s0, s1) in enumerate(zip(c0["segments"], c1["segments"])):
        if "C" in s0:
            M = torch.maximum(s0["m"], s1["m"])
            w0, w1 = torch.exp(s0["m"] - M), torch.exp(s1["m"] - M)
            pairs = {"C": (s1["C"] * w1[..., None, None],
                           s0["C"] * w0[..., None, None]),
                     "n": (s1["n"] * w1[..., None], s0["n"] * w0[..., None]),
                     "m": (s1["m"], s0["m"]), "conv": (s1["conv"], s0["conv"])}
        else:
            pairs = {k: (s1[k], s0[k]) for k in s0}
        for k, (a, b) in pairs.items():
            errs[f"seg{i}.{k}"] = _rel(a, b)
    worst = max(errs, key=errs.get)
    V = cfg.vocab_size
    held = 0
    with torch.no_grad():
        tok = l0[:, :V].argmax(-1, keepdim=True)
        for i in range(MM_TICKS):
            d0, c0 = model.decode(params, tok, c0, p0 + i, compute_dtype=f32)
            d1, c1 = model.decode(params, tok, c1, p1 + i, compute_dtype=f32)
            top = d0[0, -1, :V].float().topk(2).values
            if float(top[0] - top[1]) > MM_LEAD:
                assert int(d1[0, -1, :V].argmax()) == \
                    int(d0[0, -1, :V].argmax()), i
                held += 1
            tok = d0[:, -1, :V].argmax(-1, keepdim=True)
    print(f"[model_mesh] (b) {XLSTM} seqpar prefill on (model {MM_SEQ}) of "
          f"this card, fp32, S {XL_PROMPT}: {launches['mlstm_scan']} "
          f"mlstm_scan launches ({layers} layers x {MM_SEQ} entries x 2 "
          f"passes); vs unsharded: logits rel err {errs['logits']:.3e}, "
          f"worst cache leaf {worst} {errs[worst]:.3e} (tol {MM_REL}); "
          f"{held} of {MM_TICKS} decode tokens held (top-1 lead > "
          f"{MM_LEAD}); ms seqpar {ev[0].elapsed_time(ev[1]):.1f}, "
          f"unsharded {ev[1].elapsed_time(ev[2]):.1f}")
    assert max(errs.values()) <= MM_REL, errs
    return launches["mlstm_scan"]


def _mlstm_seed(B, H, P, dtype, gen):
    """A real state to start from: the token-by-token recurrence's over
    MM_SEED_PREFIX steps of fresh inputs."""
    args = _mlstm_inputs(B, MM_SEED_PREFIX, H, P, dtype, gen)
    return mlstm_recurrent(*args, return_state=True)[1]


def model_mesh_seeded():
    """[model_mesh] (c): the seeded mlstm_scan at (1, S, 4, 512), S 256
    and a ragged 200, bf16 (the tensor-core path) and fp32 (the CUDA-core
    kernel), from the recurrence's state over MM_SEED_PREFIX steps: h
    and the final state vs `mlstm_recurrent(init_state=...)` and h vs
    `mlstm_chunked(init_state=...)` within TOL. Without a state, and
    with the zero state given, each path gives the same results bit for
    bit. Returns the largest error vs the oracle."""
    gen = torch.Generator(device=DEV).manual_seed(24)
    worst = 0.0
    for S, dtype in MM_SEEDED:
        shape = (1, S, XL_HEADS, XL_P)
        args = _mlstm_inputs(*shape, dtype, gen)
        seed = _mlstm_seed(1, XL_HEADS, XL_P, dtype, gen)
        path = ml_plan(*args[:3], MLSTM_CHUNK)
        assert path == (ML_TENSOR_CORE if dtype == torch.bfloat16
                        else ML_CUDA_CORE)
        h, st = mlstm_scan(*args, chunk=MLSTM_CHUNK, init_state=seed,
                           return_state=True)
        rh, rst = mlstm_recurrent(*args, init_state=seed, return_state=True)
        ch = mlstm_chunked(*args, chunk=MLSTM_CHUNK, init_state=seed)
        name = f"mlstm_scan seeded {str(dtype)[6:]} {shape}"
        errs = [_check(f"{name} h vs token-by-token oracle", h, rh,
                       TOL[dtype]),
                _check(f"{name} h vs chunked", h, ch, TOL[dtype])]
        errs += [_check(f"{name} state {leaf} vs token-by-token oracle", a,
                        w, TOL[dtype]) for leaf, a, w in zip("Cnm", st, rst)]
        worst = max(worst, *errs)
        zero = (torch.zeros_like(seed[0]), torch.zeros_like(seed[1]),
                torch.full_like(seed[2], -math.inf))
        h0, st0 = mlstm_scan(*args, chunk=MLSTM_CHUNK, return_state=True)
        hz, stz = mlstm_scan(*args, chunk=MLSTM_CHUNK, init_state=zero,
                             return_state=True)
        assert torch.equal(h0, hz) and all(
            torch.equal(a, b) for a, b in zip(st0, stz)), name
        print(f"[check] {name}: no state and the zero state bit for bit "
              f"equal ok")
    return worst


def model_mesh_tp():
    """[model_mesh] (d): starcoder2-3b at its published config built at
    tp = 16: its 24 heads padded per kv group to 32 over 2 kv heads (GQA
    group 16), bf16. A FAM_PROMPT-token prefill, kernel vs plain route,
    last-token logits within LOGIT_TOL, one flash_attention launch a
    layer; layer 0's attention: the padded heads' raw outputs nonzero,
    masked to zero. Returns the launches."""
    bf16 = torch.bfloat16
    cfg = get_config("starcoder2-3b")
    model = build_model(cfg, tp=MM_TP)
    params = model.init(seed=0, dtype=bf16, device=DEV)
    assert params["segments"][0]["attn"]["wq"].shape[2] == 32
    x = torch.as_tensor(np.random.default_rng(4).integers(
        0, cfg.vocab_size, size=(1, FAM_PROMPT)), device=DEV)
    V = cfg.vocab_size
    with torch.no_grad():
        reset_launches()
        got, _, _ = model.prefill(params, x, FAM_CAP)
        torch.cuda.synchronize()
        launches = launch_counts()
        want, _, _ = model.prefill(params, x, FAM_CAP, kernel_impl="ref")
        assert launches == expected_launches(cfg, 1, 0), launches
        seg = params["segments"][0]
        lp = {k: tree_map(lambda t: t[0], seg[k]) for k in ("ln1", "attn")}
        h = L.apply_norm(cfg, lp["ln1"], L.embed_tokens(params["embed"], x,
                                                        bf16))
        pos = torch.arange(FAM_PROMPT, device=DEV)[None]
        q, k, v = L._qkv(cfg, lp["attn"], h, pos)
        o = flash_attention(q, k, v, causal=True)
        pad = ~L.head_mask(cfg, 32, torch.float32, DEV).bool()
        masked = L._mask_heads(cfg, o)
    err = float((got[:, :V].float() - want[:, :V].float()).abs().max())
    raw = float(o[:, :, pad].float().abs().max())
    assert int(pad.sum()) == 8 and raw > 0
    assert bool((masked[:, :, pad] == 0).all())
    print(f"[model_mesh] (d) starcoder2-3b at tp {MM_TP}: 32 q heads (8 "
          f"padded) over 2 kv heads; prefill logits kernel vs plain "
          f"max_abs_err={err:.4e} tol={LOGIT_TOL}; {launches['flash_attention']}"
          f" flash_attention launches; layer 0's padded heads: raw output "
          f"max |o| {raw:.3f}, masked to 0")
    assert err <= LOGIT_TOL, err
    return launches["flash_attention"]


def model_mesh_compression():
    """[model_mesh] (e): `pod_mean_compressed` over a 2-entry pod axis of
    this card on a gradient tree of olmo-1b's shapes (normal draws, fp32,
    4.71 GB), equal to the CPU's bit for bit; GB/s of gradient reduced
    (CUDA events, best of 2)."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.train.compression import pod_mean_compressed
    spec = build_model(get_config(ARCH)).spec
    gen = torch.Generator(device=DEV).manual_seed(25)
    grads = tree_map(lambda s: torch.randn(s.shape, generator=gen,
                                           device=DEV) * 1e-3, spec)
    nbytes = sum(g.numel() * 4 for g in tree_leaves(grads))
    mesh = card_model_mesh((MM_PODS,), ("pod",))
    out = pod_mean_compressed(grads, mesh)
    ms = []
    for _ in range(2):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        pod_mean_compressed(grads, mesh)
        ev[1].record()
        torch.cuda.synchronize()
        ms.append(ev[0].elapsed_time(ev[1]))
    host = tree_map(lambda g: g.cpu(), grads)
    del grads
    cpu = pod_mean_compressed(host, make_mesh(
        (MM_PODS,), ("pod",), devices=["cpu"] * MM_PODS))
    for a, b in zip(tree_leaves(out), tree_leaves(cpu)):
        assert torch.equal(a.cpu(), b), "card and CPU differ"
    print(f"[model_mesh] (e) pod_mean_compressed (int8) over {MM_PODS} pod "
          f"entries of this card, {ARCH}'s gradient shapes "
          f"({nbytes / 1e9:.2f} GB fp32): equal to the CPU's bit for bit; "
          f"{min(ms):.1f} ms, {nbytes / min(ms) / 1e6:.1f} GB/s")


def model_mesh():
    """[model_mesh]: (a)-(e); returns (flash_attention launches of (a) and
    (d), mlstm_scan launches of (b), (c)'s largest error)."""
    _free_device()
    ep = model_mesh_ep()
    _free_device()
    seqpar = model_mesh_seqpar()
    _free_device()
    seeded = model_mesh_seeded()
    tp = model_mesh_tp()
    _free_device()
    model_mesh_compression()
    _free_device()
    return ep["flash_attention"] + tp, seqpar, seeded


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
                   pk, causal=True):
    """Attention as serving calls it, by the kernel, the plain version
    and SDPA (the yardstick the port never calls) on the same inputs: per
    call (CUDA events) and on the device (the kernels of the path `plan`
    picks, every kernel SDPA launches). SDPA's causal mask is aligned
    top-left, so a decode row (S = 1, every key visible) calls it without
    one; so does a non-causal encode (`causal` False)."""
    path = fa_plan(*sets[0]).path

    def kern(q, k, v):
        return flash_attention(q, k, v, causal=causal)

    def plain(q, k, v):
        return attention_ref(q, k, v, causal=causal)

    def lib(q, k, v):
        return F.scaled_dot_product_attention(q, k, v, is_causal=prefill)

    bound = _bound(nbytes, flops, dtype, pk)
    return dict(
        shape=f"{shape} [{path}]", path=path,
        ms=_time_ms(kern, sets),
        device_ms=_device_ms(kern, sets, FA_KERNELS[path],
                             bound_ms=bound[0]),
        plain_ms=_time_ms(plain, sets),
        library_ms=_time_ms(lib, sdpa_sets),
        library_device_ms=_device_ms(lib, sdpa_sets, bound_ms=bound[0]),
        bound=bound)


def time_attention(pk):
    """flash_attention at the four bf16 serving shapes (olmo and hymba,
    prefill and decode), the two fp32 ones (olmo prefill in fp32, and
    fp32 q over olmo's bf16 cache) and the fleet tick's two (olmo's and
    hymba's 32 lanes over the whole pool with ragged lengths), rotating
    6-8 input sets so that L2 does not hold them. SDPA gets q, k, v in its (B, H, S, hd) layout,
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

    def prefill(name, S, H, K, hd, dtype, B=1):
        sets = [(_randn((B, S, H, hd), dtype, gen),
                 _randn((B, S, K, hd), dtype, gen),
                 _randn((B, S, K, hd), dtype, gen)) for _ in range(8)]
        el = sets[0][0].element_size()
        pairs = S * (S + 1) // 2                  # visible (query, key)
        rows[name] = _attention_row(
            f"q ({B},{S},{H},{hd}), k,v ({B},{S},{K},{hd}) "
            f"{str(dtype)[6:]} causal", sets, sdpa(sets, H // K), True,
            2 * B * S * (H + K) * hd * el, 4 * B * H * pairs * hd, dtype, pk)

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

    def ragged(name, cap, H, K, hd):
        """The fleet tick's decode: FLEET_SLOTS lanes over the whole pool,
        one set of ragged lengths for every input set. Bytes: q, o and
        each lane's lengths[b] K/V rows; operations over those keys. SDPA
        gets a boolean mask of each lane's keys."""
        B = FLEET_SLOTS
        n = ragged_lengths(B, cap, gen)
        keys = int(n.sum())
        sets = [(_randn((B, 1, H, hd), bf16, gen),
                 _randn((B, cap, K, hd), bf16, gen),
                 _randn((B, cap, K, hd), bf16, gen)) for _ in range(6)]
        assert fa_plan(*sets[0]).path == "split_decode"
        mask = (torch.arange(cap, device=DEV)[None] < n[:, None])[:, None,
                                                                   None]
        lib_sets = [tuple(t.repeat_interleave(H // K if i else 1, 2)
                          .transpose(1, 2).contiguous()
                          for i, t in enumerate(st)) for st in sets]

        def kern(q, k, v):
            return flash_attention(q, k, v, lengths=n)

        def plain(q, k, v):
            return attention_ref(q, k, v, lengths=n)

        def lib(q, k, v):
            return F.scaled_dot_product_attention(q, k, v, attn_mask=mask)

        bound = _bound(2 * B * H * hd * 2 + 4 * B + 2 * keys * K * hd * 2,
                       4 * H * keys * hd, bf16, pk)
        rows[name] = dict(
            shape=f"q ({B},1,{H},{hd}) bf16 over bf16 k,v ({B},{cap},{K},"
                  f"{hd}), lengths {int(n.min())}..{int(n.max())} ({keys} "
                  f"keys) [split_decode]",
            path="split_decode", ms=_time_ms(kern, sets),
            device_ms=_device_ms(kern, sets, FA_KERNELS["split_decode"],
                                 bound_ms=bound[0]),
            plain_ms=_time_ms(plain, sets, iters=10),
            library_ms=_time_ms(lib, lib_sets),
            library_device_ms=_device_ms(lib, lib_sets, bound_ms=bound[0]),
            bound=bound)

    def encode(name, B, S, H, hd):
        """A non-causal prefill of B sequences (hubert's encode): every
        (query, key) pair of a sequence visible."""
        sets = [tuple(_randn((B, S, H, hd), bf16, gen) for _ in range(3))
                for _ in range(6)]
        rows[name] = _attention_row(
            f"q, k, v ({B},{S},{H},{hd}) bf16 non-causal", sets,
            sdpa(sets), False, 4 * B * S * H * hd * 2,
            4 * B * H * S * S * hd, bf16, pk, causal=False)

    prefill("prefill", PROMPT, 16, 16, 128, bf16)
    decode("decode", DECODE_T, CAP, 16, 16, 128, bf16)
    prefill("hymba_prefill", HY_S, 25, 5, 64, bf16)
    decode("hymba_decode", HY_DECODE_T, HY_CAP, 25, 5, 64, bf16)
    prefill("prefill_fp32", PROMPT, 16, 16, 128, f32)
    decode("decode_fp32_q", DECODE_T, CAP, 16, 16, 128, f32)
    ragged("decode_ragged", CAP, 16, 16, 128)
    ragged("hymba_decode_ragged", HY_CAP, 25, 5, 64)
    # [families] (a): qwen2-moe-a2.7b's attention is olmo-1b's shape
    # (16 heads of 128, 512-token prompts, 4 slots of 1024), timed again
    # under its own name; hubert-xlarge's encode
    prefill("qwen2moe_prefill", SERVING[QWEN2]["prompt"], 16, 16, 128, bf16)
    decode("qwen2moe_decode", DECODE_T, SERVING[QWEN2]["capacity"], 16, 16,
           128, bf16)
    encode("hubert_encode", HU_FRAMES[0], HU_FRAMES[1], 16, 80)
    # [model_mesh] (d): starcoder2-3b at tp 16, 32 padded q heads over 2 kv
    # heads (GQA group 16); the window loop's fp32 eval forward of olmo-1b
    # (128 members' 32-token rows, the CUDA-core kernel)
    prefill("starcoder2_tp16_prefill", FAM_PROMPT, 32, 2, 128, bf16)
    prefill("window_eval_fp32", 32, 16, 16, 128, f32, B=128)
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


def mlstm_cost(B, S, H, P, Q, el=2, seeded=False):
    """(bytes, operations) the mLSTM scan must move and do at these
    shapes in an `el`-byte dtype (bf16 by default) with the state out: q,
    k, v and the two gates read once, h and the fp32 state (C, n, m)
    written once, and with `seeded` the fp32 initial state read once; per
    chunk of L steps and head, the causal q k^T and w v triangles
    (L (L + 1) / 2 P multiply-adds each), q C^T and the state update
    (L P^2 each), q . n and the normaliser update (L P each), an
    exponential counted as nothing."""
    nbytes = el * (4 * B * S * H * P + 2 * B * S * H) + 4 * B * H * (
        P * P + P + 1) * (2 if seeded else 1)
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
    PR 14's kernel was held to. Then the same beside it for the seqpar
    output pass ([model_mesh] (c): (1, 256, 4, 512) from an initial
    state, bf16 and fp32, the state read once more) and the metered
    window's xlstm eval forwards ((128, 32, 4, 512): bf16 screens on the
    tensor cores, fp32 rescores on the CUDA-core kernel)."""
    bf16, f32 = torch.bfloat16, torch.float32
    gen = torch.Generator(device=DEV).manual_seed(10)

    def row(B, S, dtype, seeded=False, n_sets=10):
        H, P, Q = XL_HEADS, XL_P, MLSTM_CHUNK
        sets = [_mlstm_inputs(B, S, H, P, dtype, gen) for _ in range(n_sets)]
        seeds = [_mlstm_seed(B, H, P, dtype, gen) if seeded else None
                 for _ in range(n_sets)]
        sets = [a + (st,) for a, st in zip(sets, seeds)]
        path = ml_plan(*sets[0][:3], min(Q, S))
        assert path == (ML_TENSOR_CORE if dtype == bf16 else ML_CUDA_CORE)
        nbytes, flops = mlstm_cost(B, S, H, P, Q,
                                   el=torch.finfo(dtype).bits // 8,
                                   seeded=seeded)
        bound = _bound(nbytes, flops, dtype, pk)

        def kern(*a):
            return mlstm_scan(*a[:5], chunk=Q, init_state=a[5],
                              return_state=True)

        def plain(*a):
            return mlstm_chunked(*a[:5], chunk=Q, init_state=a[5],
                                 return_state=True)

        return dict(shape=f"q,k,v ({B},{S},{H},{P}) {str(dtype)[6:]}, chunk "
                          f"{min(Q, S)}, state out"
                          f"{', from an initial state' if seeded else ''}",
                    ms=_time_ms(kern, sets),
                    device_ms=_device_ms(kern, sets, ML_TC_KERNELS
                                         if path == ML_TENSOR_CORE
                                         else ML_CC_KERNELS,
                                         bound_ms=bound[0]),
                    plain_ms=_time_ms(plain, sets, iters=10),
                    library_ms=None, bound=bound,
                    bound_cuda_core=_bound(nbytes, flops, f32, pk),
                    nbytes=nbytes, flops=flops)

    r = row(1, XL_PROMPT, bf16)
    bcc, bycc = r["bound_cuda_core"]
    print(f"[time] mlstm_scan least work: {r['nbytes'] / 1e6:.2f} MB, "
          f"{r['flops'] / 1e9:.3f} GFLOP; bound on bf16 tensor cores "
          f"{r['bound'][0]:.4f} ms ({r['bound'][1]}), on fp32 CUDA cores "
          f"{bcc:.4f} ms ({bycc}, kernel at {100 * bcc / r['device_ms']:.1f}% "
          f"of it)")
    _print_time("mlstm_scan", r)
    for name, args in (("seeded", (1, 256, bf16, True)),
                       ("seeded_fp32", (1, 256, f32, True)),
                       ("metered_eval", (128, 32, bf16, False, 4)),
                       ("metered_eval_fp32", (128, 32, f32, False, 4))):
        r[name] = row(*args)
        _print_time(f"mlstm_scan {name}", r[name])
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
    kernels = run_phases(pk)
    print(f"[env] chip_smoke ran {time.perf_counter() - t_start:.1f}s after "
          f"start-up")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card,
        "count": torch.cuda.device_count()}}))


def run_phases(pk):
    """Every phase after the build; returns the kernels' JSON entries."""
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
    xl = phase(f"serve {XLSTM}", serve_full_width, XLSTM, XL_REQUESTS)
    # 12 mLSTM blocks, each through the kernel once per prefill
    assert xl == {"flash_attention": 0, "flash_attention_combine": 0,
                  "ssd_scan": 0, "mlstm_scan": 12 * XL_REQUESTS}, xl
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
    phase("meter smoke", meter_smoke)
    meter = phase(f"meter {ARCH} + {XLSTM}", meter_full_width)
    torch.cuda.empty_cache()
    phase("meter launcher", meter_launcher)
    torch.cuda.empty_cache()
    fleet = phase(f"fleet {ARCH}", fleet_full_width)
    torch.cuda.empty_cache()
    phase("fleet smoke", fleet_smoke)
    torch.cuda.empty_cache()
    fam = phase("families", families)
    fam_large = phase("families (e)", families_large)
    _free_device()
    mesh_calls, mesh_launches, mesh_ckpt = phase("mesh", mesh)
    mm_flash, mm_mlstm, mm_seeded_err = phase("model_mesh", model_mesh)
    torch.cuda.empty_cache()
    phase("remat", remat_full_width)
    phase("dryrun", dryrun_cells)
    dry_flash = phase("dryrun card cell", dryrun_card_cell, pk)
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
                    decode_fp32_q=att["decode_fp32_q"],
                    decode_ragged=att["decode_ragged"],
                    hymba_decode_ragged=att["hymba_decode_ragged"],
                    qwen2moe_prefill=att["qwen2moe_prefill"],
                    qwen2moe_decode=att["qwen2moe_decode"],
                    hubert_encode=att["hubert_encode"],
                    starcoder2_tp16_prefill=att["starcoder2_tp16_prefill"],
                    window_eval_fp32=att["window_eval_fp32"]),
             combine_launches=launches["flash_attention_combine"],
             hymba_launches=hymba["flash_attention"],
             hymba_combine_launches=hymba["flash_attention_combine"],
             train_eval_launches=train_eval,
             window_launches=window["flash_attention"],
             meter_launches=meter["flash_attention"],
             fleet_launches=fleet[0], fleet_combine_launches=fleet[1],
             families_launches=fam[0], families_combine_launches=fam[1],
             families_large_launches=fam_large[0],
             families_large_combine_launches=fam_large[1],
             dryrun_cell_launches=dry_flash,
             mesh_launches=mesh_launches["flash_attention"],
             model_mesh_launches=mm_flash,
             tensor_core_hmma=hmma),
        dict(_entry("fleet_drift", *src["fleet_drift"],
                    launches["fleet_drift"], err["fleet_drift"], fd),
             window_launches=window["fleet_drift"],
             meter_launches=meter["fleet_drift"],
             mesh_launches=mesh_launches["fleet_drift"],
             mesh_call=mesh_calls["fleet_drift"]),
        dict(_entry("pairwise_js", *src["pairwise_js"],
                    launches["pairwise_js"], err["pairwise_js"], pj[1],
                    requests_32=pj[32]),
             storm_full_uploads=storm["full_uploads"],
             storm_rows_uploaded=storm["rows_uploaded"],
             window_launches=window["pairwise_js"],
             meter_launches=meter["pairwise_js"],
             mesh_launches=mesh_launches["pairwise_js"],
             mesh_call_rows=mesh_calls["pairwise_js"]["rows"],
             mesh_call_cols=mesh_calls["pairwise_js"]["cols"]),
        dict(_entry("ssd_scan", *src["ssd_scan"], launches["ssd_scan"],
                    err["ssd_scan"], ssd),
             bound_cuda_core_ms=ssd["bound_cuda_core"][0]),
        dict(_entry("mlstm_scan", *src["mlstm_scan"], launches["mlstm_scan"],
                    err["mlstm_scan"], ml, seeded=ml["seeded"],
                    seeded_fp32=ml["seeded_fp32"],
                    metered_eval=ml["metered_eval"],
                    metered_eval_fp32=ml["metered_eval_fp32"]),
             bound_cuda_core_ms=ml["bound_cuda_core"][0],
             meter_launches=meter["mlstm_scan"],
             model_mesh_launches=mm_mlstm,
             seeded_max_abs_err=mm_seeded_err),
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
    print(f"[mesh] checkpoint of one {ARCH} job: {mesh_ckpt}")
    return kernels


if __name__ == "__main__":
    main()
