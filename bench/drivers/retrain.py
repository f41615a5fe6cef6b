"""ECCO's retraining window at full width: `ECCOController.run_window`
over drifting camera fleets, episode after episode.

An episode is a fresh controller and JobBank on the one warm
`SharedEngine`, over a drift_wave fleet (`bench/core/scenario.py`) placed
from one of the mix's scenario seeds; it runs `windows_per_episode`
windows. The run replays the mix's fixed set of scenarios, in an order the
run's seed draws, until the measured time is spent, and finishes the
episode it is in, so that every run does the same work. `window_ms` is the
whole measured time over the windows it holds (episode resets included).

The jobs start from weights made from the seed: the engine's
`fresh_state` hands every new job that one device tree with zeroed AdamW
moments (`init_opt_state`), where the program's own path would draw
`init_state` or copy its `init_params` host arrays to the card per job
(PERF.md says what this takes out of the window). Set-up runs one episode
of its own (`warm_scenario`), which builds every kernel and shape, and in
which the first job's first three train steps are read for the check; the
first job of the first timed episode in which it reaches three steps is
read the same way.

What decides `correct`:
* drift: every window's triggers, those of the program's fleet screen
  against the float64 host reference on the same tokens;
* training: the two probed jobs' first three steps (loss, each layer
  leaf's gradient as the optimizer got it, each leaf's change after three
  steps) against the float32 reference trainer from the same weights on
  the same rows; and every row they trained on traced back to a camera's
  draw;
* evals: the run's last eval forwards (the final metrics pass): the
  logits the program computed, and each hit it reported, against the
  reference's float32 logits from the same parameters on the same tokens;
* grouping: every Jensen-Shannon score matrix of the shortlist
  (`pairwise_js`) against the float64 host reference on the same
  histograms;
* allocation: every window's Alg. 1 gains, picks and shares, replayed on
  the accuracies the program measured (`bench/reference/alloc.py`).
"""
from __future__ import annotations

import contextlib
import gc
import math
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from bench.core import device as D
from bench.core import scenario as S
from bench.core import trace as T
from bench.core import weights as W
from bench.core import yardstick as Y
from bench.core.record import Check, Run
from bench.reference import alloc as ref_alloc
from bench.reference import drift as ref_drift
from bench.reference import model as ref
from bench.reference import train as ref_train

F32 = torch.float32


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


class Probe:
    """Readings of one job's first three train steps, taken in set-up:
    the rows of each step, its loss, each layer leaf's norm of the first
    moment after step one (the clipped gradient times 1 - b1), and each
    leaf's change from the initial weights after step three."""

    STEPS = 3

    def __init__(self, engine, init, b1: float):
        self.init, self.b1 = init, b1
        self.reset()
        self._wrap(engine)

    def reset(self, streams=()):
        """Forget what was read: the next job trained is probed. `streams`
        are the cameras of the episode it belongs to."""
        self.job: Optional[str] = None
        self.active = False
        self.steps = 0
        self.rows: List[np.ndarray] = []
        self.losses: List[float] = []
        self.grad: Dict[str, float] = {}
        self.gnorm = math.nan
        self.change: Dict[str, float] = {}
        self.streams = list(streams)

    @property
    def done(self) -> bool:
        return self.steps >= self.STEPS

    def _wrap(self, engine):
        job_scalar, step = engine._train_job_scalar, engine._train

        def probed_job(job, toks):
            if self.job is None:
                self.job = job.job_id
            self.active = job.job_id == self.job and not self.done
            try:
                return job_scalar(job, toks)
            finally:
                self.active = False

        def probed_step(state, batch):
            out = step(state, batch)
            if not self.active or self.done:
                return out
            self.steps += 1
            st, met = out
            self.rows.append(batch["inputs"].cpu().numpy())
            self.losses.append(float(met["loss"]))
            with torch.no_grad():
                if self.steps == 1:
                    self.gnorm = float(met["grad_norm"])
                    self.grad = {n: float(x.norm()) / (1 - self.b1)
                                 for n, x in ref_train.layer_leaves(
                                     st["opt"]["mu"])}
                if self.steps == self.STEPS:
                    # leaf by leaf, so that no second copy of the
                    # parameters is made
                    self.change = {
                        n: float((a.to(F32) - b.to(F32)).norm())
                        for (n, a), (_, b) in zip(
                            ref_train.layer_leaves(st["params"]),
                            ref_train.layer_leaves(self.init))}
            return out
        engine._train_job_scalar = probed_job
        engine._train = probed_step
        self._undo = lambda: (
            setattr(engine, "_train_job_scalar", job_scalar),
            setattr(engine, "_train", step))

    def remove(self):
        self._undo()


class Episodes:
    """The engine, the camera bank, and the controller of each episode."""

    def __init__(self, cell, seed: int, dev, trace: bool):
        from repro_torch.configs.base import TrainConfig
        from repro_torch.core.trainer import SharedEngine
        from repro_torch.train.optimizer import init_opt_state
        self.cfg, self.tr, self.dev = cell.config, cell.traffic, dev
        tr = self.tr
        mcfg = D.model_config(self.cfg)
        self.spec = W.spec_of(mcfg)
        self.engine = SharedEngine(mcfg, TrainConfig(**tr["train"]),
                                   device=dev)
        self.init = W.make(self.spec, weight_seed(seed), dev)
        init = self.init
        # every job starts from the benchmark's weights
        self.engine.fresh_state = lambda seed=0: {
            "params": init, "opt": init_opt_state(init)}
        self.bank = S.DomainBank(self.cfg["vocab_size"],
                                 int(tr["num_domains"]),
                                 dim=int(tr["domain_dim"]),
                                 seed=int(tr["bank_seed"]))
        self.seed = seed
        self.ctl = None
        self.streams: List[S.Stream] = []
        # drift screen calls: (stream ids, tokens, triggers), and each
        # episode's reference tokens
        self.observed: List[tuple] = []
        self.references: Dict[str, np.ndarray] = {}
        self.spans = T.Spans() if trace else None
        self.rec = T.Recorder() if trace else None
        self.flops = 0.0
        # the eval forwards since the last train call: (params, tokens,
        # hits, precision, logits); their params are still those they
        # scored
        self.evals: List[tuple] = []
        self.warm_streams: List[S.Stream] = []
        # the shortlist's score matrices: (requests, signatures, scores)
        self.shortlists: List[tuple] = []
        # Alg. 1's windows: (members, window_micro, gain calls, order,
        # shares)
        self.allocations: List[tuple] = []
        self._wrap_engine()

    def _wrap_engine(self):
        from repro_torch.kernels import ops
        eng = self.engine
        fwd, train = eng._forward_hits, eng.train_micro_many
        apply, pjs = eng.model.apply, ops.pairwise_js
        cfg = self.cfg
        captured: List[torch.Tensor] = []

        def span(label):
            return (self.spans(label) if self.spans is not None
                    else contextlib.nullcontext())

        def capturing_apply(*a, **k):
            out = apply(*a, **k)
            captured.append(out[0])
            return out

        def recorded_forward(params, toks, precision):
            captured.clear()
            eng.model.apply = capturing_apply
            try:
                with span("bench.eval"):
                    hits = fwd(params, toks, precision)
            finally:
                eng.model.apply = apply
            logits = captured[-1] if captured else None
            captured.clear()
            self.evals.append((params, toks, hits, precision, logits))
            del self.evals[:-int(self.tr["check_evals"])]
            if self.rec is not None and self.rec.on:
                self.flops += Y.forward_flops(cfg, *toks.shape)
            return hits

        def recorded_train(jobs):
            if self.rec is not None and self.rec.on:
                mc = self.tr["controller"]
                n = sum(1 for j in jobs if len(j.pool))
                self.flops += 3 * n * mc["micro_steps"] * Y.forward_flops(
                    cfg, mc["train_batch"], mc["seq_len"])
            self.evals.clear()
            with span("bench.train"):
                return train(jobs)
        def recorded_js(p, q, **kw):
            d = pjs(p, q, **kw)
            if isinstance(q, torch.Tensor):
                self.shortlists.append((p.detach().clone(),
                                        q.detach().clone(),
                                        d.detach().clone()))
            return d
        eng._forward_hits = recorded_forward
        eng.train_micro_many = recorded_train
        ops.pairwise_js = recorded_js
        self._undo_js = lambda: setattr(ops, "pairwise_js", pjs)
        if self.rec is not None:
            self.rec.install()

    def start(self, scenario_seed: int):
        """A fresh bank and controller over the scenario's fleet."""
        from repro_torch.core.baselines import FRAMEWORKS
        from repro_torch.core.controller import ControllerConfig
        from repro_torch.core.trainer import JobBank
        tr = self.tr
        # the last episode's bank goes first: its jobs' finalizers and the
        # recorded evals' params hold it until they are collected
        self.ctl = None
        self.evals.clear()
        self.engine.bank = None
        while gc.collect():
            pass
        self.engine.bank = bank = JobBank(self.engine,
                                          capacity=int(tr["bank_rows"]))

        def no_growth(need):
            if need > bank.capacity:
                raise RuntimeError(
                    f"the window loop made a job for slot {need}, past the "
                    f"bank's {bank.capacity} rows, which may not grow")
        bank._grow_to = no_growth
        self.streams = S.drift_wave(
            self.bank, regions=int(tr["regions"]),
            streams_per_region=int(tr["streams_per_region"]),
            wave_start=float(tr["wave_start"]),
            wave_step=float(tr["wave_step"]), seed=int(scenario_seed))
        cc = ControllerConfig(**tr["controller"])
        self.ctl = FRAMEWORKS[tr["framework"]](
            self.engine, list(self.streams), cc, seed=self.seed)
        fleet = self.ctl.fleet
        set_refs, observe = fleet.set_references, fleet.observe

        def recorded_refs(ids, toks):
            self.references.update(zip(ids, np.asarray(toks)))
            return set_refs(ids, toks)

        def recorded_observe(ids, toks):
            got = observe(ids, toks)
            self.observed.append((list(ids), np.asarray(toks), set(got),
                                  dict(self.references)))
            return got
        fleet.set_references = recorded_refs
        fleet.observe = recorded_observe
        self._record_allocator(self.ctl.allocator)
        self.references = {}
        self.ctl.warmup()

    def _record_allocator(self, alloc):
        """Each Alg. 1 window: the jobs and their member counts, the gain
        computations in turn, and the picks and shares it returned."""
        gains_of, window_of = alloc._objective_gains, alloc.run_window
        calls: List[tuple] = []

        def recorded_gains(jobs, acc, acc_gain):
            got = gains_of(jobs, acc, acc_gain)
            calls.append((dict(acc), dict(acc_gain), dict(got)))
            return got

        def recorded_window(jobs, window_micro, **kw):
            members = {j.job_id: int(j.num_members) for j in jobs}
            calls.clear()
            trace = window_of(jobs, window_micro, **kw)
            self.allocations.append((members, int(window_micro),
                                     list(calls), list(trace.order),
                                     dict(trace.shares)))
            return trace
        alloc._objective_gains = recorded_gains
        alloc.run_window = recorded_window

    def window(self):
        with torch.profiler.record_function("bench.window"):
            return self.ctl.run_window()

    def close(self):
        self._undo_js()
        if self.rec is not None:
            self.rec.uninstall()


def weight_seed(seed: int) -> int:
    return int(np.random.SeedSequence([seed & 0xFFFFFFFF, seed >> 32, 7])
               .generate_state(1, np.uint64)[0])


def episode_order(tr: dict, seed: int) -> List[int]:
    seeds = list(tr["scenario_seeds"])
    rng = np.random.default_rng([seed & 0xFFFFFFFF, seed >> 32, 3])
    return [seeds[i] for i in rng.permutation(len(seeds))]


def run(cell, seed: int, seconds: float, trace: bool, dev=None,
        control: bool = False) -> Run:
    dev = torch.device(dev or "cuda")
    t_start = time.perf_counter()
    tr = cell.traffic
    out = Run(cell.name, cell.config, tr)
    ep = Episodes(cell, seed, dev, trace)
    probe = Probe(ep.engine, ep.init, float(tr["train"]["b1"]))
    per = int(tr["windows_per_episode"])
    for _ in range(2):                    # set-up: the warm-up episode
        ep.start(int(tr["warm_scenario"]))
        ep.warm_streams += ep.streams
        for _ in range(per):
            ep.window()
        if probe.done:
            break
    probe.remove()
    if trace:
        T.prime()
    _sync(dev)
    if ep.spans is not None:
        ep.spans.clear()
    out.setup_s = time.perf_counter() - t_start

    order = episode_order(tr, seed)
    trace_at = int(tr.get("trace_window", 1))
    prof = None
    # the timed path's own training, read as the set-up's was
    wprobe = Probe(ep.engine, ep.init, float(tr["train"]["b1"]))
    ep.shortlists.clear()
    ep.allocations.clear()
    t0 = time.perf_counter()
    i = 0
    while True:
        ep.start(order[i % len(order)])
        if not wprobe.done:
            wprobe.reset(ep.streams)
        for w in range(per):
            if trace and prof is None and w == trace_at:
                prof = T.Profile(ep.rec)
                prof.start()
                torch.zeros(1, device=dev).add_(1)   # the discarded step
                prof.warm()
                ep.flops = 0.0
            a = time.perf_counter()
            ep.window()
            _sync(dev)
            b = time.perf_counter()
            out.windows.append((a - t0, b - t0))
            if prof is not None and prof.wall is None:
                prof.flops = ep.flops
                prof.stop()
        i += 1
        if time.perf_counter() - t0 >= seconds:
            break
    out.window_s = time.perf_counter() - t0
    wprobe.remove()
    if prof is not None:
        out.stretch = prof.result()
    out.attempted = len(out.windows)
    out.notes["episodes"] = i
    out.notes["window_ms_each"] = [round(1e3 * (b - a), 1)
                                   for a, b in out.windows]
    if ep.spans is not None:
        out.spans = ep.spans.resolve(t0)
    if dev.type == "cuda":
        out.memory_peak_bytes = int(torch.cuda.max_memory_allocated())
    ep.close()
    probe.streams = ep.warm_streams
    out.checks = check(ep, [probe, wprobe], dev, control)
    return out


def check(ep: Episodes, probes: List[Probe], dev, control: bool = False
          ) -> List[Check]:
    """Frees the program's state, then compares. With `control`, also the
    readings of the reference put in the program's place in the next
    precision down (fp8 operands for the bf16 training, TF32 for the fp32
    evals, bfloat16 for the fp32 Jensen-Shannon scores) and of planted
    faults (half of each batch left out, an eval's hits flipped), each
    against the same limits, named `control.<number>`, `half.<number>`,
    `altered.<number>`. A training number is the worst over the probes."""
    tr = ep.tr
    lim = tr["limits"]
    cfg = ep.cfg
    # what the check needs from the run, before the program's state goes
    evals = [(tuple(x.clone() for x in _leaf_list(p)), t.clone(),
              h.clone(), z) for p, t, h, prec, z in ep.evals
             if prec == "fp32"]
    observed = ep.observed
    shortlists, allocations = ep.shortlists, ep.allocations
    skeleton = ep.spec
    init_seed = weight_seed(ep.seed)
    ep.ctl = None
    ep.engine.bank = None
    ep.init = None
    ep.evals = []
    # a job's finalizer holds its bank until the job is collected
    while gc.collect():
        pass
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    checks = []
    # drift: the host reference's triggers on the same tokens
    bad = 0
    for ids, toks, got, refs in observed:
        want = ref_drift.triggers(
            dict(zip(ids, toks)), refs,
            buckets=int(tr["controller"].get("sig_buckets", 64)),
            vocab=int(cfg["vocab_size"]),
            threshold=float(tr["controller"].get("drift_threshold", 0.25)))
        bad += int(want != got)
    checks.append(Check("drift_windows_differ", float(bad), 0.0))
    foreign = 0
    for pr in probes:
        seen = _emitted_rows(pr.streams)
        foreign += sum(1 for b in pr.rows for r in b
                       if tuple(r.tolist()) not in seen)
    checks.append(Check("foreign_rows", float(foreign), 0.0))
    checks += _shortlist_gaps(shortlists, lim, control)
    checks.append(Check("alg1_windows_differ", float(sum(
        ref_alloc.window_differs(*a) for a in allocations)), 0.0))
    checks.append(Check("reading.alg1_windows", float(len(allocations)),
                        math.inf))

    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        init = W.make(skeleton, init_seed, dev)
        per_probe = []
        for pr in probes:
            if not pr.done:
                checks.append(Check("train_steps_read", float(pr.steps),
                                    -1.0))
                continue
            want = _reference_steps(cfg, init, tr["train"], pr, dev)
            mine = (pr.losses, pr.grad, pr.change, pr.gnorm)
            got = _train_gaps("", mine, want, lim)
            if control:
                got += _train_gaps("control.", _reference_steps(
                    cfg, init, tr["train"], pr, dev, quant=ref.fp8),
                    want, lim)
                got += _train_gaps("half.", _reference_steps(
                    cfg, init, tr["train"], pr, dev, half=True),
                    want, lim)
            per_probe.append(got)
        checks += _worst(per_probe)
        del init
        worst = {"eval_margin": 0.0, "eval_logit_rms": 0.0,
                 "eval_logit_gap": 0.0, "control.eval_margin": 0.0,
                 "control.eval_logit_rms": 0.0,
                 "control.eval_logit_gap": 0.0,
                 "altered.eval_margin": 0.0}
        with torch.no_grad():
            for k, (leaves, toks, hits, z) in enumerate(evals):
                params = _unleaf(skeleton, list(leaves))
                got = eval_gaps(cfg, params, toks, hits, z, control)
                if control and k == 0:
                    # the fault "an answer altered where it is produced":
                    # the first row's hits flipped
                    flip = hits.clone()
                    flip[0] = 1 - flip[0]
                    got["altered.eval_margin"] = eval_gaps(
                        cfg, params, toks[:1], flip[:1], z[:1])[
                        "eval_margin"]
                for name, v in got.items():
                    worst[name] = max(worst[name], v)
        checks.append(Check("reading.eval_logit_gap",
                            worst["eval_logit_gap"], math.inf))
        if control:
            checks.append(Check("reading.control.eval_logit_gap",
                                worst["control.eval_logit_gap"], math.inf))
        for name in ("eval_margin", "eval_logit_rms"):
            value = worst[name] if evals else math.nan
            checks.append(Check(name, value, float(lim[name])))
            if control:
                for pre in ("control.", "altered."):
                    if pre + name in worst:
                        checks.append(Check(pre + name, worst[pre + name],
                                            float(lim[name])))
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old
    return checks


def _worst(per_probe: List[List[Check]]) -> List[Check]:
    """One check per name: the largest value over the probes."""
    out: Dict[str, Check] = {}
    for got in per_probe:
        for c in got:
            if c.name not in out or c.value > out[c.name].value:
                out[c.name] = c
    return list(out.values())


def _shortlist_gaps(shortlists, lim, control: bool) -> List[Check]:
    """The widest gap between the shortlist kernel's scores and the
    float64 reference's, over every request and every signature row in
    use (an all-zero row is a free slot, which the program masks); with
    `control`, also that of the reference computed in bfloat16."""
    gap, ctl, n = 0.0, 0.0, 0
    for p, q, d in shortlists:
        p, q, d = p.cpu(), q.cpu(), d.cpu().to(torch.float64)
        live = q.sum(-1) > 0
        if not bool(live.any()):
            continue
        n += 1
        want = ref_drift.pairwise_js(p, q[live])
        gap = max(gap, float((d[:, live] - want).abs().max()))
        if control:
            low = ref_drift.pairwise_js(p, q[live], dtype=torch.bfloat16)
            ctl = max(ctl, float((low - want).abs().max()))
    out = [Check("js_gap", gap, float(lim["js_gap"])),
           Check("reading.js_calls", float(n), math.inf)]
    if control:
        out.append(Check("control.js_gap", ctl, float(lim["js_gap"])))
    return out


def _reference_steps(cfg, init, tc, probe: Probe, dev, quant=None,
                     half=False):
    """The reference trainer's three steps on the probed rows: (losses,
    first gradient's leaf norms, leaf changes after the three, the first
    gradient's global norm before clipping)."""
    rt = ref_train.Trainer(cfg, init, tc, quant=quant)
    losses, grad, gnorm = [], None, math.nan
    for k, rows in enumerate(probe.rows):
        batch = torch.as_tensor(rows, device=dev)
        if half:
            batch = batch[:max(1, batch.shape[0] // 2)]
        lv, norms, gn = rt.step(batch)
        losses.append(lv)
        if k == 0:
            grad, gnorm = norms, gn
    return losses, grad, rt.change(), gnorm


def _train_gaps(prefix, got, want, lim) -> List[Check]:
    """The first step's loss (relative: both sides start from the same
    weights), the first gradient's global norm before clipping (relative:
    the program's own `grad_norm` metric), the first gradient's and the
    change's norms by the worst layer leaf (clipped, as the optimizer got
    them); leaves whose reference gradient is under a thousandth of the
    median leaf's move by round-off alone and are left out of the change.
    A number the cell's limits do not name is printed as a reading
    (`reading.<number>`; PERF.md gives why), as is the largest loss gap
    over the three steps (`steps3.loss_gap`)."""
    (l1, g1, c1, n1), (l0, g0, c0, n0) = got, want
    med = sorted(g0.values())[len(g0) // 2]
    keep = {n for n, g in g0.items() if g >= 1e-3 * med}
    numbers = {
        "loss_gap": abs(l1[0] - l0[0]) / abs(l0[0]),
        "gnorm_gap": abs(n1 - n0) / n0,
        "grad_gap": ref_train.gap_by_worst_leaf(g1, g0)[0],
        "change_gap": ref_train.gap_by_worst_leaf(c1, c0, keep)[0]}
    out = []
    for name, value in numbers.items():
        if prefix or name in lim:
            out.append(Check(prefix + name, value,
                             float(lim.get(name, math.inf))))
        else:
            out.append(Check("reading." + name, value, math.inf))
    out.append(Check("steps3." + prefix + "loss_gap",
                     max(abs(a - b) / abs(b) for a, b in zip(l1, l0)),
                     math.inf))
    return out


def eval_gaps(cfg, params, toks, hits, z_prog, control=False
              ) -> Dict[str, float]:
    """Against the reference's float32 logits on the same rows: the RMS
    of the gap of every logit the program computed, over the RMS of the
    reference's logits (`eval_logit_rms`); the widest such gap
    (`eval_logit_gap`, a reading); and the widest margin by which the
    reference contradicts a reported hit (`eval_margin`: at a reported
    hit, how far the label's logit lies below the best other; at a
    reported miss, how far it lies above every other). With `control`,
    also those of the reference computed in TF32 (`control.`). Rows in
    blocks, so that the logits fit."""
    out = {"eval_margin": 0.0, "eval_logit_gap": 0.0}
    if control:
        out.update({"control.eval_margin": 0.0,
                    "control.eval_logit_gap": 0.0})
    sq = {"": 0.0, "control.": 0.0}
    norm = 0.0
    V = int(cfg["vocab_size"])
    for lo in range(0, toks.shape[0], 32):
        t = toks[lo:lo + 32]
        z = ref.logits(cfg, params, ref.hidden(cfg, params, t[:, :-1]))
        lab = t[:, 1:].long()
        zp = z_prog[lo:lo + 32, :-1, :V].to(F32)
        norm += float(z.double().pow(2).sum())
        sq[""] += float((zp - z).double().pow(2).sum())
        _worse(out, "eval_logit_gap", float((zp - z).abs().max()))
        _worse(out, "eval_margin", _margin(z, lab,
                                           hits[lo:lo + 32].bool()))
        if control:
            torch.backends.cuda.matmul.allow_tf32 = True
            zt = ref.logits(cfg, params, ref.hidden(cfg, params, t[:, :-1]))
            torch.backends.cuda.matmul.allow_tf32 = False
            sq["control."] += float((zt - z).double().pow(2).sum())
            _worse(out, "control.eval_logit_gap",
                   float((zt - z).abs().max()))
            _worse(out, "control.eval_margin",
                   _margin(z, lab, zt.argmax(-1) == lab))
    for pre in ([""] + (["control."] if control else [])):
        out[pre + "eval_logit_rms"] = math.sqrt(sq[pre] / max(norm, 1e-300))
    return out


def _worse(d: Dict[str, float], name: str, value: float):
    d[name] = max(d[name], value)


def _margin(z, lab, hit) -> float:
    zl = z.gather(-1, lab[..., None])[..., 0]
    others = z.scatter(-1, lab[..., None], -math.inf).amax(-1)
    m = torch.where(hit, others - zl, zl - others)
    return float(m.clamp(min=0).max())


def _leaf_list(tree):
    return [x for _, x in ref_train.leaves(tree)]


def _unleaf(spec, flat):
    it = iter(flat)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if isinstance(t, (list, tuple)):
            return [build(v) for v in t]
        return next(it)
    return build(spec)


def _emitted_rows(streams) -> set:
    """Every row the given cameras drew."""
    rows = set()
    for s in streams:
        for arr in s.emitted:
            for r in np.asarray(arr):
                rows.add(tuple(r.tolist()))
    return rows
