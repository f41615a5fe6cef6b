"""Stream queries through the fleet serving plane (ECCO's step 6): each
query is a camera's last `prompt_len` tokens, answered with `max_new`
tokens by its group's current model.

Cameras sit in groups (`groups`: cameras per group), each group with its
own serving snapshot (weights made from the seed) installed through the
plane's first, ungated `publish`. A group's prompts are drawn from its own
token distribution: a Zipf law over a seeded permutation of the
vocabulary. Two loops:

* open: queries fall due on a fixed schedule at `rate` a second, from
  cameras drawn uniformly. The inter-arrival gaps are one fixed set (drawn
  from `gap_seed`, scaled to fill the window exactly) that each run's seed
  puts in another order, so every run offers the same load. The driver
  enqueues every query that has come due, then pumps the plane one tick,
  and records how late it enqueued. With `"arrivals": "group-bursts"`
  the same loop sends cameras of one group together: each camera falls
  due once a period (`sum(groups) / rate` seconds), a group's cameras in
  bursts of at most `burst`, the bursts spread evenly over the period in
  the order of `groups`, and the seed orders the cameras within a burst.
* closed: every camera sends its next query when its last one completes,
  so `sum(groups)` queries stand against `slots` slots.

A query's latency runs from its due time to its last token; one still in
flight when the window closes counts at its age then. After the window
the plane drains (at most `drain_seconds`), and a sample of finished
queries drawn from the seed is held to the plain float32 reference.
"""
from __future__ import annotations

import gc
import math
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from bench.core import device as D
from bench.core import trace as T
from bench.core import weights as W
from bench.core import yardstick as Y
from bench.core.record import Check, Query, Run
from bench.reference import model as ref

SALT_GROUP, SALT_CHECK, SALT_PROMPT = 0x5EED0001, 0x5EED0002, 0x5EED0003


def _seed(*parts) -> int:
    return int(np.random.SeedSequence([int(p) & 0xFFFFFFFF for p in parts]
                                      + [int(p) >> 32 for p in parts]
                                      ).generate_state(1, np.uint64)[0])


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


class Traffic:
    """The cameras, their groups, and each group's prompt distribution."""

    def __init__(self, tr: dict, vocab: int, seed: int):
        self.tr = tr
        self.P = int(tr["prompt_len"])
        self.cameras = []                       # camera -> group index
        for g, n in enumerate(tr["groups"]):
            self.cameras += [g] * int(n)
        ranks = np.arange(1, vocab + 1, dtype=np.float64)
        p = ranks ** -float(tr["zipf"])
        p /= p.sum()
        self.cdf = np.cumsum(p)
        self.perm = [np.random.default_rng(_seed(seed, SALT_GROUP, g))
                     .permutation(vocab) for g in range(len(tr["groups"]))]
        self.rng = np.random.default_rng(_seed(seed, SALT_PROMPT))
        self.vocab = vocab

    def prompt(self, group: int) -> np.ndarray:
        u = self.rng.random(self.P)
        idx = np.minimum(np.searchsorted(self.cdf, u), self.vocab - 1)
        return self.perm[group][idx]

    def schedule(self, seconds: float, seed: int) -> np.ndarray:
        """Due times of the open loop: the fixed gaps, permuted."""
        n = max(1, int(round(float(self.tr["rate"]) * seconds)))
        gaps = np.random.default_rng(int(self.tr["gap_seed"])).exponential(
            1.0, size=n)
        gaps *= seconds / gaps.sum()
        gaps = np.random.default_rng(_seed(seed, 11)).permutation(gaps)
        return np.concatenate([[0.0], np.cumsum(gaps)[:-1]])

    def bursts(self, seconds: float, seed: int) -> List[tuple]:
        """(due, camera) of the open loop in group bursts, in due order:
        the same bursts for every seed, each burst's cameras in the seed's
        order."""
        groups = [int(n) for n in self.tr["groups"]]
        size = int(self.tr["burst"])
        period = sum(groups) / float(self.tr["rate"])
        first = np.concatenate([[0], np.cumsum(groups)[:-1]])
        bursts = [(int(first[g]) + a, min(n - a, size))
                  for g, n in enumerate(groups) for a in range(0, n, size)]
        rng = np.random.default_rng(_seed(seed, 17))
        out = []
        for k in range(int(math.ceil(seconds / period))):
            for j, (cam, n) in enumerate(bursts):
                due = (k + j / len(bursts)) * period
                if due < seconds:
                    out += [(due, cam + int(c)) for c in rng.permutation(n)]
        return out


class Harness:
    """The plane, set up for one run, and the spans a traced run takes."""

    def __init__(self, cell, seed: int, dev, trace: bool):
        from repro_torch.core.trainer import SharedEngine
        from repro_torch.serve.plane import FleetServePlane, ServeConfig
        self.cfg = cell.config
        self.tr = cell.traffic
        self.dev = dev
        mcfg = D.model_config(self.cfg)
        self.spec = W.spec_of(mcfg)
        self.engine = SharedEngine(mcfg, device=dev)
        P, new = int(self.tr["prompt_len"]), int(self.tr["max_new"])
        self.plane = FleetServePlane(self.engine, ServeConfig(
            num_slots=int(self.tr["slots"]), capacity=P + new, max_new=new))
        self.groups = [f"g{g}" for g in range(len(self.tr["groups"]))]
        sample = np.random.default_rng(seed).integers(
            0, self.cfg["vocab_size"], size=(1, 16))
        for g, gid in enumerate(self.groups):
            params = W.make(self.spec, group_seed(seed, g), dev)
            dec = self.plane.publish(gid, params, sample)
            if not (dec.seeded and dec.accepted):
                raise RuntimeError(f"the first publish of {gid} was not "
                                   f"installed: {dec}")
            del params
        gc.collect()
        self.rec = T.Recorder() if trace else None
        self.spans = T.Spans() if trace else None
        self.flops = 0.0
        self._wrap()

    def _wrap(self):
        plane = self.plane
        self.admit_log: List[tuple] = []
        admit = plane._admit_from_queue

        def observed_admit():
            before = [q[0] for q in plane._queue]
            t = time.perf_counter()
            admit()
            if before:
                left = {q[0] for q in plane._queue}
                self.admit_log.append((t, [r for r in before
                                           if r not in left]))
        plane._admit_from_queue = observed_admit
        if self.rec is None:
            return
        self.rec.install()
        prefill, tick = plane._prefill_group, plane.tick

        def spanned_prefill(group_id, prompts):
            with self.spans("bench.prefill", queries=int(prompts.shape[0])):
                out = prefill(group_id, prompts)
            if self.rec.on:
                self.flops += Y.forward_flops(self.cfg, *prompts.shape,
                                                logit_rows=1)
            return out

        def spanned_tick():
            if self.rec.on:
                pos = [plane.mgr.slots[i].pos for i in plane.mgr.active()]
                self.flops += Y.decode_flops(self.cfg, pos)
            with torch.profiler.record_function("bench.tick"):
                return tick()
        plane._prefill_group = spanned_prefill
        plane.tick = spanned_tick

    def close(self):
        if self.rec is not None:
            self.rec.uninstall()


def group_seed(seed: int, g: int) -> int:
    return _seed(seed, g)


def warm(h: Harness, traffic: Traffic):
    """Every shape the window uses, once: a batched prefill per group (of
    a whole burst where the loop sends bursts) and decode ticks until the
    plane drains."""
    bursts = traffic.tr.get("arrivals") == "group-bursts"
    for g, gid in enumerate(h.groups):
        n = min(int(traffic.tr["groups"][g]), int(traffic.tr["burst"])) \
            if bursts else 2
        for i in range(n):
            h.plane.enqueue(f"warm{g}.{i}", gid, traffic.prompt(g))
        if bursts:
            h.plane.pump()
    h.plane.pump()
    h.plane.drain()
    h.plane.window_report()
    h.plane.tick_log.clear()
    h.admit_log.clear()
    if h.spans is not None:
        h.spans.clear()
    _sync(h.dev)


def run(cell, seed: int, seconds: float, trace: bool, dev=None,
        control: bool = False) -> Run:
    dev = torch.device(dev or "cuda")
    t_start = time.perf_counter()
    tr = cell.traffic
    out = Run(cell.name, cell.config, tr)
    traffic = Traffic(tr, cell.config["vocab_size"], seed)
    h = Harness(cell, seed, dev, trace)
    warm(h, traffic)
    if trace:
        T.prime()
    out.setup_s = time.perf_counter() - t_start
    queries = _window(h, traffic, seconds, seed, trace, out)
    out.queries = queries
    out.ticks = list(h.plane.tick_log)
    if h.spans is not None:
        out.spans = h.spans.resolve(out.notes["t0"])
    out.attempted = len(out.in_window())
    _drain(h, queries, float(tr.get("drain_seconds", 60)))
    missing = [q for q in queries if q.tokens is None]
    out.failed = len(missing)
    if dev.type == "cuda":
        out.memory_peak_bytes = int(torch.cuda.max_memory_allocated())
    h.close()
    finished = {q.rid: q for q in queries if q.tokens is not None}
    del h
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    out.checks = check(cell, seed, finished, dev, control, out.notes) + [
        Check("unanswered", float(len(missing)), 0.0)]
    return out


def _window(h: Harness, traffic: Traffic, seconds: float, seed: int,
            trace: bool, out: Run) -> List[Query]:
    plane, tr = h.plane, traffic.tr
    closed = tr["loop"] == "closed"
    ncam = len(traffic.cameras)
    cam_rng = np.random.default_rng(_seed(seed, 13))
    queries: List[Query] = []
    by_rid: Dict[str, Query] = {}
    prompts: Dict[str, np.ndarray] = {}
    cam_of: Dict[str, int] = {}
    pending: List[tuple] = []               # (due, camera) not yet sent
    if closed:
        pending = [(0.0, int(c)) for c in cam_rng.permutation(ncam)]
    elif tr.get("arrivals") == "group-bursts":
        pending = traffic.bursts(seconds, seed)
    else:
        pending = [(float(t), int(cam_rng.integers(ncam)))
                   for t in traffic.schedule(seconds, seed)]
    pending.reverse()                        # pop() takes the earliest
    # a traced run profiles the window's last `trace_seconds`, so that the
    # profiler's stop and parse, which take seconds, fall after the close
    prof = None
    t_trace = max(0.0, seconds - float(tr.get("trace_seconds", 3.0)))
    lateness = []
    t0 = time.perf_counter()

    def now():
        return time.perf_counter() - t0

    def send(due, cam):
        g = traffic.cameras[cam]
        rid = f"q{len(queries)}"
        q = Query(rid, h.groups[g], due, enqueued=now())
        queries.append(q)
        by_rid[rid] = q
        cam_of[rid] = cam
        prompts[rid] = traffic.prompt(g)
        plane.enqueue(rid, q.group, prompts[rid])
        lateness.append(q.enqueued - due)

    while True:
        t = now()
        if t >= seconds:
            # the window closes at the end of the pump that crossed
            # `seconds`: its work and its time both count
            out.window_s = t
            break
        if trace and prof is None and t >= t_trace:
            prof = T.Profile(h.rec)       # the next pump is its warm-up
            prof.start()
        elif prof is not None and prof.t0 is None:
            prof.warm()
            h.flops = 0.0
        while pending and pending[-1][0] <= t:
            send(*pending.pop())
        if plane._queue or plane.mgr.active():
            for rid in _pump(h, by_rid, t0):
                if closed:
                    pending.append((by_rid[rid].done, cam_of[rid]))
        elif pending:
            time.sleep(max(0.0, min(pending[-1][0] - now(), 0.002)))
    if prof is not None:
        prof.flops = h.flops
        prof.stop()
        out.stretch = prof.result()
    for rid, q in by_rid.items():
        if q.done is None:
            q.at_close = len(plane.outputs.get(rid, ()))
    out.notes["generator_late_ms"] = {
        "median": 1e3 * float(np.median(lateness)) if lateness else 0.0,
        "max": 1e3 * float(np.max(lateness)) if lateness else 0.0}
    # due before the close but not yet sent: sent now, so that the drain
    # answers them for the check; their latency is their age at the close
    while pending and pending[-1][0] < seconds:
        send(*pending.pop())
    for q in queries:
        q.prompt = prompts[q.rid]
    out.notes["t0"] = t0
    return queries


def _pump(h: Harness, by_rid: Dict[str, Query], t0: float) -> List[str]:
    """One admission and one tick; returns the queries that finished."""
    n_admits = len(h.admit_log)
    h.plane.pump(max_ticks=1)
    t = time.perf_counter() - t0
    for ta, rids in h.admit_log[n_admits:]:
        for rid in rids:
            if rid in by_rid:
                by_rid[rid].admitted = ta - t0
    done = h.plane.drain()
    for rid, toks in done.items():
        q = by_rid.get(rid)
        if q is not None:
            q.done = t
            q.tokens = list(toks)
    return [r for r in done if r in by_rid]


def _drain(h: Harness, queries: List[Query], limit_s: float):
    """Finish what the window left in flight, for the check only: the
    latencies were read at the close."""
    by_rid = {q.rid: q for q in queries}
    t_end = time.perf_counter() + limit_s
    while (h.plane._queue or h.plane.mgr.active()) and \
            time.perf_counter() < t_end:
        h.plane.pump(max_ticks=1)
        for rid, toks in h.plane.drain().items():
            if rid in by_rid:
                by_rid[rid].tokens = list(toks)


def check(cell, seed: int, finished: Dict[str, Query], dev,
          control: bool = False, notes: Optional[dict] = None
          ) -> List[Check]:
    """A sample of finished queries, drawn from the seed, against the
    float32 reference: the widest gap by which a served token's logit
    lies below the reference's best at its position (`served_gap`), the
    mean of those gaps (`served_gap_mean`), and the worst query's mean
    gap (`served_gap_query`), which one lane served wrong moves where it
    barely moves the mean over all of them. The cell's `limits` name
    the numbers compared; the others are printed as readings. With
    `control`, also the gaps of the token that the reference computed
    with fp8 operands (the control) or bf16 operands puts first, and of
    the served token plus one (the fault "a token altered")."""
    limits = cell.traffic["limits"]
    quants = {"control": ref.fp8, "bf16": ref.bf16} if control else {}
    gaps = served_gaps(cell.config, seed, finished, dev,
                       int(cell.traffic["check_queries"]), quants,
                       altered=control)
    served = gaps.pop("served")
    if notes is not None and served:
        notes["served_gap_by_position"] = [
            round(float(x), 4) for x in np.max(np.asarray(served), axis=0)]
    checks = []
    for prefix, g in [("", served)] + [(k + ".", v) for k, v in
                                       gaps.items()]:
        for name, value in (("served_gap", np.max(g) if g else math.nan),
                            ("served_gap_mean",
                             np.mean(g) if g else math.nan),
                            ("served_gap_query",
                             max(np.mean(x) for x in g) if g
                             else math.nan)):
            if name in limits:
                checks.append(Check(prefix + name, float(value),
                                    float(limits[name])))
            elif control:
                checks.append(Check(prefix + name, float(value), math.inf))
            elif notes is not None and not prefix:
                notes[name] = float(value)
    return checks


def served_gaps(cfg, seed, finished: Dict[str, Query], dev, n: int,
                quants: dict, altered: bool = False) -> Dict[str, list]:
    """Per sampled query, per served position: the gap of the served
    token (`served`) and of each lower-precision reference's first
    choice, under the float32 reference's best; with `altered`, also of
    the served token plus one (the fault "a token altered where it is
    produced")."""
    rng = np.random.default_rng(_seed(seed, SALT_CHECK))
    rids = sorted(finished, key=lambda r: int(r[1:]))
    pick = [rids[i] for i in sorted(rng.choice(len(rids), size=min(
        n, len(rids)), replace=False))] if rids else []
    spec = W.spec_of(D.model_config(cfg))
    out = {"served": [], **{k: [] for k in quants}}
    if altered:
        out["altered"] = []
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        for gid in sorted({finished[r].group for r in pick}):
            params = W.make(spec, group_seed(seed, int(gid[1:])), dev)
            with torch.no_grad():
                for rid in pick:
                    if finished[rid].group == gid:
                        for k, g in _gaps_one(cfg, params, finished[rid],
                                              dev, quants, altered).items():
                            out[k].append(g)
            del params
            if dev.type == "cuda":
                torch.cuda.empty_cache()
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old
    return out


def _gaps_one(cfg, params, q: Query, dev, quants, altered=False
              ) -> Dict[str, list]:
    toks = np.concatenate([q.prompt, np.asarray(q.tokens[:-1], np.int64)])
    x = torch.as_tensor(toks, device=dev)[None]
    P = len(q.prompt)
    at = torch.arange(P - 1, P - 1 + len(q.tokens), device=dev)
    z = ref.logits(cfg, params, ref.hidden(cfg, params, x)[0][at])
    best = z.max(dim=-1).values

    def gap(tokens):
        return (best - z.gather(1, tokens[:, None])[:, 0]).tolist()
    served = torch.as_tensor(q.tokens, device=dev)
    out = {"served": gap(served)}
    if altered:
        out["altered"] = gap((served + 1) % cfg["vocab_size"])
    for name, quant in quants.items():
        zq = ref.logits(cfg, params,
                        ref.hidden(cfg, params, x, quant)[0][at], quant)
        out[name] = gap(zq.argmax(-1))
    return out
