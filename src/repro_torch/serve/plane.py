"""Live serving plane: batched fleet inference from validated per-group
serving snapshots, ported from the JAX package's `serve/plane.py`
(its design note: docs/serving_plane.md).

While `ECCOController.run_window` retrains group models, this plane
answers stream queries from a separate set of committed per-group params,
the serving snapshots, stacked on one leading row axis (`ServingStore`,
the `RowRegistry` churn discipline of every fleet plane). Queries for any
mix of groups decode together: every tick is one call of the fleet decode
step over all active slots, each lane with its own params row and its own
position (`serve_step.make_fleet_decode_step`: one `flash_attention`
launch per global-attention layer per tick), and admission batches
prefills per (group, prompt length). For the dense attention families the
step decodes the whole pool against every live serving row, and on the
card replays it as CUDA graphs; `graph_ticks`, `eager_ticks` and
`graph_captures` count how often.

A freshly retrained model is not what serves next by default: `publish`
runs an update-validation gate (EdgeSync, PAPERS.md). The candidate must
reach the incumbent's fp32 accuracy on the group's held-out sample plus
`gate_margin` (ties accept at the default margin 0.0). On failure the
incumbent keeps serving, the miss is counted, and the group's staleness
(windows since its serving snapshot last changed) grows.

Two differences from the JAX plane, neither of which moves a token:
  * the store keeps, beside each committed fp32 row, a copy in the
    serving compute dtype, cast once at install: the JAX step casts the
    stacked fp32 rows inside every jitted tick, which done eagerly would
    read every row and allocate a bf16 copy of it per tick. The cast is
    deterministic, so the decode reads the same values; the gate scores
    the fp32 row.
  * lanes are not padded to a shape grid (`_pad_size` bounds XLA's
    compilations): prefills run on the real lane count. A tick of a
    family the fleet step decodes pool-wide (`serve_step.pool_wide`)
    pads instead to the whole pool, whose fixed shapes the card's CUDA
    graphs need; the other families' ticks run on the real lane count.
    `tick_log` records the lanes a tick really served either way.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import tracing
from repro_torch.core.rows import RowRegistry
from repro_torch.models.param import tree_leaves, tree_map
from repro_torch.serve.kvcache import ServeLoop
from repro_torch.serve.serve_step import make_fleet_decode_step


@dataclasses.dataclass
class ServeConfig:
    """Controller-side switch for the serving plane
    (`ControllerConfig.serve`; None = plane off, the default — golden
    traces never see it)."""
    num_slots: int = 32          # shared KV-cache slot pool size
    capacity: int = 64           # per-slot prompt+generation budget
    max_new: int = 8             # tokens per query (incl. prefill token)
    prompt_len: int = 8          # query prompt tokens (from window data)
    queries_per_stream: int = 1  # queries each grouped stream issues/window
    eos_id: Optional[int] = None
    gate_margin: float = 0.0     # candidate must beat incumbent by this
    gate_members: int = 2        # members whose eval draws form the gate set
    max_ticks_per_window: Optional[int] = None   # None = drain fully


@dataclasses.dataclass
class GateDecision:
    """One `publish` outcome (the swap-gate audit record)."""
    group_id: str
    candidate_acc: float
    incumbent_acc: float         # nan when the group was first seeded
    accepted: bool
    seeded: bool                 # first snapshot: installed ungated


class ServingStore:
    """Stacked per-group serving params: leaves (capacity, ...), rows
    keyed by group id through `RowRegistry` (amortized doubling,
    swap-with-last removal). Rows are committed copies owned by the store
    (fp32, as given); installs overwrite a row and never alias the
    training bank. Beside them, the same rows in `compute_dtype` (the
    same tensors when that is the rows' own dtype), cast once at install,
    which the fleet decode reads."""

    def __init__(self, compute_dtype=torch.bfloat16):
        self.reg = RowRegistry(capacity=4)
        self.compute_dtype = compute_dtype
        self._stack = None           # committed rows (capacity, ...)
        self._compute = None         # the rows in compute_dtype

    def __contains__(self, group_id: str) -> bool:
        return group_id in self.reg

    def __len__(self) -> int:
        return len(self.reg)

    @property
    def group_ids(self) -> List[str]:
        return self.reg.ids

    def _dtype(self, x):
        """The dtype of `x`'s row in the compute copy."""
        return self.compute_dtype if x.is_floating_point() else x.dtype

    @torch.no_grad()
    def install(self, group_id: str, params):
        """Set `group_id`'s serving row to `params` (add or overwrite)."""
        row, _ = self.reg.add(group_id)
        cap = self.reg.capacity
        if self._stack is None:
            self._stack = tree_map(
                lambda x: torch.zeros((cap,) + tuple(x.shape),
                                      dtype=x.dtype, device=x.device),
                params)
            self._compute = self._new_compute()
        elif cap > tree_leaves(self._stack)[0].shape[0]:
            same = self._compute_is_stack()
            self._stack = tree_map(lambda x: self._grow(x, cap), self._stack)
            self._compute = (self._stack if same else tree_map(
                lambda x: self._grow(x, cap), self._compute))
        for dst, src in zip(tree_leaves(self._stack), tree_leaves(params),
                            strict=True):
            dst[row] = src
        if not self._compute_is_stack():
            for dst, src in zip(tree_leaves(self._compute),
                                tree_leaves(self._stack)):
                dst[row] = src[row]

    def _compute_is_stack(self) -> bool:
        return self._compute is self._stack

    def _new_compute(self):
        if all(self._dtype(x) == x.dtype for x in tree_leaves(self._stack)):
            return self._stack
        return tree_map(lambda x: torch.zeros_like(x, dtype=self._dtype(x)),
                        self._stack)

    @staticmethod
    def _grow(x, cap):
        pad = torch.zeros((cap - x.shape[0],) + tuple(x.shape[1:]),
                          dtype=x.dtype, device=x.device)
        return torch.cat([x, pad])

    @torch.no_grad()
    def remove(self, group_id: str):
        mv = self.reg.remove(group_id)
        if mv is None:
            return
        dst, src = mv
        if dst != src:
            stacks = [self._stack] + ([] if self._compute_is_stack()
                                      else [self._compute])
            for stack in stacks:
                for x in tree_leaves(stack):
                    x[dst] = x[src]

    def row(self, group_id: str):
        """One group's committed serving params (views into the store,
        valid until its next install or remove)."""
        r = self.reg[group_id]
        return tree_map(lambda x: x[r], self._stack)

    def compute_row(self, group_id: str):
        """One group's row in the compute dtype (views, as `row`)."""
        r = self.reg[group_id]
        return tree_map(lambda x: x[r], self._compute)

    def stack(self):
        """The full stacked params tree (leaves (capacity, ...))."""
        return self._stack

    def compute_stack(self):
        """The stacked rows in the compute dtype: the fleet decode's."""
        return self._compute

    def nbytes(self) -> Dict[str, int]:
        """Device bytes of the committed rows and of their compute copy
        (0 when the two are the same tensors)."""
        if self._stack is None:
            return {"rows": 0, "compute": 0}
        rows = sum(x.numel() * x.element_size()
                   for x in tree_leaves(self._stack))
        comp = 0 if self._compute_is_stack() else sum(
            x.numel() * x.element_size() for x in tree_leaves(self._compute))
        return {"rows": rows, "compute": comp}


class FleetServePlane(ServeLoop):
    """Batched fleet serving over the slot-pool cache, one model per
    group, with the validated hot swap. Extends `ServeLoop` (admission
    bookkeeping, retirement rule, drain API) with a query queue, a
    `ServingStore` of per-group snapshots, per-(group, length) batched
    admission, and a per-lane-params decode tick. Runs on the engine's
    device; `compute_dtype` and `cache_dtype` are the serving forward's
    and the pool's (bf16 both, as the JAX plane's)."""

    def __init__(self, engine, scfg: Optional[ServeConfig] = None, *,
                 compute_dtype=torch.bfloat16, cache_dtype=torch.bfloat16):
        self.scfg = scfg = scfg or ServeConfig()
        super().__init__(engine.model, None, num_slots=scfg.num_slots,
                         capacity=scfg.capacity, eos_id=scfg.eos_id,
                         max_new=scfg.max_new, compute_dtype=compute_dtype,
                         cache_dtype=cache_dtype, device=engine.device)
        self.engine = engine
        self.store = ServingStore(compute_dtype)
        self._fleet_decode = make_fleet_decode_step(
            engine.model, compute_dtype=compute_dtype)
        self._queue: Deque[Tuple[str, str, np.ndarray]] = deque()
        # swap-gate counters (cumulative) + per-group staleness
        self.swap_seeded = 0
        self.swap_accepted = 0
        self.swap_rejected = 0
        self.staleness: Dict[str, int] = {}
        # run-lifetime tick log for pooled latency percentiles: (lanes,
        # seconds) per tick, the lanes the tick served (not the pool a
        # pool-wide tick decodes); the last `_window_ticks` entries are
        # this window's
        self.tick_log: List[Tuple[int, float]] = []
        self.prefill_calls = 0       # batched prefills, run-lifetime
        # ticks that replayed the fleet step's CUDA graphs, ticks run op by
        # op (the CPU, the grouped families, a capture's own tick), and
        # the sets of graphs captured; run-lifetime
        self.graph_ticks = 0
        self.eager_ticks = 0
        self.graph_captures = 0
        self._last_lanes = 0
        # per-window accumulators (reset by window_report)
        self._gate_log: List[GateDecision] = []
        self._window_ticks = 0
        self._queries = 0
        self._tokens = 0
        self._ticks = 0
        self._serve_seconds = 0.0
        self._dropped = 0

    # -- validated hot swap --------------------------------------------------
    def publish(self, group_id: str, candidate_params,
                eval_sample) -> GateDecision:
        """Offer a freshly retrained `candidate_params` as `group_id`'s
        serving snapshot. The first publish seeds the group ungated (there
        is no incumbent to regress); afterwards the candidate's fp32
        accuracy on `eval_sample` must reach the incumbent's plus
        `gate_margin`, or the incumbent keeps serving and the miss is
        recorded."""
        cand = float(self.engine.accuracy(candidate_params, eval_sample))
        if group_id not in self.store:
            self.store.install(group_id, candidate_params)
            self.swap_seeded += 1
            self.staleness[group_id] = 0
            dec = GateDecision(group_id, cand, float("nan"), True, True)
        else:
            inc = float(self.engine.accuracy(self.store.row(group_id),
                                             eval_sample))
            if cand >= inc + self.scfg.gate_margin:
                self.store.install(group_id, candidate_params)
                self.swap_accepted += 1
                self.staleness[group_id] = 0
                dec = GateDecision(group_id, cand, inc, True, False)
            else:
                self.swap_rejected += 1
                self.staleness[group_id] = self.staleness.get(group_id,
                                                              0) + 1
                dec = GateDecision(group_id, cand, inc, False, False)
        self._gate_log.append(dec)
        return dec

    def drop_group(self, group_id: str):
        """A group died (regrouping / fleet churn): retire its in-flight
        requests, drop its queued queries, and free its serving row."""
        for i, st in enumerate(self.mgr.slots):
            if not st.done and st.group == group_id:
                self._retire(i)
        if self._queue:
            kept = []
            for q in self._queue:
                if q[1] == group_id:
                    tracing.end("ecco.query.queue", q[0], dropped=True)
                else:
                    kept.append(q)
            self._dropped += len(self._queue) - len(kept)
            self._queue = deque(kept)
        self.store.remove(group_id)
        self.staleness.pop(group_id, None)

    def prune(self, live_group_ids):
        """Drop every serving row whose group is no longer live."""
        live = set(live_group_ids)
        for gid in list(self.store.group_ids):
            if gid not in live:
                self.drop_group(gid)

    # -- query path ----------------------------------------------------------
    def enqueue(self, request_id: str, group_id: str, prompt):
        """Queue one query against `group_id`'s serving snapshot. Capacity
        is validated here (admission would only defer the error); unknown
        groups are resolved at admission time, when the store membership
        is current."""
        prompt = np.asarray(prompt)
        self.mgr.check_fit(prompt.shape[-1], self.max_new)
        self._queue.append((request_id, group_id, prompt))
        tracing.begin("ecco.query.queue", request_id)

    def _prefill_group(self, group_id: str, prompts: np.ndarray):
        tok, cache, pos = self._prefill(
            self.store.compute_row(group_id),
            torch.as_tensor(prompts, device=self.device))
        self.prefill_calls += 1
        return tok.tolist(), cache, pos

    def submit(self, request_id: str, prompt, *,
               group: Optional[str] = None) -> int:
        """Immediate single-request admission (tests / interactive use);
        the window loop goes through enqueue + pump."""
        if group is None:
            raise TypeError("FleetServePlane.submit requires group=")
        prompt = np.asarray(prompt)
        slot = self.mgr.admit(request_id, prompt_len=prompt.shape[-1],
                              max_new=self.max_new, group=group)
        with tracing.span("ecco.prefill", rids=[request_id]):
            toks, cache, pos = self._prefill_group(group, prompt[None])
        self.mgr.write_prefill(slot, cache, int(pos))
        self._queries += 1
        self._record_first(request_id, slot, toks[0])
        return slot

    def _admit_from_queue(self):
        """Admit as many queued queries as there are free slots, one
        batched prefill per (group, prompt-length) bucket."""
        free = len(self.mgr.free_slots())
        if not free or not self._queue:
            return
        queued = len(self._queue)
        take: List[Tuple[str, str, np.ndarray]] = []
        while self._queue and len(take) < free:
            rid, gid, prompt = self._queue.popleft()
            if gid not in self.store:
                tracing.end("ecco.query.queue", rid, dropped=True)
                self._dropped += 1
                continue
            tracing.end("ecco.query.queue", rid)
            take.append((rid, gid, prompt))
        if not take:
            return
        buckets: Dict[Tuple[str, int], List[Tuple[str, str, np.ndarray]]] = {}
        for item in take:
            buckets.setdefault((item[1], item[2].shape[-1]),
                               []).append(item)
        with tracing.span("ecco.admit", queued=queued, admitted=len(take)):
            for (gid, slen), items in buckets.items():
                rids = [rid for rid, _, _ in items]
                with tracing.span("ecco.prefill", rids=rids):
                    toks, cache, pos = self._prefill_group(
                        gid, np.stack([p for _, _, p in items]))
                slots = [self.mgr.admit(rid, prompt_len=slen,
                                        max_new=self.max_new, group=gid)
                         for rid in rids]
                self.mgr.write_prefill_many(slots, cache, int(pos))
                self._queries += len(items)
                for rid, slot, t in zip(rids, slots, toks):
                    self._record_first(rid, slot, t)

    def tick(self) -> Dict[str, int]:
        """One decode step for every active slot in one fleet-step call:
        lanes carry their own params row and position, so mixed groups
        and staggered admissions share the tick. Every live serving row
        is computed, whether or not a lane reads it this tick, so that the
        step's shapes change only when the store does."""
        act = self.mgr.active()
        if not act:
            return {}
        step = self._fleet_decode
        captures = step.captures
        with tracing.span("ecco.tick", lanes=len(act)):
            slots = [self.mgr.slots[i] for i in act]
            nxt, _ = step(
                self.store.compute_stack(),
                [self.store.reg[st.group] for st in slots],
                [self._new_tokens[i] for i in act], self.mgr.cache,
                [st.pos for st in slots], slots=act,
                groups=range(len(self.store)))
            nxt = nxt.tolist()
            tracing.annotate(graphed=step.graphed)
        self.decode_calls += 1
        if step.graphed:
            self.graph_ticks += 1
        else:
            self.eager_ticks += 1
        self.graph_captures += step.captures - captures
        self._last_lanes = len(act)
        emitted: Dict[str, int] = {}
        for i, t in zip(act, nxt):
            emitted[self._emit(i, t)] = t
        self._ticks += 1
        self._tokens += len(act)
        return emitted

    def pump(self, *, max_ticks: Optional[int] = None) -> int:
        """Admit + tick until the queue and the pool drain (or `max_ticks`
        decode ticks elapse). Returns ticks run. A tick ends in the copy
        of its tokens to the host, so its host clock times finished device
        work."""
        if max_ticks is None:
            max_ticks = self.scfg.max_ticks_per_window
        t_start = time.perf_counter()
        ran = 0
        while self._queue or self.mgr.active():
            if max_ticks is not None and ran >= max_ticks:
                break
            self._admit_from_queue()
            if not self.mgr.active():
                if not self._queue:
                    break
                continue
            t0 = time.perf_counter()
            self.tick()
            self.tick_log.append((self._last_lanes,
                                  time.perf_counter() - t0))
            self._window_ticks += 1
            ran += 1
        self._serve_seconds += time.perf_counter() - t_start
        return ran

    # -- reporting -----------------------------------------------------------
    def window_report(self) -> Dict:
        """Per-window serving metrics; resets the window accumulators
        (swap counters stay cumulative, mirroring the JAX plane's)."""
        first = max(0, len(self.tick_log) - self._window_ticks)
        tt = np.asarray([dt for _, dt in self.tick_log[first:]], np.float64)
        rep = {
            "queries": self._queries,
            "tokens": self._tokens,
            "ticks": self._ticks,
            "dropped": self._dropped,
            "serve_seconds": self._serve_seconds,
            "qps": (self._queries / self._serve_seconds
                    if self._serve_seconds > 0 else 0.0),
            "p50_tick_ms": (float(np.percentile(tt, 50)) * 1e3
                            if tt.size else 0.0),
            "p99_tick_ms": (float(np.percentile(tt, 99)) * 1e3
                            if tt.size else 0.0),
            "groups": len(self.store),
            "swap_seeded": self.swap_seeded,
            "swap_accepted": self.swap_accepted,
            "swap_rejected": self.swap_rejected,
            "staleness": dict(self.staleness),
            "gate": [dataclasses.asdict(d) for d in self._gate_log],
        }
        self._gate_log = []
        self._window_ticks = 0
        self._queries = self._tokens = self._ticks = 0
        self._dropped = 0
        self._serve_seconds = 0.0
        return rep


# the report's keys that read a clock; everything else is a count or a
# decision, equal across packages and devices
TIMING_KEYS = ("serve_seconds", "qps", "p50_tick_ms", "p99_tick_ms")
