"""ECCO end-to-end controller: drift detection -> dynamic grouping ->
GPU allocation -> transmission control -> group retraining, window by
window (Fig. 3 / Fig. 4 of the paper), ported from the JAX package's
`core/controller.py`.

One window (`run_window`) runs the reference's steps in the reference's
order, and draws every stream's data in the reference's order (window
data, then request subsamples, then the metrics draws at t + 0.5), so
equal seeds give equal tokens:

  1. each stream's window data; drift scored by `FleetDriftDetector` on
     the engine's device (`drift_impl="auto"`: the `fleet_drift`
     kernel on the card, decided in float64 on the host); a drifted,
     ungrouped stream sends a retraining request to the `Grouper`
     (`SignatureIndex` shortlist: the `pairwise_js` kernel when
     `shortlist_k > 0`);
  2. GPU shares from the allocator's last gains -> GAIMD bandwidth
     (`FleetTransmissionPlane.allocate`, host fp32);
  3. the §3.2 camera-side decisions for the whole fleet
     (`decide_many`), and each member's delivered sequences ingested;
  4. Alg. 1 over the jobs (`ECCOAllocator.run_window`): the eval
     forwards through `flash_attention` on the card, the train steps on
     the autograd route;
  5. regrouping (Alg. 2 `update_grouping`) on the members' window data,
     then the window's per-stream accuracy on fresh draws (`eval_pairs`);
  6. with `cc.serve`, the serving plane (`serve.plane.FleetServePlane`):
     each group's retrained params offered through the validation gate
     (fp32 evals through `flash_attention`), then every grouped stream's
     queries served from the committed snapshots (prefills and fleet
     decode ticks through `flash_attention` with per-lane lengths). It
     uses only data drawn above, so no decision moves.

Accuracies leave the engine as Python floats, so the allocator's and
the grouper's arithmetic runs in float64 as the reference's does.

With `cc.roofline_budget` the window is metered (docs/scheduling.md):
a fresh `launch.roofline.RooflineMeter` over the controller's
`CostTable` (an H100 roofline unless `cc.cost_table` gives another
table) charges the window's grouping and metrics evals (and, with
`serve`, the gate's evals and the queries) up front, and Alg. 1 spends
the remainder by gain per modeled second; `WindowMetrics.roofline` is
the ledger. `zoo` engines are smaller model classes a metered controller
may place NEW jobs on (`_pick_engine`).

Fleet distribution (docs/distributed_plane.md): with `mesh` (a
`launch.mesh.FleetMesh`) every decision plane block-shards its row axis
over the mesh's devices (JobBank slots, drift rows, signature columns,
transmission flows), with decisions bit-identical to one device. With
`elastic` (a `distributed.elastic.FleetElastic`) a window is
transactional: job states are checkpointed and the host control plane
snapshotted at its start, and a device loss raised at one of its
barriers (after step 1, before each micro-window) shrinks the mesh to the
survivors, rolls everything back and re-runs the window to the same
decisions. `stragglers` (a `distributed.stragglers.StragglerPolicy`)
shrinks a slow job's micro-window quota; `cc.window_deadline` drops the
micro-windows left when a window runs out of time.
"""
from __future__ import annotations

import copy
import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch import tracing
from repro_torch.configs.base import ModelConfig
from repro_torch.core import trainer as _trainer
from repro_torch.core.allocator import AllocationTrace, ECCOAllocator
from repro_torch.core.batching import engine_groups
from repro_torch.core.drift import FleetDriftDetector, batch_token_histogram
from repro_torch.core.grouping import Grouper, Request
from repro_torch.core.signature_index import SignatureIndex
from repro_torch.core.trainer import RetrainJob, SharedEngine
from repro_torch.core.transmission import (FleetTransmissionPlane,
                                           ProfileTable, SamplingConfig)
from repro_torch.data.streams import Stream
from repro_torch.distributed.elastic import DeviceFailure
from repro_torch.serve.plane import FleetServePlane, ServeConfig


@dataclasses.dataclass
class ControllerConfig:
    window_micro: int = 8            # W micro-windows per retraining window
    window_seconds: float = 10.0
    seq_len: int = 32
    sample_rate: int = 8             # sequences per stream per window (f)
    eval_batch: int = 16
    eps_t: float = 60.0
    delta_loc: float = 100.0
    p_drop: float = 0.15
    drift_threshold: float = 0.25
    shared_bandwidth: float = 64.0   # tokens/sec equivalents
    local_caps: Optional[Dict[str, float]] = None
    bytes_per_token: float = 1.0
    micro_steps: int = 4
    train_batch: int = 8
    sig_buckets: int = 64            # drift-signature histogram buckets
    shortlist_k: int = 0             # grouping eval_on cap (0 = no cap)
    drift_impl: str = "exact"        # FleetDriftDetector scoring backend
    # §3.2 profiled sampling-config table. None = a single fixed
    # (sample_rate, seq_len) configuration (the table's configs must use
    # resolution == seq_len because the ring pool holds fixed-width rows)
    profile_table: Optional[ProfileTable] = None
    # wall-clock budget (seconds) for one window's allocator loop: once
    # exceeded, leftover micro-windows are dropped. None = no deadline
    window_deadline: Optional[float] = None
    # live serving plane. None = off (the default; golden traces never
    # see it). When set, run_window step 6 publishes each group's freshly
    # retrained params through the validation gate and serves every
    # grouped stream's queries from the committed serving snapshots.
    # Read-only w.r.t. the decision planes: it reuses the window's
    # already-drawn data and consumes no rng
    serve: Optional[ServeConfig] = None
    # roofline-budgeted co-scheduling: fleet-wide modeled device-seconds
    # per window, covering the train pass, the allocator / grouper /
    # metrics eval passes and (with `serve`) the serve plane, on ONE
    # budget. The grouping / metrics / serve shares are reserved up front
    # each window, so retraining competes only for the remainder, by gain
    # per metered cost. None = the unmetered path (golden traces)
    roofline_budget: Optional[float] = None
    # launch.roofline.CostTable to price windows with (anything with its
    # `seconds(cfg, *, batch, seq, kind, precision)`); None builds one
    # lazily on the first metered window and keeps it (the cache is the
    # point)
    cost_table: Optional[object] = None
    # decision-plane screen precision for NEW jobs ("fp32" | "bf16");
    # near-threshold grouping decisions rescore in fp32 when
    # `rescore_margin` > 0
    job_precision: str = "fp32"
    rescore_margin: float = 0.0


@dataclasses.dataclass
class WindowMetrics:
    t: float
    per_stream_acc: Dict[str, float]
    groups: Dict[str, List[str]]
    shares: Dict[str, float]
    bandwidth: Dict[str, float]
    # tokens each grouped member actually ingested after §3.2
    # compression — always <= bandwidth * window_seconds / bytes_per_token
    delivered: Dict[str, int] = dataclasses.field(default_factory=dict)
    # serving-plane window report (FleetServePlane.window_report): qps /
    # tick latency / swap-gate counters / per-group staleness. None
    # whenever ControllerConfig.serve is off
    serve: Optional[Dict] = None
    # roofline ledger for the window (WindowBudget.report plus the
    # allocator's degrade / drop notes); None when metering is off
    roofline: Optional[Dict] = None


class ECCOController:
    # GAIMD parameterization for step 2: "ecco" = alpha p_j/n_j
    # (GPU-share proportional); "equal" = plain AIMD equal competition
    # (the no-coordination baselines override this)
    bandwidth_mode = "ecco"

    def __init__(self, engine: SharedEngine, streams: Sequence[Stream],
                 cc: Optional[ControllerConfig] = None, *, seed: int = 0,
                 mesh=None, elastic=None, stragglers=None, zoo=None):
        """`engine`'s device carries the fleet planes too: the drift
        screen and the signature shortlist run where the jobs do. `mesh`:
        optional 1-D fleet mesh (launch.mesh.make_fleet_mesh): every
        decision plane shards its row axis over it. `elastic`: optional
        distributed.elastic.FleetElastic: run_window then checkpoints at
        window start and survives a mid-window device loss by re-meshing
        and re-running the window. `stragglers`: optional
        distributed.stragglers.StragglerPolicy, wired into the
        allocator's micro-window loop with cc.window_deadline. `zoo`:
        optional sequence of further SharedEngines (smaller model classes
        on the same device and vocabulary) a metered controller may place
        NEW jobs on: under budget pressure `_new_job` picks the largest
        tier whose micro-window cost fits the job's fair share of the
        window budget. Requires cc.roofline_budget; ignored otherwise."""
        self.cc = cc or ControllerConfig()
        self.engine = engine
        self.streams = list(streams)
        self.elastic = elastic
        self.stragglers = stragglers
        if mesh is None and elastic is not None:
            mesh = elastic.mesh
        self.mesh = mesh
        if elastic is not None:
            elastic.mesh = mesh
        self.allocator = ECCOAllocator()
        self.sig_index = SignatureIndex(buckets=self.cc.sig_buckets,
                                        capacity=max(64, 2 * len(streams)),
                                        device=engine.device, mesh=mesh)
        self.grouper = Grouper(eps_t=self.cc.eps_t,
                               delta_loc=self.cc.delta_loc,
                               p_drop=self.cc.p_drop,
                               new_job_fn=self._new_job,
                               index=self.sig_index,
                               shortlist_k=self.cc.shortlist_k,
                               rescore_margin=self.cc.rescore_margin)
        # model-class tiers for metered job placement: the primary engine
        # plus any zoo engines, priced lazily per window
        self.zoo: List[SharedEngine] = list(zoo or [])
        self._cost_table = self.cc.cost_table
        self.jobs: List[RetrainJob] = []
        table = self.cc.profile_table
        if table is None:
            # fixed sampling configuration: the window's full sample at
            # the stream's native resolution
            table = ProfileTable([SamplingConfig(self.cc.sample_rate,
                                                 self.cc.seq_len)])
        else:
            # the ring pool stores fixed-width (seq_len,) rows, so a
            # config at any other resolution would be rejected at
            # ingest mid-run — fail at construction instead
            bad = [c for c in getattr(table, "configs", [])
                   if c.resolution != self.cc.seq_len]
            if bad:
                raise ValueError(
                    f"profile_table configs must use resolution == "
                    f"seq_len={self.cc.seq_len} (the token ring pool "
                    f"holds fixed-width rows); offending: {bad}")
        self.tx_plane = FleetTransmissionPlane(
            table, bytes_per_token=self.cc.bytes_per_token, mesh=mesh)
        self.fleet = FleetDriftDetector(
            threshold=self.cc.drift_threshold, buckets=self.cc.sig_buckets,
            vocab=engine.cfg.vocab_size, impl=self.cc.drift_impl,
            device=engine.device, mesh=mesh)
        bank = getattr(engine, "bank", None)
        if mesh is not None and hasattr(bank, "place_on"):
            bank.place_on(mesh)   # job axis block-sharded over the mesh
        for s in self.streams:
            self.fleet.add_stream(s.stream_id)
        self.serve_plane = (FleetServePlane(engine, self.cc.serve)
                            if self.cc.serve is not None else None)
        self.t = 0.0
        self.history: List[WindowMetrics] = []
        self.request_time: Dict[str, float] = {}
        self._seed = seed

    # ------------------------------------------------------------------
    def _new_job(self, req: Request) -> RetrainJob:
        return RetrainJob(self._pick_engine(), req,
                          micro_steps=self.cc.micro_steps,
                          batch=self.cc.train_batch, seed=self._seed,
                          precision=self.cc.job_precision)

    # -- roofline co-scheduling ------------------------------------------
    def _table(self):
        """The shared CostTable, built lazily on the first metered window
        (its cache is kept across windows)."""
        if self._cost_table is None:
            from repro_torch.launch.roofline import CostTable
            self._cost_table = CostTable()
        return self._cost_table

    def _micro_seconds(self, cfg, precision: str) -> float:
        """Modeled seconds of one allocator micro-window (train pass +
        the two bracketing evals) for a job on `cfg` at the controller
        batch settings."""
        cc = self.cc
        tbl = self._table()
        return (cc.micro_steps * tbl.seconds(
                    cfg, batch=cc.train_batch, seq=cc.seq_len,
                    kind="train", precision=precision)
                + 2 * tbl.seconds(
                    cfg, batch=cc.eval_batch, seq=cc.seq_len,
                    kind="eval", precision=precision))

    def _pick_engine(self) -> SharedEngine:
        """Model class for a NEW job: without metering (or a zoo) the
        primary engine. Under a roofline budget, the costliest tier whose
        one micro-window fits the job's fair share of the window budget,
        `budget / (window_micro * (jobs + 1))`; a fleet under budget
        pressure retrains a smaller backbone rather than starve."""
        cc = self.cc
        if not self.zoo or cc.roofline_budget is None:
            return self.engine
        prec = cc.job_precision
        tiers = sorted(
            [self.engine] + self.zoo,
            key=lambda e: self._micro_seconds(e.cfg, prec), reverse=True)
        fair = cc.roofline_budget / max(1, cc.window_micro) \
            / (len(self.jobs) + 1)
        for e in tiers:
            if self._micro_seconds(e.cfg, prec) <= fair:
                return e
        return tiers[-1]          # nothing fits: cheapest tier

    def _window_meter(self):
        """A fresh RooflineMeter for this window, or None (unmetered)."""
        if self.cc.roofline_budget is None:
            return None
        from repro_torch.launch.roofline import RooflineMeter
        return RooflineMeter(self._table(), self.cc.roofline_budget,
                             seq_len=self.cc.seq_len,
                             eval_batch=self.cc.eval_batch)

    def _reserve_overheads(self, meter):
        """Charge the window's NON-allocator compute up front so that
        retraining competes only for the remainder: the Alg. 2
        update-grouping screens (one eval per member), the window metrics
        eval (one eval per grouped stream), and, with serving on, each
        group's fp32 gate validation plus its streams' query prefills and
        decode steps."""
        cc = self.cc
        for j in self.jobs:
            meter.charge(meter.eval_cost(j), "grouping")
            meter.charge(meter.eval_cost(j), "metrics")
        if self.serve_plane is None:
            return
        scfg = cc.serve
        tbl = self._table()
        for j in self.jobs:
            cfg = getattr(getattr(j, "engine", None), "cfg", None)
            if not isinstance(cfg, ModelConfig):
                continue
            # validation gate: candidate + incumbent, always fp32
            meter.charge(2 * tbl.seconds(
                cfg, batch=cc.eval_batch, seq=cc.seq_len, kind="eval",
                precision="fp32"), "serve")
            meter.charge(meter.serve_cost(
                cfg, queries=j.num_members * scfg.queries_per_stream,
                prompt_len=max(1, scfg.prompt_len),
                gen_tokens=scfg.max_new), "serve")

    def _jobs_by_stream(self) -> Dict[str, RetrainJob]:
        """One O(members) pass; callers iterating the whole fleet grab
        this once instead of a per-stream linear scan."""
        return {mem.stream_id: j for j in self.jobs for mem in j.members}

    def _token_budgets(self, fshare: Sequence[float]) -> List[float]:
        """Per-flow token budget for §3.2 config selection: the group's
        share of the accelerator tokens one retraining window can
        consume (the paper's GPU-budget axis of the Fig. 5 table)."""
        cc = self.cc
        cap = cc.window_micro * cc.micro_steps * cc.train_batch * cc.seq_len
        return [s * cap for s in fshare]

    def warmup(self):
        """Set drift references from time-0 data."""
        if not self.streams:
            return
        toks = np.stack([s.sample(0.0, self.cc.sample_rate, self.cc.seq_len)
                         for s in self.streams])
        self.fleet.set_references([s.stream_id for s in self.streams], toks)

    # -- fleet membership (camera churn) -------------------------------
    def add_stream(self, stream: Stream, *, warm: bool = True):
        """A camera joins the fleet mid-run. Its drift reference is set
        from its first window of data (deployment-time snapshot).
        Joining an id that is already live is an error: re-adding
        would silently overwrite the stream's detector reference and
        leave duplicate fleet rows behind every per-stream plane."""
        if any(s.stream_id == stream.stream_id for s in self.streams):
            raise ValueError(
                f"stream {stream.stream_id!r} is already live; remove "
                f"it before re-joining")
        self.streams.append(stream)
        self.fleet.add_stream(stream.stream_id)
        if warm:
            toks = stream.sample(self.t, self.cc.sample_rate,
                                 self.cc.seq_len)
            self.fleet.set_reference(stream.stream_id, toks)

    def remove_stream(self, stream_id: str):
        """A camera leaves the fleet: drop its detector row, its job
        membership (empty jobs die), its grouping-index row, and its
        pending-request clock (response_times must not report latencies
        for cameras no longer in the fleet)."""
        self.streams = [s for s in self.streams
                        if s.stream_id != stream_id]
        self.fleet.remove_stream(stream_id)
        job = self._jobs_by_stream().get(stream_id)
        if job is not None:
            job.remove_member(stream_id)
            job.purge_stream_data(stream_id)
        self.jobs[:] = [j for j in self.jobs if j.members]
        self.sig_index.remove(stream_id)
        self.tx_plane.remove_flow(stream_id)
        self.request_time.pop(stream_id, None)

    # -- elastic window protocol ---------------------------------------
    def _barrier(self):
        """Stage-boundary health check; DeviceFailure propagates to the
        run_window retry loop. No-op without an elastic runtime."""
        if self.elastic is not None:
            self.elastic.barrier()

    def _snapshot(self) -> dict:
        """Host control-plane snapshot at a window boundary: everything a
        window mutates outside the JobBank's device stack (which the
        elastic runtime checkpoints to disk). Strong refs to the job
        handles keep their bank slots alive through the rollback."""
        return {
            "t": self.t,
            "stream_rng": {s.stream_id:
                           copy.deepcopy(s.rng.bit_generator.state)
                           for s in self.streams},
            "jobs": list(self.jobs),
            "job_host": {j.job_id: {
                "members": [copy.copy(m) for m in j.members],
                "pool": copy.deepcopy(j.pool),
                "rng": copy.deepcopy(j.rng.bit_generator.state),
                "gpu_time": j.gpu_time,
            } for j in self.jobs},
            "job_counter": _trainer._job_counter.n,
            "history_len": len(self.history),
            "request_time": dict(self.request_time),
            "gains": dict(self.allocator.last_gains),
            "grouper_events": len(self.grouper.events),
            "fleet": self.fleet.state_dict(),
            "sig": self.sig_index.state_dict(),
            "tx": self.tx_plane.state_dict(),
        }

    def _restore(self, snap: dict, mesh):
        """Roll the host control plane back to `snap` and re-attach every
        plane to the (shrunken) `mesh`; job train-states come back from
        the elastic runtime's window-start checkpoint. Jobs created by
        the aborted attempt lose their last reference here: their bank
        slots free through the deferred-free rule and compact away at the
        next batched entry point."""
        self.mesh = mesh
        self.t = snap["t"]
        for s in self.streams:
            s.rng.bit_generator.state = \
                copy.deepcopy(snap["stream_rng"][s.stream_id])
        self.jobs[:] = snap["jobs"]
        for j in self.jobs:
            jh = snap["job_host"][j.job_id]
            j.members = [copy.copy(m) for m in jh["members"]]
            j.pool = copy.deepcopy(jh["pool"])
            j.rng.bit_generator.state = copy.deepcopy(jh["rng"])
            j.gpu_time = jh["gpu_time"]
        _trainer._job_counter.n = snap["job_counter"]
        del self.history[snap["history_len"]:]
        self.request_time = dict(snap["request_time"])
        self.allocator.last_gains = dict(snap["gains"])
        del self.grouper.events[snap["grouper_events"]:]
        self.fleet.set_mesh(mesh)
        self.fleet.load_state_dict(snap["fleet"])
        self.sig_index.set_mesh(mesh)
        self.sig_index.load_state_dict(snap["sig"])
        self.tx_plane.set_mesh(mesh)
        self.tx_plane.load_state_dict(snap["tx"])
        bank = getattr(self.engine, "bank", None)
        if hasattr(bank, "invalidate_device"):
            bank.invalidate_device()   # device memory is gone
            bank.place_on(mesh)
        if self.elastic is not None:
            self.elastic.restore_jobs(self.jobs)

    def run_window(self) -> WindowMetrics:
        """One retraining window (steps 1-6 of the module docstring). With
        an elastic runtime the window is transactional: job states are
        checkpointed and the host control plane snapshotted at its start,
        and a DeviceFailure raised at a barrier shrinks the mesh to the
        survivors, rolls everything back and re-runs the window, which
        decides as a run that never failed (every plane's math is
        row-local under block sharding)."""
        if self.elastic is None:
            return self._run_window_inner()
        self.elastic.on_window_start(self.jobs)
        snap = self._snapshot()
        while True:
            try:
                return self._run_window_inner()
            except DeviceFailure as e:
                mesh = self.elastic.recover(e.lost)
                self._restore(snap, mesh)

    def _run_window_inner(self) -> WindowMetrics:
        with tracing.span("ecco.window"):
            return self._window_steps()

    def _window_steps(self) -> WindowMetrics:
        """Steps 1-6 of one window, each under its own span."""
        cc = self.cc
        t = self.t
        meter = self._window_meter()   # None = the unmetered path
        alloc_trace: Optional[AllocationTrace] = None

        # 1. live data + drift detection -> retraining requests. Sampling
        # stays per-stream (each stream owns its rng); scoring is ONE
        # batched fleet call
        with tracing.span("ecco.window.drift"):
            window_data: Dict[str, np.ndarray] = {}
            assigned = self._jobs_by_stream()
            ids = [s.stream_id for s in self.streams]
            if self.streams:
                toks_all = np.stack([s.sample(t, cc.sample_rate, cc.seq_len)
                                     for s in self.streams])
                window_data = dict(zip(ids, toks_all))
                triggered = set(self.fleet.observe(ids, toks_all))
            else:
                triggered = set()
            for s in self.streams:
                if (assigned.get(s.stream_id) is None
                        and s.stream_id in triggered):
                    sub = s.sample(t, cc.eval_batch, cc.seq_len)
                    req = Request(stream_id=s.stream_id, t=t, loc=s.loc,
                                  subsamples=sub, acc=0.0,
                                  train_data=window_data[s.stream_id],
                                  sig=self.fleet.hist(s.stream_id))
                    self.request_time.setdefault(s.stream_id, t)
                    self.grouper.group_request(self.jobs, req)
            self._barrier()

        # steps 2-5 run when the window starts with jobs
        has_jobs = bool(self.jobs)
        # 2. GPU shares estimate -> transmission control (GAIMD). The
        # plane warm-starts every flow's GAIMD rate from the state it
        # persisted at the end of the previous window and short-circuits
        # the fluid simulation once the steady cycle is reached.
        shares: Dict[str, float] = {}
        bw: Dict[str, float] = {}
        delivered: Dict[str, int] = {}
        with tracing.span("ecco.window.transmit"):
            if has_jobs:
                p = self.allocator.estimate_shares(self.jobs)
                members = [m for j in self.jobs for m in j.members]
                jobs_of = [j for j in self.jobs for _ in j.members]
                flows = [m.stream_id for m in members]
                fshare = [p[j.job_id] for j in jobs_of]
                fn = [j.num_members for j in jobs_of]
                caps = [(cc.local_caps or {}).get(sid, np.inf)
                        for sid in flows]
                rates = self.tx_plane.allocate(flows, fshare, fn, caps,
                                               cc.shared_bandwidth,
                                               mode=self.bandwidth_mode)
                bw = dict(zip(flows, map(float, rates)))
                shares = p
                # 3. §3.2 camera-side decisions for the whole fleet in ONE
                # batched call; a zero-bandwidth camera delivers nothing
                batch = self.tx_plane.decide_many(
                    budget_levels=self.tx_plane.levels_for_shares(fshare),
                    token_budgets=self._token_budgets(fshare),
                    p_shares=fshare, n_members=fn, achieved_bw=rates,
                    window_seconds=cc.window_seconds)
                for i, (j, m) in enumerate(zip(jobs_of, members)):
                    toks = window_data.get(m.stream_id)
                    if toks is None:
                        continue
                    res = int(batch.resolution[i])
                    # sequence subsampling: whole sequences within the
                    # delivered-token allowance, bounded by what the
                    # stream sampled this window
                    n_seq = int(batch.delivered[i]) // res if res else 0
                    if (n_seq == 0 and res and batch.delivered[i] > 0
                            and int(batch.deliverable[i]) >= res):
                        # a group larger than the config rate gives each
                        # member a fractional f*/n_j share; quantize UP to
                        # one whole sequence when the achieved bandwidth
                        # can carry it
                        n_seq = 1
                    sl = toks[:n_seq]
                    delivered[m.stream_id] = int(sl.shape[0]) * res
                    if sl.shape[0] == 0:
                        continue
                    j.ingest(sl, m.stream_id)

        # 4. the allocator runs the retraining window (Alg. 1), under the
        # elastic barrier (one health check per micro-window), the
        # straggler quota policy and the window deadline, all no-ops when
        # unset. With a roofline budget the window's eval / serve
        # co-tenants are charged FIRST and the allocator maximizes gain
        # per metered cost over the remainder
        with tracing.span("ecco.window.alloc"):
            if has_jobs:
                if meter is not None:
                    self._reserve_overheads(meter)
                alloc_trace = self.allocator.run_window(
                    self.jobs, cc.window_micro, stragglers=self.stragglers,
                    deadline=cc.window_deadline,
                    barrier=(self.elastic.barrier
                             if self.elastic is not None else None),
                    meter=meter)

        # 5. periodic regrouping (Alg. 2 UpdateGrouping), evaluated on each
        # member's RECENT window data, with the drift signatures refreshed
        # on the Request and in the index
        with tracing.span("ecco.window.regroup"):
            if has_jobs:
                members = [m for j in self.jobs for m in j.members
                           if window_data.get(m.stream_id) is not None]
                if members:
                    sigs = batch_token_histogram(
                        np.stack([window_data[m.stream_id]
                                  for m in members]),
                        self.fleet.buckets, self.fleet.vocab)
                    for m, sig in zip(members, sigs):
                        m.subsamples = window_data[m.stream_id]
                        m.sig = sig
                        self.sig_index.refresh_sig(m.stream_id, m.sig)
                self.grouper.update_grouping(self.jobs, t)

        # metrics: eval samples stay per-stream draws (fleet order),
        # scored in one batched call per engine
        with tracing.span("ecco.window.metrics"):
            acc = {}
            by_stream = self._jobs_by_stream()
            evs = {}
            for s in self.streams:
                evs[s.stream_id] = s.sample(t + 0.5, cc.eval_batch,
                                            cc.seq_len)
            grouped = [s.stream_id for s in self.streams
                       if by_stream.get(s.stream_id) is not None]
            gjobs = [by_stream[sid] for sid in grouped]
            vals: List[float] = [0.0] * len(gjobs)
            for grp_eng, idxs in engine_groups(gjobs):
                if grp_eng is None:
                    # fleetlint: disable=per-member-loop -- documented
                    # scalar fallback for probe-rejected jobs;
                    # bit-identical to the batched dispatch
                    for i in idxs:
                        vals[i] = gjobs[i].eval_on(evs[grouped[i]])
                else:
                    sub = grp_eng.eval_pairs(
                        [(gjobs[i], evs[grouped[i]]) for i in idxs])
                    for i, a in zip(idxs, sub):
                        vals[i] = a
            got = dict(zip(grouped, vals))
            for s in self.streams:
                acc[s.stream_id] = got.get(s.stream_id, float("nan"))

        # 6. live serving plane (off by default): validated hot swap of
        # each group's serving snapshot, then this window's stream queries
        # answered from the committed snapshots. Uses only data drawn
        # above (window_data prompts, evs gate sets): no rng, no decision
        with tracing.span("ecco.window.serve"):
            serve_report = None
            if self.serve_plane is not None:
                serve_report = self._serve_window(window_data, evs)

        groups = {j.job_id: [m.stream_id for m in j.members]
                  for j in self.jobs}
        roofline = None
        if meter is not None:
            roofline = meter.report()
            roofline["notes"] = list(alloc_trace.notes) \
                if alloc_trace is not None else []
        wm = WindowMetrics(t=t, per_stream_acc=acc, groups=groups,
                           shares=shares, bandwidth=bw,
                           delivered=delivered, serve=serve_report,
                           roofline=roofline)
        self.history.append(wm)
        self.t += cc.window_seconds
        return wm

    def _serve_window(self, window_data: Dict[str, np.ndarray],
                      evs: Dict[str, np.ndarray]) -> Dict:
        """One serving pass (run_window step 6).

        Swap protocol: every live group's freshly retrained params are
        offered through the plane's validation gate against the group's
        held-out set, up to `gate_members` members' metrics eval draws
        (drawn at t + 0.5, never ingested for training). Candidate rows
        follow the bank residency discipline
        (`RetrainJob.serving_snapshot`: compact, sync, committed row
        copy). Dead groups are pruned, then each grouped stream issues
        `queries_per_stream` prompts sliced from the window data it
        already transmitted, and the plane pumps the slot pool dry."""
        sp = self.serve_plane
        scfg = self.cc.serve
        for j in self.jobs:
            # the serve plane decodes with ITS engine's model; a job on
            # another engine cannot publish its params there (shape
            # mismatch); its streams keep the incumbent
            if getattr(j, "engine", None) is not sp.engine:
                continue
            ms = [m for m in j.members if m.stream_id in evs]
            ms = ms[:max(1, scfg.gate_members)]
            if not ms:
                continue
            sample = np.concatenate(
                [evs[m.stream_id] for m in ms])[:self.cc.eval_batch]
            sp.publish(j.job_id, j.serving_snapshot(), sample)
        sp.prune({j.job_id for j in self.jobs})
        by_stream = self._jobs_by_stream()
        w = len(self.history)
        for s in self.streams:
            j = by_stream.get(s.stream_id)
            if j is None or j.job_id not in sp.store:
                continue
            toks = window_data.get(s.stream_id)
            if toks is None or toks.shape[0] == 0:
                continue
            for q in range(scfg.queries_per_stream):
                prompt = toks[q % toks.shape[0]][:scfg.prompt_len]
                sp.enqueue(f"{s.stream_id}/w{w}q{q}", j.job_id, prompt)
        sp.pump()
        sp.drain()      # transcripts are per-window; keep memory bounded
        return sp.window_report()

    def run(self, windows: int) -> List[WindowMetrics]:
        self.warmup()
        for _ in range(windows):
            self.run_window()
        return self.history

    # -- reporting -------------------------------------------------------------
    def mean_accuracy(self, last_k: int = 1) -> float:
        vals = []
        for wm in self.history[-last_k:]:
            vals += [v for v in wm.per_stream_acc.values()
                     if not np.isnan(v)]
        return float(np.mean(vals)) if vals else float("nan")

    def response_times(self, threshold: float) -> Dict[str, float]:
        """Windows from request to reaching `threshold` accuracy."""
        out = {}
        for sid, t0 in self.request_time.items():
            for wm in self.history:
                if wm.t >= t0 and wm.per_stream_acc.get(sid, 0.0) >= threshold:
                    out[sid] = wm.t - t0
                    break
        return out
