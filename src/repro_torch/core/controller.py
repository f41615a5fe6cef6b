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
  5. regrouping (Alg. 2 `update_grouping`) on the members' window data;
  6. per-stream accuracy on fresh draws (`eval_pairs`).

Accuracies leave the engine as Python floats, so the allocator's and
the grouper's arithmetic runs in float64 as the reference's does.

Not here yet, and refused loudly: the serving plane (`cc.serve`,
ROADMAP.md queue 1 item 6), roofline budgets (`cc.roofline_budget`,
`cc.cost_table`, item 5), and `mesh`, `elastic`, `stragglers` and `zoo`
(items 5 and 9).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core.allocator import ECCOAllocator
from repro_torch.core.batching import engine_groups
from repro_torch.core.drift import FleetDriftDetector, batch_token_histogram
from repro_torch.core.grouping import Grouper, Request
from repro_torch.core.signature_index import SignatureIndex
from repro_torch.core.trainer import RetrainJob, SharedEngine
from repro_torch.core.transmission import (FleetTransmissionPlane,
                                           ProfileTable, SamplingConfig)
from repro_torch.data.streams import Stream


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
    # not ported yet; a value other than None raises (see the module
    # docstring)
    serve: Optional[object] = None
    roofline_budget: Optional[float] = None
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
    # the serving plane's and the roofline meter's window reports in the
    # reference; always None here (neither is ported yet)
    serve: Optional[Dict] = None
    roofline: Optional[Dict] = None


def _refuse(what: str, item: str):
    raise NotImplementedError(
        f"{what} is not ported yet (ROADMAP.md queue 1 {item})")


class ECCOController:
    # GAIMD parameterization for step 2: "ecco" = alpha p_j/n_j
    # (GPU-share proportional); "equal" = plain AIMD equal competition
    # (the no-coordination baselines override this)
    bandwidth_mode = "ecco"

    def __init__(self, engine: SharedEngine, streams: Sequence[Stream],
                 cc: Optional[ControllerConfig] = None, *, seed: int = 0,
                 mesh=None, elastic=None, stragglers=None, zoo=None):
        """`engine`'s device carries the fleet planes too: the drift
        screen and the signature shortlist run where the jobs do."""
        self.cc = cc or ControllerConfig()
        if self.cc.serve is not None:
            _refuse("the serving plane (ControllerConfig.serve)", "item 6")
        if self.cc.roofline_budget is not None \
                or self.cc.cost_table is not None:
            _refuse("roofline-budgeted windows (ControllerConfig."
                    "roofline_budget / cost_table)", "item 5")
        if mesh is not None or elastic is not None:
            _refuse("the controller under a mesh or an elastic runtime",
                    "item 9")
        if stragglers is not None:
            _refuse("straggler policies", "item 9")
        if zoo is not None:
            _refuse("zoo engines (metered job placement)", "item 5")
        self.engine = engine
        self.streams = list(streams)
        self.allocator = ECCOAllocator()
        self.sig_index = SignatureIndex(buckets=self.cc.sig_buckets,
                                        capacity=max(64, 2 * len(streams)),
                                        device=engine.device)
        self.grouper = Grouper(eps_t=self.cc.eps_t,
                               delta_loc=self.cc.delta_loc,
                               p_drop=self.cc.p_drop,
                               new_job_fn=self._new_job,
                               index=self.sig_index,
                               shortlist_k=self.cc.shortlist_k,
                               rescore_margin=self.cc.rescore_margin)
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
            table, bytes_per_token=self.cc.bytes_per_token)
        self.fleet = FleetDriftDetector(
            threshold=self.cc.drift_threshold, buckets=self.cc.sig_buckets,
            vocab=engine.cfg.vocab_size, impl=self.cc.drift_impl,
            device=engine.device)
        for s in self.streams:
            self.fleet.add_stream(s.stream_id)
        self.t = 0.0
        self.history: List[WindowMetrics] = []
        self.request_time: Dict[str, float] = {}
        self._seed = seed

    # ------------------------------------------------------------------
    def _new_job(self, req: Request) -> RetrainJob:
        return RetrainJob(self.engine, req,
                          micro_steps=self.cc.micro_steps,
                          batch=self.cc.train_batch, seed=self._seed,
                          precision=self.cc.job_precision)

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

    # ------------------------------------------------------------------
    def run_window(self) -> WindowMetrics:
        """One retraining window (steps 1-6 of the module docstring)."""
        cc = self.cc
        t = self.t

        # 1. live data + drift detection -> retraining requests. Sampling
        # stays per-stream (each stream owns its rng); scoring is ONE
        # batched fleet call
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

        # 2. GPU shares estimate -> transmission control (GAIMD). The
        # plane warm-starts every flow's GAIMD rate from the state it
        # persisted at the end of the previous window and short-circuits
        # the fluid simulation once the steady cycle is reached.
        shares: Dict[str, float] = {}
        bw: Dict[str, float] = {}
        delivered: Dict[str, int] = {}
        if self.jobs:
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
                # delivered-token allowance, bounded by what the stream
                # sampled this window
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

            # 4. the allocator runs the retraining window (Alg. 1)
            self.allocator.run_window(self.jobs, cc.window_micro,
                                      deadline=cc.window_deadline)

            # 5. periodic regrouping (Alg. 2 UpdateGrouping), evaluated
            # on each member's RECENT window data, with the drift
            # signatures refreshed on the Request and in the index
            members = [m for j in self.jobs for m in j.members
                       if window_data.get(m.stream_id) is not None]
            if members:
                sigs = batch_token_histogram(
                    np.stack([window_data[m.stream_id] for m in members]),
                    self.fleet.buckets, self.fleet.vocab)
                for m, sig in zip(members, sigs):
                    m.subsamples = window_data[m.stream_id]
                    m.sig = sig
                    self.sig_index.refresh_sig(m.stream_id, m.sig)
            self.grouper.update_grouping(self.jobs, t)

        # metrics: eval samples stay per-stream draws (fleet order),
        # scored in one batched call per engine
        acc = {}
        by_stream = self._jobs_by_stream()
        evs = {}
        for s in self.streams:
            evs[s.stream_id] = s.sample(t + 0.5, cc.eval_batch, cc.seq_len)
        grouped = [s.stream_id for s in self.streams
                   if by_stream.get(s.stream_id) is not None]
        gjobs = [by_stream[sid] for sid in grouped]
        vals: List[float] = [0.0] * len(gjobs)
        for grp_eng, idxs in engine_groups(gjobs):
            if grp_eng is None:
                # fleetlint: disable=per-member-loop -- documented
                # scalar fallback for probe-rejected jobs; bit-identical
                # to the batched dispatch
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

        groups = {j.job_id: [m.stream_id for m in j.members]
                  for j in self.jobs}
        wm = WindowMetrics(t=t, per_stream_acc=acc, groups=groups,
                           shares=shares, bandwidth=bw,
                           delivered=delivered)
        self.history.append(wm)
        self.t += cc.window_seconds
        return wm

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
