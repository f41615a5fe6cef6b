"""Window-level fleet invariants — what must hold on EVERY window of
EVERY scenario, benign or hostile, under every framework. Ported from
the JAX package's `testing/invariants.py`, law for law.

The golden traces pin one fixed-seed trajectory per framework; this
module pins the *laws* those trajectories (and every other run) must
obey, so an adversarial scenario that wanders off the golden set still
cannot silently violate the planes' contracts:

  * transmission — each flow's delivered tokens fit its realized
    bandwidth (`delivered <= bw * W / bytes_per_token`), realized
    bandwidth respects the per-camera uplink caps, and the fleet total
    respects the shared bottleneck (up to GAIMD's additive-increase
    overshoot bound, see `_check_bandwidth`).
  * allocation — GPU shares are a distribution (sum to 1, each in
    [0, 1]) and reproduce Alg. 1 Line 15 exactly: proportional to the
    previous window's final positive gains with the estimate_shares
    new-job fill rule (uniform for the patched no-coordination
    baselines).
  * grouping — no stream sits in two groups, memberships match the
    live jobs list, and every membership change is explained by this
    window's join/new/evict events (frameworks that patch the grouper
    must instead keep memberships frozen).
  * residency — detector / signature-index / transmission-plane rows
    never outlive their stream; JobBank slots match live jobs (after
    draining the deferred-free queue: a dead job's slot is queued by
    its `weakref.finalize`, which cyclic garbage reaches only through a
    collection); ServingStore rows match live groups (once the serving
    plane is ported).

`InvariantChecker` is stateful per run: `before_window` snapshots the
previous window's gains/groups (what the laws are relative to),
`after_window` asserts. The trace runner (repro_torch.testing.trace.
run_scenario) drives it on every window by default; timing runs opt out
via `invariants=False`.

Adding a new invariant: write a `_check_*(self, ctl, wm, events)`
method that calls `self._fail(msg)` on violation, and append it to
`_CHECKS`.
"""
from __future__ import annotations

import gc
from typing import Dict, Iterable, List, Optional, Set


class InvariantViolation(AssertionError):
    """A window broke a fleet-plane contract (see module docstring)."""


def _patched(obj, name: str) -> bool:
    """True when `name` is instance-patched (the baseline controllers
    overwrite grouper/allocator methods with lambdas per window)."""
    return name in getattr(obj, "__dict__", {})


def expected_shares(job_ids: List[str], prev_gains: Dict[str, float],
                    *, uniform: bool) -> Dict[str, float]:
    """The p_j distribution Alg. 1 Line 15 must have produced for
    `job_ids` given the previous window's final gains — the
    ECCOAllocator.estimate_shares contract re-derived independently
    (new jobs fill at the mean positive known gain; an all-nonpositive
    fleet falls to uniform). `uniform=True` is the patched-baseline
    contract (equal shares regardless of gains)."""
    n = len(job_ids)
    if n == 0:
        return {}
    if uniform:
        return {j: 1.0 / n for j in job_ids}
    known = {j: prev_gains[j] for j in job_ids if j in prev_gains}
    pos_known = [v for v in known.values() if v > 0]
    if pos_known:
        fill = sum(pos_known) / len(pos_known)
        gains = {j: known.get(j, fill) for j in job_ids}
    else:
        gains = {j: 0.0 for j in job_ids}
    pos = {j: max(g, 0.0) for j, g in gains.items()}
    tot = sum(pos.values())
    if tot <= 0:
        return {j: 1.0 / n for j in job_ids}
    return {j: v / tot for j, v in pos.items()}


class InvariantChecker:
    """Asserts the window-level fleet invariants around each
    `run_window` call.

    `bank_exact`: when the controller's engines are exclusive to this
    run, JobBank live-slot counts must EQUAL the live job count after
    draining the deferred-free queue. A shared engine (golden fixture,
    benchmark loops) may carry slots of a previous run's still-
    referenced jobs, so the check relaxes to "the stranger-slot count
    never grows during this run".

    Laws run on host state only: no check reads a job's train-state, so
    a checked window moves no bank row across the host boundary.
    """

    def __init__(self, *, bank_exact: bool = True, label: str = ""):
        self.bank_exact = bank_exact
        self.label = label
        self.windows_checked = 0
        self._prev_gains: Dict[str, float] = {}
        self._prev_groups: Dict[str, str] = {}
        self._churned: Set[str] = set()
        self._bank_extra: Dict[int, int] = {}

    # -- driver hooks --------------------------------------------------
    def before_window(self, ctl, churned_ids: Iterable[str] = ()):
        """Snapshot the pre-window state the laws are relative to. Call
        AFTER applying churn/bandwidth events, BEFORE run_window."""
        self._prev_gains = dict(getattr(ctl.allocator, "last_gains",
                                        None) or {})
        self._prev_groups = {m.stream_id: j.job_id
                             for j in ctl.jobs for m in j.members}
        self._churned = set(churned_ids)

    def after_window(self, ctl, wm, events: Optional[List[dict]] = None):
        """Assert every invariant against the window's outcome.
        `events` is the slice of `ctl.grouper.events` appended during
        this window (None skips event-correspondence)."""
        self._wm = wm
        for check in self._CHECKS:
            check(self, ctl, wm, events)
        self.windows_checked += 1

    def _fail(self, msg: str):
        where = f"{self.label}: " if self.label else ""
        raise InvariantViolation(
            f"{where}window {self.windows_checked} "
            f"(t={getattr(self._wm, 't', '?')}): {msg}")

    # -- transmission (§3.2 / GAIMD) -----------------------------------
    def _check_bandwidth(self, ctl, wm, events):
        cc = ctl.cc
        w, bpt = cc.window_seconds, cc.bytes_per_token
        caps = cc.local_caps or {}
        tol = 1e-6
        extra = set(wm.delivered) - set(wm.bandwidth)
        if extra:
            self._fail(f"delivered tokens for flows with no bandwidth "
                       f"allocation: {sorted(extra)}")
        for sid, bw in wm.bandwidth.items():
            if bw < -tol:
                self._fail(f"negative bandwidth {bw} for {sid}")
            cap = caps.get(sid)
            if cap is not None and bw > cap * (1 + tol) + tol:
                self._fail(f"flow {sid} bandwidth {bw} exceeds local "
                           f"cap {cap}")
            d = wm.delivered.get(sid, 0)
            if d > bw * w / bpt + tol:
                self._fail(f"flow {sid} delivered {d} tokens > "
                           f"bw*W/T = {bw * w / bpt}")
        if wm.bandwidth:
            # the AIMD sawtooth's recorded rates can transiently exceed
            # the bottleneck by at most the fleet's summed additive
            # increase before the multiplicative decrease bites: the
            # recorded per-step sum never exceeds max(C, sum(alpha))
            # (fixpoint of s -> max(C, beta*(s + sum_alpha)), beta=0.5),
            # so the window's time-averaged sum is bounded by it too.
            # ecco mode: alpha_i = p_j/n_j, summing to sum_j p_j <= 1;
            # equal mode: alpha_i = 1 per flow.
            sum_alpha = (len(wm.bandwidth)
                         if ctl.bandwidth_mode == "equal"
                         else sum(wm.shares.values()))
            bound = max(cc.shared_bandwidth, sum_alpha)
            total = sum(wm.bandwidth.values())
            if total > bound * (1 + tol) + tol:
                self._fail(f"fleet bandwidth {total} exceeds shared "
                           f"bound {bound} "
                           f"(C={cc.shared_bandwidth}, "
                           f"sum_alpha={sum_alpha})")

    # -- GPU shares (Alg. 1 Line 15) -----------------------------------
    def _check_shares(self, ctl, wm, events):
        if not wm.shares:
            return
        tol = 1e-6
        total = sum(wm.shares.values())
        if abs(total - 1.0) > tol:
            self._fail(f"GPU shares sum to {total}, not 1")
        for jid, p in wm.shares.items():
            if p < -tol or p > 1 + tol:
                self._fail(f"share {p} for {jid} outside [0, 1]")
        want = expected_shares(
            list(wm.shares), self._prev_gains,
            uniform=_patched(ctl.allocator, "estimate_shares"))
        for jid, p in wm.shares.items():
            if abs(p - want[jid]) > 1e-8:
                self._fail(
                    f"share for {jid} is {p}, expected {want[jid]} "
                    f"from last window's final gains "
                    f"(gain-proportionality, Alg. 1 Line 15)")

    # -- grouping (Alg. 2) ---------------------------------------------
    def _check_groups(self, ctl, wm, events):
        live = {s.stream_id for s in ctl.streams}
        cur: Dict[str, str] = {}
        for jid, members in wm.groups.items():
            for sid in members:
                if sid in cur:
                    self._fail(f"stream {sid} is a member of both "
                               f"{cur[sid]} and {jid}")
                cur[sid] = jid
        stale = set(cur) - live
        if stale:
            self._fail(f"grouped streams not in the fleet: "
                       f"{sorted(stale)}")
        jobs_now = {j.job_id: [m.stream_id for m in j.members]
                    for j in ctl.jobs}
        if jobs_now != wm.groups:
            self._fail(f"wm.groups disagrees with live jobs: "
                       f"{wm.groups} vs {jobs_now}")
        # a previously grouped stream that survived the window must
        # still be grouped somewhere — eviction requeues and regroups
        # in the same update_grouping pass, it never orphans
        dropped = set(self._prev_groups) - set(cur) - self._churned
        if dropped & live:
            self._fail(f"grouped streams lost their group with no "
                       f"churn: {sorted(dropped & live)}")
        if events is None:
            return
        if _patched(ctl.grouper, "group_request") \
                or _patched(ctl.grouper, "update_grouping"):
            # no-grouping baselines: memberships are frozen (their
            # patched update_grouping is a no-op), so any change short
            # of churn is a violation
            for sid, jid in self._prev_groups.items():
                if sid in cur and cur[sid] != jid:
                    self._fail(f"baseline regrouped {sid}: "
                               f"{jid} -> {cur[sid]}")
            return
        joins = {}
        evicts = []
        for e in events:
            if e["kind"] in ("join", "new"):
                joins[e["stream"]] = e["job"]
            elif e["kind"] == "evict":
                evicts.append((e["stream"], e["job"]))
        for sid, jid in cur.items():
            if sid in joins:
                if joins[sid] != jid:
                    self._fail(f"{sid} last joined {joins[sid]} but "
                               f"ended the window in {jid}")
            elif self._prev_groups.get(sid) != jid:
                self._fail(f"{sid} moved "
                           f"{self._prev_groups.get(sid)} -> {jid} "
                           f"with no join/new event")
        for sid, jid in evicts:
            if sid not in live:
                continue
            if cur.get(sid) is None:
                self._fail(f"evicted stream {sid} was not regrouped")
            if cur.get(sid) == jid:
                self._fail(f"{sid} evicted from {jid} yet still a "
                           f"member (Alg. 2 excludes the evicting "
                           f"job from the requeue)")

    # -- plane row residency -------------------------------------------
    def _check_plane_rows(self, ctl, wm, events):
        live = {s.stream_id for s in ctl.streams}
        det = set(ctl.fleet.stream_ids)
        if det != live:
            self._fail(f"drift-detector rows {sorted(det)} != live "
                       f"fleet {sorted(live)}")
        tx = set(ctl.tx_plane.flow_ids)
        if not tx <= live:
            self._fail(f"transmission rows outlive their streams: "
                       f"{sorted(tx - live)}")
        sig = set(ctl.sig_index.state_dict()["row"])
        if not sig <= live:
            self._fail(f"signature-index rows outlive their streams: "
                       f"{sorted(sig - live)}")
        pending = set(ctl.request_time)
        if not pending <= live:
            self._fail(f"pending-request clocks outlive their "
                       f"streams: {sorted(pending - live)}")

    # -- bank / serving-store residency --------------------------------
    def _check_bank(self, ctl, wm, events):
        banks: Dict[int, object] = {}
        jobs_on: Dict[int, int] = {}
        for eng in [ctl.engine] + [getattr(j, "engine", ctl.engine)
                                   for j in ctl.jobs]:
            bank = getattr(eng, "bank", None)
            if bank is not None:
                banks[id(bank)] = bank
                jobs_on.setdefault(id(bank), 0)
        for j in ctl.jobs:
            bank = getattr(getattr(j, "engine", ctl.engine), "bank",
                           None)
            if bank is not None:
                jobs_on[id(bank)] += 1
        # dead jobs queue their slot frees from GC finalizers (cyclic
        # garbage needs a collect) and the bank frees lazily at the
        # next safe point — drain both before counting
        gc.collect()
        for key, bank in banks.items():
            bank.compact()
            extra = len(bank) - jobs_on[key]
            if extra < 0:
                self._fail(f"JobBank holds {len(bank)} live slots for "
                           f"{jobs_on[key]} live jobs")
            if self.bank_exact and extra:
                self._fail(f"JobBank leaked {extra} slots beyond the "
                           f"{jobs_on[key]} live jobs")
            seen = self._bank_extra.setdefault(key, extra)
            if extra > seen:
                self._fail(f"JobBank stranger-slot count grew "
                           f"{seen} -> {extra} during the run "
                           f"(slot leak)")
            self._bank_extra[key] = min(seen, extra)

    def _check_serving(self, ctl, wm, events):
        sp = getattr(ctl, "serve_plane", None)
        if sp is None:
            return
        store = set(sp.store.group_ids)
        live = {j.job_id for j in ctl.jobs}
        if not store <= live:
            self._fail(f"ServingStore rows for dead groups: "
                       f"{sorted(store - live)}")

    _CHECKS = (_check_bandwidth, _check_shares, _check_groups,
               _check_plane_rows, _check_bank, _check_serving)
