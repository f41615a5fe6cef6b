"""ECCO GPU (accelerator) allocation for group retraining — Algorithm 1,
ported from the JAX package's `core/allocator.py`. Host Python: the
accuracies arrive as Python floats and the objective's arithmetic runs
in float64, as the reference's does, so shares and greedy picks are the
reference's bit for bit.

The allocator time-shares the accelerator across retraining jobs in
micro-windows. Each micro-window is greedily granted to the job with the
highest *objective gain* under the paper's objective (Eq. 1):

    max  alpha * sum_j n_j^beta A_j(g_j) / sum_j n_j^beta  +  min_j A_j(g_j)

The fairness term gives the lowest-accuracy job a bonus equal to its raw
accuracy gain, preventing starvation of small groups (paper §3.1).

Jobs are duck-typed: they expose
    .num_members          -> int (n_j)
    .eval()               -> float accuracy in [0, 1]
    .train_micro()        -> None (train for one micro-window)

`RECLAllocator` reproduces the baseline allocator ECCO compares against
(objective = total accuracy improvement, i.e. size-weighted, no fairness
term; paper Fig. 10).

`meter=` (roofline budgets), `stragglers=`, `deadline=` and `barrier=`
are duck-typed as in the reference and port as they are; the port has
no roofline meter of its own yet (ROADMAP.md queue 1 item 5).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Sequence

from repro_torch.core.batching import engine_groups, shared_engine


@dataclasses.dataclass
class AllocationTrace:
    """Per-micro-window record of who ran and the measured accuracies."""
    order: List[str]                      # job id per micro-window
    acc: Dict[str, List[float]]           # accuracy trajectory per job
    shares: Dict[str, float]              # estimated GPU share p_j
    gpu_time: Dict[str, int]              # micro-windows consumed per job
    # explicit window annotations (e.g. the eval-only degrade of a
    # window whose budget is smaller than one micro-step) — empty on
    # the seed path, so golden traces never see it
    notes: List[str] = dataclasses.field(default_factory=list)
    # WindowBudget.report() of the window's meter (roofline-metered
    # windows only; None on the seed unitless path)
    budget: Optional[Dict] = None


class ECCOAllocator:
    def __init__(self, alpha: float = 1.0, beta: float = 0.5):
        self.alpha = alpha
        self.beta = beta
        # final objective gains of the last completed window (Alg. 1
        # Line 15) — what estimate_shares serves between windows
        self.last_gains: Dict[str, float] = {}

    # -- objective gain (Alg. 1, CalObjectiveGain) --------------------------
    def _objective_gains(self, jobs, acc, acc_gain):
        nbeta = {j.job_id: j.num_members ** self.beta for j in jobs}
        denom = sum(nbeta.values()) or 1.0
        # jobs that never got a micro-window (budget < |J|) have no
        # measured gain yet; treat as 0 rather than KeyError
        gains = {j.job_id: self.alpha * nbeta[j.job_id] / denom
                 * acc_gain.get(j.job_id, 0.0) for j in jobs}
        if acc:
            worst = min(acc, key=acc.get)
            gains[worst] = gains.get(worst, 0.0) + acc_gain.get(worst, 0.0)
        return gains

    def _shares_from_gains(self, jobs, gains) -> Dict[str, float]:
        pos = {j.job_id: max(gains.get(j.job_id, 0.0), 0.0) for j in jobs}
        tot = sum(pos.values())
        if tot <= 0:
            return {j.job_id: 1.0 / len(jobs) for j in jobs}
        return {k: v / tot for k, v in pos.items()}

    # -- Alg. 1 main loop ----------------------------------------------------
    def run_window(self, jobs: Sequence, window_micro: int, *,
                   stragglers=None, deadline: Optional[float] = None,
                   clock: Optional[Callable[[], float]] = None,
                   barrier: Optional[Callable[[], None]] = None,
                   meter=None) -> AllocationTrace:
        """Run one retraining window of `window_micro` micro-windows.

        `meter`: optional roofline meter (duck-typed). When set, each
        micro-window is converted into metered roofline cost (the job's
        own model config, batch, and precision policy price it) and
        charged against the meter's fleet-wide WindowBudget; the greedy
        pick maximizes objective gain PER METERED COST, so a
        budget-pressured fleet prefers jobs whose backbone/precision is
        cheaper instead of starving. `window_micro` stays an upper
        bound on micro-window count. A window whose remaining budget
        cannot afford one micro-step for ANY job (or window_micro <= 0)
        degrades to an eval-only window with an explicit trace note
        instead of silently doing nothing. None = the seed unitless
        path, byte-identical (golden traces).

        `stragglers`: optional straggler policy (duck-typed).
        When set, every micro-window is wall-clock timed per job and a
        flagged straggler's next micro-window runs under a shrunken
        step quota (quota re-normalization) — the allocator then
        measures a smaller AccGain for it and de-prioritizes it, the
        paper's own feedback loop doing double duty. Timing needs
        per-job launches, so the batched initial pass is traded for
        the (bit-identical) scalar loop while a policy is attached.

        `deadline`: optional wall-clock budget (seconds) for this
        window, measured by `clock` (default time.monotonic; tests
        inject a fake). Once exceeded, no further greedy micro-windows
        are granted — leftover budget is dropped so a straggling fleet
        can't stretch the window (straggler-aware window deadline).

        `barrier`: optional callable invoked before every micro-window
        — an elastic runtime's health-check point; it raises to abort
        the window.

        All four default to None/off, leaving the window byte-identical
        to the seed path (golden traces).
        """
        jobs = list(jobs)
        if not jobs:          # update_grouping may have dropped every job
            return AllocationTrace(order=[], acc={}, shares={}, gpu_time={})
        clock = clock if clock is not None else time.monotonic
        t0 = clock()
        budget = window_micro
        acc: Dict[str, float] = {}
        acc_gain: Dict[str, float] = {}
        order: List[str] = []
        traj: Dict[str, List[float]] = {j.job_id: [] for j in jobs}
        used: Dict[str, int] = {j.job_id: 0 for j in jobs}
        notes: List[str] = []
        # per-window metered price of one micro-window per job (the
        # meter caches compiled costs, so this is dict math)
        micro_cost: Optional[Dict[str, float]] = None
        if meter is not None:
            micro_cost = {j.job_id: max(meter.micro_cost(j), 1e-12)
                          for j in jobs}

        def record(j, a_i, a_f):
            # the ONE bookkeeping path for a measured micro-window —
            # batched and scalar passes must stay field-for-field
            # identical (bit-identity contract, golden-trace pinned)
            nonlocal budget
            budget -= 1
            if meter is not None:
                meter.charge(meter.train_cost(j), "train")
                meter.charge(2 * meter.eval_cost(j), "eval")
            acc[j.job_id] = a_f
            acc_gain[j.job_id] = a_f - a_i
            order.append(j.job_id)
            traj[j.job_id].append(a_f)
            used[j.job_id] += 1

        def eval_only(reason: str) -> AllocationTrace:
            # the degraded window: no training, but the fleet is still
            # MEASURED once (the controller's shares/metrics consumers
            # need accuracies), and the trace says why out loud.
            # last_gains is left untouched so estimate_shares keeps
            # serving the last real window's signal.
            notes.append(reason)
            vals: List[float] = [0.0] * len(jobs)
            # per-engine batched dispatch: a zoo fleet (mixed engines)
            # still evals each model class in one fleet call
            for grp_eng, idxs in engine_groups(jobs):
                if grp_eng is None:
                    for i in idxs:
                        vals[i] = jobs[i].eval()
                else:
                    sub = grp_eng.eval_jobs([jobs[i] for i in idxs])
                    for i, a in zip(idxs, sub):
                        vals[i] = a
            for j, a in zip(jobs, vals):
                acc[j.job_id] = float(a)
                traj[j.job_id].append(float(a))
                if meter is not None:
                    meter.charge(meter.eval_cost(j), "eval")
            return AllocationTrace(
                order=order, acc=traj,
                shares=self._shares_from_gains(jobs, {}), gpu_time=used,
                notes=notes,
                budget=meter.report() if meter is not None else None)

        if window_micro <= 0:
            return eval_only(
                f"window_micro={window_micro} < 1 micro-window: degraded "
                f"to eval-only window")
        if meter is not None and \
                not any(meter.can_afford(micro_cost[j.job_id])
                        for j in jobs):
            return eval_only(
                f"roofline budget (remaining "
                f"{meter.budget.remaining:.3e}s) smaller than one "
                f"micro-step for every job: degraded to eval-only window")

        def micro_retraining(j):
            if barrier is not None:
                barrier()
            if stragglers is None:
                a_i = j.eval()
                j.train_micro()
                record(j, a_i, j.eval())
                return
            base = j.micro_steps
            ts = clock()
            try:
                # quota re-normalization: a straggler trains fewer
                # steps this micro-window so its wall time re-joins
                # the fleet median
                j.micro_steps = stragglers.quota(j.job_id, base)
                a_i = j.eval()
                j.train_micro()
                record(j, a_i, j.eval())
            finally:
                j.micro_steps = base
            stragglers.record(j.job_id, clock() - ts)

        # initial training pass — with a batch-capable engine the whole
        # fleet's measurement collapses to three fleet calls (eval all,
        # one micro-window for all, eval all) instead of 4|J| member
        # launches. Bit-identical to the per-job micro_retraining loop:
        # jobs are independent (own state, own rng, own pool), so
        # reordering eval/train across jobs changes nothing per job.
        # Each entry point compacts the bank and flushes host-dirty
        # state rows to the device-resident stack before capturing slot
        # indices (the residency contract in repro_torch.core.batching), so
        # the measurement pass itself moves no state across the host
        # boundary.
        if meter is None:
            head = jobs[:min(budget, len(jobs))]
        else:
            # metered initial pass: grant first micro-windows in fleet
            # order while the window budget can afford them; jobs left
            # out simply have no measured gain yet (0.0 in the
            # objective), exactly like budget < |J| on the seed path
            head, rem = [], meter.budget.remaining
            for j in jobs:
                if len(head) >= budget:
                    break
                c = micro_cost[j.job_id]
                if rem - c < -1e-12 * max(1.0, meter.budget.total):
                    continue
                head.append(j)
                rem -= c
        eng = shared_engine(head) if (head and stragglers is None) \
            else None
        if eng is not None:
            if barrier is not None:
                barrier()
            a_i = eng.eval_jobs(head)
            eng.train_micro_many(head)
            a_f = eng.eval_jobs(head)
            for j, ai, af in zip(head, a_i, a_f):
                record(j, ai, af)
        else:
            for j in head:
                micro_retraining(j)
        gains = self._objective_gains(jobs, acc, acc_gain)

        by_id = {j.job_id: j for j in jobs}
        while budget > 0:
            if deadline is not None and clock() - t0 >= deadline:
                break     # window deadline: drop the leftover budget
            if meter is None:
                jid = max(gains, key=gains.get)
            else:
                # Alg. 1 objective with metered cost in the
                # denominator: accuracy gain per modeled device-second,
                # restricted to jobs the remaining budget can afford —
                # a cheaper backbone/precision wins ties against an
                # equally-improving expensive one
                afford = [k for k in gains
                          if meter.can_afford(micro_cost[k])]
                if not afford:
                    notes.append(
                        "roofline budget exhausted: "
                        f"{budget} micro-window(s) dropped")
                    break
                jid = max(afford, key=lambda k: gains[k] / micro_cost[k])
            micro_retraining(by_id[jid])
            gains = self._objective_gains(jobs, acc, acc_gain)

        # GPU-share estimate for the transmission controller (§3.2):
        # Alg. 1 Line 15 derives p_j from the *final* gains of the
        # window, not the post-initial-pass snapshot
        self.last_gains = dict(gains)
        shares = self._shares_from_gains(jobs, gains)
        return AllocationTrace(order=order, acc=traj, shares=shares,
                               gpu_time=used, notes=notes,
                               budget=meter.report() if meter is not None
                               else None)

    def estimate_shares(self, jobs, gains=None) -> Dict[str, float]:
        """p_j from the latest objective gains (Line 15 of Alg. 1)."""
        if gains is None:
            known = {j.job_id: self.last_gains[j.job_id] for j in jobs
                     if j.job_id in self.last_gains}
            pos_known = [v for v in known.values() if v > 0]
            if pos_known:
                # jobs created since the last window have no measured
                # gain; seed them at the mean positive gain so new
                # groups are not starved of bandwidth before their
                # first micro-window
                fill = sum(pos_known) / len(pos_known)
                gains = {j.job_id: known.get(j.job_id, fill)
                         for j in jobs}
            else:
                # no job measured a positive gain last window (converged
                # or noisy fleet): there is no signal to apportion, so
                # every job — old or new — falls through to the uniform
                # branch of _shares_from_gains
                gains = {j.job_id: 0.0 for j in jobs}
        if not jobs:
            return {}
        return self._shares_from_gains(jobs, gains)


class RECLAllocator(ECCOAllocator):
    """Baseline allocator (RECL/Ekya-style): maximize total accuracy
    improvement; groups weighted by member count, no fairness term."""

    def _objective_gains(self, jobs, acc, acc_gain):
        return {j.job_id: j.num_members * acc_gain.get(j.job_id, 0.0)
                for j in jobs}


class UniformAllocator(ECCOAllocator):
    """Naive baseline: round-robin micro-windows, no measurement-driven
    choices."""

    def run_window(self, jobs: Sequence, window_micro: int, *,
                   barrier=None, **_ignored) -> AllocationTrace:
        jobs = list(jobs)
        if not jobs:
            return AllocationTrace(order=[], acc={}, shares={}, gpu_time={})
        order, traj, used = [], {j.job_id: [] for j in jobs}, \
            {j.job_id: 0 for j in jobs}
        acc = {}
        # round-robin, one full round per batched (train all, eval all)
        # pair of fleet calls; per-job numbers are identical to the
        # seed's interleaved train/eval loop because jobs are
        # independent
        eng = shared_engine(jobs)
        done = 0
        while done < window_micro:
            if barrier is not None:
                barrier()
            rnd = jobs[:min(len(jobs), window_micro - done)]
            if eng is not None:
                eng.train_micro_many(rnd)
                accs = eng.eval_jobs(rnd)
            else:
                accs = []
                for j in rnd:
                    j.train_micro()
                    accs.append(j.eval())
            for j, a in zip(rnd, accs):
                acc[j.job_id] = a
                order.append(j.job_id)
                traj[j.job_id].append(a)
                used[j.job_id] += 1
            done += len(rnd)
        shares = {j.job_id: 1.0 / len(jobs) for j in jobs}
        return AllocationTrace(order=order, acc=traj, shares=shares,
                               gpu_time=used)
