"""ECCO dynamic camera/stream grouping — Algorithm 2.

Two stages:
  * GroupRequest: a new retraining request joins an existing job iff
    (i) metadata pre-filter passes for EVERY member (request time within
    eps, location within delta), and (ii) the job model's accuracy on the
    request's subsamples beats the request's own current accuracy. Among
    candidates, the best-scoring job wins; otherwise a new job is created.
  * UpdateGrouping: at every retraining-window end, each member whose
    accuracy dropped more than fraction `p` relative to the previous
    window is evicted and re-enters GroupRequest as a fresh request.

Candidate selection scales two ways. Without an index the seed's pure
Python all-pairs scan runs. With a SignatureIndex attached, the
metadata prefilter is one vectorized call over dense fleet arrays, and
`shortlist_k` caps the number of jobs that pay the expensive `eval_on`
model check at the k signature-most-similar (the hand-written
`pairwise_js` kernel on the card). For k >= #passing jobs (or k == 0)
decisions are bit-identical to the Python scan; the index only
requires that all membership mutations flow through this class (else
call index.rebuild(jobs)).

Jobs are duck-typed: .eval_on(samples) -> float, .add_member(req),
.remove_member(stream_id), .members -> list[Request]. When every job
scored in a call is a `RetrainJob` of one batched `SharedEngine`
(`core/trainer.py`; `core/batching.shared_engine` decides), the accuracy
checks of a request and the window-end member evals each run as one
batched `eval_pairs` call, whose accuracies equal the scalar `eval_on`
loop's.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Optional, Sequence

from repro_torch.core.batching import job_precision, shared_engine
from repro_torch.core.signature_index import SignatureIndex


@dataclasses.dataclass
class Request:
    stream_id: str
    t: float                      # drift-detection time
    loc: Sequence[float]          # (x, y) location / trajectory centroid
    subsamples: Any               # eval data for the performance check
    acc: float                    # current (drifted) model accuracy
    model: Any = None             # the device's current model (job seed)
    train_data: Any = None        # sampled frames to contribute
    sig: Any = None               # drift-signature histogram (buckets,)
    # bookkeeping for periodic reevaluation
    acc_prev: Optional[float] = None
    last_job: Optional[str] = None   # job that just evicted this member


def _dist(a, b) -> float:
    return math.sqrt(sum((float(x) - float(y)) ** 2 for x, y in zip(a, b)))


class Grouper:
    def __init__(self, *, eps_t: float = 60.0, delta_loc: float = 100.0,
                 p_drop: float = 0.1,
                 new_job_fn: Callable[[Request], Any] = None,
                 index: Optional[SignatureIndex] = None,
                 shortlist_k: int = 0, rescore_margin: float = 0.0):
        self.eps_t = eps_t
        self.delta_loc = delta_loc
        self.p_drop = p_drop
        self.new_job_fn = new_job_fn
        self.index = index               # fleet signature/metadata arrays
        self.shortlist_k = shortlist_k   # 0 = evaluate every passing job
        # fp32-screen/rescore discipline for reduced-precision fleets
        # (docs/scheduling.md): a bf16 job whose screened accuracy
        # lands within `rescore_margin` of a join/evict threshold is
        # re-scored once in fp32 and the decision uses the fp32 value.
        # 0.0 (default) + all-fp32 fleet = the seed decision path.
        self.rescore_margin = float(rescore_margin)
        self.rescores = 0                # fp32 rescores taken
        self.events: List[dict] = []     # grouping decisions (for Fig. 9)

    def _rescore(self, job, samples, screened: float,
                 threshold: float) -> float:
        """fp32 rescore of a near-threshold reduced-precision screen;
        passthrough for fp32 jobs, wide margins, or duck-typed jobs
        whose eval_on has no precision knob."""
        if (self.rescore_margin <= 0.0 or job_precision(job) == "fp32"
                or abs(screened - threshold) > self.rescore_margin):
            return screened
        try:
            acc = float(job.eval_on(samples, precision="fp32"))
        except TypeError:
            return screened
        self.rescores += 1
        return acc

    # -- candidate selection --------------------------------------------------
    def _python_candidates(self, jobs: List, req: Request) -> List[int]:
        """Seed all-pairs metadata scan (reference path, O(fleet))."""
        out = []
        for idx, job in enumerate(jobs):
            if not job.members:
                continue
            # a member evicted for diverging must not rejoin the same
            # job this round (its model trivially scores >= the member's
            # own accuracy — it IS the member's model); the paper
            # initiates a separate retraining job for it
            if req.last_job is not None and job.job_id == req.last_job:
                continue
            correlated = all(
                abs(r.t - req.t) <= self.eps_t
                and _dist(r.loc, req.loc) <= self.delta_loc
                for r in job.members)
            if correlated:
                out.append(idx)
        return out

    def _index_candidates(self, jobs: List, req: Request) -> List[int]:
        """Vectorized prefilter + batched-JS top-k via the index."""
        keys = self.index.candidate_jobs(
            req.t, req.loc, eps_t=self.eps_t, delta_loc=self.delta_loc,
            exclude_job=req.last_job, sig=req.sig, k=self.shortlist_k)
        if not keys:
            return []
        key_to_idx = self.index.key_to_position(jobs)
        return sorted(key_to_idx[k] for k in keys if k in key_to_idx)

    # -- Alg. 2 GroupRequest -------------------------------------------------
    def group_request(self, jobs: List, req: Request):
        if self.index is not None:
            self.index.upsert(req.stream_id, req.t, req.loc, req.sig)
            cand_idx = self._index_candidates(jobs, req)
        else:
            cand_idx = self._python_candidates(jobs, req)
        candidates: Dict[int, float] = {}
        if cand_idx:
            cjobs = [jobs[i] for i in cand_idx]
            eng = shared_engine(cjobs)
            if eng is not None:     # all candidates scored in one call
                accs = eng.eval_pairs([(cj, req.subsamples)
                                       for cj in cjobs])
            else:
                # fleetlint: disable=per-member-loop -- documented
                # scalar fallback when the probe rejects the candidate
                # set (fake test jobs, mixed engines); bit-identical
                accs = [cj.eval_on(req.subsamples) for cj in cjobs]
            for idx, acc_j in zip(cand_idx, accs):   # ascending: ties
                acc_j = self._rescore(jobs[idx], req.subsamples,
                                      acc_j, req.acc)
                if acc_j >= req.acc:   # resolve to the oldest passing job
                    candidates[idx] = acc_j
        if candidates:
            best = max(candidates, key=candidates.get)
            jobs[best].add_member(req)
            if self.index is not None:
                self.index.assign(req.stream_id, jobs[best].job_id)
            self.events.append({"kind": "join", "stream": req.stream_id,
                                "job": jobs[best].job_id, "t": req.t,
                                "acc_gain": candidates[best] - req.acc})
            return jobs[best]
        job = self.new_job_fn(req)
        jobs.append(job)
        if self.index is not None:
            self.index.assign(req.stream_id, job.job_id)
        self.events.append({"kind": "new", "stream": req.stream_id,
                            "job": job.job_id, "t": req.t})
        return job

    # -- Alg. 2 UpdateGrouping ------------------------------------------------
    def update_grouping(self, jobs: List, now: float):
        """Window-end reevaluation. Returns list of re-queued requests.

        The reference accuracy is an EMA over windows rather than the
        raw previous value: young models oscillate window-to-window and
        a raw comparison evicts on training noise, while a true second
        drift collapses accuracy far below any smoothed reference.
        """
        requeued: List[Request] = []
        # window-end member evals: ONE batched fleet call. Eval mutates
        # nothing, membership only shrinks during the loop, and a
        # member belongs to exactly one job — so a snapshot taken here
        # covers every (job, member) eval the loop performs.
        cached: Dict[tuple, float] = {}
        eng = shared_engine(jobs) if jobs else None
        if eng is not None:
            snap = [(job, r) for job in jobs for r in job.members]
            accs = eng.eval_pairs([(job, r.subsamples) for job, r in snap])
            cached = {(id(job), id(r)): a
                      for (job, r), a in zip(snap, accs)}
        for job in list(jobs):
            # fleetlint: disable=per-member-loop -- eval_on only runs
            # on the probe-rejected path (cache miss); probe-positive
            # fleets were pre-scored by the eval_pairs call above
            for r in list(job.members):
                key = (id(job), id(r))
                acc_n = (cached[key] if key in cached
                         else job.eval_on(r.subsamples))
                if r.acc_prev is not None and r.acc_prev > 0:
                    # evict threshold in accuracy units:
                    # acc_n < acc_prev * (1 - p_drop)
                    acc_n = self._rescore(
                        job, r.subsamples, acc_n,
                        r.acc_prev * (1.0 - self.p_drop))
                    rel = (acc_n - r.acc_prev) / r.acc_prev
                    if rel < -self.p_drop:       # second drift detected
                        job.remove_member(r.stream_id)
                        if self.index is not None:
                            # detach now: later requeues this round must
                            # not see the evicted row as a member
                            self.index.unassign(r.stream_id)
                        r.t = now
                        r.acc = acc_n
                        r.acc_prev = None
                        r.last_job = job.job_id
                        requeued.append(r)
                        self.events.append({"kind": "evict",
                                            "stream": r.stream_id,
                                            "job": job.job_id, "t": now})
                        continue
                    r.acc_prev = 0.5 * r.acc_prev + 0.5 * acc_n
                else:
                    r.acc_prev = acc_n
        # drop empty jobs, then re-group evicted members
        jobs[:] = [j for j in jobs if j.members]
        for r in requeued:
            self.group_request(jobs, r)
        return requeued
