"""Fleet-wide drift-signature index: the batched half of Alg. 2.

The seed's GroupRequest scans every member of every job in pure Python
(metadata prefilter) and then pays a model evaluation per surviving
job — O(fleet) Python work per request, which cannot reach the
ROADMAP's 10k-stream scale. The index keeps the fleet's request
metadata and drift signatures as dense arrays:

    t    (cap,)          request/drift-detection time
    loc  (cap, 2)        location / trajectory centroid
    sig  (cap, buckets)  latest drift histogram (token_histogram)
    job  (cap,)          interned job key, -1 = unassigned

so one `candidate_jobs` call answers "which jobs pass the time/location
prefilter for request r, ranked by signature similarity" with a
vectorized numpy prefilter plus one batched Jensen-Shannon call
(kernels.ops.pairwise_js: the hand-written `pairwise_js` kernel on a
CUDA device, the plain version on the CPU). The Grouper then runs the
expensive `eval_on` model check only on the top-k shortlist.

The arrays stay on the host, as in the reference: each shortlist call
copies the request signatures and the full capacity block to the
index's `device`, and copies the (R, capacity) matrix back before the
host gathers, masks and ranks it exactly as the reference does.

Exactness: the prefilter reproduces the Python scan bit-for-bit (same
float64 ops in the same order), so for k >= #passing jobs the grouping
decisions are identical to the seed's Alg. 2 loop. The index must see
every membership change — the Grouper owns it and updates it in
group_request / update_grouping; after mutating jobs externally, call
`rebuild(jobs)`.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.kernels import ops


class SignatureIndex:
    def __init__(self, buckets: int = 64, capacity: int = 64,
                 *, impl: str = "auto", device="cuda"):
        if impl not in ops.IMPLS:
            raise ValueError(f"unknown pairwise_js impl {impl!r}; use one "
                             f"of {ops.IMPLS}")
        self.buckets = buckets
        self.impl = impl           # kernels.ops.pairwise_js backend
        self.device = resolve_device(device)   # where the shortlist runs
        cap = max(8, int(capacity))
        self._sig = np.zeros((cap, buckets), np.float32)
        self._has_sig = np.zeros(cap, bool)
        self._t = np.zeros(cap, np.float64)
        self._loc = np.zeros((cap, 2), np.float64)
        self._job = np.full(cap, -1, np.int64)
        self._active = np.zeros(cap, bool)
        self._row: Dict[str, int] = {}
        self._free: List[int] = list(range(cap - 1, -1, -1))
        self._jobkey: Dict[str, int] = {}
        self._gen = 0              # bumped on any mutation
        self._seg_gen = -1         # generation the segment cache is at
        self._seg = None           # (rows_sorted, starts, seg_keys)

    # -- bookkeeping --------------------------------------------------------
    def __len__(self) -> int:
        return len(self._row)

    @property
    def capacity(self) -> int:
        return self._sig.shape[0]

    def _grow(self):
        old = self.capacity
        new = old * 2
        self._sig = np.concatenate(
            [self._sig, np.zeros((old, self.buckets), np.float32)])
        self._has_sig = np.concatenate([self._has_sig, np.zeros(old, bool)])
        self._t = np.concatenate([self._t, np.zeros(old, np.float64)])
        self._loc = np.concatenate([self._loc, np.zeros((old, 2), np.float64)])
        self._job = np.concatenate([self._job, np.full(old, -1, np.int64)])
        self._active = np.concatenate([self._active, np.zeros(old, bool)])
        self._free.extend(range(new - 1, old - 1, -1))

    def job_key(self, job_id: str) -> int:
        """Intern a job id (keys are dense ints in creation order)."""
        key = self._jobkey.get(job_id)
        if key is None:
            key = len(self._jobkey)
            self._jobkey[job_id] = key
        return key

    def key_to_position(self, jobs) -> Dict[int, int]:
        """job key -> position in `jobs`. Deliberately uncached: the
        dict is O(|jobs|) to build, and any cache keyed on the list's
        identity/length is unsound under drop+append churn (the list
        can return to a prior length with different contents)."""
        return {self.job_key(job.job_id): idx
                for idx, job in enumerate(jobs)}

    # -- mutation -----------------------------------------------------------
    def _set_sig(self, row: int, sig):
        s = np.asarray(sig, np.float32).reshape(-1)
        if s.shape[0] != self.buckets:
            raise ValueError(f"signature has {s.shape[0]} buckets, "
                             f"index holds {self.buckets}")
        self._sig[row] = s
        self._has_sig[row] = True

    def upsert(self, stream_id: str, t: float, loc, sig=None) -> int:
        """Insert/refresh a stream's request row; clears job assignment
        (a stream re-enters the index exactly when it becomes a free
        retraining request)."""
        self._gen += 1
        row = self._row.get(stream_id)
        if row is None:
            if not self._free:
                self._grow()
            row = self._free.pop()
            self._row[stream_id] = row
        self._t[row] = float(t)
        self._loc[row, 0] = float(loc[0])
        self._loc[row, 1] = float(loc[1])
        if sig is not None:
            self._set_sig(row, sig)
        self._active[row] = True
        self._job[row] = -1
        return row

    def refresh_sig(self, stream_id: str, sig):
        """Update a stream's drift signature in place, PRESERVING its
        job assignment (upsert clears it: it models a stream re-entering
        as a free request). The controller calls this at window end so
        the top-k shortlist scores a job's members by their current
        distribution, not the histograms they joined with."""
        row = self._row.get(stream_id)
        if row is None:
            return
        self._gen += 1
        self._set_sig(row, sig)

    def assign(self, stream_id: str, job_id: str):
        self._gen += 1
        self._job[self._row[stream_id]] = self.job_key(job_id)

    def unassign(self, stream_id: str):
        row = self._row.get(stream_id)
        if row is not None:
            self._gen += 1
            self._job[row] = -1

    def remove(self, stream_id: str):
        row = self._row.pop(stream_id, None)
        if row is not None:
            self._gen += 1
            self._active[row] = False
            self._has_sig[row] = False
            self._job[row] = -1
            self._free.append(row)

    # -- snapshot / restore (elastic window rollback) -----------------------
    def state_dict(self) -> dict:
        return {"sig": self._sig.copy(), "has_sig": self._has_sig.copy(),
                "t": self._t.copy(), "loc": self._loc.copy(),
                "job": self._job.copy(), "active": self._active.copy(),
                "row": dict(self._row), "free": list(self._free),
                "jobkey": dict(self._jobkey)}

    def load_state_dict(self, state: dict):
        self._sig = state["sig"].copy()
        self._has_sig = state["has_sig"].copy()
        self._t = state["t"].copy()
        self._loc = state["loc"].copy()
        self._job = state["job"].copy()
        self._active = state["active"].copy()
        self._row = dict(state["row"])
        self._free = list(state["free"])
        self._jobkey = dict(state["jobkey"])
        self._gen += 1              # invalidate the segment cache

    def rebuild(self, jobs):
        """Re-derive membership from a jobs list mutated externally."""
        self._job[:] = -1
        known = set()
        for job in jobs:
            for m in job.members:
                sig = getattr(m, "sig", None)
                self.upsert(m.stream_id, m.t, m.loc, sig)
                self.assign(m.stream_id, job.job_id)
                known.add(m.stream_id)
        for sid in [s for s in self._row if s not in known]:
            self.remove(sid)

    # -- the vectorized queries ---------------------------------------------
    def _segments(self):
        """Member rows grouped by job key, cached until the next mutation.

        Returns (rows_sorted, starts, seg_keys, meta) where meta packs
        the gathered per-row (t, x, y, has_sig) in segment order;
        `starts` are reduceat segment boundaries and seg_keys is
        ascending (== job creation order).
        """
        if self._seg is not None and self._seg_gen == self._gen:
            return self._seg
        rows = np.nonzero(self._active & (self._job >= 0))[0]
        keys = self._job[rows]
        order = np.argsort(keys, kind="stable")
        rows_sorted = rows[order]
        keys_sorted = keys[order]
        if rows_sorted.size:
            starts = np.nonzero(
                np.r_[True, keys_sorted[1:] != keys_sorted[:-1]])[0]
            seg_keys = keys_sorted[starts]
        else:
            starts = np.zeros(0, np.int64)
            seg_keys = np.zeros(0, np.int64)
        mt = self._t[rows_sorted]
        if starts.size:
            sizes = np.diff(np.r_[starts, mt.size])
            tmin = np.minimum.reduceat(mt, starts)
            tmax = np.maximum.reduceat(mt, starts)
        else:
            sizes = np.zeros(0, np.int64)
            tmin = tmax = np.zeros(0, np.float64)
        meta = (mt, self._loc[rows_sorted, 0], self._loc[rows_sorted, 1],
                self._has_sig[rows_sorted], tmin, tmax, sizes)
        self._seg = (rows_sorted, starts, seg_keys, meta)
        self._seg_gen = self._gen
        return self._seg

    def candidate_jobs(self, t: float, loc, *, eps_t: float,
                       delta_loc: float, exclude_job: Optional[str] = None,
                       sig=None, k: int = 0) -> List[int]:
        """Job keys whose EVERY member passes the time/location prefilter
        (Alg. 2 line 4), shortlisted to the k signature-most-similar
        when k > 0 and a request signature is given. Ascending key order
        (== job creation order)."""
        return self.candidate_jobs_batch(
            [t], [loc], eps_t=eps_t, delta_loc=delta_loc,
            exclude_jobs=[exclude_job],
            sigs=None if sig is None else [sig], k=k)[0]

    def candidate_jobs_batch(self, ts, locs, *, eps_t: float,
                             delta_loc: float, exclude_jobs=None,
                             sigs=None, k: int = 0) -> List[List[int]]:
        """Answer R grouping requests in one shot.

        Two exact pruning stages before any per-pair work:
          1. per-JOB time window on (R, jobs): every member within eps_t
             of the request iff tmax - tau <= eps_t and tau - tmin <=
             eps_t (IEEE subtraction is monotonic, so folding the
             per-member |t_i - tau| <= eps_t test into the segment
             min/max is bit-exact);
          2. per-member distance check only for members of
             time-surviving (request, job) pairs, folded per pair with
             reduceat.
        The top-k shortlist adds one (R, fleet) batched pairwise-JS
        kernel call.
        """
        nq = len(ts)
        if nq == 0:
            return []
        rows_sorted, starts, seg_keys, (mt, mx, my, mhas, tmin, tmax,
                                        sizes) = self._segments()
        if seg_keys.size == 0:
            return [[] for _ in range(nq)]
        tq = np.asarray(ts, np.float64)[:, None]
        lq = np.asarray(locs, np.float64).reshape(nq, 2)
        time_ok = (tmax[None, :] - tq <= eps_t) \
            & (tq - tmin[None, :] <= eps_t)                     # (R, jobs)
        jr, jc = np.nonzero(time_ok)                            # pairs
        if jr.size:
            ln = sizes[jc]
            cl = np.cumsum(ln)
            offs = np.arange(cl[-1]) - np.repeat(cl - ln, ln)
            mrow = np.repeat(starts[jc], ln) + offs   # member seg positions
            req = np.repeat(jr, ln)
            dx = mx[mrow] - lq[req, 0]
            dy = my[mrow] - lq[req, 1]
            okm = np.sqrt(dx * dx + dy * dy) <= delta_loc
            pair_ok = np.logical_and.reduceat(okm, cl - ln)
            pr, pc = jr[pair_ok], jc[pair_ok]   # row-major: pc asc within pr
        else:
            pr = pc = jr
        parts = np.split(pc, np.searchsorted(pr, np.arange(1, nq)))

        jobmin = None
        if k and sigs is not None:
            q = np.stack([np.asarray(s, np.float32).reshape(-1)
                          for s in sigs])
            # score against the full capacity block, as the reference
            # does (inactive rows are all-zero and stay finite); the
            # host ranks the copied-back matrix
            d = ops.pairwise_js(torch.from_numpy(q).to(self.device),
                                torch.from_numpy(self._sig).to(self.device),
                                impl=self.impl).cpu().numpy()
            d = d[:, rows_sorted].astype(np.float64)
            d = np.where(mhas[None, :], d, np.inf)
            jobmin = np.minimum.reduceat(d, starts, axis=1)     # (R, jobs)

        plain = (not k or jobmin is None) and (
            exclude_jobs is None or all(e is None for e in exclude_jobs))
        if plain:
            return [seg_keys[pos].tolist() for pos in parts]
        out: List[List[int]] = []
        for r, pos in enumerate(parts):
            ex = exclude_jobs[r] if exclude_jobs is not None else None
            if ex is not None:
                ek = self._jobkey.get(ex)
                if ek is not None:
                    pos = pos[seg_keys[pos] != ek]
            if k and pos.size > k and jobmin is not None:
                pos = np.sort(pos[np.argsort(jobmin[r, pos],
                                             kind="stable")[:k]])
            out.append(seg_keys[pos].tolist())
        return out
