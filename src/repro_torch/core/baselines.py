"""Baseline continuous-learning frameworks the paper compares against,
ported from the JAX package's `core/baselines.py`:

* Naive    — independent per-stream retraining, uniform round-robin GPU,
             fixed sampling configuration, equal bandwidth shares.
* Ekya     — independent retraining + microprofiling-based greedy GPU
             allocation (no grouping, no bandwidth coordination).
* RECL     — Ekya + model-zoo reuse (retraining starts from the best
             historical model by subsample accuracy) + content-adaptive
             frame rate (AMS-style), still no bandwidth/GPU coordination.

All reuse ECCO's substrate (SharedEngine jobs, GAIMD fluid network) with
the coordination pieces swapped out, so comparisons isolate the paper's
contributions. As in the reference, a roofline budget reaches them
through `cc` (`ControllerConfig.roofline_budget` / `cost_table`), and
they take no `zoo`: every job of theirs trains on the primary engine.
Unlike the reference's, they take the controller's `mesh`, `elastic` and
`stragglers`, so the four frameworks all run under a fleet mesh.
The grouper's and the allocator's methods are patched on the instance
each window (`InvariantChecker` recognises a patched framework by its
instance attributes).
"""
from __future__ import annotations

from typing import Dict

from repro_torch.core.allocator import RECLAllocator, UniformAllocator
from repro_torch.core.controller import ECCOController, WindowMetrics
from repro_torch.core.grouping import Request
from repro_torch.core.trainer import RetrainJob, SharedEngine
from repro_torch.models.param import tree_map


class IndependentController(ECCOController):
    """Shared machinery for the no-grouping baselines: every retraining
    request becomes its own single-stream job (paper Fig. 1 left)."""

    allocator_cls = UniformAllocator
    use_model_zoo = False
    # no bandwidth coordination: plain AIMD (alpha=1, beta=0.5) equal
    # competition through the FleetTransmissionPlane's equal-share path
    bandwidth_mode = "equal"

    def __init__(self, engine: SharedEngine, streams, cc=None, *, seed=0,
                 mesh=None, elastic=None, stragglers=None):
        """`mesh`, `elastic` and `stragglers` as ECCOController's (the
        reference's baselines take none of them); the elastic window
        protocol wraps the patched window of each framework."""
        super().__init__(engine, streams, cc, seed=seed, mesh=mesh,
                         elastic=elastic, stragglers=stragglers)
        self.allocator = self.allocator_cls()
        self.zoo: Dict[str, dict] = {}

    def _pick_engine(self) -> SharedEngine:
        """Every new job on the primary engine: the baselines take no
        zoo of engines, and their `zoo` holds RECL's model snapshots. The
        reference inherits ECCO's metered placement here, which adds that
        dict to its tier list and raises TypeError once RECL has a
        snapshot under a roofline budget (ROADMAP.md queue 3)."""
        return self.engine


def _independent_group_request(self, jobs, req: Request):
    if self.use_model_zoo and self.zoo:
        best, best_acc = None, -1.0
        for key, state in self.zoo.items():
            acc = self.engine.accuracy(state["params"], req.subsamples)
            if acc > best_acc:
                best, best_acc = key, acc
        # RECL's model selector only proposes zoo models that actually
        # fit the new distribution; emulate with a floor well above
        # random accuracy — without it, wrong-domain warm starts are
        # negative transfer (synthetic domains share no structure)
        floor = max(req.acc, getattr(self, "zoo_reuse_floor", 0.15))
        if best is not None and best_acc >= floor:
            job = RetrainJob(self.engine, req,
                             micro_steps=self.cc.micro_steps,
                             batch=self.cc.train_batch,
                             init_state_tree=_clone_state(self.zoo[best]))
            jobs.append(job)
            return job
    job = self._new_job(req)
    jobs.append(job)
    return job


def _clone_state(state):
    """An independent copy of a state tree. The reference's identity map
    suffices over immutable JAX arrays; here bank rows train in place, so
    a zoo entry and the job seeded from it must share no storage."""
    return tree_map(lambda x: x.detach().clone(), state)


def _device_state(job):
    """The job's current state as a copy on its engine's device (no host
    round trip)."""
    bank = job.engine.bank
    bank.compact()
    return _clone_state(bank.row_device(job._slot.idx))


class NaiveController(IndependentController):
    allocator_cls = UniformAllocator

    def run_window(self) -> WindowMetrics:
        # equal bandwidth, fixed sampling: overwrite the grouped logic by
        # patching grouping + shares
        self.grouper.group_request = lambda jobs, req: \
            _independent_group_request(self, jobs, req)
        self.allocator.estimate_shares = lambda jobs, gains=None: {
            j.job_id: 1.0 / max(1, len(jobs)) for j in jobs}
        # disable regrouping for independent baselines
        self.grouper.update_grouping = lambda jobs, now: []
        return super().run_window()


class EkyaController(NaiveController):
    """Greedy microprofiled allocation, still independent per stream."""
    allocator_cls = RECLAllocator      # total-accuracy greedy (n_j = 1)


class RECLController(EkyaController):
    """Ekya + model zoo + content-adaptive sampling."""
    use_model_zoo = True
    zoo_reuse_floor = 0.15      # emulates RECL's model-selector gating

    def run_window(self) -> WindowMetrics:
        wm = super().run_window()
        # snapshot models into the zoo at window end
        for j in self.jobs:
            for m in j.members:
                self.zoo[f"{m.stream_id}@{wm.t}"] = _device_state(j)
        if len(self.zoo) > 32:
            for k in list(self.zoo)[:-32]:
                del self.zoo[k]
        return wm


# Framework registry shared by the trace harness and chip_smoke.py.
FRAMEWORKS = {
    "ecco": ECCOController,
    "naive": NaiveController,
    "ekya": EkyaController,
    "recl": RECLController,
}
