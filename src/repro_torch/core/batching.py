"""Duck-typed probe wiring a batched training plane (a JobBank of
stacked job states behind one SharedEngine) into the
allocator/grouper/controller loops.

Those loops operate on duck-typed jobs (their tests drive them with
scripted fakes), so the batched fast paths must not assume RetrainJob.
`shared_engine(jobs)` answers "can this set of jobs be measured and
trained in batched fleet calls?": every job must be a live handle in
the SAME SharedEngine's JobBank and the engine must have batching
enabled. Callers fall back to the seed per-job loop on None; the
batched and scalar paths must be bit-identical, so the probe only
decides dispatch cost, never decisions.

This port has no trainer yet (`core/trainer.py` is queued in
ROADMAP.md): every job the grouping plane sees is duck-typed,
`shared_engine` returns None, and the scalar `eval_on` path runs. The
probe is copied whole so that the grouper's dispatch is the reference's
line for line once the trainer lands.

Residency contract (docs/training_plane.md): dispatch sites never
touch bank rows directly. A probe-positive engine guarantees that its
batched entry points (eval_pairs / eval_jobs / train_micro_many)
compact the bank AND flush host-dirty rows (`bank.sync_to_device`)
BEFORE capturing any slot index, so host-side state writes made since
the last fleet call — checkpoint restores, model-zoo seeding,
`job.state = ...` — are visible to the fleet call without the caller
doing anything. An engine whose bank lacks the compact/sync protocol
cannot uphold that ordering, so the probe rejects it and the caller
stays on the scalar loop.
"""
from __future__ import annotations

from typing import Dict, List, Tuple


def job_precision(job) -> str:
    """A job's decision-plane screen precision tag
    (docs/scheduling.md). Duck-typed fakes and legacy jobs without the
    attribute screen in fp32 — the seed path."""
    return getattr(job, "precision", "fp32") or "fp32"


def engine_groups(jobs) -> List[Tuple[object, List[int]]]:
    """Partition `jobs` into per-engine runs for batched dispatch over
    a HETEROGENEOUS fleet (zoo fleets carry several model classes, one
    SharedEngine each). Returns [(engine_or_None, indices)] with
    indices into `jobs`, preserving fleet order within each group;
    group order follows first appearance, so a single-engine fleet
    reduces to exactly one group covering today's order (bit-identity
    contract). Jobs the probe rejects (fakes, freed slots) collect
    under the None key for the caller's scalar fallback. Duplicates in
    `jobs` are fine — each position keeps its own index."""
    order: List[object] = []
    groups: Dict[object, Tuple[object, List[int]]] = {}
    for i, j in enumerate(jobs):
        eng = shared_engine([j])
        k = id(eng) if eng is not None else None
        if k not in groups:
            groups[k] = (eng, [])
            order.append(k)
        groups[k][1].append(i)
    return [groups[k] for k in order]


def shared_engine(jobs):
    """The batch-capable SharedEngine shared by every job in `jobs`,
    or None (empty set, fake test jobs, mixed engines, freed slots,
    engine.batched=False, or a bank missing the residency sync
    protocol)."""
    eng = None
    for j in jobs:
        e = getattr(j, "engine", None)
        slot = getattr(j, "_slot", None)
        if (e is None or slot is None
                or getattr(slot, "idx", None) is None
                or getattr(slot, "dead", False)):
            return None
        if eng is None:
            eng = e
        elif e is not eng:
            return None
    if eng is None or not getattr(eng, "batched", False):
        return None
    for attr in ("eval_jobs", "eval_pairs", "train_micro_many"):
        if not callable(getattr(eng, attr, None)):
            return None
    bank = getattr(eng, "bank", None)
    for attr in ("compact", "sync_to_device", "params_stack"):
        if bank is None or not callable(getattr(bank, attr, None)):
            return None
    return eng
