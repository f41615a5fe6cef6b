"""Deterministic fleet scenario library — the workload zoo.

Ekya/RECL-class systems are evaluated across diverse drift patterns,
not one synthetic fleet shape. Each generator here builds a seeded,
fully deterministic `FleetScenario` on top of `DomainBank`/`Region`
(same substrate as `make_fleet`), so every benchmark, golden trace, and
regression test can name a workload and get the identical fleet back:

  * drift_wave            — a domain switch sweeps region by region
                            across space (rolling front, staggered in
                            time like a weather system).
  * diurnal               — day/night domain recurrence; every region
                            oscillates between two domains with a fixed
                            period (drift that *repeats*).
  * camera_churn          — streams join and leave mid-run (`churn`
                            events applied by the scenario runner at
                            window boundaries).
  * flash_crowd           — at one instant every region snaps to the
                            SAME domain (a city-wide event): maximal
                            cross-camera correlation.
  * bandwidth_contention  — one drift event under a tight shared
                            bottleneck, heterogeneous per-camera
                            uplink caps, and a profiled §3.2
                            sampling-config table (`profile` spec).

Hostile scenarios push the same planes to their failure boundaries —
the regimes Ekya/RECL report as worst-case and the benign five never
enter (see docs/scenarios.md "Hostile scenarios"):

  * flash_crowd_10k       — a huge camera cohort joins in ONE window
                            (default 10k; override `joiners` for
                            smoke), then drifts together one window
                            later: RowRegistry/JobBank growth and
                            grouper shortlisting under a request storm.
  * sensor_blackout       — an entire region's streams fail together
                            mid-run (correlated leave events).
  * oscillating_drift     — every region's domain flips EVERY window,
                            tuned to thrash join/evict regrouping.
  * bandwidth_collapse    — shared + local caps drop ~100x mid-retrain
                            (`BandwidthEvent`), exercising GAIMD decay
                            and the zero-bandwidth delivery path.

A scenario is `make_fleet`-compatible: `.bank`/`.streams` slot in
anywhere `make_fleet`'s return does, and `shared_bandwidth` /
`local_caps` / `churn` carry the scenario's resource shape to the
controller. The window-loop runner that applies them is a later module
of this port (ROADMAP.md); the port's `chip_smoke.py` drives
`flash_crowd_10k`'s join storm through the grouping plane directly.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.data.streams import DomainBank, Region, Stream


@dataclasses.dataclass
class ChurnEvent:
    """Fleet membership change applied BEFORE running window `window`."""
    window: int
    kind: str                      # "join" | "leave"
    stream_id: str
    stream: Optional[Stream] = None    # populated for joins


@dataclasses.dataclass
class BandwidthEvent:
    """Network-resource change applied BEFORE running window `window`:
    the scenario runner overwrites the controller's shared bottleneck
    and/or per-camera uplink caps (None fields keep the current
    value). Models backhaul degradation/recovery mid-run — the caps a
    live fleet sees are not a constant of the deployment."""
    window: int
    shared_bandwidth: Optional[float] = None
    local_caps: Optional[Dict[str, float]] = None


@dataclasses.dataclass
class FleetScenario:
    name: str
    bank: DomainBank
    streams: List[Stream]          # fleet at t=0
    windows: int                   # suggested run length
    seed: int
    window_seconds: float = 10.0
    shared_bandwidth: float = 1e9
    local_caps: Optional[Dict[str, float]] = None
    churn: List[ChurnEvent] = dataclasses.field(default_factory=list)
    # §3.2 profiled sampling-config table as PLAIN DATA (data/ cannot
    # import core/): {"configs": [[rate, resolution], ...],
    # "acc": [[budget_level, cfg_idx, acc], ...]}. The scenario runner
    # materializes it via transmission.ProfileTable.from_spec. None =
    # the controller's fixed-sampling default.
    profile: Optional[dict] = None
    # mid-run network-resource changes (see BandwidthEvent), applied by
    # the scenario runner at window boundaries like `churn`
    bandwidth: List[BandwidthEvent] = dataclasses.field(
        default_factory=list)

    def events_at(self, window: int) -> List[ChurnEvent]:
        return [e for e in self.churn if e.window == window]

    def bandwidth_events_at(self, window: int) -> List[BandwidthEvent]:
        return [e for e in self.bandwidth if e.window == window]


def _place_streams(bank: DomainBank, region: Region, center,
                   n: int, rng: np.random.Generator, *, prefix: str,
                   spread: float = 10.0, seed: int = 0) -> List[Stream]:
    out = []
    for s in range(n):
        loc = (center[0] + rng.uniform(-spread, spread),
               center[1] + rng.uniform(-spread, spread))
        out.append(Stream(f"{prefix}_{s}", bank, region, loc,
                          lag=rng.uniform(0.0, 2.0), seed=seed + s))
    return out


def _mk(bank_seed: int, vocab: int, num_domains: int, dim: int
        ) -> Tuple[DomainBank, np.random.Generator]:
    bank = DomainBank(vocab, num_domains, dim=dim, seed=bank_seed)
    return bank, np.random.default_rng(bank_seed + 1)


def drift_wave(*, regions: int = 4, streams_per_region: int = 2,
               vocab: int = 64, num_domains: int = 6, dim: int = 4,
               wave_start: float = 5.0, wave_step: float = 10.0,
               windows: int = 8, seed: int = 0) -> FleetScenario:
    """A drift front sweeps across regions in spatial order: region r
    switches domain at wave_start + r * wave_step. Nearby regions drift
    at nearby times — the cross-camera-correlation premise with a
    *temporal* gradient (grouping must track the moving front)."""
    bank, rng = _mk(seed, vocab, num_domains, dim)
    streams: List[Stream] = []
    for r in range(regions):
        doms = rng.permutation(num_domains)
        sched = [(0.0, int(doms[0])),
                 (wave_start + r * wave_step, int(doms[1]))]
        region = Region(f"region{r}", sched)
        streams += _place_streams(bank, region, (r * 1000.0, 0.0),
                                  streams_per_region, rng,
                                  prefix=f"cam{r}", seed=seed + 10 * r)
    return FleetScenario("drift_wave", bank, streams, windows, seed)


def diurnal(*, regions: int = 2, streams_per_region: int = 3,
            vocab: int = 64, num_domains: int = 6, dim: int = 4,
            period: float = 40.0, windows: int = 10,
            seed: int = 0) -> FleetScenario:
    """Day/night recurrence: each region alternates between two domains
    every period/2 for the whole horizon. Drift the fleet has seen
    before — the regime where model reuse and stable grouping pay."""
    bank, rng = _mk(seed, vocab, num_domains, dim)
    horizon = windows * 10.0 + period
    streams: List[Stream] = []
    for r in range(regions):
        doms = rng.permutation(num_domains)
        day, night = int(doms[0]), int(doms[1])
        sched = [(0.0, day)]
        t, cur = period / 2.0, night
        while t < horizon:
            sched.append((t, cur))
            cur = night if cur == day else day
            t += period / 2.0
        region = Region(f"region{r}", sched)
        streams += _place_streams(bank, region, (r * 1000.0, 0.0),
                                  streams_per_region, rng,
                                  prefix=f"cam{r}", seed=seed + 10 * r)
    return FleetScenario("diurnal", bank, streams, windows, seed)


def camera_churn(*, regions: int = 2, streams_per_region: int = 2,
                 vocab: int = 64, num_domains: int = 6, dim: int = 4,
                 switch_time: float = 10.0, join_window: int = 2,
                 leave_window: int = 5, windows: int = 8,
                 seed: int = 0) -> FleetScenario:
    """Streams join and leave mid-run: one extra camera per region
    comes online at `join_window`, and the first camera of region 0
    goes dark at `leave_window`. Exercises detector-row / index /
    job-membership churn paths end to end."""
    bank, rng = _mk(seed, vocab, num_domains, dim)
    streams: List[Stream] = []
    churn: List[ChurnEvent] = []
    for r in range(regions):
        doms = rng.permutation(num_domains)
        sched = [(0.0, int(doms[0])),
                 (switch_time + 5.0 * r, int(doms[1]))]
        region = Region(f"region{r}", sched)
        streams += _place_streams(bank, region, (r * 1000.0, 0.0),
                                  streams_per_region, rng,
                                  prefix=f"cam{r}", seed=seed + 10 * r)
        late = _place_streams(bank, region, (r * 1000.0, 0.0), 1, rng,
                              prefix=f"late{r}", seed=seed + 500 + r)[0]
        churn.append(ChurnEvent(window=join_window, kind="join",
                                stream_id=late.stream_id, stream=late))
    churn.append(ChurnEvent(window=leave_window, kind="leave",
                            stream_id=streams[0].stream_id))
    return FleetScenario("camera_churn", bank, streams, windows, seed,
                         churn=churn)


def flash_crowd(*, regions: int = 3, streams_per_region: int = 2,
                vocab: int = 64, num_domains: int = 6, dim: int = 4,
                flash_time: float = 15.0, windows: int = 8,
                seed: int = 0) -> FleetScenario:
    """At `flash_time` every region snaps to one shared event domain
    (city-wide incident). All cameras drift simultaneously and
    identically — the best case for group retraining, the worst case
    for per-stream budgets."""
    bank, rng = _mk(seed, vocab, num_domains, dim)
    event_dom = int(rng.integers(0, num_domains))
    streams: List[Stream] = []
    for r in range(regions):
        base = int((event_dom + 1 + r) % num_domains)
        region = Region(f"region{r}", [(0.0, base),
                                       (flash_time, event_dom)])
        streams += _place_streams(bank, region, (r * 1000.0, 0.0),
                                  streams_per_region, rng,
                                  prefix=f"cam{r}", seed=seed + 10 * r)
    return FleetScenario("flash_crowd", bank, streams, windows, seed)


def bandwidth_contention(*, regions: int = 2, streams_per_region: int = 4,
                         vocab: int = 64, num_domains: int = 6,
                         dim: int = 4, switch_time: float = 10.0,
                         shared_bandwidth: float = 48.0,
                         cap_range: Tuple[float, float] = (4.0, 24.0),
                         windows: int = 8, seed: int = 0) -> FleetScenario:
    """One drift event under a tight shared bottleneck plus seeded
    heterogeneous per-camera uplink caps — the regime where GAIMD's
    GPU-share-proportional bandwidth (vs equal share) matters."""
    bank, rng = _mk(seed, vocab, num_domains, dim)
    streams: List[Stream] = []
    for r in range(regions):
        doms = rng.permutation(num_domains)
        sched = [(0.0, int(doms[0])),
                 (switch_time + 5.0 * r, int(doms[1]))]
        region = Region(f"region{r}", sched)
        streams += _place_streams(bank, region, (r * 1000.0, 0.0),
                                  streams_per_region, rng,
                                  prefix=f"cam{r}", seed=seed + 10 * r)
    caps = {s.stream_id: float(rng.uniform(*cap_range)) for s in streams}
    # a profiled §3.2 sampling-config table (rates at the streams'
    # native 32-token resolution — the controller's ring pool holds
    # fixed-width rows): higher budget levels profile best at higher
    # sampling rates, with seeded jitter so the argmax isn't degenerate
    rates = (2, 4, 8)
    acc = [[lvl, i,
            round(0.35 + 0.10 * lvl * (i + 1) / len(rates)
                  + float(rng.uniform(0.0, 0.02)), 6)]
           for lvl in range(4) for i in range(len(rates))]
    profile = {"configs": [[r, 32] for r in rates], "acc": acc}
    return FleetScenario("bandwidth_contention", bank, streams, windows,
                         seed, shared_bandwidth=shared_bandwidth,
                         local_caps=caps, profile=profile)


# ---------------------------------------------------------------------------
# hostile scenarios: the failure-boundary regimes.
# Same substrate and determinism contract as the benign five; sized by
# parameters so goldens/smoke can run them tiny while benchmarks run
# them at full hostility.
# ---------------------------------------------------------------------------
def flash_crowd_10k(*, joiners: int = 10_000, base_regions: int = 2,
                    streams_per_region: int = 2, vocab: int = 64,
                    num_domains: int = 6, dim: int = 4,
                    join_window: int = 1, windows: int = 5,
                    window_seconds: float = 10.0,
                    seed: int = 0) -> FleetScenario:
    """A `joiners`-camera cohort joins the fleet in ONE window, then the
    whole cohort drifts to a shared event domain one window later: a
    registry/bank growth spike followed by a correlated request storm
    through grouping. The default 10k matches the paper's fleet-scale
    claim; goldens/smoke override `joiners` down."""
    bank, rng = _mk(seed, vocab, num_domains, dim)
    streams: List[Stream] = []
    for r in range(base_regions):
        doms = rng.permutation(num_domains)
        region = Region(f"region{r}", [(0.0, int(doms[0]))])
        streams += _place_streams(bank, region, (r * 1000.0, 0.0),
                                  streams_per_region, rng,
                                  prefix=f"cam{r}", seed=seed + 10 * r)
    calm = int(rng.integers(0, num_domains))
    event_dom = int((calm + 1) % num_domains)
    # the cohort shares one region that flips ONE window after the
    # join, so every joiner's deployment-time drift reference (set at
    # join) is invalidated simultaneously
    crowd = Region("crowd", [(0.0, calm),
                             ((join_window + 1) * window_seconds,
                              event_dom)])
    late = _place_streams(bank, crowd, (5000.0, 5000.0), joiners, rng,
                          prefix="crowd", spread=50.0, seed=seed + 900)
    churn = [ChurnEvent(window=join_window, kind="join",
                        stream_id=s.stream_id, stream=s) for s in late]
    return FleetScenario("flash_crowd_10k", bank, streams, windows, seed,
                         window_seconds=window_seconds, churn=churn)


def sensor_blackout(*, regions: int = 3, streams_per_region: int = 2,
                    vocab: int = 64, num_domains: int = 6, dim: int = 4,
                    switch_time: float = 5.0, blackout_window: int = 2,
                    blackout_region: int = 0, windows: int = 5,
                    seed: int = 0) -> FleetScenario:
    """Correlated failure: every stream of one region goes dark in the
    same window, AFTER that region drifted and grouped — its group must
    die cleanly (members, pooled data, detector/index/tx rows) while
    the rest of the fleet keeps retraining."""
    bank, rng = _mk(seed, vocab, num_domains, dim)
    streams: List[Stream] = []
    for r in range(regions):
        doms = rng.permutation(num_domains)
        sched = [(0.0, int(doms[0])),
                 (switch_time + 5.0 * r, int(doms[1]))]
        region = Region(f"region{r}", sched)
        streams += _place_streams(bank, region, (r * 1000.0, 0.0),
                                  streams_per_region, rng,
                                  prefix=f"cam{r}", seed=seed + 10 * r)
    doomed = [s for s in streams
              if s.region.region_id == f"region{blackout_region}"]
    churn = [ChurnEvent(window=blackout_window, kind="leave",
                        stream_id=s.stream_id) for s in doomed]
    return FleetScenario("sensor_blackout", bank, streams, windows, seed,
                         churn=churn)


def oscillating_drift(*, regions: int = 2, streams_per_region: int = 2,
                      vocab: int = 64, num_domains: int = 6, dim: int = 4,
                      flip_every: float = 10.0, windows: int = 6,
                      seed: int = 0) -> FleetScenario:
    """Every region's domain flips EVERY `flip_every` seconds (default:
    once per window) between two alternatives for the whole horizon —
    each window's data contradicts the distribution the group just
    retrained on, thrashing Alg. 2's evict/requeue/regroup loop at its
    maximum rate."""
    bank, rng = _mk(seed, vocab, num_domains, dim)
    horizon = windows * 10.0 + flip_every
    streams: List[Stream] = []
    for r in range(regions):
        doms = rng.permutation(num_domains)
        a, b = int(doms[0]), int(doms[1])
        sched = [(0.0, a)]
        t, cur = flip_every, b
        while t < horizon:
            sched.append((t, cur))
            cur = b if cur == a else a
            t += flip_every
        region = Region(f"region{r}", sched)
        streams += _place_streams(bank, region, (r * 1000.0, 0.0),
                                  streams_per_region, rng,
                                  prefix=f"cam{r}", seed=seed + 10 * r)
    return FleetScenario("oscillating_drift", bank, streams, windows,
                         seed)


def bandwidth_collapse(*, regions: int = 2, streams_per_region: int = 3,
                       vocab: int = 64, num_domains: int = 6, dim: int = 4,
                       switch_time: float = 5.0,
                       shared_bandwidth: float = 48.0,
                       cap_range: Tuple[float, float] = (4.0, 24.0),
                       collapse_window: int = 2,
                       collapse_factor: float = 100.0,
                       recover_window: Optional[int] = None,
                       windows: int = 6, seed: int = 0) -> FleetScenario:
    """bandwidth_contention's fleet, but the backhaul collapses ~100x
    (shared bottleneck AND per-camera caps) mid-retrain: GAIMD must
    decay every flow to the starved regime and §3.2 compression must
    take the zero/near-zero-delivery path instead of forcing tokens
    through. `recover_window` (optional) restores the original caps to
    exercise the additive-increase ramp back up."""
    base = bandwidth_contention(
        regions=regions, streams_per_region=streams_per_region,
        vocab=vocab, num_domains=num_domains, dim=dim,
        switch_time=switch_time, shared_bandwidth=shared_bandwidth,
        cap_range=cap_range, windows=windows, seed=seed)
    f = float(collapse_factor)
    events = [BandwidthEvent(
        window=collapse_window, shared_bandwidth=shared_bandwidth / f,
        local_caps={k: v / f for k, v in base.local_caps.items()})]
    if recover_window is not None:
        events.append(BandwidthEvent(
            window=recover_window, shared_bandwidth=shared_bandwidth,
            local_caps=dict(base.local_caps)))
    return dataclasses.replace(base, name="bandwidth_collapse",
                               bandwidth=events)


SCENARIOS: Dict[str, Callable[..., FleetScenario]] = {
    "drift_wave": drift_wave,
    "diurnal": diurnal,
    "camera_churn": camera_churn,
    "flash_crowd": flash_crowd,
    "bandwidth_contention": bandwidth_contention,
    "flash_crowd_10k": flash_crowd_10k,
    "sensor_blackout": sensor_blackout,
    "oscillating_drift": oscillating_drift,
    "bandwidth_collapse": bandwidth_collapse,
}

#: the adversarial subset — what the invariant harness golden-pins
HOSTILE_SCENARIOS = ("flash_crowd_10k", "sensor_blackout",
                     "oscillating_drift", "bandwidth_collapse")


def build_scenario(name: str, *, seed: int = 0, **kw) -> FleetScenario:
    """Build a named scenario (see SCENARIOS) with overrides."""
    try:
        gen = SCENARIOS[name]
    except KeyError:
        raise KeyError(f"unknown scenario {name!r}; "
                       f"have {sorted(SCENARIOS)}") from None
    return gen(seed=seed, **kw)
