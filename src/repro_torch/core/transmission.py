"""Resource-aware transmission control (paper §3.2), ported from the
JAX package's `core/transmission.py`. Host numpy throughout: every
decision here is made on the host, bit for bit the reference's.

The camera-side controller:
  1. Picks a *sampling configuration* (rate f, resolution q) from an
     offline-profiled table keyed by GPU-budget level; scales f by 1/n_j
     inside a group so the group's aggregate data volume matches the
     group's compute capacity.
  2. Sets GAIMD parameters alpha = p_j / n_j, beta = 0.5 so the flow's
     steady-state bandwidth approximates its GPU-proportional share.
  3. "Compresses" (drops sequences / truncates resolution) so the
     selected configuration fits inside the bandwidth actually achieved.

In the LM mapping: f = sequences sampled per retraining window and
q = tokens per sequence (context resolution).

Two granularities, mirroring the drift plane:
  * `TransmissionController` — one camera, the scalar reference
    semantics (`decide`).
  * `FleetTransmissionPlane` — the whole fleet in dense per-flow
    arrays: one `best_many` masked argmax for every flow's sampling
    config, one vectorized pass for GAIMD params / deliverable tokens /
    compression (`decide_many`, bit-identical to a per-camera `decide`
    loop), and warm-started GAIMD bandwidth estimation whose per-flow
    rate state persists across windows under camera churn
    (`FleetDriftDetector` row discipline).

Under a fleet mesh (`mesh=`, `set_mesh`) the flow registry's capacity is
aligned to the mesh size and `shard_spans` gives each device's block of
flow rows; `decide_many` over those spans, concatenated, equals the
global call row for row. Nothing of the plane runs on a device.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core import gaimd
from repro_torch.core.rows import RowRegistry


@dataclasses.dataclass(frozen=True)
class SamplingConfig:
    rate: int          # sequences per window (paper: frame rate f)
    resolution: int    # tokens per sequence  (paper: resolution q)

    @property
    def tokens(self) -> int:
        return self.rate * self.resolution


class ProfileTable:
    """Offline-profiled accuracy for (budget_level, sampling config).

    The reference's profiling benchmark builds it by retraining a
    reduced model under each configuration (the paper's Fig. 5
    procedure); here it stores and queries the results. Accuracies live
    in a dense (levels, configs) float64 matrix so `best_many` answers
    every flow of the fleet in one masked argmax.
    """

    def __init__(self, configs: Sequence[SamplingConfig]):
        self.configs = list(configs)
        self._tokens = np.array([c.tokens for c in self.configs], np.int64)
        self._rates = np.array([c.rate for c in self.configs], np.int64)
        self._res = np.array([c.resolution for c in self.configs], np.int64)
        self._level_row: Dict[int, int] = {}
        # the ONLY accuracy store: -inf marks unprofiled cells; both
        # best() and best_many() read it, so scalar/batched can never
        # disagree about what was recorded
        self._mat = np.full((0, len(self.configs)), -np.inf, np.float64)

    @property
    def levels(self) -> List[int]:
        """Profiled budget levels, ascending."""
        return sorted(self._level_row)

    @classmethod
    def from_spec(cls, spec: dict) -> "ProfileTable":
        """Build from a plain-data spec: {"configs": [[rate, res], ...],
        "acc": [[level, cfg_idx, acc], ...]} — the form scenarios carry
        (data/ cannot import core/)."""
        t = cls([SamplingConfig(int(r), int(q)) for r, q in spec["configs"]])
        for lvl, idx, acc in spec.get("acc", []):
            t.record(int(lvl), int(idx), float(acc))
        return t

    def record(self, budget_level: int, cfg_idx: int, acc: float):
        row = self._level_row.get(budget_level)
        if row is None:
            row = len(self._level_row)
            self._level_row[budget_level] = row
            # fleetlint: disable=rows-discipline -- the profile matrix
            # grows once per NEW BUDGET LEVEL (bounded by the profiler's
            # level grid, ~5 rows), not with fleet churn; flow-indexed
            # state in this module rides RowRegistry
            self._mat = np.concatenate(
                [self._mat,
                 np.full((1, len(self.configs)), -np.inf, np.float64)])
        self._mat[row, cfg_idx] = acc

    def acc(self, budget_level: int, cfg_idx: int) -> Optional[float]:
        """Profiled accuracy for one cell, or None when unprofiled."""
        row = self._level_row.get(budget_level)
        if row is None or self._mat[row, cfg_idx] == -np.inf:
            return None
        return float(self._mat[row, cfg_idx])

    def best(self, budget_level: int, token_budget: Optional[int] = None
             ) -> Optional[SamplingConfig]:
        """Best profiled config at this budget level whose token volume
        fits `token_budget` (if given). Returns None when the table
        holds no configs at all (max() over an empty candidate AND
        fallback set used to raise ValueError)."""
        if not self.configs:
            return None
        row = self._level_row.get(budget_level)
        cands = []
        if row is not None:
            for idx in range(len(self.configs)):
                a = self._mat[row, idx]
                if a == -np.inf:
                    continue
                c = self.configs[idx]
                if token_budget is not None and c.tokens > token_budget:
                    continue
                cands.append((a, idx))
        if not cands:
            # fall back: the SPARSEST config that fits — and when even
            # nothing fits, still the sparsest overall. (The seed fell
            # back to the densest, maximally violating the very budget
            # it was asked to respect.)
            fitting = [c for c in self.configs
                       if token_budget is None or c.tokens <= token_budget]
            return min(fitting or self.configs, key=lambda c: c.tokens)
        return self.configs[max(cands)[1]]

    def best_many(self, budget_levels: Sequence[int],
                  token_budgets=None) -> np.ndarray:
        """Vectorized `best` for a whole fleet: one masked argmax over
        the (levels, configs) matrix. Returns (N,) config indices into
        `self.configs` (-1 = empty table, the scalar path's None).
        `token_budgets` is None (unbudgeted) or per-flow; None entries
        mean unbudgeted for that flow. Row i is bit-identical to
        `best(budget_levels[i], token_budgets[i])` — including the
        tie-breaks: profiled ties go to the LARGEST config index
        (max((acc, idx))), fallback ties to the FIRST sparsest
        (min(key=tokens))."""
        n = len(budget_levels)
        C = len(self.configs)
        if C == 0:
            return np.full(n, -1, np.int64)
        if token_budgets is None:
            tb = np.full(n, np.inf, np.float64)
        else:
            tb = np.array([np.inf if b is None else float(b)
                           for b in token_budgets], np.float64)
        rows = np.array([self._level_row.get(l, -1) for l in budget_levels],
                        np.int64)
        acc = np.full((n, C), -np.inf, np.float64)
        known = rows >= 0
        if known.any():
            acc[known] = self._mat[rows[known]]
        fits = self._tokens[None, :] <= tb[:, None]
        cand = fits & (acc > -np.inf)
        # profiled argmax; ties -> largest idx (argmax over the reversed
        # axis picks the last original occurrence of the max)
        masked = np.where(cand, acc, -np.inf)
        pick = C - 1 - np.argmax(masked[:, ::-1], axis=1)
        # fallback: sparsest fitting (first-index ties), else sparsest
        ftok = np.where(fits, self._tokens[None, :].astype(np.float64),
                        np.inf)
        fallback = np.where(fits.any(axis=1), np.argmin(ftok, axis=1),
                            np.argmin(self._tokens))
        return np.where(cand.any(axis=1), pick, fallback).astype(np.int64)


@dataclasses.dataclass
class TransmissionDecision:
    config: SamplingConfig
    scaled_rate: float          # f* / n_j
    gaimd_alpha: float
    gaimd_beta: float
    target_rate: float          # alpha/(1-beta)-proportional GAIMD target
    delivered_tokens: int       # after compression to achieved bandwidth


class TransmissionController:
    """One per camera/stream (the scalar reference semantics)."""

    def __init__(self, table: ProfileTable, *, bytes_per_token: float = 2.0):
        self.table = table
        self.bytes_per_token = bytes_per_token

    def decide(self, *, gpu_budget_level: int, token_budget: int,
               p_share: float, n_members: int,
               achieved_bandwidth: float, window_seconds: float
               ) -> TransmissionDecision:
        cfg = self.table.best(gpu_budget_level, token_budget)
        if cfg is None:              # empty profile table: transmit nothing
            cfg = SamplingConfig(rate=0, resolution=0)
        scaled_rate = cfg.rate / max(1, n_members)
        alpha = p_share / max(1, n_members)
        beta = 0.5
        # tokens deliverable within the achieved bandwidth
        deliverable = int(achieved_bandwidth * window_seconds
                          / self.bytes_per_token)
        want = int(scaled_rate * cfg.resolution)
        delivered = min(want, deliverable)
        # the flow's steady-state GAIMD rate is proportional to
        # alpha/(1-beta) (Yang & Lam Eq. 21) — the target the realized
        # bandwidth is graded against, NOT the achieved bandwidth
        # itself (achieved-vs-achieved makes proportionality error
        # identically zero)
        return TransmissionDecision(
            config=cfg, scaled_rate=scaled_rate, gaimd_alpha=alpha,
            gaimd_beta=beta, target_rate=alpha / (1.0 - beta),
            delivered_tokens=delivered)


@dataclasses.dataclass
class FleetDecisionBatch:
    """Dense per-flow §3.2 decisions (all arrays length N, flow order).

    `as_decisions()` materializes the scalar `TransmissionDecision`
    objects for parity checks; hot paths read the arrays directly."""
    rate: np.ndarray            # (N,) int64 chosen config rate f*
    resolution: np.ndarray      # (N,) int64 chosen config resolution q
    scaled_rate: np.ndarray     # (N,) float64 f*/n_j
    gaimd_alpha: np.ndarray     # (N,) float64 p_j/n_j
    gaimd_beta: np.ndarray      # (N,) float64
    target_rate: np.ndarray     # (N,) float64 alpha/(1-beta)
    deliverable: np.ndarray     # (N,) int64 tokens the bandwidth allows
    delivered: np.ndarray       # (N,) int64 min(want, deliverable)

    def as_decisions(self) -> List[TransmissionDecision]:
        return [TransmissionDecision(
                    config=SamplingConfig(int(self.rate[i]),
                                          int(self.resolution[i])),
                    scaled_rate=float(self.scaled_rate[i]),
                    gaimd_alpha=float(self.gaimd_alpha[i]),
                    gaimd_beta=float(self.gaimd_beta[i]),
                    target_rate=float(self.target_rate[i]),
                    delivered_tokens=int(self.delivered[i]))
                for i in range(len(self.rate))]


class FleetTransmissionPlane:
    """The fleet's §3.2 transmission controller as dense per-flow
    arrays: batched sampling-config selection + GAIMD parameterization +
    compression (`decide_many`), and warm-started bandwidth estimation
    (`allocate`) whose per-flow GAIMD rate state persists across
    retraining windows. Flow rows follow the `FleetDriftDetector`
    churn discipline (lazy add, swap-with-last removal, amortized
    doubling)."""

    def __init__(self, table: Optional[ProfileTable] = None, *,
                 bytes_per_token: float = 2.0, max_steps: int = 4000,
                 chunk: int = 500, tol: float = 0.01, mesh=None):
        self.table = table if table is not None else ProfileTable([])
        self.bytes_per_token = bytes_per_token
        self.max_steps = int(max_steps)
        self.chunk = int(chunk)
        self.tol = float(tol)
        self.mesh = mesh
        self.last_steps = 0          # GAIMD steps burnt by last allocate
        self._rows = RowRegistry(align=mesh.size if mesh is not None else 1)
        self._r = np.zeros(self._rows.capacity, np.float32)  # GAIMD rates

    def set_mesh(self, mesh):
        """(Re)attach the fleet mesh (the elastic re-mesh). Decisions are
        mesh-independent: `decide_many` is elementwise per flow (each
        device block of registry rows can evaluate its own span and the
        concatenation equals the global call, see `shard_spans`), and
        `allocate` stays GLOBAL: GAIMD's shared-bottleneck coupling sums
        every flow's rate each step, and a sharded reduction could
        reorder that float sum."""
        self.mesh = mesh
        self._rows.set_align(mesh.size if mesh is not None else 1)
        if self._rows.capacity > self._r.shape[0]:
            pad = self._rows.capacity - self._r.shape[0]
            self._r = np.concatenate([self._r, np.zeros(pad, np.float32)])

    def shard_spans(self):
        """Contiguous per-device [lo, hi) row blocks of the flow axis
        (mesh-aligned capacity). For any inputs, concatenating
        decide_many over the live parts of these spans equals the global
        decide_many row for row."""
        return self._rows.shard_spans(
            self.mesh.size if self.mesh is not None else 1)

    # -- flow membership (camera churn) --------------------------------
    def __len__(self) -> int:
        return len(self._rows)

    def __contains__(self, flow_id: str) -> bool:
        return flow_id in self._rows

    @property
    def flow_ids(self) -> List[str]:
        return self._rows.ids

    def add_flow(self, flow_id: str) -> int:
        row, new = self._rows.add(flow_id)
        if self._rows.capacity > self._r.shape[0]:
            pad = self._rows.capacity - self._r.shape[0]
            self._r = np.concatenate([self._r,
                                      np.zeros(pad, np.float32)])
        if new:
            self._r[row] = 0.0
        return row

    def remove_flow(self, flow_id: str):
        """Swap-with-last removal keeps live rows dense; a departed
        camera's warm-start rate must not leak into a future joiner."""
        mv = self._rows.remove(flow_id)
        if mv is not None and mv[0] != mv[1]:
            self._r[mv[0]] = self._r[mv[1]]

    def rate_state(self, flow_id: str) -> float:
        """Persisted warm-start rate for one flow (0.0 before its first
        allocate)."""
        row = self._rows.get(flow_id)
        return float(self._r[row]) if row is not None else 0.0

    # -- bandwidth allocation (GAIMD, warm-started) --------------------
    def allocate(self, flow_ids: Sequence[str], p_shares, n_members,
                 local_caps, shared_cap: float, *, mode: str = "ecco"
                 ) -> np.ndarray:
        """Realized per-flow bandwidth for this window. `mode="ecco"`
        sets alpha = p_j/n_j, beta = 0.5 (GPU-share proportional);
        `mode="equal"` is the plain-AIMD equal-competition baseline
        (alpha = 1, beta = 0.5). Each flow's GAIMD rate warm-starts
        from the state persisted at the end of its previous window and
        the simulation short-circuits on steady-cycle convergence."""
        n = len(flow_ids)
        if n == 0:
            self.last_steps = 0
            return np.zeros(0, np.float64)
        if mode == "equal":
            alpha = np.ones(n, np.float32)
            beta = np.full(n, 0.5, np.float32)
        else:
            alpha, beta = gaimd.ecco_params(p_shares, n_members)
        known = self._rows.rows_of(flow_ids)     # fast path: no churn
        rows = (np.asarray(known, np.int64) if known is not None else
                np.array([self.add_flow(f) for f in flow_ids], np.int64))
        rates, final, steps = gaimd.simulate_warm(
            alpha, beta, np.asarray(local_caps, np.float32), shared_cap,
            r0=self._r[rows], max_steps=self.max_steps, chunk=self.chunk,
            tol=self.tol)
        self._r[rows] = final
        self.last_steps = steps
        return rates

    # -- snapshot / restore (elastic window rollback) ------------------
    def state_dict(self) -> dict:
        live = len(self._rows)
        return {"ids": self._rows.ids, "r": self._r[:live].copy(),
                "last_steps": self.last_steps}

    def load_state_dict(self, state: dict):
        self._rows = RowRegistry(align=self._rows.align)
        self._r = np.zeros(self._rows.capacity, np.float32)
        for sid in state["ids"]:
            self.add_flow(sid)
        self._r[:len(state["ids"])] = state["r"]
        self.last_steps = state["last_steps"]

    # -- batched §3.2 decisions ----------------------------------------
    def decide_many(self, *, budget_levels: Sequence[int], token_budgets,
                    p_shares, n_members, achieved_bw,
                    window_seconds: float) -> FleetDecisionBatch:
        """One call for every flow's sampling config, GAIMD params,
        deliverable tokens, and compression — bit-identical to a
        per-camera `TransmissionController.decide` loop
        (tests/test_torch_transmission.py)."""
        n = len(p_shares)
        idx = self.table.best_many(budget_levels, token_budgets)
        if len(self.table.configs):
            safe = np.maximum(idx, 0)
            rate = np.where(idx >= 0, self.table._rates[safe], 0)
            res = np.where(idx >= 0, self.table._res[safe], 0)
        else:                       # empty table: transmit nothing
            rate = np.zeros(n, np.int64)
            res = np.zeros(n, np.int64)
        nm = np.maximum(np.asarray(n_members, np.int64), 1)
        scaled = rate / nm                                   # float64
        alpha = np.asarray(p_shares, np.float64) / nm
        beta = np.full(n, 0.5, np.float64)
        bwa = np.asarray(achieved_bw, np.float64)
        deliverable = (bwa * window_seconds
                       / self.bytes_per_token).astype(np.int64)
        want = (scaled * res).astype(np.int64)
        return FleetDecisionBatch(
            rate=rate.astype(np.int64), resolution=res.astype(np.int64),
            scaled_rate=scaled, gaimd_alpha=alpha, gaimd_beta=beta,
            target_rate=alpha / (1.0 - beta), deliverable=deliverable,
            delivered=np.minimum(want, deliverable))

    # -- budget-level / token-budget helpers ---------------------------
    def levels_for_shares(self, p_shares) -> List[int]:
        """Quantize GPU shares onto the table's profiled budget levels
        (uniform buckets over [0, 1]); 0 when the table is unprofiled
        (every lookup then falls back to the sparsest fitting config)."""
        lvls = self.table.levels if hasattr(self.table, "levels") else []
        p = np.asarray(p_shares, np.float64)
        if not lvls:
            return [0] * len(p)
        sel = np.minimum((p * len(lvls)).astype(np.int64), len(lvls) - 1)
        return [lvls[i] for i in sel]

