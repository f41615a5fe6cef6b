"""Fluid-model GAIMD congestion control (paper §3.2.2), ported from the
JAX package's `core/gaimd.py`.

Each flow i runs Generalized AIMD with additive increase alpha_i (rate
units per RTT) and multiplicative decrease beta_i. All flows traverse a
shared bottleneck of capacity C; flow i additionally has a local uplink
cap L_i. On bottleneck saturation every flow multiplicatively decreases
(synchronized-loss fluid model). Steady-state rate is proportional to
alpha_i / (1 - beta_i)  [Yang & Lam 2000, Eq. 21], which ECCO exploits by
setting alpha_i = p_j / n_j, beta_i = 0.5 so bandwidth approximates
GPU-share-proportional allocation.

The reference scans the RTT steps with a jitted `lax.scan`; here the
same recurrence is a plain fp32 numpy loop on the host. The rates feed
host decisions only (the controller's deliverable tokens), and a loop
on the card would cost several launches per simulated step. Each step
rounds as the reference's does, so the trajectory and the final rates
equal the reference's bit for bit. The means (`steady_state_rates`,
the chunk means of `simulate_warm`) are the fp32 rounding of a float64
mean: XLA reduces the (steps, N) column in an order of its own, which
no numpy order reproduces; the correctly rounded mean lies within about
1e-6 relative of it, where a sequential fp32 sum drifts to 7e-6.
"""
from __future__ import annotations

from typing import Optional

import numpy as np


def simulate(alpha, beta, local_cap, shared_cap, *, steps: int = 2000,
             r0: Optional[np.ndarray] = None):
    """Simulate GAIMD flows.

    alpha: (N,) additive increase per RTT
    beta:  (N,) multiplicative decrease in (0, 1)
    local_cap: (N,) per-flow uplink caps (inf for none)
    shared_cap: scalar shared bottleneck capacity
    Returns (rates (steps, N), final_rates (N,)), fp32.
    """
    alpha = np.asarray(alpha, np.float32)
    beta = np.asarray(beta, np.float32)
    local_cap = np.asarray(local_cap, np.float32)
    cap = np.float32(shared_cap)
    n = alpha.shape[0]
    r = (np.zeros(n, np.float32) if r0 is None
         else np.array(r0, np.float32))
    rates = np.empty((int(steps), n), np.float32)
    for i in range(int(steps)):
        r = np.minimum(r + alpha, local_cap)
        if r.sum(dtype=np.float32) > cap:
            r = r * beta
        rates[i] = r
    return rates, r.copy()


def _mean32(rates: np.ndarray) -> np.ndarray:
    """Per-flow mean over the steps, rounded once to fp32."""
    return rates.mean(axis=0, dtype=np.float64).astype(np.float32)


def steady_state_rates(alpha, beta, local_cap, shared_cap, *,
                       steps: int = 4000, tail: int = 1000):
    """Time-averaged steady-state rate per flow (tail average)."""
    rates, _ = simulate(alpha, beta, local_cap, shared_cap, steps=steps)
    return _mean32(rates[-tail:])


def simulate_warm(alpha, beta, local_cap, shared_cap, *,
                  r0: Optional[np.ndarray] = None, max_steps: int = 4000,
                  chunk: int = 500, tol: float = 0.01):
    """Chunked GAIMD simulation with warm start + convergence short-circuit.

    Runs `simulate` in `chunk`-step slices from `r0` (zeros when None —
    the cold transient) and stops as soon as two consecutive chunk
    means agree to within `tol` (relative to the rate magnitude): the
    AIMD sawtooth has entered its steady cycle and further steps only
    re-average the same cycle. A warm `r0` carried from the previous
    retraining window starts inside the cycle, so the fleet stops
    paying the from-zero transient every window.

    Returns (rates (N,), final_r (N,), steps_run): `rates` is the
    steady-cycle time average (the `steady_state_rates` analogue),
    `final_r` the instantaneous state to persist for the next window.
    """
    alpha = np.asarray(alpha, np.float32)
    n = alpha.shape[0]
    r = (np.zeros(n, np.float32) if r0 is None
         else np.asarray(r0, np.float32))
    if n == 0:
        return np.zeros(0, np.float64), r, 0
    chunk = max(1, min(int(chunk), int(max_steps)))
    prev = None
    mean = np.zeros(n, np.float64)
    steps_run = 0
    while steps_run < max_steps:
        rates, r = simulate(alpha, beta, local_cap, shared_cap,
                            steps=chunk, r0=r)
        mean = _mean32(rates).astype(np.float64)
        steps_run += chunk
        if prev is not None and np.abs(mean - prev).max() <= \
                tol * max(1e-9, float(np.abs(prev).max())):
            break
        prev = mean
    return mean, r, steps_run


def ecco_params(p_shares, n_members, *, beta: float = 0.5,
                alpha_scale: float = 1.0):
    """Per-camera GAIMD parameters from GPU shares (paper: alpha = p_j/n_j,
    beta = 0.5). p_shares/n_members: per-flow arrays (a camera inherits its
    group's share p_j and group size n_j)."""
    p = np.asarray(p_shares, np.float32)
    n = np.asarray(n_members, np.float32)
    alpha = alpha_scale * p / np.maximum(n, 1.0)
    return alpha, np.full_like(alpha, beta)


def proportionality_error(rates, targets) -> float:
    """How far realized rates are from the GPU-proportional target
    (normalized L1)."""
    r = np.asarray(rates, np.float64)
    t = np.asarray(targets, np.float64)
    r = r / (r.sum() or 1.0)
    t = t / (t.sum() or 1.0)
    return float(np.abs(r - t).sum() / 2.0)
