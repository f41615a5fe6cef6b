"""ECCO's Alg. 1 (the GPU allocation of a retraining window) as the paper
states it, replayed on the accuracies the system measured: each job's
objective gain is alpha * n_j^beta / sum_k n_k^beta * AccGain_j, plus
AccGain_j once more for the job of lowest accuracy; after the initial
pass every micro-window goes to the job of largest gain; the window's GPU
shares are the final gains' positive parts over their sum (uniform when
none is positive). Plain Python floats; nothing here imports the system.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

ALPHA, BETA = 1.0, 0.5
RTOL = 1e-12


def gains(members: Dict[str, int], acc: Dict[str, float],
          acc_gain: Dict[str, float], worst: str = None
          ) -> Dict[str, float]:
    nbeta = {j: n ** BETA for j, n in members.items()}
    denom = sum(nbeta.values()) or 1.0
    out = {j: ALPHA * nbeta[j] / denom * acc_gain.get(j, 0.0)
           for j in members}
    if worst is not None:
        out[worst] = out.get(worst, 0.0) + acc_gain.get(worst, 0.0)
    return out


def shares(members: Dict[str, int], g: Dict[str, float]
           ) -> Dict[str, float]:
    pos = {j: max(g.get(j, 0.0), 0.0) for j in members}
    tot = sum(pos.values())
    if tot <= 0:
        return {j: 1.0 / len(members) for j in members}
    return {j: v / tot for j, v in pos.items()}


def _close(a: float, b: float) -> bool:
    return abs(a - b) <= RTOL * max(1.0, abs(a), abs(b))


def _same(a: Dict[str, float], b: Dict[str, float]) -> bool:
    return set(a) == set(b) and all(_close(a[k], b[k]) for k in a)


def window_differs(members: Dict[str, int], window_micro: int,
                   calls: Sequence[Tuple[dict, dict, dict]],
                   order: List[str], got_shares: Dict[str, float]) -> bool:
    """Whether one window of the system departs from Alg. 1. `members`
    maps each job, in the fleet's order, to its member count; `calls` are
    the window's gain computations in turn, each (acc, acc_gain, the
    gains it gave): one after the initial pass and one after each later
    micro-window; `order` is the job of each micro-window and
    `got_shares` the window's shares. Ties (equal accuracies, equal
    gains) may go either way."""
    if not members:
        return bool(order or got_shares or calls)
    head = list(members)[:max(0, min(window_micro, len(members)))]
    if order[:len(head)] != head:
        return True
    greedy = order[len(head):]
    if (len(calls) != len(greedy) + 1) if head else (calls or greedy):
        return True
    for acc, acc_gain, got in calls:
        low = min(acc.values()) if acc else None
        cands = [j for j, a in acc.items() if a == low] or [None]
        if not any(_same(got, gains(members, acc, acc_gain, w))
                   for w in cands):
            return True
    for pick, (_, _, g) in zip(greedy, calls):
        if pick not in g or not _close(g[pick], max(g.values())):
            return True
    final = calls[-1][2] if calls else {}
    return not _same(got_shares, shares(members, final))
