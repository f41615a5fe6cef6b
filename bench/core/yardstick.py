"""The yardstick's arithmetic, frozen here so that no later change to the
program moves it: the card's published peaks, a kernel's bound, and the
model FLOPs of a forward and of a decode step. A kernel's own operations
and bytes are its file's (`bench/kernels/<name>.py`); a model family's
FLOPs are its reference's file's (`bench/reference/families/<name>.py`),
which the public counts here call. The formulas are those of the
repository's `chip_smoke.py` (`peaks`, `_bound`, `time_attention`'s and
`ssd_cost`'s counts), copied; nothing here calls the program.
"""
from __future__ import annotations

import math
from typing import Optional

from bench.core import spec

# data-sheet peaks (dense, at the full power limit): bytes/s of device
# memory, FLOP/s of bf16 tensor cores and of fp32 outside them; matched
# against the card's name, most specific first
PEAKS = (  # (name fragment, bytes/s, bf16 FLOP/s, fp32 FLOP/s)
    ("H200", 4.8e12, 989e12, 67e12),
    ("H100 NVL", 3.9e12, 835e12, 60e12),
    ("H100 PCIe", 2.0e12, 756e12, 51e12),
    ("H100", 3.35e12, 989e12, 67e12),          # SXM
)


def peaks(card: str) -> dict:
    """{"bytes": B/s, "bf16": FLOP/s, "fp32": FLOP/s} of the named card."""
    for frag, bw, bf16, fp32 in PEAKS:
        if frag in card:
            return {"bytes": bw, "bf16": bf16, "fp32": fp32}
    raise RuntimeError(f"no data-sheet peaks for card {card!r}")


def bound_s(nbytes: float, flops: float, flops_peak: float,
            bytes_peak: float) -> float:
    """The least time the card could take: the larger of bytes over
    bandwidth and operations over the peak of the units doing them."""
    return max(nbytes / bytes_peak, flops / flops_peak)


def _count(cfg: dict, count: str):
    """The configuration's family's `count` (`bench/reference/families/
    <family>.py`), which every family file defines beside its reference."""
    fam = spec.family(cfg)
    own = getattr(fam, count, None)
    if own is None:
        raise NotImplementedError(
            f"family {cfg['family']!r} ({fam.__file__}) defines no "
            f"{count}: a family gives its own operation counts")
    return own


def matmul_params(cfg: dict) -> int:
    """Weights that a token multiplies through in one forward: every
    projection of every layer and the unembedding over the padded
    vocabulary (the program computes logits over all of it)."""
    return _count(cfg, "matmul_params")(cfg)


def forward_flops(cfg: dict, batch: int, seq: int,
                  logit_rows: Optional[int] = None) -> float:
    """Model FLOPs of a forward of `batch` sequences of `seq` tokens from
    position 0, with the unembedding at `logit_rows` positions a sequence
    (every position by default; 1 for a prefill)."""
    return _count(cfg, "forward_flops")(cfg, batch, seq, logit_rows)


def decode_flops(cfg: dict, positions) -> float:
    """Model FLOPs of one decode step of lanes at absolute `positions`."""
    return _count(cfg, "decode_flops")(cfg, positions)


def percentile(values, q: float) -> float:
    """The q-th percentile (0..100) by linear interpolation between the
    closest ranks, as numpy's default; inf where the rank falls on an
    inf (a missing answer)."""
    xs = sorted(values)
    if not xs:
        return math.nan
    k = (len(xs) - 1) * q / 100.0
    lo, hi = math.floor(k), math.ceil(k)
    if math.isinf(xs[hi]):
        return math.inf
    return xs[lo] + (xs[hi] - xs[lo]) * (k - lo)
