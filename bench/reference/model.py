"""Plain float32 forwards of the benchmark's model families, written from
the published descriptions and the configuration files alone. Each family
is a file of its own, `bench/reference/families/<family>.py`, found by
the configuration's `family` (`bench.core.spec.family`); what the
families share is `bench/reference/common.py`.

Weights come as a tree of tensors (keys and shapes as the benchmark made
them). `quant` (None for the reference itself) is applied to both
operands of every weight product: the control that puts a lower-precision
path in the program's place. Nothing here imports the program.
"""
from __future__ import annotations

import torch

from bench.core import spec
from bench.reference.common import Quant, bf16, fp8  # noqa: F401
from bench.reference import common as C


def hidden(cfg, params, tokens: torch.Tensor, quant: Quant = None):
    """The final-normed hidden states (B, S, d) of token ids (B, S), any
    positions the family prepends dropped."""
    return spec.family(cfg).hidden(cfg, params, tokens, quant)


def logits(cfg, params, h: torch.Tensor, quant: Quant = None):
    """Logits over the vocabulary (padded rows left out) of hidden states
    h (..., d): the family's own, else the tied table or the untied
    unembedding."""
    own = getattr(spec.family(cfg), "logits", C.logits)
    return own(cfg, params, h, quant)
