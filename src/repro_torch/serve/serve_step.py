"""Serving step factories, as in the JAX package's `serve/serve_step.py`:
prefill (prompt -> cache + first token) and decode (one token against a
static-capacity cache). Greedy sampling, argmax in fp32.

The fleet variant `make_fleet_decode_step` (per-lane parameter gather)
arrives with the serving plane (ROADMAP.md, queue 1).
"""
from __future__ import annotations

import torch

from repro_torch.models.model import Model


def make_prefill_step(model: Model, cap: int, *,
                      compute_dtype=torch.bfloat16):
    def prefill_step(params, inputs):
        last_logits, cache, pos = model.prefill(
            params, inputs, cap, compute_dtype=compute_dtype)
        tok = last_logits.to(torch.float32).argmax(dim=-1)
        return tok, cache, pos

    return prefill_step


def make_decode_step(model: Model, *, compute_dtype=torch.bfloat16):
    def decode_step(params, token, cache, pos):
        logits, new_cache = model.decode(params, token, cache, pos,
                                         compute_dtype=compute_dtype)
        nxt = logits[:, -1].to(torch.float32).argmax(dim=-1)
        return nxt[:, None], new_cache

    return decode_step
