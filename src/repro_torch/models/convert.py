"""Weight bridge: the JAX package's parameter tree -> the port's.

`jax.random` and `torch.Generator` draw different numbers from one seed,
so tests that hold the port to the JAX package start both from the JAX
`Model.init` weights. The caller converts them to numpy first
(`jax.tree.map(np.asarray, params)`); this module imports no JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device


def params_from_numpy(tree, *, device="cuda"):
    """Nested dicts/lists of numpy arrays -> the same tree of tensors on
    `device`, in the arrays' own dtype. The layouts are the same in both
    packages: `embed.table`, `segments[i]` stacked on a leading layer
    axis, `attn.{wq,wk,wv,wo}`, `mlp.{w_gate,w_up,w_down}`, the Mamba and
    the mLSTM / sLSTM leaves under their blocks' keys."""
    dev = resolve_device(device)
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device=dev) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_numpy(v, device=dev) for v in tree]
    return torch.from_numpy(np.array(tree, copy=True)).to(dev)
