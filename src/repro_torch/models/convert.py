"""Weight bridge: the JAX package's parameter tree -> the port's.

`jax.random` and `torch.Generator` draw different numbers from one seed,
so tests that hold the port to the JAX package start both from the JAX
`Model.init` weights. The caller converts them to numpy first
(`jax.tree.map(np.asarray, params)`); this module imports no JAX.
"""
from __future__ import annotations

import json

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


def _flat_items(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat_items(tree[k], f"{prefix}{k}/")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flat_items(v, f"{prefix}{i}/")
    else:
        yield prefix[:-1], np.asarray(tree)


def _skeleton(tree):
    if isinstance(tree, dict):
        return {k: _skeleton(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_skeleton(v) for v in tree]
    return None


_STRUCTURE = "__structure__"


def save_params_npz(tree, path: str):
    """Write a tree of numpy arrays to one `.npz`: one entry per leaf,
    keyed by its path ("segments/0/attn/wq"), and the tree's structure
    as JSON (empty subtrees, such as a norm without parameters, have no
    leaf to carry them)."""
    np.savez(path, **{_STRUCTURE: np.array(json.dumps(_skeleton(tree)))},
             **dict(_flat_items(tree)))


def load_params_npz(path: str):
    """The tree `save_params_npz` wrote, as nested dicts/lists of numpy
    arrays."""
    with np.load(path) as z:
        def build(skel, prefix):
            if isinstance(skel, dict):
                return {k: build(v, f"{prefix}{k}/") for k, v in skel.items()}
            if isinstance(skel, list):
                return [build(v, f"{prefix}{i}/") for i, v in enumerate(skel)]
            return z[prefix[:-1]]
        return build(json.loads(str(z[_STRUCTURE])), "")
