"""Parameter spec trees.

A model is described by a nested dict of `Spec` leaves, as in the JAX
package's `models/param.py`. From the spec tree:
  * `init_params` materializes it from an explicit `torch.Generator` on
    the generator's device. The numbers differ from `jax.random` for the
    same seed; tests that compare the two packages bridge the JAX
    parameters instead (`models/convert.py`);
  * `shardings` gives each leaf its partition spec, resolved from the
    logical axis names on its dims through a rules dict
    (`distributed.sharding.mesh_rules`);
  * `abstract_params` gives each leaf as a `meta` tensor of the block one
    mesh entry holds: the dry run's stand-ins, no allocation.

The port has no `PartitionSpec`: a pspec is a plain tuple with one entry
per dim, None, a mesh axis name or a tuple of names, which is what the
reference's `PartitionSpec` holds (`tuple(pspec)` compares equal).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, List, Optional, Sequence, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class Spec:
    """One parameter: its shape, the logical axis name of each dim (or
    None), and its init rule."""
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]   # logical axis name per dim (or None)
    init: str = "normal"              # normal | zeros | ones | neg_inf | embed
                                      # (a cache's: zeros_fp32)
    scale: float = 1.0                # fan-in style scale multiplier

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} and axes {self.axes} "
                             f"differ in rank")


def tree_map(fn: Callable, tree, *rest):
    """Apply `fn` to every leaf of a tree of dicts and lists (leaves are
    Specs or tensors), with the matching leaves of the trees in `rest` of
    the same structure as further arguments."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, *vs) for vs in zip(tree, *rest))
    return fn(tree, *rest)


def tree_leaves(tree) -> List[Any]:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def _trunc_normal(shape, generator):
    """Standard normal truncated at +-3 standard units (the JAX rule
    truncates before scaling, so the bounds here are in standard units)."""
    x = torch.empty(shape, dtype=torch.float32, device=generator.device)
    return torch.nn.init.trunc_normal_(x, 0.0, 1.0, -3.0, 3.0,
                                       generator=generator)


def _init_leaf(spec: Spec, generator, dtype):
    dev = generator.device
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=dtype, device=dev)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=dtype, device=dev)
    if spec.init == "neg_inf":
        return torch.full(spec.shape, -math.inf, dtype=dtype, device=dev)
    if spec.init == "normal":
        # truncated-normal, fan-in scaled on the last contracting dim
        fan_in = (spec.shape[0] if len(spec.shape) == 1
                  else math.prod(spec.shape[:-1]))
        std = spec.scale / max(1.0, math.sqrt(fan_in))
    elif spec.init == "embed":
        std = spec.scale * 0.02
    else:
        raise ValueError(spec.init)
    if spec.axes[:1] == ("layers",):
        # a stacked leaf is drawn one layer at a time into the leaf of the
        # target dtype, so no fp32 copy of the whole stack is ever held
        # (qwen3-moe-30b-a3b's experts: 38.7 GB in fp32, 19.3 in bf16)
        out = torch.empty(spec.shape, dtype=dtype, device=dev)
        for layer in out:
            layer.copy_(_trunc_normal(spec.shape[1:], generator).mul_(std))
        return out
    # scaled in place: the value is `_trunc_normal(...) * std`, and the
    # leaf is never held twice in fp32
    return _trunc_normal(spec.shape, generator).mul_(std).to(dtype)


def init_params(spec_tree, generator: torch.Generator,
                dtype=torch.float32):
    """Materialize real parameters on `generator.device`. Deterministic
    given the generator's seed. Every leaf is drawn in fp32, scaled and
    cast, the stacked ones a layer at a time (`_init_leaf`), so a bf16
    init is the fp32 init rounded, leaf for leaf and bit for bit, and
    peaks one layer's fp32 slice above the bf16 tree."""
    return tree_map(lambda s: _init_leaf(s, generator, dtype), spec_tree)


def logical_to_pspec(axes: Sequence[Optional[str]], rules: dict) -> tuple:
    """Logical axis names -> a pspec tuple through `rules` (a name the
    rules do not hold maps to None, replicated)."""
    return tuple(None if name is None else rules.get(name) for name in axes)


def shardings(spec_tree, mesh, rules):
    """The pspec tuple of every leaf, in the spec tree's structure. Only
    the rules are read; `mesh` is taken for the reference's signature."""
    return tree_map(lambda s: logical_to_pspec(s.axes, rules), spec_tree)


def _ways(entry, mesh_shape) -> int:
    if entry is None:
        return 1
    names = entry if isinstance(entry, tuple) else (entry,)
    return math.prod(int(mesh_shape[a]) for a in names)


def _block_shape(spec: Spec, mesh, rules) -> Tuple[int, ...]:
    """The shape of the block of `spec` one mesh entry holds: each dim
    split over the product of the mesh axes its pspec entry names, rounded
    up where it does not divide (GSPMD pads an uneven dim to a multiple of
    its ways)."""
    return tuple(-(-dim // _ways(entry, mesh.shape)) for dim, entry in
                 zip(spec.shape, logical_to_pspec(spec.axes, rules)))


def abstract_params(spec_tree, mesh, rules, dtype=torch.float32):
    """`meta` tensors of each leaf's per-entry block shape, in the spec
    tree's structure: the dry run's stand-ins (no allocation)."""
    return tree_map(lambda s: torch.empty(_block_shape(s, mesh, rules),
                                          dtype=dtype, device="meta"),
                    spec_tree)


def param_count(spec_tree) -> int:
    return int(sum(math.prod(s.shape) for s in tree_leaves(spec_tree)))


def param_bytes(spec_tree, bytes_per_el: int = 4) -> int:
    return param_count(spec_tree) * bytes_per_el
