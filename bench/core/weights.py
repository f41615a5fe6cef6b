"""Model weights made from the seed on the run's device, in a few large
calls: one normal draw for the whole tree, clipped at three standard
units, then each leaf's view scaled to its init rule (fan-in for
projections, 0.02 for embeddings, ones and zeros where the model says).
The program and the reference are both given these weights; the layout of
the tree (its keys and shapes) is the model's parameter spec."""
from __future__ import annotations

import math

import torch


def _leaves(spec, path=()):
    if isinstance(spec, dict):
        for k in spec:
            yield from _leaves(spec[k], path + (k,))
    elif isinstance(spec, (list, tuple)):
        for i, v in enumerate(spec):
            yield from _leaves(v, path + (i,))
    else:
        yield path, spec


def _set(tree, path, value):
    for k in path[:-1]:
        tree = tree[k]
    tree[path[-1]] = value


def _skeleton(spec):
    if isinstance(spec, dict):
        return {k: _skeleton(v) for k, v in spec.items()}
    if isinstance(spec, (list, tuple)):
        return [_skeleton(v) for v in spec]
    return None


def _std(path, s) -> float:
    """0.02 for an embedding; otherwise the spec's scale over the square
    root of the fan-in of one layer's matrix (the model dimension for the
    (D, heads, head_dim) query, key and value projections)."""
    if s.init == "embed":
        return 0.02 * s.scale
    shape = s.shape[1:] if s.axes[:1] == ("layers",) else s.shape
    if path[-1] in ("wq", "wk", "wv") or len(shape) == 1:
        fan_in = shape[0]
    else:
        fan_in = math.prod(shape[:-1])
    return s.scale / max(1.0, math.sqrt(fan_in))


def make(spec, seed: int, device, dtype=torch.float32):
    """A params tree shaped as `spec` (the model's tree of Specs, which
    carry shape, init rule and scale), every leaf a view of one buffer."""
    items = list(_leaves(spec))
    drawn = [(p, s) for p, s in items if s.init in ("normal", "embed")]
    total = sum(math.prod(s.shape) for _, s in drawn)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) & 0xFFFF_FFFF_FFFF_FFFF)
    buf = torch.randn(total, generator=gen, device=device,
                      dtype=torch.float32)
    buf.clamp_(-3.0, 3.0)
    if dtype != torch.float32:
        buf = buf.to(dtype)
    tree = _skeleton(spec)
    at = 0
    for path, s in drawn:
        n = math.prod(s.shape)
        leaf = buf[at:at + n].view(s.shape)
        leaf.mul_(_std(path, s))
        _set(tree, path, leaf)
        at += n
    for path, s in items:
        if s.init == "zeros":
            _set(tree, path, torch.zeros(s.shape, dtype=dtype, device=device))
        elif s.init == "ones":
            _set(tree, path, torch.ones(s.shape, dtype=dtype, device=device))
        elif s.init == "neg_inf":
            _set(tree, path, torch.full(s.shape, -math.inf, dtype=dtype,
                                        device=device))
    return tree


def spec_of(cfg):
    """The parameter spec of the port's model for a ModelConfig."""
    from repro_torch.models.model import build_model
    return build_model(cfg).spec
