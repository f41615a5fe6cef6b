"""Plain float32 training of the dense model for the first steps of a
retraining job: the loss, its gradients by autograd through
`reference.model`, and AdamW, all from the hyperparameters in the traffic
file.

The loss is the one the system defines (its train step's `softmax_xent`
plus the z-loss): next-token cross entropy whose log-sum-exp subtracts the
row's max for stability without stopping its gradient where the max is
added back, so the gradient of the log-sum-exp is softmax plus a one-hot
at the argmax. That is the system's stated loss, a known departure from
the textbook one (ROADMAP.md, queue 3); the reference computes the same
function so that the comparison judges the arithmetic.

AdamW: the learning rate from the count before the step (linear warm-up,
cosine decay to a tenth), the bias corrections from the count after it,
eps outside the square root, weight decay on every leaf, gradients
clipped to a global norm.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

from bench.reference import model as ref

F32 = torch.float32
Z_WEIGHT = 1e-4


def loss(cfg, params, batch: torch.Tensor, quant=None) -> torch.Tensor:
    """Mean loss over every next-token position of `batch` (B, S): cross
    entropy plus Z_WEIGHT times the mean squared log-sum-exp."""
    h = ref.hidden(cfg, params, batch[:, :-1], quant)
    lf = ref.logits(cfg, params, h, quant)
    m = lf.amax(dim=-1, keepdim=True)
    lse = torch.log(torch.exp(lf - m.detach()).sum(-1)) + m[..., 0]
    picked = lf.gather(-1, batch[:, 1:, None].long())[..., 0]
    return (lse - picked).mean() + Z_WEIGHT * lse.pow(2).mean()


def leaves(tree, prefix="") -> List[Tuple[str, torch.Tensor]]:
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in leaves(tree[k], f"{prefix}{k}/")]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree)
                for x in leaves(v, f"{prefix}{i}/")]
    return [(prefix[:-1], tree)]


def layer_leaves(tree) -> List[Tuple[str, torch.Tensor]]:
    """Leaves with every stacked segment leaf cut into its layers: the
    units whose norms are compared."""
    out = []
    for name, x in leaves(tree):
        if name.startswith("segments/"):
            out += [(f"{name}[{i}]", x[i]) for i in range(x.shape[0])]
        else:
            out.append((name, x))
    return out


def lr_at(tc: dict, count: int) -> float:
    warm = min(1.0, (count + 1) / max(1, tc["warmup_steps"]))
    prog = min(1.0, max(0.0, (count - tc["warmup_steps"])
                        / max(1, tc["total_steps"] - tc["warmup_steps"])))
    return tc["learning_rate"] * warm * (0.1 + 0.9 * 0.5
                                         * (1 + math.cos(math.pi * prog)))


class Trainer:
    """The reference job: fp32 params (copies of the given weights),
    AdamW moments, and the readings the check compares."""

    def __init__(self, cfg, params, tc: dict, quant=None):
        self.cfg, self.tc, self.quant = cfg, tc, quant
        self.p0 = params
        self.params = _tree(lambda x: x.detach().to(F32).clone()
                            .requires_grad_(), params)
        self.mu = _tree(torch.zeros_like, self.params)
        self.nu = _tree(torch.zeros_like, self.params)
        self.count = 0

    def step(self, batch) -> Tuple[float, Dict[str, float], float]:
        """One step. Returns the loss, each layer leaf's clipped gradient
        norm (the gradient as the optimizer gets it) and the global norm
        before clipping."""
        tc = self.tc
        lv = loss(self.cfg, self.params, batch, self.quant)
        ps = [x for _, x in leaves(self.params)]
        grads = torch.autograd.grad(lv, ps, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(ps, grads)]
        gn = torch.sqrt(sum((g * g).sum() for g in grads))
        scale = torch.clamp(tc["grad_clip"] / (gn + 1e-9), max=1.0)
        lr = lr_at(tc, self.count)
        self.count += 1
        b1, b2 = tc["b1"], tc["b2"]
        bc1, bc2 = 1 - b1 ** self.count, 1 - b2 ** self.count
        gtree = _unflatten(self.params, [g * scale for g in grads])
        with torch.no_grad():
            for (_, p), (_, g), (_, m), (_, v) in zip(
                    leaves(self.params), leaves(gtree), leaves(self.mu),
                    leaves(self.nu)):
                m.mul_(b1).add_((1 - b1) * g)
                v.mul_(b2).add_((1 - b2) * g * g)
                p.sub_(lr * ((m / bc1) / (torch.sqrt(v / bc2) + 1e-8)
                             + tc["weight_decay"] * p))
        norms = {n: float(x.norm()) for n, x in layer_leaves(gtree)}
        return float(lv.detach()), norms, float(gn)

    def change(self) -> Dict[str, float]:
        """Each layer leaf's norm of params - initial params."""
        with torch.no_grad():
            delta = _tree(lambda a, b: a.detach() - b.to(F32), self.params,
                          self.p0)
        return {n: float(x.norm()) for n, x in layer_leaves(delta)}


def _tree(fn, tree, *rest):
    if isinstance(tree, dict):
        return {k: _tree(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree(fn, *vs) for vs in zip(tree, *rest)]
    return fn(tree, *rest)


def _unflatten(like, flat):
    it = iter(flat)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if isinstance(t, (list, tuple)):
            return [build(v) for v in t]
        return next(it)
    return build(like)


def gap_by_worst_leaf(prog: Dict[str, float], ref_: Dict[str, float],
                      keep=None) -> Tuple[float, str]:
    """max over leaves of |prog - ref| / max(ref, the median leaf's ref):
    the gap between the two norms, not the norm of the difference."""
    names = [n for n in ref_ if keep is None or n in keep]
    med = sorted(ref_[n] for n in names)[len(names) // 2]
    worst, at = 0.0, ""
    for n in names:
        g = abs(prog[n] - ref_[n]) / max(ref_[n], med, 1e-30)
        if g > worst:
            worst, at = g, n
    return worst, at
