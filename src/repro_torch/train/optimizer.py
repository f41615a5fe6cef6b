"""AdamW with warmup + cosine decay on nested dicts of tensors, as in the
JAX package's `train/optimizer.py` and with its arithmetic: the learning
rate comes from the count before the step, the bias corrections from the
count after it (in fp32), eps 1e-8 sits outside the square root, weight
decay applies to every leaf, the clip scale is min(1, max_norm / (gn +
1e-9)), and mu and nu are fp32.

`adamw_update` writes in place into the tensors it is given (params, mu,
nu and the count), so a caller that passes views of a stacked bank row
updates that row (`core/trainer.py`).
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import TrainConfig
from repro_torch.models.param import tree_leaves, tree_map

F32 = torch.float32


def init_opt_state(params):
    leaf = tree_leaves(params)[0]
    return {"mu": tree_map(lambda p: torch.zeros_like(p, dtype=F32), params),
            "nu": tree_map(lambda p: torch.zeros_like(p, dtype=F32), params),
            "count": torch.zeros((), dtype=torch.int32, device=leaf.device)}


def lr_schedule(tcfg: TrainConfig, step):
    """The learning rate at step `step` (a count tensor or an int), fp32."""
    step = torch.as_tensor(step).to(F32)
    warm = torch.clamp((step + 1) / max(1, tcfg.warmup_steps), max=1.0)
    prog = torch.clamp((step - tcfg.warmup_steps)
                       / max(1, tcfg.total_steps - tcfg.warmup_steps),
                       0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    return tcfg.learning_rate * warm * (0.1 + 0.9 * cos)


def global_norm(tree):
    return torch.sqrt(sum(torch.sum(torch.square(x.to(F32)))
                          for x in tree_leaves(tree)))


def _clip_scale(gn, max_norm: float):
    return torch.clamp(max_norm / (gn + 1e-9), max=1.0)


def clip_by_global_norm(grads, max_norm: float):
    gn = global_norm(grads)
    scale = _clip_scale(gn, max_norm)
    return tree_map(lambda g: g * scale, grads), gn


def adamw_update(tcfg: TrainConfig, params, grads, opt_state):
    """One AdamW step, in place. Returns (params, opt_state, metrics): the
    trees it was given, updated, and {"grad_norm", "lr"} (0-d fp32). The
    gradients are clipped leaf by leaf as they are used, so no clipped copy
    of the whole tree is made."""
    gnorm = global_norm(grads)
    scale = _clip_scale(gnorm, tcfg.grad_clip)
    count = opt_state["count"]
    lr = lr_schedule(tcfg, count)
    count.add_(1)
    cf = count.to(F32)
    b1, b2 = tcfg.b1, tcfg.b2
    bc1 = 1 - b1 ** cf
    bc2 = 1 - b2 ** cf

    def upd(p, g, mu, nu):
        g = (g * scale).to(F32)
        p32 = p.to(F32)
        mu.mul_(b1).add_((1 - b1) * g)
        nu.mul_(b2).add_((1 - b2) * torch.square(g))
        step = (mu / bc1) / (torch.sqrt(nu / bc2) + 1e-8) \
            + tcfg.weight_decay * p32
        p.copy_(p32 - lr * step)

    tree_map(upd, params, grads, opt_state["mu"], opt_state["nu"])
    return params, opt_state, {"grad_norm": gnorm, "lr": lr}
