"""Train-step factory, as in the JAX package's `train/train_step.py`: the
loss (next-token CE + MoE aux + z-loss + an optional distill term),
microbatched gradient accumulation, mixed precision over fp32 masters,
and the AdamW update (`train/optimizer.py`).

The forward differentiates the plain forms through `kernel_impl=
"autograd"` (`kernels/ops.py`): the JAX step trains through XLA, and no
hand-written kernel of either package has a backward pass. `tcfg.remat`
rematerialises each layer as the reference's does (`models.transformer.
_remat_wrap`). Gradients come from `grad_and_value`, `torch.autograd.grad`
over the params tree: checkpointing works through saved-tensor hooks,
which the `torch.func` transforms refuse. The update is in
place, so a step changes the state trees it is given; `make_train_step_
many` runs its lanes one after another on views of a stacked state, so
lane j is bit-identical to `make_train_step` run on state j with its
batches in order.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import (ENCODER, ModelConfig, TrainConfig,
                                      check_train_config)
from repro_torch.kernels.ops import AUTOGRAD
from repro_torch.models.model import Model
from repro_torch.models.param import tree_leaves, tree_map
from repro_torch.train import optimizer as opt_lib

AUX_WEIGHT = 0.01
Z_WEIGHT = 1e-4
F32 = torch.float32


def softmax_xent(cfg: ModelConfig, logits, labels):
    """Stable CE over the (padded) vocab axis. logits (B,S,V), labels (B,S)
    int. Returns (mean CE, mean z-loss). The label logit is picked with a
    gather (the JAX version sums against a one-hot, the same value in
    fp32 without a (B,S,V) one-hot).

    As in the JAX version, the max is detached where it shifts the
    exponent but not where it is added back, so the gradient of lse is
    softmax + one-hot(argmax), not softmax: a defect of the reference
    (ROADMAP.md queue 3) that the port keeps, since its training is held
    to the reference's."""
    lf = logits.to(F32)
    m = lf.amax(dim=-1, keepdim=True)
    lse = torch.log(torch.sum(torch.exp(lf - m.detach()), dim=-1)) \
        + m[..., 0]
    picked = torch.gather(lf, -1, labels[..., None].long())[..., 0]
    ce = torch.mean(lse - picked)
    z = torch.mean(torch.square(lse))
    return ce, z


def grad_and_value(loss_fn):
    """`torch.func.grad_and_value(loss_fn, has_aux=True)` on the
    autograd engine: returns f(params, batch) -> (grads, (loss, aux)),
    the gradient of every leaf of `params` in its tree (zeros where the
    loss does not reach it), the loss and aux detached. The leaves are
    differentiated through detached aliases, so `params` may be views of
    a stack that the update then writes in place; grad mode is on inside,
    whatever the caller's."""
    def run(params, batch):
        with torch.enable_grad():
            ps = tree_map(lambda p: p.detach().requires_grad_(), params)
            loss, aux = loss_fn(ps, batch)
            leaves = tree_leaves(ps)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        it = iter(torch.zeros_like(p) if g is None else g
                  for p, g in zip(leaves, grads))
        return (tree_map(lambda _: next(it), ps),
                (loss.detach(), tree_map(torch.Tensor.detach, aux)))
    return run


def make_loss_fn(model: Model, tcfg: TrainConfig, *, mesh=None, rules=None,
                 moe_impl: str = "dense", distill_weight: float = 0.0,
                 ssm_impl: str = "gspmd"):
    """The loss of `params` on a batch. With a mesh, `moe_impl="ep"`
    differentiates the expert-parallel MoE and `ssm_impl="seqpar"` the
    sequence-parallel mLSTM (its two passes on the chunked plain form,
    as every op of the train forward)."""
    check_train_config(tcfg)
    cfg = model.cfg
    compute_dtype = getattr(torch, tcfg.compute_dtype)

    def loss_fn(params, batch):
        # cast the fp32 masters to the compute dtype once, outside the
        # layers; the gradients flow back through the cast into fp32
        if compute_dtype != F32:
            params = tree_map(lambda p: p.to(compute_dtype)
                              if p.dtype == F32 else p, params)
        logits, aux = model.apply(params, batch["inputs"],
                                  compute_dtype=compute_dtype,
                                  kernel_impl=AUTOGRAD, mesh=mesh,
                                  rules=rules, moe_impl=moe_impl,
                                  ssm_impl=ssm_impl, remat=tcfg.remat)
        if cfg.family == ENCODER or not cfg.causal:
            lab, lg = batch["labels"], logits
        else:
            lg = logits[:, :-1]
            lab = batch["labels"][:, 1:]
        ce, z = softmax_xent(cfg, lg, lab)
        loss = ce + AUX_WEIGHT * aux + Z_WEIGHT * z
        if distill_weight and "teacher_logits" in batch:
            tl = batch["teacher_logits"].to(F32)
            sl = torch.log_softmax(lg.to(F32)[..., :tl.shape[-1]], dim=-1)
            tp = torch.softmax(tl, dim=-1)
            kd = -torch.mean(torch.sum(tp * sl, dim=-1))
            loss = loss + distill_weight * kd
        return loss, {"ce": ce, "aux": aux, "z": z}

    return loss_fn


def make_train_step(model: Model, tcfg: TrainConfig, *, mesh=None,
                    rules=None, moe_impl: str = "dense",
                    distill_weight: float = 0.0, ssm_impl: str = "gspmd"):
    """Returns train_step(state, batch) -> (state, metrics). state is
    {"params", "opt"}, updated in place and returned; batch holds
    {"inputs", "labels"[, "teacher_logits"]} tensors on the state's
    device. metrics: {"loss", "ce", "aux", "z", "grad_norm", "lr"}, 0-d."""
    loss_fn = make_loss_fn(model, tcfg, mesh=mesh, rules=rules,
                           moe_impl=moe_impl, distill_weight=distill_weight,
                           ssm_impl=ssm_impl)
    value_and_grads = grad_and_value(loss_fn)
    k = tcfg.microbatches

    def grads_of(params, batch):
        if k <= 1:
            grads, (loss, met) = value_and_grads(params, batch)
            return loss, met, grads
        # gradient accumulation over k microbatches
        micro = {n: x.reshape((k, x.shape[0] // k) + x.shape[1:])
                 for n, x in batch.items()}
        acc = tree_map(lambda p: torch.zeros(p.shape, dtype=F32,
                                             device=p.device), params)
        loss_sum = 0.0
        for i in range(k):
            grads, (loss, met) = value_and_grads(
                params, {n: x[i] for n, x in micro.items()})
            acc = tree_map(torch.add, acc, grads)
            loss_sum = loss_sum + loss
        return loss_sum / k, met, tree_map(lambda g: g / k, acc)

    def train_step(state, batch):
        loss, met, grads = grads_of(state["params"], batch)
        _, _, omet = opt_lib.adamw_update(tcfg, state["params"], grads,
                                          state["opt"])
        return state, {"loss": loss, **met, **omet}

    return train_step


def make_train_step_many(model: Model, tcfg: TrainConfig, *, mesh=None,
                         rules=None, moe_impl: str = "dense",
                         distill_weight: float = 0.0,
                         ssm_impl: str = "gspmd"):
    """Multi-step trainer over STACKED job states.

    Returns train_steps_many(states, batches, lanes=None) -> (states,
    metrics): `states` is a state tree with a leading jobs axis on every
    leaf, `batches` holds tensors of shape (len(lanes), steps, ...), and
    lane j runs its `steps` train_step updates in place on row lanes[j]
    (default j) of `states`. The lanes run one after another through the
    one-lane step, so lane j is bit-identical to make_train_step run on
    state j with its batches in order (the JAX version's vmap of a scan
    pins the same contract; a batched vmap here would round its GEMMs
    differently). Metrics: every step's, stacked as (lanes, steps)."""
    step = make_train_step(model, tcfg, mesh=mesh, rules=rules,
                           moe_impl=moe_impl, distill_weight=distill_weight,
                           ssm_impl=ssm_impl)

    def train_steps_many(states, batches, lanes=None):
        n = next(iter(batches.values())).shape[0]
        lanes = range(n) if lanes is None else lanes
        mets = []
        for j, row in enumerate(lanes):
            st = tree_map(lambda x: x[row], states)
            lane = []
            for s in range(next(iter(batches.values())).shape[1]):
                st, met = step(st, {name: b[j, s]
                                    for name, b in batches.items()})
                lane.append(met)
            mets.append(lane)
        metrics = {name: torch.stack([torch.stack([m[name] for m in lane])
                                      for lane in mets])
                   for name in mets[0][0]} if mets else {}
        return states, metrics

    return train_steps_many


def init_state(model: Model, seed: int = 0,
               tcfg: Optional[TrainConfig] = None, device="cuda"):
    dtype = getattr(torch, (tcfg or TrainConfig()).param_dtype)
    params = model.init(seed, dtype, device=device)
    return {"params": params, "opt": opt_lib.init_opt_state(params)}
