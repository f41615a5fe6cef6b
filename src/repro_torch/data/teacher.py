"""Teacher annotation, as in the JAX package's `data/teacher.py`: the
server-side "high-accuracy model" that labels retraining frames (paper
Fig. 1: YOLO11x annotating sampled frames).

Two teachers are provided:
  * OracleTeacher — the DomainBank's true next-token distribution
    (a perfect teacher; isolates control-plane effects in benchmarks).
  * ModelTeacher  — a larger same-family student (by default 2x depth)
    producing logits with the port's fp32 forward on the card (full
    attention through flash_attention's CUDA-core kernel); run
    server-side only on sampled frames.

Both return per-token soft label distributions that the train step
consumes through `distill_weight` (repro_torch.train.train_step.
make_loss_fn). ModelTeacher's weights are random from `seed`
(`torch.Generator`, not `jax.random`: tests hold it to the reference on
bridged weights).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models.model import build_model


class OracleTeacher:
    """Wraps a DomainBank; emits exact next-token distributions."""

    def __init__(self, bank):
        self.bank = bank

    def annotate(self, domain: int, tokens: np.ndarray) -> np.ndarray:
        """tokens (B,S) -> soft targets (B,S,V) (probability space)."""
        return self.bank.soft_labels(domain, tokens)


def scale_config(cfg: ModelConfig, *, depth_mult: float = 2.0,
                 width_mult: float = 1.0) -> ModelConfig:
    """A same-family, larger teacher config (the YOLO11n -> YOLO11x
    analogue)."""
    d_model = int(cfg.d_model * width_mult)
    return dataclasses.replace(
        cfg,
        name=cfg.name + "-teacher",
        num_layers=max(1, int(cfg.num_layers * depth_mult)),
        d_model=d_model,
        d_ff=int(cfg.d_ff * width_mult) if cfg.d_ff else cfg.d_ff,
        num_heads=max(1, int(cfg.num_heads * width_mult)),
        num_kv_heads=max(1, int(cfg.num_kv_heads * width_mult)),
    )


class ModelTeacher:
    """A larger same-family model annotating sampled sequences with
    logits. Kept fp32 on the server; never shipped to devices. Runs on
    `device` (CUDA unless the CPU is asked for)."""

    def __init__(self, student_cfg: ModelConfig, *, depth_mult: float = 2.0,
                 width_mult: float = 1.0, seed: int = 0, device="cuda"):
        self.cfg = scale_config(student_cfg, depth_mult=depth_mult,
                                width_mult=width_mult)
        self.device = resolve_device(device)
        self.model = build_model(self.cfg)
        self.params = self.model.init(seed=seed, device=self.device)

    @torch.no_grad()
    def annotate(self, tokens: np.ndarray) -> np.ndarray:
        """tokens (B,S) -> teacher logits (B,S,V) as float32."""
        logits, _ = self.model.apply(
            self.params, torch.as_tensor(np.asarray(tokens),
                                         device=self.device),
            compute_dtype=torch.float32)
        return logits.cpu().numpy()

    def fit(self, batches, *, steps: int = 50, lr: float = 3e-3,
            tcfg=None):
        """Optionally adapt the teacher itself on pooled fleet data (the
        paper pre-trains teachers offline; exposed for examples). The
        port's train step (the autograd route), in place on the
        teacher's parameters."""
        from repro_torch.configs.base import TrainConfig
        from repro_torch.train.optimizer import init_opt_state
        from repro_torch.train.train_step import make_train_step
        tcfg = tcfg or TrainConfig(learning_rate=lr, warmup_steps=5,
                                   total_steps=max(steps, 10), remat="none")
        step = make_train_step(self.model, tcfg)
        state = {"params": self.params, "opt": init_opt_state(self.params)}
        it = 0
        while it < steps:
            for b in batches:
                state, _ = step(state, {
                    k: torch.as_tensor(np.asarray(v), device=self.device)
                    for k, v in b.items()})
                it += 1
                if it >= steps:
                    break
        self.params = state["params"]
        return self
