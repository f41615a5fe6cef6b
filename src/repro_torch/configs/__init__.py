"""Architecture registry: `get_config(arch)`, `smoke_config(arch)`.

Each architecture lives in its own module with the exact published
dimensions; `smoke_config()` returns a reduced same-family variant used by
CPU tests. The registry is the JAX package's, in its order: the dense,
MoE, hybrid, xLSTM, encoder and VLM families, with the dry run's
`SHAPES` and `cell_is_runnable`; `PORT_ARCH_IDS` are the architectures
the port adds (granite-4.0-h-micro, whose layers are each a Mamba-2 mixer
or attention).
"""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.configs.base import (  # noqa: F401  (re-exported)
    DENSE, ENCODER, HYBRID, MAMBA_HYBRID, MOE, SSM, VLM, ModelConfig,
    MoEConfig,
    SHAPES, SSMConfig, ShapeConfig, TrainConfig)

_ARCH_MODULES: Dict[str, str] = {
    "olmo-1b": "repro_torch.configs.olmo_1b",
    "stablelm-3b": "repro_torch.configs.stablelm_3b",
    "llama3-8b": "repro_torch.configs.llama3_8b",
    "starcoder2-3b": "repro_torch.configs.starcoder2_3b",
    "xlstm-350m": "repro_torch.configs.xlstm_350m",
    "qwen3-moe-30b-a3b": "repro_torch.configs.qwen3_moe_30b_a3b",
    "qwen2-moe-a2.7b": "repro_torch.configs.qwen2_moe_a2_7b",
    "hymba-1.5b": "repro_torch.configs.hymba_1_5b",
    "hubert-xlarge": "repro_torch.configs.hubert_xlarge",
    "chameleon-34b": "repro_torch.configs.chameleon_34b",
}

ARCH_IDS: List[str] = list(_ARCH_MODULES)

# architectures the port serves beyond the JAX package's registry: no JAX
# twin and no dry-run cell (`launch.dryrun` runs ARCH_IDS)
_PORT_MODULES: Dict[str, str] = {
    "granite-4.0-h-micro": "repro_torch.configs.granite_4_0_h_micro",
}

PORT_ARCH_IDS: List[str] = list(_PORT_MODULES)


def _module(arch: str):
    name = _ARCH_MODULES.get(arch) or _PORT_MODULES.get(arch)
    if name is None:
        raise KeyError(f"unknown arch {arch!r}; known: "
                       f"{ARCH_IDS + PORT_ARCH_IDS}")
    return importlib.import_module(name)


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def smoke_config(arch: str) -> ModelConfig:
    return _module(arch).smoke_config()


def cell_is_runnable(cfg: ModelConfig, shape_name: str) -> str:
    """Return 'ok' or a skip reason for an (arch, shape) cell."""
    shape = SHAPES[shape_name]
    if shape.kind == "decode" and not cfg.has_decode:
        return "skip: encoder-only arch has no decode step"
    if shape_name == "long_500k" and not cfg.sub_quadratic:
        return ("skip: full-attention arch; 524k decode needs "
                "sub-quadratic attention")
    return "ok"
