"""Architecture registry: `get_config(arch)`, `smoke_config(arch)`.

Each architecture lives in its own module with the exact published
dimensions; `smoke_config()` returns a reduced same-family variant used by
CPU tests. The port registers olmo-1b (dense), hymba-1.5b (hybrid) and
xlstm-350m (the xLSTM family); the other architectures of the JAX
package's registry arrive with their model families (ROADMAP.md).
"""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.configs.base import ModelConfig

_ARCH_MODULES: Dict[str, str] = {
    "olmo-1b": "repro_torch.configs.olmo_1b",
    "hymba-1.5b": "repro_torch.configs.hymba_1_5b",
    "xlstm-350m": "repro_torch.configs.xlstm_350m",
}

ARCH_IDS: List[str] = list(_ARCH_MODULES)


def get_config(arch: str) -> ModelConfig:
    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {ARCH_IDS}")
    return importlib.import_module(_ARCH_MODULES[arch]).CONFIG


def smoke_config(arch: str) -> ModelConfig:
    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {ARCH_IDS}")
    return importlib.import_module(_ARCH_MODULES[arch]).smoke_config()
