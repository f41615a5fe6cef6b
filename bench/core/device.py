"""The card a run uses, and the guards around a run: enough CUDA devices,
no JAX in the process, and the card's name and power limit."""
from __future__ import annotations

import subprocess
import sys
from typing import List

import torch

# top-level module names that must not be loaded in a run's process: the
# JAX stack and the JAX package that the port was made from
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


class NoDevice(RuntimeError):
    pass


def require_cuda(count: int):
    """Exit (status 2, no result) unless `count` CUDA devices are here."""
    if not torch.cuda.is_available():
        raise NoDevice("bench: torch.cuda.is_available() is false; the "
                       "benchmark runs on an NVIDIA GPU")
    have = torch.cuda.device_count()
    if have < count:
        raise NoDevice(f"bench: the cell asks for {count} CUDA device(s), "
                       f"this machine has {have}")


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name (before the first dot) is one
    of FORBIDDEN, compared whole."""
    return sorted({name for name in list(sys.modules)
                   if name.split(".", 1)[0] in FORBIDDEN})


def card() -> dict:
    """Name, count and power limit of the card in use."""
    name = torch.cuda.get_device_name(0)
    limit = "unknown"
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True)
        limit = out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        pass
    return {"kind": name, "power_limit": limit}


def model_config(cfg: dict):
    """The port's ModelConfig from a configuration file: its keys that are
    ModelConfig fields (the file's other keys say where the numbers come
    from)."""
    import dataclasses
    from repro_torch.configs.base import ModelConfig, SSMConfig
    fields = {f.name for f in dataclasses.fields(ModelConfig)}
    kw = {k: v for k, v in cfg.items() if k in fields}
    if kw.get("ssm"):
        kw["ssm"] = SSMConfig(**kw["ssm"])
    if "global_attn_layers" in kw:
        kw["global_attn_layers"] = tuple(kw["global_attn_layers"])
    return ModelConfig(**kw)
