"""The card a run uses, and the guards around a run: enough CUDA devices,
no JAX in the process, and the card's name and power limit."""
from __future__ import annotations

import dataclasses
import subprocess
import sys
import types
import typing
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
    from), each as its field's type asks (`typed`)."""
    from repro_torch.configs.base import ModelConfig
    names = {f.name for f in dataclasses.fields(ModelConfig)}
    return typed(ModelConfig, {k: v for k, v in cfg.items() if k in names})


def typed(hint, value):
    """A value read from JSON as the type `hint` asks: a dict as the
    dataclass it names (each field in turn, by the dataclass's own type
    hints, so that a sub-configuration the port adds needs no word here),
    a list as a tuple where it names a tuple; else the value itself."""
    if value is None:
        return None
    origin, args = typing.get_origin(hint), typing.get_args(hint)
    if origin in (typing.Union, types.UnionType):          # Optional[X]
        return typed(next(a for a in args if a is not type(None)), value)
    if dataclasses.is_dataclass(hint) and isinstance(value, dict):
        hints = typing.get_type_hints(hint)
        return hint(**{k: typed(hints.get(k), v) for k, v in value.items()})
    if origin is tuple and isinstance(value, list):
        return tuple(typed(args[0] if args[1:] == (...,) else args[i], v)
                     for i, v in enumerate(value))
    return value
