"""PyTorch/CUDA port of the ECCO reproduction.

The JAX package `repro` is the reference; this package mirrors its layout
module by module (`configs`, `kernels`, `models`, `serve`, `launch`) and
never imports it. Kernels that the JAX package wrote in Pallas for the
TPU are hand-written CUDA kernels for Hopper (`csrc/`), built at first use
and bound with ctypes (`kernels/_build.py`).

Entry points run on `cuda` unless the caller passes `device="cpu"`; they
raise when CUDA is missing rather than falling back to the CPU.
"""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """The torch device an entry point runs on. Raises when CUDA was asked
    for (the default) and is not available: nothing falls back silently."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return dev
