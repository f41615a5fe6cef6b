"""Build and load the port's CUDA kernels.

Each source under `repro_torch/csrc/` is compiled by `nvcc` into a shared
library with a plain C interface and loaded with ctypes (no PyTorch
headers, so a build takes seconds). Libraries go to `build/kernels/` at
the repository root, named by a hash of the source and the flags, and are
built at first use; concurrent builders write to a private file and
rename it into place. `refuse_grad` is every wrapper's guard against a
call under autograd.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LOADED: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def library_path(source: str) -> Path:
    text = (CSRC / source).read_bytes()
    tag = hashlib.sha256(text + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{Path(source).stem}-{tag[:16]}.so"


def build(source: str) -> Path:
    """Compile `csrc/<source>` unless a library of the same content exists.
    Raises on a compiler error, with the compiler's output; on success the
    output (ptxas' register / spill report) is kept beside the library as
    `<library>.log`."""
    out = library_path(source)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source}:\n{proc.stdout}\n"
                           f"{proc.stderr}")
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)
    return out


def load(source: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<source>`, built first if needed."""
    lib = _LOADED.get(source)
    if lib is None:
        lib = ctypes.CDLL(str(build(source)))
        _LOADED[source] = lib
    return lib


def refuse_grad(op: str, *tensors):
    """Raise when grad mode is on and a floating input requires grad: the
    kernels have no backward pass, so their output would carry no
    `grad_fn` and silently cut the gradient. Checked on every device."""
    if torch.is_grad_enabled() and any(
            t.requires_grad and t.is_floating_point() for t in tensors):
        raise ValueError(
            f"{op}: the hand-written kernels have no backward; train "
            f"through impl='autograd'")
