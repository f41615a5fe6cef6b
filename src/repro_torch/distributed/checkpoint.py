"""Atomic, async checkpoints of state trees, ported from the JAX
package's `distributed/checkpoint.py`.

Layout, the reference's: one directory per step,
    step_%08d/manifest.json   tree structure, shapes, dtypes, step meta
    step_%08d/<i>.npy         one array per leaf
written to `<dir>.tmp` and renamed, so a crash mid-write never corrupts
the latest checkpoint: `list_steps` / `latest_step` only see complete
directories. `AsyncCheckpointer.save_async` copies the tree to the host
on the caller's thread and serializes it on a daemon thread, keeping the
newest `keep` steps.

Leaves go in the port's tree order (`core.trainer._flatten`: dict keys
sorted, as JAX flattens them), so a checkpoint of a dict tree lists its
leaves in the reference's order. numpy has no bfloat16: a bf16 tensor is
stored as its uint16 bits and the manifest records its torch dtype, which
`restore` reads back bit for bit.

`restore(..., devices=)` places each leaf on a device (one device, or a
tree of devices matching the target: the elastic re-mesh path). A
retraining job's state is restored THROUGH the JobBank (`restore_job`):
the assignment goes through `job.state = ...`, i.e. `JobBank.write`,
which stages host values in the mirror and marks the device row stale for
the next batched call's flush.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import List, Optional

import numpy as np
import torch

from repro_torch.core.trainer import _flatten, _skeleton, _unflatten

_BF16 = "bfloat16"


def _host_leaf(leaf):
    """(numpy array, torch dtype name or None) of a leaf, on the host."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), _BF16
        return t.numpy(), str(t.dtype).replace("torch.", "")
    return np.asarray(leaf), None


def _to_host(tree):
    """The tree's leaves copied to host numpy (bf16 as uint16 bits)."""
    return [_host_leaf(x) for x in _flatten(tree)]


def _write(ckpt_dir: str, step: int, skel, leaves,
           extra: Optional[dict]) -> str:
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    manifest = {"step": step, "treedef": json.dumps(skel),
                "num_leaves": len(leaves), "leaves": [],
                "extra": extra or {}}
    for i, (arr, tdtype) in enumerate(leaves):
        np.save(os.path.join(tmp, f"{i}.npy"), arr)
        meta = {"shape": list(arr.shape), "dtype": str(arr.dtype)}
        if tdtype is not None:
            meta["torch_dtype"] = tdtype
        manifest["leaves"].append(meta)
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)       # atomic publish
    return final


def save(ckpt_dir: str, step: int, tree, *,
         extra: Optional[dict] = None) -> str:
    """Blocking save with atomic rename. Leaves may be torch tensors on
    any device or numpy arrays."""
    return _write(ckpt_dir, step, _skeleton(tree), _to_host(tree), extra)


class AsyncCheckpointer:
    """Serializes saves on a background thread; at most one in flight."""

    def __init__(self, ckpt_dir: str, *, keep: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self.last_path: Optional[str] = None
        self._error: Optional[BaseException] = None

    def wait(self):
        """Join the save in flight; re-raise what it raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def save_async(self, step: int, tree, *, extra: Optional[dict] = None):
        self.wait()
        # to the host on the caller's thread: bank rows train in place and
        # may change once the caller goes on
        skel, leaves = _skeleton(tree), _to_host(tree)

        def work():
            try:
                self.last_path = _write(self.ckpt_dir, step, skel, leaves,
                                        extra)
                self._gc()
            except BaseException as e:      # re-raised by wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()
        return self._thread

    def _gc(self):
        for s in list_steps(self.ckpt_dir)[:-self.keep]:
            shutil.rmtree(os.path.join(self.ckpt_dir, f"step_{s:08d}"),
                          ignore_errors=True)


def list_steps(ckpt_dir: str) -> List[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for name in os.listdir(ckpt_dir):
        if name.startswith("step_") and not name.endswith(".tmp") and \
                os.path.exists(os.path.join(ckpt_dir, name,
                                            "manifest.json")):
            out.append(int(name[5:]))
    return sorted(out)


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = list_steps(ckpt_dir)
    return steps[-1] if steps else None


def _load_leaf(path: str, meta: dict) -> torch.Tensor:
    arr = np.load(path)
    if meta.get("torch_dtype") == _BF16:
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def restore(ckpt_dir: str, step: int, target_tree, *, devices=None):
    """Load a checkpoint into the structure of `target_tree` (any tree of
    the same structure and leaf shapes: `JobBank.read_template`'s `meta`
    tensors serve). Returns (tree of tensors, the manifest's `extra`).

    `devices`: None leaves the tensors on the host; a device places every
    leaf there; a tree of devices matching `target_tree` places each leaf
    on its own (the elastic re-mesh path)."""
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    want = _flatten(target_tree)
    if manifest["num_leaves"] != len(want):
        raise ValueError(f"checkpoint has {manifest['num_leaves']} leaves, "
                         f"target {len(want)}: structure changed?")
    loaded = [_load_leaf(os.path.join(path, f"{i}.npy"), meta)
              for i, meta in enumerate(manifest["leaves"])]
    for got, ref in zip(loaded, want):
        if tuple(got.shape) != tuple(np.shape(ref)):
            raise ValueError(f"leaf shape {tuple(got.shape)}, target "
                             f"{tuple(np.shape(ref))}")
    if devices is not None:
        devs = (_flatten(devices) if isinstance(devices, (dict, list, tuple))
                else [devices] * len(loaded))
        loaded = [x.to(d) for x, d in zip(loaded, devs)]
    return _unflatten(_skeleton(target_tree), loaded), manifest["extra"]


def restore_job(ckpt_dir: str, step: int, job, *, devices=None):
    """Restore a retraining job's train-state IN PLACE, writing through
    the JobBank (`job.state = tree`: host values land in the mirror and
    the device row goes stale; values on the bank's device are copied on
    the device). Loaded against the job's `state_template` (no sync).
    Returns the manifest's `extra` dict."""
    template = getattr(job, "state_template", None)
    if template is None:
        template = job.state
    tree, extra = restore(ckpt_dir, step, template, devices=devices)
    job.state = tree
    return extra
