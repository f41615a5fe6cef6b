"""fleetlint runtime sanitizer for the port: dynamic checks of the
residency contracts static analysis can only approximate, the JAX
package's sanitizer on the port's `core.trainer` classes.

Two instruments, installed by monkeypatching the real classes (no
subclass opt-in — the point is to catch call sites that DIDN'T opt in):

* **Borrow fingerprinting** — every `JobBank.params_stack()` /
  `params_stack_compute()` call records a checksum of the borrowed
  leaves plus the bank's `_version`.  At the next entry-point sync
  (`compact()` / `sync_to_device()`), if the version is unchanged — no
  legitimate write invalidated the borrow — the leaves are re-hashed:
  a mismatch means someone mutated the borrowed buffers in place,
  bypassing the dirty-bit write protocol (host mode) or writing the
  device rows the bank owns.  A version bump simply retires the record:
  that is the borrow expiring legally.

* **Transfer guard** — the batched decision entry points
  (`eval_pairs`, `eval_jobs`, `train_micro_many`, `batched_accuracy`)
  promise zero host<->device crossings of bank state once the fleet is
  resident (docs/training_plane.md).  The guard pre-flushes (compact +
  sync, both idempotent and exactly what the entry point would do
  first anyway), then hard-fails any `TransferStats.h2d/d2h` fired
  inside the guarded call on a resident bank.

`install()` / `uninstall()` patch and restore the classes; both
instruments change failure modes only, never values.
"""
from __future__ import annotations

import zlib
from typing import Dict, List, Tuple

import numpy as np
import torch


class FleetlintRuntimeError(RuntimeError):
    """A residency-contract violation caught at runtime."""


_ORIGINALS: Dict[str, object] = {}    # qualified name -> unpatched fn


def _leaves(tree) -> list:
    from repro_torch.models.param import tree_leaves
    return tree_leaves(tree)


def _host_bytes(leaf) -> bytes:
    """A leaf's bytes on the host: a tensor's (bf16 as its int16 bits)
    through one debug-only d2h, a numpy array's as they are."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        # fleetlint: disable=host-sync -- the sanitizer's debug-only
        # d2h: a test mode, not a production path
        return t.cpu().contiguous().numpy().tobytes()
    return np.ascontiguousarray(np.asarray(leaf)).tobytes()


def _fingerprint(tree) -> List[Tuple[int, int]]:
    """(id, crc32) per leaf of a borrowed stack."""
    return [(id(leaf), zlib.crc32(_host_bytes(leaf)))
            for leaf in _leaves(tree)]


def _record_borrow(bank, stack) -> None:
    if stack is None:
        return
    bank._fleetlint_borrow = {
        "version": bank._version,
        "prints": _fingerprint(stack),
        "tree": stack,
    }


def _verify_borrow(bank) -> None:
    rec = getattr(bank, "_fleetlint_borrow", None)
    if rec is None:
        return
    bank._fleetlint_borrow = None
    if rec["version"] != bank._version:
        return    # a legitimate write/compaction retired the borrow
    for (lid, crc), leaf in zip(rec["prints"], _leaves(rec["tree"])):
        if zlib.crc32(_host_bytes(leaf)) != crc:
            raise FleetlintRuntimeError(
                "borrowed params_stack() buffers were mutated in place "
                "with no bank version bump — a write bypassed the "
                "dirty-bit protocol (docs/training_plane.md residency "
                "rule: go through bank.write / scatter / "
                "written_on_device)")


class _GuardStats:
    """TransferStats stand-in that hard-fails on any crossing.  All
    other reads/writes forward to the real stats object (TransferStats
    is __slots__-only, so the guard swaps `bank.stats` wholesale for
    the duration of the guarded call)."""

    def __init__(self, inner):
        object.__setattr__(self, "_inner", inner)

    def h2d(self, nbytes: int):
        raise FleetlintRuntimeError(
            f"h2d transfer ({nbytes} bytes) of bank state inside a "
            f"batched decision call on a resident bank — the residency "
            f"contract promises zero per-call host crossings "
            f"(docs/training_plane.md)")

    def d2h(self, nbytes: int):
        raise FleetlintRuntimeError(
            f"d2h transfer ({nbytes} bytes) of bank state inside a "
            f"batched decision call on a resident bank — the residency "
            f"contract promises zero per-call host crossings "
            f"(docs/training_plane.md)")

    def __getattr__(self, name):
        return getattr(object.__getattribute__(self, "_inner"), name)

    def __setattr__(self, name, value):
        setattr(object.__getattribute__(self, "_inner"), name, value)


def _guard_transfers(engine):
    """Context manager: hard-fail any TransferStats crossing fired
    inside a batched decision call on a RESIDENT bank."""
    class _Guard:
        def __enter__(self):
            bank = engine.bank
            self.bank = bank
            self.depth = getattr(bank, "_fleetlint_guard_depth", 0)
            bank._fleetlint_guard_depth = self.depth + 1
            self.armed = not (self.depth or not bank.resident
                              or bank._host is None)
            if self.armed:
                # the entry point's own first moves, hoisted:
                # idempotent, and any crossing they need happens
                # BEFORE the guard arms
                bank.compact()
                bank.sync_to_device()
                bank.stats = _GuardStats(bank.stats)
            return self

        def __exit__(self, *exc):
            self.bank._fleetlint_guard_depth = self.depth
            if self.armed and isinstance(self.bank.stats, _GuardStats):
                self.bank.stats = object.__getattribute__(
                    self.bank.stats, "_inner")
            return False
    return _Guard()


def install() -> None:
    """Monkeypatch JobBank + SharedEngine with the sanitizer hooks.
    Idempotent; `uninstall()` restores the originals."""
    if _ORIGINALS:
        return
    from repro_torch.core.trainer import JobBank, SharedEngine

    _ORIGINALS["JobBank.params_stack"] = JobBank.params_stack
    _ORIGINALS["JobBank.compact"] = JobBank.compact
    _ORIGINALS["JobBank.sync_to_device"] = JobBank.sync_to_device
    _ORIGINALS["SharedEngine.eval_pairs"] = SharedEngine.eval_pairs
    _ORIGINALS["SharedEngine.train_micro_many"] = \
        SharedEngine.train_micro_many
    _ORIGINALS["SharedEngine.batched_accuracy"] = \
        SharedEngine.batched_accuracy

    orig_stack = JobBank.params_stack
    orig_compact = JobBank.compact
    orig_sync = JobBank.sync_to_device

    def params_stack(self):
        stack = orig_stack(self)
        _record_borrow(self, stack)
        return stack

    def compact(self):
        _verify_borrow(self)
        return orig_compact(self)

    def sync_to_device(self):
        _verify_borrow(self)
        return orig_sync(self)

    JobBank.params_stack = params_stack
    JobBank.compact = compact
    JobBank.sync_to_device = sync_to_device

    for name in ("eval_pairs", "train_micro_many", "batched_accuracy"):
        orig = _ORIGINALS[f"SharedEngine.{name}"]

        def wrapped(self, *args, _orig=orig, **kwargs):
            with _guard_transfers(self):
                return _orig(self, *args, **kwargs)
        wrapped.__name__ = name
        setattr(SharedEngine, name, wrapped)


def uninstall() -> None:
    """Restore the unpatched JobBank/SharedEngine methods."""
    if not _ORIGINALS:
        return
    from repro_torch.core.trainer import JobBank, SharedEngine
    for qual, fn in _ORIGINALS.items():
        cls_name, meth = qual.split(".")
        cls = {"JobBank": JobBank, "SharedEngine": SharedEngine}[cls_name]
        setattr(cls, meth, fn)
    _ORIGINALS.clear()


def installed() -> bool:
    return bool(_ORIGINALS)
