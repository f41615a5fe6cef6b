"""Group-retraining jobs: one shared student model per camera group,
trained on the group's aggregated stream data (knowledge-distilled from
the teacher's soft labels), ported from the JAX package's
`core/trainer.py`.

Training-plane layout, as in the reference: every job's train-state
lives in ONE stacked tree (`JobBank`: one tensor of shape (capacity,
...) per leaf, amortized-doubling capacity, swap-compaction on job
death), every job's data pool is a fixed-capacity dense ring buffer of
(seq,) token rows with per-row stream tags (`TokenRingPool`), and
`SharedEngine` serves the fleet: `batched_accuracy` scores every
(member, job) pair of the fleet in one forward per job and chunk,
`train_micro_many` runs one micro-window for a SET of jobs on their
bank rows. `RetrainJob` stays the thin duck-typed handle the
allocator/grouper drive; the fleet calls are bit-identical to its scalar
loop (tests/test_torch_trainer.py), so they change dispatch cost, never
decisions.

Where the port differs from the reference, and why:
  * `train_micro_many` trains each job's bank row IN PLACE with the
    one-job step (`train_steps` on views of the resident stack,
    `train/optimizer.py`), one job after another. The reference's
    vmapped multi-job call has no faithful batched form here: a batched
    GEMM rounds differently from the one-job step, and the
    batched-equals-scalar contract pins the one-job numbers. Its
    grouping by shape, `batch_min_jobs` threshold and padded lanes
    would therefore only re-dispatch the same step, and are left out.
  * A state whose leaves already lie on the bank's device is written on
    the device (`JobBank.write`); only host values go through the host
    mirror. An olmo-1b row is 14.12 GB, and the reference's round trip
    through the mirror at every `alloc` would buy nothing. The mirror is
    allocated at its first use.
  * Eval forwards run under `torch.no_grad()` on the default kernel
    route (on the card, the `flash_attention` kernel); the train forward
    takes the autograd route (`train/train_step.py`).
  * Under a fleet mesh (`mesh=`, `place_on`) the resident stack is one
    tensor per row block (`distributed.sharding.BlockRows`), block b on
    the mesh's b-th device, capacity aligned to the mesh size. Each job
    trains and evaluates on its own block's device; rows never change
    value with the placement, so decisions stay bit-identical.
  * `read_template` / `state_template` return `meta` tensors: a
    checkpoint restore needs only the shapes, dtypes and structure, and
    the port's mirror is not allocated until its first use.

Residency: by default (`resident=True`) the stacked leaves live on the
engine's device, with a per-slot host/device validity bitmap
(`_host_ok`, `_dev_ok`). Batched entry points compact the bank and flush
host-dirty rows in one indexed copy before they capture any slot index;
host reads (`job.state`) sync lazily, one row at a time, into the host
mirror. `JobBank.stats` counts every host<->device crossing of bank
state; `resident=False` keeps the host-resident layout, and both modes
are bit-identical.
"""
from __future__ import annotations

import weakref
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.core.batching import job_precision
from repro_torch.core.grouping import Request
from repro_torch.distributed.sharding import BlockRows, block_devices
from repro_torch.launch.mesh import on_device
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.model import build_model
from repro_torch.models.param import tree_map
from repro_torch.train.optimizer import init_opt_state
from repro_torch.train.train_step import init_state, make_train_step

F32 = torch.float32


class _JobCounter:
    """Monotonic job-id source, rewindable to a snapshot. Elastic
    recovery re-runs an aborted window from its start; jobs created in
    the aborted attempt must reuse the SAME ids on the re-run (gains,
    groups, and golden traces key on job_id), so the counter position
    is part of the controller's window snapshot — `itertools.count`
    can't rewind."""

    def __init__(self):
        self.n = 0

    def __next__(self) -> int:
        v = self.n
        self.n += 1
        return v


_job_counter = _JobCounter()

# decision-plane precision policy: eval/screen dtype per job. Training
# compute is governed separately by TrainConfig.compute_dtype (bf16
# compute over fp32 master rows for every job); the per-job `precision`
# selects which dtype SCORES the job in the decision plane.
PRECISIONS = ("fp32", "bf16")
_PRECISION_DTYPE = {"fp32": torch.float32, "bf16": torch.bfloat16}


class TokenRingPool:
    """Fixed-capacity dense ring buffer of (seq,) token rows, each row
    tagged with the stream that contributed it.

    `rows()` is the oldest->newest dense array `train_micro` samples
    batches from, eviction is by total pooled ROWS (a real token
    budget), and the per-row stream tag lets camera churn purge a
    departed stream's rows (`purge`). A copy of the reference's, bit for
    bit.
    """

    def __init__(self, capacity_rows: int = 512):
        if capacity_rows <= 0:
            raise ValueError("capacity_rows must be positive")
        self.capacity = int(capacity_rows)
        self._rows: Optional[np.ndarray] = None    # (capacity, seq)
        self._src = np.empty(self.capacity, object)  # stream tag per row
        self._start = 0                            # oldest row position
        self._count = 0

    def __len__(self) -> int:
        return self._count

    @property
    def seq(self) -> Optional[int]:
        return None if self._rows is None else self._rows.shape[1]

    def _order(self) -> np.ndarray:
        """Physical indices of the live rows, oldest -> newest."""
        return (self._start + np.arange(self._count)) % self.capacity

    def add(self, tokens, stream_id: Optional[str] = None):
        arr = np.asarray(tokens)
        rows = arr.reshape(-1, arr.shape[-1])
        if self._rows is None:
            self._rows = np.zeros((self.capacity, rows.shape[1]), arr.dtype)
        if rows.shape[1] != self._rows.shape[1]:
            raise ValueError(
                f"pool rows are (seq={self._rows.shape[1]},); got "
                f"seq={rows.shape[1]}")
        n = rows.shape[0]
        if n >= self.capacity:
            # a single oversized entry: only its newest `capacity` rows
            # fit the budget
            self._rows[:] = rows[-self.capacity:]
            self._src[:] = stream_id
            self._start, self._count = 0, self.capacity
            return
        end = (self._start + self._count) % self.capacity
        idx = (end + np.arange(n)) % self.capacity
        self._rows[idx] = rows
        self._src[idx] = stream_id
        over = self._count + n - self.capacity
        if over > 0:                  # evict the oldest rows
            self._start = (self._start + over) % self.capacity
            self._count = self.capacity
        else:
            self._count += n

    def rows(self) -> np.ndarray:
        """All pooled rows as one dense (count, seq) array, oldest ->
        newest — what train batches are sampled from."""
        if self._rows is None or self._count == 0:
            return np.zeros((0, self.seq or 0), np.int64)
        return self._rows[self._order()]

    def sources(self) -> List[Optional[str]]:
        """Per-row stream tags, oldest -> newest (parallel to rows())."""
        if self._count == 0:
            return []
        return list(self._src[self._order()])

    def purge(self, stream_id: str):
        """Drop every row contributed by `stream_id`, preserving the
        relative order of the survivors."""
        if self._count == 0:
            return
        order = self._order()
        keep_mask = np.array([self._src[i] != stream_id for i in order])
        keep = order[keep_mask]
        kept_rows = self._rows[keep]           # fancy index: copies
        kept_src = self._src[keep]
        self._start = 0
        self._count = kept_rows.shape[0]
        self._rows[:self._count] = kept_rows
        self._src[:self._count] = kept_src


class _Slot:
    """Mutable bank position for one job. Swap-compaction retargets the
    moved survivor by rewriting `idx` in place; a freed-and-compacted
    slot has idx=None. `dead` marks slots queued for compaction."""
    __slots__ = ("idx", "dead")

    def __init__(self, idx: int):
        self.idx: Optional[int] = idx
        self.dead = False


class TransferStats:
    """Host<->device crossings of bank STATE (train-state rows; batch
    data is excluded — it originates on the host either way).

    One `sync` is one transfer event regardless of how many rows it
    carries, `bytes` is the payload that actually crossed, so "zero
    per-member round-trips" is directly checkable: the batched entry
    points must add 0 syncs once the fleet is resident.
    """
    __slots__ = ("h2d_syncs", "h2d_bytes", "d2h_syncs", "d2h_bytes")

    def __init__(self):
        self.reset()

    def reset(self):
        self.h2d_syncs = self.h2d_bytes = 0
        self.d2h_syncs = self.d2h_bytes = 0

    def h2d(self, nbytes: int):
        self.h2d_syncs += 1
        self.h2d_bytes += int(nbytes)

    def d2h(self, nbytes: int):
        self.d2h_syncs += 1
        self.d2h_bytes += int(nbytes)


# ---------------------------------------------------------------------------
# state trees: nested dicts (keys sorted, as JAX flattens them) and lists
# ---------------------------------------------------------------------------
def _skeleton(tree):
    if isinstance(tree, dict):
        return {k: _skeleton(tree[k]) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return [_skeleton(v) for v in tree]
    return None


def _flatten(tree) -> list:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flatten(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _flatten(v)]
    return [tree]


def _unflatten(skel, leaves):
    it = iter(leaves)

    def build(s):
        if isinstance(s, dict):
            return {k: build(v) for k, v in s.items()}
        if isinstance(s, list):
            return [build(v) for v in s]
        return next(it)
    return build(skel)


def _numpy_dtype(dtype: torch.dtype):
    try:
        # fleetlint: disable=host-sync -- a 0-element CPU tensor's numpy
        # dtype: no device, no transfer
        return torch.empty(0, dtype=dtype).numpy().dtype
    except TypeError as e:
        raise TypeError(f"a bank leaf of {dtype} has no numpy host "
                        f"mirror") from e


def _as_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        # fleetlint: disable=host-sync -- the host mirror's staging of a
        # tree written from off the bank's device (bank.write / scatter
        # in host mode), metered by their callers
        return x.detach().cpu().numpy()
    return np.asarray(x)


class JobBank:
    """All job train-states in ONE stacked tree.

    Leaves are tensors of shape (capacity, ...) on the engine's device:
    capacity grows by amortized doubling, job death swap-compacts the
    dead row with the last live one, and the fleet calls touch only the
    rows of their slots. Reads return independent copies — a bank row
    may be overwritten by compaction after the caller lets go of its job
    handle.

    Residency: with `resident=True` (the default) the authoritative
    stack lives on the device; a host numpy mirror (allocated at its
    first use) stages host reads and writes. Two per-slot bitmaps track
    which side is current (`_host_ok`, `_dev_ok`; at least one is set for
    every live row):

      * host writes (`write` with host values, i.e. `job.state = ...`)
        land in the mirror and mark the device row stale;
      * `sync_to_device()` — run by every batched entry point AFTER
        `compact()`, before slot indices are captured — flushes ALL
        host-dirty rows in one indexed copy;
      * device writes (`write` with values on the device, `scatter`, and
        in-place updates reported through `written_on_device`) mark the
        mirror stale; host reads (`read`, `read_params`) re-sync lazily,
        one row at a time.

    Rule for new call sites: capture `params_stack()` / `row_device()` /
    `params_row_device()` (device views, BORROWED) right before the fleet
    call and never cache them across a bank write/compaction, which may
    replace or move the rows. `gather` and `snapshot_params` return
    fresh tensors and are safe to hold.

    Under a fleet mesh (`place_on`) each resident leaf is a `BlockRows`:
    the slot axis in equal contiguous blocks, one per mesh device, with
    capacity aligned to the mesh size so churn never re-pads the blocks.
    Growth, compaction and re-meshing copy rows device to device.
    """

    def __init__(self, engine: "SharedEngine", capacity: int = 4,
                 resident: Optional[bool] = None, mesh=None):
        self.engine = engine
        self.device = engine.device
        self._cap = int(capacity)
        self.resident = True if resident is None else bool(resident)
        self._skel = None            # the state tree's structure
        self._shapes: List[tuple] = []   # per leaf: (row shape, dtype)
        self._host: Optional[List[np.ndarray]] = None   # mirror leaves
        self._dev: Optional[List[torch.Tensor]] = None  # resident leaves
        self._params_at: List[int] = []   # leaf positions under "params"
        self._slots: List[_Slot] = []
        self._dead: List[_Slot] = []
        self._host_ok = np.zeros(self._cap, bool)
        self._dev_ok = np.zeros(self._cap, bool)
        # params-content version: bumped by every write/scatter/move so
        # the cached compute-precision stack (params_stack_compute)
        # knows when its cast is stale — ONE cast per flush, not one
        # per eval call
        self._version = 0
        self._compute_cache = None
        self.stats = TransferStats()
        self.state_row_nbytes = 0    # one slot's full train-state
        self.params_row_nbytes = 0   # one slot's params subtree
        self.mesh = None
        if mesh is not None:
            self.place_on(mesh)

    def place_on(self, mesh):
        """(Re)place the resident stack under a fleet mesh: slots
        block-sharded along the job axis, capacity aligned to the mesh
        size so the blocks stay equal. Also the elastic re-mesh path: the
        rows move device to device into the NEW mesh's blocks. mesh=None
        detaches (one tensor per leaf on the engine's device). Values
        never change, so decisions stay bit-identical."""
        self.mesh = mesh
        new_cap = self._align(self._cap)
        if new_cap > self._cap:
            self._pad_capacity(new_cap)     # lays the stack out anew
        elif self._dev is not None:
            self._dev = [self._restack(x, self._cap) for x in self._dev]
            self._version += 1

    def _layout(self) -> Optional[List[torch.device]]:
        """The device of each slot block, or None for one tensor a leaf."""
        if self.mesh is None or not self.resident:
            return None
        return block_devices(self.mesh)

    def _align(self, n: int) -> int:
        """Round capacity up to a multiple of the mesh's block count so the
        slot axis splits into equal blocks (RowRegistry.align's rule)."""
        if self.mesh is None:
            return n
        d = len(block_devices(self.mesh))
        return -(-n // d) * d

    def _restack(self, x, rows: int):
        """Leaf `x` (a tensor or BlockRows) with `rows` slots in the current
        layout, its first rows kept (device to device)."""
        devs = self._layout()
        if devs is None:
            if isinstance(x, BlockRows):
                x = x.flat(self.device)
            pad = rows - x.shape[0]
            if pad <= 0:
                return x
            return torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])
        if not isinstance(x, BlockRows):
            x = BlockRows([x])
        if x.shape[0] == rows and x.devices == devs:
            return x
        return x.resized(rows, devs)

    def slot_device(self, idx: int) -> torch.device:
        """Where slot `idx`'s resident row lives (its block's device)."""
        if self._dev is not None and isinstance(self._dev[0], BlockRows):
            return self._dev[0].device_of(idx)
        return self.device

    def invalidate_device(self):
        """Simulate accelerator-memory loss (the elastic failure model: the
        device stack is gone, the host control plane survives). Every
        device row is marked stale AND zeroed, so a recovery path that
        forgets to restore a job reads zeros instead of silently reusing
        lost values. Restore writes each job through `write`; the next
        batched entry point flushes the fleet in one indexed copy."""
        self._dev_ok[:] = False
        self._version += 1
        if self._dev is not None:
            with torch.no_grad():
                for x in self._dev:
                    x.zero_()

    def __len__(self) -> int:
        """Live slots, including dead-but-not-yet-compacted ones."""
        return len(self._slots)

    @property
    def capacity(self) -> int:
        return self._cap

    def _init_stack(self, template):
        self._skel = _skeleton(template)
        leaves = _flatten(template)
        self._shapes = [(tuple(x.shape),
                         x.dtype if isinstance(x, torch.Tensor)
                         else torch.from_numpy(np.asarray(x)).dtype)
                        for x in leaves]
        nbytes = [int(np.prod(s, dtype=np.int64)) * d.itemsize
                  for s, d in self._shapes]
        self.state_row_nbytes = sum(nbytes)
        if isinstance(template, dict) and "params" in template:
            n_before = sum(len(_flatten(template[k]))
                           for k in sorted(template) if k < "params")
            n = len(_flatten(template["params"]))
            self._params_at = list(range(n_before, n_before + n))
            self.params_row_nbytes = sum(nbytes[i] for i in self._params_at)
        if self.resident:
            devs = self._layout()
            self._dev = [torch.zeros((self._cap,) + s, dtype=d,
                                     device=self.device) if devs is None
                         else BlockRows.zeros(self._cap, s, d, devs)
                         for s, d in self._shapes]

    def _host_stack(self) -> List[np.ndarray]:
        """The host mirror, allocated at its first use."""
        if self._host is None:
            self._host = [np.zeros((self._cap,) + s, _numpy_dtype(d))
                          for s, d in self._shapes]
        return self._host

    def _grow_to(self, need: int):
        """Amortized doubling: allocating the Nth job is O(state), not
        O(N * state). Under a mesh, capacity rounds up to a multiple of
        the block count."""
        if need <= self._cap:
            return
        self._pad_capacity(self._align(max(need, 2 * self._cap)))

    def _pad_capacity(self, new_cap: int):
        """Pad every stacked array (host mirror, resident stack,
        validity bitmaps) to exactly `new_cap` slots."""
        pad = new_cap - self._cap
        if pad <= 0:
            return
        if self._host is not None:
            self._host = [np.concatenate(
                [x, np.zeros((pad,) + x.shape[1:], x.dtype)])
                for x in self._host]
        if self._dev is not None:
            self._dev = [self._restack(x, new_cap) for x in self._dev]
        # fleetlint: disable=rows-discipline -- JobBank IS the training
        # plane's row registry (amortized doubling + swap-compaction);
        # the validity bitmaps grow in lockstep with its stack
        self._host_ok = np.concatenate(
            [self._host_ok, np.zeros(pad, bool)])
        # fleetlint: disable=rows-discipline -- as above: bank-owned
        # bitmap, grown under the bank's own doubling discipline
        self._dev_ok = np.concatenate(
            [self._dev_ok, np.zeros(pad, bool)])
        self._cap = new_cap
        self._version += 1      # leaf shapes changed under the cache

    def _state_leaves(self, state) -> List:
        if _skeleton(state) != self._skel:
            raise ValueError(
                f"state tree mismatch: bank holds {self._skel}, got "
                f"{_skeleton(state)}")
        return _flatten(state)

    def alloc(self, state) -> _Slot:
        self.compact()
        if self._skel is None:
            self._init_stack(state)
        self._grow_to(len(self._slots) + 1)
        slot = _Slot(len(self._slots))
        self._slots.append(slot)
        self.write(slot.idx, state)
        return slot

    def free(self, slot: _Slot):
        """QUEUE the slot for reclamation; rows do not move here.

        free() runs from GC finalizers, i.e. at arbitrary allocation
        points. Batched callers capture slot indices right before a
        fleet call, so moving rows here would silently evaluate/train
        the wrong job. Actual swap-compaction happens in compact(),
        which every allocating or batched entry point runs FIRST —
        before any index is captured. Idempotent."""
        if slot.idx is None or slot.dead:
            return
        slot.dead = True
        self._dead.append(slot)

    def compact(self):
        """Swap-with-last removal of every queued-dead slot, keeping
        live rows dense (capacity is retained; rows beyond len(self)
        are garbage). Moves both the host mirror row and — when it is
        current — the resident device row, carrying the validity bits
        with them; the vacated tail row's bits are cleared. Device moves
        are DEFERRED and applied as one indexed copy per leaf, whose
        gather reads the pre-move stack, so swap chains (a survivor moved
        into a hole later becoming the move source of another hole) are
        resolved host-side to original row indices."""
        if self._dead:
            self._version += 1      # row moves remap slot -> contents
        dev_moves: Dict[int, int] = {}     # dst row -> ORIGINAL src row
        src_of: Dict[int, int] = {}        # current row -> original row
        while self._dead:
            slot = self._dead.pop()
            idx = slot.idx
            last = len(self._slots) - 1
            if idx != last:
                moved = self._slots[last]
                # a stale mirror row is garbage by definition — only
                # copy host bytes when the mirror is authoritative
                if self._host_ok[last]:
                    for x in self._host:
                        x[idx] = x[last]
                self._host_ok[idx] = bool(self._host_ok[last])
                if self._dev is not None:
                    if self._dev_ok[last]:
                        orig = src_of.pop(last, last)
                        dev_moves[idx] = orig
                        src_of[idx] = orig
                    else:
                        # idx now holds a host-authoritative row; any
                        # earlier device move into it is moot
                        dev_moves.pop(idx, None)
                        src_of.pop(idx, None)
                    self._dev_ok[idx] = bool(self._dev_ok[last])
                moved.idx = idx
                self._slots[idx] = moved
            self._slots.pop()
            self._host_ok[last] = False
            self._dev_ok[last] = False
            dev_moves.pop(last, None)      # fell off the live range
            src_of.pop(last, None)
            slot.idx = None
        if dev_moves:
            dst = torch.tensor(list(dev_moves.keys()), device=self.device)
            src = torch.tensor(list(dev_moves.values()), device=self.device)
            for x in self._dev:
                x[dst] = x[src]

    @staticmethod
    def _check_idx(idx):
        """A freed-and-compacted slot has idx=None; indexing with None
        would broadcast a write across the WHOLE bank (silent fleet-wide
        corruption) — fail loudly instead."""
        if idx is None:
            raise ValueError("use-after-release: job's bank slot was freed")
        return idx

    # -- residency sync protocol -------------------------------------------
    def sync_to_device(self):
        """Flush every host-dirty row into the resident stack as ONE
        indexed copy per leaf (one h2d sync, not one per row). Every
        batched entry point runs this after compact(), before capturing
        slot indices; no-op in host mode or when nothing is dirty."""
        if not self.resident or self._host is None:
            return
        live = len(self._slots)
        dirty = np.flatnonzero(self._host_ok[:live] & ~self._dev_ok[:live])
        if dirty.size == 0:
            return
        sel = torch.from_numpy(dirty).to(self.device)
        for dst, src in zip(self._dev, self._host):
            rows = torch.from_numpy(src[dirty])
            # a block stack copies each row straight to its block's device
            dst[sel] = rows if isinstance(dst, BlockRows) \
                else rows.to(self.device)
        self._dev_ok[dirty] = True
        self.stats.h2d(int(dirty.size) * self.state_row_nbytes)

    def _sync_row_to_host(self, idx: int):
        """Lazy d2h: pull the device row into the host mirror only when
        the mirror is stale. Repeat reads are free."""
        if self._host_ok[idx]:
            return
        for dst, src in zip(self._host_stack(), self._dev):
            # fleetlint: disable=host-sync -- this IS the residency rule's
            # lazy mirror d2h: one row, only when the mirror is stale,
            # metered via stats.d2h below
            dst[idx] = src[idx].cpu().numpy()
        self._host_ok[idx] = True
        self.stats.d2h(self.state_row_nbytes)

    # -- host-side reads/writes (checkpoints, model zoo, job.state) --------
    def read(self, idx: int):
        """Slot `idx`'s state as an independent host tree of numpy arrays
        (lazily synced from the device when stale)."""
        self._check_idx(idx)
        self._sync_row_to_host(idx)
        return _unflatten(self._skel, [np.array(x[idx]) for x in self._host])

    def read_params(self, idx: int):
        """Params-only host copy of slot `idx` — the eval hot path
        doesn't pay for copying the Adam moments (~2x params)."""
        self._check_idx(idx)
        self._sync_row_to_host(idx)
        return _unflatten(self._skel["params"],
                          [np.array(self._host[i][idx])
                           for i in self._params_at])

    def read_template(self, idx: int):
        """Slot `idx`'s state as a shape / dtype / structure TEMPLATE of
        `meta` tensors: no values, no sync, no host memory. For structure
        consumers (a checkpoint restore's target) that would otherwise pay
        a full-row copy to throw the numbers away."""
        self._check_idx(idx)
        return _unflatten(self._skel, [torch.empty(s, dtype=d, device="meta")
                                       for s, d in self._shapes])

    def write(self, idx: int, state):
        """Write slot `idx`'s state. On a resident bank a state whose
        leaves all lie on the bank's device is copied into the device row
        (the mirror goes stale); any other state lands in the host mirror
        and marks the device row stale, and the next batched entry
        point's sync_to_device() carries it across in the shared
        flush."""
        self._check_idx(idx)
        leaves = self._state_leaves(state)
        if self.resident and all(isinstance(x, torch.Tensor)
                                 and x.device == self.device
                                 for x in leaves):
            with torch.no_grad():
                for dst, src in zip(self._dev, leaves):
                    dst[idx].copy_(src)
            self.written_on_device([idx])
            return
        for dst, src in zip(self._host_stack(), leaves):
            dst[idx] = _as_numpy(src)
        self._host_ok[idx] = True
        self._dev_ok[idx] = False
        self._version += 1

    # -- device-side access ------------------------------------------------
    def row_device(self, idx: int):
        """Slot `idx`'s full state as views of the resident stack (synced
        first; zero host transfer) — the scalar train path updates it in
        place and then reports it through `written_on_device`. BORROWED:
        valid until the next bank write/compaction."""
        self._check_idx(idx)
        self.sync_to_device()
        return _unflatten(self._skel, [x[idx] for x in self._dev])

    def params_row_device(self, idx: int):
        """Params subtree of slot `idx` as views of the resident stack —
        the scalar eval path's zero-transfer read. BORROWED."""
        self._check_idx(idx)
        self.sync_to_device()
        return _unflatten(self._skel["params"],
                          [self._dev[i][idx] for i in self._params_at])

    def written_on_device(self, idxs: Sequence[int]):
        """Record device-side writes of rows `idxs` (in-place training,
        device-row writes): the mirror rows go stale."""
        sel = np.asarray(idxs, np.int64)
        self._dev_ok[sel] = True
        self._host_ok[sel] = False
        self._version += 1

    # -- batched access ----------------------------------------------------
    def gather(self, idxs: Sequence[int]):
        """Stacked device states for the selected slots (leaves (k, ...),
        fresh tensors). Resident mode copies rows of the device stack
        (zero host transfer after the shared flush); host mode pays one
        h2d of the k rows. `scatter` writes such rows back."""
        sel = np.asarray(idxs, np.int64)
        if self.resident:
            self.sync_to_device()
            dsel = torch.from_numpy(sel).to(self.device)
            return _unflatten(self._skel, [x[dsel] for x in self._dev])
        self.stats.h2d(int(sel.size) * self.state_row_nbytes)
        return _unflatten(self._skel, [torch.from_numpy(x[sel]).to(
            self.device) for x in self._host_stack()])

    def scatter(self, idxs: Sequence[int], states):
        """Write stacked states (leaves (k, ...)) back into rows `idxs`.
        Resident mode copies on the device and marks the host mirror
        stale (zero host transfer); host mode pays one d2h of the k
        rows."""
        sel = np.asarray(idxs, np.int64)
        if sel.size == 0:
            return
        leaves = self._state_leaves(states)
        if self.resident:
            dsel = torch.from_numpy(sel).to(self.device)
            with torch.no_grad():
                for dst, src in zip(self._dev, leaves):
                    dst[dsel] = src
            self.written_on_device(sel)
            return
        for dst, src in zip(self._host_stack(), leaves):
            dst[sel] = _as_numpy(src)
        self.stats.d2h(int(sel.size) * self.state_row_nbytes)
        self._version += 1

    def snapshot_params(self, idx: int):
        """An independent device copy of slot `idx`'s params subtree —
        unlike `params_stack()` (borrowed) this survives later bank
        writes/compaction, so long-lived consumers (the serve plane's
        swap gate) may keep it. Resident mode copies on the device (zero
        host crossing); host mode pays the one params-row h2d its layout
        implies."""
        self._check_idx(idx)
        if self.resident:
            self.sync_to_device()
            return _unflatten(self._skel["params"],
                              [self._dev[i][idx].to(self.device, copy=True)
                               for i in self._params_at])
        self.stats.h2d(self.params_row_nbytes)
        return _unflatten(self._skel["params"],
                          [torch.from_numpy(self._host[i][idx].copy()).to(
                              self.device) for i in self._params_at])

    def params_stack(self):
        """The stacked params subtree (leaves (capacity, ...)) —
        `batched_accuracy`'s params_stack argument. Resident mode
        returns the DEVICE leaves (synced first), host mode the mirror's
        numpy leaves. BORROWED: valid only until the next bank
        write/scatter/compaction, so capture it right before the fleet
        call — the engine entry points already do."""
        if self._skel is None:
            return None
        if self.resident:
            self.sync_to_device()
            return _unflatten(self._skel["params"],
                              [self._dev[i] for i in self._params_at])
        host = self._host_stack()
        return _unflatten(self._skel["params"],
                          [host[i] for i in self._params_at])

    def params_stack_compute(self, dtype):
        """The stacked params CAST to compute dtype `dtype` — the
        precision policy's "one cast at flush" contract: fp32 master rows
        stay the authoritative stack; the bf16 compute stack is cast ONCE
        per bank version (writes/scatters/compaction bump `_version`) and
        cached, so a window's many bf16 eval calls share one cast. fp32
        requests return the master stack itself (borrowed, as
        params_stack). A host-resident bank returns its fp32 mirror:
        numpy has no bf16, and the eval forward casts each job's row as
        it crosses (the same values)."""
        if dtype == torch.float32 or not self.resident:
            return self.params_stack()
        base = self.params_stack()
        if base is None:
            return None
        key = (dtype, self._version)
        if self._compute_cache is not None \
                and self._compute_cache[0] == key:
            return self._compute_cache[1]
        stack = tree_map(lambda x: x.to(dtype) if x.is_floating_point()
                         else x, base)
        self._compute_cache = (key, stack)
        return stack


def _hit_mean(count: np.ndarray, n: int) -> np.ndarray:
    """Mean accuracy from fp32 hit counts over `n` positions, rounded as
    the reference's `jnp.mean` rounds it: XLA multiplies the sum by the
    fp32 reciprocal of n. The counts are exact integers in fp32 (below
    2^24 positions), so equal hits give equal accuracies bit for bit;
    `count / n` would differ in the last bit in about half the cases."""
    return (np.asarray(count, np.float32)
            * (np.float32(1.0) / np.float32(n))).astype(np.float32)


class SharedEngine:
    """Train/eval entry points shared by every job of a fleet.

    Scalar paths (`accuracy`, `train_steps`) serve single jobs; the
    batched ones (`batched_accuracy`, `eval_pairs`, `eval_jobs`,
    `train_micro_many`) serve the whole fleet per call and are
    bit-identical to looping the scalar path. `batched=False` disables
    the batched eval dispatch (the duck-typed probe in
    repro_torch.core.batching reports the engine as not batch-capable),
    which the parity tests use as the reference scalar twin.
    `resident=False` keeps the JobBank host-resident. `device` is where
    the bank and the forwards live ("cuda" unless the caller asks for
    the CPU). The reference's `batch_min_jobs` is not taken: every job
    trains on the one-job step (see the module docstring).

    `init_params` ({seed: tree of numpy arrays}) makes `fresh_state(seed)`
    return those parameters, with zero AdamW moments, and raise for any
    other seed: `jax.random` and `torch.Generator` draw different weights
    from one seed, so a run held to the reference's (the golden traces)
    starts from the reference's own initialisation. Without it,
    `fresh_state` draws the port's torch initialisation.
    """

    def __init__(self, cfg: ModelConfig, tcfg: Optional[TrainConfig] = None,
                 *, distill_weight: float = 1.0, batched: bool = True,
                 eval_chunk: int = 128, resident: Optional[bool] = None,
                 mesh=None, device="cuda", init_params=None):
        self.device = resolve_device(device)
        if self.device.type == "cuda" and self.device.index is None:
            # the card's index, so that the bank knows a state whose
            # tensors lie on "cuda:0" for one already on its device
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.cfg = cfg
        self.model = build_model(cfg)
        # b2=0.999 + no decay: the small-batch streaming regime needs the
        # long second-moment horizon (the reference's calibration)
        self.tcfg = tcfg or TrainConfig(learning_rate=1e-3, b2=0.999,
                                        weight_decay=0.0, warmup_steps=5,
                                        total_steps=100000, remat="none")
        self._distill_weight = distill_weight
        self._train = make_train_step(self.model, self.tcfg,
                                      distill_weight=distill_weight)
        self.batched = bool(batched)
        self.eval_chunk = int(eval_chunk)
        self.bank = JobBank(self, resident=resident, mesh=mesh)
        self._init_params = (None if init_params is None
                             else {int(k): v for k, v in init_params.items()})

    def fresh_state(self, seed: int = 0):
        if self._init_params is None:
            return init_state(self.model, seed, self.tcfg,
                              device=self.device)
        if seed not in self._init_params:
            raise KeyError(
                f"this engine was given initial parameters for seeds "
                f"{sorted(self._init_params)} only; fresh_state({seed})")
        dtype = getattr(torch, self.tcfg.param_dtype)
        params = tree_map(lambda x: x.to(dtype), params_from_numpy(
            self._init_params[seed], device=self.device))
        return {"params": params, "opt": init_opt_state(params)}

    def train_steps(self, state, batches):
        """Train `state` in place on each batch in order. Returns (state,
        [metrics per step])."""
        mets = []
        for b in batches:
            state, m = self._train(state, b)
            mets.append(m)
        return state, mets

    def _tokens(self, tokens, device=None) -> torch.Tensor:
        return torch.as_tensor(np.asarray(tokens),
                               device=self.device if device is None
                               else device)

    def _params_device(self, params) -> torch.device:
        """The device of a params tree (a mesh block's, for a bank row)."""
        leaf = _flatten(params)[0]
        return leaf.device if isinstance(leaf, torch.Tensor) else self.device

    @torch.no_grad()
    def _forward_hits(self, params, toks, precision: str):
        """(rows, S-1) fp32 next-token hits of a forward at the eval
        precision: params cast to its dtype (a no-op on the bank's
        cast-at-flush compute stack), argmax in fp32."""
        cd = _PRECISION_DTYPE[precision]
        if cd != F32:
            params = tree_map(lambda x: x.to(cd) if x.is_floating_point()
                              else x, params)
        logits, _ = self.model.apply(params, toks, compute_dtype=cd)
        pred = torch.argmax(logits[:, :-1].to(F32), dim=-1)
        return (pred == toks[:, 1:]).to(F32)

    def accuracy(self, params, tokens, *, precision: str = "fp32") -> float:
        """Top-1 next-token accuracy — the mAP analogue. `precision`
        picks the decision-plane eval dtype."""
        dev = self._params_device(params)
        with on_device(dev):
            hits = self._forward_hits(params, self._tokens(tokens, dev),
                                      precision)
        # fleetlint: disable=host-sync -- the scalar decision API
        # returns a host float by contract; batched callers use
        # batched_accuracy, whose results cross once per chunk
        count = hits.sum().cpu().numpy()
        return float(_hit_mean(count, hits.numel()))

    # -- batched eval plane -------------------------------------------------
    def batched_accuracy(self, params_stack, tokens, job_ids, *,
                         precision: str = "fp32") -> np.ndarray:
        """Score every (tokens[i], params_stack[job_ids[i]]) pair of the
        fleet, each accuracy equal to calling `accuracy` per pair.

        tokens is (P, B, S) — pair i's eval batch; job_ids (P,) indexes
        the stacked params (JobBank slots). Pairs are grouped by job and
        each job's member batches are FLATTENED into the example axis of
        one forward per chunk of ~eval_chunk rows: the job's params are
        read once per chunk instead of once per member and the GEMMs see
        M*B rows instead of B. Member counts pad to a multiple of 8, as
        in the reference; padded lanes are discarded.
        """
        toks = np.asarray(tokens)
        ids = np.asarray(job_ids, np.int64)
        out = np.empty(ids.shape[0], np.float32)
        if ids.shape[0] == 0:
            return out
        if toks.ndim != 3:
            raise ValueError(f"tokens must be (P, B, S); got {toks.shape}")
        b = toks.shape[1]
        groups: Dict[int, List[int]] = {}
        for i, j in enumerate(ids):
            groups.setdefault(int(j), []).append(i)
        m_chunk = max(1, self.eval_chunk // b)     # members per flat call
        # a resident stack is sliced per job ON DEVICE (zero transfer);
        # host leaves pay one params-row h2d per job
        host_stack = any(isinstance(x, np.ndarray)
                         for x in _flatten(params_stack))
        for jid, members in groups.items():
            if host_stack:
                params = tree_map(lambda x: torch.from_numpy(
                    x[jid].copy()).to(self.device), params_stack)
                self.bank.stats.h2d(self.bank.params_row_nbytes)
            else:
                params = tree_map(lambda x: x[jid], params_stack)
            dev = self._params_device(params)   # the job's block's device
            for lo in range(0, len(members), m_chunk):
                sel = members[lo:lo + m_chunk]
                m = len(sel)
                m_pad = min(m_chunk, -(-m // 8) * 8)
                tk = np.zeros((m_pad * b,) + toks.shape[2:], toks.dtype)
                tk[:m * b] = toks[sel].reshape(m * b, -1)
                with on_device(dev):
                    hits = self._forward_hits(params, self._tokens(tk, dev),
                                              precision)
                count = hits.reshape(m_pad, b, -1).sum(dim=(1, 2))
                # fleetlint: disable=host-sync -- one (m,) result crossing
                # per (job, chunk), the batched API's host return
                out[sel] = _hit_mean(count[:m].cpu().numpy(),
                                     hits.shape[0] // m_pad * hits.shape[1])
        return out

    def _bank_slot(self, job) -> Optional[int]:
        """The job's live slot index in THIS engine's bank, else None
        (foreign engines, duck-typed fakes, freed/dying slots)."""
        slot = getattr(job, "_slot", None)
        if (getattr(job, "engine", None) is self and slot is not None
                and slot.idx is not None and not slot.dead):
            return slot.idx
        return None

    def _bank_backed(self, jobs) -> bool:
        return (self.batched and len(self.bank) > 0
                and all(self._bank_slot(j) is not None for j in jobs))

    def _eval_slot(self, idx, samples, *, precision: str = "fp32") -> float:
        """Scalar eval of one bank slot. Resident mode reads the job's
        params as views of the resident stack (zero host transfer); the
        host-resident bank copies the row out and pays the params h2d."""
        if self.bank.resident:
            return self.accuracy(self.bank.params_row_device(idx), samples,
                                 precision=precision)
        params = tree_map(lambda x: torch.from_numpy(x).to(self.device),
                          self.bank.read_params(idx))
        self.bank.stats.h2d(self.bank.params_row_nbytes)
        return self.accuracy(params, samples, precision=precision)

    def eval_pairs(self, pairs, *,
                   precision: Optional[str] = None) -> List[float]:
        """pairs: [(job, samples)]. Returns per-pair accuracies, equal to
        [job.eval_on(s) for job, s in pairs], with each distinct sample
        shape dispatched as one batched call. `precision` overrides
        every pair's own screen dtype; None keeps each job's
        decision-plane precision."""
        if not pairs:
            return []
        self.bank.compact()     # BEFORE capturing any slot index
        if not self._bank_backed([j for j, _ in pairs]):
            if precision is None:
                # fleetlint: disable=per-member-loop -- the documented
                # scalar fallback for probe-rejected jobs (duck-typed
                # fakes, foreign engines); bit-identical by contract
                return [job.eval_on(s) for job, s in pairs]
            # fleetlint: disable=per-member-loop -- scalar fallback, as
            # above, with the override forwarded
            return [job.eval_on(s, precision=precision)
                    for job, s in pairs]
        out: List[float] = [0.0] * len(pairs)
        arrs = [np.asarray(s) for _, s in pairs]
        # pairs group by (shape, decision precision), in order of first
        # appearance; bf16 jobs are scored against the bank's
        # cast-at-flush compute stack
        by_key: Dict[tuple, List[int]] = {}
        for i, a in enumerate(arrs):
            prec = precision or job_precision(pairs[i][0])
            by_key.setdefault((a.shape, prec), []).append(i)
        stacks = {"fp32": self.bank.params_stack()}
        for (_shape, prec), idxs in by_key.items():
            stack = stacks.get(prec)
            if stack is None:
                stack = self.bank.params_stack_compute(
                    _PRECISION_DTYPE[prec])
                stacks[prec] = stack
            toks = np.stack([arrs[i] for i in idxs])
            jids = np.array([pairs[i][0]._slot.idx for i in idxs])
            for i, a in zip(idxs, self.batched_accuracy(
                    stack, toks, jids, precision=prec)):
                out[i] = float(a)
        return out

    def eval_jobs(self, jobs, *,
                  precision: Optional[str] = None) -> List[float]:
        """Batched RetrainJob.eval: every (member, job) subsample pair
        of `jobs` scored in one fleet call, then averaged per job with
        the same float64 np.mean the scalar path uses."""
        pairs, spans = [], []
        for j in jobs:
            ms = list(j.members)
            spans.append(len(ms))
            pairs.extend((j, m.subsamples) for m in ms)
        accs = self.eval_pairs(pairs, precision=precision)
        out, k = [], 0
        for n in spans:
            out.append(float(np.mean(accs[k:k + n])) if n else 0.0)
            k += n
        return out

    # -- train plane --------------------------------------------------------
    def _train_job_scalar(self, job, toks):
        """The per-job micro-window, with the batches pre-drawn. A
        bank-backed job on a resident bank trains its row in place on
        the device (zero host round-trip); duck-typed foreign jobs and
        the host-resident bank go through `job.state`, whose whole state
        crosses the boundary twice per micro-window."""
        idx = self._bank_slot(job)
        if idx is not None and self.bank.resident:
            dev = self.bank.slot_device(idx)    # the row's block's device
            t = self._tokens(toks, dev)
            batches = [{"inputs": x, "labels": x} for x in t]
            with on_device(dev):
                _, mets = self.train_steps(self.bank.row_device(idx),
                                           batches)
            self.bank.written_on_device([idx])
            return _stack_steps(mets)
        t = self._tokens(toks)
        batches = [{"inputs": x, "labels": x} for x in t]
        if idx is not None:
            self.bank.stats.h2d(self.bank.state_row_nbytes)
            self.bank.stats.d2h(self.bank.state_row_nbytes)
        state = tree_map(lambda x: torch.as_tensor(x).to(self.device),
                         job.state)
        state, mets = self.train_steps(state, batches)
        job.state = state
        return _stack_steps(mets)

    def train_micro_many(self, jobs) -> Dict[str, Dict[str, torch.Tensor]]:
        """One micro-window for each job in `jobs`, equal bit for bit to
        calling job.train_micro() per job.

        Batches are drawn on the host with each job's OWN rng in the
        order the scalar loop draws them, and each job trains its row in
        place (`_train_job_scalar`). Returns {job_id: metrics}, each
        metric a (micro_steps,) tensor on the device (no host sync); jobs
        with an empty pool are absent.
        """
        self.bank.compact()     # BEFORE capturing any slot index
        out: Dict[str, Dict[str, torch.Tensor]] = {}
        for job in jobs:
            data = job.pool.rows()
            if data.shape[0] == 0:
                continue                       # train_micro no-ops
            k = min(job.batch, data.shape[0])
            toks = np.stack(
                [data[job.rng.integers(0, data.shape[0], size=k)]
                 for _ in range(job.micro_steps)])
            job.gpu_time += 1
            out[job.job_id] = self._train_job_scalar(job, toks)
        return out


def _stack_steps(mets: List[Dict[str, torch.Tensor]]):
    return {k: torch.stack([m[k] for m in mets]) for k in mets[0]}


class RetrainJob:
    """One group-retraining job (Alg. 1/2 unit): a thin handle over a
    JobBank slot (the train-state) plus host-side bookkeeping (members,
    token ring pool, rng). The duck-typed allocator/grouper interface
    is the reference's."""

    def __init__(self, engine: SharedEngine, first: Request, *,
                 micro_steps: int = 4, batch: int = 8, seed: int = 0,
                 init_state_tree=None, pool_rows: int = 512,
                 precision: str = "fp32"):
        if precision not in PRECISIONS:
            raise ValueError(
                f"precision must be one of {PRECISIONS}; got {precision!r}")
        self.job_id = f"job{next(_job_counter)}"
        self.engine = engine
        # decision-plane screen precision: bf16 jobs eval against the
        # bank's compute stack; near-threshold grouping decisions rescore
        # in fp32
        self.precision = precision
        self.members: List[Request] = []
        self.pool = TokenRingPool(pool_rows)
        self.micro_steps = micro_steps
        self.batch = batch
        self.rng = np.random.default_rng(seed)
        init = (init_state_tree if init_state_tree is not None
                else (first.model if first.model is not None
                      else engine.fresh_state(seed)))
        self._slot = engine.bank.alloc(init)
        # dying jobs return their bank slot as soon as the last handle
        # ref drops (mid-window death triggers swap-compaction)
        self._finalizer = weakref.finalize(self, engine.bank.free,
                                           self._slot)
        self.gpu_time = 0
        self.add_member(first)

    # -- bank-backed state --------------------------------------------------
    @property
    def state(self):
        """The job's {"params", "opt"} train-state, read from its bank
        slot as an independent host copy (safe to hold across
        compaction)."""
        return self.engine.bank.read(self._slot.idx)

    @state.setter
    def state(self, tree):
        self.engine.bank.write(self._slot.idx, tree)

    @property
    def state_template(self):
        """Shape / dtype / structure template of the train-state (`meta`
        tensors, no sync): the target a checkpoint restore loads into."""
        return self.engine.bank.read_template(self._slot.idx)

    def release(self):
        """Return the bank slot (idempotent). Runs automatically when
        the handle is garbage-collected."""
        self._finalizer()

    def serving_snapshot(self):
        """An independent device copy of the job's CURRENT params, safe to
        hold across future bank writes/compaction — what the serve
        plane's validation gate scores and, on acceptance, installs as
        the group's serving row. Compacts FIRST (a queued-dead slot must
        not shift this row after the index is captured), then copies the
        synced row."""
        bank = self.engine.bank
        bank.compact()
        return bank.snapshot_params(self._slot.idx)

    # -- grouping interface ---------------------------------------------------
    @property
    def num_members(self) -> int:
        return len(self.members)

    @property
    def _pool_src(self) -> List[Optional[str]]:
        """Per-row stream tags, oldest first (tests/inspection)."""
        return self.pool.sources()

    def add_member(self, req: Request):
        self.members.append(req)
        if req.train_data is not None:
            self.pool.add(req.train_data, req.stream_id)

    def remove_member(self, stream_id: str):
        self.members = [m for m in self.members if m.stream_id != stream_id]

    def purge_stream_data(self, stream_id: str):
        """Drop a stream's pooled training data. Used when a camera
        LEAVES the fleet (churn): the group must stop doing SGD on a
        distribution no live member has. Eviction/regrouping does NOT
        purge — an evicted member's data contributed while it was a
        member (the reference's semantics, pinned by the golden
        traces)."""
        self.pool.purge(stream_id)

    def eval_on(self, samples, precision: Optional[str] = None) -> float:
        """Accuracy on `samples`, scored at the job's own decision
        precision by default; pass precision="fp32" for the
        near-threshold rescore."""
        return self.engine._eval_slot(
            self._slot.idx, samples,
            precision=self.precision if precision is None else precision)

    # -- allocator interface ------------------------------------------------
    def eval(self) -> float:
        """Accuracy averaged over member subsamples (A_j in Eq. 1)."""
        if not self.members:
            return 0.0
        return self.engine.eval_jobs([self])[0]

    def train_micro(self):
        """One micro-window: `micro_steps` SGD steps on pool batches.
        Returns its metrics (see `SharedEngine.train_micro_many`)."""
        return self.engine.train_micro_many([self]).get(self.job_id)

    # -- data plane ---------------------------------------------------------
    def ingest(self, tokens: np.ndarray, stream_id: Optional[str] = None):
        """New window data from a member's transmission. `stream_id`
        attributes each row so churn can purge a departed camera's
        data (purge_stream_data). The ring pool evicts the OLDEST rows
        once the row budget is exceeded."""
        self.pool.add(tokens, stream_id)
