"""Fleet decision-plane sharding, ported from the fleet-row half of the
JAX package's `distributed/sharding.py`.

The batched control planes (the JobBank's slot stack, fleet_drift rows,
decide_many flows, pairwise_js signatures) all shard ONE leading axis,
the job / stream row axis, over a 1-D fleet mesh (`launch.mesh.
make_fleet_mesh`). Per-row math is independent, so block-sharding the
leading axis is bit-identical to one device; capacity alignment
(`core.rows.RowRegistry.align`) keeps the blocks equal, so churn never
re-pads the global shape.

Where the reference names a placement (`row_pspec`, `row_sharding`,
`stack_sharding`, `replicated`) and lets XLA move the data, the port
places each block itself: `row_spans` are the contiguous [lo, hi) blocks,
`block_devices` their devices, `split_rows` pads a row array and puts each
block on its device, `join_rows` concatenates per-block results on
`devices[0]`, and `BlockRows` holds a (capacity, ...) stack as one tensor
per block. `mesh_rules` and `batch_pspec` (model-level sharding over the
production mesh) are not here: ROADMAP.md queue 1 item 9b.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch


def fleet_axis(mesh) -> str:
    """The mesh axis fleet rows shard along (the leading one)."""
    return tuple(mesh.axis_names)[0]


def fleet_devices(mesh) -> int:
    """Shard count along the fleet axis."""
    return int(mesh.shape[fleet_axis(mesh)])


def block_devices(mesh) -> List[torch.device]:
    """The device of each row block: the first device of each slice of
    the leading axis (every device of a 1-D mesh)."""
    n = fleet_devices(mesh)
    step = mesh.size // n
    return [mesh.devices[b * step] for b in range(n)]


def block_rows(n: int, shards: int) -> int:
    """Rows per block when `n` rows are padded to a multiple of `shards`."""
    return -(-int(n) // shards)


def row_spans(n: int, shards: int) -> List[Tuple[int, int]]:
    """Contiguous [lo, hi) row blocks of `n` rows padded to a multiple of
    `shards` (the tail block's padding lies past `n`)."""
    per = block_rows(n, shards)
    return [(b * per, (b + 1) * per) for b in range(shards)]


def split_rows(x: torch.Tensor, mesh) -> List[torch.Tensor]:
    """Pad the leading (row) axis of `x` with zero rows to a multiple of
    the shard count and return its contiguous blocks, block b on
    `block_devices(mesh)[b]`. The padding rows' results are sliced off
    by `join_rows`; their values never matter."""
    devs = block_devices(mesh)
    per = block_rows(x.shape[0], len(devs))
    pad = per * len(devs) - x.shape[0]
    if pad:
        x = torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])
    return [x[b * per:(b + 1) * per].to(d) for b, d in enumerate(devs)]


def join_rows(parts: Sequence[torch.Tensor], n: int, device,
              dim: int = 0) -> torch.Tensor:
    """Concatenate per-block results on `device` along `dim` and keep the
    first `n` (the padding goes)."""
    out = torch.cat([p.to(device) for p in parts], dim=dim)
    return out.narrow(dim, 0, n)


def _indices(idx) -> List[int]:
    if isinstance(idx, torch.Tensor):
        return [int(i) for i in idx.reshape(-1).tolist()]
    return [int(i) for i in np.asarray(idx).reshape(-1)]


class BlockRows:
    """A (rows, ...) stack held as equal contiguous row blocks, block b a
    tensor on its own device: the JobBank's slot stack under a fleet
    mesh. Indexing takes global row numbers. An int index gives a VIEW of
    the row on its block's device (the train step updates it in place);
    an index vector gathers a fresh tensor on the first block's device,
    and assignment writes each row into its block."""
    __slots__ = ("blocks", "per")

    def __init__(self, blocks: Sequence[torch.Tensor]):
        self.blocks = list(blocks)
        self.per = int(self.blocks[0].shape[0])

    @classmethod
    def zeros(cls, rows: int, row_shape, dtype, devices) -> "BlockRows":
        if rows % len(devices):
            raise ValueError(f"{rows} rows do not split into "
                             f"{len(devices)} equal blocks")
        per = rows // len(devices)
        return cls([torch.zeros((per,) + tuple(row_shape), dtype=dtype,
                                device=d) for d in devices])

    @property
    def shape(self) -> torch.Size:
        b = self.blocks[0]
        return torch.Size((self.per * len(self.blocks),) + tuple(b.shape[1:]))

    @property
    def dtype(self) -> torch.dtype:
        return self.blocks[0].dtype

    @property
    def device(self) -> torch.device:
        return self.blocks[0].device

    @property
    def devices(self) -> List[torch.device]:
        return [b.device for b in self.blocks]

    def is_floating_point(self) -> bool:
        return self.blocks[0].is_floating_point()

    def to(self, dtype) -> "BlockRows":
        """Every block cast to `dtype` on its own device."""
        return BlockRows([b.to(dtype) for b in self.blocks])

    def zero_(self) -> "BlockRows":
        for b in self.blocks:
            b.zero_()
        return self

    def locate(self, i: int) -> Tuple[int, int]:
        """(block, row within the block) of global row `i`."""
        return divmod(int(i), self.per)

    def device_of(self, i: int) -> torch.device:
        return self.blocks[int(i) // self.per].device

    def __getitem__(self, idx):
        if isinstance(idx, (int, np.integer)):
            b, r = self.locate(idx)
            return self.blocks[b][r]
        rows = [self[i] for i in _indices(idx)]
        if not rows:
            return self.blocks[0].new_zeros((0,) + self.shape[1:])
        return torch.stack([r.to(self.device) for r in rows])

    def __setitem__(self, idx, value):
        if isinstance(idx, (int, np.integer)):
            self[idx].copy_(value)
            return
        for k, i in enumerate(_indices(idx)):
            self[i].copy_(value[k])

    def resized(self, rows: int, devices) -> "BlockRows":
        """A stack of `rows` rows in equal blocks over `devices`, holding
        this one's first min(rows, len) rows (device to device)."""
        out = BlockRows.zeros(rows, self.shape[1:], self.dtype, devices)
        keep = min(rows, self.shape[0])
        for b, blk in enumerate(self.blocks):
            lo = b * self.per
            hi = min(lo + self.per, keep)
            for i in range(lo, hi):
                out[i].copy_(blk[i - lo])
        return out

    def flat(self, device) -> torch.Tensor:
        """The whole stack as one tensor on `device`."""
        return torch.cat([b.to(device) for b in self.blocks])
