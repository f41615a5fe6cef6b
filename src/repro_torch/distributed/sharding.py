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
per block.

The model half, `mesh_rules` and `batch_pspec`, maps logical axis names
onto the production mesh, with the reference's two policies:

``tp``, the paper-faithful baseline (MaxText-style 2D sharding):
  * batch           -> (pod, data)         pure DP across pods + data rows
  * vocab/heads/mlp -> model               Megatron tensor parallelism
  * experts         -> model               expert parallelism (MoE)
  * fsdp            -> data                ZeRO-3 parameter+optimizer shard
  * kv_heads        -> model when divisible, else replicated
  * heads           -> model when the padded head count divides it
                       (`models.layers.padded_heads`: starcoder2's 24
                       heads -> 32), else replicated (hymba's 25)
  * seq             -> model (Megatron-SP between blocks)

``zero``, pure DP + ZeRO-3 for train and prefill:
  * batch           -> (pod, data)
  * heads/kv_heads/mlp/seq -> None
  * vocab, experts  -> model
  * fsdp            -> data; ("data", "model") for dense archs over
                       `_FSDP2D_PARAM_THRESHOLD` parameters whose d_model
                       divides both axes, where vocab then reverts to None.

A pspec is a plain tuple, one entry per dim (None, an axis name or a
tuple of names), as `models.param.logical_to_pspec` builds it. Both
functions read only `mesh.shape`, so a shape-only stand-in serves.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

# beyond this many params, fp32 param+Adam state (16 B/param -> 1 B/param
# per chip at 16-way ZeRO) exceeds a chip's memory share and params must
# shard over both mesh axes (256-way)
_FSDP2D_PARAM_THRESHOLD = 12e9


def mesh_rules(mesh, cfg=None, *, fsdp: bool = True,
               policy: str = "tp") -> dict:
    """{logical axis: mesh axis, tuple of axes, or None} for `mesh` under
    `policy` ("tp" or "zero"); `cfg` (a ModelConfig) refines the heads,
    kv_heads and fsdp rules."""
    axes = dict(mesh.shape)
    model_n = axes.get("model", 1)
    batch = tuple(a for a in ("pod", "data") if a in axes)
    batch_rule = batch if len(batch) > 1 else (batch[0] if batch else None)
    data_n = axes.get("data", 1)

    if policy == "zero":
        rules = {
            "batch": batch_rule,
            "vocab": "model" if model_n > 1 else None,
            "mlp": None,
            "experts": "model" if model_n > 1 else None,
            "heads": None,
            "kv_heads": None,
            "fsdp": "data" if (fsdp and data_n > 1) else None,
            "seq": None,
            "layers": None,
        }
        if cfg is not None and fsdp and model_n > 1 and data_n > 1 \
                and cfg.moe is None \
                and cfg.param_count() > _FSDP2D_PARAM_THRESHOLD \
                and cfg.d_model % (data_n * model_n) == 0:
            rules["fsdp"] = ("data", "model")
            rules["vocab"] = None      # embed table: fsdp owns both axes
        return rules

    if policy != "tp":
        raise ValueError(f"unknown policy {policy!r}; use 'tp' or 'zero'")
    on = "model" if model_n > 1 else None
    rules = {
        "batch": batch_rule,
        "vocab": on,
        "mlp": on,
        "experts": on,
        "heads": on,
        "kv_heads": on,
        "fsdp": "data" if (fsdp and data_n > 1) else None,
        "seq": on,
        "layers": None,
    }
    if cfg is not None and model_n > 1:
        if cfg.num_kv_heads % model_n != 0:
            rules["kv_heads"] = None          # replicate small KV-head sets
        from repro_torch.models.layers import padded_heads
        if padded_heads(cfg, model_n) % model_n != 0:
            rules["heads"] = None             # padding too wasteful
    return rules


def batch_pspec(mesh) -> tuple:
    """The pspec of a (batch, ...) input: its leading dim over the batch
    axes present ("pod", "data"), as one name or a tuple of two."""
    axes = tuple(a for a in ("pod", "data") if a in mesh.shape)
    return (axes if len(axes) > 1 else axes[0],)


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
