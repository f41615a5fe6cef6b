"""Device meshes for the fleet decision planes, ported from the JAX
package's `launch/mesh.py`.

The reference's fleet mesh is one process that places contiguous row
blocks on its local devices and runs the same kernel on each block
(`shard_map`). Its counterpart here is not `torch.distributed`, whose
`DeviceMesh` is one process per rank, but `FleetMesh`: an ordered tuple of
`torch.device` with named axes. A sharded op (`kernels/ops.py`) pads the
row axis to a multiple of `size` with zero rows, launches the unchanged
kernel on each contiguous block on that block's device (inside
`on_device(block_device)`, on that device's current stream), concatenates
the blocks on `devices[0]` and slices the padding off. Per-row math is
unchanged, so results are bit-identical to one call.

`make_fleet_mesh(n)` with no device list takes the first `n` CUDA devices
and raises when there are fewer; it never drops to the CPU. An explicit
device list may repeat a device: the CPU tests run eight `cpu` shards, and
`chip_smoke.py` runs four `cuda:0` shards on one card. Placement on
several cards is untested until a machine with several cards runs it.

The model half runs on the same mesh: `make_production_mesh` lays out the
reference's (16, 16) ("data", "model") or (2, 16, 16) ("pod", "data",
"model") mesh, and the expert-parallel MoE (`models/moe.apply_moe_ep`)
and the sequence-parallel mLSTM (`models/xlstm.
apply_mlstm_block_seqpar`) run their `shard_map` bodies once per entry
(`FleetMesh.device_at`), each on its entry's device, with the
collectives as tensor moves between the entries.
"""
from __future__ import annotations

import contextlib
import dataclasses
import itertools
import math
from typing import Dict, Iterator, Optional, Sequence, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class FleetMesh:
    """Devices laid out over named axes; row blocks shard along the
    leading axis. `devices` is flat, in row-major order of `dims`."""
    devices: Tuple[torch.device, ...]
    axis_names: Tuple[str, ...]
    dims: Tuple[int, ...]

    def __post_init__(self):
        if len(self.axis_names) != len(self.dims):
            raise ValueError(f"axes {self.axis_names} and shape {self.dims} "
                             f"differ in rank")
        if len(self.devices) != math.prod(self.dims):
            raise ValueError(f"{len(self.devices)} devices for shape "
                             f"{self.dims}")

    @property
    def shape(self) -> Dict[str, int]:
        """{axis: size}, as the reference's `mesh.shape` reads."""
        return dict(zip(self.axis_names, self.dims))

    @property
    def size(self) -> int:
        return len(self.devices)

    def device_at(self, **index: int) -> torch.device:
        """The device of the entry at `index` ({axis: position}; an axis
        left out is taken at 0)."""
        flat = 0
        for name, dim in zip(self.axis_names, self.dims):
            i = int(index.get(name, 0))
            if not 0 <= i < dim:
                raise IndexError(f"{name}={i} outside [0, {dim})")
            flat = flat * dim + i
        return self.devices[flat]

    def positions(self, axes: Sequence[str]) -> Iterator[Dict[str, int]]:
        """Every {axis: position} over `axes`, in row-major order (the
        order of a tiled concatenation over those axes)."""
        for idx in itertools.product(*(range(self.shape[a]) for a in axes)):
            yield dict(zip(axes, idx))


def _cuda_devices(n: int):
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < n:
        raise RuntimeError(f"need {n} CUDA devices, have {have}; pass "
                           f"devices= to place a mesh elsewhere")
    return [torch.device("cuda", i) for i in range(n)]


def make_mesh(shape: Sequence[int], axes: Sequence[str], *,
              devices: Optional[Sequence] = None) -> FleetMesh:
    """A mesh of `shape` over the first prod(shape) of `devices` (the CUDA
    devices when None); raises when there are fewer."""
    dims = tuple(int(s) for s in shape)
    n = math.prod(dims)
    devs = (_cuda_devices(n) if devices is None
            else [torch.device(d) for d in devices][:n])
    if len(devs) < n:
        raise RuntimeError(f"need {n} devices, have {len(devs)}")
    return FleetMesh(tuple(devs), tuple(axes), dims)


def make_production_mesh(multi_pod: bool = False, *,
                         devices: Optional[Sequence] = None) -> FleetMesh:
    """The reference's production mesh: (16, 16) over ("data", "model"),
    or (2, 16, 16) over ("pod", "data", "model"). With no device list it
    takes CUDA devices and raises when there are fewer than it needs (256
    or 512); it never drops to the CPU. An explicit list may repeat a
    device, as `make_mesh`'s does (the CPU tests, the dry run)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, devices=devices)


def make_fleet_mesh(n_devices: Optional[int] = None, *, axis: str = "fleet",
                    devices: Optional[Sequence] = None) -> FleetMesh:
    """1-D mesh over the fleet row / job axis: what the JobBank's slot
    stack, fleet_drift rows, decide_many flows and pairwise_js signatures
    shard along. Defaults to every CUDA device; `n_devices` takes a prefix
    (the elastic shrink passes the survivors)."""
    if devices is None:
        if n_devices is None:
            n_devices = torch.cuda.device_count() \
                if torch.cuda.is_available() else 0
            if n_devices < 1:
                raise RuntimeError("no CUDA device for a fleet mesh; pass "
                                   "devices= to place one elsewhere")
        devices = _cuda_devices(int(n_devices))
    n = len(devices) if n_devices is None else int(n_devices)
    return make_mesh((n,), (axis,), devices=devices)


def on_device(device: torch.device):
    """The context a block's launch runs in: its CUDA device made current
    (the kernels launch on the current device's current stream), nothing
    on the CPU."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()
