"""Elastic scaling: survive a device failure by re-meshing and restoring
from the last checkpoint, ported from the JAX package's
`distributed/elastic.py`.

Two levels, as in the reference:

* The fleet decision planes (`FleetElastic`, driven by
  `core.controller.ECCOController.run_window`): a 1-D fleet mesh loses
  devices mid-window; the window re-runs from its start checkpoint on the
  surviving prefix, to the same decisions.
* A model-level mesh (`MeshSpec`, `shrink_mesh`, `plan_recovery`,
  `ElasticRuntime`): a failure takes out whole rows of the data axis; the
  runtime shrinks the mesh, rebuilds the step for it and restores the
  state from the last checkpoint onto the new placement.
  `ElasticRuntime.step_factory(mesh, rules)` returns the step and a tree
  of devices, one per state leaf, where the reference returns
  `NamedSharding`s.

Meshes are `launch.mesh.FleetMesh`; with no device list they draw CUDA
devices (the CPU tests pass `devices=`).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence, Tuple

from repro_torch.distributed import checkpoint as ckpt
from repro_torch.launch.mesh import make_fleet_mesh, make_mesh


@dataclasses.dataclass
class MeshSpec:
    shape: Tuple[int, ...]
    axes: Tuple[str, ...]


def shrink_mesh(current: MeshSpec, failed_rows: int,
                *, data_axis: str = "data") -> MeshSpec:
    """New mesh spec after losing `failed_rows` rows of the data axis.
    Keeps the other axes; drops whole data rows (slice-granular
    failure). Raises if nothing survives."""
    idx = current.axes.index(data_axis)
    new_data = current.shape[idx] - failed_rows
    if new_data < 1:
        raise RuntimeError("no surviving data rows")
    shape = list(current.shape)
    shape[idx] = new_data
    return MeshSpec(tuple(shape), current.axes)


def build_mesh(spec: MeshSpec, *, devices=None):
    """A mesh over the first prod(shape) (surviving) devices."""
    return make_mesh(spec.shape, spec.axes, devices=devices)


class DeviceFailure(RuntimeError):
    """Raised at an elastic barrier when device loss invalidates the
    in-flight retraining window. Carries how many fleet devices died."""

    def __init__(self, lost: int):
        self.lost = int(lost)
        super().__init__(f"lost {lost} fleet device(s) mid-window")


@dataclasses.dataclass
class RecoveryPlan:
    old_mesh_shape: Tuple[int, ...]
    new_mesh_shape: Tuple[int, ...]
    restore_step: Optional[int]
    global_batch_scale: float      # DP width shrank -> scale batch or accum


class FleetElastic:
    """Elastic runtime for the fleet decision planes (1-D fleet mesh).

    Failure model: device memory is lost (the JobBank's resident slot
    stack), the host control plane survives. The window protocol (driven
    by ECCOController.run_window):

      1. `on_window_start(jobs)`: checkpoint every job's train-state
         ({job_id: state}, atomic rename). This plus the controller's
         in-memory host snapshot is the recovery point.
      2. `barrier()` between the window's stages and before every
         allocator micro-window. A failure armed by `schedule_failure`
         fires at its barrier and raises DeviceFailure; a deployment would
         raise it from a health check instead.
      3. On DeviceFailure, `recover(lost)` shrinks the mesh to the
         surviving device prefix; the controller re-attaches every plane
         to the new mesh, rolls its host snapshot back, calls
         `restore_jobs`, and re-runs the window. Per-row math does not
         depend on the placement, so the re-run decides as a run that
         never failed (tests/test_torch_elastic.py).
    """

    def __init__(self, ckpt_dir: str, mesh=None, *, axis: str = "fleet"):
        self.ckpt_dir = ckpt_dir
        self.axis = axis
        self.mesh = mesh            # current fleet mesh (None = 1 device)
        self.step = 0               # one checkpoint step per window
        self.barriers = 0
        self._fail_at: Optional[Tuple[int, int]] = None
        self.recoveries: List[RecoveryPlan] = []

    def schedule_failure(self, n_devices: int = 1, *,
                         after_barriers: int = 1):
        """Arm a simulated failure: the `after_barriers`-th barrier from
        now raises DeviceFailure(n_devices)."""
        self._fail_at = (self.barriers + int(after_barriers),
                         int(n_devices))

    def barrier(self):
        """Stage-boundary health check inside a window."""
        self.barriers += 1
        if self._fail_at is not None and self.barriers >= self._fail_at[0]:
            lost = self._fail_at[1]
            self._fail_at = None
            raise DeviceFailure(lost)

    def on_window_start(self, jobs: Sequence):
        """Checkpoint every job's train-state at the window boundary.
        Reading `job.state` syncs through the bank's residency cache (one
        row copy per host-stale row, nothing for host-current rows)."""
        ckpt.save(self.ckpt_dir, self.step,
                  {j.job_id: j.state for j in jobs})
        self.step += 1

    def recover(self, lost: int):
        """Shrink to the surviving device prefix; returns the new mesh (a
        1-device mesh stays a real mesh: the sharded entry points run
        one block)."""
        old = self.mesh.size if self.mesh is not None else 1
        n = old - int(lost)
        if n < 1:
            raise RuntimeError("no surviving fleet devices")
        self.mesh = make_fleet_mesh(n, axis=self.axis,
                                    devices=self.mesh.devices[:n])
        self.recoveries.append(RecoveryPlan(
            old_mesh_shape=(old,), new_mesh_shape=(n,),
            restore_step=self.step - 1,
            global_batch_scale=n / old))
        return self.mesh

    def restore_jobs(self, jobs: Sequence):
        """Restore every job's train-state from the window-start
        checkpoint, writing THROUGH the bank (`job.state =` stages the
        host mirror and marks the device row stale; the next batched
        fleet call flushes them in one copy). `jobs` must be the
        window-start job set: the ids the checkpoint holds."""
        if not jobs:
            return
        template = {j.job_id: j.state_template for j in jobs}
        tree, _ = ckpt.restore(self.ckpt_dir, self.step - 1, template)
        for j in jobs:
            j.state = tree[j.job_id]


def plan_recovery(current: MeshSpec, failed_rows: int, ckpt_dir: str,
                  *, data_axis: str = "data") -> RecoveryPlan:
    new = shrink_mesh(current, failed_rows, data_axis=data_axis)
    i = current.axes.index(data_axis)
    return RecoveryPlan(
        old_mesh_shape=current.shape,
        new_mesh_shape=new.shape,
        restore_step=ckpt.latest_step(ckpt_dir),
        global_batch_scale=new.shape[i] / current.shape[i],
    )


class ElasticRuntime:
    """Owns the mesh and the step; `fail_and_recover` swaps both.

    step_factory(mesh, rules) -> (step_fn, state_devices), a tree of
    devices matching the state, so the runtime can rebuild after any
    re-mesh. State flows through the checkpoint (restored onto the new
    placement), the only correct path when block boundaries move.
    `devices` is the pool meshes draw from, in order (the CUDA devices
    when None)."""

    def __init__(self, mesh_spec: MeshSpec, step_factory: Callable,
                 rules_fn: Callable, ckpt_dir: str, *, devices=None):
        self.spec = mesh_spec
        self.step_factory = step_factory
        self.rules_fn = rules_fn
        self.ckpt_dir = ckpt_dir
        self.pool = None if devices is None else list(devices)
        self.mesh = build_mesh(mesh_spec, devices=self.pool)
        self.rules = rules_fn(self.mesh)
        self.step, self.state_devices = step_factory(self.mesh, self.rules)
        self.recoveries: List[RecoveryPlan] = []

    def fail_and_recover(self, failed_rows: int, state_template):
        """Simulated failure of `failed_rows` data rows; returns the
        restored state on the shrunken mesh and the plan."""
        plan = plan_recovery(self.spec, failed_rows, self.ckpt_dir)
        self.recoveries.append(plan)
        self.spec = MeshSpec(plan.new_mesh_shape, self.spec.axes)
        self.mesh = build_mesh(self.spec, devices=self.pool)
        self.rules = self.rules_fn(self.mesh)
        self.step, self.state_devices = self.step_factory(self.mesh,
                                                          self.rules)
        if plan.restore_step is None:
            raise RuntimeError("no checkpoint to recover from")
        state, _ = ckpt.restore(self.ckpt_dir, plan.restore_step,
                                state_template, devices=self.state_devices)
        return state, plan
