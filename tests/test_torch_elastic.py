"""Fault tolerance of the port: tests/test_elastic.py's mesh-shrink and
ElasticRuntime tests, tests/test_distributed_plane.py's barrier test and
its ELASTIC_RECOVERY contract, restated on `repro_torch.distributed`.

The reference runs its recovery in a subprocess on a forced 8-device host
platform, whose XLA CPU all-reduce can miss its 40 s rendezvous on a
loaded machine. The port's fleet mesh is a single controller, so an
8-entry CPU mesh (one device repeated) runs in this process. The
controller's mid-window recovery: window 2 runs on 8 entries, loses 4 at
its 4th barrier and re-runs on 4. Its history must equal, exactly, the
port's unsharded run that never failed, and the live reference's
single-device run in fp32 from the same initial weights as
tests/test_torch_window.py holds them (structure, accuracies and shares
as equal floats, bandwidth within 1e-5 relative).
"""
import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402

from repro.configs import smoke_config as jsmoke_config  # noqa: E402
from repro.configs.base import TrainConfig as JTrainConfig  # noqa: E402
from repro.core import baselines as jbaselines  # noqa: E402
from repro.core import controller as jcontroller  # noqa: E402
from repro.core import trainer as jtrainer  # noqa: E402
from repro.data.streams import make_fleet as jmake_fleet  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.configs.base import TrainConfig  # noqa: E402
from repro_torch.core import trainer  # noqa: E402
from repro_torch.core.allocator import ECCOAllocator  # noqa: E402
from repro_torch.core.baselines import FRAMEWORKS  # noqa: E402
from repro_torch.core.controller import ControllerConfig  # noqa: E402
from repro_torch.data.streams import make_fleet  # noqa: E402
from repro_torch.distributed import checkpoint as ckpt  # noqa: E402
from repro_torch.distributed.elastic import (  # noqa: E402
    DeviceFailure, ElasticRuntime, FleetElastic, MeshSpec, plan_recovery,
    shrink_mesh)
from repro_torch.distributed.stragglers import StragglerPolicy  # noqa: E402
from repro_torch.launch.mesh import make_fleet_mesh  # noqa: E402

CPU8 = ["cpu"] * 8
VOCAB = 64
FP32 = dict(learning_rate=1e-3, b2=0.999, weight_decay=0.0, warmup_steps=5,
            total_steps=100000, remat="none", compute_dtype="float32")
CC = dict(window_micro=6, micro_steps=4, train_batch=16,
          drift_threshold=0.25, p_drop=0.5, shared_bandwidth=1e9)
FLEET = dict(vocab=VOCAB, regions=2, streams_per_region=2, dim=4,
             switch_times=(5.0,), seed=1)
BW_RTOL = 1e-5
JFRAMEWORKS = {"ecco": jcontroller.ECCOController,
               "recl": jbaselines.RECLController}


# -- tests/test_elastic.py ---------------------------------------------------
def test_shrink_mesh_drops_data_rows():
    spec = MeshSpec((2, 16, 16), ("pod", "data", "model"))
    new = shrink_mesh(spec, 4)
    assert new.shape == (2, 12, 16)
    assert new.axes == spec.axes


def test_shrink_mesh_exhaustion_raises():
    with pytest.raises(RuntimeError):
        shrink_mesh(MeshSpec((4, 2), ("data", "model")), 4)


def test_plan_recovery_scales_batch(tmp_path):
    ckpt.save(str(tmp_path), 7, {"w": torch.zeros(2)})
    plan = plan_recovery(MeshSpec((8, 2), ("data", "model")), 2,
                         str(tmp_path))
    assert plan.new_mesh_shape == (6, 2)
    assert plan.restore_step == 7
    assert plan.global_batch_scale == pytest.approx(6 / 8)


def test_elastic_runtime_recovers_onto_the_shrunken_mesh(tmp_path):
    """The reference's subprocess test in process: state on a 4x2 mesh,
    2 data rows lost, restored onto the 2x2 mesh's placement."""
    built = []

    def rules_fn(mesh):
        return {"batch": "data", "mlp": "model"}

    def step_factory(mesh, rules):
        built.append(mesh.shape)

        def step(w, x):
            return w + 0.1 * torch.mean(x), None
        return step, {"w": mesh.devices[-1]}

    rt = ElasticRuntime(MeshSpec((4, 2), ("data", "model")), step_factory,
                        rules_fn, str(tmp_path), devices=CPU8)
    w = torch.arange(32, dtype=torch.float32).reshape(4, 8)
    ckpt.save(str(tmp_path), 0, {"w": w})
    restored, plan = rt.fail_and_recover(2, {"w": w})
    assert plan.new_mesh_shape == (2, 2), plan
    assert rt.mesh.size == 4 and rt.mesh.shape["data"] == 2
    assert built == [{"data": 4, "model": 2}, {"data": 2, "model": 2}]
    assert torch.equal(restored["w"], w)
    assert restored["w"].device == rt.mesh.devices[-1]
    y, _ = rt.step(restored["w"], torch.ones(4, 8))
    assert torch.isfinite(y).all()
    assert rt.recoveries == [plan]


def test_elastic_runtime_without_a_checkpoint_raises(tmp_path):
    rt = ElasticRuntime(MeshSpec((2,), ("data",)),
                        lambda m, r: (None, {"w": "cpu"}), lambda m: {},
                        str(tmp_path), devices=CPU8)
    with pytest.raises(RuntimeError, match="no checkpoint"):
        rt.fail_and_recover(1, {"w": torch.zeros(1)})


# -- tests/test_distributed_plane.py: the barrier -----------------------------
class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


class _FakeJob:
    def __init__(self, jid, clock, step_time, gain):
        self.job_id = jid
        self.num_members = 1
        self.micro_steps = 4
        self._clock = clock
        self._step_time = step_time
        self._gain = gain
        self._acc = 0.0
        self.steps_run = []

    def eval(self):
        return self._acc

    def train_micro(self):
        self._clock.t += self.micro_steps * self._step_time
        self.steps_run.append(self.micro_steps)
        self._acc = min(1.0, self._acc + self._gain * self.micro_steps)


def test_barrier_failure_aborts_allocator_window(tmp_path):
    el = FleetElastic(str(tmp_path))
    el.schedule_failure(1, after_barriers=3)
    clock = _Clock()
    jobs = [_FakeJob(f"j{i}", clock, step_time=1.0, gain=0.01)
            for i in range(2)]
    with pytest.raises(DeviceFailure) as ei:
        ECCOAllocator().run_window(jobs, 8, stragglers=StragglerPolicy(),
                                   clock=clock, barrier=el.barrier)
    assert ei.value.lost == 1
    # the two pre-failure micro-windows ran; the third aborted cleanly
    assert sum(len(j.steps_run) for j in jobs) == 2


def test_recover_shrinks_to_the_survivor_prefix(tmp_path):
    mesh = make_fleet_mesh(8, devices=CPU8)
    el = FleetElastic(str(tmp_path), mesh)
    el.step = 3
    new = el.recover(5)
    assert new.size == 3 and el.mesh is new
    plan = el.recoveries[0]
    assert (plan.old_mesh_shape, plan.new_mesh_shape) == ((8,), (3,))
    assert (plan.restore_step, plan.global_batch_scale) == (2, 3 / 8)
    with pytest.raises(RuntimeError, match="no surviving"):
        el.recover(3)
    with pytest.raises(RuntimeError, match="no surviving"):
        FleetElastic(str(tmp_path)).recover(1)


# -- ELASTIC_RECOVERY ----------------------------------------------------------
@pytest.fixture(scope="module")
def engines():
    jcfg = dataclasses.replace(jsmoke_config("olmo-1b"), vocab_size=VOCAB)
    jeng = jtrainer.SharedEngine(jcfg, JTrainConfig(**FP32))
    init = jax.tree.map(np.asarray, jeng.fresh_state(0)["params"])

    def port_engine():
        cfg = dataclasses.replace(smoke_config("olmo-1b"), vocab_size=VOCAB)
        return trainer.SharedEngine(cfg, TrainConfig(**FP32), device="cpu",
                                    init_params={0: init})
    return jeng, port_engine


def _reference(framework, jeng):
    jtrainer._job_counter.n = 0
    _, streams = jmake_fleet(**FLEET)
    ctl = JFRAMEWORKS[framework](jeng, streams,
                                 jcontroller.ControllerConfig(**CC), seed=0)
    ctl.run(3)
    return ctl


def _port(framework, engine, **kw):
    trainer._job_counter.n = 0     # job ids must match across runs
    _, streams = make_fleet(**FLEET)
    return FRAMEWORKS[framework](engine, streams, ControllerConfig(**CC),
                                 seed=0, **kw)


def _same(a, b):
    return a == b or (math.isnan(a) and math.isnan(b))


@pytest.mark.parametrize("framework", ["ecco", "recl"])
def test_mid_window_recovery_equals_the_run_that_never_failed(
        framework, engines, tmp_path):
    jeng, port_engine = engines
    ctl_a = _port(framework, port_engine())
    ctl_a.run(3)

    el = FleetElastic(str(tmp_path), mesh=make_fleet_mesh(8, devices=CPU8))
    ctl_b = _port(framework, port_engine(), elastic=el)
    assert ctl_b.mesh is el.mesh and ctl_b.engine.bank.mesh is el.mesh
    ctl_b.warmup()
    ctl_b.run_window()
    el.schedule_failure(4, after_barriers=4)
    ctl_b.run_window()            # aborts, re-meshes to 4, re-runs
    ctl_b.run_window()
    assert len(el.recoveries) == 1, el.recoveries
    plan = el.recoveries[0]
    assert (plan.old_mesh_shape, plan.new_mesh_shape) == ((8,), (4,))
    assert ctl_b.mesh.size == 4 and ctl_b.engine.bank.mesh.size == 4
    assert ctl_b.fleet.mesh is ctl_b.mesh is ctl_b.sig_index.mesh \
        is ctl_b.tx_plane.mesh
    assert len(ckpt.list_steps(str(tmp_path))) == 3   # one per window
    assert any(wm.groups for wm in ctl_a.history)     # something trained

    assert len(ctl_a.history) == len(ctl_b.history) == 3
    for wa, wb in zip(ctl_a.history, ctl_b.history):
        assert wa.t == wb.t
        assert wa.groups == wb.groups, (wa.groups, wb.groups)
        assert list(wa.per_stream_acc) == list(wb.per_stream_acc)
        for k, va in wa.per_stream_acc.items():
            assert _same(va, wb.per_stream_acc[k]), (k, va)
        assert wa.shares == wb.shares
        assert wa.bandwidth == wb.bandwidth
        assert wa.delivered == wb.delivered

    ctl_r = _reference(framework, jeng)
    assert len(ctl_r.history) == 3
    for wr, wb in zip(ctl_r.history, ctl_b.history):
        assert wr.t == wb.t
        assert wr.groups == wb.groups
        assert list(wr.per_stream_acc) == list(wb.per_stream_acc)
        for k, vr in wr.per_stream_acc.items():
            assert _same(vr, wb.per_stream_acc[k]), (k, vr)
        assert list(wr.shares.items()) == list(wb.shares.items())
        assert wr.delivered == wb.delivered
        assert list(wr.bandwidth) == list(wb.bandwidth)
        np.testing.assert_allclose(list(wb.bandwidth.values()),
                                   list(wr.bandwidth.values()),
                                   rtol=BW_RTOL, atol=0)
