"""Straggler quotas and the window deadline on the port: the three
fake-clock tests of tests/test_distributed_plane.py restated on
`repro_torch.core.allocator` and `repro_torch.distributed.stragglers`,
and one seeded sequence of step times fed to both packages' policies,
whose quotas, flags and reports must be equal."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.distributed.stragglers import \
    StragglerPolicy as JStragglerPolicy  # noqa: E402
from repro_torch.core.allocator import ECCOAllocator  # noqa: E402
from repro_torch.distributed.stragglers import (  # noqa: E402
    StepStats, StragglerPolicy)


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


class _FakeJob:
    """Allocator duck-type whose train_micro advances a fake clock by
    micro_steps * step_time and logs the quota it actually ran."""

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


def test_straggler_quota_shrinks_micro_windows():
    clock = _Clock()
    fast1 = _FakeJob("fast1", clock, step_time=1.0, gain=0.001)
    fast2 = _FakeJob("fast2", clock, step_time=1.0, gain=0.001)
    # 10x the step time and the juiciest gain (the greedy loop keeps
    # picking it; the quota must be what reins it in)
    slow = _FakeJob("slow", clock, step_time=10.0, gain=0.05)
    pol = StragglerPolicy(threshold=2.0, min_quota_frac=0.25)
    ECCOAllocator().run_window([fast1, fast2, slow], 8,
                               stragglers=pol, clock=clock)
    assert pol.is_straggler("slow")
    assert not pol.is_straggler("fast1")
    # the first micro-window at full quota (no timings yet); every later
    # one at the re-normalized quota 4 * max(0.25, med/mean)
    assert slow.steps_run[0] == 4
    assert len(slow.steps_run) > 1
    assert all(s == 1 for s in slow.steps_run[1:]), slow.steps_run
    assert pol.flagged.get("slow", 0) >= 1
    assert fast1.steps_run == [4] * len(fast1.steps_run)


def test_window_deadline_drops_leftover_budget():
    clock = _Clock()
    jobs = [_FakeJob(f"j{i}", clock, step_time=10.0, gain=0.01)
            for i in range(3)]
    # the initial pass alone burns 3 * 40 s; the 100 s deadline leaves no
    # room for greedy micro-windows after it
    trace = ECCOAllocator().run_window(jobs, 10, stragglers=StragglerPolicy(),
                                       deadline=100.0, clock=clock)
    assert len(trace.order) == 3, trace.order
    clock2 = _Clock()
    jobs2 = [_FakeJob(f"j{i}", clock2, step_time=10.0, gain=0.01)
             for i in range(3)]
    trace2 = ECCOAllocator().run_window(jobs2, 10,
                                        stragglers=StragglerPolicy(),
                                        clock=clock2)
    assert len(trace2.order) == 10


def test_straggler_off_is_seed_identical():
    """stragglers=None leaves the scalar path untouched: same order, same
    accuracies, same GPU time."""
    def jobs(clock):
        return [_FakeJob(f"j{i}", clock, step_time=1.0, gain=0.01 * (i + 1))
                for i in range(3)]
    a = ECCOAllocator().run_window(jobs(_Clock()), 6)
    clock = _Clock()
    b = ECCOAllocator().run_window(jobs(clock), 6, stragglers=None,
                                   deadline=None, clock=clock)
    assert a.order == b.order
    assert a.acc == b.acc
    assert a.gpu_time == b.gpu_time


def test_policy_equals_the_reference_on_a_seeded_sequence():
    rng = np.random.default_rng(7)
    kw = dict(threshold=1.5, min_quota_frac=0.3, window=8)
    pol, jpol = StragglerPolicy(**kw), JStragglerPolicy(**kw)
    ids = [f"j{i}" for i in range(5)]
    slow = {"j1": 3.0, "j4": 1.8}
    for step in range(120):
        jid = ids[int(rng.integers(0, len(ids)))]
        dt = float(rng.gamma(4.0, 0.25)) * slow.get(jid, 1.0)
        pol.record(jid, dt)
        jpol.record(jid, dt)
        base = int(rng.integers(1, 9))
        assert pol.quota(jid, base) == jpol.quota(jid, base), step
        for j in ids:
            assert pol.is_straggler(j) == jpol.is_straggler(j), (step, j)
    assert pol.report() == jpol.report()
    assert pol.flagged == jpol.flagged and pol.flagged
    assert pol.median_step_time() == jpol.median_step_time()


def test_step_stats_window():
    s = StepStats()
    for i in range(70):
        s.push(float(i), cap=64)
    assert len(s.times) == 64 and s.times[0] == 6.0
    assert s.mean == float(np.mean(np.arange(6, 70)))
    assert StepStats().mean == 0.0
