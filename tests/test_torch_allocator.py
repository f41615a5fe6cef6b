"""Alg. 1 in the port (`repro_torch.core.allocator`) against the JAX
package's allocator: scripted duck-typed jobs under ECCO, RECL and
Uniform give the same `order`, `acc`, `shares`, `gpu_time`, `notes`,
`last_gains` and `estimate_shares` (equal floats, equal dict order:
`max(gains, key=gains.get)` breaks ties by insertion order); the
duck-typed `deadline`, `stragglers`, `barrier` and `meter` hooks act
alike; and the port's batched fleet calls decide as its scalar loop and
as the reference's RetrainJobs on bridged weights."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402

from repro.configs import smoke_config as jax_smoke_config  # noqa: E402
from repro.configs.base import TrainConfig as JTrainConfig  # noqa: E402
from repro.core import allocator as jalloc  # noqa: E402
from repro.core import trainer as jtrainer  # noqa: E402
from repro.core.grouping import Request as JRequest  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.configs.base import TrainConfig  # noqa: E402
from repro_torch.core import allocator as alloc  # noqa: E402
from repro_torch.core.grouping import Request  # noqa: E402
from repro_torch.core.trainer import RetrainJob, SharedEngine  # noqa: E402

VOCAB, SEQ = 64, 16
FP32 = dict(learning_rate=1e-3, b2=0.999, weight_decay=0.0, warmup_steps=5,
            total_steps=100000, remat="none", compute_dtype="float32")
KINDS = ("ECCOAllocator", "RECLAllocator", "UniformAllocator")


class FakeJob:
    """Concave accuracy-vs-GPU-time curve (tests/test_allocator.py)."""

    def __init__(self, job_id, n, ceil=0.8, rate=0.35, acc0=0.0):
        self.job_id, self.num_members = job_id, n
        self.ceil, self.rate, self.acc0 = ceil, rate, acc0
        self.t = 0.0
        self.micro_steps = 4

    def eval(self):
        return float(self.acc0 + (self.ceil - self.acc0)
                     * (1 - np.exp(-self.rate * self.t)))

    def train_micro(self):
        self.t += self.micro_steps / 4


class ScriptedJob:
    """Deterministic gains per micro-window, then flat: equal gains make
    the greedy pick a tie."""

    def __init__(self, job_id, gains, n=1):
        self.job_id, self.num_members = job_id, n
        self.gains = list(gains)
        self.a = 0.0
        self.micro_steps = 4

    def eval(self):
        return self.a

    def train_micro(self):
        self.a += self.gains.pop(0) if self.gains else 0.0


def _fleet(kind):
    if kind == "paper":      # §3.1: a 4-camera group beside a 1-camera one
        return [FakeJob("big", 4, ceil=0.9, rate=0.3),
                FakeJob("small", 1, ceil=0.7, rate=0.5, acc0=0.1)]
    if kind == "mixed":
        return [FakeJob(f"j{i}", n, ceil=c, rate=r, acc0=a)
                for i, (n, c, r, a) in enumerate(
                    [(3, 0.85, 0.2, 0.05), (1, 0.6, 0.6, 0.0),
                     (2, 0.75, 0.35, 0.2), (5, 0.9, 0.1, 0.1)])]
    return [ScriptedJob("a", [0.1, 0.1, 0.05]),      # ties with b
            ScriptedJob("b", [0.1, 0.1, 0.05]),
            ScriptedJob("c", [0.0, -0.02, 0.3], n=2)]


def _trace_equal(got, want):
    assert got.order == want.order
    assert list(got.acc) == list(want.acc) and got.acc == want.acc
    assert list(got.shares) == list(want.shares)
    assert got.shares == want.shares
    assert got.gpu_time == want.gpu_time
    assert got.notes == want.notes and got.budget == want.budget


def _both(kind_alloc, fleet, window_micro, **kw):
    a = getattr(alloc, kind_alloc)()
    ja = getattr(jalloc, kind_alloc)()
    jobs, jjobs = _fleet(fleet), _fleet(fleet)
    got = a.run_window(jobs, window_micro, **kw)
    want = ja.run_window(jjobs, window_micro, **kw)
    return a, ja, jobs, jjobs, got, want


@pytest.mark.parametrize("window_micro", [-1, 0, 1, 2, 9, 24])
@pytest.mark.parametrize("fleet", ["paper", "mixed", "scripted"])
@pytest.mark.parametrize("kind", KINDS)
def test_run_window_equals_reference(kind, fleet, window_micro):
    a, ja, jobs, jjobs, got, want = _both(kind, fleet, window_micro)
    _trace_equal(got, want)
    assert list(a.last_gains.items()) == list(ja.last_gains.items())
    # a later window's shares, with a job the last window never measured
    jobs.append(FakeJob("late", 2))
    jjobs.append(FakeJob("late", 2))
    est = a.estimate_shares(jobs)
    assert list(est.items()) == list(ja.estimate_shares(jjobs).items())
    gains = {j.job_id: g for j, g in zip(jobs, (0.3, -0.1, 0.0, 0.2))}
    assert a.estimate_shares(jobs, gains) == ja.estimate_shares(jjobs, gains)


@pytest.mark.parametrize("kind", KINDS[:2])
def test_empty_fleet_and_no_positive_gains(kind):
    a, ja = getattr(alloc, kind)(), getattr(jalloc, kind)()
    _trace_equal(a.run_window([], 5), ja.run_window([], 5))
    assert a.estimate_shares([]) == ja.estimate_shares([]) == {}
    flat = [ScriptedJob(k, [0.0] * 4) for k in "xyz"]
    jflat = [ScriptedJob(k, [0.0] * 4) for k in "xyz"]
    _trace_equal(a.run_window(flat, 6), ja.run_window(jflat, 6))
    assert a.estimate_shares(flat) == ja.estimate_shares(jflat)


class _Clock:
    def __init__(self, step):
        self.t, self.step = 0.0, step

    def __call__(self):
        self.t += self.step
        return self.t


class _Stragglers:
    """Halves one job's quota and records every micro-window's time."""

    def __init__(self):
        self.seen = []

    def quota(self, job_id, base):
        return base // 2 if job_id == "j1" else base

    def record(self, job_id, seconds):
        self.seen.append((job_id, round(seconds, 9)))


class _Budget:
    def __init__(self, total):
        self.total = self.remaining = total


class _Meter:
    """A duck-typed roofline meter pricing a micro-window by job size."""

    def __init__(self, total):
        self.budget = _Budget(total)
        self.charges = []

    def micro_cost(self, job):
        return 1.0 + 0.5 * job.num_members

    def train_cost(self, job):
        return 0.8 + 0.5 * job.num_members

    def eval_cost(self, job):
        return 0.1

    def can_afford(self, cost):
        return self.budget.remaining - cost >= -1e-12

    def charge(self, cost, kind):
        self.budget.remaining -= cost
        self.charges.append((kind, cost))

    def report(self):
        return {"total": self.budget.total,
                "remaining": self.budget.remaining,
                "charges": len(self.charges)}


@pytest.mark.parametrize("kind", KINDS)
def test_duck_typed_hooks_act_alike(kind):
    # deadline on an injected clock: leftover budget dropped alike
    got = getattr(alloc, kind)().run_window(
        _fleet("mixed"), 12, deadline=5.0, clock=_Clock(1.0))
    want = getattr(jalloc, kind)().run_window(
        _fleet("mixed"), 12, deadline=5.0, clock=_Clock(1.0))
    _trace_equal(got, want)
    # straggler quotas: a halved job measures smaller gains
    s, js = _Stragglers(), _Stragglers()
    a, ja = getattr(alloc, kind)(), getattr(jalloc, kind)()
    jobs, jjobs = _fleet("mixed"), _fleet("mixed")
    _trace_equal(a.run_window(jobs, 10, stragglers=s, clock=_Clock(0.5)),
                 ja.run_window(jjobs, 10, stragglers=js, clock=_Clock(0.5)))
    assert s.seen == js.seen
    assert [j.micro_steps for j in jobs] == [4] * 4     # quota restored
    # a barrier before every micro-window
    calls, jcalls = [], []
    got = getattr(alloc, kind)().run_window(
        _fleet("paper"), 7, barrier=lambda: calls.append(1))
    want = getattr(jalloc, kind)().run_window(
        _fleet("paper"), 7, barrier=lambda: jcalls.append(1))
    _trace_equal(got, want)
    assert len(calls) == len(jcalls) > 0


@pytest.mark.parametrize("total", [0.5, 6.0, 40.0])
@pytest.mark.parametrize("kind", KINDS[:2])
def test_metered_windows_act_alike(kind, total):
    """Budget-short windows degrade to eval-only with a note; others pick
    by gain per metered cost and stop when the budget runs out."""
    m, jm = _Meter(total), _Meter(total)
    got = getattr(alloc, kind)().run_window(_fleet("mixed"), 12, meter=m)
    want = getattr(jalloc, kind)().run_window(_fleet("mixed"), 12,
                                              meter=jm)
    _trace_equal(got, want)
    assert m.charges == jm.charges


# ---------------------------------------------------------------------------
# the training plane's jobs
# ---------------------------------------------------------------------------
def _cfg():
    return dataclasses.replace(smoke_config("olmo-1b"), vocab_size=VOCAB)


def _req(cls, sid, toks):
    return cls(stream_id=sid, t=0.0, loc=(0.0, 0.0), subsamples=toks,
               acc=0.0, train_data=toks)


def _make_fleet(engine, job_cls=RetrainJob, req_cls=Request, *, jobs=3,
                members=2, seed0=80, init=None):
    out = []
    for j in range(jobs):
        rng = np.random.default_rng(100 + j)
        kw = dict(micro_steps=2, batch=4, seed=seed0 + j)
        if init is not None:
            kw["init_state_tree"] = init
        job = job_cls(engine, _req(req_cls, f"s{j}_0",
                                   rng.integers(0, VOCAB, (8, SEQ))), **kw)
        for m in range(1, members):
            job.add_member(_req(req_cls, f"s{j}_{m}",
                                rng.integers(0, VOCAB, (8, SEQ))))
        out.append(job)
    return out


def _canon(jobs, trace):
    name = {j.job_id: f"g{i}" for i, j in enumerate(jobs)}
    return ([name[x] for x in trace.order],
            {name[k]: v for k, v in trace.acc.items()},
            {name[k]: v for k, v in trace.shares.items()},
            {name[k]: v for k, v in trace.gpu_time.items()})


@pytest.mark.parametrize("alloc_cls", [alloc.ECCOAllocator,
                                       alloc.UniformAllocator])
def test_allocator_decisions_identical_batched_vs_scalar(alloc_cls):
    """tests/test_trainer_bank.py's test of the same name, on the port:
    the batched fleet calls and the scalar per-job loop decide alike."""
    fast = _make_fleet(SharedEngine(_cfg(), device="cpu"))
    slow = _make_fleet(SharedEngine(_cfg(), batched=False, device="cpu"))
    assert _canon(fast, alloc_cls().run_window(fast, window_micro=7)) == \
        _canon(slow, alloc_cls().run_window(slow, window_micro=7))


def test_allocator_decisions_identical_device_vs_host_bank():
    """The allocator tail of tests/test_trainer_bank.py's residency
    parity: the resident and the host-resident bank decide alike."""
    dev = _make_fleet(SharedEngine(_cfg(), device="cpu"))
    host = _make_fleet(SharedEngine(_cfg(), resident=False, device="cpu"))
    assert _canon(dev, alloc.ECCOAllocator().run_window(dev, 9)) == \
        _canon(host, alloc.ECCOAllocator().run_window(host, 9))


def test_real_jobs_decide_as_the_reference():
    """RetrainJobs of both packages from one bridged state, fp32 compute:
    Alg. 1's order, accuracies (Python floats, bit for bit), shares and
    GPU time equal the reference's."""
    jeng = jtrainer.SharedEngine(
        dataclasses.replace(jax_smoke_config("olmo-1b"), vocab_size=VOCAB),
        JTrainConfig(**FP32))
    jstate = jeng.fresh_state(0)
    teng = SharedEngine(_cfg(), TrainConfig(**FP32), device="cpu",
                        init_params={0: jax.tree.map(np.asarray,
                                                     jstate["params"])})
    jjobs = _make_fleet(jeng, jtrainer.RetrainJob, JRequest, init=jstate)
    tjobs = _make_fleet(teng, init=teng.fresh_state(0))
    got = alloc.ECCOAllocator().run_window(tjobs, 7)
    want = jalloc.ECCOAllocator().run_window(jjobs, 7)
    assert _canon(tjobs, got) == _canon(jjobs, want)
    assert all(type(a) is float for v in got.acc.values() for a in v)
