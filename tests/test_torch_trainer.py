"""The port's training plane (JobBank, TokenRingPool, SharedEngine,
RetrainJob), restating tests/test_trainer_bank.py against the port's own
classes, plus checks against the JAX package.

The batched paths must be BIT-IDENTICAL to the per-job loop — same
float32 per-member accuracies, same SGD trajectories (same rng draws per
job, same batch order) — so the decisions they feed are pinned.
`SharedEngine(batched=False)` is the scalar reference twin: the same
model config and seeds give the same initial states.

`test_checkpoint_restore_writes_through_cache` is restated in
tests/test_torch_checkpoint.py, beside the port's checkpoints, and the
bank under a fleet mesh in tests/test_torch_distributed_bank.py.
`test_allocator_decisions_identical_batched_vs_scalar` and the allocator
tail of `test_residency_parity_across_churn` are in
tests/test_torch_allocator.py, beside the port's allocator.
"""
import dataclasses
import gc

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import smoke_config as jax_smoke_config  # noqa: E402
from repro.configs.base import TrainConfig as JTrainConfig  # noqa: E402
from repro.core import trainer as jtrainer  # noqa: E402
from repro.core.grouping import Request as JRequest  # noqa: E402
from repro.train import train_step as jts  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.configs.base import TrainConfig  # noqa: E402
from repro_torch.core import batching  # noqa: E402
from repro_torch.core.grouping import Grouper, Request  # noqa: E402
from repro_torch.core.trainer import (JobBank, RetrainJob,  # noqa: E402
                                      SharedEngine, TokenRingPool)
from repro_torch.models.convert import params_from_numpy  # noqa: E402

VOCAB = 64
SEQ = 16
FP32 = dict(learning_rate=1e-3, b2=0.999, weight_decay=0.0, warmup_steps=5,
            total_steps=100000, remat="none", compute_dtype="float32")


def _cfg():
    return dataclasses.replace(smoke_config("olmo-1b"), vocab_size=VOCAB)


@pytest.fixture(scope="module")
def engines():
    return (SharedEngine(_cfg(), device="cpu"),
            SharedEngine(_cfg(), batched=False, device="cpu"))


@pytest.fixture(scope="module")
def host_engine():
    """Batched engine on the HOST-resident bank — the residency-parity
    reference twin."""
    return SharedEngine(_cfg(), resident=False, device="cpu")


def _req(sid, toks, acc=0.0, t=0.0, loc=(0.0, 0.0)):
    return Request(stream_id=sid, t=t, loc=loc, subsamples=toks, acc=acc,
                   train_data=toks)


def _data(rng, n, seq=SEQ):
    return rng.integers(0, VOCAB, size=(n, seq))


def _make_fleet(engine, *, jobs=3, members=3, batch=4, micro=2, seed0=0):
    """Identically-seeded jobs on `engine`; rebuildable on the twin."""
    out = []
    for j in range(jobs):
        rng = np.random.default_rng(100 + j)
        job = RetrainJob(engine, _req(f"s{j}_0", _data(rng, 8)),
                         micro_steps=micro, batch=batch, seed=seed0 + j)
        for m in range(1, members):
            job.add_member(_req(f"s{j}_{m}", _data(rng, 8)))
        out.append(job)
    return out


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _states_equal(a, b) -> bool:
    la, lb = _leaves(a), _leaves(b)
    return len(la) == len(lb) and all(
        np.array_equal(np.asarray(x), np.asarray(y)) for x, y in zip(la, lb))


# ---------------------------------------------------------------------------
# TokenRingPool: row-budget eviction, ordering, purge
# ---------------------------------------------------------------------------
def test_ring_pool_matches_concat_order_under_capacity():
    rng = np.random.default_rng(0)
    pool = TokenRingPool(capacity_rows=64)
    entries = [rng.integers(0, 9, size=(n, 8)) for n in (3, 1, 5)]
    for i, e in enumerate(entries):
        pool.add(e, f"s{i}")
    np.testing.assert_array_equal(pool.rows(), np.concatenate(entries))
    assert pool.sources() == ["s0"] * 3 + ["s1"] * 1 + ["s2"] * 5


def test_ring_pool_evicts_by_rows_not_entries():
    """The kept/evicted boundary is exactly the newest `capacity` rows —
    an old entry can survive partially."""
    rng = np.random.default_rng(1)
    pool = TokenRingPool(capacity_rows=8)
    entries = [rng.integers(0, 9, size=(n, 4)) for n in (3, 4, 3)]
    for i, e in enumerate(entries):
        pool.add(e, f"s{i}")
    np.testing.assert_array_equal(pool.rows(), np.concatenate(entries)[-8:])
    assert pool.sources() == ["s0"] + ["s1"] * 4 + ["s2"] * 3
    assert len(pool) == 8


def test_ring_pool_oversized_entry_keeps_newest_rows():
    rng = np.random.default_rng(2)
    pool = TokenRingPool(capacity_rows=4)
    big = rng.integers(0, 9, size=(10, 4))
    pool.add(big, "s0")
    np.testing.assert_array_equal(pool.rows(), big[-4:])
    assert len(pool) == 4


def test_ring_pool_wraparound_stays_ordered():
    pool = TokenRingPool(capacity_rows=5)
    for i in range(7):        # 7 one-row entries through a 5-row ring
        pool.add(np.full((1, 3), i), f"s{i}")
    np.testing.assert_array_equal(pool.rows()[:, 0], [2, 3, 4, 5, 6])
    assert pool.sources() == [f"s{i}" for i in range(2, 7)]


def test_ring_pool_purge_preserves_survivor_order():
    pool = TokenRingPool(capacity_rows=6)
    pool.add(np.full((2, 3), 0), "a")
    pool.add(np.full((2, 3), 1), "b")
    pool.add(np.full((2, 3), 2), "a")
    pool.purge("a")
    np.testing.assert_array_equal(pool.rows()[:, 0], [1, 1])
    assert pool.sources() == ["b", "b"]
    pool.add(np.full((1, 3), 3), "c")      # still usable after purge
    np.testing.assert_array_equal(pool.rows()[:, 0], [1, 1, 3])


@pytest.mark.parametrize("capacity", [1, 7, 40])
def test_ring_pool_matches_reference_bit_for_bit(capacity):
    """A seeded sequence of adds (oversized ones included) and purges
    through both packages' pools: equal rows, dtype and tags at every
    step."""
    rng = np.random.default_rng(capacity)
    want, got = jtrainer.TokenRingPool(capacity), TokenRingPool(capacity)
    for step in range(60):
        if rng.random() < 0.2:
            sid = f"s{rng.integers(0, 4)}"
            want.purge(sid)
            got.purge(sid)
        else:
            n = int(rng.integers(1, capacity + 3))
            toks = rng.integers(0, 50_000, size=(n, 6)).astype(np.int32)
            sid = f"s{rng.integers(0, 4)}"
            want.add(toks, sid)
            got.add(toks, sid)
        assert len(got) == len(want) and got.seq == want.seq, step
        np.testing.assert_array_equal(got.rows(), want.rows())
        assert got.rows().dtype == want.rows().dtype
        assert got.sources() == want.sources(), step


def test_ingest_row_budget_boundary(engines):
    engine, _ = engines
    rng = np.random.default_rng(3)
    job = RetrainJob(engine, _req("s0", _data(rng, 2)), pool_rows=6)
    job.ingest(_data(rng, 3), "s1")
    job.ingest(_data(rng, 4), "s2")       # 9 rows -> oldest 3 evicted
    assert len(job.pool) == 6
    assert job._pool_src == ["s1", "s1", "s2", "s2", "s2", "s2"]


# ---------------------------------------------------------------------------
# JobBank: slot lifecycle, deferred free, swap-compaction
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("resident", [True, False])
def test_bank_read_write_roundtrip(engines, resident):
    engine, _ = engines
    bank = JobBank(engine, resident=resident)
    s0, s1 = engine.fresh_state(0), engine.fresh_state(1)
    a, b = bank.alloc(s0), bank.alloc(s1)
    assert _states_equal(bank.read(a.idx), s0)
    assert _states_equal(bank.read(b.idx), s1)
    bank.write(a.idx, bank.read(b.idx))          # a host write
    assert _states_equal(bank.read(a.idx), s1)
    bank.write(b.idx, s0)                        # a device-tensor write
    assert _states_equal(bank.read(b.idx), s0)


def test_bank_capacity_doubles(engines):
    engine, _ = engines
    bank = JobBank(engine, capacity=2)
    slots = [bank.alloc(engine.fresh_state(i)) for i in range(5)]
    assert bank.capacity >= 5
    for i, s in enumerate(slots):       # growth preserved every slot
        assert _states_equal(bank.read(s.idx), engine.fresh_state(i))


def test_bank_free_is_deferred_until_compact(engines):
    """free() must not move rows (it runs from GC finalizers at
    arbitrary points while batched callers hold captured indices);
    compact() does the swap."""
    engine, _ = engines
    bank = JobBank(engine)
    states = [engine.fresh_state(i) for i in range(3)]
    slots = [bank.alloc(s) for s in states]
    bank.free(slots[0])
    assert slots[0].dead and slots[0].idx == 0      # queued, row intact
    assert slots[2].idx == 2                        # nothing moved yet
    assert _states_equal(bank.read(slots[2].idx), states[2])
    bank.compact()
    assert slots[0].idx is None
    assert len(bank) == 2
    assert slots[2].idx == 0
    assert _states_equal(bank.read(slots[2].idx), states[2])
    assert _states_equal(bank.read(slots[1].idx), states[1])
    bank.free(slots[0])                             # idempotent
    bank.compact()
    assert len(bank) == 2


def test_mass_churn_compaction_resolves_swap_chains(engines):
    """Several queued deaths compact as ONE indexed device move; a swap
    CHAIN (the survivor moved into one hole becomes the move source for
    the next) must resolve to original rows, because the move's gather
    reads the pre-move stack."""
    engine, _ = engines
    bank = JobBank(engine)
    states = [engine.fresh_state(i) for i in range(6)]
    slots = [bank.alloc(s) for s in states]
    bank.read(0)                  # a host mirror for the round trip below
    bank.scatter(list(range(6)), bank.gather(list(range(6))))
    assert not bank._host_ok[:6].any()
    bank.free(slots[0])
    bank.free(slots[4])
    bank.compact()
    assert len(bank) == 4
    assert slots[5].idx == 0 and slots[0].idx is None
    for orig, slot in ((1, slots[1]), (2, slots[2]), (3, slots[3]),
                       (5, slots[5])):
        assert _states_equal(bank.read(slot.idx), states[orig]), orig


def test_use_after_release_raises(engines):
    engine, _ = engines
    rng = np.random.default_rng(11)
    job = RetrainJob(engine, _req("uar0", _data(rng, 4)))
    keep = job.state
    job.release()
    engine.bank.compact()
    with pytest.raises(ValueError, match="use-after-release"):
        job.state
    with pytest.raises(ValueError, match="use-after-release"):
        job.state = keep
    with pytest.raises(ValueError, match="use-after-release"):
        job.eval_on(_data(rng, 2))


def test_job_handle_gc_returns_slot(engines):
    engine, _ = engines
    rng = np.random.default_rng(4)
    gc.collect()
    engine.bank.compact()        # settle earlier tests' dead handles
    n0 = len(engine.bank)
    job = RetrainJob(engine, _req("gc0", _data(rng, 4)))
    assert len(engine.bank) == n0 + 1
    del job
    gc.collect()
    engine.bank.compact()
    assert len(engine.bank) == n0


def test_mesh_and_state_tree_mismatch_raise(engines, monkeypatch):
    """A mesh, refused until the bank could shard, is taken now (its
    capacity aligned to the mesh); one the machine cannot hold raises,
    and so does a state of another tree."""
    from repro_torch.launch.mesh import make_fleet_mesh
    engine, _ = engines
    mesh = make_fleet_mesh(3, devices=["cpu"] * 3)
    assert JobBank(engine, mesh=mesh).capacity == 6
    assert SharedEngine(_cfg(), device="cpu", mesh=mesh).bank.mesh is mesh
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        JobBank(engine, mesh=make_fleet_mesh(2))
    bank = JobBank(engine)
    bank.alloc(engine.fresh_state(0))
    with pytest.raises(ValueError, match="state tree mismatch"):
        bank.write(0, {"params": {}})


def test_serving_snapshot_survives_later_writes(engines):
    engine, _ = engines
    rng = np.random.default_rng(12)
    job = RetrainJob(engine, _req("snap", _data(rng, 8)), micro_steps=1,
                     batch=4, seed=3)
    snap = job.serving_snapshot()
    want = job.state["params"]
    job.train_micro()
    assert _states_equal(snap, want)
    assert not _states_equal(snap, job.state["params"])


# ---------------------------------------------------------------------------
# eval-plane parity: batched_accuracy / eval_pairs / eval_jobs
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_batched_accuracy_bit_identical_to_scalar(engines, precision):
    engine, _ = engines
    rng = np.random.default_rng(5)
    jobs = _make_fleet(engine, jobs=3, members=3)
    jobs.append(RetrainJob(engine, _req("solo", _data(rng, 8)), seed=9))
    pairs = [(j, m.subsamples) for j in jobs for m in j.members]
    batched = engine.eval_pairs(pairs, precision=precision)
    scalar = [j.eval_on(s, precision=precision) for j, s in pairs]
    assert batched == scalar                 # exact float equality
    jids = np.array([j._slot.idx for j, _ in pairs])
    toks = np.stack([np.asarray(s) for _, s in pairs])
    stack = engine.bank.params_stack_compute(
        {"fp32": torch.float32, "bf16": torch.bfloat16}[precision])
    accs = engine.batched_accuracy(stack, toks, jids, precision=precision)
    assert [float(a) for a in accs] == scalar


def test_eval_jobs_matches_scalar_eval(engines):
    engine, scalar_engine = engines
    jobs = _make_fleet(engine, jobs=3, members=2)
    ref = [float(np.mean([j.eval_on(m.subsamples) for m in j.members]))
           for j in jobs]
    assert engine.eval_jobs(jobs) == ref
    assert [j.eval() for j in jobs] == ref
    twin = _make_fleet(scalar_engine, jobs=3, members=2)
    assert [j.eval() for j in twin] == ref


def test_eval_parity_on_just_compacted_slot(engines):
    engine, _ = engines
    jobs = _make_fleet(engine, jobs=3, members=2, seed0=20)
    ref = {j.job_id: [j.eval_on(m.subsamples) for m in j.members]
           for j in jobs}
    victim = jobs.pop(1)
    victim.release()                 # queued; compacted inside eval_pairs
    pairs = [(j, m.subsamples) for j in jobs for m in j.members]
    assert engine.eval_pairs(pairs) == \
        [a for j in jobs for a in ref[j.job_id]]


def test_mixed_sample_shapes_batch_per_shape(engines):
    engine, _ = engines
    rng = np.random.default_rng(6)
    jobs = _make_fleet(engine, jobs=2, members=1, seed0=30)
    pairs = [(jobs[0], _data(rng, 8)), (jobs[1], _data(rng, 4)),
             (jobs[0], _data(rng, 4)), (jobs[1], _data(rng, 8))]
    assert engine.eval_pairs(pairs) == [j.eval_on(s) for j, s in pairs]


def test_probe_accepts_bank_jobs_and_rejects_the_scalar_twin(engines):
    engine, scalar_engine = engines
    fast = _make_fleet(engine, jobs=2, members=1, seed0=50)
    slow = _make_fleet(scalar_engine, jobs=2, members=1, seed0=50)
    assert batching.shared_engine(fast) is engine
    assert batching.shared_engine(slow) is None
    assert batching.shared_engine(fast + slow) is None


# ---------------------------------------------------------------------------
# train-plane parity: train_micro_many vs sequential train_micro
# ---------------------------------------------------------------------------
def test_train_micro_many_bit_identical_to_sequential(engines):
    """Identical states after N micro-windows under identical rng, for
    full-batch jobs and a straggler (pool < batch)."""
    engine, scalar_engine = engines
    fast = _make_fleet(engine, jobs=4, members=2, batch=4, seed0=40)
    slow = _make_fleet(scalar_engine, jobs=4, members=2, batch=4, seed0=40)
    straggler_data = _data(np.random.default_rng(7), 2)   # 2 rows < 4
    fast.append(RetrainJob(engine, _req("st", straggler_data),
                           micro_steps=2, batch=4, seed=77))
    slow.append(RetrainJob(scalar_engine, _req("st", straggler_data),
                           micro_steps=2, batch=4, seed=77))
    for _ in range(3):                      # N micro-windows
        mets = engine.train_micro_many(fast)
        for f, s in zip(fast, slow):
            want = s.train_micro()
            assert torch.equal(mets[f.job_id]["loss"], want["loss"])
    for f, s in zip(fast, slow):
        assert _states_equal(f.state, s.state), f.job_id
        assert f.gpu_time == s.gpu_time == 3
    pairs_f = [(j, m.subsamples) for j in fast for m in j.members]
    pairs_s = [(j, m.subsamples) for j in slow for m in j.members]
    assert engine.eval_pairs(pairs_f) == [j.eval_on(s) for j, s in pairs_s]


def test_train_micro_many_skips_empty_pools(engines):
    engine, _ = engines
    rng = np.random.default_rng(8)
    job = RetrainJob(engine, Request(stream_id="e0", t=0.0, loc=(0, 0),
                                     subsamples=_data(rng, 4), acc=0.0))
    assert len(job.pool) == 0
    before = job.state
    assert engine.train_micro_many([job]) == {}
    assert job.gpu_time == 0
    assert _states_equal(job.state, before)


def test_mid_window_job_death_leaves_survivors_intact(engines):
    engine, scalar_engine = engines
    fast = _make_fleet(engine, jobs=4, members=2, seed0=60)
    slow = _make_fleet(scalar_engine, jobs=4, members=2, seed0=60)
    engine.train_micro_many(fast)
    for j in slow:
        j.train_micro()
    del fast[1], slow[1]
    gc.collect()
    engine.train_micro_many(fast)           # compacts, then trains
    for j in slow:
        j.train_micro()
    for f, s in zip(fast, slow):
        assert _states_equal(f.state, s.state), f.job_id
    pairs = [(j, m.subsamples) for j in fast for m in j.members]
    assert engine.eval_pairs(pairs) == \
        [j.eval_on(m.subsamples) for j in slow for m in j.members]


# ---------------------------------------------------------------------------
# residency: device-resident slot cache vs host-resident bank
# ---------------------------------------------------------------------------
def test_residency_parity_across_churn(engines, host_engine):
    """Device- and host-resident banks give bit-identical eval/train
    results through a mid-window death, an explicit release and a new
    job in the recycled row."""
    dev_e, _ = engines
    dev = _make_fleet(dev_e, jobs=5, members=2, seed0=200)
    host = _make_fleet(host_engine, jobs=5, members=2, seed0=200)

    def window(tag):
        dev_e.train_micro_many(dev)
        host_engine.train_micro_many(host)
        pd = [(j, m.subsamples) for j in dev for m in j.members]
        ph = [(j, m.subsamples) for j in host for m in j.members]
        assert dev_e.eval_pairs(pd) == host_engine.eval_pairs(ph), tag
        assert dev_e.eval_pairs(pd, precision="bf16") == \
            host_engine.eval_pairs(ph, precision="bf16"), tag

    window("warm")
    del dev[1], host[1]
    gc.collect()
    window("after-death")
    dev.pop(2).release()
    host.pop(2).release()
    data = _data(np.random.default_rng(9), 8)
    dev.append(RetrainJob(dev_e, _req("rnew", data), micro_steps=2,
                          batch=4, seed=300))
    host.append(RetrainJob(host_engine, _req("rnew", data), micro_steps=2,
                           batch=4, seed=300))
    window("after-recycle")
    for d, h in zip(dev, host):
        assert _states_equal(d.state, h.state)


def test_batched_calls_zero_per_member_transfers(engines):
    engine, _ = engines
    gc.collect()
    engine.bank.compact()
    jobs = _make_fleet(engine, jobs=4, members=3, seed0=400)
    pairs = [(j, m.subsamples) for j in jobs for m in j.members]
    engine.eval_pairs(pairs)
    engine.train_micro_many(jobs)
    s = engine.bank.stats
    s.reset()
    engine.eval_pairs(pairs)
    engine.eval_pairs(pairs, precision="bf16")
    engine.train_micro_many(jobs)
    engine.eval_jobs(jobs)
    assert (s.h2d_syncs, s.d2h_syncs) == (0, 0)
    assert (s.h2d_bytes, s.d2h_bytes) == (0, 0)


def test_host_reads_sync_lazily_and_cache(engines):
    engine, _ = engines
    jobs = _make_fleet(engine, jobs=4, members=2, seed0=420)
    engine.train_micro_many(jobs)    # rows now device-authoritative
    s = engine.bank.stats
    s.reset()
    st = jobs[0].state
    assert s.d2h_syncs == 1
    assert s.d2h_bytes == engine.bank.state_row_nbytes
    assert _states_equal(st, jobs[0].state)     # mirror hit: no new sync
    assert s.d2h_syncs == 1
    engine.train_micro_many(jobs)
    assert s.h2d_syncs == 0          # trained on resident rows directly
    jobs[0].state
    assert s.d2h_syncs == 2


def test_host_write_visible_to_fleet_calls(engines):
    """A host-side state write (`job.state = ...`) reaches the resident
    stack via the next batched entry point's shared flush — ONE h2d
    sync — and the fleet call scores the new state bit-identically."""
    engine, _ = engines
    a, b = _make_fleet(engine, jobs=2, members=1, seed0=440)
    data = a.members[0].subsamples
    engine.train_micro_many([a])     # make a's state distinct from b's
    ref = a.eval_on(data)
    b.state = a.state
    s = engine.bank.stats
    s.reset()
    assert engine.eval_pairs([(b, data)]) == [ref]
    assert s.h2d_syncs == 1
    assert s.h2d_bytes == engine.bank.state_row_nbytes


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------
def test_train_micro_and_eval_on_match_jax():
    """One RetrainJob micro-window from the same bridged state and seed:
    each step's batch is drawn by the job's rng in the same order, the
    step losses agree within 1e-4 (fp32 compute), and eval_on after the
    window gives the same accuracy bit for bit (the same hits, the mean
    rounded as XLA rounds it)."""
    jcfg = dataclasses.replace(jax_smoke_config("olmo-1b"),
                               vocab_size=VOCAB)
    jeng = jtrainer.SharedEngine(jcfg, JTrainConfig(**FP32))
    teng = SharedEngine(_cfg(), TrainConfig(**FP32), device="cpu")
    jstate = jeng.fresh_state(0)
    bridged = params_from_numpy(jax.tree.map(np.asarray, jstate),
                                device="cpu")
    rng = np.random.default_rng(13)
    data, subs = _data(rng, 12), _data(rng, 8)
    kw = dict(micro_steps=3, batch=4, seed=21)
    jjob = jtrainer.RetrainJob(jeng, JRequest(
        stream_id="a", t=0.0, loc=(0.0, 0.0), subsamples=subs, acc=0.0,
        train_data=data), init_state_tree=jstate, **kw)
    tjob = RetrainJob(teng, _req("a", data), init_state_tree=bridged, **kw)
    tjob.members[0].subsamples = subs
    jjob.train_micro()
    got = tjob.train_micro()["loss"]
    # the JAX losses of the same draws, step by step
    draw = np.random.default_rng(kw["seed"])
    batches = [{"inputs": jnp.asarray(t), "labels": jnp.asarray(t)}
               for t in (data[draw.integers(0, 12, size=4)]
                         for _ in range(3))]
    step = jax.jit(jts.make_train_step(jeng.model, jeng.tcfg,
                                       distill_weight=1.0))
    st, want = jstate, []
    for b in batches:
        st, met = step(st, b)
        want.append(float(met["loss"]))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)
    assert _states_equal(jjob.state["opt"]["count"],
                         tjob.state["opt"]["count"])
    assert tjob.eval_on(subs) == jjob.eval_on(subs)
    assert teng.eval_jobs([tjob]) == jeng.eval_jobs([jjob])


def _hits(rng, rows, cols, rate):
    return (rng.random((rows, cols)) < rate).astype(np.float32)


@pytest.mark.parametrize("cols", [31, 63, 255])
def test_accuracy_mean_rounds_as_xla(cols):
    """The hit mean is the exact count times fp32(1/n), as XLA computes
    `jnp.mean`: equal on every case, scalar and per member, where the
    old `torch.mean` (count / n) misses the last bit in some."""
    from repro_torch.core.trainer import _hit_mean
    rng = np.random.default_rng(cols)
    per_member = jax.jit(lambda h: jnp.mean(h.reshape(-1, 8, cols),
                                            axis=(1, 2)))
    old_misses = 0
    for rows in (1, 2, 8, 16, 64):
        for rate in (0.01, 0.1, 0.3, 0.5, 0.7, 0.9, 0.99):
            h = _hits(rng, rows, cols, rate)
            want = np.float32(jnp.mean(h))
            assert _hit_mean(h.sum(), h.size) == want
            old_misses += float(torch.mean(torch.from_numpy(h))) != want
            if rows % 8 == 0:
                count = h.reshape(-1, 8, cols).sum(axis=(1, 2))
                np.testing.assert_array_equal(_hit_mean(count, 8 * cols),
                                              per_member(h))
    assert old_misses > 0


def test_engine_accuracies_equal_jax_bit_for_bit():
    """accuracy, batched_accuracy (members padded to 8) and eval_pairs on
    bridged weights: the reference's floats, bit for bit."""
    jcfg = dataclasses.replace(jax_smoke_config("olmo-1b"),
                               vocab_size=VOCAB)
    jeng = jtrainer.SharedEngine(jcfg, JTrainConfig(**FP32))
    jparams = jax.tree.map(np.asarray, jeng.fresh_state(0)["params"])
    teng = SharedEngine(_cfg(), TrainConfig(**FP32), device="cpu",
                        init_params={0: jparams})
    tparams = teng.fresh_state(0)["params"]
    rng = np.random.default_rng(4)
    # a sharp, repetitive stream: a random model hits some of it
    base = rng.integers(0, VOCAB, 8)
    for rows in (1, 3, 16):
        toks = np.tile(base, (rows, 4))[:, :SEQ + 1]
        toks[rng.random(toks.shape) < 0.3] = 0
        assert teng.accuracy(tparams, toks) == jeng.accuracy(jparams, toks)
    stack = jax.tree.map(lambda x: x[None], jparams)
    tstack = params_from_numpy(stack, device="cpu")
    toks = np.stack([np.tile(base, (4, 4))[:, :SEQ] for _ in range(5)])
    toks[rng.random(toks.shape) < 0.2] = 1
    np.testing.assert_array_equal(
        teng.batched_accuracy(tstack, toks, np.zeros(5, np.int64)),
        jeng.batched_accuracy(stack, toks, np.zeros(5, np.int64)))


def _grouper_replay(engine):
    """Clustered requests with real RetrainJobs, a micro-window of
    training and periodic update_grouping; returns the events with job
    ids renamed by creation order, and the number of batched eval_pairs
    calls the grouper made."""
    rng = np.random.default_rng(17)
    seeds = iter(range(1000))
    names = {}
    calls = [0]
    inner = engine.eval_pairs

    def counting(pairs, **kw):
        calls[0] += 1
        return inner(pairs, **kw)
    engine.eval_pairs = counting

    def new_job(req):
        job = RetrainJob(engine, req, micro_steps=1, batch=4,
                         seed=next(seeds))
        names[job.job_id] = f"g{len(names)}"
        return job
    g = Grouper(eps_t=6.0, delta_loc=30.0, p_drop=0.05, new_job_fn=new_job)
    jobs = []
    try:
        for i in range(24):
            toks = _data(rng, 8)
            g.group_request(jobs, Request(
                stream_id=f"s{i}", t=float(rng.integers(0, 12)),
                loc=(float(rng.integers(0, 3) * 25), 0.0), subsamples=toks,
                acc=float(rng.random() * 0.04), train_data=toks))
            if i % 8 == 7:
                engine.train_micro_many(jobs)
                g.update_grouping(jobs, now=20.0 + i)
    finally:
        del engine.eval_pairs
    events = [(e["kind"], e["stream"], names[e["job"]]) for e in g.events]
    return events, calls[0]


def test_grouper_replay_batched_equals_scalar_engine():
    """The grouper's batched eval path (one eval_pairs call per request
    and per window end) gives the scalar eval_on loop's events."""
    fast, fast_calls = _grouper_replay(SharedEngine(_cfg(), device="cpu"))
    slow, slow_calls = _grouper_replay(
        SharedEngine(_cfg(), batched=False, device="cpu"))
    assert fast == slow
    assert {k for k, _, _ in fast} >= {"new", "join"}
    assert fast_calls > 0 and slow_calls == 0
