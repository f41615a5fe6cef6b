"""The port's JobBank under a fleet mesh, restating BANK_PARITY and the
shard-span test of tests/test_distributed_plane.py in one process.

An 8-entry CPU mesh (`make_fleet_mesh(8, devices=["cpu"] * 8)`, one
device repeated) stands in for the reference's forced 8-device host: the
bank's slot stack is then eight `BlockRows` blocks, each job trains and
evaluates on its own block. Held bit for bit against the same fleet on an
unsharded bank: batched train / eval with churn (a job dies mid-fleet,
one joins), fp32 and bf16 screens, every state leaf; a re-mesh from 8 to
4 blocks; `invalidate_device` zeroing every row and `restore_job`
bringing each back from a checkpoint; the transmission plane's
`decide_many` over `shard_spans` against the global call.
"""
import dataclasses
import gc

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.core.grouping import Request  # noqa: E402
from repro_torch.core.trainer import RetrainJob, SharedEngine  # noqa: E402
from repro_torch.core.transmission import (  # noqa: E402
    FleetTransmissionPlane, ProfileTable, SamplingConfig)
from repro_torch.distributed import checkpoint as ckpt  # noqa: E402
from repro_torch.distributed.sharding import BlockRows  # noqa: E402
from repro_torch.launch.mesh import make_fleet_mesh  # noqa: E402
from repro_torch.models.param import tree_leaves  # noqa: E402

VOCAB = 64
CPU8 = ["cpu"] * 8


def _req(sid, toks):
    return Request(stream_id=sid, t=0.0, loc=(0.0, 0.0), subsamples=toks,
                   acc=0.0, train_data=toks)


def _engine(mesh=None):
    cfg = dataclasses.replace(smoke_config("olmo-1b"), vocab_size=VOCAB)
    return SharedEngine(cfg, device="cpu", mesh=mesh)


def _leaves(state):
    return [np.asarray(x) for x in tree_leaves(state)]


def _drive(mesh):
    """BANK_PARITY's fleet: six jobs, one micro-window, job 2 dies and a
    job joins, another micro-window, then fp32 and bf16 evals."""
    eng = _engine(mesh)
    rng = np.random.default_rng(0)
    jobs = [RetrainJob(eng, _req(f"s{i}", rng.integers(0, VOCAB, (8, 32))),
                       micro_steps=2, batch=4, seed=i) for i in range(6)]
    eng.train_micro_many(jobs)
    jobs[2].release()
    del jobs[2]
    jobs.append(RetrainJob(eng, _req("s9", rng.integers(0, VOCAB, (8, 32))),
                           micro_steps=2, batch=4, seed=9))
    eng.train_micro_many(jobs)
    accs = eng.eval_jobs(jobs)
    bf16 = eng.eval_jobs(jobs, precision="bf16")
    return eng, jobs, accs, bf16


@pytest.fixture(scope="module")
def runs():
    return _drive(None), _drive(make_fleet_mesh(8, devices=CPU8))


def test_sharded_bank_train_eval_churn_parity(runs):
    (_, ja, acc_a, bf_a), (eng, jb, acc_b, bf_b) = runs
    assert acc_a == acc_b
    assert bf_a == bf_b
    for x, y in zip(ja, jb):
        for la, lb in zip(_leaves(x.state), _leaves(y.state)):
            np.testing.assert_array_equal(la, lb)
    bank = eng.bank
    assert bank.capacity % 8 == 0
    assert all(isinstance(x, BlockRows) and len(x.blocks) == 8
               for x in bank._dev)


def test_bank_blocks_hold_their_rows(runs):
    (_, _, _, _), (eng, jobs, _, _) = runs
    bank = eng.bank
    per = bank.capacity // 8
    for j in jobs:
        idx = j._slot.idx
        b, r = divmod(idx, per)
        leaf = bank._dev[0]
        assert leaf.locate(idx) == (b, r)
        assert torch.equal(leaf[idx], leaf.blocks[b][r])
        assert bank.slot_device(idx) == torch.device("cpu")


def test_place_on_remesh_8_to_4_keeps_every_row(runs):
    (_, ja, acc_a, _), _ = runs
    eng, jobs, _, _ = _drive(make_fleet_mesh(8, devices=CPU8))
    before = [_leaves(j.state) for j in jobs]
    eng.bank.place_on(make_fleet_mesh(4, devices=CPU8))
    assert all(len(x.blocks) == 4 for x in eng.bank._dev)
    assert eng.bank.capacity % 4 == 0
    for j, want in zip(jobs, before):
        for a, b in zip(_leaves(j.state), want):
            np.testing.assert_array_equal(a, b)
    assert eng.eval_jobs(jobs) == acc_a
    eng.train_micro_many(jobs)           # trains on, under the new mesh
    eng.bank.place_on(None)              # and detaches
    assert all(isinstance(x, torch.Tensor) for x in eng.bank._dev)
    eng2, jobs2, _, _ = _drive(None)
    eng2.train_micro_many(jobs2)
    for x, y in zip(jobs, jobs2):
        for a, b in zip(_leaves(x.state), _leaves(y.state)):
            np.testing.assert_array_equal(a, b)


def test_invalidate_device_then_restore_job(tmp_path):
    eng, jobs, accs, _ = _drive(make_fleet_mesh(8, devices=CPU8))
    bank = eng.bank
    for k, j in enumerate(jobs):
        ckpt.save(str(tmp_path), k, j.state, extra={"job": j.job_id})
    want = [_leaves(j.state) for j in jobs]
    bank.invalidate_device()
    assert not bank._dev_ok.any()
    assert all(not b.any() for x in bank._dev for b in x.blocks)
    for k, j in enumerate(jobs):
        assert ckpt.restore_job(str(tmp_path), k, j) == {"job": j.job_id}
    live = len(bank)
    # every row valid again: restored tensors on the bank's device (the
    # CPU here) are written on the device, host values through the mirror
    assert (bank._host_ok | bank._dev_ok)[:live].all()
    assert eng.eval_jobs(jobs) == accs
    assert bank._dev_ok[:live].all()
    for j, w in zip(jobs, want):
        for a, b in zip(_leaves(bank.row_device(j._slot.idx)), w):
            np.testing.assert_array_equal(np.asarray(a), b)


def test_growth_and_compaction_keep_equal_blocks():
    mesh = make_fleet_mesh(3, devices=CPU8)
    eng = _engine(mesh)
    rng = np.random.default_rng(5)
    jobs = [RetrainJob(eng, _req(f"s{i}", rng.integers(0, VOCAB, (4, 32))),
                       micro_steps=1, batch=2, seed=i) for i in range(7)]
    bank = eng.bank
    assert bank.capacity % 3 == 0 and bank.capacity >= 7
    want = {j.job_id: _leaves(j.state) for j in jobs}
    del jobs[1], jobs[3]
    gc.collect()
    bank.compact()
    assert len(bank) == 5
    for j in jobs:
        for a, b in zip(_leaves(j.state), want[j.job_id]):
            np.testing.assert_array_equal(a, b)


def test_read_template_is_meta(runs):
    (_, _, _, _), (eng, jobs, _, _) = runs
    tmpl = jobs[0].state_template
    got, want = tree_leaves(tmpl), tree_leaves(jobs[0].state)
    assert all(t.device.type == "meta" for t in got)
    assert [tuple(t.shape) for t in got] == [np.shape(w) for w in want]


def test_decide_many_shard_span_parity():
    """Concatenating decide_many over the plane's per-device row spans
    equals the global call row for row: the transmission plane's
    decisions are shard-local (tests/test_distributed_plane.py)."""
    table = ProfileTable([SamplingConfig(8, 32), SamplingConfig(4, 32),
                          SamplingConfig(2, 32)])
    plane = FleetTransmissionPlane(table, bytes_per_token=1.0,
                                   mesh=make_fleet_mesh(4, devices=CPU8))
    rng = np.random.default_rng(0)
    n = 24
    for i in range(n):
        plane.add_flow(f"f{i}")
    kw = dict(budget_levels=[0] * n,
              token_budgets=rng.uniform(32, 2048, n),
              p_shares=rng.uniform(0, 1, n),
              n_members=rng.integers(1, 5, n),
              achieved_bw=rng.uniform(0, 64, n),
              window_seconds=10.0)
    full = plane.decide_many(**kw)
    spans = plane.shard_spans()
    assert [hi - lo for lo, hi in spans] == [plane._rows.capacity // 4] * 4
    assert spans[0][0] == 0 and spans[-1][1] == plane._rows.capacity
    for field in ("rate", "resolution", "scaled_rate", "deliverable",
                  "delivered"):
        parts = []
        for lo, hi in spans:
            lo, hi = min(lo, n), min(hi, n)
            if lo == hi:
                continue
            sub = plane.decide_many(**{
                k: (v if np.isscalar(v) else np.asarray(v)[lo:hi])
                for k, v in kw.items()})
            parts.append(getattr(sub, field))
        np.testing.assert_array_equal(np.concatenate(parts),
                                      getattr(full, field))
    plane.set_mesh(make_fleet_mesh(3, devices=CPU8))
    assert plane._rows.capacity % 3 == 0 and len(plane.shard_spans()) == 3
