"""The port's grouping plane held to the JAX package.

`ops.pairwise_js` is held to the JAX Pallas kernel (interpret mode) and to
its oracle on the sweep of tests/test_kernels.py. `SignatureIndex`,
`Grouper`, `RowRegistry` and the batching probe replay the same requests
as the reference's (the `_run_scenario` of tests/test_grouping.py) and
must give equal partitions and event lists. State carried from the
reference's drift detector and index into the port gives equal next-window
results. On the CPU the kernel wrappers compute their plain versions; the
`gpu`-marked test and `chip_smoke.py` hold the CUDA kernel to it on the
card.
"""
import copy
import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.core import batching as jbatch  # noqa: E402
from repro.core import drift as jdrift  # noqa: E402
from repro.core import grouping as jgroup  # noqa: E402
from repro.core import rows as jrows  # noqa: E402
from repro.core import signature_index as jsig  # noqa: E402
from repro.data import streams as jstreams  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch.core import batching as tbatch  # noqa: E402
from repro_torch.core import drift as tdrift  # noqa: E402
from repro_torch.core import grouping as tgroup  # noqa: E402
from repro_torch.core import rows as trows  # noqa: E402
from repro_torch.core import signature_index as tsig  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels.pairwise_js import pairwise_js  # noqa: E402

PJS_TOL = 1e-5                       # tests/test_kernels.py

# the sweep of tests/test_kernels.py: (N, M, B)
SWEEP = [(3, 5, 64), (1, 7, 64), (9, 1, 128), (17, 13, 128), (100, 73, 64)]


def _sweep_inputs(N, M, B, seed=0):
    rng = np.random.default_rng(seed)
    p = rng.random((N, B)).astype(np.float32)
    p[0, :] = 0.0                       # all-zero histogram edge case
    q = rng.random((M, B)).astype(np.float32)
    return p, q


def _port_pjs(p, q, impl="auto"):
    return tops.pairwise_js(torch.from_numpy(p), torch.from_numpy(q),
                            impl=impl).numpy()


# ---------------------------------------------------------------------------
# ops.pairwise_js against the JAX kernel and oracle
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("N,M,B", SWEEP)
@pytest.mark.parametrize("jax_impl", ["interpret", "ref"])
def test_pairwise_js_matches_jax(N, M, B, jax_impl):
    p, q = _sweep_inputs(N, M, B)
    want = np.asarray(jops.pairwise_js(p, q, impl=jax_impl))
    got = _port_pjs(p, q)
    assert got.shape == (N, M) and got.dtype == np.float32
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=PJS_TOL, rtol=0)


@pytest.mark.parametrize("impl", ["auto", "ref"])
def test_pairwise_js_empty_inputs(impl):
    p = np.ones((3, 64), np.float32)
    e = np.zeros((0, 64), np.float32)
    assert _port_pjs(p, e, impl).shape == (3, 0)
    assert _port_pjs(e, p, impl).shape == (0, 3)
    assert _port_pjs(e, e, impl).shape == (0, 0)


def test_pairwise_js_zero_capacity_rows_and_no_launch_on_cpu():
    """The index scores every capacity row, inactive all-zero ones
    included: they normalise to eps-uniform and stay finite, as in the
    reference's kernel. A CPU tensor launches nothing."""
    rng = np.random.default_rng(1)
    p = rng.random((2, 64)).astype(np.float32)
    q = np.zeros((16, 64), np.float32)
    q[:5] = rng.random((5, 64))
    before = pairwise_js.launches
    got = _port_pjs(p, q)
    assert pairwise_js.launches == before
    assert np.isfinite(got).all()
    np.testing.assert_allclose(
        got, np.asarray(jops.pairwise_js(p, q, impl="interpret")),
        atol=PJS_TOL, rtol=0)
    with pytest.raises(ValueError, match="impl"):
        _port_pjs(p, q, impl="xla")


# ---------------------------------------------------------------------------
# copied host modules: rows registry and batching probe
# ---------------------------------------------------------------------------
def test_row_registry_matches_reference_under_churn():
    rng = np.random.default_rng(3)
    regs = (jrows.RowRegistry(align=3), trows.RowRegistry(align=3))
    for step in range(300):
        sid = f"s{int(rng.integers(0, 40))}"
        op = rng.integers(0, 3)
        if op == 0:
            out = [r.add(sid) for r in regs]
        elif op == 1:
            out = [r.remove(sid) for r in regs]
        else:
            extra = int(rng.integers(0, 5))
            out = [r.reserve(extra) for r in regs]
        assert out[0] == out[1], step
        assert regs[0].ids == regs[1].ids
        assert regs[0].capacity == regs[1].capacity
        assert regs[0].shard_spans() == regs[1].shard_spans()
        assert regs[0].shard_counts() == regs[1].shard_counts()


def test_batching_probe_matches_reference_on_fakes():
    class Slot:
        idx = 0

    class Bank:
        def compact(self):
            pass
        sync_to_device = params_stack = compact

    class Engine:
        batched = True
        bank = Bank()

        def eval_jobs(self):
            pass
        eval_pairs = train_micro_many = eval_jobs

    class Job:
        def __init__(self, eng, precision=None):
            self.engine, self._slot, self.precision = eng, Slot(), precision

    e1, e2 = Engine(), Engine()
    jobs = [Job(e1), Job(e2, "bf16"), Job(None), Job(e1)]
    for sub in (jobs[:1], jobs[:2], jobs, [jobs[0], jobs[3]], []):
        assert tbatch.shared_engine(sub) is jbatch.shared_engine(sub)
    assert [(g is None, ix) for g, ix in tbatch.engine_groups(jobs)] == \
        [(g is None, ix) for g, ix in jbatch.engine_groups(jobs)]
    assert [tbatch.job_precision(j) for j in jobs] == \
        [jbatch.job_precision(j) for j in jobs]


# ---------------------------------------------------------------------------
# SignatureIndex + Grouper: equal decisions on equal requests
# ---------------------------------------------------------------------------
def _unit(key: str) -> float:
    """A deterministic number in [0, 1) from a string (no salted hash)."""
    return zlib.crc32(key.encode()) / 2 ** 32


class DetJob:
    """Deterministic eval_on keyed on (job, samples): replayable grouping
    decisions across grouper instances and processes."""

    def __init__(self, req, counter):
        self.job_id = f"dj{counter[0]}"
        counter[0] += 1
        self.members = [req]

    def eval_on(self, samples):
        return _unit(f"{self.job_id}/{samples}")

    def add_member(self, req):
        self.members.append(req)

    def remove_member(self, sid):
        self.members = [m for m in self.members if m.stream_id != sid]


def _run_scenario(mod, n_requests=60, eps_t=5.0, delta_loc=30.0,
                  acc_scale=0.5, **kw):
    """tests/test_grouping.py's clustered random requests with periodic
    update_grouping, through grouping module `mod` (the reference's or
    the port's); returns (partition, events, eval_on calls)."""
    rng = np.random.default_rng(7)
    counter = [0]
    calls = []

    class Counting(DetJob):
        def eval_on(self, samples):
            calls.append((self.job_id, samples))
            return super().eval_on(samples)

    g = mod.Grouper(eps_t=eps_t, delta_loc=delta_loc, p_drop=0.05,
                    new_job_fn=lambda r: Counting(r, counter), **kw)
    jobs = []
    for i in range(n_requests):
        req = mod.Request(
            stream_id=f"s{i}", t=float(rng.integers(0, 20)),
            loc=(float(rng.integers(0, 4) * 25),
                 float(rng.integers(0, 2) * 25)),
            subsamples=i, acc=float(rng.random() * acc_scale),
            sig=rng.random(64).astype(np.float32))
        g.group_request(jobs, req)
        if i % 10 == 9:
            g.update_grouping(jobs, now=req.t + 1.0)
    partition = sorted(sorted(m.stream_id for m in j.members) for j in jobs)
    events = [(e["kind"], e["stream"], e["job"]) for e in g.events]
    return partition, events, calls


@pytest.mark.parametrize("k", [0, 1, 2, 10_000])
@pytest.mark.parametrize("impl", ["auto", "ref"])
def test_grouper_with_index_matches_reference(k, impl):
    want = _run_scenario(jgroup, index=jsig.SignatureIndex(buckets=64),
                         shortlist_k=k)
    got = _run_scenario(tgroup, index=tsig.SignatureIndex(
        buckets=64, impl=impl, device="cpu"), shortlist_k=k)
    assert got == want


def test_grouper_python_scan_matches_reference():
    assert _run_scenario(tgroup) == _run_scenario(jgroup)


@pytest.mark.parametrize("k", [1, 2, 3])
def test_shortlist_decided_by_js_values(k):
    """Every job passes the (wide) prefilter, so more jobs pass than k and
    the JS values alone decide which k pay an eval_on: the port's
    shortlist must pick the reference's jobs request by request."""
    kw = dict(n_requests=40, eps_t=1e9, delta_loc=1e9, acc_scale=1.0,
              shortlist_k=k)
    want = _run_scenario(jgroup, index=jsig.SignatureIndex(buckets=64), **kw)
    got = _run_scenario(tgroup, index=tsig.SignatureIndex(
        buckets=64, device="cpu"), **kw)
    assert got == want
    full = _run_scenario(tgroup, index=tsig.SignatureIndex(
        buckets=64, device="cpu"), **dict(kw, shortlist_k=0))
    assert len(full[2]) > len(got[2])      # the shortlist did prune


def test_candidate_jobs_batch_matches_reference():
    rng = np.random.default_rng(11)
    ref_idx = jsig.SignatureIndex(buckets=16, capacity=8)
    port = tsig.SignatureIndex(buckets=16, capacity=8, device="cpu")
    for i in range(70):
        args = (f"s{i}", float(rng.integers(0, 10)),
                (float(rng.integers(0, 3) * 10), 0.0),
                rng.random(16).astype(np.float32))
        for idx in (ref_idx, port):
            idx.upsert(*args)
            idx.assign(f"s{i}", f"j{i % 9}")
    for idx in (ref_idx, port):
        idx.remove("s3")
        idx.unassign("s4")
        idx.refresh_sig("s5", np.ones(16, np.float32))
    assert port.capacity == ref_idx.capacity == 128
    R = 6
    kw = dict(ts=rng.integers(0, 10, R).astype(float),
              locs=[(float(x), 0.0) for x in rng.integers(0, 3, R) * 10],
              eps_t=4.0, delta_loc=15.0,
              exclude_jobs=[None, "j1", None, "j2", None, None],
              sigs=[rng.random(16).astype(np.float32) for _ in range(R)])
    for k in (0, 1, 2, 5):
        assert port.candidate_jobs_batch(k=k, **kw) == \
            ref_idx.candidate_jobs_batch(k=k, **kw)


def test_index_device_and_impl():
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tsig.SignatureIndex()
    with pytest.raises(ValueError, match="impl"):
        tsig.SignatureIndex(impl="xla", device="cpu")


# ---------------------------------------------------------------------------
# the signature block's mirror on the index's device
# ---------------------------------------------------------------------------
def _mirror_equal(idx):
    mirror = idx._sig_dev
    assert mirror is not None and mirror.dtype == torch.float32
    assert torch.equal(mirror.cpu(), torch.from_numpy(idx._sig))


def _churn_mirror(device):
    """upsert, refresh_sig, remove, growths, load_state_dict and rebuild,
    each followed by a shortlist call: after every call the mirror equals
    the host block; a call uploads the whole block exactly when it is the
    first or the block grew, was restored or rebuilt since the last one,
    and otherwise only the rows written since (one per signature write or
    removal)."""
    rng = np.random.default_rng(21)
    idx = tsig.SignatureIndex(buckets=16, capacity=8, device=device)
    stale, writes, snap = True, set(), None

    def shortlist():
        nonlocal stale
        before = (idx.full_uploads, idx.rows_uploaded)
        idx.candidate_jobs_batch([0.0], [(0.0, 0.0)], eps_t=1e9,
                                 delta_loc=1e9, k=2,
                                 sigs=[rng.random(16).astype(np.float32)])
        _mirror_equal(idx)
        want = (before[0] + 1, before[1]) if stale else \
            (before[0], before[1] + len(writes))
        assert (idx.full_uploads, idx.rows_uploaded) == want
        stale = False
        writes.clear()

    for step in range(150):
        sid = f"s{int(rng.integers(0, 50))}"
        op = int(rng.integers(0, 5))
        cap = idx.capacity
        if op <= 1:
            row = idx.upsert(sid, 0.0, (0.0, 0.0),
                             rng.random(16).astype(np.float32))
            idx.assign(sid, f"j{int(rng.integers(0, 5))}")
            writes.add(row)
        elif op == 2 and sid in idx._row:
            writes.add(idx._row[sid])
            idx.refresh_sig(sid, rng.random(16).astype(np.float32))
        elif op == 3 and sid in idx._row:
            writes.add(idx._row[sid])
            idx.remove(sid)
        elif op == 4:
            snap = idx.state_dict()
        if step == 100:
            idx.load_state_dict(snap)
            stale = True
        stale |= idx.capacity != cap
        if (idx._job >= 0).any():
            shortlist()
    assert idx.capacity >= 32               # grew at least 8 -> 16 -> 32
    jobs = [DetJob(tgroup.Request(stream_id="r0", t=0.0, loc=(0.0, 0.0),
                                  subsamples=0, acc=0.0,
                                  sig=np.ones(16, np.float32)), [0])]
    idx.rebuild(jobs)
    stale = True
    shortlist()
    shortlist()                             # nothing changed: no upload
    # state_dict is the host's, unchanged by the mirror
    assert set(idx.state_dict()) == {"sig", "has_sig", "t", "loc", "job",
                                     "active", "row", "free", "jobkey"}


def test_signature_mirror_matches_host_under_churn():
    _churn_mirror("cpu")


def _storm_uploads(device):
    """100 grouping requests through a Grouper whose index starts at
    capacity 8: one whole-block upload per capacity its shortlist calls
    saw (the first call's and one per growth), none per request beyond
    that; each request's own row goes up as a dirty row."""
    rng = np.random.default_rng(5)
    counter = [0]
    idx = tsig.SignatureIndex(buckets=64, capacity=8, device=device)
    g = tgroup.Grouper(eps_t=1e9, delta_loc=1e9, p_drop=0.05,
                       new_job_fn=lambda r: DetJob(r, counter), index=idx,
                       shortlist_k=2)
    jobs, seen = [], set()
    for i in range(100):
        g.group_request(jobs, tgroup.Request(
            stream_id=f"s{i}", t=0.0, loc=(0.0, 0.0), subsamples=i,
            acc=float(rng.random()), sig=rng.random(64).astype(np.float32)))
        if idx._sig_dev is not None:
            seen.add(idx._sig_dev.shape[0])
            _mirror_equal(idx)
    assert idx.capacity == 128
    assert seen == {16, 32, 64, 128} or seen == {8, 16, 32, 64, 128}
    assert idx.full_uploads == len(seen)
    assert 0 < idx.rows_uploaded <= 100


def test_requests_upload_the_block_once_per_growth():
    _storm_uploads("cpu")


@pytest.mark.gpu
def test_signature_mirror_on_the_card():
    """The mirror invariants with the index on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    _churn_mirror("cuda")
    _storm_uploads("cuda")


def _wrapper_bad(what):
    p = torch.rand((2, 64))
    q = torch.rand((5, 64))
    return {"device": (p, q.to("meta")),
            "dtype": (p.double(), q),
            "rank": (p[0], q),
            "buckets": (torch.rand((2, 32)), q),
            "too many buckets": (torch.rand((2, 1025)), torch.rand((5, 1025))),
            "no buckets": (torch.rand((2, 0)), torch.rand((5, 0))),
            "strided": (p, torch.rand((64, 5)).T)}[what]


@pytest.mark.parametrize("what,err", [
    ("device", ValueError), ("dtype", TypeError), ("rank", ValueError),
    ("buckets", ValueError), ("too many buckets", ValueError),
    ("no buckets", ValueError), ("strided", ValueError)])
def test_pairwise_js_wrapper_checks(what, err):
    """The checks the wrapper runs before a launch (on a CUDA tensor; here
    called directly, since a CPU tensor takes the plain version)."""
    from repro_torch.kernels import pairwise_js as pj_mod
    with pytest.raises(err):
        pj_mod._check(*_wrapper_bad(what))
    pj_mod._check(torch.rand((2, 64)), torch.rand((5, 64)))


def test_pairwise_js_rejects_unknown_device():
    meta = torch.empty((2, 64), device="meta")
    with pytest.raises(ValueError, match="no pairwise_js for device meta"):
        pairwise_js(meta, meta)


# ---------------------------------------------------------------------------
# state carried from the reference into the port
# ---------------------------------------------------------------------------
def _window(mod, det, grouper, jobs, ids, toks, now, subs):
    """One drift -> grouping window of the controller's shape: observe,
    send each triggered stream as a request signed with its live
    histogram, then the window-end regroup."""
    trig = det.observe(ids, toks)
    for sid in trig:
        grouper.group_request(jobs, mod.Request(
            stream_id=sid, t=now, loc=subs[sid][0],
            subsamples=f"{sid}@{now}", acc=subs[sid][1],
            sig=det.hist(sid)))
    grouper.update_grouping(jobs, now=now + 1.0)
    return trig


def test_state_carry_over_gives_equal_next_window():
    """Reference detector and index run two windows; their state_dicts
    load into the port; a third window on both gives equal triggers,
    scores, events and partitions."""
    _, streams = jstreams.make_fleet(vocab=64, regions=3,
                                     streams_per_region=4, dim=4,
                                     switch_times=(5.0, 15.0), seed=2)
    ids = [s.stream_id for s in streams]
    wins = [np.stack([s.sample(10.0 * w, 8, 32) for s in streams])
            for w in range(4)]
    subs = {s.stream_id: (s.loc, 0.3 * _unit(s.stream_id)) for s in streams}

    def grouper(mod, index, counter):
        return mod.Grouper(eps_t=30.0, delta_loc=50.0, p_drop=0.2,
                           new_job_fn=lambda r: DetJob(r, counter),
                           index=index, shortlist_k=1)

    thr = 0.12
    jdet = jdrift.FleetDriftDetector(threshold=thr, buckets=64, vocab=64,
                                     impl="xla")
    jidx = jsig.SignatureIndex(buckets=64)
    jcount = [0]
    jg, jjobs = grouper(jgroup, jidx, jcount), []
    jdet.set_references(ids, wins[0])
    fired = [_window(jgroup, jdet, jg, jjobs, ids, wins[w], 10.0 * w, subs)
             for w in (1, 2)]
    assert any(fired)

    tdet = tdrift.FleetDriftDetector(threshold=thr, buckets=64, vocab=64,
                                     impl="auto", device="cpu")
    tdet.load_state_dict(jdet.state_dict())
    tidx = tsig.SignatureIndex(buckets=64, device="cpu")
    tidx.load_state_dict(jidx.state_dict())
    tg, tjobs = grouper(tgroup, tidx, list(jcount)), copy.deepcopy(jjobs)
    tg.events = copy.deepcopy(jg.events)
    n_ev = len(jg.events)

    want = _window(jgroup, jdet, jg, jjobs, ids, wins[3], 30.0, subs)
    got = _window(tgroup, tdet, tg, tjobs, ids, wins[3], 30.0, subs)
    assert got == want and want
    for sid in ids:
        assert (tdet.hist(sid) == jdet.hist(sid)).all()
        assert tdet.score(sid) == pytest.approx(jdet.score(sid), abs=1e-5)
        if sid in want:
            assert tdet.score(sid) == jdet.score(sid)
    assert tg.events[n_ev:] == jg.events[n_ev:] and len(tg.events) > n_ev
    part = [sorted(sorted(m.stream_id for m in j.members) for j in js)
            for js in (tjobs, jjobs)]
    assert part[0] == part[1]
    sd_t, sd_j = tidx.state_dict(), jidx.state_dict()
    assert sd_t.keys() == sd_j.keys()
    for key in sd_t:
        a, b = sd_t[key], sd_j[key]
        assert (a == b).all() if isinstance(a, np.ndarray) else a == b


# ---------------------------------------------------------------------------
# the card: kernel against plain version
# ---------------------------------------------------------------------------
@pytest.mark.gpu
def test_cuda_pairwise_js_matches_plain_version():
    """The Hopper kernel against the plain version on the card (needs a
    CUDA device and nvcc; chip_smoke.py runs it at the index's
    capacity)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for N, M, B in SWEEP:
        p, q = (torch.from_numpy(a).cuda() for a in _sweep_inputs(N, M, B))
        before = pairwise_js.launches
        got = pairwise_js(p, q)
        assert pairwise_js.launches == before + 1
        np.testing.assert_allclose(got.cpu().numpy(),
                                   tref.pairwise_js_ref(p, q).cpu().numpy(),
                                   atol=PJS_TOL, rtol=0)
