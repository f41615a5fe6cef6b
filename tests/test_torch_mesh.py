"""The port's fleet mesh (`launch.mesh`), the row-sharded kernel ops and
the drift plane under a mesh, restating the kernel half of
tests/test_distributed_plane.py's KERNEL_PARITY in one process.

The reference forces an 8-device host platform in a subprocess; the
port's `FleetMesh` is a single-controller mesh, so an 8-entry mesh over
the CPU (`make_fleet_mesh(8, devices=["cpu"] * 8)`, one device repeated)
runs every block here, through the kernels' plain versions. Held, bit for
bit: sharded == unsharded for fleet_drift (rows) and pairwise_js (rows and
cols) at row counts that are not multiples of 8, and the drift plane's
churn drive (triggers and float64 scores) under the mesh == without it ==
the reference's. Against the reference's `xla` path the histograms are
exact and the scores within 1e-6 (fleet_drift) and 2e-6 (pairwise_js),
tighter than the 1e-5 that tests/test_torch_drift.py and
tests/test_torch_grouping.py hold them to: the port's plain JS formula is
not XLA's, so its fp32 scores differ in the last bits.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.core.drift import FleetDriftDetector as JFleetDriftDetector  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch.core.drift import FleetDriftDetector  # noqa: E402
from repro_torch.distributed import sharding  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch.mesh import (FleetMesh, make_fleet_mesh,  # noqa: E402
                                     make_mesh)

CPU8 = ["cpu"] * 8
SCORE_TOL = 1e-6
PJS_TOL = 2e-6


@pytest.fixture(scope="module")
def mesh():
    return make_fleet_mesh(8, devices=CPU8)


def _hists(rng, n, b):
    h = rng.random((n, b))
    return h / h.sum(1, keepdims=True)


def test_fleet_mesh_shape_and_axes():
    m = make_fleet_mesh(8, devices=CPU8)
    assert isinstance(m, FleetMesh)
    assert (m.size, m.axis_names, m.shape) == (8, ("fleet",), {"fleet": 8})
    assert m.devices == (torch.device("cpu"),) * 8
    assert make_fleet_mesh(4, devices=CPU8).size == 4     # a prefix
    m2 = make_mesh((4, 2), ("data", "model"), devices=CPU8)
    assert m2.shape == {"data": 4, "model": 2} and m2.size == 8
    assert sharding.fleet_axis(m2) == "data"
    assert sharding.fleet_devices(m2) == 4
    assert len(sharding.block_devices(m2)) == 4
    with pytest.raises(RuntimeError, match="need 9 devices"):
        make_fleet_mesh(9, devices=CPU8)


def test_fleet_mesh_needs_cuda_without_a_device_list(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_fleet_mesh(2)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_fleet_mesh()
    with pytest.raises(RuntimeError, match="CUDA"):
        make_mesh((2,), ("fleet",))


def test_row_helpers():
    assert sharding.row_spans(37, 8) == [(5 * b, 5 * b + 5) for b in range(8)]
    x = torch.arange(22.).reshape(11, 2)
    blocks = sharding.split_rows(x, make_fleet_mesh(4, devices=CPU8))
    assert [b.shape[0] for b in blocks] == [3, 3, 3, 3]
    assert torch.equal(blocks[3][2], torch.zeros(2))       # padding row
    assert torch.equal(sharding.join_rows(blocks, 11, "cpu"), x)


def test_block_rows_index_and_resize():
    x = torch.arange(24.).reshape(8, 3)
    br = sharding.BlockRows([x]).resized(8, [torch.device("cpu")] * 4)
    assert br.shape == (8, 3) and br.per == 2
    assert torch.equal(br[5], x[5])
    br[5] = torch.ones(3)
    assert torch.equal(br.blocks[2][1], torch.ones(3))
    got = br[torch.tensor([7, 0, 5])]
    assert torch.equal(got, torch.stack([x[7], x[0], torch.ones(3)]))
    br[np.array([0, 1])] = torch.zeros(2, 3)
    assert torch.equal(br.flat("cpu")[:2], torch.zeros(2, 3))
    big = br.resized(12, [torch.device("cpu")] * 2)
    assert big.per == 6 and torch.equal(big.flat("cpu")[:8], br.flat("cpu"))
    assert torch.equal(big.flat("cpu")[8:], torch.zeros(4, 3))
    assert br.to(torch.bfloat16).dtype == torch.bfloat16


@pytest.mark.parametrize("n", [37, 11])
def test_fleet_drift_sharded_equals_unsharded_and_reference(n, mesh):
    rng = np.random.default_rng(n)
    toks = rng.integers(0, 64, (n, 32))
    ref = _hists(rng, n, 16)
    t, r = torch.from_numpy(toks), torch.from_numpy(ref.astype(np.float32))
    for impl in ("auto", "ref"):
        s0, h0 = ops.fleet_drift(t, r, buckets=16, vocab=64, impl=impl)
        s1, h1 = ops.fleet_drift(t, r, buckets=16, vocab=64, impl=impl,
                                 mesh=mesh)
        assert torch.equal(s0, s1) and torch.equal(h0, h1), impl
    js, jh = map(np.asarray, jops.fleet_drift(toks, ref, buckets=16,
                                              vocab=64, impl="xla"))
    np.testing.assert_array_equal(h1.numpy(), jh)
    np.testing.assert_allclose(s1.numpy(), js, atol=SCORE_TOL, rtol=0)


def test_pairwise_js_sharded_rows_and_cols(mesh):
    rng = np.random.default_rng(0)
    p, q = _hists(rng, 23, 16), _hists(rng, 37, 16)
    tp, tq = (torch.from_numpy(a.astype(np.float32)) for a in (p, q))
    want = np.asarray(jops.pairwise_js(p, q, impl="xla"))
    for impl in ("auto", "ref"):
        d0 = ops.pairwise_js(tp, tq, impl=impl)
        for shard in ("rows", "cols"):
            d1 = ops.pairwise_js(tp, tq, impl=impl, mesh=mesh, shard=shard)
            assert d1.shape == (23, 37)
            assert torch.equal(d0, d1), (impl, shard)
        np.testing.assert_allclose(d1.numpy(), want, atol=PJS_TOL, rtol=0)
    # the signature index hands its mirror in as blocks: columns kept
    blocks = sharding.split_rows(tq, mesh)
    d2 = ops.pairwise_js(tp, blocks, mesh=mesh, shard="cols")
    assert d2.shape == (23, 40)
    assert torch.equal(d2[:, :37], d0)
    with pytest.raises(ValueError, match="shard"):
        ops.pairwise_js(tp, tq, mesh=mesh, shard="diag")


def _drive(det, rng0):
    """KERNEL_PARITY's churn drive: 13 streams, 4 rounds, 2 leave and 2
    join in round 2."""
    out = []
    ids = [f"s{i}" for i in range(13)]
    for s in ids:
        det.add_stream(s)
    det.set_references(ids, rng0.integers(0, 64, (13, 8, 32)))
    for rnd in range(4):
        if rnd == 2:
            for s in ("s3", "s7"):
                det.remove_stream(s)
                ids.remove(s)
            for s in ("s13", "s14"):
                det.add_stream(s)
                ids.append(s)
            det.set_references(["s13", "s14"],
                               rng0.integers(0, 64, (2, 8, 32)))
        obs = rng0.integers(0, 64, (len(ids), 8, 32))
        trig = det.observe(ids, obs)
        out.append((list(trig), [float(det.score(s)) for s in ids]))
    return out


@pytest.mark.parametrize("impl", ["exact", "auto"])
def test_drift_plane_churn_under_mesh(impl, mesh):
    kw = dict(threshold=0.1, buckets=16, vocab=64)
    want = _drive(JFleetDriftDetector(impl="exact", **kw),
                  np.random.default_rng(1))
    plain = _drive(FleetDriftDetector(impl=impl, device="cpu", **kw),
                   np.random.default_rng(1))
    det = FleetDriftDetector(impl=impl, device="cpu", mesh=mesh, **kw)
    sharded = _drive(det, np.random.default_rng(1))
    assert sharded == plain
    assert [t for t, _ in sharded] == [t for t, _ in want]
    if impl == "exact":
        assert sharded == want
    assert det._rows.capacity % 8 == 0
    det.set_mesh(make_fleet_mesh(3, devices=CPU8))
    assert det._rows.capacity % 3 == 0 and det._ref.shape[0] >= \
        det._rows.capacity


def test_drift_screen_launches_one_block_per_shard(mesh, monkeypatch):
    """Under a mesh the screen calls the wrapper once per block, each on
    its block's rows (on the card each is one counted launch)."""
    calls = []
    real = ops._fdrift

    def spy(tok, r, **kw):
        calls.append(tok.shape[0])
        return real(tok, r, **kw)

    monkeypatch.setattr(ops, "_fdrift", spy)
    det = FleetDriftDetector(threshold=0.1, buckets=16, vocab=64,
                             impl="auto", device="cpu", mesh=mesh)
    rng = np.random.default_rng(3)
    ids = [f"s{i}" for i in range(21)]
    det.set_references(ids, rng.integers(0, 64, (21, 8, 32)))
    det.observe(ids, rng.integers(0, 64, (21, 8, 32)))
    assert calls == [3] * 8


def _shortlists(idx, rng, steps=120):
    """A churn drive of upserts, signature refreshes, removals, growths and
    a restore, each step followed by a top-2 shortlist; returns the
    shortlists and checks the mirror against the host block each time."""
    out, snap = [], None
    for step in range(steps):
        sid = f"s{int(rng.integers(0, 40))}"
        op = int(rng.integers(0, 5))
        if op <= 1:
            idx.upsert(sid, 0.0, (0.0, 0.0),
                       rng.random(16).astype(np.float32))
            idx.assign(sid, f"j{int(rng.integers(0, 5))}")
        elif op == 2 and sid in idx._row:
            idx.refresh_sig(sid, rng.random(16).astype(np.float32))
        elif op == 3 and sid in idx._row:
            idx.remove(sid)
        elif op == 4:
            snap = idx.state_dict()
        if step == 80 and snap is not None:
            idx.load_state_dict(snap)
        if (idx._job >= 0).any():
            out.append(idx.candidate_jobs_batch(
                [0.0, 0.0], [(0.0, 0.0)] * 2, eps_t=1e9, delta_loc=1e9,
                k=2, sigs=[rng.random(16).astype(np.float32)
                           for _ in range(2)]))
            mirror = idx._sig_dev
            if isinstance(mirror, list):
                mirror = torch.cat(mirror)
            assert torch.equal(mirror[:idx.capacity],
                               torch.from_numpy(idx._sig)), step
            assert not mirror[idx.capacity:].any()       # the padding
    return out


def test_signature_index_cols_sharded_mirror_under_churn():
    """The signature block column-sharded over a 3-entry mesh (capacities
    8, 16, 32 pad to blocks of 3, 6, 11 rows): every shortlist equals the
    unsharded index's, each block of the mirror equals its rows of the
    host block after every call, and the per-block upload counts add up to
    the totals (a whole upload counts once in each block)."""
    from repro_torch.core.signature_index import SignatureIndex
    plain = SignatureIndex(buckets=16, capacity=8, device="cpu")
    mesh3 = make_fleet_mesh(3, devices=CPU8)
    idx = SignatureIndex(buckets=16, capacity=8, device="cpu", mesh=mesh3)
    want = _shortlists(plain, np.random.default_rng(21))
    got = _shortlists(idx, np.random.default_rng(21))
    assert got == want and any(any(r) for r in got)
    assert idx.capacity >= 16
    assert idx.full_uploads == plain.full_uploads
    assert idx.rows_uploaded == plain.rows_uploaded > 0
    assert idx.block_full_uploads == [idx.full_uploads] * 3
    assert sum(idx.block_rows_uploaded) == idx.rows_uploaded
    idx.set_mesh(None)                    # the elastic path: laid out anew
    assert idx._sig_dev is None and idx.block_full_uploads == [0]
    assert _shortlists(idx, np.random.default_rng(4), 10) == \
        _shortlists(plain, np.random.default_rng(4), 10)
