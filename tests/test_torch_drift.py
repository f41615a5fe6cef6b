"""The port's drift plane held to the JAX package.

Inputs come from numpy with fixed seeds and go through the JAX package
(`repro.kernels.ops.fleet_drift` in Pallas interpret mode and through its
oracle; `repro.core.drift`) and through the port (`repro_torch`; on the
CPU the kernel wrappers compute their plain versions). Host histograms and
float64 JS must be bit-identical; fp32 kernel outputs match within the
tolerances of tests/test_fleet_drift.py. The streams and scenarios that
feed the planes must draw equal tokens for equal seeds. The CUDA kernel
itself runs only on the card: the `gpu`-marked test below and
`chip_smoke.py` hold it to its plain version there.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.core import drift as jdrift  # noqa: E402
from repro.data import scenarios as jscen  # noqa: E402
from repro.data import streams as jstreams  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch.core import drift as tdrift  # noqa: E402
from repro_torch.data import scenarios as tscen  # noqa: E402
from repro_torch.data import streams as tstreams  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels.fleet_drift import fleet_drift  # noqa: E402

# the tolerances of tests/test_fleet_drift.py
SCORE_TOL, HIST_TOL = 1e-5, 1e-6
THR = 0.25

# the sweep of tests/test_fleet_drift.py: (N, T, B, vocab)
SWEEP = [(1, 32, 64, 64), (5, 64, 64, 64), (33, 48, 64, 64),
         (100, 16, 128, 256), (17, 64, 64, 0)]


def _sweep_inputs(N, T, B, vocab, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, (vocab or B) + 1, size=(N, T))   # token == vocab
    ref = rng.random((N, B)).astype(np.float32)
    ref[0] = 0.0                                           # zero-sum row
    return toks, ref


def _port_fleet_drift(toks, ref, B, vocab, impl="auto"):
    s, h = tops.fleet_drift(torch.from_numpy(toks), torch.from_numpy(ref),
                            buckets=B, vocab=vocab, impl=impl)
    return s.numpy(), h.numpy()


# ---------------------------------------------------------------------------
# ops.fleet_drift against the JAX kernel and oracle
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("N,T,B,vocab", SWEEP)
@pytest.mark.parametrize("jax_impl", ["interpret", "ref"])
def test_fleet_drift_matches_jax(N, T, B, vocab, jax_impl):
    toks, ref = _sweep_inputs(N, T, B, vocab)
    want_s, want_h = map(np.asarray, jops.fleet_drift(
        toks, ref, buckets=B, vocab=vocab, impl=jax_impl))
    got_s, got_h = _port_fleet_drift(toks, ref, B, vocab)
    assert got_s.shape == (N,) and got_h.shape == (N, B)
    assert got_s.dtype == np.float32 and got_h.dtype == np.float32
    assert np.isfinite(got_s).all()
    np.testing.assert_allclose(got_s, want_s, atol=SCORE_TOL, rtol=0)
    np.testing.assert_allclose(got_h, want_h, atol=HIST_TOL, rtol=0)


@pytest.mark.parametrize("jax_impl", ["interpret", "ref"])
def test_fleet_drift_negative_tokens_floor_modulo(jax_impl):
    """vocab == 0 hashes with floor modulo: a negative token lands in
    [0, buckets), as in jnp and numpy (C's % would not)."""
    rng = np.random.default_rng(5)
    toks = rng.integers(-300, 300, size=(11, 40))
    ref = rng.random((11, 64)).astype(np.float32)
    want_s, want_h = map(np.asarray, jops.fleet_drift(
        toks, ref, buckets=64, vocab=0, impl=jax_impl))
    got_s, got_h = _port_fleet_drift(toks, ref, 64, 0)
    np.testing.assert_allclose(got_s, want_s, atol=SCORE_TOL, rtol=0)
    np.testing.assert_allclose(got_h, want_h, atol=HIST_TOL, rtol=0)
    idx = tref.bucket_index(torch.from_numpy(toks), 64, 0).numpy()
    assert (idx == toks % 64).all() and (idx >= 0).all()


def test_fleet_drift_edges():
    """N == 0 gives empty outputs; T == 0 scores finitely through the
    eps-uniform histogram, like the host path."""
    s, h = _port_fleet_drift(np.zeros((0, 8), np.int64),
                             np.zeros((0, 64), np.float32), 64, 64)
    assert s.shape == (0,) and h.shape == (0, 64)
    ref = np.random.default_rng(6).random((3, 64))
    s, h = _port_fleet_drift(np.zeros((3, 0), np.int64),
                             ref.astype(np.float32), 64, 64)
    assert (h == 0).all() and np.isfinite(s).all()
    want = jdrift.js_divergence_rows(np.zeros((3, 64)), ref)
    np.testing.assert_allclose(s, want, atol=SCORE_TOL, rtol=0)


def test_fleet_drift_impls_agree_on_cpu_and_count_no_launch():
    toks, ref = _sweep_inputs(33, 48, 64, 64, seed=2)
    before = fleet_drift.launches
    auto = _port_fleet_drift(toks, ref, 64, 64, impl="auto")
    plain = _port_fleet_drift(toks, ref, 64, 64, impl="ref")
    assert all((a == b).all() for a, b in zip(auto, plain))
    assert fleet_drift.launches == before
    with pytest.raises(ValueError, match="impl"):
        _port_fleet_drift(toks, ref, 64, 64, impl="xla")
    meta = torch.empty((2, 4), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="device"):
        fleet_drift(meta, torch.empty((2, 64), device="meta"), buckets=64)


# ---------------------------------------------------------------------------
# host histograms and float64 JS: bit for bit
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("vocab", [64, None, 0, 50_304])
def test_histograms_bit_identical(vocab):
    rng = np.random.default_rng(2)
    hi = (vocab or 32) + 1
    toks = rng.integers(0, hi, size=(1100, 4, 16))   # > one 1024-row chunk
    got = tdrift.batch_token_histogram(toks, 32, vocab)
    want = jdrift.batch_token_histogram(toks, 32, vocab)
    assert got.dtype == want.dtype and (got == want).all()
    for i in (0, 7, 1099):
        assert (tdrift.token_histogram(toks[i], 32, vocab)
                == jdrift.token_histogram(toks[i], 32, vocab)).all()
    empty = np.zeros((2, 0), np.int64)
    assert (tdrift.batch_token_histogram(empty, 16, vocab)
            == jdrift.batch_token_histogram(empty, 16, vocab)).all()


def test_js_divergence_bit_identical():
    rng = np.random.default_rng(3)
    p = rng.random((1500, 64))
    q = rng.random((1500, 64))
    q[7] = 0.0                                       # zero-sum histogram
    assert (tdrift.js_divergence_rows(p, q)
            == jdrift.js_divergence_rows(p, q)).all()
    for i in (0, 7):
        assert tdrift.js_divergence(p[i], q[i]) == \
            jdrift.js_divergence(p[i], q[i])


# ---------------------------------------------------------------------------
# streams and scenarios: equal seeds, equal tokens
# ---------------------------------------------------------------------------
def test_make_fleet_draws_equal_tokens():
    kw = dict(vocab=64, regions=3, streams_per_region=2, dim=4,
              switch_times=(10.0, 30.0), seed=4)
    jb, js = jstreams.make_fleet(**kw)
    tb, ts = tstreams.make_fleet(**kw)
    assert (tb.P == jb.P).all()
    assert [s.stream_id for s in ts] == [s.stream_id for s in js]
    assert [s.loc for s in ts] == [s.loc for s in js]
    assert [s.lag for s in ts] == [s.lag for s in js]
    for t in (0.0, 12.0, 40.0):
        for a, b in zip(ts, js):
            assert a.domain_at(t) == b.domain_at(t)
            assert (a.sample(t, 4, 16) == b.sample(t, 4, 16)).all()
    toks, soft = ts[0].sample_labeled(5.0, 2, 8)
    jtoks, jsoft = js[0].sample_labeled(5.0, 2, 8)
    assert (toks == jtoks).all() and (soft == jsoft).all()


@pytest.mark.parametrize("name", sorted(jscen.SCENARIOS))
def test_scenarios_build_equal_fleets(name):
    kw = {"joiners": 16} if name == "flash_crowd_10k" else {}
    j = jscen.build_scenario(name, seed=3, **kw)
    t = tscen.build_scenario(name, seed=3, **kw)
    assert t.name == j.name and t.windows == j.windows
    assert [s.stream_id for s in t.streams] == \
        [s.stream_id for s in j.streams]
    assert [s.loc for s in t.streams] == [s.loc for s in j.streams]
    assert [(e.window, e.kind, e.stream_id) for e in t.churn] == \
        [(e.window, e.kind, e.stream_id) for e in j.churn]
    assert t.local_caps == j.local_caps and t.profile == j.profile
    assert [(e.window, e.shared_bandwidth) for e in t.bandwidth] == \
        [(e.window, e.shared_bandwidth) for e in j.bandwidth]
    tj = [e.stream for e in t.churn if e.stream is not None] + t.streams
    jj = [e.stream for e in j.churn if e.stream is not None] + j.streams
    for a, b in zip(tj, jj):
        assert a.loc == b.loc
        assert (a.sample(20.0, 2, 32) == b.sample(20.0, 2, 32)).all()
    assert tscen.HOSTILE_SCENARIOS == jscen.HOSTILE_SCENARIOS


# ---------------------------------------------------------------------------
# FleetDriftDetector: the port under every impl against the reference
# ---------------------------------------------------------------------------
def _fleet_windows(seed=0, n=6, windows=4, batch=8, seq=32, vocab=64):
    """tests/test_fleet_drift.py's windows, drawn by the reference."""
    _, streams = jstreams.make_fleet(vocab=vocab, regions=2,
                                     streams_per_region=n // 2, dim=4,
                                     switch_times=(10.0,), seed=seed)
    ids = [s.stream_id for s in streams]
    wins = [np.stack([s.sample(10.0 * w, batch, seq) for s in streams])
            for w in range(windows)]
    return ids, wins


def _float64_score(det, sid):
    """True where a detector's stored score is the float64 one: the
    exact path, or a kernel screen's rescore within `band` of threshold."""
    return det.impl == "exact" or det.score(sid) > THR - det.band


def _assert_window_equal(port, ref_det, ids, got, want):
    assert got == want
    for sid in ids:
        assert (port.hist(sid) == ref_det.hist(sid)).all()
        r = ref_det.reference(sid)
        assert (port.reference(sid) == r).all() if r is not None \
            else port.reference(sid) is None
        if _float64_score(port, sid) and _float64_score(ref_det, sid):
            assert port.score(sid) == ref_det.score(sid)
        else:
            assert port.score(sid) == pytest.approx(ref_det.score(sid),
                                                    abs=SCORE_TOL)


@pytest.mark.parametrize("jax_impl", ["exact", "xla"])
@pytest.mark.parametrize("impl", ["exact", "ref", "auto"])
def test_fleet_detector_matches_reference(impl, jax_impl):
    """Equal triggers every window, bit-identical live histograms, scores
    bit-identical where the screen put them within `band` of the
    threshold (the float64 rescore) and within 1e-5 elsewhere, through
    churn (a removal that swaps rows, then a re-add)."""
    ids, wins = _fleet_windows(n=8, windows=5)
    ref_det = jdrift.FleetDriftDetector(threshold=THR, buckets=64, vocab=64,
                                        impl=jax_impl)
    port = tdrift.FleetDriftDetector(threshold=THR, buckets=64, vocab=64,
                                     impl=impl, device="cpu")
    ref_det.set_references(ids, wins[0])
    port.set_references(ids, wins[0])
    triggered = 0
    live = list(range(len(ids)))           # stream positions observed
    for w in range(1, len(wins)):
        if w == 3:                 # churn: a stream leaves, last row moves
            for det in (ref_det, port):
                det.remove_stream(ids[1])
            live.remove(1)
        if w == 4:                 # it comes back without a reference
            live.append(1)
        sids, toks = [ids[i] for i in live], wins[w][live]
        want = ref_det.observe(sids, toks)
        got = port.observe(sids, toks)
        triggered += len(got)
        _assert_window_equal(port, ref_det, sids, got, want)
        assert len(port) == len(ref_det) and port.stream_ids == \
            ref_det.stream_ids
    assert triggered > 0                  # the drift event fired


@pytest.mark.parametrize("impl", ["exact", "ref", "auto"])
def test_fleet_detector_vocab_boundary_and_zero_sum(impl):
    vocab, buckets = 64, 64
    ids = ["boundary", "zeroref"]
    ref_det = jdrift.FleetDriftDetector(threshold=THR, buckets=buckets,
                                        vocab=vocab)
    port = tdrift.FleetDriftDetector(threshold=THR, buckets=buckets,
                                     vocab=vocab, impl=impl, device="cpu")
    for det in (ref_det, port):
        det.set_reference("boundary", np.arange(vocab))
        det.set_reference("zeroref", [])
    toks = np.stack([np.full((4, 8), vocab), np.arange(32).reshape(4, 8)])
    _assert_window_equal(port, ref_det, ids, port.observe(ids, toks),
                         ref_det.observe(ids, toks))
    assert all(np.isfinite(port.score(s)) for s in ids)


def test_fleet_detector_devices_and_impls():
    """The exact path stays on the host; kernel modes resolve their
    device (cuda by default, which raises without a card)."""
    assert tdrift.FleetDriftDetector().device.type == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tdrift.FleetDriftDetector(impl="auto")
    with pytest.raises(ValueError, match="impl"):
        tdrift.FleetDriftDetector(impl="xla", device="cpu")


# ---------------------------------------------------------------------------
# the card: kernel against plain version
# ---------------------------------------------------------------------------
@pytest.mark.gpu
def test_cuda_fleet_drift_matches_plain_version():
    """The Hopper kernel against the plain version on the card (needs a
    CUDA device and nvcc; chip_smoke.py runs it at fleet scale)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for N, T, B, vocab in SWEEP + [(9, 37, 64, 64)]:
        toks, ref = _sweep_inputs(N, T, B, vocab)
        t = torch.from_numpy(toks.astype(np.int32)).cuda()
        r = torch.from_numpy(ref).cuda()
        before = fleet_drift.launches
        s, h = fleet_drift(t, r, buckets=B, vocab=vocab)
        assert fleet_drift.launches == before + 1
        ws, wh = tref.fleet_drift_ref(t, r, buckets=B, vocab=vocab)
        np.testing.assert_allclose(s.cpu().numpy(), ws.cpu().numpy(),
                                   atol=SCORE_TOL, rtol=0)
        np.testing.assert_allclose(h.cpu().numpy(), wh.cpu().numpy(),
                                   atol=HIST_TOL, rtol=0)
