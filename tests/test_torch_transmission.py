"""The port's §3.2 transmission plane (`repro_torch.core.transmission`)
against the JAX package's: `ProfileTable` lookups and every
`decide_many` field bit for bit, and `allocate` under churn (final GAIMD
rates and step counts bit for bit, the window means within 1e-5
relative, as tests/test_torch_gaimd.py states)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.core import transmission as jtx  # noqa: E402
from repro_torch.core import transmission as tx  # noqa: E402

MEAN_RTOL = 1e-5


def _tables(levels=3, seed=0):
    """The same profiled table in both packages."""
    cfgs = [(r, q) for r in (2, 4, 8) for q in (16, 32, 64)]
    rng = np.random.default_rng(seed)
    acc = [[lvl, i, float(rng.uniform(0.2, 0.9))]
           for lvl in range(levels) for i in range(len(cfgs))]
    spec = {"configs": cfgs, "acc": acc}
    return tx.ProfileTable.from_spec(spec), jtx.ProfileTable.from_spec(spec)


def _flows(n, seed=0, *, zero_bw_every=0):
    rng = np.random.default_rng(seed)
    shares = rng.uniform(0.05, 1.0, n)
    members = rng.integers(1, 6, n)
    bw = rng.uniform(0.0, 80.0, n)
    if zero_bw_every:
        bw[::zero_bw_every] = 0.0
    levels = [int(v) for v in rng.integers(0, 4, n)]     # incl. unprofiled
    budgets = [None if i % 5 == 4 else float(b)
               for i, b in enumerate(rng.uniform(16, 600, n))]
    return shares, members, bw, levels, budgets


def _batch_equal(got, want):
    for f in dataclasses.fields(want):
        g, w = getattr(got, f.name), getattr(want, f.name)
        assert g.dtype == w.dtype, f.name
        np.testing.assert_array_equal(g, w, err_msg=f.name)


def test_profile_table_lookups_equal():
    t, jt = _tables()
    assert t.levels == jt.levels
    rng = np.random.default_rng(1)
    levels = [int(v) for v in rng.integers(0, 5, 64)]    # 3, 4 unprofiled
    budgets = [None if i % 4 == 3 else float(b)
               for i, b in enumerate(rng.uniform(8, 700, 64))]
    np.testing.assert_array_equal(t.best_many(levels, budgets),
                                  jt.best_many(levels, budgets))
    np.testing.assert_array_equal(t.best_many(levels, None),
                                  jt.best_many(levels, None))
    for lvl, b in zip(levels, budgets):
        got, want = t.best(lvl, b), jt.best(lvl, b)
        assert (got.rate, got.resolution) == (want.rate, want.resolution)
        assert t.acc(lvl, 3) == jt.acc(lvl, 3)


def test_profile_table_ties_and_empty_table():
    """Profiled ties go to the largest index, fallback ties to the first
    sparsest, an empty table to -1 / None: as the reference."""
    spec = {"configs": [[2, 16], [4, 8], [1, 32]],
            "acc": [[0, i, 0.5] for i in range(3)]}
    t, jt = tx.ProfileTable.from_spec(spec), jtx.ProfileTable.from_spec(spec)
    for lvl in (0, 9):
        assert t.best_many([lvl], None)[0] == jt.best_many([lvl], None)[0]
    assert tx.ProfileTable([]).best(0) is None
    np.testing.assert_array_equal(tx.ProfileTable([]).best_many([0, 1], None),
                                  jtx.ProfileTable([]).best_many([0, 1], None))


@pytest.mark.parametrize("n,zero_every", [(1, 0), (7, 0), (64, 3),
                                          (500, 0)])
def test_decide_many_bit_for_bit(n, zero_every):
    t, jt = _tables()
    shares, members, bw, levels, budgets = _flows(n, seed=n,
                                                  zero_bw_every=zero_every)
    kw = dict(budget_levels=levels, token_budgets=budgets, p_shares=shares,
              n_members=members, achieved_bw=bw, window_seconds=10.0)
    got = tx.FleetTransmissionPlane(t).decide_many(**kw)
    want = jtx.FleetTransmissionPlane(jt).decide_many(**kw)
    _batch_equal(got, want)
    # and the scalar controller, decision by decision
    ctrl = tx.TransmissionController(t, bytes_per_token=2.0)
    for i, d in enumerate(got.as_decisions()):
        assert d == ctrl.decide(
            gpu_budget_level=levels[i], token_budget=budgets[i],
            p_share=float(shares[i]), n_members=int(members[i]),
            achieved_bandwidth=float(bw[i]), window_seconds=10.0)


def test_decide_many_empty_and_duck_typed_tables():
    shares, members, bw, levels, budgets = _flows(16, seed=4)
    kw = dict(budget_levels=levels, token_budgets=budgets, p_shares=shares,
              n_members=members, achieved_bw=bw, window_seconds=10.0)
    _batch_equal(tx.FleetTransmissionPlane(tx.ProfileTable([])).decide_many(
                     **kw),
                 jtx.FleetTransmissionPlane(jtx.ProfileTable([])).decide_many(
                     **kw))

    t, _ = _tables()

    class OnlyBest:            # no best_many: the port has no scalar loop
        def __init__(self, inner):
            self.best = inner.best
            self.levels = inner.levels
    with pytest.raises(AttributeError, match="best_many"):
        tx.FleetTransmissionPlane(OnlyBest(t)).decide_many(**kw)


def test_levels_for_shares_equal():
    t, jt = _tables(levels=5)
    shares = np.random.default_rng(2).uniform(0.0, 1.0, 50)
    shares[:3] = (0.0, 1.0, 0.2)
    assert tx.FleetTransmissionPlane(t).levels_for_shares(shares) == \
        jtx.FleetTransmissionPlane(jt).levels_for_shares(shares)
    assert tx.FleetTransmissionPlane().levels_for_shares(shares) == \
        [0] * 50


@pytest.mark.parametrize("mode", ["ecco", "equal"])
def test_allocate_under_churn_matches_reference(mode):
    """Flows join, leave (swap-with-last rows) and rejoin cold; every
    window's GAIMD state and step count equals the reference's, its
    rates within the mean tolerance."""
    plane, jplane = tx.FleetTransmissionPlane(), jtx.FleetTransmissionPlane()
    rng = np.random.default_rng(7)
    live = [f"f{i}" for i in range(6)]
    fresh = iter(f"n{i}" for i in range(100))
    for w in range(8):
        if w in (2, 5):
            for fid in (live[1], live[-1]):
                plane.remove_flow(fid)
                jplane.remove_flow(fid)
                live.remove(fid)
        if w in (3, 6):
            live += [next(fresh), next(fresh)]
        if w == 7:
            live.append("f1")          # a departed flow rejoins: cold row
        n = len(live)
        shares = rng.uniform(0.05, 1.0, n)
        members = rng.integers(1, 4, n)
        caps = np.where(rng.random(n) < 0.3, rng.uniform(0.5, 4.0, n),
                        np.inf)
        kw = dict(mode=mode)
        got = plane.allocate(live, shares, members, caps, 12.0, **kw)
        want = jplane.allocate(live, shares, members, caps, 12.0, **kw)
        np.testing.assert_allclose(got, want, rtol=MEAN_RTOL, atol=0)
        assert plane.last_steps == jplane.last_steps
        assert plane.flow_ids == jplane.flow_ids
        sd, jsd = plane.state_dict(), jplane.state_dict()
        assert sd["ids"] == jsd["ids"]
        np.testing.assert_array_equal(sd["r"], jsd["r"])
        for fid in live:
            assert plane.rate_state(fid) == jplane.rate_state(fid)
    assert plane.rate_state("gone") == 0.0


def test_state_dict_round_trip():
    plane = tx.FleetTransmissionPlane()
    plane.allocate(["a", "b", "c"], [0.5, 0.3, 0.2], [1, 1, 1],
                   [np.inf] * 3, 6.0)
    other = tx.FleetTransmissionPlane()
    other.load_state_dict(plane.state_dict())
    assert other.flow_ids == plane.flow_ids
    np.testing.assert_array_equal(other.state_dict()["r"],
                                  plane.state_dict()["r"])
    assert len(other) == 3 and "b" in other


def test_mesh_refused(monkeypatch):
    """The plane under a mesh, refused until distribution's fleet half,
    is taken now (capacity aligned, one span per device); a mesh of more
    CUDA devices than the machine has is refused."""
    from repro_torch.launch.mesh import make_fleet_mesh
    plane = tx.FleetTransmissionPlane(
        mesh=make_fleet_mesh(4, devices=["cpu"] * 4))
    assert plane._rows.capacity % 4 == 0 and len(plane.shard_spans()) == 4
    plane.set_mesh(None)
    assert plane.shard_spans() == [(0, plane._rows.capacity)]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tx.FleetTransmissionPlane(mesh=make_fleet_mesh(2))
