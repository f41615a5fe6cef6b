"""The yardstick's arithmetic and the generators: rates and tails over the
whole window, the roofline counts, and traffic that repeats per seed."""
from __future__ import annotations

import math

import numpy as np
import pytest

import smoke
from bench.core import readings as R
from bench.core import scenario as S
from bench.core import yardstick as Y
from bench.core.record import Query, Run
from bench.drivers import retrain, serve


def _run(**kw):
    return Run("c", {}, {}, **kw)


def test_window_ms_is_all_the_time_over_all_the_windows():
    r = _run(window_s=10.0, windows=[(0.0, 2.0), (2.5, 6.0), (6.2, 9.0)])
    assert R.window_ms(r) == pytest.approx(10_000 / 3)
    assert R.window_ms(_run(window_s=1.0)) is None


def test_query_p95_counts_in_flight_at_their_age_and_failures_missing():
    qs = [Query(f"q{i}", "g0", due=i * 0.1, done=i * 0.1 + 0.5,
                tokens=[1]) for i in range(90)]
    # in flight at the close (done after it): counted at its age then
    qs += [Query("late", "g0", due=8.0, done=12.0, tokens=[1])]
    # due after the window: not counted
    qs += [Query("after", "g0", due=10.5, done=11.0, tokens=[1])]
    r = _run(window_s=10.0, queries=qs)
    lat = [0.5] * 90 + [2.0]
    assert R.query_p95_ms(r) == pytest.approx(1e3 * np.percentile(lat, 95))
    # six of 96 never answered: the 95th percentile is missing
    qs2 = qs[:90] + [Query(f"f{i}", "g0", due=1.0) for i in range(6)]
    assert math.isinf(R.query_p95_ms(_run(window_s=10.0, queries=qs2)))


def test_queries_per_s_counts_answers_served_inside_the_window():
    qs = [Query(f"q{i}", "g0", due=0.0, done=d, tokens=[1] * 8)
          for i, d in enumerate([1.0, 2.0, 9.9])]
    # in flight at the close with 2 of its 8 tokens served; never answered
    qs.append(Query("q3", "g0", due=5.0, done=11.0, tokens=[1] * 8,
                    at_close=2))
    qs.append(Query("q4", "g0", due=9.0, at_close=3))
    assert R.queries_per_s(_run(window_s=10.0, queries=qs)) == \
        pytest.approx(3.25 / 10.0)


def test_percentile_matches_numpy_on_finite_values():
    x = list(np.random.default_rng(0).exponential(size=101))
    for q in (50, 95, 99):
        assert Y.percentile(x, q) == pytest.approx(np.percentile(x, q))


def test_attention_cost_counts_visible_pairs_once():
    nb, fl = Y.attention_cost((2, 8, 4, 16), (2, 8, 2, 16), 2, 2,
                              causal=True)
    assert fl == 4 * 2 * 4 * 16 * (8 * 9 // 2)
    assert nb == 2 * 2 * 8 * 4 * 16 * 2 + 2 * 2 * 8 * 2 * 16 * 2
    # a decode over per-lane lengths: only those keys' rows are read
    nb, fl = Y.attention_cost((3, 1, 4, 16), (3, 100, 2, 16), 2, 2,
                              causal=True, keys=30)
    assert fl == 4 * 4 * 16 * 30
    assert nb == 2 * 3 * 4 * 16 * 2 + 4 * 3 + 2 * 30 * 2 * 16 * 2
    # appended queries see the whole prefix
    _, fl = Y.attention_cost((1, 2, 1, 1), (1, 5, 1, 1), 4, 4, causal=True)
    assert fl == 4 * (4 + 5)


def test_window_pairs_and_bound():
    assert Y.window_pairs(5, 0 + 100, 0) == 15
    # window 2, no meta: each query sees itself and one before
    assert Y.window_pairs(5, 2, 0) == 1 + 2 + 2 + 2 + 2
    # meta 1 stays visible past the window
    assert Y.window_pairs(5, 2, 1) == 1 + 2 + 3 + 3 + 3
    assert Y.bound_s(3.35e12, 0.0, 989e12, 3.35e12) == 1.0
    assert Y.peaks("NVIDIA H100 80GB HBM3")["bf16"] == 989e12
    with pytest.raises(RuntimeError):
        Y.peaks("a CPU")


def test_ssd_cost_matches_the_hand_count():
    nb, fl = Y.ssd_cost(1, 64, 2, 4, 3, 64)
    T = 64 * 65 // 2
    assert fl == 2 * (T * 3 + 2 * (T * 4 + 2 * 64 * 3 * 4))
    assert nb == (2 * 64 * 2 * 4 * 2 + 4 * 64 * 2 + 2 * 64 * 3 * 2 + 16
                  + 4 * 2 * 4 * 3)


def test_roofline_share_reads_none_without_launches():
    r = _run(window_s=1.0)
    assert R.attn_roofline_pct(r) is None and R.ssd_roofline_pct(r) is None
    assert R.idle_pct(r) is None and R.mfu_pct(r) is None


def test_camera_streams_repeat_per_seed():
    bank = S.DomainBank(50, 3, seed=4)
    a = S.drift_wave(bank, regions=2, streams_per_region=2, wave_start=5,
                     wave_step=10, seed=7)
    b = S.drift_wave(bank, regions=2, streams_per_region=2, wave_start=5,
                     wave_step=10, seed=7)
    c = S.drift_wave(bank, regions=2, streams_per_region=2, wave_start=5,
                     wave_step=10, seed=8)
    for x, y in zip(a, b):
        assert np.array_equal(x.sample(0.0, 4, 9), y.sample(0.0, 4, 9))
    assert any(not np.array_equal(x.sample(0.0, 4, 9), z.sample(0.0, 4, 9))
               for x, z in zip(a, c))
    assert S.DomainBank(50, 3, seed=4).cum.tobytes() == bank.cum.tobytes()


def test_query_traffic_repeats_per_seed_and_keeps_one_set_of_gaps():
    tr = smoke.cell("olmo-1b.query").traffic
    a, b = serve.Traffic(tr, 256, 5), serve.Traffic(tr, 256, 5)
    assert np.array_equal(a.prompt(1), b.prompt(1))
    s1, s2 = a.schedule(30.0, 5), a.schedule(30.0, 6)
    assert np.array_equal(s1, b.schedule(30.0, 5))
    assert not np.array_equal(s1, s2)
    g1 = np.sort(np.diff(np.append(s1, 30.0)))
    g2 = np.sort(np.diff(np.append(s2, 30.0)))
    assert np.allclose(g1, g2) and len(s1) == round(tr["rate"] * 30.0)
    assert serve.Traffic(tr, 256, 6).prompt(1).tolist() != a.prompt(1).tolist()


def test_episode_order_is_the_same_set_in_another_order():
    tr = {"scenario_seeds": [0, 1, 2, 3]}
    orders = {tuple(retrain.episode_order(tr, s)) for s in range(20)}
    assert all(sorted(o) == [0, 1, 2, 3] for o in orders)
    assert len(orders) > 1
    assert retrain.episode_order(tr, 2**31 + 11) == \
        retrain.episode_order(tr, 2**31 + 11)
