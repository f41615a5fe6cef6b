"""The yardstick's arithmetic and the generators: rates and tails over the
whole window, the roofline counts, and traffic that repeats per seed."""
from __future__ import annotations

import json
import math
import os

import numpy as np
import pytest
import torch

import smoke
from bench.core import readings as R
from bench.core import scenario as S
from bench.core import spec
from bench.core import yardstick as Y
from bench.core.record import Query, Run
from bench.core.trace import Stretch
from bench.drivers import retrain, serve
from bench.reference import common as C

ATTN, SSD = spec.kernel("flash_attention"), spec.kernel("ssd_scan")
# the roofline metrics' readers, as their files read them
ATTN_SHARE = spec.reader("attn_roofline_pct.qps")
SSD_SHARE = spec.reader("ssd_roofline_pct.p95")


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
    nb, fl = ATTN.attention_cost((2, 8, 4, 16), (2, 8, 2, 16), 2, 2,
                              causal=True)
    assert fl == 4 * 2 * 4 * 16 * (8 * 9 // 2)
    assert nb == 2 * 2 * 8 * 4 * 16 * 2 + 2 * 2 * 8 * 2 * 16 * 2
    # a decode over per-lane lengths: only those keys' rows are read
    nb, fl = ATTN.attention_cost((3, 1, 4, 16), (3, 100, 2, 16), 2, 2,
                              causal=True, keys=30)
    assert fl == 4 * 4 * 16 * 30
    assert nb == 2 * 3 * 4 * 16 * 2 + 4 * 3 + 2 * 30 * 2 * 16 * 2
    # appended queries see the whole prefix
    _, fl = ATTN.attention_cost((1, 2, 1, 1), (1, 5, 1, 1), 4, 4,
                                causal=True)
    assert fl == 4 * (4 + 5)


def test_window_pairs_and_bound():
    assert C.window_pairs(5, 0 + 100, 0) == 15
    # window 2, no meta: each query sees itself and one before
    assert C.window_pairs(5, 2, 0) == 1 + 2 + 2 + 2 + 2
    # meta 1 stays visible past the window
    assert C.window_pairs(5, 2, 1) == 1 + 2 + 3 + 3 + 3
    assert Y.bound_s(3.35e12, 0.0, 989e12, 3.35e12) == 1.0
    assert Y.peaks("NVIDIA H100 80GB HBM3")["bf16"] == 989e12
    with pytest.raises(RuntimeError):
        Y.peaks("a CPU")


def test_ssd_cost_matches_the_hand_count():
    nb, fl = SSD.ssd_cost(1, 64, 2, 4, 3, 64)
    T = 64 * 65 // 2
    assert fl == 2 * (T * 3 + 2 * (T * 4 + 2 * 64 * 3 * 4))
    assert nb == (2 * 64 * 2 * 4 * 2 + 4 * 64 * 2 + 2 * 64 * 3 * 2 + 16
                  + 4 * 2 * 4 * 3)


def test_roofline_share_reads_none_without_launches():
    r = _run(window_s=1.0)
    assert R.roofline_pct(r, "flash_attention") is None
    assert R.roofline_pct(r, "ssd_scan") is None
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



def test_group_bursts_are_the_same_load_for_every_seed():
    """Each camera falls due once a period, with its group's burst; the
    bursts are evenly spaced; a seed changes only the order within one."""
    tr = smoke.cell("olmo-1b.query-burst").traffic
    groups, size = tr["groups"], tr["burst"]
    period = sum(groups) / tr["rate"]
    a = serve.Traffic(tr, 256, 5)
    b1, b2 = a.bursts(30.0, 5), a.bursts(30.0, 6)
    assert b1 == a.bursts(30.0, 5) and b1 != b2
    assert sorted(b1) == sorted(b2)
    assert [d for d, _ in b1] == sorted(d for d, _ in b1)
    assert all(d < 30.0 for d, _ in b1)
    cams = [c for d, c in b1 if d < period]
    assert sorted(cams) == list(range(sum(groups)))
    n_bursts = sum(-(-n // size) for n in groups)
    dues = sorted({d for d, _ in b1})
    assert np.allclose(np.diff(dues), period / n_bursts)
    group_of = a.cameras
    for due in dues:
        members = [c for d, c in b1 if d == due]
        assert len(members) <= size
        assert len({group_of[c] for c in members}) == 1

def test_episode_order_is_the_same_set_in_another_order():
    tr = {"scenario_seeds": [0, 1, 2, 3]}
    orders = {tuple(retrain.episode_order(tr, s)) for s in range(20)}
    assert all(sorted(o) == [0, 1, 2, 3] for o in orders)
    assert len(orders) > 1
    assert retrain.episode_order(tr, 2**31 + 11) == \
        retrain.episode_order(tr, 2**31 + 11)


CFG = {n: json.load(open(os.path.join(spec.ROOT, "bench", "configs",
                                       n + ".json")))
       for n in ("olmo-1b", "olmo-1b-vocab8", "hymba-1.5b")}
OLMO_LANES = [2040 + i % 8 for i in range(48)]
HYMBA_LANES = [1152 + i % 8 for i in range(48)]
# each count at the cells' shapes (a serving prefill of 48 x 2040 with the
# last position's logits, a train step's 8 x 32, an eval's 16 x 32, a tick
# of 48 lanes at 2040-2047), frozen as the benchmark computed it before
# its families and kernels became files of their own
FROZEN = {
    "matmul_params(olmo-1b)": (
        lambda: Y.matmul_params(CFG["olmo-1b"]), 1176764416),
    "matmul_params(olmo-1b-vocab8)": (
        lambda: Y.matmul_params(CFG["olmo-1b-vocab8"]), 1086849024),
    "matmul_params(hymba-1.5b)": (
        lambda: Y.matmul_params(CFG["hymba-1.5b"]), 1593344000),
    "forward_flops(olmo-1b, 48, 2040, logit_rows=1)": (
        lambda: Y.forward_flops(CFG["olmo-1b"], 48, 2040, logit_rows=1),
        223389167910912.0),
    "forward_flops(olmo-1b-vocab8, 8, 32)": (
        lambda: Y.forward_flops(CFG["olmo-1b-vocab8"], 8, 32),
        557020348416.0),
    "forward_flops(olmo-1b-vocab8, 16, 32)": (
        lambda: Y.forward_flops(CFG["olmo-1b-vocab8"], 16, 32),
        1114040696832.0),
    "forward_flops(hymba-1.5b, 48, 1024, logit_rows=1)": (
        lambda: Y.forward_flops(CFG["hymba-1.5b"], 48, 1024, logit_rows=1),
        177791997050880.0),
    "decode_flops(olmo-1b, 48 lanes at 2040-2047)": (
        lambda: Y.decode_flops(CFG["olmo-1b"], OLMO_LANES),
        125832265728.0),
    "decode_flops(hymba-1.5b, 48 lanes at 1152-1159)": (
        lambda: Y.decode_flops(CFG["hymba-1.5b"], HYMBA_LANES),
        164289792000.0),
    "attn_roofline_pct(every launch)": (
        lambda: ATTN_SHARE(_roofline_run(slice(None))),
        5.615959698696438),
    "ssd_roofline_pct(every launch)": (
        lambda: SSD_SHARE(_roofline_run(slice(None))),
        1.4069651741293532),
    "attn_roofline_pct(the fp32 eval alone)": (
        lambda: ATTN_SHARE(_roofline_run(slice(2, 3))),
        0.10406491800736578),
    "attn_roofline_pct(the fp32 prefill alone, bound by operations)": (
        lambda: ATTN_SHARE(_roofline_run(slice(5, 6))),
        2.664712306726109),
    "ssd_roofline_pct(the first launch alone)": (
        lambda: SSD_SHARE(_roofline_run(slice(0, 1))),
        0.5059677611940299),
}


def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


def _roofline_run(pick: slice) -> Run:
    """A synthetic stretch: flash_attention's prefill, ragged decode, fp32
    eval, non-causal encode, GQA and fp32 prefill launches (`pick` takes
    some of them, and of the two ssd_scan launches), and
    device time under each kernel's functions and under a GEMM of neither,
    each launch recorded by its kernel file from its op's arguments."""
    lengths = torch.arange(2041, 2089, dtype=torch.int32)
    f32 = torch.float32
    attn = [((_meta(48, 2040, 16, 128), _meta(48, 2040, 16, 128)), {}),
            ((_meta(48, 1, 16, 128), _meta(48, 2096, 16, 128)),
             {"causal": True, "lengths": lengths}),
            ((_meta(128, 32, 16, 128, dtype=f32),
              _meta(128, 32, 16, 128, dtype=f32)), {"causal": True}),
            ((_meta(4, 1024, 16, 80), _meta(4, 1024, 16, 80)),
             {"causal": False}),
            ((_meta(1, 1152, 25, 64), _meta(1, 1152, 5, 64)), {}),
            ((_meta(1, 4096, 16, 128, dtype=f32),
              _meta(1, 4096, 16, 128, dtype=f32)), {})]
    ssd = [((_meta(1, 1152, 50, 64), None, None, _meta(1, 1152, 16)),
            {"chunk": 64}),
           ((_meta(2, 1024, 50, 64), None, None, _meta(2, 1024, 16)), {})]
    launches = {
        "flash_attention": [ATTN.record((q, k, k), kw)
                            for (q, k), kw in attn[pick]],
        "ssd_scan": [SSD.record(a + (None, None), kw) for a, kw in ssd[pick]]}
    kernels = {"void attn_prefill_kernel<128>": (3, 0.0123),
               "attn_decode_split_kernel": (16, 0.0045),
               "attn_decode_combine_kernel": (16, 0.0007),
               "attn_fwd_kernel": (1, 0.0210), "ssd_state_kernel": (2, 3e-4),
               "ssd_walk_kernel": (2, 2e-4), "ssd_out_kernel": (2, 4e-4),
               "ampere_sgemm_128x64": (40, 0.5)}
    run = _run(window_s=1.0)
    run.peaks = Y.peaks("NVIDIA H100 80GB HBM3")
    run.stretch = Stretch(wall_s=1.0, busy_s=0.6, kernels=kernels,
                          launches=launches)
    return run


@pytest.mark.parametrize("count", sorted(FROZEN))
def test_counts_did_not_move(count):
    """Every count, and the roofline shares of a fixed stretch, as frozen;
    compared exactly, since the formulas are the same."""
    compute, value = FROZEN[count]
    assert compute() == value
