"""A whole run at smoke width on the CPU (the look for a card skipped),
sound and then with the timed path broken underneath: each fault that a
cell can have turns `correct` false. Limits here are set for smoke width
from the sound readings (bench/tests/test_bench_control.py holds the
control to them); the cells' own limits are set from chip readings
(PERF.md)."""
from __future__ import annotations

import numpy as np
import pytest
import torch

import smoke
from bench.drivers import retrain, serve

SEED = 2**31 + 77
SERVE_LIMITS = {"served_gap": 0.03}
HYMBA_LIMITS = {"served_gap_mean": 0.005, "served_gap_query": 0.01}
TRAIN_LIMITS = {"gnorm_gap": 0.02, "grad_gap": 0.25, "change_gap": 0.1,
                "eval_margin": 1e-3, "eval_logit_rms": 1e-4,
                "js_gap": 1e-5}


def _serve(name):
    c = smoke.cell(name)
    c.traffic["limits"] = dict(SERVE_LIMITS)
    return serve.run(c, SEED, 1.5, False, dev="cpu")


def _retrain():
    c = smoke.cell("olmo-1b.retrain")
    c.traffic["limits"] = dict(TRAIN_LIMITS)
    return retrain.run(c, SEED, 1.0, False, dev="cpu")


def _names(run):
    return {c.name: c.value for c in run.checks}


@pytest.mark.parametrize("cell", ["olmo-1b.query", "hymba-1.5b.query",
                                  "olmo-1b.query-flood",
                                  "olmo-1b.query-burst"])
def test_sound_serving_run_is_correct(cell):
    run = _serve(cell)
    assert run.correct, _names(run)
    assert run.attempted > 0 and run.failed == 0


def test_a_served_token_altered_where_it_is_produced(monkeypatch):
    from repro_torch.serve.kvcache import ServeLoop
    emit = ServeLoop._emit

    def altered(self, slot, token):
        return emit(self, slot, (token + 1) % self.model.cfg.vocab_size)
    monkeypatch.setattr(ServeLoop, "_emit", altered)
    run = _serve("olmo-1b.query-burst")
    assert not run.correct, _names(run)


def test_the_decode_leaving_its_cache_unchanged(monkeypatch):
    """Each decode step's new K/V rows never reach the cache: the next
    steps attend without them."""
    from repro_torch.models import layers as L
    attend = L.decode_attend

    def stale(q, k, v, cache, ln, **kw):
        saved = {n: t.clone() for n, t in cache.items()
                 if isinstance(t, torch.Tensor)}
        out = attend(q, k, v, cache, ln, **kw)
        for n, t in saved.items():
            cache[n].copy_(t)
        return out
    monkeypatch.setattr(L, "decode_attend", stale)
    run = _serve("olmo-1b.query-burst")
    assert not run.correct, _names(run)


def test_half_of_a_prefill_batch_left_out(monkeypatch):
    from repro_torch.serve.plane import FleetServePlane
    prefill = FleetServePlane._prefill_group

    def half(self, group_id, prompts):
        n = prompts.shape[0]
        keep = prompts[np.arange(n) % max(1, n // 2)]
        return prefill(self, group_id, keep)
    monkeypatch.setattr(FleetServePlane, "_prefill_group", half)
    c = smoke.cell("olmo-1b.query-flood")
    c.traffic["limits"] = dict(SERVE_LIMITS)
    run = serve.run(c, SEED, 1.5, False, dev="cpu")
    assert not run.correct, _names(run)


def test_sound_retraining_run_is_correct():
    run = _retrain()
    assert run.correct, _names(run)
    assert run.attempted >= 3


def test_a_train_step_that_returns_its_state_unchanged(monkeypatch):
    from repro_torch.train import optimizer
    monkeypatch.setattr(optimizer, "adamw_update",
                        lambda tcfg, params, grads, opt: (
                            params, opt, {"grad_norm": torch.zeros(()),
                                          "lr": torch.zeros(())}))
    run = _retrain()
    assert not run.correct
    assert _names(run)["change_gap"] > TRAIN_LIMITS["change_gap"]


def test_half_of_each_training_batch_left_out(monkeypatch):
    """The train step's loss over half of its batch, the mean taken over
    the rest."""
    from repro_torch.train import train_step
    xent = train_step.softmax_xent

    def half(cfg, logits, labels):
        n = max(1, logits.shape[0] // 2)
        return xent(cfg, logits[:n], labels[:n])
    monkeypatch.setattr(train_step, "softmax_xent", half)
    run = _retrain()
    assert not run.correct, _names(run)


def test_an_eval_answer_altered_where_it_is_produced(monkeypatch):
    from repro_torch.core.trainer import SharedEngine
    fwd = SharedEngine._forward_hits

    def flipped(self, params, toks, precision):
        hits = fwd(self, params, toks, precision)
        hits[0] = 1 - hits[0]
        return hits
    monkeypatch.setattr(SharedEngine, "_forward_hits", flipped)
    run = _retrain()
    assert not run.correct
    assert _names(run)["eval_margin"] > TRAIN_LIMITS["eval_margin"]


def test_a_drift_trigger_dropped(monkeypatch):
    from repro_torch.core.drift import FleetDriftDetector
    observe = FleetDriftDetector.observe

    def dropped(self, ids, toks):
        return observe(self, ids, toks)[1:]
    monkeypatch.setattr(FleetDriftDetector, "observe", dropped)
    run = _retrain()
    assert _names(run)["drift_windows_differ"] > 0
    assert not run.correct


def test_an_eval_forward_run_in_bf16(monkeypatch):
    """The eval's hits may stay as they were; its logits do not."""
    from repro_torch.core.trainer import SharedEngine
    fwd = SharedEngine._forward_hits
    monkeypatch.setattr(SharedEngine, "_forward_hits",
                        lambda self, params, toks, precision: fwd(
                            self, params, toks, "bf16"))
    run = _retrain()
    assert not run.correct
    assert _names(run)["eval_logit_rms"] > TRAIN_LIMITS["eval_logit_rms"]


def test_a_shortlist_score_altered(monkeypatch):
    from repro_torch.kernels import ops
    pjs = ops.pairwise_js
    monkeypatch.setattr(ops, "pairwise_js",
                        lambda p, q, **kw: pjs(p, q, **kw) * 1.01)
    run = _retrain()
    assert not run.correct
    assert _names(run)["js_gap"] > TRAIN_LIMITS["js_gap"]


def test_alg1_gains_altered_where_they_are_produced(monkeypatch):
    """Every job's objective gain off by a constant: the greedy picks may
    stay the same; the gains and the shares do not."""
    from repro_torch.core.allocator import ECCOAllocator
    gains = ECCOAllocator._objective_gains
    monkeypatch.setattr(ECCOAllocator, "_objective_gains",
                        lambda self, jobs, acc, acc_gain: {
                            k: v + 0.5 for k, v in gains(
                                self, jobs, acc, acc_gain).items()})
    run = _retrain()
    assert _names(run)["alg1_windows_differ"] > 0
    assert not run.correct


def test_one_lane_served_wrong():
    """Every token of one query altered: the widest gap catches it, and
    so does the worst query's mean gap, which hymba's cell compares."""
    from repro_torch.serve.kvcache import ServeLoop
    emit = ServeLoop._emit
    victim = {}

    def altered(self, slot, token):
        victim.setdefault("slot", slot)
        if slot == victim["slot"]:
            token = (token + 1) % self.model.cfg.vocab_size
        return emit(self, slot, token)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ServeLoop, "_emit", altered)
        c = smoke.cell("hymba-1.5b.query")
        c.traffic["limits"] = dict(HYMBA_LIMITS)
        run = serve.run(c, SEED, 1.5, False, dev="cpu")
    got = _names(run)
    assert not run.correct, got
    assert got["served_gap_query"] > HYMBA_LIMITS["served_gap_query"]
