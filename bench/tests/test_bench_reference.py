"""The plain reference agrees with the port at smoke width on the CPU:
logits of every configuration with a smoke file in float32, and the first
train steps."""
from __future__ import annotations

import copy

import numpy as np
import pytest
import torch

import smoke
from bench.core import device as D
from bench.core import weights as W
from bench.reference import drift as ref_drift
from bench.reference import model as ref
from bench.reference import train as ref_train


def _cfg(name):
    return smoke.cell(name).config


@pytest.mark.parametrize("config", smoke.configs())
def test_reference_logits_equal_the_port_in_fp32(config):
    from repro_torch.models.model import build_model
    cfg = smoke.config(config)
    model = build_model(D.model_config(cfg))
    params = W.make(model.spec, 5, torch.device("cpu"))
    toks = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg["vocab_size"], size=(2, 40)))
    with torch.no_grad():
        want, _ = model.apply(params, toks, compute_dtype=torch.float32,
                              kernel_impl="ref")
        got = ref.logits(cfg, params, ref.hidden(cfg, params, toks))
    want = want[..., :cfg["vocab_size"]].float()
    assert torch.allclose(got, want, atol=2e-4, rtol=1e-4), \
        float((got - want).abs().max())


def test_reference_training_follows_the_port_in_fp32():
    from repro_torch.configs.base import TrainConfig
    from repro_torch.models.model import build_model
    from repro_torch.train.optimizer import init_opt_state
    from repro_torch.train.train_step import make_train_step
    cfg = _cfg("olmo-1b.retrain")
    tc = dict(smoke.cell("olmo-1b.retrain").traffic["train"],
              compute_dtype="float32")
    model = build_model(D.model_config(cfg))
    params = W.make(model.spec, 9, torch.device("cpu"))
    state = {"params": copy.deepcopy(params),
             "opt": init_opt_state(params)}
    step = make_train_step(model, TrainConfig(**tc))
    rt = ref_train.Trainer(cfg, params, tc)
    rng = np.random.default_rng(2)
    for k in range(3):
        x = torch.as_tensor(rng.integers(0, cfg["vocab_size"], (4, 17)))
        state, met = step(state, {"inputs": x, "labels": x})
        lv, norms, gn = rt.step(x)
        assert abs(float(met["grad_norm"]) - gn) <= 1e-4 * gn
        assert abs(float(met["loss"]) - lv) <= 1e-5 * abs(lv)
        if k == 0:
            mine = {n: float(v.norm()) / (1 - tc["b1"]) for n, v in
                    ref_train.layer_leaves(state["opt"]["mu"])}
            assert ref_train.gap_by_worst_leaf(mine, norms)[0] < 1e-4
    delta = ref_train._tree(lambda a, b: a - b, state["params"], params)
    mine = {n: float(v.norm()) for n, v in ref_train.layer_leaves(delta)}
    assert ref_train.gap_by_worst_leaf(mine, rt.change())[0] < 1e-3


def test_drift_reference_equals_the_ports_exact_detector():
    from repro_torch.core.drift import FleetDriftDetector
    rng = np.random.default_rng(3)
    ids = [f"s{i}" for i in range(20)]
    refs = rng.integers(0, 300, size=(20, 8, 32))
    live = np.where(rng.random((20, 1, 1)) < 0.5, refs,
                    rng.integers(0, 60, size=(20, 8, 32)))
    det = FleetDriftDetector(threshold=0.25, buckets=64, vocab=300,
                             device="cpu")
    det.set_references(ids, refs)
    got = set(det.observe(ids, live))
    want = ref_drift.triggers(dict(zip(ids, live)), dict(zip(ids, refs)),
                              buckets=64, vocab=300, threshold=0.25)
    assert got == want and 0 < len(got) < 20


def test_js_reference_equals_the_ports_shortlist_scores():
    """The float64 score matrix and the port's `pairwise_js` agree to
    fp32 rounding; the bfloat16 control does not."""
    from repro_torch.kernels import ops
    rng = np.random.default_rng(4)
    p = torch.as_tensor(rng.random((3, 64)), dtype=torch.float32)
    q = torch.as_tensor(rng.random((10, 64)) ** 4, dtype=torch.float32)
    got = ops.pairwise_js(p, q).to(torch.float64)
    want = ref_drift.pairwise_js(p, q)
    low = ref_drift.pairwise_js(p, q, dtype=torch.bfloat16)
    assert float((got - want).abs().max()) < 1e-6
    assert float((low - want).abs().max()) > 1e-4


def test_alg1_replay_holds_the_allocators_window():
    """A window of the port's allocator on stand-in jobs passes the
    replay; the same window with a pick or a share changed does not."""
    from bench.reference import alloc as ref_alloc
    from repro_torch.core.allocator import ECCOAllocator

    class Job:
        def __init__(self, jid, n, accs):
            self.job_id, self.num_members = jid, n
            self.accs = iter(accs)
            self.micro_steps = 2

        def eval(self):
            return next(self.accs)

        def train_micro(self):
            pass

    jobs = [Job("a", 3, [0.1, 0.2, 0.2, 0.25, 0.25, 0.3]),
            Job("b", 1, [0.0, 0.3, 0.3, 0.31, 0.31, 0.32]),
            Job("c", 2, [0.2, 0.2, 0.2, 0.2])]
    alloc = ECCOAllocator()
    calls = []
    gains = alloc._objective_gains

    def recorded(js, acc, acc_gain):
        g = gains(js, acc, acc_gain)
        calls.append((dict(acc), dict(acc_gain), dict(g)))
        return g
    alloc._objective_gains = recorded
    trace = alloc.run_window(jobs, 5)
    members = {j.job_id: j.num_members for j in jobs}
    args = (members, 5, calls, list(trace.order), dict(trace.shares))
    assert len(trace.order) == 5 and len(calls) == 3
    assert not ref_alloc.window_differs(*args)
    swapped = list(trace.order)
    swapped[3] = next(j for j in members if j != swapped[3])
    assert ref_alloc.window_differs(members, 5, calls, swapped,
                                    args[4])
    shares = dict(trace.shares)
    shares["a"] += 1e-6
    assert ref_alloc.window_differs(members, 5, calls, args[3], shares)
