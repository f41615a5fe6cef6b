"""The control at a size a test run holds: the reference put in the
program's place in the next precision down (fp8 operands for bf16 serving
and training, TF32 for fp32 evals, which only the card has) fails one of
the cell's numbers where the sound run passes them. The cells' own
readings at full size are taken on the card by bench/control.py."""
from __future__ import annotations

import pytest

import smoke
from bench.drivers import retrain, serve
from test_bench_faults import HYMBA_LIMITS, SERVE_LIMITS, TRAIN_LIMITS

SEEDS = (2**31 + 101, 2**31 + 102, 2**31 + 103)


@pytest.mark.parametrize("cell", ["olmo-1b.query", "hymba-1.5b.query"])
def test_fp8_control_fails_the_served_gap(cell):
    """Over three seeds, as the limit is set: the sound runs' largest
    reading stays under the limit, the control's smallest above it."""
    sound, control = [], []
    for seed in SEEDS:
        c = smoke.cell(cell)
        c.traffic["limits"] = dict(SERVE_LIMITS)
        run = serve.run(c, seed, 2.0, False, dev="cpu", control=True)
        got = {x.name: x.value for x in run.checks}
        assert run.correct
        sound.append(got["served_gap"])
        control.append(got["control.served_gap"])
    assert max(sound) < SERVE_LIMITS["served_gap"] < min(control), \
        (sound, control)


def test_fp8_control_fails_hymbas_own_numbers():
    """hymba's cell compares the mean gap and the worst query's mean gap:
    the control fails both on every seed, the sound runs pass both."""
    for seed in SEEDS:
        c = smoke.cell("hymba-1.5b.query")
        c.traffic["limits"] = dict(HYMBA_LIMITS)
        run = serve.run(c, seed, 2.0, False, dev="cpu", control=True)
        got = {x.name: x for x in run.checks}
        assert run.correct, got
        for name in HYMBA_LIMITS:
            assert got[name].ok and not got["control." + name].ok, name


def test_fp8_control_and_half_batch_fail_a_training_number():
    c = smoke.cell("olmo-1b.retrain")
    c.traffic["limits"] = dict(TRAIN_LIMITS)
    run = retrain.run(c, SEEDS[0], 1.0, False, dev="cpu", control=True)
    got = {x.name: x for x in run.checks}
    assert run.correct
    for prefix in ("control.", "half."):
        mine = [x for n, x in got.items() if n.startswith(prefix)
                and "eval" not in n]
        assert mine and any(not x.ok for x in mine), prefix
