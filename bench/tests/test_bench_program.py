"""The program's spans in a traced run (`bench/core/program.py`,
`bench/spans.py`): device idle gaps attributed to every enclosing `ecco.`
span on a synthetic profile, with the stretch's own readings unmoved by
those spans; the readers on hand-made runs; and a smoke-width run of two
cells on the CPU with the program's tracer on."""
from __future__ import annotations

import dataclasses
from typing import Tuple

import pytest
import torch

import smoke
from bench import spans as S
from bench.core import program as P
from bench.core import spec
from bench.core import trace as T
from bench.core.record import Query, Run
from bench.core.trace import Stretch

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
SEED = 2**31 + 91


@dataclasses.dataclass
class Ev:
    """What the readers take of a profiler event (times in us)."""
    name: str
    device_type: object
    time_range: object
    is_user_annotation: bool = False


@dataclasses.dataclass
class Range:
    start: float
    end: float


class Prof:
    def __init__(self, events):
        self._events = events

    def events(self):
        return self._events


def ev(name, a, b, dev=CPU, note=False) -> Ev:
    return Ev(name, dev, Range(a, b), note)


# kernels at [0, 10], [20, 30], [25, 35] and [50, 60], [100, 110]: gaps
# (10, 20) mid 15, (35, 50) mid 42.5, (60, 100) mid 80
KERNELS = [ev("k1", 0, 10, CUDA), ev("k2", 20, 30, CUDA),
           ev("k3", 25, 35, CUDA), ev("k4", 50, 60, CUDA),
           ev("k5", 100, 110, CUDA)]
HOST_SPANS = [ev("bench.train", 0, 120)]
PROGRAM = [ev("ecco.train.micro", 5, 115), ev("ecco.train.grads", 5, 45),
           ev("ecco.train.update", 45, 110),
           # two prefills overlap the first gap: counted once for the name
           ev("ecco.prefill", 0, 18), ev("ecco.prefill", 12, 19),
           # the card's mirror of each annotation, which is no kernel
           ev("ecco.train.grads", 6, 44, CUDA, note=True),
           ev("ecco.train.update", 46, 109, CUDA, note=True)]


def test_gaps_go_to_every_enclosing_program_span():
    gaps, counts = P.gaps(KERNELS + HOST_SPANS + PROGRAM)
    assert gaps == pytest.approx({"ecco.train.micro": 65e-6,
                                  "ecco.train.grads": 25e-6,
                                  "ecco.train.update": 40e-6,
                                  "ecco.prefill": 10e-6})
    assert counts == {"ecco.train.micro": 1, "ecco.train.grads": 1,
                      "ecco.train.update": 1, "ecco.prefill": 2}


def _read(events) -> Tuple[float, dict, list]:
    st = T.read(Prof(events), 1.0, {}, 0.0)
    return st.busy_s, st.kernels, st.idle_gaps


def test_the_stretch_reads_the_same_with_or_without_program_spans():
    without = _read(KERNELS + HOST_SPANS)
    assert _read(KERNELS + HOST_SPANS + PROGRAM) == without
    assert without[2] == [("bench.train", pytest.approx(65e-6))]
    assert P.gaps(KERNELS + HOST_SPANS) == ({}, {})


def _span(name, a, b, seconds=None, **attrs):
    from repro_torch.tracing import Span
    return Span(name, 0, None, a, b, b - a if seconds is None else seconds,
                attrs)


def test_readers_on_hand_made_runs():
    plain = Run("c", {}, {}, window_s=2.0, windows=[(0.0, 1.0), (1.0, 2.0)])
    plain.stretch = Stretch()
    for name in S.METRICS:
        assert spec.reader(name)(plain) is None, name
    run = dataclasses.replace(plain)
    run.program_spans = [_span("ecco.train.update", 0.1, 0.2, 0.05),
                         _span("ecco.train.update", 1.1, 1.2, 0.03),
                         _span("ecco.train.update", 2.5, 2.6, 9.0)]
    run.stretch = Stretch()
    run.stretch.program_gaps = {"ecco.train.update": 0.5,
                                "ecco.tick.layers": 0.2, "ecco.prefill": 0.3}
    run.stretch.program_counts = {"ecco.window": 1, "ecco.tick": 4,
                                  "ecco.prefill": 3}
    assert P.update_ms(run) == pytest.approx(40.0)
    assert P.update_gap_ms(run) == pytest.approx(500.0)
    assert P.grads_gap_ms(run) == 0.0
    assert P.tick_layers_gap_ms(run) == pytest.approx(50.0)
    assert P.prefill_gap_ms(run) == pytest.approx(100.0)
    run.queries = [Query("q0", "g0", 0.1), Query("q1", "g0", 0.5),
                   Query("q2", "g0", 2.5)]
    run.program_spans = [
        _span("ecco.query.queue", 0.2, 0.3, key="q0"),
        _span("ecco.query.queue", 0.6, 0.9, key="q1"),
        _span("ecco.query.queue", 0.6, 0.7, key="q1x", dropped=True),
        _span("ecco.query.queue", 2.6, 3.6, key="q2")]
    assert P.queue_wait_ms(run) == pytest.approx(200.0)


@pytest.mark.parametrize("cell, want", [
    ("olmo-1b.retrain", {"update_ms.window", "update_gap_ms.window",
                         "grads_gap_ms.window"}),
    ("olmo-1b.query-burst", {"queue_wait_ms.p95", "prefill_gap_ms.p95",
                             "tick_layers_gap_ms.p95"}),
])
def test_a_traced_smoke_run_reads_the_program_spans(cell, want):
    """On the CPU the stretch has no device work, so the gaps read 0."""
    from repro_torch import tracing
    c = smoke.cell(cell)
    run = S.traced(c, SEED, 3.0, dev="cpu")
    assert not tracing.enabled()
    line = S.program_line(c, run)
    assert set(line["metrics"]) == want
    assert line["counts"].get("ecco.window" if "retrain" in cell
                              else "ecco.tick", 0) >= 1
    assert all(s.end >= s.start for s in run.program_spans)
    assert run.correct
