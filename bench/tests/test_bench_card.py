"""Each cell of BENCHMARK.json, run for a few seconds on the card through
the benchmark's own command, exits 0 with `correct` true. Needs a CUDA
card (marker `gpu`); skips elsewhere:

    python3 -m pytest -m gpu bench/tests/test_bench_card.py
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest
import torch

from test_bench_spec import CELLS, ROOT


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels run only there")


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_correct_on_the_card(card, cell):
    p = subprocess.run(
        [sys.executable, os.path.join(ROOT, "bench", "run.py"),
         "--workload", cell, "--seed", "3141592653", "--seconds", "5",
         "--trace", "0"], capture_output=True, text=True, cwd=ROOT,
        timeout=1200)
    assert p.returncode == 0, p.stderr[-4000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
