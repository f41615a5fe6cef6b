"""The port's window-loop launcher (`python -m repro_torch.launch.train`)
on the CPU, and against the reference's `repro.launch.train.main` on the
same flags.

Each launcher builds its own engine from its own random initialisation,
so the comparison swaps the engine constructor in both packages: fp32
compute, and the port's jobs starting from the reference engine's
`fresh_state(0)` parameters, bridged. The launchers gain no flag for
this. Under that swap, every window's groups and the final mean accuracy
must equal the reference's.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402

from repro.configs.base import TrainConfig as JTrainConfig  # noqa: E402
from repro.core import trainer as jtrainer  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro_torch.configs.base import TrainConfig  # noqa: E402
from repro_torch.core import trainer as ttrainer  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402

FP32 = dict(learning_rate=1e-3, b2=0.999, weight_decay=0.0, warmup_steps=5,
            total_steps=100000, remat="none", compute_dtype="float32")
FLAGS = ["--windows", "2", "--regions", "2", "--streams-per-region", "2",
         "--window-micro", "4", "--micro-steps", "2", "--switch-time", "5"]
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _canon(history):
    """Each window's groups with job ids renamed by first appearance."""
    names = {}
    out = []
    for w in history:
        out.append({names.setdefault(k, f"g{len(names)}"): v
                    for k, v in w["groups"].items()})
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both launchers on FLAGS with the engine swap; returns
    ((final, json) of the reference, (final, json) of the port)."""
    out = tmp_path_factory.mktemp("launch")
    made = {}
    mp = pytest.MonkeyPatch()
    real_j, real_t = jtrainer.SharedEngine, ttrainer.SharedEngine

    def jengine(cfg, *a, **k):
        made["jax"] = real_j(cfg, JTrainConfig(**FP32))
        return made["jax"]

    def tengine(cfg, *a, device="cuda", **k):
        init = jax.tree.map(np.asarray,
                            made["jax"].fresh_state(0)["params"])
        return real_t(cfg, TrainConfig(**FP32), device=device,
                      init_params={0: init})

    mp.setattr(jtrainer, "SharedEngine", jengine)
    mp.setattr(ttrainer, "SharedEngine", tengine)
    try:
        jfinal = jtrain.main(FLAGS + ["--json-out", str(out / "j.json")])
        tfinal = ttrain.main(FLAGS + ["--device", "cpu",
                                      "--json-out", str(out / "t.json")])
    finally:
        mp.undo()
    with open(out / "j.json") as f:
        jj = json.load(f)
    with open(out / "t.json") as f:
        tj = json.load(f)
    return (jfinal, jj), (tfinal, tj)


def test_two_windows_on_the_cpu_write_the_reference_keys(runs):
    (jfinal, jj), (tfinal, tj) = runs
    assert np.isfinite(tfinal)
    assert set(tj) == set(jj) == {"framework", "arch", "final_acc",
                                  "history"}
    assert len(tj["history"]) == 2
    assert [set(w) for w in tj["history"]] == [set(w) for w in jj["history"]]
    assert (tj["framework"], tj["arch"]) == (jj["framework"], jj["arch"])


def test_launcher_agrees_with_the_reference(runs):
    (jfinal, jj), (tfinal, tj) = runs
    assert _canon(tj["history"]) == _canon(jj["history"])
    assert [w["t"] for w in tj["history"]] == [w["t"] for w in jj["history"]]
    assert tfinal == jfinal
    assert tj["final_acc"] == jj["final_acc"]
    assert any(w["groups"] for w in tj["history"])   # something grouped


def test_checkpoint_flags_refused(tmp_path):
    """The checkpoint flags, refused until the port had checkpoints, now
    run (tests/test_torch_checkpoint.py holds them to the reference);
    what is refused is a checkpoint interval below one window."""
    ttrain.main(FLAGS + ["--device", "cpu", "--ckpt-dir", str(tmp_path),
                         "--ckpt-every", "1", "--fail-at-window", "1"])
    assert sorted(os.listdir(tmp_path)) == ["step_00000000",
                                            "step_00000001"]
    with pytest.raises(ValueError, match="ckpt-every"):
        ttrain.main(FLAGS + ["--device", "cpu", "--ckpt-every", "0"])


def test_default_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ttrain.main(FLAGS)


def test_module_entry_point_runs_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu",
         "--windows", "1", "--regions", "1", "--streams-per-region", "2",
         "--window-micro", "2", "--micro-steps", "1"],
        env=env, capture_output=True, text=True, timeout=240)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "[w0]" in r.stdout and "final mean accuracy=" in r.stdout
