"""The port's last two examples, `repro_torch.examples.run_scenario` and
`repro_torch.examples.train_group_retraining`, run as a user would with
`--tiny --device cpu`: the scenario's trace has its two windows and
round-trips through `--out`; the training drill restores the checkpoint's
accuracy exactly (the example raises otherwise)."""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.examples import run_scenario  # noqa: E402
from repro_torch.examples import train_group_retraining  # noqa: E402
from repro_torch.testing import trace as T  # noqa: E402


def test_run_scenario_tiny_on_the_cpu(tmp_path):
    out = tmp_path / "trace.json"
    trace = run_scenario.main(["drift_wave", "ecco", "--tiny", "--device",
                               "cpu", "--out", str(out)])
    assert trace["meta"]["scenario"] == "drift_wave"
    assert len(trace["windows"]) == run_scenario.TINY_WINDOWS
    assert T.compare(T.load_trace(str(out)), trace) == []


def test_train_group_retraining_tiny_on_the_cpu(tmp_path):
    res = train_group_retraining.main(["--tiny", "--device", "cpu",
                                       "--ckpt-dir", str(tmp_path / "ck")])
    assert res["step"] == 50
    assert res["acc"] == pytest.approx(res["checkpointed_acc"], abs=1e-6)
