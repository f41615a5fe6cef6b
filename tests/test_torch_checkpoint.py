"""The port's checkpoints (`repro_torch.distributed.checkpoint`): the
round trip of fp32, bf16 and integer leaves bit for bit, atomic step
directories, `AsyncCheckpointer`'s garbage collection, step listing
against the reference's on one directory both packages wrote into,
`restore_job` through the JobBank (tests/test_trainer_bank.py's
`test_checkpoint_restore_writes_through_cache`), and the launcher's
`--ckpt-dir` / `--fail-at-window` against the reference's launcher on the
same flags, engines swapped to fp32 from one initialisation as
tests/test_torch_launch_train.py swaps them."""
import contextlib
import dataclasses
import io
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import TrainConfig as JTrainConfig  # noqa: E402
from repro.core import trainer as jtrainer  # noqa: E402
from repro.distributed import checkpoint as jckpt  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.configs.base import TrainConfig  # noqa: E402
from repro_torch.core import trainer as ttrainer  # noqa: E402
from repro_torch.core.grouping import Request  # noqa: E402
from repro_torch.distributed import checkpoint as ckpt  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402

FP32 = dict(learning_rate=1e-3, b2=0.999, weight_decay=0.0, warmup_steps=5,
            total_steps=100000, remat="none", compute_dtype="float32")
FLAGS = ["--windows", "3", "--regions", "2", "--streams-per-region", "2",
         "--window-micro", "4", "--micro-steps", "2", "--switch-time", "5",
         "--ckpt-every", "1", "--fail-at-window", "1"]


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"params": {"w": torch.randn(3, 5, generator=g),
                       "b": torch.randn(5, generator=g).to(torch.bfloat16)},
            "opt": [torch.arange(4, dtype=torch.int32),
                    np.linspace(0, 1, 6).reshape(2, 3)]}


def _equal(a, b):
    la, lb = ttrainer._flatten(a), ttrainer._flatten(b)   # sorted keys
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        x = torch.as_tensor(x)
        y = torch.as_tensor(y)
        assert x.dtype == y.dtype and torch.equal(x, y), (x, y)


def test_round_trip_fp32_bf16_int_exact(tmp_path):
    tree = _tree()
    path = ckpt.save(str(tmp_path), 5, tree, extra={"window": 2})
    assert os.path.basename(path) == "step_00000005"
    with open(os.path.join(path, "manifest.json")) as f:
        man = json.load(f)
    assert man["num_leaves"] == 4
    # the port's tree order: dict keys sorted ("opt" < "params", "b" < "w")
    assert [m["shape"] for m in man["leaves"]] == [[4], [2, 3], [5], [3, 5]]
    assert man["leaves"][2] == {"shape": [5], "dtype": "uint16",
                                "torch_dtype": "bfloat16"}
    got, extra = ckpt.restore(str(tmp_path), 5, tree)
    assert extra == {"window": 2}
    _equal(got, tree)
    assert got["params"]["b"].dtype == torch.bfloat16
    # a template of meta tensors serves, and devices= places the leaves
    meta = {"params": {"w": torch.empty(3, 5, device="meta"),
                       "b": torch.empty(5, device="meta")},
            "opt": [torch.empty(4, device="meta"),
                    torch.empty(2, 3, device="meta")]}
    got2, _ = ckpt.restore(str(tmp_path), 5, meta, devices="cpu")
    _equal(got2, tree)
    with pytest.raises(ValueError, match="leaves"):
        ckpt.restore(str(tmp_path), 5, {"w": meta["params"]["w"]})


def test_tmp_directory_is_never_listed(tmp_path):
    ckpt.save(str(tmp_path), 1, {"w": torch.zeros(2)})
    os.makedirs(tmp_path / "step_00000009.tmp")
    with open(tmp_path / "step_00000009.tmp" / "manifest.json", "w") as f:
        f.write("{}")
    os.makedirs(tmp_path / "step_00000004")      # no manifest: incomplete
    assert ckpt.list_steps(str(tmp_path)) == [1]
    assert ckpt.latest_step(str(tmp_path)) == 1
    assert ckpt.list_steps(str(tmp_path / "absent")) == []
    assert ckpt.latest_step(str(tmp_path / "absent")) is None


def test_async_checkpointer_keeps_three(tmp_path):
    saver = ckpt.AsyncCheckpointer(str(tmp_path))
    src = torch.zeros(3)
    for step in range(6):
        src += 1.0
        saver.save_async(step, {"w": src})
    saver.wait()
    src += 1.0            # after the copy: what was saved is unchanged
    assert ckpt.list_steps(str(tmp_path)) == [3, 4, 5]
    got, _ = ckpt.restore(str(tmp_path), 5, {"w": src})
    assert torch.equal(got["w"], torch.full((3,), 6.0))
    assert saver.last_path.endswith("step_00000005")


def test_step_listing_agrees_with_the_reference(tmp_path):
    d = str(tmp_path)
    ckpt.save(d, 0, {"a": torch.ones(2), "b": torch.zeros(3)})
    jckpt.save(d, 3, {"a": jnp.ones(2), "b": jnp.zeros(3)})
    ckpt.save(d, 7, {"a": torch.ones(2), "b": torch.zeros(3)})
    os.makedirs(os.path.join(d, "step_00000009.tmp"))
    assert ckpt.list_steps(d) == jckpt.list_steps(d) == [0, 3, 7]
    assert ckpt.latest_step(d) == jckpt.latest_step(d) == 7
    # an fp32 dict tree reads back across the packages, leaf for leaf
    mine, _ = ckpt.restore(d, 3, {"a": torch.empty(2), "b": torch.empty(3)})
    theirs, _ = jckpt.restore(d, 0, {"a": jnp.zeros(2), "b": jnp.zeros(3)})
    np.testing.assert_array_equal(mine["a"].numpy(), np.ones(2))
    np.testing.assert_array_equal(theirs["b"], np.zeros(3))


def _req(sid, toks):
    return Request(stream_id=sid, t=0.0, loc=(0.0, 0.0), subsamples=toks,
                   acc=0.0, train_data=toks)


def test_checkpoint_restore_writes_through_cache(tmp_path):
    """save reads through the lazy host sync; restore_job writes back
    through the bank and the restored row is what fleet calls see."""
    cfg = dataclasses.replace(smoke_config("olmo-1b"), vocab_size=64)
    engine = ttrainer.SharedEngine(cfg, device="cpu")
    rng = np.random.default_rng(13)
    job = ttrainer.RetrainJob(engine, _req("ck0", rng.integers(0, 64, (8, 32))),
                              micro_steps=2, batch=4, seed=7)
    data = job.members[0].subsamples
    job.train_micro()                # device-authoritative row
    snap = job.state
    acc0 = job.eval_on(data)
    ckpt.save(str(tmp_path), 3, job.state, extra={"acc": acc0})
    job.train_micro()                # diverge past the snapshot
    s = engine.bank.stats
    s.reset()
    extra = ckpt.restore_job(str(tmp_path), 3, job)
    assert s.d2h_syncs == 0          # the template is structure only: the
    assert s.h2d_syncs == 0          # restore itself moves no state
    _equal(job.state, snap)
    assert job.eval_on(data) == acc0 == extra["acc"]


@pytest.fixture(scope="module")
def launches(tmp_path_factory):
    """Both launchers on FLAGS with a checkpoint directory each, engines
    swapped to fp32 from the reference engine's fresh_state(0)."""
    out = tmp_path_factory.mktemp("launch_ckpt")
    made = {}
    mp = pytest.MonkeyPatch()
    real_j, real_t = jtrainer.SharedEngine, ttrainer.SharedEngine

    def jengine(cfg, *a, **k):
        made["jax"] = real_j(cfg, JTrainConfig(**FP32))
        return made["jax"]

    def tengine(cfg, *a, device="cuda", **k):
        init = jax.tree.map(np.asarray, made["jax"].fresh_state(0)["params"])
        return real_t(cfg, TrainConfig(**FP32), device=device,
                      init_params={0: init})

    mp.setattr(jtrainer, "SharedEngine", jengine)
    mp.setattr(ttrainer, "SharedEngine", tengine)
    logs = {}
    try:
        for name, fn, extra in (
                ("jax", jtrain.main, []),
                ("torch", ttrain.main, ["--device", "cpu"])):
            jtrainer._job_counter.n = 0
            ttrainer._job_counter.n = 0
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                final = fn(FLAGS + extra + [
                    "--ckpt-dir", str(out / name),
                    "--json-out", str(out / f"{name}.json")])
            with open(out / f"{name}.json") as f:
                logs[name] = (final, buf.getvalue().splitlines(),
                              json.load(f), str(out / name))
    finally:
        mp.undo()
    return logs


def test_launcher_checkpoint_and_recovery_match_the_reference(launches):
    jfinal, jlines, jj, jdir = launches["jax"]
    tfinal, tlines, tj, tdir = launches["torch"]
    win = [ln for ln in tlines if ln.startswith("[w")]
    assert win == [ln for ln in jlines if ln.startswith("[w")]
    assert any("recovered job" in ln and "step 0 (window 0)" in ln
               for ln in win), win
    assert [w["groups"] for w in tj["history"]] == \
        [w["groups"] for w in jj["history"]]
    assert [w["acc"] for w in tj["history"]] == \
        [w["acc"] for w in jj["history"]]
    assert tfinal == jfinal
    assert ckpt.list_steps(tdir) == jckpt.list_steps(jdir) == [0, 1, 2]
