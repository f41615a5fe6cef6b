"""The port's serving slice held to the JAX package, and its slot
lifecycle (the cases of tests/test_serve.py) on the port.

The slice as a whole: the port's `ServeLoop` (fp32 compute, CPU) serves
requests of mixed prompt lengths, more requests than slots, and must emit
the tokens of a JAX greedy reference driven through `make_prefill_step` /
`make_decode_step` at fp32 compute, on the same bridged weights.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import smoke_config as jax_smoke_config  # noqa: E402
from repro.models.model import build_model as jax_build_model  # noqa: E402
from repro.serve.serve_step import make_decode_step, make_prefill_step  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.serve.kvcache import CacheManager, ServeLoop  # noqa: E402

VOCAB = 64
# logit agreement of fp32 compute over a bf16 cache
# (tests/test_torch_model.py BF16_CACHE_TOL). Greedy tokens are compared
# exactly, so the test asserts that the reference's top-1/top-2 gap exceeds
# twice this at every step (each of the two logits may move by it): no
# near-tie decides a token.
LOGIT_TOL = 5e-3


def _port_model(seed=0):
    cfg = dataclasses.replace(smoke_config("olmo-1b"), vocab_size=VOCAB)
    model = build_model(cfg)
    return cfg, model, model.init(seed=seed, device="cpu")


def _jax_reference(jm, jp, prompt, max_new, cap):
    """Greedy transcript through the JAX serve steps at fp32 compute, and
    the top-1/top-2 logit gap at every step."""
    f32 = jnp.float32
    prefill = jax.jit(make_prefill_step(jm, cap, compute_dtype=f32))
    decode = jax.jit(make_decode_step(jm, compute_dtype=f32))
    tok, cache, pos = prefill(jp, jnp.asarray(prompt)[None])
    last, _, _ = jm.prefill(jp, jnp.asarray(prompt)[None], cap,
                            compute_dtype=f32)
    logits = [np.asarray(last[0], np.float32)]
    out = [int(tok[0])]
    nxt = tok[:, None].astype(jnp.int32)
    lcache = cache
    for step in range(max_new - 1):
        lg, lcache = jm.decode(jp, nxt, lcache, pos + step,
                               compute_dtype=f32)
        logits.append(np.asarray(lg[0, -1], np.float32))
        nxt, cache = decode(jp, nxt, cache, pos + step)
        out.append(int(nxt[0, 0]))
    gaps = [float(np.diff(np.sort(lg[:VOCAB])[-2:])[0]) for lg in logits]
    assert [int(np.argmax(lg)) for lg in logits] == out
    return out, gaps


def test_serve_loop_matches_jax_greedy_reference():
    jcfg = dataclasses.replace(jax_smoke_config("olmo-1b"), vocab_size=VOCAB)
    tcfg = dataclasses.replace(smoke_config("olmo-1b"), vocab_size=VOCAB)
    jm = jax_build_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = build_model(tcfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    rng = np.random.default_rng(4)
    prompts = {f"r{i}": rng.integers(0, VOCAB, size=n)
               for i, n in enumerate([10, 7, 12])}
    capacity, max_new = 32, 6

    loop = ServeLoop(tm, tp, num_slots=2, capacity=capacity,
                     max_new=max_new, compute_dtype=torch.float32)
    pending = list(prompts.items())
    done = {}
    while pending or loop.mgr.active():
        while pending and loop.mgr.free_slots():
            loop.submit(*pending.pop(0))
        loop.tick()
        done.update(loop.drain())
    assert set(done) == set(prompts)
    # two requests at different positions share ticks: one call each
    assert loop.decode_calls > max_new - 1

    for rid, prompt in prompts.items():
        want, gaps = _jax_reference(jm, jp, prompt, max_new, capacity)
        assert min(gaps) > 2 * LOGIT_TOL, (rid, gaps)
        assert done[rid] == want, (rid, done[rid], want)


def test_slot_admission_and_release():
    cfg, model, params = _port_model()
    mgr = CacheManager(model, num_slots=3, capacity=32, device="cpu")
    a = mgr.admit("r1")
    b = mgr.admit("r2")
    assert a != b
    assert len(mgr.free_slots()) == 1
    assert mgr.utilization() == pytest.approx(2 / 3)
    mgr.release(a)
    assert len(mgr.free_slots()) == 2
    assert mgr.admit("r3") == a                  # slot recycled


def test_pool_exhaustion_raises():
    cfg, model, params = _port_model()
    mgr = CacheManager(model, num_slots=1, capacity=16, device="cpu")
    mgr.admit("r1")
    with pytest.raises(RuntimeError, match="exhausted"):
        mgr.admit("r2")


def _solo_outputs(model, params, prompt, max_new, capacity=32, eos_id=None):
    """Reference transcript: a dedicated single-slot loop."""
    loop = ServeLoop(model, params, num_slots=1, capacity=capacity,
                     max_new=max_new, eos_id=eos_id)
    loop.submit("solo", prompt)
    loop.run_until_drained()
    return loop.outputs["solo"]


def test_submit_retires_at_max_new_1():
    cfg, model, params = _port_model()
    prompt = np.random.default_rng(3).integers(0, VOCAB, size=8)
    loop = ServeLoop(model, params, num_slots=2, capacity=32, max_new=1)
    loop.submit("a", prompt)
    assert not loop.mgr.active()                 # retired at submit
    assert len(loop.outputs["a"]) == 1
    assert loop.tick() == {}                     # nothing left to decode
    assert loop.decode_calls == 0
    done = loop.drain()
    assert set(done) == {"a"} and len(done["a"]) == 1
    assert "a" not in loop.outputs


def test_submit_retires_on_eos_prefill_token():
    cfg, model, params = _port_model()
    prompt = np.random.default_rng(4).integers(0, VOCAB, size=8)
    first = _solo_outputs(model, params, prompt, max_new=4)[0]
    loop = ServeLoop(model, params, num_slots=2, capacity=32, max_new=4,
                     eos_id=first)
    loop.submit("a", prompt)
    assert not loop.mgr.active()
    assert loop.outputs["a"] == [first]
    assert loop.tick() == {}
    assert loop.outputs["a"] == [first]


def test_release_clears_per_slot_decode_state():
    """Retirement clears the slot's pending token, and a recycled slot
    serves the next request like a fresh loop."""
    cfg, model, params = _port_model()
    rng = np.random.default_rng(5)
    p1 = rng.integers(0, VOCAB, size=8)
    p2 = rng.integers(0, VOCAB, size=8)
    loop = ServeLoop(model, params, num_slots=1, capacity=32, max_new=3)
    slot1 = loop.submit("a", p1)
    loop.run_until_drained()
    assert loop._new_tokens == {}
    assert loop.submit("b", p2) == slot1
    loop.run_until_drained()
    assert loop.outputs["b"] == _solo_outputs(model, params, p2, 3)


def test_drain_keeps_outputs_bounded():
    cfg, model, params = _port_model()
    rng = np.random.default_rng(6)
    loop = ServeLoop(model, params, num_slots=4, capacity=32, max_new=2)
    for i in range(3):
        loop.submit(f"r{i}", rng.integers(0, VOCAB, size=8))
    loop.run_until_drained()
    loop.submit("late", rng.integers(0, VOCAB, size=8))
    done = loop.drain()
    assert set(done) == {"r0", "r1", "r2"}
    assert all(len(v) == 2 for v in done.values())
    assert set(loop.outputs) == {"late"}         # in-flight request kept
    assert loop.drain() == {}                    # idempotent


def test_admission_capacity_check():
    """prompt_len + max_new - 1 <= capacity; the exactly-fitting prompt
    admits and an oversized one raises before touching a slot."""
    cfg, model, params = _port_model()
    rng = np.random.default_rng(7)
    cap, max_new = 16, 4
    loop = ServeLoop(model, params, num_slots=2, capacity=cap,
                     max_new=max_new)
    fit = cap - max_new + 1
    loop.submit("ok", rng.integers(0, VOCAB, size=fit))
    loop.run_until_drained()
    assert len(loop.outputs["ok"]) == max_new
    with pytest.raises(ValueError, match="does not fit"):
        loop.submit("big", rng.integers(0, VOCAB, size=fit + 1))
    with pytest.raises(ValueError, match="max_new"):
        loop.mgr.check_fit(4, 0)
    assert len(loop.mgr.free_slots()) == 2


@pytest.mark.parametrize("lens", [[10, 7, 10, 5], [8, 5, 8]],
                         ids=["staggered", "scattered-slots"])
def test_multi_slot_tick_matches_sequential_decode(lens):
    """A multi-slot tick over requests at different positions emits the
    tokens of decoding each request alone. [8, 5, 8] puts slots 0 and 2
    at one position and slot 1 at another: the non-contiguous slots are
    gathered, decoded and written back."""
    cfg, model, params = _port_model()
    rng = np.random.default_rng(8)
    prompts = [rng.integers(0, VOCAB, size=s) for s in lens]
    max_new = 5
    loop = ServeLoop(model, params, num_slots=len(lens), capacity=32,
                     max_new=max_new)
    if len(lens) == 4:           # staggered admission
        loop.submit("r0", prompts[0])
        loop.tick()
        loop.submit("r1", prompts[1])
        loop.submit("r2", prompts[2])
        loop.tick()
        loop.submit("r3", prompts[3])
    else:
        for i, p in enumerate(prompts):
            loop.submit(f"r{i}", p)
        assert loop.mgr.slots[0].pos == loop.mgr.slots[2].pos
    loop.run_until_drained()
    for i, p in enumerate(prompts):
        assert loop.outputs[f"r{i}"] == _solo_outputs(model, params, p,
                                                      max_new), i


def test_serve_loop_isolation_between_requests():
    cfg, model, params = _port_model()
    rng = np.random.default_rng(2)
    p1 = rng.integers(0, VOCAB, size=8)
    p2 = rng.integers(0, VOCAB, size=8)
    solo = ServeLoop(model, params, num_slots=2, capacity=32, max_new=4)
    solo.submit("a", p1)
    solo.run_until_drained()
    duo = ServeLoop(model, params, num_slots=2, capacity=32, max_new=4)
    duo.submit("a", p1)
    duo.submit("b", p2)
    duo.run_until_drained()
    assert solo.outputs["a"] == duo.outputs["a"]


def test_launcher_serves_on_cpu_when_asked():
    report = launch_serve.main(["--device", "cpu", "--requests", "3",
                                "--num-slots", "2", "--prompt-len", "6",
                                "--max-new", "4", "--capacity", "16"])
    out = report["outputs"]
    assert sorted(out) == ["req0", "req1", "req2"]
    assert all(len(v) == 4 and all(0 <= t < 256 for t in v)
               for v in out.values())
    assert len(report["prefill_s"]) == 3
    assert report["decode_calls"] >= 2 * 3


def test_launcher_raises_without_cuda(monkeypatch):
    """Without CUDA and without --device cpu the entry point raises; it
    never falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        launch_serve.main([])
