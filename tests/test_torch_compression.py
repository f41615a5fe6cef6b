"""The port's gradient compression (`repro_torch.train.compression`) held
to the JAX package's `repro.train.compression`.

`quantize_int8` must give the reference's int8 values and fp32 scale bit
for bit. `compressed_psum` over a pod axis of 2 and 4 CPU entries (each
holding its own tensor) is held to a numpy computation made from the
reference's `quantize_int8` per participant: the int32 sum, the largest
scale, the division by the count. The reference's own tests
(tests/test_substrate.py) are restated on the port.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.train import compression as jcomp  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.configs.base import TrainConfig  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.train import compression as comp  # noqa: E402
from repro_torch.train import train_step as tts  # noqa: E402


def _x(shape, seed, scale=3.0, dtype=np.float32):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(dtype)


@pytest.mark.parametrize("case", ["normal", "tiny", "zeros", "ties", "big",
                                  "bf16"])
def test_quantize_int8_is_bit_for_bit(case):
    x = {"normal": _x((257,), 0), "tiny": _x((64, 3), 1, 1e-30),
         "zeros": np.zeros((5, 7), np.float32),
         "ties": (np.arange(-300, 301, dtype=np.float32) / 2.0),
         "big": _x((4, 33), 2, 1e30), "bf16": _x((129,), 3)}[case]
    if case == "bf16":
        t = torch.from_numpy(x).to(torch.bfloat16)
        jx = jnp.asarray(x).astype(jnp.bfloat16)
    else:
        t, jx = torch.from_numpy(x), jnp.asarray(x)
    q, s = comp.quantize_int8(t)
    jq, js = jcomp.quantize_int8(jx)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert s.numpy().tobytes() == np.asarray(js).tobytes()
    back = comp.dequantize_int8(q, s)
    np.testing.assert_array_equal(back.numpy(),
                                  np.asarray(jcomp.dequantize_int8(jq, js)))


def test_int8_quantization_error_bound():
    x = torch.from_numpy(_x((256,), 4))
    q, s = comp.quantize_int8(x)
    assert float((comp.dequantize_int8(q, s) - x).abs().max()) \
        <= float(s) / 2 + 1e-6


def test_error_feedback_is_unbiased_over_time():
    """Sum of compressed grads + final residual == sum of true grads."""
    grads = [torch.from_numpy(_x((64,), 10 + i, 1.0)) for i in range(10)]

    def compress(x):
        return comp.dequantize_int8(*comp.quantize_int8(x))

    residual, sent = None, torch.zeros(64)
    jresidual, jsent = None, jnp.zeros((64,))
    for g in grads:
        c, residual = comp.with_error_feedback({"g": g}, residual, compress)
        jc, jresidual = jcomp.with_error_feedback(
            {"g": jnp.asarray(g.numpy())}, jresidual,
            lambda x: jcomp.dequantize_int8(*jcomp.quantize_int8(x)))
        np.testing.assert_array_equal(c["g"].numpy(), np.asarray(jc["g"]))
        sent, jsent = sent + c["g"], jsent + jc["g"]
    np.testing.assert_allclose((sent + residual["g"]).numpy(),
                               sum(g.numpy() for g in grads), atol=1e-4)


@pytest.mark.parametrize("frac", [0.4, 0.01, 1.0])
def test_topk_mask_equals_the_reference(frac):
    x = np.asarray([0.1, -5.0, 0.2, 3.0, -0.05], np.float32)
    for arr in (x, _x((40, 9), 5)):
        got = comp.topk_mask(torch.from_numpy(arr), frac)
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(jcomp.topk_mask(jnp.asarray(arr), frac)))
    np.testing.assert_array_equal(
        comp.topk_mask(torch.from_numpy(x), 0.4).numpy(), [0, -5.0, 0, 3.0, 0])


def _numpy_psum(parts):
    """The reference's int8 mean over participants, in numpy from its
    quantize_int8 per participant."""
    qs = [jcomp.quantize_int8(jnp.asarray(p)) for p in parts]
    total = np.sum([np.asarray(q).astype(np.int32) for q, _ in qs], axis=0)
    smax = np.max([np.asarray(s) for _, s in qs])
    return (total.astype(np.float32) * smax / np.float32(len(parts))
            ).astype(np.float32)


@pytest.mark.parametrize("n", [2, 4])
def test_compressed_psum_over_a_pod_axis(n):
    mesh = make_mesh((n,), ("pod",), devices=["cpu"] * n)
    assert mesh.shape == {"pod": n}
    parts = [_x((33, 5), 20 + i, scale=1.0 + i) for i in range(n)]
    out = comp.compressed_psum([torch.from_numpy(p) for p in parts])
    want = _numpy_psum(parts)
    assert len(out) == n
    for o in out:
        np.testing.assert_array_equal(o.numpy(), want)
    mean = comp.compressed_psum([torch.from_numpy(p) for p in parts],
                                scheme="none")
    np.testing.assert_allclose(mean[0].numpy(), np.mean(parts, axis=0),
                               atol=1e-6)
    topk = comp.compressed_psum([torch.from_numpy(p) for p in parts],
                                scheme="topk", topk_frac=0.1)
    np.testing.assert_array_equal(topk[0].numpy(), _numpy_psum(
        [np.asarray(jcomp.topk_mask(jnp.asarray(p), 0.1)) for p in parts]))


def test_pod_mean_compressed_over_two_pods():
    """A tree every pod entry holds alike: the compressed mean is its
    quantize / dequantize round trip, leaf by leaf, on the leaf's
    device, in its dtype."""
    mesh = make_mesh((2, 2), ("pod", "data"), devices=["cpu"] * 4)
    tree = {"a": torch.from_numpy(_x((16, 8), 30)),
            "b": [torch.from_numpy(_x((7,), 31, 1e-3))]}
    out = comp.pod_mean_compressed(tree, mesh)
    for got, g in ((out["a"], tree["a"]), (out["b"][0], tree["b"][0])):
        np.testing.assert_array_equal(got.numpy(),
                                      _numpy_psum([g.numpy(), g.numpy()]))
        assert got.dtype == g.dtype and got.device == g.device


def test_pod_mean_compressed_noop_without_pod_axis():
    x = {"g": torch.ones(4)}
    for mesh in (make_mesh((2,), ("data",), devices=["cpu"] * 2),
                 make_mesh((1, 2), ("pod", "data"), devices=["cpu"] * 2)):
        out = comp.pod_mean_compressed(x, mesh)
        assert out is x


def test_wire_bytes_saved():
    d = comp.wire_bytes_saved(10**6, pods=2)
    assert d == jcomp.wire_bytes_saved(10**6, pods=2)
    assert d["fp32_bytes"] == 4 * 10**6 and d["reduction"] == 4.0
    assert comp.wire_bytes_saved(12345, pods=4) == \
        jcomp.wire_bytes_saved(12345, pods=4)


def test_train_step_refuses_compress_pod_grads():
    """The reference's flag is read by no train step of that package; the
    port refuses it, naming that."""
    m = build_model(dataclasses.replace(smoke_config("olmo-1b"),
                                        vocab_size=64))
    with pytest.raises(NotImplementedError,
                       match="read by no train step of the reference"):
        tts.make_train_step(m, TrainConfig(remat="none",
                                           compress_pod_grads=True))
