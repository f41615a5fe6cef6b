"""The port's mLSTM scan and xLSTM cells held to the JAX package.

Inputs come from numpy with a fixed seed and go through the JAX oracle
`repro.kernels.ref.mlstm_recurrent`, the JAX Pallas kernel `mlstm_scan` in
interpret mode, the JAX chunked form `repro.models.xlstm.mlstm_chunked`,
and the port's `repro_torch.kernels.ops.mlstm` (on the CPU: the plain
chunked form). The CUDA kernel itself runs only on the card:
`chip_smoke.py` holds it to the plain version there, and the `gpu`-marked
test below does the same when a card is present.

The JAX chunked form's final state is wrong when S is longer than the
chunk and not a multiple of it (it pads the raw forget gate with 0, so
every padded step decays the state by sigmoid(0)); the port takes the oracle's and the Pallas
kernel's semantics, and `test_jax_chunked_final_state_defect_at_ragged_S`
shows the difference.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.mlstm_scan import mlstm_scan as jmlstm_scan  # noqa: E402
from repro.models import xlstm as jx  # noqa: E402
from repro_torch.kernels import mlstm_scan as ml_mod  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels.mlstm_scan import mlstm_scan  # noqa: E402
from repro_torch.models import xlstm as tx  # noqa: E402

# the tolerances of tests/test_kernels.py
TOL = {"float32": dict(atol=2e-4, rtol=2e-4),
       "bfloat16": dict(atol=2e-2, rtol=2e-2)}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# the JAX functions, compiled once per shape
j_recurrent = jax.jit(jref.mlstm_recurrent, static_argnames=("return_state",))
j_chunked = jax.jit(jx.mlstm_chunked, static_argnames=("chunk",
                                                       "return_state"))
j_mlstm_step = jax.jit(jx.mlstm_step)
j_slstm_scan = jax.jit(jx.slstm_scan, static_argnums=2)
# the sweep of tests/test_kernels.py::test_mlstm_kernel_sweep
SWEEP = [(1, 64, 2, 32, 16),
         (2, 96, 3, 16, 32),      # ragged chunks
         (1, 33, 1, 64, 32)]      # pad


def _inputs(B, S, H, P, dtype="float32", seed=0):
    """q, k, v normal, input gate 2 z, forget gate 2 z + 1 (the JAX sweep's
    draws), as float32 numpy rounded to `dtype`."""
    rng = np.random.default_rng(seed)

    def rnd(shape, scale=1.0, shift=0.0):
        a = (rng.standard_normal(shape) * scale + shift).astype(np.float32)
        return np.asarray(jnp.asarray(a, JDT[dtype]), np.float32)

    return (rnd((B, S, H, P)), rnd((B, S, H, P)), rnd((B, S, H, P)),
            rnd((B, S, H), 2.0), rnd((B, S, H), 2.0, 1.0))


def _jax(arrays, dtype="float32"):
    return tuple(jnp.asarray(a, JDT[dtype]) for a in arrays)


def _torch(arrays, dtype="float32", device="cpu"):
    return tuple(torch.from_numpy(np.array(a)).to(device, TDT[dtype])
                 for a in arrays)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().cpu().numpy()
    return np.asarray(x, np.float32)


def _state(B, H, P, seed):
    """A nonzero (C, n, m) state, m finite."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, H, P, P)).astype(np.float32),
            rng.standard_normal((B, H, P)).astype(np.float32),
            rng.standard_normal((B, H)).astype(np.float32))


@pytest.mark.parametrize("B,S,H,P,chunk", SWEEP)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mlstm_matches_pallas_interpret_and_oracle(B, S, H, P, chunk, dtype):
    arrays = _inputs(B, S, H, P, dtype)
    jin, tin = _jax(arrays, dtype), _torch(arrays, dtype)
    got = ops.mlstm(*tin, chunk=chunk)
    assert got.dtype == TDT[dtype] and got.shape == (B, S, H, P)
    pallas = jmlstm_scan(*jin, chunk=chunk, interpret=True)
    oracle = j_recurrent(*jin)
    np.testing.assert_allclose(_np(got), _np(pallas), **TOL[dtype])
    np.testing.assert_allclose(_np(got), _np(oracle), **TOL[dtype])
    # the port's own oracle (impl="ref") is the JAX oracle's copy
    np.testing.assert_allclose(_np(ops.mlstm(*tin, impl="ref")), _np(oracle),
                               **TOL[dtype])


@pytest.mark.parametrize("S,chunk", [(64, 64), (96, 32), (96, 64),
                                     (70, 64)])
@pytest.mark.parametrize("init", [False, True], ids=["zero", "init_state"])
def test_final_state_matches_oracle(S, chunk, init):
    """The chunked form's final (C, n, m) equals the token-by-token
    oracle's at aligned (64/64, 96/32) and ragged (96/64, 70/64) lengths,
    from a zero state and from a given one; its output too."""
    arrays = _inputs(2, S, 2, 16, seed=S + chunk)
    st = _state(2, 2, 16, seed=5) if init else None
    jy, jst = j_recurrent(*_jax(arrays), return_state=True,
                          init_state=None if st is None else
                          tuple(jnp.asarray(s) for s in st))
    y, tst = tref.mlstm_chunked(
        *_torch(arrays), chunk=chunk, return_state=True,
        init_state=None if st is None else
        tuple(torch.from_numpy(s) for s in st))
    assert [tuple(s.shape) for s in tst] == [(2, 2, 16, 16), (2, 2, 16),
                                             (2, 2)]
    assert all(s.dtype == torch.float32 for s in tst)
    np.testing.assert_allclose(_np(y), _np(jy), **TOL["float32"])
    for a, w in zip(tst, jst):
        np.testing.assert_allclose(_np(a), _np(w), **TOL["float32"])
    # ops.mlstm on a CPU tensor returns the same state
    _, ost = ops.mlstm(*_torch(arrays), chunk=chunk, return_state=True)
    if not init:
        for a, w in zip(ost, tst):
            np.testing.assert_allclose(_np(a), _np(w), atol=0, rtol=0)


def test_jax_chunked_final_state_defect_at_ragged_S():
    """At S = 70, chunk 64, the JAX XLA form's final m is far from the
    oracle's (its 58 padded steps each add log sigmoid(0) = -0.693 to the
    decay), while the port's equals it; at S = 64 all three agree."""
    for S, defect in ((64, False), (70, True)):
        arrays = _inputs(1, S, 2, 16, seed=11)
        _, (_, _, om) = j_recurrent(*_jax(arrays), return_state=True)
        _, (_, _, jm) = j_chunked(*_jax(arrays), chunk=64, return_state=True)
        _, (_, _, tm) = tref.mlstm_chunked(*_torch(arrays), chunk=64,
                                           return_state=True)
        np.testing.assert_allclose(_np(tm), _np(om), **TOL["float32"])
        gap = float(np.abs(_np(jm) - _np(om)).max())
        assert (gap > 1.0) if defect else (gap < 2e-4), (S, gap)


def _cfg():
    """A config whose mLSTM heads are (3, 8): d_model 12, expand 2."""
    from repro_torch.configs.base import SSM, ModelConfig, SSMConfig
    return ModelConfig(name="t", family=SSM, num_layers=2, d_model=12,
                       num_heads=3, num_kv_heads=3, d_ff=0, vocab_size=16,
                       norm="layernorm", act="gelu",
                       ssm=SSMConfig(state_dim=0, conv_width=4, expand=2,
                                     slstm_every=2))


def test_mlstm_step_matches_jax_and_chains_to_the_scan():
    arrays = _inputs(2, 21, 3, 8, seed=3)
    q, k, v, ig, fg = _torch(arrays)
    jin = _jax(arrays)
    y_scan, st_scan = tref.mlstm_chunked(q, k, v, ig, fg, chunk=8,
                                         return_state=True)
    st = tx.mlstm_init_cache(_cfg(), 2, torch.float32)    # heads (3, 8)
    st = (st["C"], st["n"], st["m"])
    jst = (jnp.zeros((2, 3, 8, 8)), jnp.zeros((2, 3, 8)),
           jnp.full((2, 3), -jnp.inf))
    ys = []
    for t in range(q.shape[1]):
        y, st = tx.mlstm_step(q[:, t], k[:, t], v[:, t], ig[:, t], fg[:, t],
                              st)
        jy, jst = j_mlstm_step(*(a[:, t] for a in jin), jst)
        np.testing.assert_allclose(_np(y), _np(jy), **TOL["float32"])
        ys.append(y)
    np.testing.assert_allclose(_np(torch.stack(ys, 1)), _np(y_scan),
                               **TOL["float32"])
    for a, w, s in zip(st, jst, st_scan):
        np.testing.assert_allclose(_np(a), _np(w), **TOL["float32"])
        np.testing.assert_allclose(_np(a), _np(s), **TOL["float32"])


@pytest.mark.parametrize("init", [False, True], ids=["zero", "init_state"])
def test_slstm_scan_matches_jax(init):
    """Gates (B=2, S=17, 4, H=3, P=8), recurrent weights at the spec's
    0.5/sqrt(P) scale; from a zero state and from a given one (m finite)."""
    rng = np.random.default_rng(7)
    g = rng.standard_normal((2, 17, 4, 3, 8)).astype(np.float32)
    rw = (0.5 / np.sqrt(8) * rng.standard_normal((4, 3, 8, 8))).astype(
        np.float32)
    st = None
    if init:
        st = tuple(rng.standard_normal((2, 3, 8)).astype(np.float32)
                   for _ in range(4))
    jh, jst = j_slstm_scan(jnp.asarray(g), jnp.asarray(rw), 3,
                           None if st is None else
                           tuple(jnp.asarray(s) for s in st))
    th, tst = tx.slstm_scan(torch.from_numpy(g), torch.from_numpy(rw), 3,
                            init_state=None if st is None else
                            tuple(torch.from_numpy(s) for s in st))
    assert th.shape == (2, 17, 3, 8) and th.dtype == torch.float32
    np.testing.assert_allclose(_np(th), _np(jh), **TOL["float32"])
    for a, w in zip(tst, jst):
        assert tuple(a.shape) == (2, 3, 8)
        np.testing.assert_allclose(_np(a), _np(w), **TOL["float32"])


def test_ops_mlstm_rejects_unknown_impl():
    with pytest.raises(ValueError, match="unknown mlstm impl"):
        ops.mlstm(*_torch(_inputs(1, 4, 1, 4)), impl="pallas")


def test_mlstm_scan_rejects_unknown_device():
    meta = tuple(torch.empty(s, device="meta")
                 for s in ((1, 4, 1, 4),) * 3 + ((1, 4, 1),) * 2)
    with pytest.raises(ValueError, match="no mlstm_scan for device meta"):
        mlstm_scan(*meta)


def _bad(what):
    """Inputs that break one rule of the kernel's wrapper."""
    q, k, v, ig, fg = _torch(_inputs(1, 8, 2, 4))
    return {"rank": (q[0], k, v, ig, fg),
            "k shape": (q, k[:, :4], v, ig, fg),
            "gate shape": (q, k, v, ig[..., :1], fg),
            "q dtype": (q.double(), k, v, ig, fg),
            "v dtype": (q, k, v.bfloat16(), ig, fg),
            "gate dtype": (q, k, v, ig, fg.bfloat16()),
            "strided last dim": (q, k.transpose(1, 3).contiguous()
                                 .transpose(1, 3), v, ig, fg)}[what]


@pytest.mark.parametrize("what,err", [
    ("rank", ValueError), ("k shape", ValueError),
    ("gate shape", ValueError), ("q dtype", TypeError),
    ("v dtype", TypeError), ("gate dtype", TypeError),
    ("strided last dim", ValueError)])
def test_kernel_wrapper_rejects_what_the_kernel_does_not_take(what, err):
    """The checks the wrapper runs before a launch (on a CUDA tensor; here
    called directly, since a CPU tensor takes the plain version)."""
    with pytest.raises(err):
        ml_mod._check(*_bad(what), 8)


def test_kernel_wrapper_checks_chunk_and_shared_memory():
    args = _torch(_inputs(1, 8, 2, 4))
    ml_mod._check(*args, 128)
    with pytest.raises(ValueError, match="chunk"):
        ml_mod._check(*args, 129)
    # xlstm-350m's head dim at its chunk: 32 rows of C plus the tiles
    assert ml_mod.smem_bytes(64, 512) == 4 * (512 * 32 + 512 + 2 * 64 * 33
                                              + 2 * 64 * 32 + 64 * 65
                                              + 6 * 64 + 4)
    assert ml_mod.smem_bytes(128, 512) <= ml_mod.MAX_SMEM_BYTES
    assert [ml_mod.chunk_tile(q) for q in (1, 16, 17, 64, 65, 128)] == \
        [16, 16, 32, 64, 128, 128]
    wide = tuple(torch.zeros(s) for s in ((1, 8, 1, 2048),) * 3
                 + ((1, 8, 1),) * 2)
    with pytest.raises(ValueError, match="shared memory"):
        ml_mod._check(*wide, 64)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_kernel_matches_plain_version(dtype):
    """The Hopper kernel against the plain version on the card, final
    state included, on the sweep and at xlstm-350m's head width P = 512
    over ragged short sequences at chunks of both tensor-core tiles (64;
    96 and 128 take the 128-step tile) (needs a CUDA device and nvcc;
    chip_smoke.py runs xlstm-350m's prefill shape)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for B, S, H, P, chunk in SWEEP + [(1, 80, 2, 512, 64),
                                      (1, 200, 2, 512, 96),
                                      (1, 300, 1, 512, 128)]:
        tin = _torch(_inputs(B, S, H, P, dtype), dtype, device="cuda")
        before = mlstm_scan.launches
        got, st = mlstm_scan(*tin, chunk=chunk, return_state=True)
        assert mlstm_scan.launches == before + 1
        want, wst = tref.mlstm_chunked(*tin, chunk=chunk, return_state=True)
        np.testing.assert_allclose(_np(got), _np(want), **TOL[dtype])
        for a, w in zip(st, wst):
            np.testing.assert_allclose(_np(a), _np(w), **TOL[dtype])
