"""The port's SSD scan and Mamba heads held to the JAX package.

Inputs come from numpy with a fixed seed and go through the JAX oracle
`repro.kernels.ref.ssd_recurrent`, the JAX Pallas kernel `ssd_scan` in
interpret mode, the JAX chunked form `repro.models.ssm.ssd_chunked`, and
the port's `repro_torch.kernels.ops.ssd` (on the CPU: the plain chunked
form). The Mamba head-group runs on weights bridged from the JAX hymba
smoke model. The CUDA kernel itself runs only on the card: `chip_smoke.py`
holds it to the plain version there, and the `gpu`-marked test below does
the same when a card is present.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import smoke_config as jax_smoke_config  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.ssd_scan import ssd_scan as jssd_scan  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.models.param import init_params as jax_init_params  # noqa: E402
from repro_torch.configs import get_config, smoke_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels import ssd_scan as ssd_mod  # noqa: E402
from repro_torch.kernels.ssd_scan import ssd_scan  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402

# the tolerances of tests/test_kernels.py
TOL = {"float32": dict(atol=2e-4, rtol=2e-4),
       "bfloat16": dict(atol=2e-2, rtol=2e-2)}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# the JAX functions, compiled once per shape (eager dispatch of their many
# small ops takes seconds per call on the CPU)
j_ssd_chunked = jax.jit(jssm.ssd_chunked,
                        static_argnames=("chunk", "return_state"))
j_ssd_step = jax.jit(jssm.ssd_step)
j_apply_mamba = jax.jit(jssm.apply_mamba, static_argnums=0,
                        static_argnames=("chunk", "return_cache"))
j_apply_mamba_step = jax.jit(jssm.apply_mamba_step, static_argnums=0)
# the sweep of tests/test_kernels.py::test_ssd_kernel_sweep
SWEEP = [(1, 64, 2, 32, 16, 16),
         (2, 80, 1, 64, 8, 32),       # ragged last chunk
         (1, 32, 4, 16, 32, 32)]


def _inputs(B, S, H, P, N, dtype, seed=0):
    """x, dt (softplus of a normal, in `dtype` as the JAX sweep makes it),
    A = -exp(0.3 z), Bm, Cm, D = 1 + 0.1 z, as float32 numpy; x, dt, Bm
    and Cm rounded to `dtype`."""
    rng = np.random.default_rng(seed)

    def rnd(shape):
        a = rng.standard_normal(shape).astype(np.float32)
        return np.asarray(jnp.asarray(a, JDT[dtype]), np.float32)

    x = rnd((B, S, H, P))
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H)))).astype(np.float32)
    dt = np.asarray(jnp.asarray(dt, JDT[dtype]), np.float32)
    A = -np.exp(0.3 * rng.standard_normal(H)).astype(np.float32)
    Bm, Cm = rnd((B, S, N)), rnd((B, S, N))
    D = (1.0 + 0.1 * rng.standard_normal(H)).astype(np.float32)
    return x, dt, A, Bm, Cm, D


def _jax(arrays, dtype):
    x, dt, A, Bm, Cm, D = arrays
    j = JDT[dtype]
    return (jnp.asarray(x, j), jnp.asarray(dt, j), jnp.asarray(A),
            jnp.asarray(Bm, j), jnp.asarray(Cm, j), jnp.asarray(D))


def _torch(arrays, dtype, device="cpu"):
    x, dt, A, Bm, Cm, D = (np.array(a) for a in arrays)
    t = TDT[dtype]
    return (torch.from_numpy(x).to(device, t), torch.from_numpy(dt).to(device),
            torch.from_numpy(A).to(device), torch.from_numpy(Bm).to(device, t),
            torch.from_numpy(Cm).to(device, t), torch.from_numpy(D).to(device))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().cpu().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("B,S,H,P,N,chunk", SWEEP)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_matches_pallas_interpret_and_oracle(B, S, H, P, N, chunk,
                                                 dtype):
    arrays = _inputs(B, S, H, P, N, dtype)
    jx = _jax(arrays, dtype)
    tx = _torch(arrays, dtype)
    got = ops.ssd(*tx, chunk=chunk)
    assert got.dtype == TDT[dtype] and got.shape == (B, S, H, P)
    pallas = jssd_scan(*jx, chunk=chunk, interpret=True)
    oracle = jax.jit(jref.ssd_recurrent)(*jx)
    np.testing.assert_allclose(_np(got), _np(pallas), **TOL[dtype])
    np.testing.assert_allclose(_np(got), _np(oracle), **TOL[dtype])
    # the port's own oracle (impl="ref") is the JAX oracle's copy
    np.testing.assert_allclose(_np(ops.ssd(*tx, impl="ref")), _np(oracle),
                               **TOL[dtype])


@pytest.mark.parametrize("chunk", [16, 64, 128])
def test_final_state_matches_jax_chunked(chunk):
    """S = 150 leaves a ragged last chunk at every chunk length."""
    arrays = _inputs(2, 150, 3, 16, 8, "float32", seed=1)
    jy, jst = j_ssd_chunked(*_jax(arrays, "float32"), chunk=chunk,
                            return_state=True)
    y, st = ops.ssd(*_torch(arrays, "float32"), chunk=chunk,
                    return_state=True)
    assert st.dtype == torch.float32 and st.shape == (2, 3, 16, 8)
    np.testing.assert_allclose(_np(y), _np(jy), **TOL["float32"])
    np.testing.assert_allclose(_np(st), _np(jst), **TOL["float32"])
    _, rst = ops.ssd(*_torch(arrays, "float32"), return_state=True,
                     impl="ref")
    np.testing.assert_allclose(_np(rst), _np(jst), **TOL["float32"])


def test_chunked_init_state_matches_jax():
    arrays = _inputs(1, 40, 2, 8, 4, "float32", seed=2)
    init = np.random.default_rng(3).standard_normal((1, 2, 8, 4)).astype(
        np.float32)
    jy, jst = j_ssd_chunked(*_jax(arrays, "float32"), chunk=16,
                            init_state=jnp.asarray(init), return_state=True)
    y, st = tssm.ssd_chunked(*_torch(arrays, "float32"), chunk=16,
                             init_state=torch.from_numpy(init),
                             return_state=True)
    np.testing.assert_allclose(_np(y), _np(jy), **TOL["float32"])
    np.testing.assert_allclose(_np(st), _np(jst), **TOL["float32"])


def test_ssd_step_chained_equals_scan():
    arrays = _inputs(2, 37, 3, 8, 4, "float32", seed=4)
    x, dt, A, Bm, Cm, D = _torch(arrays, "float32")
    y_scan, st_scan = ops.ssd(x, dt, A, Bm, Cm, D, chunk=16,
                              return_state=True)
    st = torch.zeros((2, 3, 8, 4))
    jst = jnp.zeros((2, 3, 8, 4))
    jx = _jax(arrays, "float32")
    ys = []
    for t in range(x.shape[1]):
        y, st = tssm.ssd_step(x[:, t], dt[:, t], A, Bm[:, t], Cm[:, t], D,
                              st)
        jy, jst = j_ssd_step(jx[0][:, t], jx[1][:, t], jx[2], jx[3][:, t],
                             jx[4][:, t], jx[5], jst)
        np.testing.assert_allclose(_np(y), _np(jy), **TOL["float32"])
        ys.append(y)
    np.testing.assert_allclose(_np(torch.stack(ys, 1)), _np(y_scan),
                               **TOL["float32"])
    np.testing.assert_allclose(_np(st), _np(st_scan), **TOL["float32"])
    np.testing.assert_allclose(_np(st), _np(jst), **TOL["float32"])


def test_ops_ssd_rejects_unknown_impl():
    with pytest.raises(ValueError, match="unknown ssd impl"):
        ops.ssd(*_torch(_inputs(1, 4, 1, 4, 2, "float32"), "float32"),
                impl="pallas")


def _bad(what):
    """Inputs that break one rule of the kernel's wrapper."""
    x, dt, A, Bm, Cm, D = _torch(_inputs(1, 8, 2, 4, 3, "float32"),
                                 "float32")
    return {"rank": (x[0], dt, A, Bm, Cm, D),
            "dt shape": (x, dt[:, :4], A, Bm, Cm, D),
            "N mismatch": (x, dt, A, Bm, Cm[..., :2], D),
            "x dtype": (x.double(), dt, A, Bm, Cm, D),
            "Bm dtype": (x, dt, A, Bm.bfloat16(), Cm, D),
            "dt dtype": (x, dt.bfloat16(), A, Bm, Cm, D),
            "strided last dim": (x, dt, A, Bm.transpose(1, 2).contiguous()
                                 .transpose(1, 2), Cm, D)}[what]


@pytest.mark.parametrize("what,err", [
    ("rank", ValueError), ("dt shape", ValueError),
    ("N mismatch", ValueError), ("x dtype", TypeError),
    ("Bm dtype", TypeError), ("dt dtype", TypeError),
    ("strided last dim", ValueError)])
def test_kernel_wrapper_rejects_what_the_kernel_does_not_take(what, err):
    """The checks the wrapper runs before a launch (on a CUDA tensor; here
    called directly, since a CPU tensor takes the plain version)."""
    with pytest.raises(err):
        ssd_mod._check(*_bad(what), 8)


def test_kernel_wrapper_rejects_a_chunk_beyond_shared_memory():
    args = _torch(_inputs(1, 8, 2, 64, 16, "float32"), "float32")
    ssd_mod._check(*args, 128)                  # 122 KB: fits
    assert ssd_mod.smem_bytes(128, 64, 16) == 4 * (128 * 64 + 2 * 128 * 17
                                                   + 128 * 128 + 16 * 64
                                                   + 4 * 128)
    with pytest.raises(ValueError, match="shared memory"):
        ssd_mod._check(*args, 256)


# ---------------------------------------------------------------------------
# Mamba head-group on bridged weights
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def mamba():
    """The hymba smoke config's Mamba parameters from the JAX init, with
    A_log, dt_bias and D drawn from numpy (the init leaves them constant),
    bridged into the port."""
    cfg = smoke_config("hymba-1.5b")
    jcfg = jax_smoke_config("hymba-1.5b")
    jp = jax_init_params(jssm.mamba_spec(jcfg), jax.random.PRNGKey(7))
    jp = jax.tree.map(np.asarray, jp)
    rng = np.random.default_rng(8)
    H = jp["A_log"].shape[0]
    jp["A_log"] = (0.5 * rng.standard_normal(H)).astype(np.float32)
    jp["dt_bias"] = (0.5 * rng.standard_normal(H)).astype(np.float32)
    jp["D"] = (1.0 + 0.1 * rng.standard_normal(H)).astype(np.float32)
    tp = params_from_numpy(jp, device="cpu")
    return cfg, jcfg, jax.tree.map(jnp.asarray, jp), tp


def test_mamba_spec_matches_jax():
    """At full width: d_inner 3200 = 50 heads of 64, N = 16, conv 4."""
    jspec = jssm.mamba_spec(jax_get_config("hymba-1.5b"))
    tspec = tssm.mamba_spec(get_config("hymba-1.5b"))
    assert list(jspec) == list(tspec)
    for k, s in tspec.items():
        assert (s.shape, s.init, s.scale) == \
            (jspec[k].shape, jspec[k].init, jspec[k].scale), k
    assert tssm.mamba_heads(get_config("hymba-1.5b")) == (3200, 50, 64)


def test_mamba_init_cache_matches_jax():
    cfg, jcfg = smoke_config("hymba-1.5b"), jax_smoke_config("hymba-1.5b")
    want = jssm.mamba_init_cache(jcfg, 3, jnp.bfloat16)
    got = tssm.mamba_init_cache(cfg, 3, torch.bfloat16)
    for k in ("conv", "state"):
        assert tuple(got[k].shape) == want[k].shape
        assert str(got[k].dtype).split(".")[-1] == str(want[k].dtype)
        assert not bool(got[k].any())


@pytest.mark.parametrize("S", [12, 70])
def test_apply_mamba_matches_jax(mamba, S):
    """S = 70 spans two of apply_mamba's 64-step chunks, ragged."""
    cfg, jcfg, jp, tp = mamba
    x = np.random.default_rng(S).standard_normal((2, S, cfg.d_model))
    x = x.astype(np.float32)
    jy, jc = j_apply_mamba(jcfg, jp, jnp.asarray(x), return_cache=True)
    ty, tc = tssm.apply_mamba(cfg, tp, torch.from_numpy(x),
                              return_cache=True)
    np.testing.assert_allclose(_np(ty), _np(jy), **TOL["float32"])
    for k in ("conv", "state"):
        np.testing.assert_allclose(_np(tc[k]), _np(jc[k]), **TOL["float32"])
    assert tc["state"].dtype == torch.float32
    # without the cache: the same output
    np.testing.assert_allclose(
        _np(tssm.apply_mamba(cfg, tp, torch.from_numpy(x))), _np(ty),
        atol=0, rtol=0)


def test_apply_mamba_step_matches_jax_in_place(mamba):
    """Prefill 9 steps, then 4 decode steps; the port overwrites the cache
    it is given (a view of a larger pool here) and returns the same
    output as the JAX step."""
    cfg, jcfg, jp, tp = mamba
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, 13, cfg.d_model)).astype(np.float32)
    _, jc = j_apply_mamba(jcfg, jp, jnp.asarray(x[:, :9]),
                             return_cache=True)
    _, tc = tssm.apply_mamba(cfg, tp, torch.from_numpy(x[:, :9]),
                             return_cache=True)
    pool = {k: torch.zeros((3,) + tuple(v.shape[1:]), dtype=v.dtype)
            for k, v in tc.items()}
    view = {k: v[1:3] for k, v in pool.items()}          # slots 1 and 2
    for k in view:
        view[k].copy_(tc[k])
    for t in range(9, 13):
        jy, jc = j_apply_mamba_step(jcfg, jp, jnp.asarray(x[:, t:t + 1]),
                                       jc)
        ty, _ = tssm.apply_mamba_step(cfg, tp, torch.from_numpy(
            x[:, t:t + 1]), view)
        np.testing.assert_allclose(_np(ty), _np(jy), **TOL["float32"])
        for k in ("conv", "state"):
            np.testing.assert_allclose(_np(pool[k][1:3]), _np(jc[k]),
                                       **TOL["float32"])
    assert not bool(pool["state"][0].any())               # untouched slot


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_kernel_matches_plain_version(dtype):
    """The Hopper kernel against the plain version on the card, final
    state included: bf16 on the tensor-core path, fp32 on the CUDA-core
    kernel (needs a CUDA device and nvcc; chip_smoke.py runs the full sweep
    and hymba's prefill shape)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    # the sweep, then hymba's P 64 / N 16 at chunks 64 and 128 (a ragged S)
    for B, S, H, P, N, chunk in SWEEP + [(1, 300, 3, 64, 16, 64),
                                         (1, 300, 3, 64, 16, 128)]:
        tx = _torch(_inputs(B, S, H, P, N, dtype), dtype, device="cuda")
        want_path = (ssd_mod.TENSOR_CORE if dtype == "bfloat16"
                     else ssd_mod.CUDA_CORE)
        assert ssd_mod.plan(tx[0], tx[3], tx[4], min(chunk, S)) == want_path
        before = ssd_scan.launches
        got, st = ssd_scan(*tx, chunk=chunk, return_state=True)
        assert ssd_scan.launches == before + 1
        want, wst = tref.ssd_chunked(*tx, chunk=chunk, return_state=True)
        np.testing.assert_allclose(_np(got), _np(want), **TOL[dtype])
        np.testing.assert_allclose(_np(st), _np(wst), **TOL[dtype])
