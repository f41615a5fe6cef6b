"""Remat in the port's train step (`TrainConfig.remat`), held to itself
and to the JAX package's.

Smoke width, vocabulary 64, fp32 compute, the JAX `Model.init` weights
bridged into the port. For olmo / hymba / xlstm / qwen2-moe (dense
dispatch), xlstm with the sequence-parallel mLSTM and qwen2-moe with the
expert-parallel MoE on an 8-entry CPU mesh (data 4, model 2):

  * the loss and every gradient under remat "none", "dots" and "full"
    are equal bit for bit (the recompute runs the same ops on the same
    inputs);
  * each is held to the reference's `make_loss_fn` gradients under the
    same remat (unsharded: seqpar and EP equal the single-device paths
    the reference runs without a mesh, EP at a capacity that drops
    nothing and with the aux term off, its per-entry mean being EP's
    own), per leaf within GRAD_RTOL of the leaf's largest |g|, the
    tolerance of tests/test_torch_train.py;
  * the bytes the autograd graph keeps for the backward
    (`launch.roofline.saved_bytes`) fall in the order full < dots < none.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import smoke_config as jax_smoke_config  # noqa: E402
from repro.configs.base import TrainConfig as JTrainConfig  # noqa: E402
from repro.models.model import build_model as jax_build_model  # noqa: E402
from repro.train import train_step as jts  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.configs.base import TrainConfig  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.launch.roofline import saved_bytes  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.models.param import tree_leaves  # noqa: E402
from repro_torch.train import train_step as tts  # noqa: E402

VOCAB = 64
REMATS = ("none", "dots", "full")
TCFG = dict(learning_rate=1e-3, b2=0.999, weight_decay=0.0, warmup_steps=5,
            total_steps=100000, compute_dtype="float32")
GRAD_RTOL = 1e-4          # per leaf, relative to the leaf's max |g|
LOSS_RTOL = 1e-5
NO_DROP_CF = 16.0         # a capacity no (token, k) pair overflows

# (case, arch, port loss_fn kwargs on the (4, 2) mesh or None); hymba's
# case runs in tests/test_torch_remat_hybrid.py, xlstm's in
# tests/test_torch_remat_xlstm.py
CASES = [("olmo", "olmo-1b", None),
         ("qwen2-moe", "qwen2-moe-a2.7b", None),
         ("qwen2-moe-ep", "qwen2-moe-a2.7b", dict(moe_impl="ep"))]


def _mesh():
    return make_mesh((4, 2), ("data", "model"), devices=["cpu"] * 8)


def _models(arch):
    jcfg = dataclasses.replace(jax_smoke_config(arch), vocab_size=VOCAB)
    jm = jax_build_model(jcfg)
    npp = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    tcfg = dataclasses.replace(smoke_config(arch), vocab_size=VOCAB)
    return jm, npp, build_model(tcfg)


def _paths(tree, prefix=()):
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in _paths(tree[k], prefix + (k,))]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree)
                for x in _paths(v, prefix + (i,))]
    return [(prefix, tree)]


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _no_drop(monkeypatch, model):
    orig = model.apply
    monkeypatch.setattr(model, "apply", lambda *a, **kw: orig(
        *a, capacity_factor=NO_DROP_CF, **kw))


def check_remat_case(arch, sharded, monkeypatch):
    """One case: the port's loss and gradients under the three remats
    equal bit for bit, and each within GRAD_RTOL of the reference's under
    the same remat (its three in one jit: one compile)."""
    jm, npp, tm = _models(arch)
    toks = np.random.default_rng(4).integers(0, VOCAB, size=(4, 16))
    tbatch = {"inputs": torch.from_numpy(toks),
              "labels": torch.from_numpy(toks)}
    jbatch = {"inputs": jnp.asarray(toks), "labels": jnp.asarray(toks)}
    kw = {}
    if sharded is not None:
        kw = dict(sharded, mesh=_mesh())
    if sharded is not None and "moe_impl" in sharded:
        monkeypatch.setattr(tts, "AUX_WEIGHT", 0.0)
        monkeypatch.setattr(jts, "AUX_WEIGHT", 0.0)
        _no_drop(monkeypatch, tm)
        _no_drop(monkeypatch, jm)

    got = {}
    for remat in REMATS:
        loss_fn = tts.make_loss_fn(tm, TrainConfig(**TCFG, remat=remat),
                                   **kw)
        got[remat] = tts.grad_and_value(loss_fn)(
            params_from_numpy(npp, device="cpu"), tbatch)
    g0, (l0, _) = got["none"]
    for remat in ("dots", "full"):
        g, (loss, _) = got[remat]
        assert torch.equal(loss, l0), remat
        for a, b in zip(tree_leaves(g), tree_leaves(g0), strict=True):
            assert torch.equal(a, b), remat

    grads = [jax.value_and_grad(
        jts.make_loss_fn(jm, JTrainConfig(**TCFG, remat=remat)),
        has_aux=True) for remat in REMATS]
    want = jax.jit(lambda p, b: [f(p, b) for f in grads])(npp, jbatch)
    for remat, ((jl, _), jg) in zip(REMATS, want):
        g, (loss, _) = got[remat]
        assert float(loss) == pytest.approx(float(jl), rel=LOSS_RTOL)
        for path, w in _paths(jg):
            w = np.asarray(w)
            scale = float(np.abs(w).max())
            diff = np.abs(_at(g, path).numpy() - w).max()
            assert diff <= GRAD_RTOL * scale, (remat, path, scale)


@pytest.mark.parametrize("case,arch,sharded", CASES,
                         ids=[c[0] for c in CASES])
def test_remat_gradients_equal_none_and_the_reference(case, arch, sharded,
                                                      monkeypatch):
    check_remat_case(arch, sharded, monkeypatch)


@pytest.mark.parametrize("arch", ["olmo-1b", "qwen2-moe-a2.7b"])
def test_saved_activation_bytes_fall_with_remat(arch):
    _, npp, tm = _models(arch)
    toks = torch.from_numpy(
        np.random.default_rng(1).integers(0, VOCAB, size=(4, 32)))
    batch = {"inputs": toks, "labels": toks}
    saved = {}
    for remat in REMATS:
        loss_fn = tts.make_loss_fn(tm, TrainConfig(**TCFG, remat=remat))
        params = params_from_numpy(npp, device="cpu")
        with torch.enable_grad():
            for p in tree_leaves(params):
                p.requires_grad_()
            (loss, _), saved[remat] = saved_bytes(loss_fn, params, batch)
        assert torch.isfinite(loss)
    assert saved["full"] < saved["dots"] < saved["none"], saved


def test_unknown_remat_is_refused():
    _, npp, tm = _models("olmo-1b")
    toks = torch.zeros((2, 8), dtype=torch.int64)
    loss_fn = tts.make_loss_fn(tm, TrainConfig(**TCFG, remat="offload"))
    with pytest.raises(ValueError, match="unknown remat"):
        loss_fn(params_from_numpy(npp, device="cpu"),
                {"inputs": toks, "labels": toks})
