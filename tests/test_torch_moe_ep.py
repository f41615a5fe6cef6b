"""The port's expert-parallel MoE (`repro_torch.models.moe.apply_moe_ep`)
held to the reference's, entry by entry, on CPU meshes.

The oracle (`tests/moe_ep_oracle.py`) runs the reference's `shard_map`
body for each entry of a (data, model) mesh from the reference's own
pure functions, with its EP capacity max(1, ceil(t_m k / E cf)). The
port's mesh is one process of repeated `cpu` entries. The weights are
layer 0 of the reference's `Model.init` at the smoke configs of
qwen2-moe (6 experts top-2, shared experts) and qwen3-moe (8 experts
top-2), built with the experts padded for the model axis, bridged into
the port. Keep masks, dispatch slots and routed ids are integers and
must be equal; outputs and aux are fp32 within 2e-4 (the tolerance of
tests/test_kernels.py).
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import smoke_config as jax_smoke_config  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models.model import build_model as jax_build_model  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.configs.base import TrainConfig  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.models.param import tree_leaves, tree_map  # noqa: E402
from repro_torch.train import train_step as tts  # noqa: E402

from moe_ep_oracle import oracle_ep, patched_apply_moe_ep  # noqa: E402

FP32_TOL = 2e-4
NO_DROP_CF = 64.0        # every capacity at least the tokens' k pairs
ARCHS = ["qwen2-moe-a2.7b", "qwen3-moe-30b-a3b"]
MESHES = [(1, 2), (1, 4), (2, 2), (2, 4)]
VOCAB = 64


def cpu_mesh(data, model):
    return make_mesh((data, model), ("data", "model"),
                     devices=["cpu"] * (data * model))


@functools.lru_cache(maxsize=None)
def _layer(arch, ep):
    """(port cfg, reference cfg, reference layer-0 MoE params (numpy), the
    port's bridged copy), experts padded for `ep` model entries."""
    jcfg = jax_smoke_config(arch)
    jp = jax.jit(jax_build_model(jcfg, ep=ep).init)(jax.random.PRNGKey(0))
    jl = jax.tree.map(lambda t: np.asarray(t[0]), jp["segments"][0]["moe"])
    return smoke_config(arch), jcfg, jl, params_from_numpy(jl, device="cpu")


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _check_entries(trace, jtrace):
    assert len(trace) == len(jtrace)
    for t, j in zip(trace, jtrace):
        assert (t["data"], t["model"], t["capacity"]) == \
            (j["data"], j["model"], j["capacity"])
        for k in ("ids", "slot", "keep"):
            np.testing.assert_array_equal(t[k].numpy(), np.asarray(j[k]),
                                          err_msg=k)


@pytest.mark.parametrize("data,model", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_ep_matches_the_per_entry_oracle_with_drops(arch, data, model):
    """cf 1.25, 7 tokens a data row (no model axis divides it): pairs drop
    and the last entry's slice is padded with zero rows."""
    cfg, jcfg, jl, tl = _layer(arch, model)
    x = _x((data, 7, cfg.d_model), seed=data * 10 + model)
    jtrace, trace = [], []
    want_y, want_aux = oracle_ep(jcfg, jl, jnp.asarray(x), data, model, 1.25,
                                 trace=jtrace)
    y, aux = tmoe.apply_moe_ep(cfg, tl, torch.from_numpy(x),
                               cpu_mesh(data, model), capacity_factor=1.25,
                               trace=trace)
    _check_entries(trace, jtrace)
    t_m = -(-7 // model)
    dropped = sum(int((~t["keep"][:max(0, min(t_m, 7 - t["model"] * t_m))]
                       ).sum()) for t in trace)
    assert dropped > 0, "no valid pair dropped: the case tests nothing"
    np.testing.assert_allclose(y.numpy(), np.asarray(want_y), atol=FP32_TOL,
                               rtol=0)
    assert float(aux) == pytest.approx(float(want_aux), abs=FP32_TOL)


@pytest.mark.parametrize("data,model", MESHES)
def test_ep_without_drops_equals_dense_dispatch(data, model):
    """At a cf that drops nothing, EP's y equals the port's and the
    reference's dense dispatch; its aux is still the per-entry mean (the
    oracle's), not the dense path's."""
    cfg, jcfg, jl, tl = _layer("qwen2-moe-a2.7b", model)
    x = _x((2 * data, 5, cfg.d_model), seed=7)
    y, aux = tmoe.apply_moe_ep(cfg, tl, torch.from_numpy(x),
                               cpu_mesh(data, model),
                               capacity_factor=NO_DROP_CF)
    dy, _ = tmoe.apply_moe_dense(cfg, tl, torch.from_numpy(x),
                                 capacity_factor=NO_DROP_CF)
    jy, _ = jmoe.apply_moe_dense(jcfg, jl, jnp.asarray(x),
                                 capacity_factor=NO_DROP_CF)
    np.testing.assert_allclose(y.numpy(), dy.numpy(), atol=FP32_TOL, rtol=0)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=FP32_TOL,
                               rtol=0)
    _, want_aux = oracle_ep(jcfg, jl, jnp.asarray(x), data, model,
                            NO_DROP_CF)
    assert float(aux) == pytest.approx(float(want_aux), abs=FP32_TOL)


def test_padded_experts_are_never_routed():
    """ep = 8 on the 6-expert smoke config: 8 experts, one an entry; the
    two padded ones get -inf router logits and no token."""
    cfg, jcfg, jl, tl = _layer("qwen2-moe-a2.7b", 8)
    assert tl["router"].shape[1] == 8 and tl["wg"].shape[0] == 8
    x = _x((2, 40, cfg.d_model), seed=3) * 4
    trace = []
    tmoe.apply_moe_ep(cfg, tl, torch.from_numpy(x), cpu_mesh(1, 8),
                      capacity_factor=1.25, trace=trace)
    ids = torch.cat([t["ids"] for t in trace])
    assert int(ids.max()) < 6 and ids.numel() == 8 * 10 * 2
    _, jids, _ = jmoe._route(jcfg, jl, jnp.asarray(x.reshape(-1, 64)))
    _, tids, _ = tmoe._route(cfg, tl, torch.from_numpy(x.reshape(-1, 64)))
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    assert int(tids.max()) < 6


def test_ep_refuses_what_does_not_split():
    cfg, _, _, tl = _layer("qwen2-moe-a2.7b", 1)       # 6 experts
    x = torch.zeros((2, 3, cfg.d_model))
    with pytest.raises(ValueError, match="ep=4"):
        tmoe.apply_moe_ep(cfg, tl, x, cpu_mesh(1, 4))
    cfg, _, _, tl = _layer("qwen2-moe-a2.7b", 2)
    with pytest.raises(ValueError, match="batch 3"):
        tmoe.apply_moe_ep(cfg, tl, torch.zeros((3, 2, cfg.d_model)),
                          cpu_mesh(2, 2))


def _models(arch, model):
    jcfg = dataclasses.replace(jax_smoke_config(arch), vocab_size=VOCAB)
    cfg = dataclasses.replace(smoke_config(arch), vocab_size=VOCAB)
    jm, tm = jax_build_model(jcfg, ep=model), build_model(cfg, ep=model)
    jp = jax.jit(jm.init)(jax.random.PRNGKey(0))
    return jm, jp, tm, params_from_numpy(jax.tree.map(np.asarray, jp),
                                         device="cpu")


class ShapeMesh:
    def __init__(self, shape):
        self.shape = shape


@pytest.mark.parametrize("arch", ARCHS)
def test_model_logits_with_ep_equal_the_oracle_model(arch, monkeypatch):
    """The full model with moe_impl="ep" on a (2, 2) mesh vs the
    reference's model forward with its `apply_moe_ep` replaced by the
    per-entry oracle (its shard_map needs four devices): logits, aux, and
    a prefill and two decode steps (each decode routes 2 tokens over 2
    entries)."""
    jm, jp, tm, tp = _models(arch, 2)
    monkeypatch.setattr(jmoe, "apply_moe_ep", patched_apply_moe_ep)
    jmesh = ShapeMesh({"data": 2, "model": 2})
    mesh = cpu_mesh(2, 2)
    toks = np.random.default_rng(4).integers(0, VOCAB, size=(2, 9))
    ep = dict(mesh=jmesh, moe_impl="ep", compute_dtype=jnp.float32)
    want, jaux = jax.jit(lambda p, t: jm.apply(p, t, **ep))(
        jp, jnp.asarray(toks))
    got, aux = tm.apply(tp, torch.from_numpy(toks), mesh=mesh, moe_impl="ep",
                        compute_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy()[..., :VOCAB],
                               np.asarray(want)[..., :VOCAB], atol=FP32_TOL,
                               rtol=0)
    assert float(aux) == pytest.approx(float(jaux), abs=FP32_TOL)
    jl, jc, jpos = jax.jit(lambda p, t: jm.prefill(
        p, t, 16, cache_dtype=jnp.float32, **ep))(jp, jnp.asarray(toks))
    tl, tc, tpos = tm.prefill(tp, torch.from_numpy(toks), 16, mesh=mesh,
                              moe_impl="ep", compute_dtype=torch.float32,
                              cache_dtype=torch.float32)
    np.testing.assert_allclose(tl.numpy()[:, :VOCAB],
                               np.asarray(jl)[:, :VOCAB], atol=FP32_TOL,
                               rtol=0)
    tok = np.asarray(jnp.argmax(jl[:, :VOCAB], -1))[:, None]
    jdecode = jax.jit(lambda p, t, c, pos: jm.decode(p, t, c, pos, **ep))
    for step in range(2):
        jl, jc = jdecode(jp, jnp.asarray(tok), jc, jpos + step)
        tl, tc = tm.decode(tp, torch.from_numpy(tok), tc, int(tpos) + step,
                           mesh=mesh, moe_impl="ep",
                           compute_dtype=torch.float32)
        np.testing.assert_allclose(tl.numpy()[..., :VOCAB],
                                   np.asarray(jl)[..., :VOCAB],
                                   atol=FP32_TOL, rtol=0)
        tok = np.asarray(jnp.argmax(jl[:, -1, :VOCAB], -1))[:, None]


def test_train_step_with_ep_differentiates_the_ep_path(monkeypatch):
    """At a cf that drops nothing, the gradients of the loss with
    moe_impl="ep" equal the dense path's within fp32 tolerance, the aux
    term excepted (its weight set to 0: EP's aux is the per-entry mean);
    one train step with each moves the parameters alike."""
    monkeypatch.setattr(tts, "AUX_WEIGHT", 0.0)
    _, _, tm, tp = _models("qwen2-moe-a2.7b", 2)
    tcfg = TrainConfig(remat="none", compute_dtype="float32",
                       learning_rate=1e-3, warmup_steps=0)
    toks = torch.from_numpy(
        np.random.default_rng(9).integers(0, VOCAB, size=(4, 8)))
    batch = {"inputs": toks, "labels": toks}
    mesh = cpu_mesh(2, 2)

    def grads(**kw):
        loss_fn = tts.make_loss_fn(tm, tcfg, **kw)
        return torch.func.grad_and_value(loss_fn, has_aux=True)(tp, batch)

    # the no-drop capacity: the model's forward takes capacity_factor
    orig = tm.apply

    def apply(*a, **kw):
        return orig(*a, capacity_factor=NO_DROP_CF, **kw)
    monkeypatch.setattr(tm, "apply", apply)
    g_ep, (loss_ep, _) = grads(mesh=mesh, moe_impl="ep")
    g_dense, (loss_dense, _) = grads()
    assert float(loss_ep) == pytest.approx(float(loss_dense), abs=FP32_TOL)
    moe_grad = g_ep["segments"][0]["moe"]["wg"]
    assert float(moe_grad.abs().sum()) > 0
    for a, b in zip(tree_leaves(g_ep), tree_leaves(g_dense)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=FP32_TOL,
                                   rtol=1e-3)
    states = []
    for kw in (dict(mesh=mesh, moe_impl="ep"), {}):
        params = tree_map(lambda t: t.clone(), tp)
        from repro_torch.train.optimizer import init_opt_state
        st = {"params": params, "opt": init_opt_state(params)}
        st, met = tts.make_train_step(tm, tcfg, **kw)(st, batch)
        states.append(st["params"])
    for a, b in zip(tree_leaves(states[0]), tree_leaves(states[1])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=FP32_TOL,
                                   rtol=0)
