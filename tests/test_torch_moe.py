"""The port's Mixture-of-Experts (`repro_torch.models.moe`) held to the JAX
package's `repro.models.moe` on the same inputs and weights.

The weights are layer 0 of the JAX `Model.init` tree of the qwen2-moe and
qwen3-moe smoke configs (6 experts top-2 with two shared experts; 8
experts top-2 without), bridged into the port. Routing ids, dispatch
slots and keep masks are integers and must be equal; outputs and the
load-balance loss are fp32 and held within 2e-4 (the tolerance of
tests/test_kernels.py).
"""
import dataclasses

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
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402

FP32_TOL = 2e-4
ARCHS = ["qwen2-moe-a2.7b", "qwen3-moe-30b-a3b"]


@pytest.fixture(scope="module", params=ARCHS)
def layer(request):
    """(cfg, JAX layer-0 MoE params, the port's bridged copy)."""
    cfg = jax_smoke_config(request.param)
    jp = jax_build_model(cfg).init(jax.random.PRNGKey(0))
    jl = jax.tree.map(lambda t: np.asarray(t[0]), jp["segments"][0]["moe"])
    return cfg, jl, params_from_numpy(jl, device="cpu")


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def test_moe_spec_equals_the_reference():
    for arch in ARCHS:
        js = jmoe.moe_spec(jax_smoke_config(arch), 1)
        ts = tmoe.moe_spec(smoke_config(arch))
        assert sorted(js) == sorted(ts)
        for k, s in ts.items():
            assert (s.shape, s.init, s.scale) == \
                (js[k].shape, js[k].init, js[k].scale), k
        assert tmoe.padded_experts(smoke_config(arch)) == \
            jmoe.padded_experts(jax_smoke_config(arch), 1)


def test_route_matches_the_reference(layer):
    cfg, jl, tl = layer
    x = _x((48, cfg.d_model), seed=1)
    jw, jids, jaux = jmoe._route(cfg, jax.tree.map(jnp.asarray, jl),
                                 jnp.asarray(x))
    tw, tids, taux = tmoe._route(cfg, tl, torch.from_numpy(x))
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=FP32_TOL,
                               rtol=0)
    assert float(taux) == pytest.approx(float(jaux), abs=FP32_TOL)


def test_topk_ties_go_to_the_lower_index_first(layer):
    """Router columns duplicated in pairs give exactly tied logits: both
    packages take the lower expert index first, as lax.top_k does."""
    cfg, jl, _ = layer
    E = jl["router"].shape[1]
    router = np.repeat(jl["router"][:, :E // 2], 2, axis=1)   # 0=1, 2=3...
    x = _x((16, cfg.d_model), seed=2)
    _, jids, _ = jmoe._route(cfg, {"router": jnp.asarray(router)},
                             jnp.asarray(x))
    _, tids, _ = tmoe._route(cfg, {"router": torch.from_numpy(router)},
                             torch.from_numpy(x))
    jids, tids = np.asarray(jids), tids.numpy()
    np.testing.assert_array_equal(tids, jids)
    # every token's top-2 is a tied pair (2i, 2i+1), lower index first
    assert (tids[:, 0] % 2 == 0).all()
    assert (tids[:, 1] == tids[:, 0] + 1).all()


@pytest.mark.parametrize("capacity", [1, 3, 10])
def test_dispatch_slots_match_the_reference(capacity):
    rng = np.random.default_rng(capacity)
    E = 6
    ids = np.stack([rng.permutation(E)[:2] for _ in range(40)])
    js, jk = jmoe._dispatch_slots(jnp.asarray(ids), E, capacity)
    ts, tk = tmoe._dispatch_slots(torch.from_numpy(ids), E, capacity)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))


@pytest.mark.parametrize("capacity_factor", [1.25, 0.5, 4.0])
def test_apply_moe_dense_matches_the_reference(layer, capacity_factor):
    """Outputs and aux within fp32 2e-4, and the keep mask equal bit for
    bit. The tokens lie near one common direction, so the router favours
    a few experts: at capacity factor 1.25 (and 0.5) pairs really drop;
    at 4.0 none can (capacity >= the tokens)."""
    cfg, jl, tl = layer
    B, S = 3, 16
    x = _x((1, 1, cfg.d_model), seed=3) + 0.5 * _x((B, S, cfg.d_model),
                                                    seed=4)
    jy, jaux = jmoe.apply_moe_dense(cfg, jax.tree.map(jnp.asarray, jl),
                                    jnp.asarray(x),
                                    capacity_factor=capacity_factor)
    ty, taux = tmoe.apply_moe_dense(cfg, tl, torch.from_numpy(x),
                                    capacity_factor=capacity_factor)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=FP32_TOL,
                               rtol=0)
    assert float(taux) == pytest.approx(float(jaux), abs=FP32_TOL)
    # the keep masks, from both packages' own routing of these tokens
    t = B * S
    cap = max(1, int(t * cfg.moe.top_k / cfg.moe.num_experts
                     * capacity_factor))
    assert tmoe.capacity_of(cfg, t, capacity_factor) == cap
    E = jl["router"].shape[1]
    x2d = x.reshape(t, -1)
    _, jids, _ = jmoe._route(cfg, jax.tree.map(jnp.asarray, jl),
                             jnp.asarray(x2d))
    _, tids, _ = tmoe._route(cfg, tl, torch.from_numpy(x2d))
    _, jkeep = jmoe._dispatch_slots(jids, E, cap)
    _, tkeep = tmoe._dispatch_slots(tids, E, cap)
    np.testing.assert_array_equal(tkeep.numpy(), np.asarray(jkeep))
    assert (not tkeep.all()) == (capacity_factor < 4.0)


def test_shared_expert_matches_the_reference():
    cfg = jax_smoke_config("qwen2-moe-a2.7b")
    jp = jax_build_model(cfg).init(jax.random.PRNGKey(1))
    jl = jax.tree.map(lambda t: np.asarray(t[1]), jp["segments"][0]["moe"])
    x = _x((20, cfg.d_model), seed=4)
    want = jmoe._shared_expert(cfg, jax.tree.map(jnp.asarray, jl),
                               jnp.asarray(x))
    got = tmoe._shared_expert(cfg, params_from_numpy(jl, device="cpu"),
                              torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=FP32_TOL,
                               rtol=0)


def test_dropless_equals_each_token_routed_alone(layer):
    """The fleet decode's MoE: B tokens in one dispatch equal the
    reference's dense MoE run on each token alone (t = 1, capacity 1)."""
    cfg, jl, tl = layer
    x = _x((5, 1, cfg.d_model), seed=5)
    got = tmoe.apply_moe_dropless(cfg, tl, torch.from_numpy(x))
    for i in range(5):
        want, _ = jmoe.apply_moe_dense(cfg, jax.tree.map(jnp.asarray, jl),
                                       jnp.asarray(x[i:i + 1]))
        np.testing.assert_allclose(got[i:i + 1].numpy(), np.asarray(want),
                                   atol=FP32_TOL, rtol=0)


def test_moe_is_differentiable_through_grad_and_value(layer):
    """The train step's transform: gradients of the MoE output and aux
    with respect to every expert leaf, equal to JAX's within 2e-4 of each
    leaf's largest gradient."""
    cfg, jl, tl = layer
    x = _x((2, 16, cfg.d_model), seed=6)

    def jloss(p):
        y, aux = jmoe.apply_moe_dense(cfg, p, jnp.asarray(x))
        return jnp.sum(y ** 2) + aux

    def tloss(p):
        y, aux = tmoe.apply_moe_dense(cfg, p, torch.from_numpy(x))
        return torch.sum(y ** 2) + aux

    jg = jax.grad(jloss)(jax.tree.map(jnp.asarray, jl))
    tg = torch.func.grad(tloss)(tl)
    for k in tg:
        want = np.asarray(jg[k])
        scale = max(1.0, float(np.abs(want).max()))
        assert np.abs(tg[k].numpy() - want).max() <= FP32_TOL * scale, k


def test_expert_parallel_path_is_refused():
    """Once refused, now ported: `moe_impl="ep"` on a (1, 2) CPU mesh,
    the experts padded for ep = 4 on a (1, 4) one, held to the per-entry
    oracle (tests/moe_ep_oracle.py) at cf 1.25 on the reference's layer-0
    weights: output and aux within 2e-4; the model forward runs it. What
    stays refused is an implementation neither package knows."""
    from repro_torch.launch.mesh import make_mesh
    from moe_ep_oracle import oracle_ep
    for M in (2, 4):
        jcfg = jax_smoke_config("qwen2-moe-a2.7b")
        cfg = smoke_config("qwen2-moe-a2.7b")
        jp = jax.jit(jax_build_model(jcfg, ep=M).init)(jax.random.PRNGKey(0))
        jl = jax.tree.map(lambda t: np.asarray(t[0]),
                          jp["segments"][0]["moe"])
        tl = params_from_numpy(jl, device="cpu")
        assert tl["wg"].shape[0] == tmoe.padded_experts(cfg, M) == \
            jmoe.padded_experts(jcfg, M)
        x = _x((1, 9, cfg.d_model), seed=M)
        mesh = make_mesh((1, M), ("data", "model"), devices=["cpu"] * M)
        y, aux = tmoe.apply_moe_ep(cfg, tl, torch.from_numpy(x), mesh)
        want, jaux = oracle_ep(jcfg, jl, jnp.asarray(x), 1, M, 1.25)
        np.testing.assert_allclose(y.numpy(), np.asarray(want),
                                   atol=FP32_TOL, rtol=0)
        assert float(aux) == pytest.approx(float(jaux), abs=FP32_TOL)
    model = build_model(dataclasses.replace(cfg, vocab_size=64), ep=2)
    params = model.init(seed=0, device="cpu")
    toks = torch.zeros((2, 4), dtype=torch.long)
    mesh = make_mesh((2, 2), ("data", "model"), devices=["cpu"] * 4)
    logits, _ = model.apply(params, toks, moe_impl="ep", mesh=mesh)
    assert logits.shape == (2, 4, 128)
    with pytest.raises(ValueError, match="unknown moe_impl"):
        model.apply(params, toks, moe_impl="tutel")
