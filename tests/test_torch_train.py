"""The port's optimizer and train step held to the JAX package's.

Smoke width (2 layers, d_model 64, vocabulary 64 padded to 128): the
JAX `Model.init` weights are bridged into the port
(`repro_torch.models.convert`), and the same numpy tokens and gradients
go through both packages. fp32 compute unless a test says otherwise.

Adam's first step is lr * sign(g): where a gradient element sits near
rounding noise the two packages can move it in opposite directions, so
the optimizer is compared on SHARED gradients, the gradients before any
optimizer step, and trajectories by loss and by the share of parameter
elements that differ by more than a few ulp.
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
from repro.configs.base import TrainConfig as JTrainConfig  # noqa: E402
from repro.models.model import build_model as jax_build_model  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro.train import train_step as jts  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.configs.base import TrainConfig  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.kernels.mlstm_scan import mlstm_scan  # noqa: E402
from repro_torch.kernels.ssd_scan import ssd_scan  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.models.param import tree_leaves, tree_map  # noqa: E402
from repro_torch.train import optimizer as topt  # noqa: E402
from repro_torch.train import train_step as tts  # noqa: E402

VOCAB = 64
ARCHS = ["olmo-1b", "hymba-1.5b", "xlstm-350m"]
# the SharedEngine's training config, at fp32 compute
ENGINE_TCFG = dict(learning_rate=1e-3, b2=0.999, weight_decay=0.0,
                   warmup_steps=5, total_steps=100000, remat="none",
                   compute_dtype="float32")
# fp32 elementwise arithmetic in the same order: XLA's and torch's
# reductions (the global norm) and transcendental rounding differ by ulps
OPT_RTOL = 1e-6
LOSS_RTOL = {"float32": 1e-5, "bfloat16": 2e-2}
# per leaf, relative to the leaf's max |g|
GRAD_RTOL = 1e-4
STEP_LOSS_TOL = 1e-4


@pytest.fixture(scope="module", params=ARCHS)
def models(request):
    arch = request.param
    jcfg = dataclasses.replace(jax_smoke_config(arch), vocab_size=VOCAB)
    tcfg = dataclasses.replace(smoke_config(arch), vocab_size=VOCAB)
    jm = jax_build_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    npp = jax.tree.map(np.asarray, jp)
    return jm, jp, build_model(tcfg), npp


def _port_params(npp):
    return params_from_numpy(npp, device="cpu")


def _tokens(shape, seed=0):
    return np.random.default_rng(seed).integers(0, VOCAB, size=shape)


def _jbatch(toks, **extra):
    return {"inputs": jnp.asarray(toks), "labels": jnp.asarray(toks),
            **{k: jnp.asarray(v) for k, v in extra.items()}}


def _tbatch(toks, **extra):
    return {"inputs": torch.from_numpy(toks),
            "labels": torch.from_numpy(toks),
            **{k: torch.from_numpy(v) for k, v in extra.items()}}


def _paths(tree, prefix=()):
    """(path, leaf) pairs of a JAX tree of dicts and lists."""
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


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


# ---------------------------------------------------------------------------
# config
# ---------------------------------------------------------------------------
def test_train_config_matches_jax_and_refuses_unported_fields():
    asdict = dataclasses.asdict
    assert asdict(TrainConfig()) == asdict(JTrainConfig())
    assert asdict(TrainConfig(**ENGINE_TCFG)) == \
        asdict(JTrainConfig(**ENGINE_TCFG))
    m = build_model(dataclasses.replace(smoke_config("olmo-1b"),
                                        vocab_size=VOCAB))
    assert TrainConfig().remat == "full"
    assert callable(tts.make_train_step(m, TrainConfig()))   # remat ported
    with pytest.raises(NotImplementedError,
                       match="read by no train step of the reference"):
        tts.make_train_step(m, TrainConfig(remat="none",
                                           compress_pod_grads=True))


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------
def test_lr_schedule_matches_jax():
    kw = dict(learning_rate=3e-3, warmup_steps=20, total_steps=250)
    steps = np.arange(301)
    want = np.asarray(jax.vmap(lambda s: jopt.lr_schedule(
        JTrainConfig(**kw), s))(jnp.asarray(steps, jnp.int32)))
    got = np.array([float(topt.lr_schedule(
        TrainConfig(**kw), torch.tensor(s, dtype=torch.int32)))
        for s in steps], np.float32)
    np.testing.assert_allclose(got, want, rtol=OPT_RTOL, atol=0)


@pytest.mark.parametrize("grad_scale,weight_decay", [
    (1e-3, 0.0),       # global norm under the clip
    (1.0, 0.1),        # clipped, with decay on every leaf
])
def test_adamw_update_matches_jax_on_shared_grads(models, grad_scale,
                                                  weight_decay):
    jm, jp, tm, npp = models
    kw = dict(ENGINE_TCFG, weight_decay=weight_decay, warmup_steps=2)
    rng = np.random.default_rng(1)
    jstate = {"params": jp, "opt": jopt.init_opt_state(jp)}
    tp = _port_params(npp)
    tstate = {"params": tp, "opt": topt.init_opt_state(tp)}
    jupdate = jax.jit(functools.partial(jopt.adamw_update,
                                        JTrainConfig(**kw)))
    for _ in range(3):      # warm-up and the first decay steps
        g = jax.tree.map(lambda x: (rng.standard_normal(x.shape)
                                    * grad_scale).astype(np.float32), npp)
        jp2, jo2, jmet = jupdate(jstate["params"],
                                 jax.tree.map(jnp.asarray, g),
                                 jstate["opt"])
        jstate = {"params": jp2, "opt": jo2}
        tg = params_from_numpy(g, device="cpu")
        tp2, to2, tmet = topt.adamw_update(TrainConfig(**kw),
                                           tstate["params"], tg,
                                           tstate["opt"])
        assert tp2 is tstate["params"] and to2 is tstate["opt"]  # in place
        for k in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(tmet[k]), float(jmet[k]),
                                       rtol=OPT_RTOL)
    assert int(tstate["opt"]["count"]) == int(jstate["opt"]["count"]) == 3
    for tree in ("params", "mu", "nu"):
        jt = jstate["params"] if tree == "params" else jstate["opt"][tree]
        tt = tstate["params"] if tree == "params" else tstate["opt"][tree]
        for path, want in _paths(jt):
            got = _at(tt, path)
            assert got.dtype == torch.float32, (tree, path)
            np.testing.assert_allclose(_np(got), np.asarray(want),
                                       rtol=OPT_RTOL, atol=1e-9,
                                       err_msg=f"{tree} {path}")


def test_clip_by_global_norm_matches_jax(models):
    _, _, _, npp = models
    g = jax.tree.map(lambda x: np.full(x.shape, 0.5, np.float32), npp)
    jg, jn = jopt.clip_by_global_norm(jax.tree.map(jnp.asarray, g), 1.0)
    tg, tn = topt.clip_by_global_norm(params_from_numpy(g, device="cpu"),
                                      1.0)
    np.testing.assert_allclose(float(tn), float(jn), rtol=OPT_RTOL)
    for path, want in _paths(jg):
        np.testing.assert_allclose(_np(_at(tg, path)), np.asarray(want),
                                   rtol=OPT_RTOL)


# ---------------------------------------------------------------------------
# loss and gradients
# ---------------------------------------------------------------------------
def test_softmax_xent_and_its_gradient_match_jax():
    """Value and gradient, padded vocabulary entries included. The JAX
    version adds back the max without stop_gradient, so its lse gradient
    is softmax + one-hot(argmax); the port keeps that arithmetic."""
    rng = np.random.default_rng(2)
    lg = rng.standard_normal((3, 7, 128)).astype(np.float32) * 3
    lg[..., VOCAB:] = -1e30
    lab = rng.integers(0, VOCAB, size=(3, 7))
    cfg = smoke_config("olmo-1b")

    def jloss(x):
        ce, z = jts.softmax_xent(cfg, x, jnp.asarray(lab))
        return ce + 0.5 * z
    jce, jz = jts.softmax_xent(cfg, jnp.asarray(lg), jnp.asarray(lab))
    jgrad = np.asarray(jax.grad(jloss)(jnp.asarray(lg)))
    x = torch.from_numpy(lg).requires_grad_(True)
    tce, tz = tts.softmax_xent(cfg, x, torch.from_numpy(lab))
    (tce + 0.5 * tz).backward()
    np.testing.assert_allclose(float(tce.detach()), float(jce), rtol=1e-6)
    np.testing.assert_allclose(float(tz.detach()), float(jz), rtol=1e-6)
    np.testing.assert_allclose(x.grad.numpy(), jgrad, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_loss_with_distill_term_matches_jax(models, compute):
    jm, jp, tm, npp = models
    kw = dict(ENGINE_TCFG, compute_dtype=compute)
    toks = _tokens((4, 32))
    teacher = np.random.default_rng(3).standard_normal(
        (4, 31, VOCAB)).astype(np.float32)
    jl = jts.make_loss_fn(jm, JTrainConfig(**kw), distill_weight=0.5)
    (jloss, jmet) = jl(jp, _jbatch(toks, teacher_logits=teacher))
    tl = tts.make_loss_fn(tm, TrainConfig(**kw), distill_weight=0.5)
    tloss, tmet = tl(_port_params(npp), _tbatch(toks, teacher_logits=teacher))
    for got, want in ((tloss, jloss), (tmet["ce"], jmet["ce"]),
                      (tmet["z"], jmet["z"])):
        np.testing.assert_allclose(float(got), float(want),
                                   rtol=LOSS_RTOL[compute])
    assert float(tmet["aux"]) == float(jmet["aux"]) == 0.0


def test_gradients_match_jax_per_leaf(models):
    jm, jp, tm, npp = models
    toks = _tokens((4, 32), seed=4)
    (_, _), jg = jax.jit(jax.value_and_grad(
        jts.make_loss_fn(jm, JTrainConfig(**ENGINE_TCFG)),
        has_aux=True))(jp, _jbatch(toks))
    tg, _ = torch.func.grad_and_value(
        tts.make_loss_fn(tm, TrainConfig(**ENGINE_TCFG)),
        has_aux=True)(_port_params(npp), _tbatch(toks))
    for path, want in _paths(jg):
        want = np.asarray(want)
        got = _np(_at(tg, path))
        scale = float(np.abs(want).max())
        assert np.abs(got - want).max() <= GRAD_RTOL * scale, (path, scale)


def _four_steps(jm, jp, tm, npp, kw, batches):
    jstep = jax.jit(jts.make_train_step(jm, JTrainConfig(**kw)))
    tstep = tts.make_train_step(tm, TrainConfig(**kw))
    jstate = {"params": jp, "opt": jopt.init_opt_state(jp)}
    tp = _port_params(npp)
    tstate = {"params": tp, "opt": topt.init_opt_state(tp)}
    jl, tl = [], []
    for toks in batches:
        jstate, jmet = jstep(jstate, _jbatch(toks))
        tstate, tmet = tstep(tstate, _tbatch(toks))
        jl.append(float(jmet["loss"]))
        tl.append(float(tmet["loss"]))
    return jstate, tstate, jl, tl


def test_four_train_steps_match_jax(models):
    """Losses within 1e-4; parameters: under 1 % of the elements move by
    more than 16 ulp of their value plus 1e-7 (a sign flip of a gradient
    element near rounding noise moves it by up to 2 lr)."""
    jm, jp, tm, npp = models
    batches = [_tokens((4, 32), seed=10 + i) for i in range(4)]
    jstate, tstate, jl, tl = _four_steps(jm, jp, tm, npp, ENGINE_TCFG,
                                         batches)
    np.testing.assert_allclose(tl, jl, atol=STEP_LOSS_TOL, rtol=0)
    far = total = 0
    for path, want in _paths(jstate["params"]):
        want = np.asarray(want)
        got = _np(_at(tstate["params"], path))
        ulp = np.spacing(np.abs(want).astype(np.float32))
        far += int((np.abs(got - want) > 16 * ulp + 1e-7).sum())
        total += want.size
    assert far <= 0.01 * total, (far, total)


def test_microbatches_match_jax_and_one_full_batch(models):
    jm, jp, tm, npp = models
    kw = dict(ENGINE_TCFG, microbatches=2)
    batches = [_tokens((4, 32), seed=20 + i) for i in range(2)]
    _, _, jl, tl = _four_steps(jm, jp, tm, npp, kw, batches)
    np.testing.assert_allclose(tl, jl, atol=STEP_LOSS_TOL, rtol=0)
    # the first step's loss is the full batch's (equal halves, mean CE)
    full = tts.make_loss_fn(tm, TrainConfig(**ENGINE_TCFG))(
        _port_params(npp), _tbatch(batches[0]))[0]
    np.testing.assert_allclose(tl[0], float(full), rtol=1e-6)


def test_train_step_many_lanes_equal_single_steps_bit_for_bit(models):
    """Lane j of make_train_step_many over a stacked state (rows 1 and 3
    of 4 trained, in that order) equals make_train_step on state j with
    its batches in order, bit for bit; rows not in `lanes` are
    untouched."""
    _, _, tm, npp = models
    tcfg = TrainConfig(**dict(ENGINE_TCFG, compute_dtype="bfloat16"))

    def state(seed):
        p = tree_map(lambda x: x + 0.01 * seed, _port_params(npp))
        return {"params": p, "opt": topt.init_opt_state(p)}
    states = [state(i) for i in range(4)]
    stack = tree_map(lambda *xs: torch.stack(xs), *states)
    before = tree_map(torch.clone, stack)
    toks = torch.from_numpy(_tokens((2, 3, 2, 16), seed=30))
    many = tts.make_train_step_many(tm, tcfg)
    _, mets = many(stack, {"inputs": toks, "labels": toks}, lanes=[1, 3])
    assert mets["loss"].shape == (2, 3)
    step = tts.make_train_step(tm, tcfg)
    for j, row in enumerate([1, 3]):
        st = states[row]
        for s in range(3):
            st, met = step(st, {"inputs": toks[j, s], "labels": toks[j, s]})
            assert torch.equal(met["loss"], mets["loss"][j, s])
        for a, b in zip(tree_leaves(st), tree_leaves(
                tree_map(lambda x: x[row], stack))):
            assert torch.equal(a, b)
    for row in (0, 2):
        for a, b in zip(tree_leaves(tree_map(lambda x: x[row], stack)),
                        tree_leaves(tree_map(lambda x: x[row], before))):
            assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the autograd route and the kernels' refusal
# ---------------------------------------------------------------------------
def _op_inputs(op):
    g = torch.Generator().manual_seed(5)

    def r(*s):
        return torch.randn(*s, generator=g)
    if op == "attention":
        return (r(2, 24, 4, 16), r(2, 24, 2, 16), r(2, 24, 2, 16)), {}
    if op == "ssd":
        return (r(1, 40, 2, 8), torch.rand(1, 40, 2, generator=g) * 0.2,
                -torch.rand(2, generator=g) - 0.1, r(1, 40, 4), r(1, 40, 4),
                torch.ones(2)), {"chunk": 16}
    return (r(1, 40, 2, 8), r(1, 40, 2, 8), r(1, 40, 2, 8), r(1, 40, 2),
            r(1, 40, 2) + 2), {"chunk": 16}


_CHUNKED = {"attention": ref.attention_ref, "ssd": ref.ssd_chunked,
            "mlstm": ref.mlstm_chunked}
_WRAPPERS = {"attention": flash_attention, "ssd": ssd_scan,
             "mlstm": mlstm_scan}


@pytest.mark.parametrize("op", ["attention", "ssd", "mlstm"])
def test_auto_refuses_inputs_that_require_grad(op):
    args, kw = _op_inputs(op)
    fn = getattr(ops, op)
    want = fn(*args, impl="auto", **kw)                # no grad asked
    leaf = args[0].clone().requires_grad_(True)
    grad_args = (leaf,) + args[1:]
    for call in (lambda: fn(*grad_args, impl="auto", **kw),
                 lambda: _WRAPPERS[op](*grad_args, **kw)):
        with pytest.raises(ValueError, match="impl='autograd'"):
            call()
    with torch.no_grad():                              # eval forwards
        assert torch.equal(fn(*grad_args, impl="auto", **kw), want)
    out = fn(*grad_args, impl="autograd", **kw)
    assert out.grad_fn is not None
    out.sum().backward()
    assert leaf.grad is not None and torch.isfinite(leaf.grad).all()


@pytest.mark.parametrize("op", ["attention", "ssd", "mlstm"])
def test_autograd_route_is_the_chunked_plain_form(op):
    """"autograd" is the differentiable chunked form, and agrees with
    "ref" (for ssd and mlstm the token-by-token oracle) in fp32."""
    args, kw = _op_inputs(op)
    fn = getattr(ops, op)
    got = fn(*args, impl="autograd", **kw)
    assert torch.equal(got, _CHUNKED[op](*args, **kw))
    np.testing.assert_allclose(got.numpy(), fn(*args, impl="ref",
                                               **kw).numpy(),
                               atol=2e-4, rtol=0)


def test_autograd_impl_is_refused_by_the_drift_ops():
    with pytest.raises(ValueError, match="unknown"):
        ops.pairwise_js(torch.rand(2, 8), torch.rand(3, 8), impl="autograd")
