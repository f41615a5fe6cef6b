"""The port's sequence-parallel mLSTM (`repro_torch.models.xlstm.
mlstm_state_summary`, `combine_mlstm_states`, `apply_mlstm_block_seqpar`,
the xLSTM prefill with ssm_impl="seqpar") and the seeded `ops.mlstm`
held to the reference.

The reference's own check (tests/test_seqpar.py) runs its shard_map block
in a subprocess with 8 forced host devices; the port's mesh is one
process of repeated `cpu` entries, and the port's block is held to the
reference's UNSHARDED block within that check's tolerances: out 1e-4,
conv 1e-5, C in the invariant frame C e^(m - M) 1e-4. On the CPU every
pass is the plain chunked form (`ref.mlstm_chunked`), the kernel's plain
version.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import smoke_config as jax_smoke_config  # noqa: E402
from repro.models import param as jP  # noqa: E402
from repro.models import xlstm as jx  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models import xlstm as tx  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402

SUMMARY_TOL = 1e-5
OUT_TOL = 1e-4
CONV_TOL = 1e-5
STATE_TOL = 1e-4
FP32_TOL = 2e-4
VOCAB = 64


def _qkvg(seed, B, S, H, P):
    r = np.random.default_rng(seed)
    f = np.float32
    return (r.standard_normal((B, S, H, P)).astype(f),
            r.standard_normal((B, S, H, P)).astype(f),
            r.standard_normal((B, S, H, P)).astype(f),
            (r.standard_normal((B, S, H)) * 2).astype(f),
            (r.standard_normal((B, S, H)) * 2 + 1).astype(f))


def _t(*xs):
    return [torch.from_numpy(x) for x in xs]


def _invariant(C, m, M):
    return C * np.exp(m - M)[..., None, None]


@pytest.mark.parametrize("split", [16, 64, 96])
def test_summary_and_combine_equal_the_reference(split):
    """At the splits of tests/test_seqpar.py (chunk 16, so no padding):
    each part's summary and the combine of the two equal the reference's,
    and the second part run from the first's summary continues the whole
    sequence's output."""
    q, k, v, ig, fg = _qkvg(0, 2, 128, 2, 16)
    a, b = slice(0, split), slice(split, 128)
    parts = []
    for s in (a, b):
        (C, n, m), bt = tx.mlstm_state_summary(
            *_t(k[:, s], v[:, s], ig[:, s], fg[:, s]), chunk=16)
        (jC, jn, jm), jbt = jx.mlstm_state_summary(
            *(jnp.asarray(t[:, s]) for t in (k, v, ig, fg)), chunk=16)
        for got, want in ((C, jC), (n, jn), (m, jm), (bt, jbt)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       atol=SUMMARY_TOL, rtol=SUMMARY_TOL)
        parts.append(((C, n, m), bt, (jC, jn, jm), jbt))
    got = tx.combine_mlstm_states(parts[0][0], parts[1][1], parts[1][0])
    want = jx.combine_mlstm_states(parts[0][2], parts[1][3], parts[1][2])
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                   atol=SUMMARY_TOL, rtol=SUMMARY_TOL)
    qt, kt, vt, it, ft = _t(q, k, v, ig, fg)
    h_b = ops.mlstm(qt[:, b], kt[:, b], vt[:, b], it[:, b], ft[:, b],
                    chunk=16, init_state=parts[0][0])
    h_a = ops.mlstm(qt[:, a], kt[:, a], vt[:, a], it[:, a], ft[:, a],
                    chunk=16)
    h_full = np.asarray(jx.mlstm_chunked(*(jnp.asarray(t) for t in
                                           (q, k, v, ig, fg)), chunk=16))
    np.testing.assert_allclose(torch.cat([h_a, h_b], 1).numpy(), h_full,
                               atol=SUMMARY_TOL, rtol=SUMMARY_TOL)


def test_combine_of_empty_states_stays_finite():
    z = (torch.zeros((1, 2, 4, 4)), torch.zeros((1, 2, 4)),
         torch.full((1, 2), -float("inf")))
    C, n, m = tx.combine_mlstm_states(z, torch.zeros((1, 2)), z)
    jC, jn, jm = jx.combine_mlstm_states(
        tuple(jnp.asarray(t.numpy()) for t in z), jnp.zeros((1, 2)),
        tuple(jnp.asarray(t.numpy()) for t in z))
    assert bool(torch.isfinite(m).all())
    assert float(m.max()) == float(np.float32(-1e30))
    np.testing.assert_array_equal(m.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(C.numpy(), np.asarray(jC))


@pytest.fixture(scope="module")
def block():
    """xlstm smoke's mLSTM block spec, the reference's init, bridged."""
    jcfg = jax_smoke_config("xlstm-350m")
    spec = jx.mlstm_block_spec(jcfg)
    jp = jP.init_params(spec, jax.random.PRNGKey(0))
    return (smoke_config("xlstm-350m"), jcfg, jp,
            params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu"))


def cpu_mesh(data, model):
    axes = ("data", "model") if data else ("model",)
    shape = (data, model) if data else (model,)
    n = (data or 1) * model
    return make_mesh(shape, axes, devices=["cpu"] * n)


def test_seqpar_block_equals_the_reference_unsharded(block):
    """The reference's own check (tests/test_seqpar.py), on the port: a
    (2, 4) mesh, x (4, 64, D), chunk 16 (shards of 16 steps)."""
    cfg, jcfg, jp, tp = block
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(1),
                                     (4, 64, cfg.d_model), jnp.float32))
    mesh = cpu_mesh(2, 4)
    want, _ = jx.apply_mlstm_block(jcfg, jp, jnp.asarray(x), chunk=16)
    out = tx.apply_mlstm_block_seqpar(cfg, tp, torch.from_numpy(x), mesh,
                                      chunk=16)
    assert float(np.abs(out.numpy() - np.asarray(want)).max()) < OUT_TOL
    want2, cref = jx.mlstm_block_states(jcfg, jp, jnp.asarray(x), chunk=16)
    out2, c = tx.apply_mlstm_block_seqpar(cfg, tp, torch.from_numpy(x), mesh,
                                          chunk=16, want_state=True)
    assert float(np.abs(out2.numpy() - np.asarray(want2)).max()) < OUT_TOL
    assert float(np.abs(c["conv"].numpy()
                        - np.asarray(cref["conv"])).max()) < CONV_TOL
    m1, m2 = np.asarray(cref["m"]), c["m"].numpy()
    M = np.maximum(m1, m2)
    a = _invariant(np.asarray(cref["C"]), m1, M)
    b = _invariant(c["C"].numpy(), m2, M)
    assert float(np.abs(a - b).max()) < STATE_TOL
    n_a = np.asarray(cref["n"]) * np.exp(m1 - M)[..., None]
    n_b = c["n"].numpy() * np.exp(m2 - M)[..., None]
    assert float(np.abs(n_a - n_b).max()) < STATE_TOL


def test_seqpar_at_ragged_shards_equals_the_unsharded_port(block):
    """Shards of 20 steps at chunk 16 (a ragged last chunk in every
    shard): the port's seqpar equals the port's unsharded block, out and
    state, whose state is the token recurrence's."""
    cfg, _, _, tp = block
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (2, 80, cfg.d_model)).astype(np.float32))
    out, c = tx.apply_mlstm_block_seqpar(cfg, tp, x, cpu_mesh(0, 4),
                                         batch_axes=(), chunk=16,
                                         want_state=True)
    want, cw = tx.mlstm_block_states(cfg, tp, x, chunk=16)
    assert float((out - want).abs().max()) < OUT_TOL
    torch.testing.assert_close(c["conv"], cw["conv"], rtol=0, atol=0)
    M = torch.maximum(c["m"], cw["m"])
    a = c["C"] * torch.exp(c["m"] - M)[..., None, None]
    b = cw["C"] * torch.exp(cw["m"] - M)[..., None, None]
    assert float((a - b).abs().max()) < STATE_TOL
    # the recurrence's state, token by token
    q, k, v, ig, fg, _, _ = tx._mlstm_in(cfg, tp, x)
    _, (Cr, nr, mr) = ops.mlstm(q, k, v, ig, fg, return_state=True,
                                impl="ref")
    Mr = torch.maximum(c["m"], mr)
    assert float((c["C"] * torch.exp(c["m"] - Mr)[..., None, None]
                  - Cr * torch.exp(mr - Mr)[..., None, None]).abs().max()) \
        < STATE_TOL


def test_reference_summary_decays_at_ragged_shards():
    """The reference's defect that the port does not copy: at a ragged
    shard (20 steps, chunk 16) its summary pads the forget gate with 0 and
    decays the state by log sigmoid(0) per padded step, and its b_total
    counts those steps; the port's summary is the recurrence's."""
    q, k, v, ig, fg = _qkvg(3, 1, 20, 2, 8)
    (jC, jn, jm), jbt = jx.mlstm_state_summary(
        *(jnp.asarray(t) for t in (k, v, ig, fg)), chunk=16)
    (C, n, m), bt = tx.mlstm_state_summary(*_t(k, v, ig, fg), chunk=16)
    _, (Cr, nr, mr) = ref.mlstm_recurrent(*_t(q, k, v, ig, fg),
                                          return_state=True)
    np.testing.assert_allclose(m.numpy(), mr.numpy(), atol=1e-5)
    np.testing.assert_allclose(C.numpy(), Cr.numpy(), atol=1e-5, rtol=1e-5)
    pad = 12 * np.log(0.5)                       # 12 padded steps
    np.testing.assert_allclose(np.asarray(jbt) - bt.numpy(), pad, atol=1e-4)
    # the reference's m (the stabiliser) has decayed over the pad
    assert float(np.max(np.asarray(jm) - m.numpy())) < -1.0


def test_seeded_plain_mlstm_equals_the_recurrence():
    """ops.mlstm(init_state=...) in its plain form (the chunked one, at
    aligned and ragged S) equals `mlstm_recurrent(init_state=...)`, states
    included; the zero state gives the unseeded call exactly."""
    for S, chunk in ((64, 16), (50, 16), (7, 16)):
        q, k, v, ig, fg = _t(*_qkvg(4 + S, 2, S, 2, 8))
        C0 = torch.from_numpy(np.random.default_rng(S).standard_normal(
            (2, 2, 8, 8)).astype(np.float32))
        n0 = torch.from_numpy(np.random.default_rng(S + 1).standard_normal(
            (2, 2, 8)).astype(np.float32))
        m0 = torch.tensor([[0.5, -2.0], [1.5, 0.0]])
        seed = (C0, n0, m0)
        h, st = ops.mlstm(q, k, v, ig, fg, chunk=chunk, init_state=seed,
                          return_state=True)
        hr, sr = ops.mlstm(q, k, v, ig, fg, init_state=seed,
                           return_state=True, impl="ref")
        np.testing.assert_allclose(h.numpy(), hr.numpy(), atol=2e-5,
                                   rtol=2e-5)
        for a, b in zip(st, sr):
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=2e-5,
                                       rtol=2e-5)
        zero = (torch.zeros_like(C0), torch.zeros_like(n0),
                torch.full_like(m0, -float("inf")))
        torch.testing.assert_close(
            ops.mlstm(q, k, v, ig, fg, chunk=chunk, init_state=zero),
            ops.mlstm(q, k, v, ig, fg, chunk=chunk), rtol=0, atol=0)


@pytest.fixture(scope="module")
def xlstm_model():
    from repro.models.model import build_model as jax_build_model
    jcfg = dataclasses.replace(jax_smoke_config("xlstm-350m"),
                               vocab_size=VOCAB)
    cfg = dataclasses.replace(smoke_config("xlstm-350m"), vocab_size=VOCAB)
    jp = jax.jit(jax_build_model(jcfg).init)(jax.random.PRNGKey(0))
    tm = build_model(cfg)
    return tm, params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")


@pytest.mark.parametrize("S", [64, 320])
def test_seqpar_prefill_equals_the_unsharded_prefill(xlstm_model, S):
    """The xLSTM prefill with ssm_impl="seqpar" on a (2, 4) mesh vs the
    port's unsharded prefill: last logits, every cache leaf (C and n in
    the invariant frame), and four greedy decode steps from each cache.
    The block's chunk is 64: S 64 gives shards of 16 steps (one short
    chunk), S 320 shards of 80 (a ragged second chunk)."""
    tm, tp = xlstm_model
    toks = torch.from_numpy(np.random.default_rng(S).integers(
        0, VOCAB, size=(2, S)))
    mesh = cpu_mesh(2, 4)
    kw = dict(compute_dtype=torch.float32, cache_dtype=torch.float32)
    l0, c0, p0 = tm.prefill(tp, toks, S + 8, **kw)
    l1, c1, p1 = tm.prefill(tp, toks, S + 8, mesh=mesh, ssm_impl="seqpar",
                            **kw)
    assert p0 == p1 == S
    np.testing.assert_allclose(l1.numpy(), l0.numpy(), atol=FP32_TOL, rtol=0)
    for s0, s1 in zip(c0["segments"], c1["segments"]):
        if "C" in s0:
            M = torch.maximum(s0["m"], s1["m"])
            for a, b in ((s0["C"] * torch.exp(s0["m"] - M)[..., None, None],
                          s1["C"] * torch.exp(s1["m"] - M)[..., None, None]),
                         (s0["n"] * torch.exp(s0["m"] - M)[..., None],
                          s1["n"] * torch.exp(s1["m"] - M)[..., None])):
                assert float((a - b).abs().max()) < STATE_TOL
            torch.testing.assert_close(s1["conv"], s0["conv"], rtol=0,
                                       atol=CONV_TOL)
        else:      # the sLSTM, on the mLSTM layers' outputs
            for k in s0:
                torch.testing.assert_close(s1[k], s0[k], rtol=0,
                                           atol=FP32_TOL)
    tok0 = tok1 = l0.argmax(-1)[:, None]
    assert torch.equal(l1.argmax(-1)[:, None], tok0)
    for step in range(4):
        d0, c0 = tm.decode(tp, tok0, c0, p0 + step,
                           compute_dtype=torch.float32)
        d1, c1 = tm.decode(tp, tok1, c1, p1 + step,
                           compute_dtype=torch.float32)
        np.testing.assert_allclose(d1.numpy(), d0.numpy(), atol=FP32_TOL,
                                   rtol=0)
        tok0 = d0[:, -1].argmax(-1)[:, None]
        tok1 = d1[:, -1].argmax(-1)[:, None]
        assert torch.equal(tok0, tok1)


def test_seqpar_forward_and_train_step(xlstm_model):
    """The forward with ssm_impl="seqpar" equals the unsharded one, and a
    train step differentiates it (both passes on the chunked plain form)
    with the unsharded step's gradients."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.models.param import tree_leaves
    from repro_torch.train import train_step as tts
    tm, tp = xlstm_model
    toks = torch.from_numpy(np.random.default_rng(8).integers(
        0, VOCAB, size=(2, 32)))
    mesh = cpu_mesh(2, 4)
    a, _ = tm.apply(tp, toks, compute_dtype=torch.float32)
    b, _ = tm.apply(tp, toks, compute_dtype=torch.float32, mesh=mesh,
                    ssm_impl="seqpar")
    np.testing.assert_allclose(b.numpy(), a.numpy(), atol=FP32_TOL, rtol=0)
    tcfg = TrainConfig(remat="none", compute_dtype="float32")
    batch = {"inputs": toks, "labels": toks}
    grads = [torch.func.grad_and_value(tts.make_loss_fn(tm, tcfg, **kw),
                                       has_aux=True)(tp, batch)[0]
             for kw in ({}, dict(mesh=mesh, ssm_impl="seqpar"))]
    for g0, g1 in zip(tree_leaves(grads[0]), tree_leaves(grads[1])):
        np.testing.assert_allclose(g1.numpy(), g0.numpy(), atol=FP32_TOL,
                                   rtol=1e-3)
