"""The port's fleet decode step (one decode for lanes that query different
group models at different positions) held to the JAX package's
`make_fleet_decode_step`, and to each slot decoded alone; the per-lane
`lengths` of the attention it makes one call of per global layer.

Smoke widths of olmo (dense), hymba (global layer 0, windowed layer 1 with
window 16 and 4 meta tokens) and xlstm, vocabulary 64; three group models
from the JAX `Model.init` of seeds 0, 1 and 2, bridged; seven lanes at
staggered positions, two of each hymba ring's lanes past its wrap. fp32
compute over an fp32 pool: the two packages differ by summation order
only, logits within 1e-5 and tokens equal. bf16 compute over a bf16 pool:
tokens equal wherever the reference's top-1 leads its top-2 by more than
1e-2 (the rule of tests/test_torch_hymba.py).
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
from repro.serve.serve_step import \
    make_fleet_decode_step as jax_fleet_step  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.kernels.ref import attention_ref  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.models.param import tree_leaves, tree_map  # noqa: E402
from repro_torch.serve.serve_step import (fleet_decode_logits,  # noqa: E402
                                          make_fleet_decode_step)

VOCAB = 64
ARCHS = ("olmo-1b", "hymba-1.5b", "xlstm-350m")
LOGIT_TOL = 1e-5        # fp32 logits, port vs JAX
CACHE_TOL = 1e-5        # fp32 cache rows written by the step
LEAD = 1e-2             # bf16: tokens compared where top-1 leads by more
ROWS = [0, 1, 2, 1, 0, 2, 1]
PROMPTS = [5, 9, 20, 14, 3, 30, 11]      # staggered positions
CAP = 48
TICKS = 3
DT = {"fp32": (jnp.float32, torch.float32),
      "bf16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(scope="module", params=ARCHS)
def fleet(request):
    arch = request.param
    jcfg = dataclasses.replace(jax_smoke_config(arch), vocab_size=VOCAB)
    tcfg = dataclasses.replace(smoke_config(arch), vocab_size=VOCAB)
    jm, tm = jax_build_model(jcfg), build_model(tcfg)
    init = jax.jit(jm.init)
    jps = [init(jax.random.PRNGKey(s)) for s in range(3)]
    jstack = jax.tree.map(lambda *x: jnp.stack(x), *jps)
    tstack = params_from_numpy(jax.tree.map(np.asarray, jstack),
                               device="cpu")
    return arch, jm, jps, jstack, tm, tstack


def _paths(tree, prefix=""):
    """{path: leaf} of a nested dict/list tree (either package's)."""
    if isinstance(tree, dict):
        out = {}
        for k in tree:
            out.update(_paths(tree[k], f"{prefix}{k}/"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_paths(v, f"{prefix}{i}/"))
        return out
    return {prefix[:-1]: tree}


def _np(x):
    return (x.float().numpy() if torch.is_tensor(x)
            else np.asarray(x, np.float32))


def _as_jax(tree, jdt):
    """The port's pool tree as the JAX pool: every leaf in `jdt` but the
    xLSTM stabilisers m, which both pools keep in fp32."""
    if isinstance(tree, dict):
        return {k: (jnp.asarray(_np(v)) if k == "m" else _as_jax(v, jdt))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_as_jax(v, jdt) for v in tree]
    return jnp.asarray(_np(tree), jdt)


def _as_torch(tree, like):
    """A JAX tree as a port tree of `like`'s key order and dtypes."""
    if isinstance(like, dict):
        return {k: _as_torch(tree[k], v) for k, v in like.items()}
    if isinstance(like, list):
        return [_as_torch(t, v) for t, v in zip(tree, like)]
    return torch.from_numpy(_np(tree).copy()).to(like.dtype)


_POOLS = {}


def _pool(fleet, precision):
    """Each lane's prompt prefilled by its group's model (the port, at the
    precision's compute) into lane a of a pool of the lanes in the
    precision's dtype, as the pools cast on write. Returns (pool, first
    tokens, positions); both packages decode from this cache."""
    arch, jm, jps, jstack, tm, tstack = fleet
    key = (arch, precision)
    if key not in _POOLS:
        tdt = DT[precision][1]
        stack = tree_map(lambda t: t.to(tdt), tstack)
        cap = CAP + tm.cfg.meta_tokens
        rng = np.random.default_rng(0)
        pool = tm.init_cache(len(ROWS), cap, tdt, "cpu")
        toks, poss = [], []
        for a, (r, n) in enumerate(zip(ROWS, PROMPTS)):
            params = tree_map(lambda t, r=r: t[r], stack)
            prompt = torch.as_tensor(rng.integers(0, VOCAB, size=n))[None]
            last, c, pos = tm.prefill(params, prompt, cap, compute_dtype=tdt)
            for dst, src in zip(tree_leaves(pool), tree_leaves(c)):
                dst[:, a] = src[:, 0].to(dst.dtype)
            toks.append(int(last[0].float().argmax()))
            poss.append(int(pos))
        _POOLS[key] = (pool, toks, poss)
    pool, toks, poss = _POOLS[key]
    return tree_map(lambda t: t.clone(), pool), list(toks), list(poss)


def _jax_logits_step(jm, jdt):
    """The JAX fleet step's own arithmetic (rows gathered, the B=1 decode
    vmapped over lanes), returning each lane's logits too."""
    def one(params, token, cache, pos):
        cb = jax.tree.map(lambda c: c[:, None], cache)
        logits, nc = jm.decode(params, token[None, None], cb, pos,
                               compute_dtype=jdt)
        return logits[0, -1], jax.tree.map(lambda c: c[:, 0], nc)

    def step(stack, rows, tokens, cache, pos):
        params = jax.tree.map(lambda x: x[rows], stack)
        return jax.vmap(one, in_axes=(0, 0, 1, 0),
                        out_axes=(0, 1))(params, tokens, cache, pos)
    return jax.jit(step)


def _lead(logits):
    top2 = np.sort(np.asarray(logits, np.float32)[..., :VOCAB], -1)[..., -2:]
    return top2[..., 1] - top2[..., 0]


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_fleet_step_matches_jax(fleet, precision):
    """TICKS fleet ticks teacher-forced on the reference's tokens: each
    tick's tokens against the JAX `make_fleet_decode_step`'s, the logits
    (fp32) and the cache rows it wrote against the JAX step's."""
    arch, jm, jps, jstack, tm, tstack = fleet
    jdt, tdt = DT[precision]
    tstack = tree_map(lambda t: t.to(tdt), tstack)
    tpool, toks, poss = _pool(fleet, precision)
    jpool = _as_jax(tpool, jdt)
    if arch == "hymba-1.5b":     # the ring (16 wide) has wrapped
        assert sum(p >= 16 for p in poss) >= 2, poss
    jstep = jax.jit(jax_fleet_step(jm, compute_dtype=jdt))
    jlog = _jax_logits_step(jm, jdt)
    tstep = make_fleet_decode_step(tm, compute_dtype=tdt)
    rows = jnp.asarray(ROWS, jnp.int32)
    decided = 0
    for tick in range(TICKS):
        jt, jp = jnp.asarray(toks, jnp.int32), jnp.asarray(poss, jnp.int32)
        want, _ = jstep(jstack, rows, jt, jpool, jp)
        jl, jnew = jlog(jstack, rows, jt, jpool, jp)
        assert np.array_equal(np.asarray(want), np.argmax(
            np.asarray(jl, np.float32), -1))
        again = tree_map(lambda t: t.clone(), tpool)
        tl, _ = fleet_decode_logits(tm, tstack, ROWS, toks, tpool, poss,
                                    compute_dtype=tdt)
        got, _ = tstep(tstack, ROWS, toks, again, poss)
        assert got.tolist() == tl[:, 0].float().argmax(-1).tolist()
        want = np.asarray(want).tolist()
        if precision == "fp32":
            np.testing.assert_allclose(
                tl[:, 0, :VOCAB].numpy(), np.asarray(jl)[:, :VOCAB],
                atol=LOGIT_TOL, rtol=LOGIT_TOL, err_msg=f"tick {tick}")
            assert got.tolist() == want, tick
            jw = _paths(jnew)
            for path, leaf in _paths(tpool).items():
                np.testing.assert_allclose(_np(leaf), _np(jw[path]),
                                           atol=CACHE_TOL, rtol=CACHE_TOL,
                                           err_msg=path)
        else:
            lead = _lead(jl)
            for a in range(len(ROWS)):
                if lead[a] > LEAD:
                    assert got.tolist()[a] == want[a], (tick, a, lead[a])
                    decided += 1
        jpool = jnew
        tpool = _as_torch(jnew, tpool)
        toks = want
        poss = [p + 1 for p in poss]
    if precision == "bf16":
        assert decided >= len(ROWS) * TICKS // 2, decided


# lanes of the pool: all seven (slots 4 and 7 of 9 hold none); or the
# lanes of rows 0 and 2 only, with row 1 still computed (the plane passes
# every live serving row), a live group no lane reads
LANES = {"all": list(range(len(ROWS))),
         "idle-group": [a for a, r in enumerate(ROWS) if r != 1]}


@pytest.mark.parametrize("precision,lanes", [
    pytest.param(p, la, id=p if la == "all" else f"{p}-{la}")
    for la in LANES for p in ("fp32", "bf16")])
def test_fleet_tick_equals_each_slot_alone(fleet, precision, lanes):
    """The port's step over a pool larger than its lanes (lanes in a
    permuted subset of the slots, the plane's call, every group of the
    stack computed) against each lane decoded alone by `make_decode_step`
    on its own row, TICKS ticks on each side's own tokens: equal in fp32;
    in bf16 equal wherever the solo top-1 leads by more than 1e-2, until
    the first nearer tie."""
    arch, jm, jps, jstack, tm, tstack = fleet
    tdt = DT[precision][1]
    tstack = tree_map(lambda t: t.to(tdt), tstack)
    one, toks0, poss0 = _pool(fleet, precision)
    lane = LANES[lanes]
    rows = [ROWS[a] for a in lane]
    slots = [[5, 0, 3, 6, 2, 8, 1][a] for a in lane]   # lanes' pool rows
    pool = tm.init_cache(9, CAP + tm.cfg.meta_tokens, tdt, "cpu")
    for dst, src in zip(tree_leaves(pool), tree_leaves(one)):
        dst[:, slots] = src[:, lane]
    step = make_fleet_decode_step(tm, compute_dtype=tdt)
    toks, poss = [toks0[a] for a in lane], [poss0[a] for a in lane]
    fleet_out = []
    for _ in range(TICKS):
        nxt, _ = step(tstack, rows, toks, pool, poss, slots=slots,
                      groups=range(3))
        fleet_out.append(nxt.tolist())
        toks, poss = nxt.tolist(), [p + 1 for p in poss]
    compared = 0
    for i, (a, r) in enumerate(zip(lane, rows)):
        params = tree_map(lambda t, r=r: t[r], tstack)
        cache = tree_map(lambda t, a=a: t[:, a:a + 1].clone(), one)
        tok, pos = toks0[a], poss0[a]
        for tick in range(TICKS):
            logits, _ = tm.decode(params, torch.tensor([[tok]]), cache, pos,
                                  compute_dtype=tdt)
            lg = logits[0, -1].float()
            nxt = int(lg.argmax())
            if precision == "bf16" and _lead(lg.numpy()) <= LEAD:
                break
            assert fleet_out[tick][i] == nxt, (arch, a, tick)
            compared += 1
            tok, pos = nxt, pos + 1
        else:
            continue
    assert compared >= len(lane) * TICKS // 2, compared
    if precision == "fp32":
        assert compared == len(lane) * TICKS


def test_fleet_step_through_decode_step_per_lane_positions(fleet):
    """`decode_step` with a (B,) position tensor (one model, per-lane
    positions) equals the fleet step with every lane on one row."""
    arch, jm, jps, jstack, tm, tstack = fleet
    a, toks, poss = _pool(fleet, "fp32")
    b = tree_map(lambda t: t.clone(), a)
    params = tree_map(lambda t: t[0], tstack)
    logits, _ = tm.decode(params, torch.tensor(toks)[:, None], a,
                          torch.tensor(poss), compute_dtype=torch.float32)
    fl, _ = fleet_decode_logits(tm, tstack, [0] * len(ROWS), toks, b, poss,
                                compute_dtype=torch.float32)
    np.testing.assert_allclose(logits.numpy(), fl.numpy(), atol=1e-5,
                               rtol=1e-5)
    assert logits[:, 0].argmax(-1).tolist() == fl[:, 0].argmax(-1).tolist()
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        np.testing.assert_allclose(x.numpy(), y.numpy(), atol=1e-5,
                                   rtol=1e-5)


# ---------------------------------------------------------------------------
# attention with per-lane lengths
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,cap,H,K,hd,window", [
    (6, 1, 40, 4, 2, 16, 0),
    (5, 1, 300, 16, 16, 64, 0),        # olmo's heads, narrow
    (4, 1, 100, 25, 5, 64, 0),         # hymba's GQA 25/5
    (3, 2, 70, 4, 2, 32, 0),           # two appended queries
    (4, 1, 90, 4, 2, 16, 16),          # windowed
])
def test_attention_ref_lengths_is_each_lanes_prefix(dtype, B, S, cap, H, K,
                                                     hd, window):
    g = torch.Generator().manual_seed(B * cap + hd)
    q = torch.randn(B, S, H, hd, generator=g).to(dtype)
    k, v = (torch.randn(B, cap, K, hd, generator=g).to(dtype)
            for _ in range(2))
    lengths = torch.randint(S, cap + 1, (B,), generator=g,
                            dtype=torch.int32)
    lengths[0] = cap
    out = attention_ref(q, k, v, window=window, lengths=lengths)
    for b, n in enumerate(lengths.tolist()):
        want = attention_ref(q[b:b + 1], k[b:b + 1, :n], v[b:b + 1, :n],
                             window=window)
        assert torch.equal(out[b:b + 1], want), b
    got = ops.attention(q, k, v, window=window, lengths=lengths)
    assert torch.equal(got, out)
    assert torch.equal(
        flash_attention(q, k, v, window=window, lengths=lengths), out)


def test_attention_lengths_zero_lane_and_refusals():
    g = torch.Generator().manual_seed(3)
    bf = torch.bfloat16
    q = torch.randn(3, 1, 16, 64, generator=g).to(bf)
    k, v = (torch.randn(3, 64, 16, 64, generator=g).to(bf) for _ in range(2))
    lengths = torch.tensor([0, 5, 64], dtype=torch.int32)
    out = ops.attention(q, k, v, lengths=lengths)
    assert torch.equal(out[0], torch.zeros_like(out[0]))  # a row of no lane
    with pytest.raises(ValueError, match="int32"):
        ops.attention(q, k, v, lengths=lengths.to(torch.int64))
    with pytest.raises(ValueError, match="int32"):
        ops.attention(q, k, v, lengths=lengths[:2])
    # a prefill (S x G > 16 query rows per kv head) takes no lengths
    qp = torch.randn(3, 32, 16, 64, generator=g).to(bf)
    with pytest.raises(ValueError, match="prefill"):
        ops.attention(qp, k, v, lengths=lengths)
    with pytest.raises(ValueError, match="prefill"):
        flash_attention(qp, k, v, lengths=lengths)
