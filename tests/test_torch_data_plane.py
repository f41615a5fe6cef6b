"""The port's data plane between streams and jobs held to the JAX package:
`repro_torch.data.pipeline` (StreamBuffer, GroupPipeline) and
`repro_torch.data.teacher` (OracleTeacher, scale_config, ModelTeacher).

The pipeline is numpy on the host in both packages: equal seeds draw
equal batches, compared bit for bit. The model teacher runs the port's
fp32 forward on bridged weights (logits within 2e-4) and its train step
(the autograd route) for `fit`, held to the reference's jitted step by
the rule of tests/test_torch_train.py.
"""
import dataclasses

import numpy as np
import pytest
from config_parity import reference_fields

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402

from repro.configs import smoke_config as jax_smoke_config  # noqa: E402
from repro.configs.base import TrainConfig as JTrainConfig  # noqa: E402
from repro.data import pipeline as jpipe  # noqa: E402
from repro.data import teacher as jteacher  # noqa: E402
from repro.data.streams import DomainBank as JDomainBank  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.configs.base import TrainConfig  # noqa: E402
from repro_torch.data import pipeline as tpipe  # noqa: E402
from repro_torch.data import teacher as tteacher  # noqa: E402
from repro_torch.data.streams import DomainBank  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402

VOCAB = 64
FP32_TOL = 2e-4
TCFG = dict(learning_rate=3e-3, warmup_steps=5, total_steps=10,
            remat="none", compute_dtype="float32")


def _equal(a, b):
    """Two batches (dicts of arrays, or None) equal bit for bit."""
    if a is None or b is None:
        assert a is None and b is None
        return
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _script(mod, seed):
    """One scripted run of a GroupPipeline: deliveries under and over
    bandwidth, soft labels, a ring that drops, a stream dropped, batches
    drawn after each change. Returns every batch and the final stats."""
    rng = np.random.default_rng(seed)
    p = mod.GroupPipeline(seq_len=8, capacity_per_stream=6, seed=seed)
    out = [p.group_batch(4)]
    for w in range(5):
        for sid in ("a", "b", "c")[:1 + w % 3]:
            n = int(rng.integers(1, 9))
            toks = rng.integers(0, VOCAB, size=(n, 8))
            soft = rng.random((n, 8, 5)).astype(np.float32)
            bw = None if w % 2 else int(rng.integers(0, 6)) * 8 + 3
            p.deliver(sid, toks, bandwidth_tokens=bw, soft=soft)
        out.append(p.group_batch(7))
        out.append(p.group_batch(16, with_soft=True))
        if w == 3:
            p.drop_stream("b")
    return out, p.stats(), p.total_rows()


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_group_pipeline_draws_the_references_batches(seed):
    want, wstats, wrows = _script(jpipe, seed)
    got, gstats, grows = _script(tpipe, seed)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _equal(g, w)
    assert gstats == wstats and grows == wrows


def test_stream_buffer_matches_the_reference():
    rows = np.arange(8 * 9).reshape(9, 8)
    soft = np.arange(9 * 8 * 3, dtype=np.float32).reshape(9, 8, 3)
    bufs = []
    for mod in (jpipe, tpipe):
        b = mod.StreamBuffer(seq_len=8, capacity=4)
        b.push(rows[:3], soft[:3])
        b.push(rows[3:], soft[3:])
        bufs.append(b)
    want, got = bufs
    assert (len(got), got.delivered_total, got.dropped_total) == \
        (len(want), want.delivered_total, want.dropped_total) == (4, 9, 5)
    np.testing.assert_array_equal(got.tokens, want.tokens)
    np.testing.assert_array_equal(got.soft, want.soft)


def test_scale_config_equals_the_reference():
    for arch, kw in [("olmo-1b", {}), ("qwen2-moe-a2.7b",
                                      dict(depth_mult=1.5, width_mult=2.0)),
                     ("hubert-xlarge", dict(width_mult=0.5))]:
        want = jteacher.scale_config(jax_smoke_config(arch), **kw)
        got = tteacher.scale_config(smoke_config(arch), **kw)
        assert reference_fields(got, want) == dataclasses.asdict(want), arch


def test_oracle_teacher_equals_the_reference():
    toks = np.random.default_rng(3).integers(0, 32, size=(3, 10))
    want = jteacher.OracleTeacher(JDomainBank(32, 3, seed=5)).annotate(
        2, toks)
    got = tteacher.OracleTeacher(DomainBank(32, 3, seed=5)).annotate(2, toks)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def teachers():
    """The reference's ModelTeacher of the olmo smoke student (vocabulary
    64) and the port's on the CPU with the reference's weights bridged."""
    cfg = dataclasses.replace(jax_smoke_config("olmo-1b"), vocab_size=VOCAB)
    jt = jteacher.ModelTeacher(cfg, seed=0)
    tt = tteacher.ModelTeacher(
        dataclasses.replace(smoke_config("olmo-1b"), vocab_size=VOCAB),
        seed=0, device="cpu")
    assert reference_fields(tt.cfg, jt.cfg) == dataclasses.asdict(jt.cfg)
    assert tt.cfg.num_layers == 4
    tt.params = params_from_numpy(jax.tree.map(np.asarray, jt.params),
                                  device="cpu")
    return jt, tt


def test_model_teacher_annotate_matches_the_reference(teachers):
    jt, tt = teachers
    toks = np.random.default_rng(4).integers(0, VOCAB, size=(3, 16))
    want, got = jt.annotate(toks), tt.annotate(toks)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got[..., :VOCAB], want[..., :VOCAB],
                               atol=FP32_TOL, rtol=0)


def test_model_teacher_fit_matches_the_reference(teachers):
    """Three fp32 steps of `fit` over two pooled batches (so the second
    pass starts over): parameters after them held as tests/test_torch_
    train.py holds four steps (under 1 % of elements farther than 16 ulp
    + 1e-7), and the fitted teachers' logits within 2e-4."""
    jt, tt = teachers
    rng = np.random.default_rng(6)
    batches = [{"inputs": t, "labels": t}
               for t in (rng.integers(0, VOCAB, size=(4, 16))
                         for _ in range(2))]
    jt.fit(batches, steps=3, tcfg=JTrainConfig(**TCFG))
    tt.fit(batches, steps=3, tcfg=TrainConfig(**TCFG))
    far = total = 0
    for path, w in jax.tree_util.tree_leaves_with_path(jt.params):
        node = tt.params
        for k in path:
            node = node[k.key if hasattr(k, "key") else k.idx]
        w = np.asarray(w)
        ulp = np.spacing(np.abs(w).astype(np.float32))
        far += int((np.abs(node.numpy() - w) > 16 * ulp + 1e-7).sum())
        total += w.size
    assert far <= 0.01 * total, (far, total)
    toks = batches[0]["inputs"]
    np.testing.assert_allclose(tt.annotate(toks)[..., :VOCAB],
                               jt.annotate(toks)[..., :VOCAB],
                               atol=FP32_TOL, rtol=0)


def test_model_teacher_runs_on_cuda_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tteacher.ModelTeacher(smoke_config("olmo-1b"))
