"""The dry run's per-layer costs (`launch.roofline.segment_layer_cost`)
held to the reference's `segment_layer_cost` on a one-device mesh.

Smoke width, batch 2, 32 tokens, fp32 parameters and activations, remat
"full". Each case is one layer of a segment: a dense block (olmo), a MoE
block with the dense dispatch and expert-parallel (qwen2-moe), an mLSTM
block with and without the sequence-parallel path and an sLSTM block
(xlstm), each as a train step, a prefill and a decode step. The port
counts on `meta` tensors (its FLOP counter: matrix products plus one FLOP
per element of the other arithmetic); the reference reads XLA's
`cost_analysis()` of the compiled layer, less XLA's dtype converts
(`tools/roofline_flops_check.py`), as tests/test_torch_roofline.py holds
the `CostTable`, within its FLOPS_RTOL (5 %).

Five cases lie above that band, each for a stated cause in the reference's
count, and are held to lie above it and within 1.5x of it:
  * the mLSTM prefill: XLA folds the products with the zero initial state
    away, the port multiplies them;
  * the seqpar mLSTM (train, prefill): the port's state-only summary pass
    runs the whole chunked form and drops its output;
  * the sLSTM (train, prefill): XLA counts the body of its time-step
    `lax.scan` once (the reference's own docstring names this undercount).
"""
import importlib.util
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

from repro.configs import smoke_config as jsmoke_config  # noqa: E402
from repro.distributed.sharding import mesh_rules as jmesh_rules  # noqa: E402
from repro.launch import roofline as JR  # noqa: E402
from repro.models import param as jP  # noqa: E402
from repro.models import transformer as jT  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.distributed.sharding import mesh_rules  # noqa: E402
from repro_torch.launch import roofline as RL  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models.transformer import layer_plan  # noqa: E402

FLOPS_RTOL = 0.05
ABOVE = 1.5
B, S = 2, 32
KINDS = ("train", "prefill", "decode")
# (case, arch, segment index, moe_impl, ssm_impl)
CASES = [("dense-block", "olmo-1b", 0, "dense", "gspmd"),
         ("moe-block", "qwen2-moe-a2.7b", 0, "dense", "gspmd"),
         ("moe-block-ep", "qwen2-moe-a2.7b", 0, "ep", "gspmd"),
         ("mlstm", "xlstm-350m", 0, "dense", "gspmd"),
         ("mlstm-seqpar", "xlstm-350m", 0, "dense", "seqpar"),
         ("slstm", "xlstm-350m", 1, "dense", "gspmd")]
OUT_OF_BAND = {("mlstm", "prefill"), ("mlstm-seqpar", "train"),
               ("mlstm-seqpar", "prefill"), ("slstm", "train"),
               ("slstm", "prefill")}


def _converted_elements():
    """tools/roofline_flops_check.py's count of XLA's converts."""
    path = pathlib.Path(__file__).parents[1] / "tools" / \
        "roofline_flops_check.py"
    spec = importlib.util.spec_from_file_location("roofline_flops_check",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.converted_elements


def _no_collectives(hlo):
    return {k: 0 for k in RL.COLLECTIVES + ("total",)}


@pytest.mark.parametrize("case,arch,i,moe_impl,ssm_impl", CASES,
                         ids=[c[0] for c in CASES])
def test_layer_costs_match_the_reference(case, arch, i, moe_impl, ssm_impl,
                                         monkeypatch):
    converts = []
    cost_dict = JR._cost_dict

    def counted(compiled, fn):
        converts.append(_converted_elements()(compiled.as_text()))
        return cost_dict(compiled, fn)
    monkeypatch.setattr(JR, "_cost_dict", counted)

    jcfg, cfg = jsmoke_config(arch), smoke_config(arch)
    jmesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                 ("data", "model"))
    tmesh = make_mesh((1, 1), ("data", "model"), devices=["meta"])
    jrules, trules = jmesh_rules(jmesh, jcfg), mesh_rules(tmesh, cfg)
    jseg, seg = jT.layer_plan(jcfg)[i], layer_plan(cfg)[i]
    for kind in KINDS:
        cache = None
        if kind == "decode":
            one = jP.tree_map_specs(
                lambda s: jP.Spec(s.shape[1:], s.axes[1:], s.init),
                jT.cache_spec(jcfg, B, S + jcfg.meta_tokens)["segments"][i])
            cache = jP.abstract_params(one, jmesh, jrules, jnp.float32)
        converts.clear()
        want = JR.segment_layer_cost(
            jcfg, jseg, mesh=jmesh, rules=jrules, batch=B, seq=S, kind=kind,
            moe_impl=moe_impl, remat="full", collective_fn=_no_collectives,
            cache_slice=cache, ssm_impl=ssm_impl,
            compute_dtype=jnp.float32)["flops"] - converts[0]
        got = RL.segment_layer_cost(
            cfg, seg, mesh=tmesh, rules=trules, batch=B, seq=S, kind=kind,
            moe_impl=moe_impl, remat="full", ssm_impl=ssm_impl,
            compute_dtype=torch.float32)["flops"]
        if (case, kind) in OUT_OF_BAND:
            assert want * (1 + FLOPS_RTOL) < got <= ABOVE * want, \
                (kind, got, want)
        else:
            assert got == pytest.approx(want, rel=FLOPS_RTOL), \
                (kind, got, want)


def test_remat_prices_the_recompute_and_keeps_fewer_bytes():
    """A train step's layer under remat "full" counts the recompute, at
    most one more forward (a prefill's count; the checkpoint stops its
    recompute once the backward's tensors are back, short of the layer's
    last products), and keeps fewer bytes for the backward than "none";
    "dots" keeps bytes between the two."""
    cfg = smoke_config("olmo-1b")
    mesh = make_mesh((1, 1), ("data", "model"), devices=["meta"])
    rules = mesh_rules(mesh, cfg)
    seg = layer_plan(cfg)[0]

    def cost(kind, remat="none"):
        return RL.segment_layer_cost(cfg, seg, mesh=mesh, rules=rules,
                                     batch=B, seq=S, kind=kind, remat=remat,
                                     compute_dtype=torch.float32)
    none, dots, full = (cost("train", r) for r in ("none", "dots", "full"))
    forward = cost("prefill")["flops"]
    assert none["flops"] + forward / 2 < full["flops"] <= \
        none["flops"] + forward
    assert none["flops"] <= dots["flops"] < full["flops"]
    assert full["saved_bytes"] < dots["saved_bytes"] < none["saved_bytes"]
