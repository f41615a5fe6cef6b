"""Public model API, as in the JAX package's `models/model.py`:

    model = build_model(cfg)
    params = model.init(seed=0, device="cuda")
    logits, aux = model.apply(params, tokens)
    last, cache, pos = model.prefill(params, tokens, cap)
    logits, cache = model.decode(params, token, cache, pos)

Parameters and caches are nested dicts of tensors on one device; compute
runs where they lie. `capacity_factor` sets a MoE model's per-expert
capacity, as in the JAX package. `build_model(cfg, ep=, tp=)` pads the
experts and the query heads for a sharded model; `apply` / `prefill` /
`decode` take the reference's `mesh`, `rules` (through a `ShardCtx`),
`moe_impl` ("dense" or "ep") and, for the forward and prefill, `ssm_impl`
("gspmd" or "seqpar"); `apply` takes the reference's `remat` ("none",
"dots" or "full", per layer: `transformer._remat_wrap`). `param_shardings`, `abstract_params` and
`abstract_cache` give the pspec tuples and the per-entry `meta` blocks of
the dry run. `init` and `init_cache` default to CUDA and raise when it is
missing (pass device="cpu" for the CPU).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import SHAPES, ModelConfig
from repro_torch.models import param as P
from repro_torch.models import transformer as T


@dataclasses.dataclass
class Model:
    cfg: ModelConfig
    spec: Any
    ep: int = 1
    tp: int = 1

    # ---- parameters -------------------------------------------------------
    def init(self, seed: int = 0, dtype=torch.float32, device="cuda"):
        gen = torch.Generator(device=resolve_device(device))
        gen.manual_seed(seed)
        return P.init_params(self.spec, gen, dtype)

    def abstract_params(self, mesh, rules, dtype=torch.float32):
        return P.abstract_params(self.spec, mesh, rules, dtype)

    def param_shardings(self, mesh, rules):
        return P.shardings(self.spec, mesh, rules)

    def num_params(self) -> int:
        return P.param_count(self.spec)

    # ---- compute ----------------------------------------------------------
    def apply(self, params, inputs, *, compute_dtype=torch.bfloat16,
              kernel_impl: str = "auto", capacity_factor: float = 1.25,
              moe_impl: str = "dense", mesh=None, rules=None,
              ssm_impl: str = "gspmd", remat: str = "none"):
        T.check_ported(moe_impl=moe_impl, ssm_impl=ssm_impl)
        logits, aux, _ = T.forward(self.cfg, params, inputs,
                                   compute_dtype=compute_dtype,
                                   kernel_impl=kernel_impl,
                                   capacity_factor=capacity_factor,
                                   ctx=_ctx(mesh, rules), moe_impl=moe_impl,
                                   mesh=mesh, ssm_impl=ssm_impl, remat=remat)
        return logits, aux

    def prefill(self, params, inputs, cap: int, *,
                compute_dtype=torch.bfloat16, cache_dtype=torch.bfloat16,
                kernel_impl: str = "auto", capacity_factor: float = 1.25,
                moe_impl: str = "dense", mesh=None, rules=None,
                ssm_impl: str = "gspmd"):
        T.check_ported(moe_impl=moe_impl, ssm_impl=ssm_impl)
        return T.prefill(self.cfg, params, inputs, cap,
                         compute_dtype=compute_dtype,
                         cache_dtype=cache_dtype, kernel_impl=kernel_impl,
                         capacity_factor=capacity_factor,
                         ctx=_ctx(mesh, rules), moe_impl=moe_impl,
                         mesh=mesh, ssm_impl=ssm_impl)

    def decode(self, params, token, cache, pos, *,
               compute_dtype=torch.bfloat16, kernel_impl: str = "auto",
               capacity_factor: float = 1.25, moe_impl: str = "dense",
               mesh=None, rules=None):
        T.check_ported(moe_impl=moe_impl)
        return T.decode_step(self.cfg, params, token, cache, pos,
                             compute_dtype=compute_dtype,
                             kernel_impl=kernel_impl,
                             capacity_factor=capacity_factor,
                             ctx=_ctx(mesh, rules), moe_impl=moe_impl,
                             mesh=mesh)

    # ---- cache ------------------------------------------------------------
    def cache_spec(self, batch: int, cap: int):
        return T.cache_spec(self.cfg, batch, cap)

    def init_cache(self, batch: int, cap: int, dtype=torch.bfloat16,
                   device="cuda"):
        """A fresh decode cache as in the JAX package's: a "neg_inf" leaf
        (the xLSTM stabilisers m) fp32 filled with -inf, every other leaf
        zeros in `dtype` (hymba's Mamba state and the xLSTM C, n, h, c
        included), bf16 by default whatever the compute dtype, but for a
        "zeros_fp32" leaf (the Mamba-2 mixers' state), zeros in fp32."""
        dev = resolve_device(device)

        def leaf(s):
            if s.init == "neg_inf":
                return torch.full(s.shape, -math.inf, dtype=torch.float32,
                                  device=dev)
            return torch.zeros(s.shape, device=dev, dtype=(
                torch.float32 if s.init == "zeros_fp32" else dtype))

        return P.tree_map(leaf, self.cache_spec(batch, cap))

    def abstract_cache(self, batch: int, cap: int, mesh, rules,
                       dtype=torch.bfloat16):
        return P.abstract_params(self.cache_spec(batch, cap), mesh, rules,
                                 dtype)


def _ctx(mesh, rules):
    return T.ShardCtx(mesh, rules) if mesh is not None else T.NULL_CTX


def build_model(cfg: ModelConfig, *, ep: int = 1, tp: int = 1) -> Model:
    """`ep` pads the MoE experts to a multiple of it, `tp` the query heads
    per KV group (`layers.padded_heads`)."""
    return Model(cfg=cfg, spec=T.build_spec(cfg, ep=ep, tp=tp), ep=ep, tp=tp)


# ---------------------------------------------------------------------------
# Input specs per (arch, shape): `meta` stand-ins for the dry run
# ---------------------------------------------------------------------------
def input_specs(cfg: ModelConfig, shape_name: str, mesh=None, rules=None):
    """`meta` tensors of a cell's inputs, as the reference's
    `input_specs` gives ShapeDtypeStructs: {"inputs"[, "labels"]} for the
    train and prefill shapes (int32 tokens (B, S), or bf16 frames (B, S,
    D) for an embedding frontend), {"token", "cache", "pos"} for decode
    (one token against a bf16 cache of S + meta positions). Without a
    mesh the shapes are global; with `mesh` and `rules` each tensor is
    the block one mesh entry holds (`param.abstract_params`), the cache's
    "neg_inf" leaves included in bf16, as the reference's specs are."""
    shape = SHAPES[shape_name]
    B, S = shape.global_batch, shape.seq_len

    def struct(shp, dtype, axes):
        spec = P.Spec(tuple(shp), tuple(axes), "zeros")
        if mesh is None:
            return torch.empty(spec.shape, dtype=dtype, device="meta")
        return P.abstract_params(spec, mesh, rules, dtype)

    if shape.kind in ("train", "prefill"):
        if cfg.embedding_frontend:
            toks = struct((B, S, cfg.d_model), torch.bfloat16,
                          ("batch", None, None))
        else:
            toks = struct((B, S), torch.int32, ("batch", None))
        if shape.kind == "train":
            return {"inputs": toks,
                    "labels": struct((B, S), torch.int32, ("batch", None))}
        return {"inputs": toks}
    cap = S + cfg.meta_tokens
    model = build_model(cfg, ep=mesh.shape.get("model", 1) if mesh else 1)
    cache = (model.abstract_cache(B, cap, mesh, rules) if mesh is not None
             else P.tree_map(lambda s: torch.empty(
                 s.shape, dtype=torch.bfloat16, device="meta"),
                 model.cache_spec(B, cap)))
    return {"token": struct((B, 1), torch.int32, ("batch", None)),
            "cache": cache,
            "pos": torch.empty((), dtype=torch.int32, device="meta")}
