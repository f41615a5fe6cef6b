"""Dry run of every (arch, shape, mesh) cell on the production mesh, ported
from the JAX package's `launch/dryrun.py`, with no device:

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch olmo-1b \
        --shape train_4k --mesh single
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh single \
        --policy zero --out dryrun_results.json

The reference lowers and compiles each cell for a TPU mesh and reads
XLA's cost and memory analyses; it never executes. The port builds the
same mesh (`make_production_mesh` over `meta` devices), the same rules
(`lower_cell`'s policy logic line for line) and the same specs
(`input_specs`, `Model.abstract_params` / `abstract_cache`), and counts
on `meta` tensors, so it touches no device either. Where XLA supplied a
number, the port's own rule stands:

  * flops and bytes per device: the cell's step counted by
    `launch.roofline` (the head, i.e. the embedding, the final norm, the
    unembedding and, in a train step, the loss and its backward, counted
    on a model of no layers; plus each segment's count x one layer,
    `segment_layer_cost`), at the global shape, divided by the entries
    the rules spread the work over (the mesh axes that the batch, the
    sequence and the heads / MLP / experts rules name, or the seqpar
    sequence axis);
  * collective bytes per device: `roofline._layer_collectives`, a formula
    per kind from the rules, summed over the layers;
  * memory per device: the exact bytes of each entry's parameter block
    (fp32 masters for a train step; the serving dtype, fp32 under the
    "tp" policy and bf16 under "zero", for prefill and decode), AdamW's
    two fp32 moments and the fp32 gradients (train), the bf16 cache
    block (decode reads and donates it; prefill writes it), and the
    activations: a train step's bytes kept for the backward under the
    cell's remat (`roofline.saved_bytes`' rule, per layer x count plus
    the head, divided like the flops), an inference pass's largest
    layer's allocations (an upper bound of its peak). argument = the
    step's inputs, output = its results, alias = the donated state
    (train) or cache (decode), peak = argument + output + temp - alias,
    as the reference sums XLA's memory analysis;
  * the roofline: flops over the bf16 tensor-core peak, bytes over HBM,
    collective bytes over one NVLink direction, the constants of the
    port's H100 `DeviceSpec` (`launch/roofline.py`).

The reference's scan-body correction does not carry over: XLA counts a
scanned segment's body once and `corrected_cost` adds (count - 1) layers;
the port sums count x layer itself, and reports the step with each
segment's layer counted once as `base_cost_uncorrected`. The result's
keys are the reference's; `t_compile_s` is the seconds of the head's
count (there is nothing to compile).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback

import torch

from repro_torch.configs import (ARCH_IDS, MOE, SHAPES, SSM, TrainConfig,
                                 cell_is_runnable, get_config)
from repro_torch.distributed.sharding import mesh_rules
from repro_torch.launch import roofline as RL
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import param as P
from repro_torch.models.model import build_model, input_specs
from repro_torch.models.transformer import layer_plan

DEVICE = RL.DeviceSpec()
PEAK_FLOPS = DEVICE.peak_flops_bf16      # bf16 FLOP/s per card
HBM_BW = DEVICE.hbm_bw                   # bytes/s per card
LINK_BW = DEVICE.link_bw                 # bytes/s, one NVLink direction


def roofline(flops, hbm_bytes, coll_bytes):
    return {
        "compute_s": flops / PEAK_FLOPS,
        "memory_s": hbm_bytes / HBM_BW,
        "collective_s": coll_bytes / LINK_BW,
    }


def spread(mesh, rules, ssm_impl: str = "gspmd") -> int:
    """Entries a cell's work divides over: the distinct mesh axes named
    by the batch, seq, heads, mlp and experts rules (the model axis too
    for a seqpar mLSTM)."""
    axes = set()
    for name in ("batch", "seq", "heads", "mlp", "experts"):
        entry = rules.get(name)
        axes.update(entry if isinstance(entry, tuple) else
                    (() if entry is None else (entry,)))
    if ssm_impl == "seqpar":
        axes.add("model")
    return RL.ways(tuple(sorted(axes)), mesh) if axes else 1


def _bytes_of(tree) -> int:
    return int(sum(t.numel() * t.element_size() for t in P.tree_leaves(tree)))


def _head_cost(cfg, kind, batch, seq, remat, cd):
    """The step outside the layers, counted on a model of no layers at
    the global shape: (flops, bytes, saved bytes, created bytes)."""
    from repro_torch.train.train_step import make_loss_fn
    model = build_model(dataclasses.replace(cfg, num_layers=0))
    params = RL._meta(model.spec, cd)
    S = 1 if kind == "decode" else seq
    inputs = (torch.empty((batch, S, cfg.d_model), dtype=cd, device="meta")
              if cfg.embedding_frontend else
              torch.empty((batch, S), dtype=torch.int32, device="meta"))
    e = torch.empty((), dtype=cd).element_size()
    n = model.num_params()
    width = RL._matrix_width(cfg, model.spec)
    ids = 0 if cfg.embedding_frontend else batch * S
    tokens = batch * (S + (cfg.meta_tokens if kind != "decode" else 0))
    if kind == "train":
        loss_fn = make_loss_fn(model, TrainConfig(
            remat=remat, compute_dtype=str(cd).split(".")[-1]))
        leaves = [t.requires_grad_() for t in P.tree_leaves(params)]

        def forward():
            with torch.enable_grad():
                return loss_fn(params, {"inputs": inputs, "labels": inputs
                                        if not cfg.embedding_frontend else
                                        torch.empty((batch, S),
                                                    dtype=torch.int32,
                                                    device="meta")})[0]
        f1, saved, created, loss = RL._count(forward)
        f2, _, c2, _ = RL._count(lambda: torch.autograd.grad(
            loss, leaves, allow_unused=True))
        # the head runs outside the checkpointed layers: no recompute
        return (f1 + f2, RL.pass_bytes(n, width, tokens, kind, e, ids=ids),
                saved, created + c2)

    def infer():
        with torch.no_grad():
            if kind == "decode":
                return model.decode(params, inputs, {"segments": []},
                                    seq + cfg.meta_tokens - 1,
                                    compute_dtype=cd, kernel_impl="ref")
            if not cfg.causal:
                return model.apply(params, inputs, compute_dtype=cd,
                                   kernel_impl="ref")
            return model.prefill(params, inputs, seq + cfg.meta_tokens,
                                 compute_dtype=cd, kernel_impl="ref")
    flops, _, created, _ = RL._count(infer)
    return (flops, RL.pass_bytes(n, width, tokens, kind, e, ids=ids), 0,
            created)


def _zero_coll():
    return {k: 0.0 for k in RL.COLLECTIVES + ("total",)}


def step_cost(cfg, kind: str, batch: int, seq: int, *, mesh, rules,
              remat: str = "full", moe_impl: str = "dense",
              capacity_factor: float = 1.25, ssm_impl: str = "gspmd",
              ep: int = 1, tp: int = 1, compute_dtype=torch.bfloat16):
    """The whole step of a (kind, batch, seq) cell, counted at the
    global shape over `mesh`: {"flops", "bytes", "saved_bytes" (a train
    step's bytes kept for the backward), "temp_bytes" (an inference
    pass's largest layer's allocations), "coll" (per device), "base"
    (the step with each segment's layer counted once), "per_layer",
    "t_head_s"}."""
    t0 = time.time()
    head = _head_cost(cfg, kind, batch, seq, remat, compute_dtype)
    t_head = time.time() - t0
    per_layer, seen = [], {}
    flops, nbytes, saved, temp = head
    base = {"flops": head[0], "bytes": head[1], "coll": _zero_coll()}
    coll = _zero_coll()
    for seg in layer_plan(cfg):
        if seg not in seen:      # a repeated unit (xlstm) counts once
            seen[seg] = RL.segment_layer_cost(
                cfg, seg, mesh=mesh, rules=rules, batch=batch, seq=seq,
                kind=kind, moe_impl=moe_impl, remat=remat,
                capacity_factor=capacity_factor, ssm_impl=ssm_impl, ep=ep,
                tp=tp, compute_dtype=compute_dtype)
        lc = seen[seg]
        per_layer.append({"kind": seg.kind, "window": seg.window,
                          "count": seg.count, "flops": lc["flops"],
                          "bytes": lc["bytes"], "coll": lc["coll"],
                          "saved_bytes": lc["saved_bytes"]})
        flops += seg.count * lc["flops"]
        nbytes += seg.count * lc["bytes"]
        saved += seg.count * lc["saved_bytes"]
        base = {"flops": base["flops"] + lc["flops"],
                "bytes": base["bytes"] + lc["bytes"],
                "coll": {k: base["coll"][k] + lc["coll"][k] for k in coll}}
        coll = {k: coll[k] + seg.count * lc["coll"][k] for k in coll}
        temp = max(temp, lc["created_bytes"])
    return {"flops": flops, "bytes": nbytes, "saved_bytes": saved,
            "temp_bytes": temp, "coll": coll, "base": base,
            "per_layer": per_layer, "t_head_s": t_head}


def lower_cell(arch: str, shape_name: str, *, multi_pod: bool,
               remat: str = "full", moe_impl: str = None,
               capacity_factor: float = 1.25, fsdp: bool = True,
               extra_rules: dict = None, policy: str = "tp"):
    """Count one (arch, shape, mesh) cell. Returns the result dict.

    policy: "tp" (paper-faithful baseline) | "zero" (optimized; decode
    shapes fall back to tp: KV-cache sharding needs the model axis)."""
    cfg = get_config(arch)
    status = cell_is_runnable(cfg, shape_name)
    if status != "ok":
        return {"arch": arch, "shape": shape_name,
                "mesh": "multi" if multi_pod else "single",
                "status": status}

    t0 = time.time()
    shape = SHAPES[shape_name]
    orig_policy = policy
    if policy == "zero" and shape.kind == "decode":
        policy = "tp"   # KV-cache sharding needs the model axis
    n_dev = 512 if multi_pod else 256
    mesh = make_production_mesh(multi_pod=multi_pod,
                                devices=[torch.device("meta")] * n_dev)
    rules = mesh_rules(mesh, cfg, fsdp=fsdp, policy=policy)
    data_ways = mesh.shape.get("pod", 1) * mesh.shape["data"]
    if policy == "zero":
        # The model axis must carry real work. Pure DP (batch over every
        # axis) when the global batch divides the chip count. Otherwise:
        # SSM families get explicit sequence parallelism; attention
        # families fall back to the tp policy (the reference measured
        # GSPMD replicating q 16x for context parallelism).
        all_axes = tuple(a for a in ("pod", "data", "model")
                         if a in mesh.shape)
        n_chips = data_ways * mesh.shape["model"]
        if shape.global_batch % n_chips == 0:
            # vocab TP would reuse the model axis -> conflict; with one
            # sequence per device the full-vocab logits are small anyway
            rules = dict(rules, batch=all_axes, vocab=None)
        elif cfg.family == SSM:
            rules = dict(rules, seq="model")
            if shape.global_batch % data_ways != 0:
                rules = dict(rules, batch=None)
        else:
            policy = "tp"
            rules = mesh_rules(mesh, cfg, fsdp=fsdp, policy="tp")
    # single-stream decode cannot shard batch
    if shape.global_batch < data_ways:
        rules = dict(rules, batch=None)
    if shape.kind == "decode":
        rules = dict(rules, seq=None)   # S=1 at decode
    if extra_rules:
        rules = dict(rules, **extra_rules)
    if moe_impl is None:
        moe_impl = "ep" if cfg.family == MOE else "dense"
    # SSM-family sequence dims are split by the explicit sequence-
    # parallel mLSTM under the zero policy
    ssm_impl = ("seqpar" if policy == "zero" and cfg.family == SSM
                and rules.get("seq") == "model" else "gspmd")
    if ssm_impl == "seqpar":
        rules = dict(rules, seq=None)   # the seqpar block owns the seq axis

    ep = mesh.shape["model"]
    tp = mesh.shape["model"] if rules.get("heads") else 1
    model = build_model(cfg, ep=ep, tp=tp)
    specs = input_specs(cfg, shape_name, mesh, rules)
    cd = torch.bfloat16
    B, S = shape.global_batch, shape.seq_len
    t_lower = time.time() - t0

    t0 = time.time()
    cost = step_cost(cfg, shape.kind, B, S, mesh=mesh, rules=rules,
                     remat=remat, moe_impl=moe_impl,
                     capacity_factor=capacity_factor, ssm_impl=ssm_impl,
                     ep=ep, tp=tp, compute_dtype=cd)
    t_compile, t_layers = cost["t_head_s"], time.time() - t0 - \
        cost["t_head_s"]
    flops, nbytes, saved = cost["flops"], cost["bytes"], cost["saved_bytes"]
    coll, base, temp_infer = cost["coll"], cost["base"], cost["temp_bytes"]
    per_layer = cost["per_layer"]

    n_spread = spread(mesh, rules, ssm_impl)
    flops_dev = flops / n_spread
    bytes_dev = nbytes / n_spread
    base = {"flops": base["flops"] / n_spread,
            "bytes": base["bytes"] / n_spread, "coll": base["coll"]}

    inputs = _bytes_of({k: v for k, v in specs.items() if k != "cache"})
    if shape.kind == "train":
        params = _bytes_of(model.abstract_params(mesh, rules, torch.float32))
        state = 3 * params            # the fp32 masters and AdamW's mu, nu
        mem = {"argument_bytes": state + inputs, "output_bytes": state,
               "temp_bytes": int(saved / n_spread) + params,
               "alias_bytes": state}
    else:
        serve = torch.bfloat16 if orig_policy == "zero" else torch.float32
        params = _bytes_of(model.abstract_params(mesh, rules, serve))
        cache = (_bytes_of(specs["cache"]) if shape.kind == "decode" else
                 (_bytes_of(model.abstract_cache(
                     B, S + cfg.meta_tokens, mesh, rules))
                  if cfg.causal else 0))
        logits = 4 * -(-B // RL.ways(rules.get("batch"), mesh)) * \
            -(-cfg.vocab_size // RL.ways(rules.get("vocab"), mesh))
        if shape.kind == "decode":
            mem = {"argument_bytes": params + cache + inputs,
                   "output_bytes": cache + logits,
                   "temp_bytes": int(temp_infer / n_spread),
                   "alias_bytes": cache}
        else:
            mem = {"argument_bytes": params + inputs,
                   "output_bytes": cache + logits,
                   "temp_bytes": int(temp_infer / n_spread),
                   "alias_bytes": 0}
    mem["peak_estimate_bytes"] = (mem["argument_bytes"] + mem["output_bytes"]
                                  + mem["temp_bytes"] - mem["alias_bytes"])

    terms = roofline(flops_dev, bytes_dev, coll["total"])
    n_chips = n_dev
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        model_flops = 6 * n_active * B * S
    elif shape.kind == "prefill":
        model_flops = 2 * n_active * B * S
    else:
        model_flops = 2 * n_active * B
    model_flops_per_chip = model_flops / n_chips

    dominant = max(terms, key=terms.get)
    return {
        "arch": arch, "shape": shape_name,
        "mesh": "multi" if multi_pod else "single",
        "status": "ok",
        "moe_impl": moe_impl,
        "policy": orig_policy,
        "effective_policy": policy,
        "ssm_impl": ssm_impl,
        "remat": remat,
        "t_lower_s": round(t_lower, 1),
        "t_compile_s": round(t_compile, 1),
        "t_layer_costs_s": round(t_layers, 1),
        "flops_per_device": flops_dev,
        "bytes_per_device": bytes_dev,
        "collective_bytes_per_device": coll,
        "base_cost_uncorrected": base,
        "per_layer_costs": per_layer,
        "memory": mem,
        "roofline": terms,
        "dominant": dominant,
        "model_flops_per_chip": model_flops_per_chip,
        "useful_flops_ratio": (model_flops_per_chip / flops_dev)
        if flops_dev else 0.0,
        "step_time_bound_s": max(terms.values()),
        "roofline_fraction": (model_flops_per_chip / PEAK_FLOPS)
        / max(terms.values()) if max(terms.values()) > 0 else 0.0,
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="both")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--remat", default="full")
    ap.add_argument("--moe-impl", default=None)
    ap.add_argument("--capacity-factor", type=float, default=1.25)
    ap.add_argument("--no-fsdp", action="store_true")
    ap.add_argument("--policy", choices=["tp", "zero"], default="tp")
    ap.add_argument("--out", default="dryrun_results.json")
    args = ap.parse_args(argv)

    archs = ARCH_IDS if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = (["single", "multi"] if args.mesh == "both" else [args.mesh])

    results = []
    if os.path.exists(args.out):
        with open(args.out) as f:
            results = json.load(f)
    done = {(r["arch"], r["shape"], r["mesh"]) for r in results
            if r.get("status", "").startswith(("ok", "skip"))}

    for arch in archs:
        for shape in shapes:
            for m in meshes:
                if (arch, shape, m) in done:
                    continue
                print(f"=== {arch} x {shape} x {m} ===", flush=True)
                try:
                    r = lower_cell(arch, shape, multi_pod=(m == "multi"),
                                   remat=args.remat, moe_impl=args.moe_impl,
                                   capacity_factor=args.capacity_factor,
                                   fsdp=not args.no_fsdp,
                                   policy=args.policy)
                except Exception as e:
                    traceback.print_exc()
                    r = {"arch": arch, "shape": shape, "mesh": m,
                         "status": f"error: {type(e).__name__}: "
                                   f"{str(e)[:300]}"}
                results.append(r)
                with open(args.out, "w") as f:
                    json.dump(results, f, indent=1)
                if r["status"] == "ok":
                    print(f"  count={r['t_compile_s'] + r['t_layer_costs_s']:.1f}s "
                          f"flops/dev={r['flops_per_device']:.3e} "
                          f"dominant={r['dominant']} "
                          f"roofline_frac={r['roofline_fraction']:.3f}",
                          flush=True)
                else:
                    print(f"  {r['status']}", flush=True)
    return results


if __name__ == "__main__":
    main()
