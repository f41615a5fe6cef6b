"""Fleet scheduling cost model (docs/scheduling.md), ported from the
fleet half of the JAX package's `launch/roofline.py`:

  * `CostTable` — FLOP / byte costs per (model-config, batch, seq, kind,
    precision), cached, converted to modeled device-seconds on a
    `DeviceSpec` roofline;
  * `WindowBudget` — one retraining window's metered budget ledger;
  * `RooflineMeter` — the controller/allocator-facing meter that prices
    duck-typed retraining jobs (train micro-windows, eval passes,
    serve-plane queries) against one fleet-wide budget.

The device is an NVIDIA H100 SXM by default, at the peaks the kernel
table of PERF.md divides by: bf16 989 TFLOP/s on the tensor cores, fp32
67 TFLOP/s on the CUDA cores (the port runs fp32 GEMMs with TF32 off),
3.35 TB/s of HBM.

Where the reference reads XLA's `compiled.cost_analysis()`, the port
counts for itself, with no device work, so that the table gives the same
numbers on the CPU and on the card:

  * FLOPs: the pass runs on the `meta` device through the port's PLAIN
    route (`kernel_impl="autograd"` for `train`, "ref" for the rest) —
    the hand-written kernels are never launched by a count — while
    `torch.utils.flop_counter.FlopCounterMode` counts the matrix
    products (2 M N K each) and `_ArithmeticCounter` the rest of the
    arithmetic: one FLOP per output element of a pointwise op (a fused
    one, the tanh GELU, the operations of its formula), per input
    element of a reduction, and per element of a dtype cast, which is
    how XLA's cost analysis counts elementwise work; copies count none.
  * Bytes, from the shapes (`pass_bytes`; P parameters, T = batch x
    tokens, e the compute dtype's element size, A = the sum over the
    model's matrices of fan-in + fan-out per token, `_matrix_width`, C
    the cache's bytes at its own dtypes):
        eval     4P [+ 2P + 2P at bf16: the cast's write, the pass's read]
                 + e A T + 4T (token ids)
        prefill  eval at T = batch x (seq + meta tokens), + C
        train    eval + the backward's weight read (4P, or 2P at bf16)
                 + the fp32 gradients' write 4P + 2 e A T (the saved
                 activations read back, their gradients written)
        decode   4P [+ 4P at bf16] + C + e A batch + 4 batch

`segment_layer_cost` counts one layer of a segment with the same
counter, width rule and bytes formula (its parameters already in the
compute dtype, cast once before the layers), for the dry run's
per-layer list (`launch/dryrun.py`): forward for a prefill,
forward + backward under the cell's remat for a train step, one decode
step over a cache slice, with the seqpar mLSTM and the expert-parallel
MoE run over the cell's mesh, whose entries all stand on `meta`. The
reference's `corrected_cost` adds (count - 1) layers to XLA's count of a
scanned model, whose loop bodies XLA counts once; eager PyTorch has no
such body to correct, so the dry run sums count x layer itself.
"""
from __future__ import annotations

import dataclasses
import functools
import gc
import math
from typing import Dict, Optional

import torch
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode, flop_registry

from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.models import param as P

PRECISIONS = ("fp32", "bf16")

_PRECISION_DTYPE = {"fp32": torch.float32, "bf16": torch.bfloat16}

KINDS = ("train", "eval", "prefill", "decode")


def precision_dtype(precision: str) -> torch.dtype:
    """torch dtype for a job precision policy string."""
    try:
        return _PRECISION_DTYPE[precision]
    except KeyError:
        raise ValueError(
            f"unknown precision {precision!r}; known: {PRECISIONS}")


@dataclasses.dataclass(frozen=True)
class Cost:
    """FLOP / byte cost of one pass (one train step, one eval forward,
    one prefill, or one decode step)."""
    flops: float
    bytes: float

    def scaled(self, k: float) -> "Cost":
        return Cost(self.flops * k, self.bytes * k)


@dataclasses.dataclass(frozen=True)
class DeviceSpec:
    """Per-precision roofline of one accelerator: an NVIDIA H100 SXM by
    default (dense bf16 on the tensor cores, fp32 on the CUDA cores). fp32
    runs at a fifteenth of the bf16 peak, which is what makes a bf16
    precision policy cheaper in the meter, not just a label."""
    name: str = "h100_sxm"
    peak_flops_bf16: float = 989e12
    peak_flops_fp32: float = 67e12
    hbm_bw: float = 3.35e12
    # NVLink 4 on the H100 SXM: 900 GB/s per GPU, both directions together
    # (NVIDIA H100 Tensor Core GPU datasheet); 450 GB/s each way
    link_bw: float = 450e9

    def peak(self, precision: str) -> float:
        precision_dtype(precision)      # validate
        return (self.peak_flops_bf16 if precision == "bf16"
                else self.peak_flops_fp32)

    def seconds(self, cost: Cost, precision: str = "fp32") -> float:
        """Modeled device-seconds: max of the compute and HBM terms."""
        return max(cost.flops / self.peak(precision),
                   cost.bytes / self.hbm_bw)


# operations per element of the fused pointwise ops the models run, as
# their formulas do them (the tanh GELU: x^3 2, x kappa 1, + x 1, x beta
# 1, tanh 1, + 1 1, x x 1, x 0.5 1; its backward, aten's formula: 18)
FUSED_POINTWISE = {(torch.ops.aten.gelu, "tanh"): 9,
                   (torch.ops.aten.gelu_backward, "tanh"): 18}


class _ArithmeticCounter(TorchDispatchMode):
    """Counts the arithmetic that `FlopCounterMode` leaves out: one FLOP
    per output element of a pointwise op, per input element of a
    reduction, and per element of a dtype cast. Ops that
    `FlopCounterMode` prices (the matrix products) are skipped, and so
    are copies and views, which move data without arithmetic (`clone`
    among them, which aten tags pointwise). A fused pointwise op counts
    the operations of its formula (`FUSED_POINTWISE`)."""

    def __init__(self):
        super().__init__()
        self.flops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        packet = func._overloadpacket
        if packet in flop_registry or packet is torch.ops.aten.clone:
            return out
        if torch.Tag.pointwise in func.tags:
            first = out[0] if isinstance(out, (tuple, list)) else out
            if isinstance(first, torch.Tensor):
                self.flops += first.numel() * FUSED_POINTWISE.get(
                    (packet, kwargs.get("approximate", "none")), 1)
        elif torch.Tag.reduction in func.tags:
            if args and isinstance(args[0], torch.Tensor):
                self.flops += args[0].numel()
        elif packet is torch.ops.aten._to_copy:
            src = args[0]
            if kwargs.get("dtype", src.dtype) != src.dtype:
                self.flops += src.numel()
        return out


class _LiveStorage(TorchDispatchMode):
    """Weak references to every storage an op creates while the mode is
    on, with its bytes: `alive()` sums those still referenced, `created`
    all of them."""

    def __init__(self):
        super().__init__()
        self.refs = {}
        self.created = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_flatten(out)[0]:
            if isinstance(t, torch.Tensor):
                st = t.untyped_storage()
                ref = StorageWeakRef(st)
                if ref.cdata not in self.refs:
                    self.refs[ref.cdata] = (ref, st.nbytes())
                    self.created += st.nbytes()
        return out

    def alive(self) -> int:
        gc.collect()
        return sum(n for ref, n in self.refs.values() if not ref.expired())


def saved_bytes(fn, *args, **kwargs):
    """(fn(*args, **kwargs), bytes): the bytes of the storages created
    inside `fn` that are still alive when it returns. Run with grad on
    over a forward that returns its loss, these are what the autograd
    graph keeps for the backward, under any remat: the activations saved
    outside checkpointed regions, each checkpointed region's inputs, and
    the matrix products a selective policy keeps. (A
    `torch.autograd.graph.saved_tensors_hooks` pair outside a
    checkpointed region never sees the tensors saved inside it, so the
    count follows storages instead.) Works on `meta` tensors."""
    mode = _LiveStorage()
    with mode:
        out = fn(*args, **kwargs)
    return out, mode.alive()


def _count(fn):
    """(FLOPs, storages' bytes alive after, bytes created, fn's value) of
    fn() (the dry run's tensors are `meta`; any device's are counted
    alike): the matrix products (`FlopCounterMode`) and the rest of the
    arithmetic (`_ArithmeticCounter`)."""
    products = FlopCounterMode(display=False)
    rest = _ArithmeticCounter()
    live = _LiveStorage()
    with products, rest, live:
        out = fn()
    return (float(products.get_total_flops() + rest.flops), live.alive(),
            live.created, out)


def _meta(tree, dtype):
    """Empty `meta` tensors in the shape of a spec tree: "neg_inf" leaves
    (the xLSTM stabilisers) fp32, the rest `dtype`."""
    if isinstance(tree, dict):
        return {k: _meta(v, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_meta(v, dtype) for v in tree]
    dt = torch.float32 if tree.init == "neg_inf" else dtype
    return torch.empty(tree.shape, dtype=dt, device="meta")


def _spec_leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _spec_leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _spec_leaves(v)
    else:
        yield tree


def _matrix_width(cfg: ModelConfig, spec) -> float:
    """A: the sum over the matrices of `spec` (a model's or one layer's)
    of fan-in + fan-out, per token. A matrix is a leaf of two or more
    dims once a segment's leading layer axis is dropped (the leaf then
    counts once per layer); d_model is one side where a first or last
    dim is d_model (the attention projections' heads and head dims form
    the other), else the first dim against the rest; a leaf with a
    leading experts axis counts top_k of its experts."""
    width = 0.0
    for name, sub in spec.items():
        for leaf in _spec_leaves(sub):
            shape, axes, layers = leaf.shape, leaf.axes, 1
            if name == "segments":
                layers, shape, axes = shape[0], shape[1:], axes[1:]
            share = 1.0
            if axes[:1] == ("experts",):
                shape, share = shape[1:], cfg.moe.top_k / shape[0]
            if len(shape) < 2:
                continue
            side = cfg.d_model if cfg.d_model in (shape[0], shape[-1]) \
                else shape[0]
            width += layers * share * (side + math.prod(shape) // side)
    return width


def _tree_bytes(spec) -> int:
    """Bytes of a cache spec tree at the pool's dtypes: bf16 leaves but
    the fp32 "neg_inf" stabilisers."""
    return sum(math.prod(s.shape) * (4 if s.init == "neg_inf" else 2)
               for s in _spec_leaves(spec))


class CostTable:
    """Cached costs per (model-config, batch, seq, precision, kind in
    {train, eval, prefill, decode}); see the module docstring for how
    FLOPs are counted and bytes reckoned.

    Each key is counted once, on the `meta` device; every later lookup
    is a dict hit, so metering a window adds no device work. "eval" is a
    full forward with logits (the SharedEngine accuracy pass); "train" is
    one optimizer-free forward + backward through the loss the training
    plane uses; "prefill" and "decode" run against a bf16 cache of
    seq + meta tokens, as in the reference.
    """

    def __init__(self, device: Optional[DeviceSpec] = None):
        self.device = device or DeviceSpec()
        self._cache: Dict[tuple, Cost] = {}
        self._models: Dict[ModelConfig, object] = {}

    def _model(self, cfg: ModelConfig):
        m = self._models.get(cfg)
        if m is None:
            from repro_torch.models.model import build_model
            m = build_model(cfg)
            self._models[cfg] = m
        return m

    def _run(self, model, batch: int, seq: int, kind: str, cd):
        """One `kind` pass on meta tensors, through the plain route."""
        cfg = model.cfg
        params = _meta(model.spec, torch.float32)    # master rows
        toks = torch.empty((batch, seq), dtype=torch.int32, device="meta")
        # an embedding frontend (hubert) takes frame embeddings for tokens
        inputs = (torch.empty((batch, seq, cfg.d_model), dtype=cd,
                              device="meta")
                  if cfg.embedding_frontend else toks)
        if kind == "train":
            from repro_torch.train.train_step import (grad_and_value,
                                                      make_loss_fn)
            tcfg = TrainConfig(remat="none",
                               compute_dtype=str(cd).split(".")[-1])
            grad_and_value(make_loss_fn(model, tcfg))(
                params, {"inputs": inputs, "labels": toks})
            return
        with torch.no_grad():
            if kind == "eval":
                model.apply(params, inputs, compute_dtype=cd,
                            kernel_impl="ref")
            elif kind == "prefill":
                model.prefill(params, inputs, seq + cfg.meta_tokens,
                              compute_dtype=cd, kernel_impl="ref")
            else:
                cap = seq + cfg.meta_tokens
                cache = _meta(model.cache_spec(batch, cap), torch.bfloat16)
                tok = torch.empty((batch, 1), dtype=torch.int32,
                                  device="meta")
                model.decode(params, tok, cache, cap - 1, compute_dtype=cd,
                             kernel_impl="ref")

    def _flops(self, model, batch: int, seq: int, kind: str, cd) -> float:
        return _count(lambda: self._run(model, batch, seq, kind, cd))[0]

    def _bytes(self, model, batch: int, seq: int, kind: str, cd) -> float:
        cfg = model.cfg
        e = torch.empty((), dtype=cd).element_size()
        cap = seq + cfg.meta_tokens
        tokens = batch * (1 if kind == "decode" else
                          cap if kind == "prefill" else seq)
        cache = (_tree_bytes(model.cache_spec(batch, cap))
                 if kind in ("prefill", "decode") else 0)
        return pass_bytes(model.num_params(), _matrix_width(cfg, model.spec),
                          tokens, kind, e, masters=True, cache=cache,
                          ids=batch if kind == "decode" else tokens)

    # -- public API ---------------------------------------------------------
    def cost(self, cfg: ModelConfig, *, batch: int, seq: int, kind: str,
             precision: str = "fp32") -> Cost:
        """FLOP / byte cost of one `kind` pass."""
        key = (cfg, int(batch), int(seq), kind, precision)
        hit = self._cache.get(key)
        if hit is not None:
            return hit
        if kind not in KINDS:
            raise ValueError(
                f"unknown kind {kind!r}; expected train/eval/prefill/decode")
        cd = precision_dtype(precision)
        model = self._model(cfg)
        out = Cost(flops=self._flops(model, int(batch), int(seq), kind, cd),
                   bytes=self._bytes(model, int(batch), int(seq), kind, cd))
        self._cache[key] = out
        return out

    def seconds(self, cfg: ModelConfig, *, batch: int, seq: int, kind: str,
                precision: str = "fp32") -> float:
        """Modeled device-seconds of one `kind` pass on the roofline."""
        return self.device.seconds(
            self.cost(cfg, batch=batch, seq=seq, kind=kind,
                      precision=precision), precision)


# ---------------------------------------------------------------------------
# Per-layer costs (the dry run's accounting)
# ---------------------------------------------------------------------------
COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")


def ways(entry, mesh) -> int:
    """Entries a pspec entry (None, an axis or a tuple of axes) spans."""
    if entry is None:
        return 1
    names = entry if isinstance(entry, tuple) else (entry,)
    return math.prod(int(mesh.shape[a]) for a in names)


def _tree_numel(spec) -> int:
    return sum(math.prod(s.shape) for s in _spec_leaves(spec))


def _layer_collectives(cfg: ModelConfig, kind_seg: str, lspec, *, mesh,
                       rules, batch: int, seq: int, kind: str,
                       moe_impl: str, ssm_impl: str, remat: str, e: int,
                       capacity_factor: float) -> Dict[str, float]:
    """Per-device wire bytes of one layer's collectives, by kind, from
    the rules (all-reduce counted at twice its result bytes, the
    reference's ring convention). Activation collectives run once per
    forward and once more in a train step's backward (twice more under
    remat "full", whose recompute repeats them):
      * all-reduce: tensor parallelism, one (T, D) partial sum per
        sharded output projection (attention's and the MLP's in a block,
        the out projection of an xLSTM block); a train step's data-
        parallel gradient all-reduce (fp32) of the leaves FSDP does not
        shard;
      * all-gather: FSDP, each entry gathering the other f - 1 blocks of
        the leaves FSDP shards (in the compute dtype, cast once before
        the layers as the reference does), once a forward and again in
        the backward; the seqpar mLSTM's state summaries (fp32), each
        entry receiving the other M - 1;
      * reduce-scatter: FSDP, a train step's fp32 gradients of those
        leaves;
      * all-to-all: expert parallelism, the (E, C, D) buffer out and back,
        (M - 1) / M of it leaving the entry;
      * collective-permute: the seqpar halo, W - 1 rows of the left
        neighbour's conv input.
    T is the tokens one entry holds: batch and sequence split over the
    axes the rules give them (decode: one token a sequence)."""
    out = {k: 0.0 for k in COLLECTIVES}
    tokens_seq = 1 if kind == "decode" else seq
    b_dev = -(-batch // ways(rules.get("batch"), mesh))
    seqpar = kind_seg == "mlstm" and ssm_impl == "seqpar" and kind != "decode"
    seq_ways = (ways("model", mesh) if seqpar
                else ways(rules.get("seq"), mesh) if kind != "decode" else 1)
    t_dev = b_dev * -(-tokens_seq // seq_ways)
    D = cfg.d_model
    passes = 1 if kind != "train" else (3 if remat == "full" else 2)
    tp = ways(rules.get("heads"), mesh) if kind_seg == "block" else \
        ways(rules.get("mlp"), mesh)
    moe_ep = kind_seg == "block" and cfg.moe is not None and \
        moe_impl == "ep" and ways("model", mesh) > 1
    if tp > 1:
        sharded = (2 if kind_seg == "block" and not moe_ep else 1)
        out["all-reduce"] += passes * sharded * 2.0 * t_dev * D * e
    fsdp = rules.get("fsdp")
    f = ways(fsdp, mesh)
    fsdp_axes = set(fsdp if isinstance(fsdp, tuple) else (fsdp,)) - {None}
    gathered = replicated = 0
    for leaf in _spec_leaves(lspec):
        n = math.prod(P._block_shape(leaf, mesh, rules))
        named = set()
        for entry in P.logical_to_pspec(leaf.axes, rules):
            named.update(entry if isinstance(entry, tuple) else (entry,))
        if fsdp_axes & named:
            gathered += n
        else:
            replicated += n
    if f > 1:
        gathers = 2 if kind == "train" else 1
        out["all-gather"] += gathers * (f - 1) * gathered * e
        if kind == "train":
            out["reduce-scatter"] += (f - 1) * gathered * 4.0
    if kind == "train" and ways(rules.get("batch"), mesh) > 1:
        # the gradients of the leaves FSDP does not shard, over the data
        out["all-reduce"] += 2.0 * (replicated + (0 if f > 1 else gathered)
                                    ) * 4.0
    if moe_ep:
        M = ways("model", mesh)
        E = lspec["moe"]["wg"].shape[0]
        t_entry = max(1, t_dev // M)
        C = max(1, int(t_entry * cfg.moe.top_k / E * capacity_factor))
        out["all-to-all"] += passes * 2.0 * (M - 1) / M * E * C * D * e
    if seqpar:
        from repro_torch.models import xlstm as xlstm_lib
        M = ways("model", mesh)
        di, H, Ph = xlstm_lib.mlstm_heads(cfg)
        summary = 4.0 * b_dev * H * (Ph * Ph + Ph + 2)
        grads = 2 if kind == "train" else 1
        out["all-gather"] += grads * (M - 1) * summary
        out["collective-permute"] += grads * b_dev * \
            (cfg.ssm.conv_width - 1) * di * e
    out["total"] = float(sum(out[k] for k in COLLECTIVES))
    return out


def pass_bytes(n_params: int, width: float, tokens: int, kind: str,
               e: int, *, masters: bool = False, remat: str = "none",
               cache: int = 0, ids: int = 0) -> float:
    """Bytes one pass moves at the compute dtype's element size e (the
    module docstring's formula): the parameters read, e P, or with
    `masters` the fp32 masters, 4P, plus at e < 4 the cast's write and
    the pass's read, 2 e P; the matrices' inputs and outputs, e A T; a
    train step adds the backward's parameter read, the fp32 gradients'
    write and 2 e A T, and remat "full" a second forward (e P + e A T);
    the cache read (decode) or written (prefill); 4 bytes per token id
    read."""
    weights = (4 + (2 * e if e < 4 else 0)) * n_params if masters \
        else e * n_params
    total = weights + e * width * tokens + cache + 4 * ids
    if kind == "train":
        total += e * n_params + 4 * n_params + 2 * e * width * tokens
        if remat == "full":
            total += e * n_params + e * width * tokens
    return float(total)


def layer_cache_spec(cfg: ModelConfig, seg, batch: int, cap: int):
    """The spec tree of one layer's decode cache in the first segment of
    `cfg`'s plan equal to `seg` (the segment's stacked cache, its layers
    axis dropped)."""
    from repro_torch.models import transformer as T
    i = T.layer_plan(cfg).index(seg)
    return P.tree_map(lambda s: P.Spec(s.shape[1:], s.axes[1:], s.init,
                                       s.scale),
                      T.cache_spec(cfg, batch, cap)["segments"][i])


def segment_layer_cost(cfg: ModelConfig, seg, *, mesh, rules, batch: int,
                       seq: int, kind: str, moe_impl: str = "dense",
                       remat: str = "none", capacity_factor: float = 1.25,
                       ssm_impl: str = "gspmd", ep: int = 1, tp: int = 1,
                       compute_dtype=torch.bfloat16) -> Dict[str, object]:
    """Count one layer of `seg` (a `transformer.Segment`) on `meta`
    tensors at the global (batch, seq), parameters and activations in
    `compute_dtype`: "train" is the forward and backward through
    `transformer._remat_wrap(remat)` (vjp with a cotangent the shape of
    the output, the train route's plain forms), "prefill" the forward
    (plain route), "decode" one token against one layer's slice of the
    bf16 cache at position seq + meta - 1. The seqpar mLSTM and the
    expert-parallel MoE run over `mesh`'s entries (its devices `meta`),
    so the count is the whole mesh's work. Returns {"flops", "bytes"
    (`pass_bytes`), "coll" (per device, `_layer_collectives`),
    "saved_bytes" (train: what the graph keeps for the backward between
    the passes; else 0), "created_bytes" (every storage the pass made)}.
    """
    from repro_torch.models import transformer as T
    cd = compute_dtype
    lspec = T._segment_spec(cfg, seg.kind, ep, tp)
    S_tot = seq + (cfg.meta_tokens if seg.kind == "block" else 0)
    e = torch.empty((), dtype=cd).element_size()
    n_params = _tree_numel(lspec)
    width = _matrix_width(cfg, lspec)
    coll = _layer_collectives(cfg, seg.kind, lspec, mesh=mesh, rules=rules,
                              batch=batch, seq=S_tot, kind=kind,
                              moe_impl=moe_impl, ssm_impl=ssm_impl,
                              remat=remat, e=e,
                              capacity_factor=capacity_factor)
    ctx = T.ShardCtx(mesh, rules)
    if kind == "decode":
        cspec = layer_cache_spec(cfg, seg, batch, S_tot)
        cache = _meta(cspec, torch.bfloat16)
        lp = _meta(lspec, cd)
        x1 = torch.empty((batch, 1, cfg.d_model), dtype=cd, device="meta")

        def dec():
            with torch.no_grad():
                if seg.kind == "block":
                    return T._block_decode(
                        cfg, lp, x1, cache, S_tot - 1, window=seg.window,
                        kernel_impl="ref", capacity_factor=capacity_factor,
                        moe_impl=moe_impl, mesh=mesh)
                from repro_torch.models import xlstm as xlstm_lib
                if seg.kind == "mlstm":
                    return xlstm_lib.apply_mlstm_block(cfg, lp, x1,
                                                       cache=cache)
                return xlstm_lib.apply_slstm_block(cfg, lp, x1, cache=cache)
        flops, _, created, _ = _count(dec)
        return {"flops": flops,
                "bytes": pass_bytes(n_params, width, batch, kind, e,
                                    cache=_tree_bytes(cspec)),
                "coll": coll, "saved_bytes": 0, "created_bytes": created}

    train = kind == "train"
    body = functools.partial(
        T._layer_forward, cfg, seg, collect_cache=False,
        kernel_impl="autograd",
        capacity_factor=capacity_factor, moe_impl=moe_impl, mesh=mesh,
        ssm_impl=ssm_impl, ctx=ctx)
    f = T._remat_wrap(body, remat) if train else body

    def count(s_tot):
        positions = torch.empty((batch, s_tot), dtype=torch.int64,
                                device="meta")
        x = torch.empty((batch, s_tot, cfg.d_model), dtype=cd, device="meta")
        lp = _meta(lspec, cd)
        if not train:
            def fwd():
                with torch.no_grad():
                    return f(lp, x, positions=positions)[0]
            flops, _, created, _ = _count(fwd)
            return flops, 0, created
        leaves = [t.requires_grad_() for t in P.tree_leaves(lp)]
        xg = x.requires_grad_()

        def forward():
            with torch.enable_grad():
                return f(lp, xg, positions=positions)[0]
        fwd_flops, saved, created, y = _count(forward)
        bwd_flops, _, bwd_created, _ = _count(lambda: torch.autograd.grad(
            y, leaves + [xg], torch.empty_like(y), allow_unused=True))
        return fwd_flops + bwd_flops, saved, created + bwd_created

    points = _fit_points(seg)
    if points and S_tot > points[-1]:
        # the sLSTM's steps: its count evaluated exactly from three short
        # sequences
        flops, saved, created = (_extrapolate(points, ys, S_tot) for ys in
                                 zip(*(count(p) for p in points)))
    else:
        flops, saved, created = count(S_tot)
    return {"flops": flops,
            "bytes": pass_bytes(n_params, width, batch * S_tot, kind, e,
                                remat=remat if train else "none"),
            "coll": coll, "saved_bytes": saved, "created_bytes": created}


def _fit_points(seg):
    """The sequence lengths an sLSTM block's layer is counted at: its
    plain form loops over the steps in Python, so a long sequence would
    take minutes on `meta`. Its count is a polynomial of degree 2 in the
    length (the train backward's sums over the steps grow with them), so
    three points give it exactly. None for the rest, whose plain forms
    loop over chunks at most and are counted at their own length."""
    return (64, 128, 192) if seg.kind == "slstm" else ()


def _extrapolate(xs, ys, x) -> float:
    """The polynomial through (xs, ys) (Lagrange form) at x."""
    total = 0.0
    for i, (xi, yi) in enumerate(zip(xs, ys)):
        w = 1.0
        for j, xj in enumerate(xs):
            if j != i:
                w *= (x - xj) / (xi - xj)
        total += w * yi
    return float(total)


@dataclasses.dataclass
class WindowBudget:
    """One retraining window's metered budget ledger (modeled
    device-seconds). Charges are tagged by kind so the window report
    shows where the budget went (train vs eval vs serve)."""
    total: float
    spent: float = 0.0
    by_kind: Dict[str, float] = dataclasses.field(default_factory=dict)

    @property
    def remaining(self) -> float:
        return self.total - self.spent

    def can_afford(self, seconds: float) -> bool:
        return self.spent + seconds <= self.total * (1 + 1e-9)

    def charge(self, seconds: float, kind: str = "train"):
        self.spent += seconds
        self.by_kind[kind] = self.by_kind.get(kind, 0.0) + seconds

    def report(self) -> Dict:
        return {"total": self.total, "spent": self.spent,
                "remaining": self.remaining, "by_kind": dict(self.by_kind)}


class RooflineMeter:
    """Prices duck-typed retraining jobs against one window budget.

    A job is priced from its own engine's ModelConfig, its own batch /
    micro_steps, and its own precision policy (`job.precision`, default
    fp32): a heterogeneous fleet meters heterogeneously, which is what
    lets Alg. 1's gain/cost objective prefer a smaller backbone or a
    cheaper precision under budget pressure. Jobs without a real engine
    (scripted test fakes) fall back to `fallback_cost` seconds per
    micro-window so the allocator stays duck-typed.
    """

    def __init__(self, table: CostTable, budget_seconds: float, *,
                 seq_len: int = 32, eval_batch: int = 16,
                 fallback_cost: float = 1.0):
        self.table = table
        self.budget = WindowBudget(total=float(budget_seconds))
        self.seq_len = int(seq_len)
        self.eval_batch = int(eval_batch)
        self.fallback_cost = float(fallback_cost)

    # -- job pricing --------------------------------------------------------
    @staticmethod
    def job_precision(job) -> str:
        return getattr(job, "precision", "fp32") or "fp32"

    def _job_cfg(self, job) -> Optional[ModelConfig]:
        cfg = getattr(getattr(job, "engine", None), "cfg", None)
        return cfg if isinstance(cfg, ModelConfig) else None

    def train_cost(self, job) -> float:
        """One micro-window: `micro_steps` train steps at the job's train
        batch, engine config, and precision."""
        cfg = self._job_cfg(job)
        if cfg is None:
            return self.fallback_cost
        steps = int(getattr(job, "micro_steps", 1) or 1)
        return steps * self.table.seconds(
            cfg, batch=int(getattr(job, "batch", 8) or 8),
            seq=self.seq_len, kind="train",
            precision=self.job_precision(job))

    def eval_cost(self, job) -> float:
        """One allocator eval(): one accuracy pass per member at the
        controller eval batch."""
        cfg = self._job_cfg(job)
        if cfg is None:
            return 0.0
        members = max(1, int(getattr(job, "num_members", 1) or 1))
        return members * self.table.seconds(
            cfg, batch=self.eval_batch, seq=self.seq_len, kind="eval",
            precision=self.job_precision(job))

    def micro_cost(self, job) -> float:
        """One allocator micro-window: eval before, train, eval after
        (the measured AccGain bracket of Alg. 1)."""
        return self.train_cost(job) + 2 * self.eval_cost(job)

    def serve_cost(self, cfg: ModelConfig, *, queries: int,
                   prompt_len: int, gen_tokens: int,
                   batch: int = 1) -> float:
        """Serve-plane pricing: one prefill per query plus `gen_tokens`
        decode steps (gate evals are charged separately as evals)."""
        if queries <= 0:
            return 0.0
        pre = self.table.seconds(cfg, batch=batch, seq=prompt_len,
                                 kind="prefill", precision="fp32")
        dec = self.table.seconds(cfg, batch=batch, seq=prompt_len,
                                 kind="decode", precision="fp32")
        return queries * (pre + max(0, gen_tokens) * dec)

    # -- ledger passthrough -------------------------------------------------
    def can_afford(self, seconds: float) -> bool:
        return self.budget.can_afford(seconds)

    def charge(self, seconds: float, kind: str = "train"):
        self.budget.charge(seconds, kind)

    def report(self) -> Dict:
        return self.budget.report()
