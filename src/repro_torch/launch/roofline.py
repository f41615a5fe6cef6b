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
    arithmetic: one FLOP per output element of a pointwise op, per input
    element of a reduction, and per element of a dtype cast, which is
    how XLA's cost analysis counts elementwise work.
  * Bytes, from the shapes (P parameters, T = batch x tokens, e the
    compute dtype's element size, A = the sum over the model's matrices
    of fan-in + fan-out per token, C the cache's bytes at its own
    dtypes):
        eval     4P [+ 2P + 2P at bf16: the cast's write, the pass's read]
                 + e A T + 4T (token ids)
        prefill  eval at T = batch x (seq + meta tokens), + C
        train    eval + the backward's weight read (4P, or 2P at bf16)
                 + the fp32 gradients' write 4P + 2 e A T (the saved
                 activations read back, their gradients written)
        decode   4P [+ 4P at bf16] + C + e A batch + 4 batch

Not carried: `segment_layer_cost` / `corrected_cost`, the reference's
correction of XLA's once-counted scan bodies. The port's eager passes
run every layer, so the count sees them all. The dry run's per-cell
accounting (`launch/dryrun.py` in the reference) waits for ROADMAP.md
queue 1 item 10.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode, flop_registry

from repro_torch.configs.base import ModelConfig, TrainConfig

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

    def peak(self, precision: str) -> float:
        precision_dtype(precision)      # validate
        return (self.peak_flops_bf16 if precision == "bf16"
                else self.peak_flops_fp32)

    def seconds(self, cost: Cost, precision: str = "fp32") -> float:
        """Modeled device-seconds: max of the compute and HBM terms."""
        return max(cost.flops / self.peak(precision),
                   cost.bytes / self.hbm_bw)


class _ArithmeticCounter(TorchDispatchMode):
    """Counts the arithmetic that `FlopCounterMode` leaves out: one FLOP
    per output element of a pointwise op, per input element of a
    reduction, and per element of a dtype cast. Ops that
    `FlopCounterMode` prices (the matrix products) are skipped, and so
    are copies and views, which move data without arithmetic."""

    def __init__(self):
        super().__init__()
        self.flops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        packet = func._overloadpacket
        if packet in flop_registry:
            return out
        if torch.Tag.pointwise in func.tags:
            first = out[0] if isinstance(out, (tuple, list)) else out
            if isinstance(first, torch.Tensor):
                self.flops += first.numel()
        elif torch.Tag.reduction in func.tags:
            if args and isinstance(args[0], torch.Tensor):
                self.flops += args[0].numel()
        elif packet is torch.ops.aten._to_copy:
            src = args[0]
            if kwargs.get("dtype", src.dtype) != src.dtype:
                self.flops += src.numel()
        return out


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


def _matrix_width(spec) -> int:
    """A: the sum over the model's matrices of fan-in + fan-out, per
    token. Segment leaves carry a leading layer axis; a matrix is a leaf
    with two or more dims beyond it (fan-in its first, fan-out the
    product of the rest)."""
    width = 0
    for name, sub in spec.items():
        if name == "segments":
            for leaf in _spec_leaves(sub):
                if len(leaf.shape) >= 3:
                    width += leaf.shape[0] * (
                        leaf.shape[1] + math.prod(leaf.shape[2:]))
        else:
            for leaf in _spec_leaves(sub):
                if len(leaf.shape) >= 2:
                    width += leaf.shape[0] + math.prod(leaf.shape[1:])
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
            from repro_torch.train.train_step import make_loss_fn
            tcfg = TrainConfig(remat="none",
                               compute_dtype=str(cd).split(".")[-1])
            loss_fn = make_loss_fn(model, tcfg)
            torch.func.grad_and_value(loss_fn, has_aux=True)(
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
        products = FlopCounterMode(display=False)
        rest = _ArithmeticCounter()
        with products, rest:
            self._run(model, batch, seq, kind, cd)
        return float(products.get_total_flops() + rest.flops)

    def _bytes(self, model, batch: int, seq: int, kind: str, cd) -> float:
        cfg = model.cfg
        n = model.num_params()
        e = torch.empty((), dtype=cd).element_size()
        bf16 = cd != torch.float32
        weights = 4 * n + (4 * n if bf16 else 0)
        width = _matrix_width(model.spec)
        if kind == "decode":
            cache = _tree_bytes(model.cache_spec(batch,
                                                 seq + cfg.meta_tokens))
            return float(weights + cache + e * width * batch + 4 * batch)
        tokens = batch * (seq + (cfg.meta_tokens if kind == "prefill"
                                 else 0))
        total = weights + e * width * tokens + 4 * tokens
        if kind == "prefill":
            total += _tree_bytes(model.cache_spec(batch,
                                                  seq + cfg.meta_tokens))
        elif kind == "train":
            total += (2 * n if bf16 else 4 * n) + 4 * n \
                + 2 * e * width * tokens
        return float(total)

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
