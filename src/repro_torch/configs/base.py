"""Config dataclasses, a copy of the JAX package's `configs/base.py`: the
model configs, the dry run's `ShapeConfig` / `SHAPES` and `TrainConfig`.
(The reference's `MeshConfig` has no reader; the port's meshes are built
by `launch.mesh`.)

Every architecture the port serves gets a `ModelConfig` in its own module
under `repro_torch.configs`; the registry in `__init__.py` exposes
`get_config(arch)` and `smoke_config(arch)`.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

# ---------------------------------------------------------------------------
# Model families
# ---------------------------------------------------------------------------
DENSE = "dense"
MOE = "moe"
SSM = "ssm"          # xLSTM-style recurrent
HYBRID = "hybrid"    # parallel attention + SSM heads (hymba)
ENCODER = "encoder"  # bidirectional, no decode (hubert)
VLM = "vlm"          # early-fusion token VLM (chameleon)
MAMBA_HYBRID = "mamba_hybrid"  # each layer a Mamba-2 mixer or attention,
                               # by a pattern (granite-4.0-h)


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int          # routed experts (logical, pre-padding)
    top_k: int
    d_ff_expert: int
    num_shared_experts: int = 0
    d_ff_shared: int = 0      # total shared-expert ffn width
    router_aux_weight: float = 0.01
    # experts are padded up to a multiple of the EP shard count at build
    # time; padded experts get -inf router logits.


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    state_dim: int = 16       # per-channel state (mamba) / head_dim (mLSTM)
    conv_width: int = 4
    expand: int = 2           # d_inner = expand * d_model
    num_ssm_heads: int = 0    # hymba: number of mamba heads in parallel mix
    slstm_every: int = 2      # xlstm: one sLSTM block per this many blocks
    head_dim: int = 64        # Mamba heads of this dim over d_inner
    # Mamba-2: B/C groups shared by the heads. The mixer computes one
    # (`ssm.mamba2_dims` refuses others); the field holds the benchmark's
    # configuration file to the published value
    n_groups: int = 1
    conv_bias: bool = False   # Mamba-2: a bias on the depthwise conv


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                   # 0 -> d_model // num_heads
    norm: str = "rmsnorm"               # rmsnorm | layernorm | nonparam_ln
    act: str = "swiglu"                 # swiglu | gelu
    rope_theta: float = 10000.0
    qk_norm: bool = False               # chameleon / qwen3
    tie_embeddings: bool = False
    causal: bool = True                 # False for encoder-only
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    # attention pattern: full everywhere, or sliding window with a few
    # global layers (hymba)
    sliding_window: int = 0             # 0 -> full attention
    global_attn_layers: Tuple[int, ...] = ()
    meta_tokens: int = 0                # hymba learned prefix tokens
    # modality frontend stub: if set, inputs are precomputed embeddings
    # (batch, seq, d_model) instead of token ids
    embedding_frontend: bool = False
    dtype: str = "bfloat16"
    # mamba_hybrid: the attention layers' indices; every other layer is a
    # Mamba-2 mixer
    attn_layers: Tuple[int, ...] = ()
    # "nope": no positional encoding in attention, whatever rope_theta says
    position_embedding_type: str = "rope"
    # muP multipliers (granite-4.0-h), each applied only where it differs
    # from its default: the embedding's rows, each residual branch, the
    # attention scores (0 -> 1 / sqrt(head_dim)), and logits divided by
    # logits_scaling
    embedding_multiplier: float = 1.0
    residual_multiplier: float = 1.0
    attention_multiplier: float = 0.0
    logits_scaling: float = 1.0
    # -- derived ------------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def sub_quadratic(self) -> bool:
        """Can this arch decode at 500k context without O(L) KV cache
        attention per step over the full context?"""
        return self.family in (SSM, HYBRID)

    @property
    def has_decode(self) -> bool:
        return self.causal

    def param_count(self) -> int:
        """Approximate parameter count (used for MODEL_FLOPS=6ND)."""
        d, L, V = self.d_model, self.num_layers, self.vocab_size
        hd = self.resolved_head_dim
        emb = V * d * (1 if self.tie_embeddings else 2)
        per_layer = 0
        if self.family in (DENSE, MOE, VLM, ENCODER):
            per_layer += d * (self.num_heads * hd) + 2 * d * (self.num_kv_heads * hd)
            per_layer += (self.num_heads * hd) * d
        if self.family == HYBRID:
            per_layer += d * (self.num_heads * hd) + 2 * d * (self.num_kv_heads * hd)
            per_layer += (self.num_heads * hd) * d
            di = self.ssm.expand * d
            per_layer += 2 * d * di + di * d + di * (self.ssm.state_dim * 2 + 1)
        if self.family == MAMBA_HYBRID:     # exact: the final norm too
            return emb + d + sum(self._layer_params(i) for i in range(L))
        if self.family == SSM:
            # mLSTM/sLSTM projections (approx): qkv + gates + out
            di = self.ssm.expand * d
            per_layer += 2 * d * di + di * d + 3 * d * d
        if self.moe is not None:
            mult = 3 if self.act == "swiglu" else 2
            per_layer += self.moe.num_experts * mult * d * self.moe.d_ff_expert
            per_layer += self.moe.num_shared_experts and mult * d * self.moe.d_ff_shared
            per_layer += d * self.moe.num_experts  # router
        elif self.d_ff:
            mult = 3 if self.act == "swiglu" else 2
            per_layer += mult * d * self.d_ff
        return emb + L * per_layer

    def _layer_params(self, i: int) -> int:
        """A mamba_hybrid layer's parameters: its mixer (attention, or the
        Mamba-2 mixer's in- and out-projections, conv, per-head vectors
        and gated norm), its two norms and its MLP."""
        d, s = self.d_model, self.ssm
        hd = self.resolved_head_dim
        mult = 3 if self.act == "swiglu" else 2
        n = mult * d * self.d_ff + 2 * d
        if i in self.attn_layers:
            return n + 2 * d * (self.num_heads + self.num_kv_heads) * hd
        di = s.expand * d
        heads = di // s.head_dim
        conv = di + 2 * s.n_groups * s.state_dim
        return (n + d * (di + conv + heads) + di * d
                + (s.conv_width + s.conv_bias) * conv + 3 * heads + di)

    def active_param_count(self) -> int:
        """Active params per token (MoE: only top_k + shared experts)."""
        if self.moe is None:
            return self.param_count()
        d, L = self.d_model, self.num_layers
        mult = 3 if self.act == "swiglu" else 2
        full_experts = self.moe.num_experts * mult * d * self.moe.d_ff_expert
        active_experts = self.moe.top_k * mult * d * self.moe.d_ff_expert
        return self.param_count() - L * (full_experts - active_experts)


# ---------------------------------------------------------------------------
# Shapes (the dry run's cells)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


# ---------------------------------------------------------------------------
# Training configuration
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10000
    weight_decay: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    grad_clip: float = 1.0
    remat: str = "full"          # none | dots | full
    microbatches: int = 1        # gradient accumulation
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    compress_pod_grads: bool = False   # int8 cross-pod all-reduce
    seed: int = 0


def check_train_config(tcfg: TrainConfig):
    """Raise NotImplementedError for a field the port's train step does not
    honour, rather than train without it: compress_pod_grads, which no
    train step of either package reads."""
    if tcfg.compress_pod_grads:
        raise NotImplementedError(
            "compress_pod_grads is read by no train step of the reference "
            "(its train_step never calls pod_mean_compressed; ROADMAP.md, "
            "defects of the reference): the port keeps refusing it rather "
            "than add a feature the reference lacks. "
            "train.compression holds the functions themselves")
