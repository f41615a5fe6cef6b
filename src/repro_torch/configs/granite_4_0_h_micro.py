"""granite-4.0-h-micro — Mamba-2 mixers interleaved with NoPE GQA layers
(IBM Granite 4.0, https://huggingface.co/ibm-granite/granite-4.0-h-micro,
model_type granitemoehybrid).

40 layers: GQA attention (32 query heads, 8 KV heads of 64, no positional
encoding) at layers 5 / 15 / 25 / 35, a Mamba-2 mixer (64 heads of 64,
state 128, one B/C group, conv 4 with a bias) at the other 36; each
layer ends in a SwiGLU MLP of 8192. muP multipliers: embedding 12,
residual 0.22, attention scores 1/64, logits divided by 8. RMSNorm eps
1e-5 everywhere; tied 100,352-row table. rope_theta is the published
10000, which the published model ignores (position_embedding_type nope).
"""
from repro_torch.configs.base import MAMBA_HYBRID, ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="granite-4.0-h-micro",
    family=MAMBA_HYBRID,
    num_layers=40,
    d_model=2048,
    num_heads=32,
    num_kv_heads=8,
    d_ff=8192,
    vocab_size=100352,
    norm="rmsnorm",
    act="swiglu",
    rope_theta=10000.0,
    position_embedding_type="nope",
    tie_embeddings=True,
    ssm=SSMConfig(state_dim=128, conv_width=4, expand=2, head_dim=64,
                  n_groups=1, conv_bias=True),
    attn_layers=(5, 15, 25, 35),
    embedding_multiplier=12.0,
    residual_multiplier=0.22,
    attention_multiplier=0.015625,
    logits_scaling=8.0,
)


def smoke_config() -> ModelConfig:
    """Both kinds of layer at width 64: Mamba-2 mixers of 8 heads of 16
    at state 16 around one attention layer."""
    return ModelConfig(
        name="granite-smoke", family=MAMBA_HYBRID, num_layers=4, d_model=64,
        num_heads=4, num_kv_heads=2, d_ff=96, vocab_size=256,
        norm="rmsnorm", act="swiglu", rope_theta=10000.0,
        position_embedding_type="nope", tie_embeddings=True,
        ssm=SSMConfig(state_dim=16, conv_width=4, expand=2, head_dim=16,
                      n_groups=1, conv_bias=True),
        attn_layers=(1,), embedding_multiplier=12.0,
        residual_multiplier=0.22, attention_multiplier=0.0625,
        logits_scaling=8.0)
