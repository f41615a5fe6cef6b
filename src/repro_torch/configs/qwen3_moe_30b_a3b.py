"""qwen3-moe-30b-a3b — 128 routed experts, top-8 [hf:Qwen/Qwen3-30B-A3B]."""
from repro_torch.configs.base import MOE, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b",
    family=MOE,
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=4,
    d_ff=0,
    vocab_size=151936,
    head_dim=128,                 # qwen3 uses head_dim 128 (> d_model/heads)
    norm="rmsnorm",
    act="swiglu",
    rope_theta=1000000.0,
    qk_norm=True,
    moe=MoEConfig(num_experts=128, top_k=8, d_ff_expert=768),
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-moe-smoke", family=MOE, num_layers=2, d_model=64,
        num_heads=4, num_kv_heads=2, d_ff=0, vocab_size=256, head_dim=16,
        norm="rmsnorm", act="swiglu", qk_norm=True,
        moe=MoEConfig(num_experts=8, top_k=2, d_ff_expert=64))
