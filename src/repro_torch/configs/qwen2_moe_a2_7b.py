"""qwen2-moe-a2.7b — 4 shared + 60 routed top-4 [hf:Qwen/Qwen1.5-MoE-A2.7B]."""
from repro_torch.configs.base import MOE, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b",
    family=MOE,
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=0,
    vocab_size=151936,
    norm="rmsnorm",
    act="swiglu",
    rope_theta=1000000.0,
    moe=MoEConfig(num_experts=60, top_k=4, d_ff_expert=1408,
                  num_shared_experts=4, d_ff_shared=5632),
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-moe-smoke", family=MOE, num_layers=2, d_model=64,
        num_heads=4, num_kv_heads=4, d_ff=0, vocab_size=256,
        norm="rmsnorm", act="swiglu",
        moe=MoEConfig(num_experts=6, top_k=2, d_ff_expert=64,
                      num_shared_experts=2, d_ff_shared=128))
