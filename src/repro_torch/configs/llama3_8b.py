"""llama3-8b — dense, GQA kv=8, 128k vocab [arXiv:2407.21783]."""
from repro_torch.configs.base import DENSE, ModelConfig

CONFIG = ModelConfig(
    name="llama3-8b",
    family=DENSE,
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=128256,
    norm="rmsnorm",
    act="swiglu",
    rope_theta=500000.0,
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="llama3-8b-smoke", family=DENSE, num_layers=2, d_model=64,
        num_heads=4, num_kv_heads=2, d_ff=224, vocab_size=256,
        norm="rmsnorm", act="swiglu", rope_theta=500000.0)
