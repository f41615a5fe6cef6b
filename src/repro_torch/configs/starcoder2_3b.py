"""starcoder2-3b — dense, GQA kv=2, RoPE, GELU MLP [arXiv:2402.19173]."""
from repro_torch.configs.base import DENSE, ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-3b",
    family=DENSE,
    num_layers=30,
    d_model=3072,
    num_heads=24,
    num_kv_heads=2,
    d_ff=12288,
    vocab_size=49152,
    norm="layernorm",
    act="gelu",
    rope_theta=100000.0,
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="starcoder2-3b-smoke", family=DENSE, num_layers=2, d_model=64,
        num_heads=4, num_kv_heads=2, d_ff=256, vocab_size=256,
        norm="layernorm", act="gelu")
