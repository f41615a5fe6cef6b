"""stablelm-3b — dense [hf:stabilityai/stablelm-2-1_6b family]."""
from repro_torch.configs.base import DENSE, ModelConfig

CONFIG = ModelConfig(
    name="stablelm-3b",
    family=DENSE,
    num_layers=32,
    d_model=2560,
    num_heads=32,
    num_kv_heads=32,
    d_ff=6912,
    vocab_size=50304,
    norm="layernorm",
    act="swiglu",
    rope_theta=10000.0,
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="stablelm-3b-smoke", family=DENSE, num_layers=2, d_model=64,
        num_heads=4, num_kv_heads=4, d_ff=192, vocab_size=256,
        norm="layernorm", act="swiglu")
