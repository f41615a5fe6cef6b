"""hymba-1.5b — parallel attention + Mamba heads per block [arXiv:2411.13676].

Sliding-window attention everywhere except 3 global layers (first, middle,
last); 128 learned meta tokens prepended to every sequence.
"""
from repro_torch.configs.base import HYBRID, ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="hymba-1.5b",
    family=HYBRID,
    num_layers=32,
    d_model=1600,
    num_heads=25,
    num_kv_heads=5,
    d_ff=5504,
    vocab_size=32001,
    norm="rmsnorm",
    act="swiglu",
    rope_theta=10000.0,
    ssm=SSMConfig(state_dim=16, conv_width=4, expand=2),
    sliding_window=1024,
    global_attn_layers=(0, 15, 31),
    meta_tokens=128,
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="hymba-smoke", family=HYBRID, num_layers=2, d_model=64,
        num_heads=4, num_kv_heads=2, d_ff=192, vocab_size=256,
        norm="rmsnorm", act="swiglu",
        ssm=SSMConfig(state_dim=8, conv_width=4, expand=2),
        sliding_window=16, global_attn_layers=(0,), meta_tokens=4)
