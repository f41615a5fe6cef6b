"""chameleon-34b — early-fusion VLM; VQ image tokens share the 65536 vocab
[arXiv:2405.09818]. The VQ image tokenizer frontend is a STUB per the brief
(inputs are token ids; image regions are just token spans).
"""
from repro_torch.configs.base import VLM, ModelConfig

CONFIG = ModelConfig(
    name="chameleon-34b",
    family=VLM,
    num_layers=48,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=22016,
    vocab_size=65536,
    norm="rmsnorm",
    act="swiglu",
    rope_theta=10000.0,
    qk_norm=True,
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="chameleon-smoke", family=VLM, num_layers=2, d_model=64,
        num_heads=4, num_kv_heads=2, d_ff=192, vocab_size=256,
        norm="rmsnorm", act="swiglu", qk_norm=True)
