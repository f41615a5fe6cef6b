"""olmo-1b — dense, non-parametric LayerNorm [arXiv:2402.00838]."""
from repro_torch.configs.base import DENSE, ModelConfig

CONFIG = ModelConfig(
    name="olmo-1b",
    family=DENSE,
    num_layers=16,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=8192,
    vocab_size=50304,
    norm="nonparam_ln",
    act="swiglu",
    rope_theta=10000.0,
    tie_embeddings=True,
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="olmo-1b-smoke", family=DENSE, num_layers=2, d_model=64,
        num_heads=4, num_kv_heads=4, d_ff=256, vocab_size=256,
        norm="nonparam_ln", act="swiglu", tie_embeddings=True)
