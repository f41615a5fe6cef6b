"""hubert-xlarge — encoder-only audio backbone [arXiv:2106.07447].

The conv feature-extractor frontend is a STUB per the brief: `input_specs`
provides precomputed frame embeddings (batch, frames, d_model).
"""
from repro_torch.configs.base import ENCODER, ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge",
    family=ENCODER,
    num_layers=48,
    d_model=1280,
    num_heads=16,
    num_kv_heads=16,
    d_ff=5120,
    vocab_size=504,
    norm="layernorm",
    act="gelu",
    causal=False,
    embedding_frontend=True,
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="hubert-smoke", family=ENCODER, num_layers=2, d_model=64,
        num_heads=4, num_kv_heads=4, d_ff=256, vocab_size=64,
        norm="layernorm", act="gelu", causal=False, embedding_frontend=True)
