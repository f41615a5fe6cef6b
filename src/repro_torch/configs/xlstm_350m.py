"""xlstm-350m — alternating sLSTM + mLSTM blocks [arXiv:2405.04517]."""
from repro_torch.configs.base import SSM, ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="xlstm-350m",
    family=SSM,
    num_layers=24,
    d_model=1024,
    num_heads=4,
    num_kv_heads=4,
    d_ff=0,                      # xLSTM blocks embed their own up-projection
    vocab_size=50304,
    norm="layernorm",
    act="gelu",
    ssm=SSMConfig(state_dim=0, conv_width=4, expand=2, slstm_every=2),
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="xlstm-350m-smoke", family=SSM, num_layers=2, d_model=64,
        num_heads=2, num_kv_heads=2, d_ff=0, vocab_size=256,
        norm="layernorm", act="gelu",
        ssm=SSMConfig(state_dim=0, conv_width=4, expand=2, slstm_every=2))
