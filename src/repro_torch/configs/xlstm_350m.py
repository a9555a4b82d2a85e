"""xlstm-350m [ssm] — sLSTM + mLSTM blocks, attention-free. [arXiv:2405.04517]
Copy of ``repro.configs.xlstm_350m``.

d_ff=0: the xLSTM blocks carry their own gated up/down projections (expand
factor 2) instead of a separate FFN; every ``slstm_every``-th block is an
sLSTM, xLSTM[7:1] style.
"""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-350m",
    family="ssm",
    n_layers=24,
    d_model=1024,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    rope="none",
    act="swiglu",
    norm="layernorm",
    ssm_expand=2,
    slstm_every=8,
    source="arXiv:2405.04517",
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=128, n_heads=2, n_kv_heads=2,
        vocab_size=512, slstm_every=2)
