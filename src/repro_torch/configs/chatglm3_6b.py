"""chatglm3-6b [dense] — RoPE 2d (half-rotary), GQA kv=2. [arXiv:2406.12793]
Copy of ``repro.configs.chatglm3_6b``.
"""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="chatglm3-6b",
    family="dense",
    n_layers=28,
    d_model=4096,
    n_heads=32,
    n_kv_heads=2,
    d_ff=13696,
    vocab_size=65024,
    rope="2d-partial",
    rope_fraction=0.5,
    qkv_bias=True,
    act="swiglu",
    norm="rmsnorm",
    window_mode="optional",
    source="arXiv:2406.12793",
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, d_ff=256,
        vocab_size=512)
