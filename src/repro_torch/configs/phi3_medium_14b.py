"""phi3-medium-14b [dense] — RoPE, SwiGLU, GQA kv=10. [arXiv:2404.14219]
Copy of ``repro.configs.phi3_medium_14b``.
"""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="phi3-medium-14b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=40,
    n_kv_heads=10,
    d_ff=17920,
    vocab_size=100352,
    act="swiglu",
    norm="rmsnorm",
    window_mode="optional",
    source="arXiv:2404.14219",
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, d_ff=256,
        vocab_size=512)
