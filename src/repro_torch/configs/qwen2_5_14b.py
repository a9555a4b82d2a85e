"""qwen2.5-14b [dense] — GQA, QKV bias. [hf:Qwen/Qwen2.5-0.5B]
Copy of ``repro.configs.qwen2_5_14b``.
"""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-14b",
    family="dense",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=13824,
    vocab_size=152064,
    qkv_bias=True,
    act="swiglu",
    norm="rmsnorm",
    window_mode="optional",
    source="hf:Qwen/Qwen2.5-0.5B",
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, d_ff=256,
        vocab_size=512)
