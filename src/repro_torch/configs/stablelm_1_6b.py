"""stablelm-1.6b [dense] — MHA (kv=heads), partial rotary, layernorm.
[hf:stabilityai/stablelm-2-1_6b]
Copy of ``repro.configs.stablelm_1_6b``.
"""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-1.6b",
    family="dense",
    n_layers=24,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=5632,
    vocab_size=100352,
    rope="partial",
    rope_fraction=0.25,
    act="swiglu",
    norm="layernorm",
    window_mode="optional",
    source="hf:stabilityai/stablelm-2-1_6b",
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=128, n_heads=4, n_kv_heads=4, d_ff=256,
        vocab_size=512)
