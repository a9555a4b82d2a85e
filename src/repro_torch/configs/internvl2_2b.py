"""internvl2-2b [vlm] — InternViT (stubbed frontend) + InternLM2 backbone.
[arXiv:2404.16821]

Per the assignment carve-out the ViT is a stub: ``input_specs`` supplies 256
precomputed patch embeddings of width d_model which are prepended to the text
token embeddings.
Copy of ``repro.configs.internvl2_2b``.
"""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-2b",
    family="vlm",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=92553,
    act="swiglu",
    norm="rmsnorm",
    window_mode="optional",
    n_patches=256,
    source="arXiv:2404.16821",
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, d_ff=256,
        vocab_size=512, n_patches=8)
