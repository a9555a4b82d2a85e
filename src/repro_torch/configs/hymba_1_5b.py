"""hymba-1.5b [hybrid] — parallel attention + mamba heads per block; sliding
window attention everywhere except 3 global layers. [arXiv:2411.13676]
Copy of ``repro.configs.hymba_1_5b``.
"""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b",
    family="hybrid",
    n_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv_heads=5,
    d_ff=5504,
    vocab_size=32001,
    act="swiglu",
    norm="rmsnorm",
    ssm_state=16,
    ssm_expand=2,
    window=2048,
    window_mode="all_but_global",
    global_attn_every=16,  # layers 0, 16 (and the last) are global
    source="arXiv:2411.13676",
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, d_ff=256,
        vocab_size=512, ssm_state=8, window=64, global_attn_every=2)
