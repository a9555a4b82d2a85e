"""dbrx-132b [moe] — 16 experts top-4, fine-grained. [hf:databricks/dbrx-base]
Copy of ``repro.configs.dbrx_132b``.
"""
import dataclasses

from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="dbrx-132b",
    family="moe",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=10752,
    vocab_size=100352,
    act="swiglu",
    norm="layernorm",
    window_mode="optional",
    moe=MoEConfig(n_experts=16, top_k=4),
    source="hf:databricks/dbrx-base",
)


def smoke_config() -> ModelConfig:
    # ``replace`` keeps the full config's head_dim (128): 4 heads of 128
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, d_ff=256,
        vocab_size=512, moe=MoEConfig(n_experts=4, top_k=2))
