"""arctic-480b [moe] — 128 experts top-2 + dense residual MLP.
[hf:Snowflake/snowflake-arctic-base]
Copy of ``repro.configs.arctic_480b``.
"""
import dataclasses

from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="arctic-480b",
    family="moe",
    n_layers=35,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=4864,
    vocab_size=32000,
    act="swiglu",
    norm="rmsnorm",
    window_mode="optional",
    moe=MoEConfig(n_experts=128, top_k=2, dense_residual=True, dense_d_ff=4864),
    source="hf:Snowflake/snowflake-arctic-base",
)


def smoke_config() -> ModelConfig:
    # ``replace`` keeps the full config's head_dim (128): 4 heads of 128
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, d_ff=128,
        vocab_size=512,
        moe=MoEConfig(n_experts=4, top_k=2, dense_residual=True, dense_d_ff=128))
