"""resnet50 [cnn] — the paper's own network (He et al. 2016); copy of
``repro.configs.resnet50``.  Images arrive as ``[B, hw·hw, 3]``."""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="resnet50",
    family="cnn",
    n_layers=50,
    d_model=2048,  # final feature width
    n_heads=1,
    n_kv_heads=1,
    d_ff=0,
    vocab_size=0,
    rope="none",
    norm="layernorm",
    source="He et al. 2016 (paper's own net)",
)

# (stage blocks, stage width) per ResNet50
RESNET50_STAGES = ((3, 256), (4, 512), (6, 1024), (3, 2048))
RESNET_TINY_STAGES = ((1, 64), (1, 128))


def smoke_config() -> ModelConfig:
    return dataclasses.replace(CONFIG, name="resnet-tiny", n_layers=8, d_model=128)
