"""Architecture registry (``get_config`` / ``get_smoke_config``).

Ported: the ``cnn`` family (resnet50), the ``dense`` family
(stablelm-1.6b, qwen2.5-14b, phi3-medium-14b, chatglm3-6b), the ``moe``
family (dbrx-132b, arctic-480b), the ``vlm`` family (internvl2-2b), the
``hybrid`` family (hymba-1.5b) and the ``audio`` encoder-decoder
(seamless-m4t-medium) and the ``ssm`` family (xlstm-350m); the ``mlp``
scorer is ``mlp_config()``.
"""
from __future__ import annotations

from repro_torch.configs import (
    arctic_480b,
    chatglm3_6b,
    dbrx_132b,
    hymba_1_5b,
    internvl2_2b,
    phi3_medium_14b,
    qwen2_5_14b,
    resnet50,
    seamless_m4t_medium,
    stablelm_1_6b,
    xlstm_350m,
)
from repro_torch.configs.base import ModelConfig, MoEConfig, mlp_config

_MODULES = {
    "chatglm3-6b": chatglm3_6b,
    "arctic-480b": arctic_480b,
    "dbrx-132b": dbrx_132b,
    "internvl2-2b": internvl2_2b,
    "qwen2.5-14b": qwen2_5_14b,
    "stablelm-1.6b": stablelm_1_6b,
    "seamless-m4t-medium": seamless_m4t_medium,
    "hymba-1.5b": hymba_1_5b,
    "phi3-medium-14b": phi3_medium_14b,
    "resnet50": resnet50,
    "xlstm-350m": xlstm_350m,
}

DENSE_ARCHS = ("stablelm-1.6b", "qwen2.5-14b", "phi3-medium-14b", "chatglm3-6b")
MOE_ARCHS = ("dbrx-132b", "arctic-480b")
# the vlm, hybrid, audio and ssm families, one architecture each
ZOO_ARCHS = ("internvl2-2b", "hymba-1.5b", "seamless-m4t-medium", "xlstm-350m")


def _module(arch: str):
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; ported: mlp, {', '.join(_MODULES)}")
    return _MODULES[arch]


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return _module(arch).smoke_config()


__all__ = ["DENSE_ARCHS", "MOE_ARCHS", "ZOO_ARCHS", "ModelConfig", "MoEConfig", "get_config",
           "get_smoke_config", "mlp_config"]
