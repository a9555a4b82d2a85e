"""Architecture registry (``get_config`` / ``get_smoke_config``).

Ported: the ``cnn`` family (resnet50) and the ``dense`` family
(stablelm-1.6b, qwen2.5-14b, phi3-medium-14b, chatglm3-6b); the ``mlp``
scorer is ``mlp_config()``.  The other six architectures of
``repro.configs`` arrive with the rest of the model zoo (ROADMAP Queue 1,
item 11).
"""
from __future__ import annotations

from repro_torch.configs import (
    chatglm3_6b,
    phi3_medium_14b,
    qwen2_5_14b,
    resnet50,
    stablelm_1_6b,
)
from repro_torch.configs.base import ModelConfig, mlp_config

_MODULES = {
    "chatglm3-6b": chatglm3_6b,
    "qwen2.5-14b": qwen2_5_14b,
    "stablelm-1.6b": stablelm_1_6b,
    "phi3-medium-14b": phi3_medium_14b,
    "resnet50": resnet50,
}

DENSE_ARCHS = ("stablelm-1.6b", "qwen2.5-14b", "phi3-medium-14b", "chatglm3-6b")


def _module(arch: str):
    if arch not in _MODULES:
        raise NotImplementedError(
            f"arch {arch!r} is not ported yet (ROADMAP Queue 1 item 11, model "
            f"zoo); ported: mlp, {', '.join(_MODULES)}")
    return _MODULES[arch]


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return _module(arch).smoke_config()


__all__ = ["DENSE_ARCHS", "ModelConfig", "get_config", "get_smoke_config",
           "mlp_config"]
