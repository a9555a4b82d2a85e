"""Architecture registry (``get_config`` / ``get_smoke_config``).

This slice ports the ``cnn`` family only; the other ten architectures of
``repro.configs`` arrive with the model zoo (ROADMAP Queue 1, item 11).
"""
from __future__ import annotations

from repro_torch.configs import resnet50
from repro_torch.configs.base import ModelConfig, mlp_config

_MODULES = {"resnet50": resnet50}


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


__all__ = ["ModelConfig", "get_config", "get_smoke_config", "mlp_config"]
