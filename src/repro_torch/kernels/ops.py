"""Public wrappers over the CUDA kernels (counterpart of
``repro.kernels.ops``).

``impl`` semantics everywhere (one decision point: ``dispatch``):
  * "auto"   — the hand-written kernel for CUDA tensors, the plain PyTorch
               version for CPU tensors.
  * "ref"    — force the plain version (on any device).
  * "kernel" — force the kernel; a CPU tensor raises.
Anything else raises — a typo'd ``impl`` must not silently fall back.
There is no ``try`` around a build or a launch: a kernel that fails to
build or launch raises, it is never replaced by the plain version.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import auc_loss as _auc_mod
from repro_torch.kernels import prox_update as _prox_mod
from repro_torch.kernels import ref
from repro_torch.tree import tree_map

IMPLS = ("auto", "ref", "kernel")


def dispatch(impl: str, device: torch.device) -> bool:
    """The one dispatch decision: True = launch the CUDA kernel."""
    if impl == "ref":
        return False
    if impl == "kernel":
        if device.type != "cuda":
            raise ValueError(f"impl='kernel' needs CUDA tensors, got {device}")
        return True
    if impl == "auto":
        return device.type == "cuda"
    raise ValueError(f"unknown impl {impl!r} (want auto | ref | kernel)")


def auc_loss(h, y, a, b, alpha, p: float, *, impl: str = "auto"):
    """Fused loss + closed-form grads of the min-max AUC objective for all
    K workers: h, y [K, T]; a, b, alpha [K].  Returns (loss [K], dh [K, T],
    da [K], db [K], dalpha [K])."""
    if dispatch(impl, h.device):
        return _auc_mod.auc_loss(h, y, a, b, alpha, p)
    return ref.auc_loss_ref(h, y, a, b, alpha, p)


def prox_update_tree(v_tree, g_tree, v0_tree, eta: float, gamma: float, *,
                     impl: str = "auto"):
    """Apply the fused proximal update leaf-wise over parameter trees (one
    launch per leaf, each covering all K workers)."""
    def upd(v, g, v0):
        if dispatch(impl, v.device):
            return _prox_mod.prox_update(v, g, v0, eta, gamma)
        return ref.prox_update_ref(v, g, v0, eta, gamma)

    return tree_map(upd, v_tree, g_tree, v0_tree)
