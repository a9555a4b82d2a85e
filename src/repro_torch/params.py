"""Weights carried across between ``repro`` and ``repro_torch``.

The reference keeps parameters as a pytree of nested dicts and lists; this
module takes that tree as numpy arrays (no jax import) and returns the
port's tree, and back.  Every parameter leaf carries the leading worker
axis K in both packages.  The only layout change is the convolution
weights of the ``cnn`` family: HWIO ``[K, kh, kw, cin, cout]`` in the
reference, OIHW ``[K, cout, cin, kh, kw]`` here.  The mlp keeps its
``[d_in, d_out]`` matmul layout.  bf16 leaves travel through their bits.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig


def _to_torch(x, device) -> torch.Tensor:
    x = np.array(x)   # a writable copy: the caller's array stays untouched
    if x.dtype.name == "bfloat16":
        return torch.from_numpy(x.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(x).to(device)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """bf16 comes back as float32 (exact: every bf16 is an fp32)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.to(torch.float32)
    return t.numpy()


def _map(tree, f, conv: bool):
    """Map leaves, flagging those under ``backbone`` (the cnn's convs)."""
    if isinstance(tree, dict):
        return {k: _map(v, f, conv or k == "backbone") for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(v, f, conv) for v in tree)
    return f(tree, conv)


def from_jax_params(mcfg: ModelConfig, tree, device="cpu"):
    """Reference parameter tree (numpy leaves, leading K axis) → the port's
    tree of tensors on ``device``."""
    def leaf(x, conv):
        t = _to_torch(x, device)
        if conv and mcfg.family == "cnn" and t.dim() == 5:
            t = t.permute(0, 4, 3, 1, 2).contiguous()   # HWIO → OIHW
        return t

    return _map(tree, leaf, False)


def to_jax_params(mcfg: ModelConfig, tree):
    """The port's parameter tree → numpy leaves in the reference's layout."""
    def leaf(t, conv):
        if conv and mcfg.family == "cnn" and t.dim() == 5:
            t = t.permute(0, 3, 4, 2, 1)                 # OIHW → HWIO
        return _to_numpy(t)

    return _map(tree, leaf, False)


def state_from_jax(mcfg: ModelConfig, ccfg, state, device="cpu"):
    """A whole reference CoDA state (params, duals, ref_params, ref_duals
    as numpy) → the port's state.  ``ccfg`` is accepted for symmetry with
    the reference's state builders; the layout depends on ``mcfg`` only."""
    del ccfg
    duals = lambda d: {k: _to_torch(v, device) for k, v in d.items()}
    return {"params": from_jax_params(mcfg, state["params"], device),
            "duals": duals(state["duals"]),
            "ref_params": from_jax_params(mcfg, state["ref_params"], device),
            "ref_duals": duals(state["ref_duals"])}


def state_to_jax(mcfg: ModelConfig, state):
    """The port's CoDA state → numpy in the reference's layout."""
    duals = lambda d: {k: _to_numpy(v) for k, v in d.items()}
    return {"params": to_jax_params(mcfg, state["params"]),
            "duals": duals(state["duals"]),
            "ref_params": to_jax_params(mcfg, state["ref_params"]),
            "ref_duals": duals(state["ref_duals"])}
