"""Weights carried across between ``repro`` and ``repro_torch``.

The reference keeps parameters as a pytree of nested dicts and lists; this
module takes that tree as numpy arrays (no jax import) and returns the
port's tree, and back.  Every parameter leaf carries the leading worker
axis K in both packages.  The only layout change is the convolution
weights of the ``cnn`` family: HWIO ``[K, kh, kw, cin, cout]`` in the
reference, OIHW ``[K, cout, cin, kh, kw]`` here.  The mlp and the
transformers keep their ``[d_in, d_out]`` matmul layouts, and a
transformer's layers stay stacked ``[K, L, ...]`` as ``blocks.init_stack``
stacks them (an encoder-decoder's ``encoder`` stack too): an moe layer's
experts are ``[K, L, E, d, ff]`` in both packages, and its router stays
fp32, as a hybrid layer's SSM ``A_log`` and ``D`` do.  Only the cnn family's 5-D leaves are
permuted.  bf16 leaves travel through their bits.

The optimizer state follows suit: a momentum buffer has its parameter's
layout (HWIO ↔ OIHW as above); SM3 keeps its per-axis accumulators in the
reference's axis order and Shampoo its statistics over the reference's
flattening (``core/optimizer.py`` works through ``ref_order``), so neither
is permuted here.  The streaming-sketch counts are layout-free.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig


# A convolution weight [K, O, I, kh, kw] (the port's OIHW) read in the
# reference's HWIO order [K, kh, kw, I, O]: ``w.permute(TO_REF)``; and back.
TO_REF = (0, 3, 4, 2, 1)
FROM_REF = (0, 4, 3, 1, 2)


def ref_order(leaf: torch.Tensor) -> tuple[int, ...]:
    """The permutation that puts a stacked parameter leaf in the
    reference's axis order: ``leaf.permute(ref_order(leaf))``.  It reads
    every 5-D leaf as a convolution weight, which is right for the families
    the axis-order optimizers (sm3, shampoo_blocked) run on: mlp, cnn, dense,
    vlm, hybrid and audio, whose stacked layer leaves (the SSM's included)
    are at most 4-D with K (``coda.init_state`` refuses them on the moe
    family, whose expert leaves are 5-D and not permuted)."""
    return TO_REF if leaf.dim() == 5 else tuple(range(leaf.dim()))


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


def _conv_from_ref(mcfg: ModelConfig, t: torch.Tensor) -> torch.Tensor:
    if mcfg.family == "cnn" and t.dim() == 5:
        return t.permute(FROM_REF).contiguous()   # HWIO → OIHW
    return t


def _conv_to_ref(mcfg: ModelConfig, t: torch.Tensor) -> np.ndarray:
    if mcfg.family == "cnn" and t.dim() == 5:
        t = t.permute(TO_REF)                     # OIHW → HWIO
    return _to_numpy(t)


def from_jax_params(mcfg: ModelConfig, tree, device="cpu"):
    """Reference parameter tree (numpy leaves, leading K axis) → the port's
    tree of tensors on ``device``."""
    return _map(tree, lambda x, conv: _conv_from_ref(mcfg, _to_torch(x, device))
                if conv else _to_torch(x, device), False)


def to_jax_params(mcfg: ModelConfig, tree):
    """The port's parameter tree → numpy leaves in the reference's layout."""
    return _map(tree, lambda t, conv: _conv_to_ref(mcfg, t) if conv
                else _to_numpy(t), False)


def _opt_from_jax(mcfg, ccfg, opt, device):
    leaves = opt["leaves"]
    if ccfg.optimizer == "momentum":   # buffers have their parameters' layout
        leaves = [_conv_from_ref(mcfg, _to_torch(x, device)) for x in leaves]
    else:
        leaves = _map(leaves, lambda x, _: _to_torch(x, device), False)
    return {"t": _to_torch(opt["t"], device), "leaves": leaves}


def _opt_to_jax(mcfg, ccfg, opt):
    leaves = opt["leaves"]
    if ccfg.optimizer == "momentum":
        leaves = [_conv_to_ref(mcfg, t) for t in leaves]
    else:
        leaves = _map(leaves, lambda t, _: _to_numpy(t), False)
    return {"t": _to_numpy(opt["t"]), "leaves": leaves}


_SKETCH = ("sk_acc", "sk_new", "sk_loc")
# CODASCA's variates and the server-momentum buffer: parameter-shaped trees
# (the cnn's convolutions permuted as the parameters are) and dual dicts
_PARAM_TREES = ("cv_params", "cg_params", "srv_m")
_DUAL_DICTS = ("cv_duals", "cg_duals")


def state_from_jax(mcfg: ModelConfig, ccfg, state, device="cpu"):
    """A whole reference CoDA state as numpy (params, duals, ref_params,
    ref_duals, and where present the optimizer state ``opt``, the sketch
    trees, CODASCA's variates and ``srv_m``) → the port's state.  ``ccfg.optimizer`` says how ``opt`` is laid
    out."""
    duals = lambda d: {k: _to_torch(v, device) for k, v in d.items()}
    out = {"params": from_jax_params(mcfg, state["params"], device),
           "duals": duals(state["duals"]),
           "ref_params": from_jax_params(mcfg, state["ref_params"], device),
           "ref_duals": duals(state["ref_duals"])}
    for k in _SKETCH + _DUAL_DICTS:
        if k in state:
            out[k] = duals(state[k])
    for k in _PARAM_TREES:
        if k in state:
            out[k] = from_jax_params(mcfg, state[k], device)
    if "opt" in state:
        out["opt"] = _opt_from_jax(mcfg, ccfg, state["opt"], device)
    return out


def state_to_jax(mcfg: ModelConfig, state, ccfg=None):
    """The port's CoDA state → numpy in the reference's layout (``ccfg`` is
    needed only for a state with ``opt``)."""
    duals = lambda d: {k: _to_numpy(v) for k, v in d.items()}
    out = {"params": to_jax_params(mcfg, state["params"]),
           "duals": duals(state["duals"]),
           "ref_params": to_jax_params(mcfg, state["ref_params"]),
           "ref_duals": duals(state["ref_duals"])}
    for k in _SKETCH + _DUAL_DICTS:
        if k in state:
            out[k] = duals(state[k])
    for k in _PARAM_TREES:
        if k in state:
            out[k] = to_jax_params(mcfg, state[k])
    if "opt" in state:
        out["opt"] = _opt_to_jax(mcfg, ccfg, state["opt"])
    return out
