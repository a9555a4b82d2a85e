"""Weights carried across between ``repro`` and ``repro_torch``.

The reference keeps parameters as a pytree of nested dicts and lists; this
module takes that tree as numpy arrays (no jax import) and returns the
port's tree, and back.  Every parameter leaf carries the leading worker
axis K in both packages.  The only layout change is the convolution
weights of the ``cnn`` family: HWIO ``[K, kh, kw, cin, cout]`` in the
reference, OIHW ``[K, cout, cin, kh, kw]`` here.  What is a convolution is
read from the leaf's place in the tree (``conv_flags``: a ``w…`` key under
``backbone``), never from its rank: an moe layer's experts ``[K, L, E, d,
ff]`` and an sLSTM's recurrent matrices ``r [K, 4, H, hd, hd]`` are 5-D too
and keep the reference's axis order.  The mlp and the transformers keep
their ``[d_in, d_out]`` matmul layouts; a transformer's layers stay stacked
``[K, L, ...]`` as ``blocks.init_stack`` stacks them (an encoder-decoder's
``encoder`` stack too), the ``ssm`` family's xLSTM layers a list of
per-layer dicts as in the reference.  An moe router stays fp32, as a hybrid
layer's SSM ``A_log`` and ``D`` and an xLSTM layer's gate biases do.  bf16
leaves travel through their bits.

The optimizer state follows suit: a momentum buffer has its parameter's
layout (HWIO ↔ OIHW as above); SM3 keeps its per-axis accumulators in the
reference's axis order and Shampoo its statistics over the reference's
flattening (``core/optimizer.py`` works through ``ref_orders``), so neither
is permuted here.  The streaming-sketch counts are layout-free.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.tree import tree_leaves


# A convolution weight [K, O, I, kh, kw] (the port's OIHW) read in the
# reference's HWIO order [K, kh, kw, I, O]: ``w.permute(TO_REF)``; and back.
TO_REF = (0, 3, 4, 2, 1)
FROM_REF = (0, 4, 3, 1, 2)


def ref_order(leaf: torch.Tensor, conv: bool = False) -> tuple[int, ...]:
    """The permutation that puts a stacked parameter leaf in the
    reference's axis order: ``leaf.permute(ref_order(leaf, conv))``, where
    ``conv`` says the leaf is a convolution weight (``conv_flags``); every
    other leaf is already in the reference's order."""
    return TO_REF if conv else tuple(range(leaf.dim()))


def conv_flags(tree) -> list[bool]:
    """For each leaf of a parameter tree (torch or numpy, in ``tree_leaves``
    order): is it a convolution weight?  Those are the ``w``, ``w1``–``w3``
    and ``wproj`` leaves under the cnn family's ``backbone`` (its GroupNorm
    leaves sit under ``gn`` keys); no other family has a ``backbone``."""
    return tree_leaves(_map(tree, lambda _, conv: conv))


def ref_orders(params) -> list[tuple[int, ...]]:
    """``ref_order`` of every leaf of ``params``, in ``tree_leaves`` order."""
    return [ref_order(l, c) for l, c in zip(tree_leaves(params), conv_flags(params),
                                            strict=True)]


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


def _map(tree, f, under_backbone: bool = False, key: str = ""):
    """Map leaves as ``f(leaf, conv)``, ``conv`` as ``conv_flags`` has it."""
    if isinstance(tree, dict):
        return {k: _map(v, f, under_backbone or k == "backbone", k) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(v, f, under_backbone, key) for v in tree)
    return f(tree, under_backbone and key.startswith("w"))


def _conv_from_ref(t: torch.Tensor, conv: bool) -> torch.Tensor:
    return t.permute(FROM_REF).contiguous() if conv else t   # HWIO → OIHW


def _conv_to_ref(t: torch.Tensor, conv: bool) -> np.ndarray:
    return _to_numpy(t.permute(TO_REF) if conv else t)       # OIHW → HWIO


def from_jax_params(mcfg: ModelConfig, tree, device="cpu"):
    """Reference parameter tree (numpy leaves, leading K axis) → the port's
    tree of tensors on ``device``."""
    del mcfg   # the layout is read from the tree (``conv_flags``)
    return _map(tree, lambda x, conv: _conv_from_ref(_to_torch(x, device), conv))


def to_jax_params(mcfg: ModelConfig, tree):
    """The port's parameter tree → numpy leaves in the reference's layout."""
    del mcfg
    return _map(tree, _conv_to_ref)


def _opt_from_jax(ccfg, opt, flags, device):
    leaves = opt["leaves"]
    if ccfg.optimizer == "momentum":   # buffers have their parameters' layout
        leaves = [_conv_from_ref(_to_torch(x, device), c)
                  for x, c in zip(leaves, flags, strict=True)]
    else:
        leaves = _map(leaves, lambda x, _: _to_torch(x, device))
    return {"t": _to_torch(opt["t"], device), "leaves": leaves}


def _opt_to_jax(ccfg, opt, flags):
    leaves = opt["leaves"]
    if ccfg.optimizer == "momentum":
        leaves = [_conv_to_ref(t, c) for t, c in zip(leaves, flags, strict=True)]
    else:
        leaves = _map(leaves, lambda t, _: _to_numpy(t))
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
        out["opt"] = _opt_from_jax(ccfg, state["opt"], conv_flags(state["params"]),
                                   device)
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
        out["opt"] = _opt_to_jax(ccfg, state["opt"], conv_flags(state["params"]))
    return out
