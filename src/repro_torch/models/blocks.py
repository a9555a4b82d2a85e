"""Per-layer blocks and the layer stack (counterpart of
``repro.models.blocks``), for the decoder layers of the ``dense`` and
``moe`` families (an moe layer has ``moe`` where a dense one has ``mlp``).

Layer parameters are stacked along a leading ``n_layers`` axis, as
``blocks.init_stack`` stacks them (``blocks.py:75``); with the worker axis
in front a stacked leaf is ``[K, L, ...]``.  The reference scans the stack
with ``jax.lax.scan`` and hands each layer its window as a *traced* scalar,
so its attention never reaches the Pallas kernel; here the stack is a
Python loop and every layer's window is a Python int or None
(``layer_windows_static``), so every attention layer launches K4.

The ``hybrid``, encoder-decoder (``cross``) and ``xlstm`` branches are not
ported yet and raise, naming their ROADMAP item.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.attention import attend, init_attention
from repro_torch.models.embeddings import ParamInit, apply_norm, init_norm
from repro_torch.models.mlp import apply_mlp, init_mlp
from repro_torch.models.moe import apply_moe, init_moe
from repro_torch.tree import tree_leaves, tree_unflatten

_UNPORTED = "ROADMAP Queue 1 item 11 (model zoo: hybrid, audio, ssm)"


def _check_decoder(cfg: ModelConfig, kind: str):
    if cfg.family not in ("dense", "moe") or kind != "decoder":
        raise NotImplementedError(
            f"{cfg.family!r} layers of kind {kind!r} are not ported yet "
            f"({_UNPORTED}); ported: dense and moe decoder layers")


def layer_windows(cfg: ModelConfig, S: int, use_window: bool) -> torch.Tensor:
    """Per-layer effective window sizes as an int32 tensor, ``-1`` meaning
    full/global (``blocks.py:27-37``)."""
    del S  # as in the reference: the windows do not depend on S
    return torch.tensor([-1 if w is None else w
                         for w in layer_windows_static(cfg, use_window)],
                        dtype=torch.int32)


def layer_windows_static(cfg: ModelConfig, use_window: bool):
    """Per-layer windows as Python ``int | None`` (``blocks.py:39-50``):
    what the layer loop hands to attention."""
    if cfg.window_mode == "none" or (cfg.window_mode == "optional" and not use_window):
        return [None] * cfg.n_layers
    if cfg.window_mode == "optional":
        return [cfg.window] * cfg.n_layers
    out = []
    for i in range(cfg.n_layers):
        g = (i % max(cfg.global_attn_every, 1) == 0) or (i == cfg.n_layers - 1)
        out.append(None if g else cfg.window)
    return out


def init_layer(cfg: ModelConfig, kind: str, init: ParamInit, lead=()):
    """One decoder layer's parameters (``lead`` = a stack of layers)."""
    _check_decoder(cfg, kind)
    d = cfg.d_model
    p = {"norm1": init_norm(cfg, d, init, lead), "norm2": init_norm(cfg, d, init, lead),
         "attn": init_attention(cfg, init, lead)}
    if cfg.family == "moe":
        p["moe"] = init_moe(cfg, init, lead)
    else:
        p["mlp"] = init_mlp(cfg, init, lead)
    return p


def init_stack(cfg: ModelConfig, n_layers: int, kind: str, init: ParamInit):
    """``n_layers`` layers with every leaf stacked ``[L, ...]``."""
    return init_layer(cfg, kind, init, lead=(n_layers,))


def apply_layer(cfg: ModelConfig, p, x, positions, window, *, kind: str = "decoder",
                causal: bool = True, train: bool = False, impl: str = "auto",
                return_kv: bool = False):
    """One block over x [K, B, S, d].  ``window``: int | None.  Returns
    (x, aux [K], kv) — aux is the MoE load-balance loss (zeros for dense
    layers), kv the bf16 (K, V) pair when ``return_kv``.  ``train`` picks
    the MoE dispatch (capacity with drops); it changes nothing for dense
    layers."""
    _check_decoder(cfg, kind)
    h = apply_norm(cfg, p["norm1"], x)
    a = attend(cfg, p["attn"], h, positions, window=window, causal=causal,
               impl=impl, return_kv=return_kv)
    kv = None
    if return_kv:
        a, kv = a
    x = x + a
    h2 = apply_norm(cfg, p["norm2"], x)
    if "moe" in p:
        y, aux = apply_moe(cfg, p["moe"], h2, train=train, impl=impl)
    else:
        y = apply_mlp(cfg, p["mlp"], h2)
        aux = torch.zeros((x.shape[0],), dtype=torch.float32, device=x.device)
    return x + y, aux, kv


def unstack(stacked, n_layers: int):
    """Stacked leaves [K, L, ...] → one tree of [K, ...] leaves per layer
    (views; autograd stacks the layers' gradients back)."""
    cols = [l.unbind(1) for l in tree_leaves(stacked)]
    if any(len(c) != n_layers for c in cols):
        raise ValueError(f"stacked layer leaves do not all have {n_layers} layers")
    return [tree_unflatten(stacked, [c[i] for c in cols]) for i in range(n_layers)]


def apply_stack(cfg: ModelConfig, stacked, x, positions, windows, *,
                kind: str = "decoder", causal: bool = True, enc_out=None,
                train: bool = False, impl: str = "auto", return_kv: bool = False):
    """The layers in order (the reference's scan as a Python loop).
    ``windows``: one ``int | None`` per layer.  Returns (hidden, aux [K]
    summed over the layers) — plus the stacked per-layer bf16 (K, V) caches
    ``[K, L, B, S, KV, hd]`` when ``return_kv`` (the prefill path)."""
    if enc_out is not None:
        raise NotImplementedError(f"cross attention is not ported yet ({_UNPORTED})")
    aux = torch.zeros((x.shape[0],), dtype=torch.float32, device=x.device)
    ks, vs = [], []
    for lp, w in zip(unstack(stacked, len(windows)), windows, strict=True):
        x, a, kv = apply_layer(cfg, lp, x, positions, w, kind=kind, causal=causal,
                               train=train, impl=impl, return_kv=return_kv)
        aux = aux + a
        if return_kv:
            ks.append(kv[0])
            vs.append(kv[1])
    if return_kv:
        return x, aux, (torch.stack(ks, dim=1), torch.stack(vs, dim=1))
    return x, aux
