"""Per-layer blocks and the layer stack (counterpart of
``repro.models.blocks``) for the scanned families: ``dense`` and ``moe``
decoder layers (an moe layer has ``moe`` where a dense one has ``mlp``),
``vlm`` (a dense stack behind the patch projector), ``hybrid`` (each
decoder layer also runs the SSM branch on its own norm, ``ssm`` +
``norm_h``, and averages it with attention) and the ``audio``
encoder-decoder (``encoder`` layers, non-causal; ``xdecoder`` layers with a
cross attention, ``cross`` + ``norm_x``, over the encoder's output).

Layer parameters are stacked along a leading ``n_layers`` axis, as
``blocks.init_stack`` stacks them (``blocks.py:75``); with the worker axis
in front a stacked leaf is ``[K, L, ...]``.  The reference scans the stack
with ``jax.lax.scan`` and hands each layer its window as a *traced* scalar,
so its attention never reaches the Pallas kernel; here the stack is a
Python loop and every layer's window is a Python int or None
(``layer_windows_static``), so every attention layer — self and cross —
launches K4.

The ``ssm`` family's xLSTM layers are heterogeneous (mLSTM and sLSTM),
so, as in the reference, they are a *list* of per-layer dicts
(``init_xlstm_layers``; each leaf ``[K, ...]`` behind the worker axis) run
by an unrolled loop (``apply_xlstm_layers``), never a stack.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import xlstm as xl
from repro_torch.models.attention import attend, init_attention
from repro_torch.models.embeddings import ParamInit, apply_norm, init_norm
from repro_torch.models.mlp import apply_mlp, init_mlp
from repro_torch.models.moe import apply_moe, init_moe
from repro_torch.models.ssm import apply_ssm, init_ssm
from repro_torch.tree import tree_leaves, tree_unflatten

KINDS = ("decoder", "encoder", "xdecoder")
STACK_FAMILIES = ("dense", "moe", "vlm", "hybrid", "audio")


def _check_kind(cfg: ModelConfig, kind: str):
    if cfg.family not in STACK_FAMILIES:
        raise ValueError(
            f"{cfg.family!r} layers are not a stack (the xLSTM layers are a list: "
            f"init_xlstm_layers); stacked: {', '.join(STACK_FAMILIES)}")
    if kind not in KINDS:
        raise ValueError(f"unknown layer kind {kind!r} (want {' | '.join(KINDS)})")


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
    """One layer's parameters (``lead`` = a stack of layers), kind
    ``decoder | encoder | xdecoder`` (``blocks.py:56-75``)."""
    _check_kind(cfg, kind)
    d = cfg.d_model
    p = {"norm1": init_norm(cfg, d, init, lead), "norm2": init_norm(cfg, d, init, lead),
         "attn": init_attention(cfg, init, lead)}
    if kind == "xdecoder":
        p["norm_x"] = init_norm(cfg, d, init, lead)
        p["cross"] = init_attention(cfg, init, lead)
    if cfg.family == "moe" and kind == "decoder":
        p["moe"] = init_moe(cfg, init, lead)
    else:
        p["mlp"] = init_mlp(cfg, init, lead)
    if cfg.family == "hybrid" and kind == "decoder":
        p["ssm"] = init_ssm(cfg, init, lead)
        p["norm_h"] = init_norm(cfg, d, init, lead)
    return p


def init_stack(cfg: ModelConfig, n_layers: int, kind: str, init: ParamInit):
    """``n_layers`` layers with every leaf stacked ``[L, ...]``."""
    return init_layer(cfg, kind, init, lead=(n_layers,))


def xlstm_layer_kinds(cfg: ModelConfig):
    """Per-layer kind, ``"mlstm" | "slstm"``: every ``slstm_every``-th
    layer is an sLSTM, xLSTM[7:1] style (``blocks.py:80-86``)."""
    e = cfg.slstm_every
    return tuple("slstm" if e > 0 and i % e == e - 1 else "mlstm"
                 for i in range(cfg.n_layers))


def init_xlstm_layers(cfg: ModelConfig, init: ParamInit):
    """The xLSTM layers, a list of ``{"norm1", "core"}`` dicts
    (``blocks.py:89-95``)."""
    return [{"norm1": init_norm(cfg, cfg.d_model, init),
             "core": (xl.init_slstm if kind == "slstm" else xl.init_mlstm)(cfg, init)}
            for kind in xlstm_layer_kinds(cfg)]


def apply_layer(cfg: ModelConfig, p, x, positions, window, *, kind: str = "decoder",
                causal: bool = True, enc_out=None, train: bool = False,
                impl: str = "auto", return_kv: bool = False):
    """One block over x [K, B, S, d] (``blocks.py:101-130``).  ``window``:
    int | None.  A hybrid layer averages attention with its SSM branch,
    ``0.5 * (a + s)``; an xdecoder layer adds cross attention over
    ``enc_out [K, B, Se, d]`` after the self-attention residual.  Returns
    (x, aux [K], kv) — aux is the MoE load-balance loss (zeros for the
    other layers), kv the self attention's bf16 (K, V) pair when
    ``return_kv``.  ``train`` picks the MoE dispatch (capacity with drops);
    it changes nothing for the other layers."""
    _check_kind(cfg, kind)
    h = apply_norm(cfg, p["norm1"], x)
    a = attend(cfg, p["attn"], h, positions, window=window, causal=causal,
               impl=impl, return_kv=return_kv)
    kv = None
    if return_kv:
        a, kv = a
    if cfg.family == "hybrid" and "ssm" in p:
        s = apply_ssm(cfg, p["ssm"], apply_norm(cfg, p["norm_h"], x))
        a = 0.5 * (a + s)
    x = x + a
    if "cross" in p:
        hx = apply_norm(cfg, p["norm_x"], x)
        x = x + attend(cfg, p["cross"], hx, positions, window=None, causal=False,
                       x_kv=enc_out, impl=impl)
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
    ``[K, L, B, S, KV, hd]`` when ``return_kv`` (the prefill path).
    ``enc_out``: the encoder's output that xdecoder layers attend to."""
    aux = torch.zeros((x.shape[0],), dtype=torch.float32, device=x.device)
    ks, vs = [], []
    for lp, w in zip(unstack(stacked, len(windows)), windows, strict=True):
        x, a, kv = apply_layer(cfg, lp, x, positions, w, kind=kind, causal=causal,
                               enc_out=enc_out, train=train, impl=impl,
                               return_kv=return_kv)
        aux = aux + a
        if return_kv:
            ks.append(kv[0])
            vs.append(kv[1])
    if return_kv:
        return x, aux, (torch.stack(ks, dim=1), torch.stack(vs, dim=1))
    return x, aux


def apply_xlstm_layers(cfg: ModelConfig, layers, x):
    """The xLSTM layers in turn, each a pre-norm residual block
    (``blocks.py:160-167``).  Returns (hidden, zeros [K]: no aux loss)."""
    for kind, lp in zip(xlstm_layer_kinds(cfg), layers, strict=True):
        h = apply_norm(cfg, lp["norm1"], x)
        core = xl.apply_slstm if kind == "slstm" else xl.apply_mlstm
        x = x + core(cfg, lp["core"], h)
    return x, torch.zeros((x.shape[0],), dtype=torch.float32, device=x.device)
