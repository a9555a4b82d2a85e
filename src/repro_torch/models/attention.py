"""Grouped-query attention: parameter init and the train/prefill apply
(counterpart of ``repro.models.attention``, lines 21-69), the score,
softmax and value contraction delegated to ``kernels.ops.attention`` (K4
on the card).

Activations are ``[K, B, S, d]`` with the worker axis K in front and the
projections are batched matmuls over K; attention itself folds K into its
batch axis, so one K4 launch covers every worker.  The decode half of the
reference module (``init_cache``, ``decode_step``, ``cross_decode``) comes
with serving (ROADMAP Queue 1, item 12).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as kops
from repro_torch.models.embeddings import ParamInit, apply_rope, bcast
from repro_torch.models.mlp import linear


def init_attention(cfg: ModelConfig, init: ParamInit, lead=()):
    d, hd = cfg.d_model, cfg.head_dim
    H, KV = cfg.n_heads, cfg.n_kv_heads
    s = d ** -0.5
    p = {"wq": init.normal(lead + (d, H * hd), s),
         "wk": init.normal(lead + (d, KV * hd), s),
         "wv": init.normal(lead + (d, KV * hd), s),
         "wo": init.normal(lead + (H * hd, d), (H * hd) ** -0.5)}
    if cfg.qkv_bias:
        p["bq"] = init.zeros(lead + (H * hd,))
        p["bk"] = init.zeros(lead + (KV * hd,))
        p["bv"] = init.zeros(lead + (KV * hd,))
    return p


def _project_qkv(cfg: ModelConfig, p, xq, xkv):
    """xq [K, B, Sq, d], xkv [K, B, Skv, d] → q [K, B, Sq, H, hd], k/v
    [K, B, Skv, KV, hd]."""
    q = linear(xq, p["wq"])
    k = linear(xkv, p["wk"])
    v = linear(xkv, p["wv"])
    if cfg.qkv_bias:
        q, k, v = q + bcast(p["bq"], q), k + bcast(p["bk"], k), v + bcast(p["bv"], v)
    q = q.reshape(*xq.shape[:3], cfg.n_heads, cfg.head_dim)
    k = k.reshape(*xkv.shape[:3], cfg.n_kv_heads, cfg.head_dim)
    v = v.reshape(*xkv.shape[:3], cfg.n_kv_heads, cfg.head_dim)
    return q, k, v


def attend(cfg: ModelConfig, p, x, positions, *, window: int | None, causal=True,
           x_kv=None, kv_positions=None, impl="auto", return_kv: bool = False):
    """Train/prefill attention.  ``x``: [K, B, S, d]; ``positions``: [S].
    Returns [K, B, S, d] (and, with ``return_kv``, the rotated K/V
    ``[K, B, S, KV, hd]`` in bf16 for cache emission)."""
    xkv = x if x_kv is None else x_kv
    q, k, v = _project_qkv(cfg, p, x, xkv)
    if x_kv is None:  # self attention gets RoPE
        q = apply_rope(cfg, q, positions)
        k = apply_rope(cfg, k, positions if kv_positions is None else kv_positions)
    K, B, S = q.shape[:3]
    fold = lambda t: t.reshape(K * B, *t.shape[2:])
    o = kops.attention(fold(q), fold(k), fold(v), causal=causal, window=window,
                       impl=impl)
    out = linear(o.reshape(K, B, S, cfg.n_heads * cfg.head_dim), p["wo"])
    if return_kv:
        return out, (k.to(torch.bfloat16), v.to(torch.bfloat16))
    return out
