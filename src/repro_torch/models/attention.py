"""Grouped-query attention: parameter init, the train/prefill apply and
single-token decode against a KV cache (counterpart of
``repro.models.attention``).  Prefill attention is delegated to
``kernels.ops.attention`` (K4 on the card); decode attention is plain
tensor code, as in the reference (one query against the cache).

Activations are ``[K, B, S, d]`` with the worker axis K in front and the
projections are batched matmuls over K; attention itself folds K into its
batch axis, so one K4 launch covers every worker.  Decode serves one
replica (K = 1): x is ``[1, B, 1, d]``, and the caches keep the
reference's layout, with the slot axis at dim 0 and no K axis:

  * full — k/v ``[B, S, KV, hd]`` plus ``pos [B, S]`` (the position held by
    each cache row, -1 = empty);
  * ring — k/v ``[B, W, KV, hd]`` plus ``pos [B, W]``; row = position % W;
  * int8 — k/v stored as int8 with per-(row, head) fp32 scales
    ``k_scale``/``v_scale [B, W, KV]``.

``cross_decode`` (encoder-decoder serving) waits for the audio family.
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


# --------------------------------------------------------------------------
# decode
# --------------------------------------------------------------------------
def init_cache(cfg: ModelConfig, B: int, S: int, *, ring: bool,
               dtype=torch.bfloat16, device="cpu"):
    """A layer's KV cache (``attention.py:74-88``); ``dtype=torch.int8``
    is the quantized variant with per-(row, head) fp32 scales."""
    W = min(S, cfg.window) if ring else S
    shape = (B, W, cfg.n_kv_heads, cfg.head_dim)
    c = {"k": torch.zeros(shape, dtype=dtype, device=device),
         "v": torch.zeros(shape, dtype=dtype, device=device),
         "pos": torch.full((B, W), -1, dtype=torch.int32, device=device)}
    if dtype == torch.int8:
        c["k_scale"] = torch.zeros(shape[:3], dtype=torch.float32, device=device)
        c["v_scale"] = torch.zeros(shape[:3], dtype=torch.float32, device=device)
    return c


def _quantize_kv(x):
    """x [B, KV, hd] -> (int8, scale [B, KV]): max-abs over hd, round half
    to even, as ``jnp.round``."""
    xf = x.to(torch.float32)
    scale = torch.amax(torch.abs(xf), dim=-1) / 127.0 + 1e-12
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127).to(torch.int8)
    return q, scale


def decode_step(cfg: ModelConfig, p, cache, x, positions, *, window: int | None):
    """One-token decode (``attention.py:98-150``).  ``x``: [1, B, 1, d] (one
    replica); ``positions``: [B] int.  Returns (out [1, B, 1, d], new
    cache).  The cache may be a ring (positions past its length wrap);
    masking reads the per-row ``pos``, so stale ring rows and empty rows
    never contribute.  The cache is updated out of place (the reference's
    ``update_cache=False``, which no caller passes, is left out)."""
    B = x.shape[1]
    q, k_new, v_new = _project_qkv(cfg, p, x, x)            # [1, B, 1, ., hd]
    pos_b = positions[:, None]
    q = apply_rope(cfg, q, pos_b)[0, :, 0]                   # [B, H, hd]
    k_new = apply_rope(cfg, k_new, pos_b)[0, :, 0]           # [B, KV, hd]
    v_new = v_new[0, :, 0]

    W = cache["k"].shape[1]
    row = (positions % W).to(torch.int64)
    bidx = torch.arange(B, device=x.device)
    quant = cache["k"].dtype == torch.int8
    new_cache = dict(cache)
    put = lambda t, v: t.index_put((bidx, row), v)
    if quant:
        kq, ks = _quantize_kv(k_new)
        vq, vs = _quantize_kv(v_new)
        k_all, v_all = put(cache["k"], kq), put(cache["v"], vq)
        new_cache["k_scale"] = put(cache["k_scale"], ks)
        new_cache["v_scale"] = put(cache["v_scale"], vs)
    else:
        k_all = put(cache["k"], k_new.to(cache["k"].dtype))
        v_all = put(cache["v"], v_new.to(cache["v"].dtype))
    pos_all = put(cache["pos"], positions.to(torch.int32))

    G = cfg.n_heads // cfg.n_kv_heads
    qg = q.reshape(B, cfg.n_kv_heads, G, cfg.head_dim).to(torch.float32)
    kf, vf = k_all.to(torch.float32), v_all.to(torch.float32)
    if quant:
        kf = kf * new_cache["k_scale"][..., None]
        vf = vf * new_cache["v_scale"][..., None]
    scores = torch.einsum("bkgh,bskh->bkgs", qg, kf) / (cfg.head_dim ** 0.5)
    valid = (pos_all >= 0) & (pos_all <= pos_b)
    if window is not None:
        valid &= pos_all > (pos_b - window)
    scores = torch.where(valid[:, None, None, :], scores, float("-inf"))
    w = torch.softmax(scores, dim=-1)
    o = torch.einsum("bkgs,bskh->bkgh", w, vf)
    o = o.reshape(1, B, 1, cfg.n_heads * cfg.head_dim).to(x.dtype)
    new_cache.update(k=k_all, v=v_all, pos=pos_all)
    return linear(o, p["wo"]), new_cache
