"""Autoregressive serving (counterpart of ``repro.serving.decode``): the
KV-cache tree, the one-token ``serve_step``, the engine's per-row-masked
``masked_chunk_step``, the sequential ``prefill`` and, for the
encoder-decoder, ``encode_for_decode``.

The layer loop is unrolled in Python, as in the reference, so per-layer
caches may differ: full ``[B, S, KV, hd]`` caches, ``[B, W, KV, hd]`` rings
for window layers, a hybrid layer's O(1) SSM state beside its attention
cache (``{"conv", "h"}``, ``models/ssm.py``), an encoder-decoder layer's
static cross-attention K/V ``enc_k``/``enc_v`` (filled by
``encode_for_decode``) beside a short self cache of ``S //
decoder_fraction``, and an xLSTM layer's O(1) fp32 memory and no
length-S cache at all (``{"mlstm": {"C", "n", "m"}}`` or ``{"slstm": (c,
n, h, m)}``, ``models/xlstm.py``).  The reference's ``lax.scan`` over steps becomes a
Python loop; masking a finished row is a per-row ``torch.where`` on the
device, so no step reads anything back to the host.

These functions serve one replica: the port's parameter tree with K = 1
(what ``params.py`` and ``init_params(...)[None]`` give, and what
``prefill_step`` takes); they raise for K ≠ 1.  Every cache leaf carries
the slot (batch row) axis at dim 0, the contract
``ServingEngine._reset_slot`` enforces.  Every language-model family is
served: dense, moe, vlm (from tokens, as the reference serves it), hybrid,
audio and ssm.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as A
from repro_torch.models import blocks
from repro_torch.models import xlstm as xl
from repro_torch.models.embeddings import apply_norm, embed
from repro_torch.models.mlp import apply_mlp, linear
from repro_torch.models.model import LM_FAMILIES, _encdec_encoder, lm_logits
from repro_torch.models.moe import apply_moe
from repro_torch.models.ssm import decode_ssm, init_ssm_state
from repro_torch.tree import tree_map


def _check_cfg(cfg: ModelConfig):
    if cfg.family not in LM_FAMILIES:
        raise ValueError(f"the {cfg.family!r} family has no decoder to serve; "
                         f"served: {', '.join(LM_FAMILIES)}")


def _check_replica(params):
    K = params["embed"]["table"].shape[0]
    if K != 1:
        raise ValueError(f"serving takes one replica (K = 1 on every leaf), got K={K}")


def init_cache(cfg: ModelConfig, B: int, S: int, *, use_window: bool = True,
               dtype=torch.bfloat16, device="cpu"):
    """Cache tree for B slots of maximum length S (``decode.py:36-61``):
    ``{"layers": [{"attn": ...}, ...]}``, ring caches for window layers,
    each hybrid layer's fp32 SSM state under ``"ssm"``, and each
    encoder-decoder layer's ``enc_k``/``enc_v [B, S, KV, hd]`` with a self
    cache of ``max(1, S // decoder_fraction)`` positions; for the ssm family
    one fp32 xLSTM state a layer, whatever ``dtype`` (``decode.py:39-46``)."""
    _check_cfg(cfg)
    if cfg.family == "ssm":
        return {"layers": [
            {"slstm": xl.init_slstm_state(cfg, B, device=device)} if kind == "slstm"
            else {"mlstm": xl.init_mlstm_state(cfg, B, device=device)}
            for kind in blocks.xlstm_layer_kinds(cfg)]}
    S_self = max(1, S // cfg.decoder_fraction) if cfg.is_encoder_decoder else S
    layers = []
    for w in blocks.layer_windows_static(cfg, use_window):
        lc = {"attn": A.init_cache(cfg, B, S_self, ring=w is not None, dtype=dtype,
                                   device=device)}
        if cfg.family == "hybrid":
            lc["ssm"] = init_ssm_state(cfg, B, device=device)
        if cfg.is_encoder_decoder:
            shape = (B, S, cfg.n_kv_heads, cfg.head_dim)
            lc["enc_k"] = torch.zeros(shape, dtype=dtype, device=device)
            lc["enc_v"] = torch.zeros(shape, dtype=dtype, device=device)
        layers.append(lc)
    return {"layers": layers}


def cache_specs(cfg: ModelConfig, B: int, S: int, *, use_window: bool = True,
                dtype=torch.bfloat16):
    """``init_cache``'s tree on the meta device: shapes and dtypes, nothing
    allocated (``decode.py:64-68``)."""
    return init_cache(cfg, B, S, use_window=use_window, dtype=dtype, device="meta")


def encode_for_decode(cfg: ModelConfig, params, cache, frames, *, impl: str = "auto"):
    """Encoder-decoder: run the encoder over frames [B, Se, d] (one
    replica) and fill every decoder layer's cross-attention K/V
    (``decode.py:71-93``).  The other cache leaves are carried over."""
    _check_replica(params)
    enc, _ = _encdec_encoder(cfg, params, frames[None], impl=impl)   # [1, B, Se, d]
    B, Se = enc.shape[1:3]
    new_layers = []
    for lp, lc in zip(blocks.unstack(params["layers"], cfg.n_layers), cache["layers"],
                      strict=True):
        lc = dict(lc)
        cp = lp["cross"]
        kv = []
        for w, b in (("wk", "bk"), ("wv", "bv")):
            t = linear(enc, cp[w]).reshape(B, Se, cfg.n_kv_heads, cfg.head_dim)
            if cfg.qkv_bias:
                t = t + cp[b].reshape(1, 1, cfg.n_kv_heads, -1)
            kv.append(t)
        lc["enc_k"] = kv[0].to(lc["enc_k"].dtype)
        lc["enc_v"] = kv[1].to(lc["enc_v"].dtype)
        new_layers.append(lc)
    return {"layers": new_layers}


def serve_step(cfg: ModelConfig, params, cache, tokens, positions, *,
               use_window: bool = True, impl: str = "auto"):
    """Decode one token per row (``decode.py:96-149``).  tokens: [B, 1];
    positions: [B].  Returns (logits [B, vocab], score_logit [B] fp32,
    new_cache).  A hybrid layer averages its attention with the SSM step,
    an xdecoder layer adds cross attention against its ``enc_k``/``enc_v``,
    and an moe layer dispatches the B tokens by ``cfg.moe.dispatch`` (K5 on
    the card for ``sorted``); an xLSTM layer steps its recurrent state and
    ignores ``positions`` (``decode.py:104-115``)."""
    _check_cfg(cfg)
    _check_replica(params)
    x = embed(params["embed"], tokens[None])                     # [1, B, 1, d]
    if cfg.family == "ssm":
        x, new_layers = _xlstm_step(cfg, params, cache, x)
    else:
        x, new_layers = _stack_step(cfg, params, cache, x, positions, use_window, impl)
    h = apply_norm(cfg, params["final_norm"], x)[:, :, 0]         # [1, B, d]
    logits = lm_logits(cfg, params, h)[0]
    sh = params["score_head"]
    score_logit = (torch.bmm(h, sh["w"])[0, :, 0].to(torch.float32)
                   + sh["b"][0, 0])
    return logits, score_logit, {"layers": new_layers}


def _xlstm_step(cfg: ModelConfig, params, cache, x):
    new_layers = []
    for kind, lp, lc in zip(blocks.xlstm_layer_kinds(cfg), params["layers"],
                            cache["layers"], strict=True):
        h = apply_norm(cfg, lp["norm1"], x)
        step = xl.decode_slstm if kind == "slstm" else xl.decode_mlstm
        o, st = step(cfg, lp["core"], lc[kind], h)
        new_layers.append({kind: st})
        x = x + o
    return x, new_layers


def _stack_step(cfg: ModelConfig, params, cache, x, positions, use_window, impl):
    wins = blocks.layer_windows_static(cfg, use_window)
    new_layers = []
    for lp, lc, w in zip(blocks.unstack(params["layers"], cfg.n_layers),
                         cache["layers"], wins, strict=True):
        nc = {}
        h = apply_norm(cfg, lp["norm1"], x)
        a, nc["attn"] = A.decode_step(cfg, lp["attn"], lc["attn"], h, positions, window=w)
        if cfg.family == "hybrid":
            s, nc["ssm"] = decode_ssm(cfg, lp["ssm"], lc["ssm"],
                                      apply_norm(cfg, lp["norm_h"], x))
            a = 0.5 * (a + s)
        x = x + a
        if cfg.is_encoder_decoder:
            hx = apply_norm(cfg, lp["norm_x"], x)
            x = x + A.cross_decode(cfg, lp["cross"], lc["enc_k"], lc["enc_v"], hx)
            nc["enc_k"], nc["enc_v"] = lc["enc_k"], lc["enc_v"]
        h2 = apply_norm(cfg, lp["norm2"], x)
        if "moe" in lp:
            y, _ = apply_moe(cfg, lp["moe"], h2, impl=impl)
        else:
            y = apply_mlp(cfg, lp["mlp"], h2)
        x = x + y
        new_layers.append(nc)
    return x, new_layers


def masked_chunk_step(cfg: ModelConfig, params, cache, tokens, positions,
                      n_tokens, *, use_window: bool = True, impl: str = "auto"):
    """Feed each row up to C tokens (``decode.py:152-193``): tokens [B, C]
    int, positions [B] (row s's first token lands at positions[s]),
    n_tokens [B] (live steps of row s; 0 = idle).  Step t runs
    ``serve_step`` for every row; rows with t ≥ n_tokens keep their cache
    bitwise.  Returns (cache, argmax tokens [B, C] int32, score logits
    [B, C] fp32); outputs of dead steps are garbage for the caller to
    ignore."""
    B, C = tokens.shape
    toks, scores = [], []
    for t in range(C):
        live = t < n_tokens
        logits, score, new_cache = serve_step(
            cfg, params, cache, tokens[:, t:t + 1], positions + t,
            use_window=use_window, impl=impl)
        cache = tree_map(lambda n, o: torch.where(
            live.reshape((B,) + (1,) * (n.dim() - 1)), n, o), new_cache, cache)
        toks.append(torch.argmax(logits, dim=-1).to(torch.int32))
        scores.append(score.to(torch.float32))
    return cache, torch.stack(toks, dim=1), torch.stack(scores, dim=1)


def prefill(cfg: ModelConfig, params, cache, tokens, *, use_window: bool = True,
            impl: str = "auto"):
    """Sequential prefill through ``serve_step`` (``decode.py:196-222``):
    tokens [B, S0].  Returns (cache, the last token's logits [B, vocab] in
    fp32)."""
    B, S0 = tokens.shape
    pos = lambda t: torch.full((B,), t, dtype=torch.int32, device=tokens.device)
    for t in range(S0 - 1):
        _, _, cache = serve_step(cfg, params, cache, tokens[:, t:t + 1], pos(t),
                                 use_window=use_window, impl=impl)
    logits, _, cache = serve_step(cfg, params, cache, tokens[:, S0 - 1:], pos(S0 - 1),
                                  use_window=use_window, impl=impl)
    return cache, logits.to(torch.float32)
