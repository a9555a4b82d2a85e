"""Autoregressive serving (counterpart of ``repro.serving.decode``): the
KV-cache tree, the one-token ``serve_step``, the engine's per-row-masked
``masked_chunk_step`` and the sequential ``prefill``.

The layer loop is unrolled in Python, as in the reference, so per-layer
caches may differ (full ``[B, S, KV, hd]`` caches, ``[B, W, KV, hd]`` rings
for window layers).  The reference's ``lax.scan`` over steps becomes a
Python loop; masking a finished row is a per-row ``torch.where`` on the
device, so no step reads anything back to the host.

These functions serve one replica: the port's parameter tree with K = 1
(what ``params.py`` and ``init_params(...)[None]`` give, and what
``prefill_step`` takes); they raise for K ≠ 1.  Every cache leaf carries
the slot (batch row) axis at dim 0, the contract
``ServingEngine._reset_slot`` enforces.  Ported: the dense and moe
families; ``encode_for_decode`` and the hybrid/ssm states wait for their
families (ROADMAP Queue 1, items 11 and 12).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as A
from repro_torch.models import blocks
from repro_torch.models.embeddings import apply_norm, embed
from repro_torch.models.mlp import apply_mlp
from repro_torch.models.model import LM_FAMILIES, lm_logits
from repro_torch.models.moe import apply_moe
from repro_torch.tree import tree_map


def _check_cfg(cfg: ModelConfig):
    if cfg.family not in LM_FAMILIES or cfg.is_encoder_decoder:
        raise NotImplementedError(
            f"serving the {cfg.family!r} family is not ported yet (ROADMAP "
            "Queue 1 items 11-12); ported: dense and moe")


def _check_replica(params):
    K = params["embed"]["table"].shape[0]
    if K != 1:
        raise ValueError(f"serving takes one replica (K = 1 on every leaf), got K={K}")


def init_cache(cfg: ModelConfig, B: int, S: int, *, use_window: bool = True,
               dtype=torch.bfloat16, device="cpu"):
    """Cache tree for B slots of maximum length S (``decode.py:36-60``):
    ``{"layers": [{"attn": ...}, ...]}``, ring caches for window layers."""
    _check_cfg(cfg)
    wins = blocks.layer_windows_static(cfg, use_window)
    return {"layers": [{"attn": A.init_cache(cfg, B, S, ring=w is not None,
                                             dtype=dtype, device=device)}
                       for w in wins]}


def serve_step(cfg: ModelConfig, params, cache, tokens, positions, *,
               use_window: bool = True, impl: str = "auto"):
    """Decode one token per row (``decode.py:96-149``).  tokens: [B, 1];
    positions: [B].  Returns (logits [B, vocab], score_logit [B] fp32,
    new_cache).  An moe layer dispatches the B tokens by
    ``cfg.moe.dispatch`` (K5 on the card for ``sorted``)."""
    _check_cfg(cfg)
    _check_replica(params)
    x = embed(params["embed"], tokens[None])                     # [1, B, 1, d]
    wins = blocks.layer_windows_static(cfg, use_window)
    new_layers = []
    for lp, lc, w in zip(blocks.unstack(params["layers"], cfg.n_layers),
                         cache["layers"], wins, strict=True):
        h = apply_norm(cfg, lp["norm1"], x)
        a, attn = A.decode_step(cfg, lp["attn"], lc["attn"], h, positions, window=w)
        x = x + a
        h2 = apply_norm(cfg, lp["norm2"], x)
        if "moe" in lp:
            y, _ = apply_moe(cfg, lp["moe"], h2, impl=impl)
        else:
            y = apply_mlp(cfg, lp["mlp"], h2)
        x = x + y
        new_layers.append({"attn": attn})
    h = apply_norm(cfg, params["final_norm"], x)[:, :, 0]         # [1, B, d]
    logits = lm_logits(cfg, params, h)[0]
    sh = params["score_head"]
    score_logit = (torch.bmm(h, sh["w"])[0, :, 0].to(torch.float32)
                   + sh["b"][0, 0])
    return logits, score_logit, {"layers": new_layers}


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
