"""Top-level model for the ported families ``mlp``, ``cnn``, ``dense``,
``moe``, ``vlm``, ``hybrid`` and ``audio`` (counterpart of
``repro.models.model``).

``score(cfg, params, batch)`` is the scoring function h(w; x) ∈ [0, 1]
that CoDA maximizes AUC for: backbone → (mean-pool over the sequence) →
linear → sigmoid.  ``prefill_step`` is the inference prefill (scores,
last-position logits, stacked KV caches), ``lm_logits`` the LM head and
``count_params`` the parameter count from shapes alone.
Every parameter leaf carries a leading worker axis K and every input a
leading ``[K, B]``: the K replicas run as batched matmuls (mlp and the
transformers) or one grouped convolution (cnn), and attention folds K into
its batch.  The public layouts are the reference's: weights ``[d_in,
d_out]``, layers stacked ``[L, ...]`` behind K, images ``[K, B, hw·hw,
3]``, tokens ``[K, B, S]``, an moe layer's experts ``[K, L, E, d, ff]``,
a vlm's patch embeddings ``[K, B, n_patches, d]`` (projected and put in
front of the tokens), an audio model's frames ``[K, B, Se, d]`` (encoded,
then attended to by every decoder layer).  The ``ssm`` family (xLSTM)
arrives with ROADMAP Queue 1 item 11d.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import blocks, resnet
from repro_torch.models.embeddings import ParamInit, apply_norm, embed, init_embed, init_norm
from repro_torch.models.mlp import linear
from repro_torch.tree import tree_leaves

FAMILIES = ("mlp", "cnn", "dense", "moe", "vlm", "hybrid", "audio")
# the transformer families: token inputs, a layer stack, an LM head
LM_FAMILIES = ("dense", "moe", "vlm", "hybrid", "audio")


def _check_family(cfg: ModelConfig):
    if cfg.family not in FAMILIES:
        raise NotImplementedError(f"model family {cfg.family!r} is not ported "
                                  "yet (ROADMAP Queue 1 item 11d, model zoo)")


def init_params(cfg: ModelConfig, *, generator: torch.Generator | None = None,
                dtype=torch.float32, device="cpu"):
    """One replica's parameters (no K axis), drawn from ``generator`` with
    the reference's initialisers, then moved to ``device``.  mlp and cnn
    draw on the CPU; the transformer families (dense, moe) draw on the
    generator's device (a CUDA generator keeps a full-width model off the
    host).  The numbers differ from ``jax.random``'s; carry the reference's
    weights across with ``params.py`` to compare the two."""
    _check_family(cfg)
    gen = generator if generator is not None else torch.Generator().manual_seed(0)
    d = cfg.d_model
    randn = lambda *shape: torch.randn(shape, generator=gen, dtype=torch.float32)
    p = {}
    if cfg.family in LM_FAMILIES:
        init = ParamInit(gen, dtype, device)
        p["embed"] = init_embed(cfg.vocab_size, d, init)
        p["layers"] = blocks.init_stack(
            cfg, cfg.n_layers, "xdecoder" if cfg.is_encoder_decoder else "decoder", init)
        if cfg.is_encoder_decoder:
            p["encoder"] = blocks.init_stack(cfg, cfg.encoder_layers, "encoder", init)
            p["enc_norm"] = init_norm(cfg, d, init)
            p["enc_in"] = init.normal((d, d), d ** -0.5)
        if cfg.family == "vlm":
            p["projector"] = init.normal((d, d), d ** -0.5)
        p["final_norm"] = init_norm(cfg, d, init)
        p["score_head"] = {"w": init.normal((d, 1), d ** -0.5),
                           "b": init.zeros((1,), torch.float32)}
        if not cfg.tie_embeddings:
            p["lm_head"] = init.normal((d, cfg.vocab_size), d ** -0.5)
        return p
    if cfg.family == "cnn":
        p["backbone"] = resnet.init_resnet(cfg, generator=gen, dtype=dtype,
                                           device=device)
    else:
        dims = [cfg.n_features] + [d] * cfg.n_layers
        p["mlp"] = [{"w": (randn(di, do) * di ** -0.5).to(dtype=dtype, device=device),
                     "b": torch.zeros((do,), dtype=dtype, device=device)}
                    for di, do in zip(dims[:-1], dims[1:])]
    p["score_head"] = {
        "w": (randn(d, 1) * d ** -0.5).to(dtype=dtype, device=device),
        # the score bias stays fp32 whatever param_dtype is (model.py:62)
        "b": torch.zeros((1,), dtype=torch.float32, device=device)}
    return p


def backbone(cfg: ModelConfig, params, batch, *, use_window: bool = False,
             train: bool = False, impl: str = "auto"):
    """Returns (hidden, moe_aux [K]: the load-balance loss summed over the
    layers, zeros outside the moe family).  Hidden is ``[K, B, S, d]`` for
    the transformer families (S: a vlm's patches and tokens, an
    encoder-decoder's target tokens) and ``[K, B, d]`` for mlp and cnn
    (the reference keeps a length-1 sequence axis there that its mean-pool
    removes; here it is left out, and ``use_window``/``train``/``impl``
    change nothing)."""
    _check_family(cfg)
    if cfg.family == "audio":
        return _encdec(cfg, params, batch, train=train, impl=impl)
    if cfg.family in LM_FAMILIES:
        x = _embed_inputs(cfg, params, batch)
        S = x.shape[2]
        positions = torch.arange(S, device=x.device)
        windows = blocks.layer_windows_static(cfg, use_window)
        h, aux = blocks.apply_stack(cfg, params["layers"], x, positions, windows,
                                    train=train, impl=impl)
        return apply_norm(cfg, params["final_norm"], h), aux
    if cfg.family == "cnn":
        images = batch["images"]
        K, B, s, _ = images.shape
        hw = int(round(s ** 0.5))
        x = resnet.apply_resnet(cfg, params["backbone"],
                                images.reshape(K, B, hw, hw, 3))
    else:
        x = batch["features"]
        for lp in params["mlp"]:
            x = torch.relu(linear(x, lp["w"]) + lp["b"][:, None, :])
    return x, torch.zeros((x.shape[0],), dtype=torch.float32, device=x.device)


def _embed_inputs(cfg: ModelConfig, params, batch):
    """The decoder stack's input [K, B, S, d]: the token embeddings, behind
    the projected patch embeddings for vlm (``model.py:87-90``; fp32 patches
    against bf16 weights project in fp32, then join the tokens' dtype)."""
    tok = embed(params["embed"], batch["tokens"])
    if cfg.family != "vlm":
        return tok
    patches = linear(batch["patches"], params["projector"])
    return torch.cat([patches.to(tok.dtype), tok], dim=2)


def _encdec_encoder(cfg: ModelConfig, params, frames, *, train: bool = False,
                    impl: str = "auto"):
    """The audio encoder (``model.py:105-115``): frames [K, B, Se, d] →
    ``enc_in`` → ``encoder_layers`` non-causal layers → ``enc_norm``.
    Returns (enc [K, B, Se, d], aux [K])."""
    x = linear(frames, params["enc_in"])
    positions = torch.arange(x.shape[2], device=x.device)
    enc, aux = blocks.apply_stack(cfg, params["encoder"], x, positions,
                                  [None] * cfg.encoder_layers, kind="encoder",
                                  causal=False, train=train, impl=impl)
    return apply_norm(cfg, params["enc_norm"], enc), aux


def _encdec(cfg: ModelConfig, params, batch, *, train: bool, impl: str,
            return_kv: bool = False):
    """The encoder, then the causal xdecoder stack over the tokens
    attending to it (``model.py:118-129``), then ``final_norm``.  Returns
    (hidden [K, B, Sd, d], aux [K]) and, with ``return_kv``, the decoder's
    self-attention caches."""
    enc, aux_e = _encdec_encoder(cfg, params, batch["frames"], train=train, impl=impl)
    tok = embed(params["embed"], batch["tokens"])
    positions = torch.arange(tok.shape[2], device=tok.device)
    out = blocks.apply_stack(cfg, params["layers"], tok, positions, [None] * cfg.n_layers,
                             kind="xdecoder", causal=True, enc_out=enc, train=train,
                             impl=impl, return_kv=return_kv)
    h = apply_norm(cfg, params["final_norm"], out[0])
    return (h, aux_e + out[1]) + tuple(out[2:])


def score_logit(sh, pooled):
    """pooled @ w + b with the bias added in fp32 (``model.py:132-140``):
    pooled [K, B, d] → [K, B] fp32."""
    return linear(pooled, sh["w"])[..., 0].to(torch.float32) + sh["b"][:, :1]


def _score_head(sh, pooled):
    """sigmoid of ``score_logit``: pooled [K, B, d] → [K, B]."""
    return torch.sigmoid(score_logit(sh, pooled))


def score(cfg: ModelConfig, params, batch, *, use_window: bool = False,
          train: bool = False, impl: str = "auto"):
    """h(w; x) ∈ [0,1] per example.  Returns (scores [K, B], moe_aux [K]).
    The transformer families mean-pool their hidden states over the
    sequence."""
    h, aux = backbone(cfg, params, batch, use_window=use_window, train=train,
                      impl=impl)
    pooled = torch.mean(h, dim=2) if h.dim() == 4 else h
    return _score_head(params["score_head"], pooled), aux


def prefill_step(cfg: ModelConfig, params, batch, *, use_window: bool = False,
                 impl: str = "auto"):
    """Inference prefill (``model.py:143-182``): forward the whole prompt
    batch (``tokens [K, B, S]``, with ``patches`` for vlm and ``frames``
    for audio), emitting the scores [K, B], the last-position logits
    [K, B, vocab] and the stacked per-layer bf16 KV caches of the decoder's
    self attention ``([K, L, B, S, KV, hd], same)``.  mlp and cnn have no
    caches and no vocabulary: (scores, None, None)."""
    _check_family(cfg)
    if cfg.family not in LM_FAMILIES:
        s, _ = score(cfg, params, batch, use_window=use_window, impl=impl)
        return s, None, None
    if cfg.family == "audio":
        h, _, kv = _encdec(cfg, params, batch, train=False, impl=impl, return_kv=True)
    else:
        x = _embed_inputs(cfg, params, batch)
        S = x.shape[2]
        positions = torch.arange(S, device=x.device)
        windows = blocks.layer_windows_static(cfg, use_window)
        h, _, kv = blocks.apply_stack(cfg, params["layers"], x, positions, windows,
                                      impl=impl, return_kv=True)
        h = apply_norm(cfg, params["final_norm"], h)
    logits = lm_logits(cfg, params, h[:, :, -1])
    return _score_head(params["score_head"], torch.mean(h, dim=2)), logits, kv


def lm_logits(cfg: ModelConfig, params, hidden):
    """hidden [K, ..., d] → logits [K, ..., vocab] through the LM head (the
    embedding table's transpose when tied)."""
    if cfg.tie_embeddings or "lm_head" not in params:
        return linear(hidden, params["embed"]["table"].transpose(1, 2))
    return linear(hidden, params["lm_head"])


def count_params(cfg: ModelConfig, active_only: bool = False) -> int:
    """The number of parameters of one replica (``model.py:194-204``), from
    the shapes of ``init_params`` on the meta device (nothing allocated, for
    the LM families); ``active_only`` leaves out the experts a token does
    not reach (top_k of n_experts)."""
    total = sum(t.numel() for t in tree_leaves(init_params(cfg, device="meta")))
    if active_only and cfg.moe is not None:
        m = cfg.moe
        expert_params = 3 * m.n_experts * cfg.d_model * cfg.d_ff * cfg.n_layers
        total -= int(expert_params * (1 - m.top_k / m.n_experts))
    return int(total)

