"""Token embeddings, normalisation layers and rotary position embeddings
(counterpart of ``repro.models.embeddings``).

Every parameter leaf carries a leading worker axis K, and so does every
activation: ``x`` is ``[K, ..., d]``, a norm's ``scale`` is ``[K, d]``, an
embedding table ``[K, vocab, d]``.  The arithmetic is the reference's.

RoPE variants (``cfg.rope``):
  * ``1d``         — full-head rotation, half-split pairing (x_i, x_{i+n/2});
  * ``partial``    — only the first ``rope_fraction`` of head_dim rotates
                     (StableLM-2: 25 %), half-split pairing;
  * ``2d-partial`` — ChatGLM: the first half rotates with interleaved pairs
                     (x0, x1), (x2, x3), …; the second half passes through;
  * ``none``       — no rotation.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig


class ParamInit:
    """The reference's initialisers, drawn from one ``torch.Generator`` on
    the generator's device, then moved to ``device`` in ``dtype``.  ``lead``
    shapes (a stack of layers) are drawn in one call; on the ``meta`` device
    only the shapes are made.  The numbers differ
    from ``jax.random``'s; carry the reference's weights across with
    ``params.py`` to compare the two."""

    def __init__(self, generator: torch.Generator, dtype=torch.float32,
                 device="cpu"):
        self.gen, self.dtype, self.device = generator, dtype, torch.device(device)

    def normal(self, shape, scale: float, dtype=None):
        dtype = dtype or self.dtype
        if self.device.type == "meta":   # shapes only: nothing is drawn
            return torch.empty(tuple(shape), dtype=dtype, device=self.device)
        x = torch.randn(tuple(shape), generator=self.gen, dtype=torch.float32,
                        device=self.gen.device)
        return x.mul_(scale).to(dtype=dtype, device=self.device)

    def zeros(self, shape, dtype=None):
        return torch.zeros(tuple(shape), dtype=dtype or self.dtype, device=self.device)

    def ones(self, shape, dtype=None):
        return torch.ones(tuple(shape), dtype=dtype or self.dtype, device=self.device)


def bcast(p, x):
    """A per-worker vector ``p [K, n]`` shaped to broadcast against
    ``x [K, ..., n]``."""
    return p.reshape(p.shape[0], *([1] * (x.dim() - 2)), p.shape[-1])


# --------------------------------------------------------------------------
# norms
# --------------------------------------------------------------------------
def init_norm(cfg: ModelConfig, d: int, init: ParamInit, lead=()):
    """fp32 whatever the parameter dtype (``embeddings.py:24-28``)."""
    p = {"scale": init.ones(lead + (d,), torch.float32)}
    if cfg.norm == "layernorm":
        p["bias"] = init.zeros(lead + (d,), torch.float32)
    return p


def apply_norm(cfg: ModelConfig, p, x, eps: float = 1e-5):
    """LayerNorm (with a bias) or RMSNorm in fp32, back in x's dtype."""
    dt = x.dtype
    x = x.to(torch.float32)
    if cfg.norm == "layernorm":
        mu = torch.mean(x, dim=-1, keepdim=True)
        var = torch.mean(torch.square(x - mu), dim=-1, keepdim=True)
        y = (x - mu) * torch.rsqrt(var + eps) * bcast(p["scale"], x) + bcast(p["bias"], x)
    else:  # rmsnorm
        ms = torch.mean(torch.square(x), dim=-1, keepdim=True)
        y = x * torch.rsqrt(ms + eps) * bcast(p["scale"], x)
    return y.to(dt)


# --------------------------------------------------------------------------
# rotary embeddings
# --------------------------------------------------------------------------
def rope_dims(cfg: ModelConfig) -> int:
    """Number of head dimensions that get rotated (even)."""
    if cfg.rope == "none":
        return 0
    n = int(cfg.head_dim * cfg.rope_fraction)
    return n - (n % 2)


def _angles(positions, n_rot: int, base: float):
    # positions: [...]; returns [..., n_rot // 2]
    exps = torch.arange(0, n_rot, 2, dtype=torch.float32, device=positions.device) / n_rot
    inv = 1.0 / (base ** exps)
    return positions.to(torch.float32)[..., None] * inv


def apply_rope(cfg: ModelConfig, x, positions):
    """x: [..., S, n_heads, head_dim]; positions: broadcastable to [..., S]."""
    n_rot = rope_dims(cfg)
    if n_rot == 0:
        return x
    ang = _angles(positions, n_rot, cfg.rope_base)          # [..., S, n_rot/2]
    cos = torch.cos(ang)[..., None, :].to(x.dtype)          # [..., S, 1, n_rot/2]
    sin = torch.sin(ang)[..., None, :].to(x.dtype)
    rot, rest = x[..., :n_rot], x[..., n_rot:]
    if cfg.rope == "2d-partial":
        # interleaved pairing (x0,x1),(x2,x3),... — ChatGLM convention
        x1, x2 = rot[..., 0::2], rot[..., 1::2]
        r1 = x1 * cos - x2 * sin
        r2 = x2 * cos + x1 * sin
        rot = torch.stack([r1, r2], dim=-1).reshape(rot.shape)
    else:
        # half-split pairing (x_i, x_{i+n/2}) — Llama convention
        half = n_rot // 2
        x1, x2 = rot[..., :half], rot[..., half:]
        rot = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return torch.cat([rot, rest], dim=-1) if rest.shape[-1] else rot


# --------------------------------------------------------------------------
# embeddings
# --------------------------------------------------------------------------
def init_embed(vocab: int, d: int, init: ParamInit):
    return {"table": init.normal((vocab, d), d ** -0.5)}


def embed(p, tokens):
    """tokens [K, ...] (integers) → [K, ..., d]: worker k looks its tokens
    up in its own table ``p["table"][k]`` (one embedding over the K tables
    laid end to end)."""
    table = p["table"]
    K, V, d = table.shape
    offs = (torch.arange(K, device=tokens.device) * V).reshape(K, *([1] * (tokens.dim() - 1)))
    return F.embedding(tokens.to(torch.int64) + offs, table.reshape(K * V, d))
