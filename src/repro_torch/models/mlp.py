"""Feed-forward blocks: SwiGLU (Llama-style) and GELU (classic), and the
worker-batched linear map (counterpart of ``repro.models.mlp``).

``jax.nn.gelu`` is the tanh approximation by default, so the GELU branch
uses ``approximate="tanh"``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.embeddings import ParamInit


def linear(x, w):
    """x [K, ..., d_in] @ w [K, d_in, d_out] → [K, ..., d_out]: the K
    replicas as one batched matmul."""
    K, d_in = x.shape[0], x.shape[-1]
    y = torch.matmul(x.reshape(K, -1, d_in), w)
    return y.reshape(*x.shape[:-1], w.shape[-1])


def init_mlp(cfg: ModelConfig, init: ParamInit, lead=(), d_ff: int = 0):
    d = cfg.d_model
    ff = d_ff or cfg.d_ff
    s = d ** -0.5
    if cfg.act == "swiglu":
        return {"w_gate": init.normal(lead + (d, ff), s),
                "w_up": init.normal(lead + (d, ff), s),
                "w_down": init.normal(lead + (ff, d), ff ** -0.5)}
    return {"w_in": init.normal(lead + (d, ff), s),
            "w_out": init.normal(lead + (ff, d), ff ** -0.5)}


def apply_mlp(cfg: ModelConfig, p, x):
    if "w_gate" in p:
        return linear(F.silu(linear(x, p["w_gate"])) * linear(x, p["w_up"]), p["w_down"])
    return linear(F.gelu(linear(x, p["w_in"]), approximate="tanh"), p["w_out"])
