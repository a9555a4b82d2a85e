"""Feed-forward blocks: SwiGLU (Llama-style) and GELU (classic), and the
worker-batched linear map (counterpart of ``repro.models.mlp``).

``jax.nn.gelu`` is the tanh approximation by default; ``gelu`` and
``silu`` compute jax's formulas op by op, as XLA rounds them in bf16.
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.embeddings import ParamInit


def linear(x, w):
    """x [K, ..., d_in] @ w [K, d_in, d_out] → [K, ..., d_out]: the K
    replicas as one batched matmul.  Mixed dtypes compute in the promoted
    one, as jnp's ``x @ w`` does: fp32 patches or frames against bf16
    weights (``model.py:88,106``), and the audio encoder's fp32 activations
    after them, stay fp32."""
    K, d_in = x.shape[0], x.shape[-1]
    dt = torch.promote_types(x.dtype, w.dtype)
    y = torch.matmul(x.reshape(K, -1, d_in).to(dt), w.to(dt))
    return y.reshape(*x.shape[:-1], w.shape[-1])


def silu(x):
    """``jax.nn.silu`` as XLA computes it: x · 1/(1 + exp(−x)), each
    operation rounded in x's dtype.  In bf16 that rounds exp(−x), the sum
    and the reciprocal to bf16 in turn (XLA's bf16 ``logistic``), where
    ``F.silu`` rounds once: the two differ by up to 2 bf16 ulps on about a
    third of the elements (tests/test_torch_bf16_probe.py)."""
    return x * (1 / (1 + torch.exp(-x)))


def gelu(x):
    """``jax.nn.gelu`` (its tanh form, the default) as XLA computes it:
    x · 0.5·(1 + tanh(√(2/π)·(x + 0.044715·x³))), each operation rounded in
    x's dtype and the constants too (jnp makes a Python scalar take the
    array's dtype; torch would multiply by it in fp32).  In bf16 this is
    bitwise the reference's; ``F.gelu`` rounds once and differs on ~38 %
    of the elements (tests/test_torch_bf16_probe.py)."""
    k = lambda v: torch.tensor(v, dtype=x.dtype, device=x.device)
    inner = k(math.sqrt(2 / math.pi)) * (x + k(0.044715) * (x * x * x))
    return x * (0.5 * (1.0 + torch.tanh(inner)))


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
        return linear(silu(linear(x, p["w_gate"])) * linear(x, p["w_up"]), p["w_down"])
    return linear(gelu(linear(x, p["w_in"])), p["w_out"])
