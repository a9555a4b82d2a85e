"""Mamba-style selective state-space layer, Hymba's SSM branch (counterpart
of ``repro.models.ssm``).

Train and prefill run the linear recurrence h_t = dA_t·h_{t-1} + dBx_t over
the whole sequence at once; decode keeps an O(1) recurrent state
``{"conv": [B, ssm_conv - 1, di], "h": [B, di, N]}`` (slot axis at dim 0,
no worker axis, as the serving caches).

The reference runs the recurrence as ``jax.lax.associative_scan`` over S on
``[B, S, di, N]`` fp32 (``ssm.py:79``).  torch has no such scan, so
``linear_scan`` is a chunked scan in plain tensor code: S as chunks of
about √S positions, each chunk's recurrence run step by step (all chunks
at once), then the carries across the chunk ends (``_scan0``).  A log-depth
doubling scan would make ⌈log₂ S⌉ passes over the ``[.., S, di, N]``
tensors; this one makes about four, in about 4√S launches.  The products
come in another order than the reference's, so the two agree to fp32
rounding (``tests/test_torch_hybrid.py`` states the tolerance).  Its
backward is the same scan run from the end (g_t = ∂h_t + dA_{t+1}·g_{t+1};
∂dBx = g, ∂dA_t = g_t·h_{t-1}), so autograd saves dA and h and none of the
scan's intermediates.

Activations are ``[K, B, S, d]`` with the worker axis in front, and every
leaf ``[K, ...]``; ``A_log`` and ``D`` stay fp32 whatever the parameter
dtype, and the recurrence runs in fp32, as in the reference.  Products of
fp32 activations with bf16 weights compute in fp32 (jnp's promotion, which
the decode step's fp32 conv state meets under bf16 parameters).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.embeddings import ParamInit
from repro_torch.models.mlp import linear, silu


def _dims(cfg: ModelConfig):
    di = cfg.ssm_expand * cfg.d_model
    N = cfg.ssm_state
    dt_rank = max(1, math.ceil(cfg.d_model / 16))
    return di, N, dt_rank


def init_ssm(cfg: ModelConfig, init: ParamInit, lead=()):
    """The reference's ``init_ssm`` leaves (``ssm.py:25-39``), each with
    ``lead`` in front: ``dt_bias = log(expm1(0.01))`` in the parameter
    dtype, ``A_log = log([1 .. N])`` per channel and ``D = 1`` in fp32."""
    d = cfg.d_model
    di, N, dt_rank = _dims(cfg)
    dev = init.device
    dt_bias = torch.log(torch.expm1(torch.full(lead + (di,), 0.01, dtype=torch.float32,
                                               device=dev)))
    A_log = torch.log(torch.arange(1, N + 1, dtype=torch.float32, device=dev)
                      .expand(lead + (di, N)).contiguous())
    return {
        "in_proj": init.normal(lead + (d, 2 * di), d ** -0.5),
        "conv_w": init.normal(lead + (cfg.ssm_conv, di), 0.2),
        "conv_b": init.zeros(lead + (di,)),
        "x_proj": init.normal(lead + (di, dt_rank + 2 * N), di ** -0.5),
        "dt_proj": init.normal(lead + (dt_rank, di), dt_rank ** -0.5),
        "dt_bias": dt_bias.to(init.dtype),
        "A_log": A_log,
        "D": init.ones(lead + (di,), torch.float32),
        "out_proj": init.normal(lead + (di, d), di ** -0.5),
    }


def softplus(x):
    """``jax.nn.softplus`` = logaddexp(x, 0) = max(x, 0) + log1p(exp(-|x|)),
    written as the reference writes it: ``F.softplus`` returns x itself past
    its threshold of 20 and log1p(exp(x)) below it, which round otherwise."""
    return torch.clamp_min(x, 0) + torch.log1p(torch.exp(-torch.abs(x)))


def _vec(p, x):
    """A per-worker leaf ``p [K, *t]`` shaped to broadcast against
    ``x [K, ..., *t]``."""
    return p.reshape(p.shape[0], *([1] * (x.dim() - p.dim())), *p.shape[1:])


def _causal_conv(p, xi):
    """Depthwise causal convolution over xi [K, B, S, di]: the taps summed
    in the reference's order (``ssm.py:42-47``)."""
    Kc = p["conv_w"].shape[1]
    S = xi.shape[2]
    pad = F.pad(xi, (0, 0, Kc - 1, 0))
    w = p["conv_w"]
    out = sum(pad[:, :, k:k + S] * _vec(w[:, k], pad) for k in range(Kc))
    return out + _vec(p["conv_b"], out)


def _ssm_inputs(cfg: ModelConfig, p, xi):
    """The recurrence's inputs from xi [K, ..., di]: dA and dBx
    [K, ..., di, N] in fp32, and Cc [K, ..., N] (``ssm.py:50-65``)."""
    di, N, dt_rank = _dims(cfg)
    proj = linear(xi, p["x_proj"])
    dt = softplus(linear(proj[..., :dt_rank], p["dt_proj"]) + _vec(p["dt_bias"], xi))
    Bc = proj[..., dt_rank:dt_rank + N]
    Cc = proj[..., dt_rank + N:]
    A = -torch.exp(p["A_log"])                               # [K, di, N] fp32
    dt = dt.to(torch.float32)
    dA = torch.exp(dt[..., None] * _vec(A, dt[..., None]))
    dBx = ((dt * xi.to(torch.float32))[..., None]
           * Bc.to(torch.float32)[..., None, :])
    return dA, dBx, Cc


def _scan0(a, b):
    """h_t = a_t·h_{t-1} + b_t along dim 0 from h_{-1} = 0, chunked: the S
    positions as n chunks of C ≈ √S; a sequential pass over the C
    positions of every chunk at once (the local recurrence and the
    cumulative product of a), a sequential pass over the n chunk ends (the
    carries), then one pass adding each chunk's incoming carry.  About
    2C + 2n launches and four passes over memory."""
    S, rest = a.shape[0], a.shape[1:]
    C = max(1, round(math.sqrt(S)))
    n = -(-S // C)
    if n * C != S:      # pad the end: positions after S change nothing before it
        a = torch.cat([a, a.new_ones((n * C - S,) + rest)])
        b = torch.cat([b, b.new_zeros((n * C - S,) + rest)])
    a, b = a.reshape((n, C) + rest), b.reshape((n, C) + rest)
    h, P = torch.empty_like(b), torch.empty_like(a)
    h[:, 0], P[:, 0] = b[:, 0], a[:, 0]
    for j in range(1, C):
        torch.addcmul(b[:, j], a[:, j], h[:, j - 1], out=h[:, j])
        torch.mul(a[:, j], P[:, j - 1], out=P[:, j])
    carry = h[:, C - 1].clone()
    for i in range(1, n):
        carry[i].addcmul_(P[i, C - 1], carry[i - 1])
    h[1:].addcmul_(P[1:], carry[:-1, None])
    return h.reshape((n * C,) + rest)[:S]


class _LinearScan(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b, dim):
        h = _scan0(a.movedim(dim, 0), b.movedim(dim, 0)).movedim(0, dim)
        ctx.save_for_backward(a, h)
        ctx.dim = dim
        return h

    @staticmethod
    def backward(ctx, gh):
        a, h = ctx.saved_tensors
        a0, h0, g0 = a.movedim(ctx.dim, 0), h.movedim(ctx.dim, 0), gh.movedim(ctx.dim, 0)
        # g_t = ∂h_t + a_{t+1}·g_{t+1}: the same scan from the end, a shifted by one
        c = torch.cat([a0[1:], a0.new_zeros((1,) + a0.shape[1:])])
        g = _scan0(c.flip(0), g0.flip(0)).flip(0)
        del c
        da = torch.cat([torch.zeros_like(g[:1]), g[1:] * h0[:-1]])
        return da.movedim(0, ctx.dim), g.movedim(0, ctx.dim), None


def linear_scan(a, b, dim: int):
    """h_t = a_t·h_{t-1} + b_t along ``dim`` from h_{-1} = 0: what the
    reference's ``associative_scan`` with its ``combine`` returns as its
    second output.  Differentiable in a and b."""
    return _LinearScan.apply(a, b, dim)


def apply_ssm(cfg: ModelConfig, p, x):
    """x [K, B, S, d] → [K, B, S, d] (``ssm.py:68-84``)."""
    xz = linear(x, p["in_proj"])
    xi, z = torch.chunk(xz, 2, dim=-1)
    xi = silu(_causal_conv(p, xi))
    dA, dBx, Cc = _ssm_inputs(cfg, p, xi)                # [K, B, S, di, N] ×2, [K, B, S, N]
    h = linear_scan(dA, dBx, dim=2)
    y = torch.einsum("kbsdn,kbsn->kbsd", h, Cc.to(torch.float32))
    y = (y + _vec(p["D"], y) * xi.to(torch.float32)).to(x.dtype)
    y = y * silu(z)
    return linear(y, p["out_proj"]).to(x.dtype)


# --------------------------------------------------------------------------
# decode
# --------------------------------------------------------------------------
def init_ssm_state(cfg: ModelConfig, B: int, dtype=torch.float32, device="cpu"):
    """One layer's decode state for B slots (``ssm.py:90-95``)."""
    di, N, _ = _dims(cfg)
    return {"conv": torch.zeros((B, cfg.ssm_conv - 1, di), dtype=dtype, device=device),
            "h": torch.zeros((B, di, N), dtype=dtype, device=device)}


def decode_ssm(cfg: ModelConfig, p, state, x):
    """One-token step (``ssm.py:98-110``) of one replica: x [1, B, 1, d] →
    (out [1, B, 1, d], new state).  The conv history joins the state's
    dtype (fp32) with xi's as jnp's concatenate promotes them."""
    xz = linear(x[:, :, 0], p["in_proj"])                   # [1, B, 2·di]
    di = p["in_proj"].shape[-1] // 2
    xi, z = xz[..., :di], xz[..., di:]
    dt = torch.promote_types(state["conv"].dtype, xi.dtype)
    hist = torch.cat([state["conv"][None].to(dt), xi[:, :, None].to(dt)], dim=2)
    w = p["conv_w"]
    wt = torch.promote_types(dt, w.dtype)
    conv = torch.einsum("xbkd,xkd->xbd", hist.to(wt), w.to(wt))
    xi = silu(conv + _vec(p["conv_b"], conv))
    dA, dBx, Cc = _ssm_inputs(cfg, p, xi)                # [1, B, di, N] ×2, [1, B, N]
    h = dA * state["h"][None].to(dA.dtype) + dBx
    y = torch.einsum("xbdn,xbn->xbd", h, Cc.to(torch.float32))
    y = (y + _vec(p["D"], y) * xi.to(torch.float32)).to(x.dtype)
    y = y * silu(z)
    out = linear(y, p["out_proj"])[:, :, None].to(x.dtype)
    return out, {"conv": hist[0, :, 1:], "h": h[0]}
