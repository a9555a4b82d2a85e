"""Plain PyTorch versions of the ported kernels — the semantics the CUDA
kernels are held to (counterpart of ``repro.kernels.ref``).

Both repeat the reference's arithmetic in the same order; every scalar is
an fp32 0-dim tensor so each operation rounds in fp32, as the JAX oracle
and the CUDA kernels do.
"""
from __future__ import annotations

import torch


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def auc_loss_ref(h, y, a, b, alpha, p: float):
    """Per-worker mean of F(w,a,b,α;z) and its closed-form partials
    (``repro.kernels.ref.auc_loss_ref:85-105`` with the worker axis written
    out).

    h: scores [K, T]; y: labels [K, T] ∈ {0,1}; a, b, alpha: [K] duals;
    p: the positive-class prior (host float).
    Returns (loss [K], dh [K, T] fp32, da [K], db [K], dalpha [K]).
    """
    h = h.to(torch.float32)
    pos = y.to(torch.float32)
    neg = 1.0 - pos
    a, b, alpha = (d.to(torch.float32)[:, None] for d in (a, b, alpha))
    T = h.shape[1]
    f = ((1 - p) * (h - a) ** 2 * pos
         + p * (h - b) ** 2 * neg
         + 2 * (1 + alpha) * (p * h * neg - (1 - p) * h * pos)
         - p * (1 - p) * alpha ** 2)
    loss = torch.mean(f, dim=1)
    dh = (2 * (1 - p) * (h - a) * pos + 2 * p * (h - b) * neg
          + 2 * (1 + alpha) * (p * neg - (1 - p) * pos)) / T
    da = torch.sum(-2 * (1 - p) * (h - a) * pos, dim=1) / T
    db = torch.sum(-2 * p * (h - b) * neg, dim=1) / T
    dalpha = (torch.sum(2 * (p * h * neg - (1 - p) * h * pos), dim=1) / T
              - 2 * p * (1 - p) * alpha[:, 0])
    return loss, dh, da, db, dalpha


def prox_update_ref(v, g, v0, eta: float, gamma: float):
    """v ← (γ(v − ηg) + ηv₀) / (η + γ) in fp32, stored in v's dtype
    (``repro.kernels.ref.prox_update_ref:179-185``)."""
    eta, gamma = _f32(eta), _f32(gamma)
    vf = v.to(torch.float32)
    out = gamma * (vf - eta * g.to(torch.float32)) + eta * v0.to(torch.float32)
    # divide by a tensor on out's device: torch's CUDA division by a CPU
    # scalar multiplies by the reciprocal, 1 ulp off the true quotient
    denom = torch.full((), (eta + gamma).item(), dtype=torch.float32,
                       device=out.device)
    return (out / denom).to(v.dtype)
