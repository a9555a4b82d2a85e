"""Public wrappers over the CUDA kernels (counterpart of
``repro.kernels.ops``).

``impl`` semantics everywhere (one decision point: ``dispatch``):
  * "auto"   — the hand-written kernel for CUDA tensors, the plain PyTorch
               version for CPU tensors.
  * "ref"    — force the plain version (on any device).
  * "kernel" — force the kernel; a CPU tensor raises.
Anything else raises — a typo'd ``impl`` must not silently fall back.
There is no ``try`` around a build or a launch: a kernel that fails to
build or launch raises, it is never replaced by the plain version.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import auc_loss as _auc_mod
from repro_torch.kernels import flash_attention as _fa_mod
from repro_torch.kernels import moe_dispatch as _moe_mod
from repro_torch.kernels import opt_update as _opt_mod
from repro_torch.kernels import prox_update as _prox_mod
from repro_torch.kernels import ref
from repro_torch.tree import tree_map

IMPLS = ("auto", "ref", "kernel")

# Above this many KV positions the plain version switches from materialised
# scores to the chunked online softmax (memory O(S·chunk)), as the
# reference's ``ops.py:35`` does.
_FULL_ATTN_MAX_KV = 8192


def dispatch(impl: str, device: torch.device) -> bool:
    """The one dispatch decision: True = launch the CUDA kernel."""
    if impl == "ref":
        return False
    if impl == "kernel":
        if device.type != "cuda":
            raise ValueError(f"impl='kernel' needs CUDA tensors, got {device}")
        return True
    if impl == "auto":
        return device.type == "cuda"
    raise ValueError(f"unknown impl {impl!r} (want auto | ref | kernel)")


def attention(q, k, v, *, causal: bool = True, window=None, impl: str = "auto"):
    """GQA attention.  q: [B,S,H,hd], k/v: [B,Skv,KV,hd] -> [B,S,H,hd].

    ``window``: None or -1 = full, else a Python int.  On the card the K4
    kernel runs in every call (its backward is plain tensor code); the
    reference reaches its Pallas kernel only for a static window, which its
    scanned layer stacks never pass (their windows are traced), while the
    port runs the layers in a Python loop and always knows the window."""
    window = _fa_mod.normalize_window(window)
    if dispatch(impl, q.device):
        return _fa_mod.flash_attention(q, k, v, causal=causal, window=window)
    if k.shape[1] <= _FULL_ATTN_MAX_KV:
        return ref.attention_full(q, k, v, causal=causal, window=window)
    return ref.attention_chunked(q, k, v, causal=causal, window=window)


def auc_loss(h, y, a, b, alpha, p: float, *, impl: str = "auto"):
    """Fused loss + closed-form grads of the min-max AUC objective for all
    K workers: h, y [K, T]; a, b, alpha [K].  Returns (loss [K], dh [K, T],
    da [K], db [K], dalpha [K])."""
    if dispatch(impl, h.device):
        return _auc_mod.auc_loss(h, y, a, b, alpha, p)
    return ref.auc_loss_ref(h, y, a, b, alpha, p)


def grouped_matmul(x, w, group_sizes, *, impl: str = "auto"):
    """Ragged grouped GEMM of the sorted MoE dispatch: ``out[i] = x[i] @
    w[g(i)]`` for rows of x [N, Kd] sorted by group, w [G, Kd, F] or
    [R, E, Kd, F] (R·E groups), group_sizes [G].  On the card "auto"
    launches K5 (forward only); the plain version is differentiable."""
    if dispatch(impl, x.device):
        return _moe_mod.grouped_matmul(x, w, group_sizes)
    return ref.grouped_matmul_ref(x, w, group_sizes)


def opt_update(v, g, v0, buf, eta: float, gamma: float, coef: float, seed, *,
               mode: str, impl: str = "auto"):
    """Fused optimizer update of one parameter leaf (the
    ``core/optimizer.py`` seam): accumulator update + preconditioned step +
    prox projection in one pass, returning ``(new_v, new_buf)``.

    ``mode="momentum"``: buf is the momentum buffer (m ← coef·m + g, d = m;
    a bf16 buffer is re-stored with stochastic rounding under ``seed``).
    ``mode="precond"``: buf is the fp32 accumulator cover (ν = cover + g²,
    d = g/√(ν+coef), ν returned fp32 for the caller's axis reductions)."""
    if dispatch(impl, v.device):
        return _opt_mod.opt_update(v, g, v0, buf, eta, gamma, coef, seed,
                                   mode=mode)
    return ref.opt_update_ref(v, g, v0, buf, eta, gamma, coef, seed, mode=mode)


def prox_update_tree(v_tree, g_tree, v0_tree, eta: float, gamma: float, *,
                     impl: str = "auto"):
    """Apply the fused proximal update leaf-wise over parameter trees (one
    launch per leaf, each covering all K workers)."""
    def upd(v, g, v0):
        if dispatch(impl, v.device):
            return _prox_mod.prox_update(v, g, v0, eta, gamma)
        return ref.prox_update_ref(v, g, v0, eta, gamma)

    return tree_map(upd, v_tree, g_tree, v0_tree)
