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
from repro_torch.tree import tree_leaves, tree_unflatten

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
    launches K5 (forward only); the plain version is differentiable.  w may
    be narrower than x (bf16 experts under fp32 rows): K5 gets it widened to
    x's dtype, and the plain version, which computes in fp32, widens one
    group's [Kd, F] block at a time, so the experts never exist whole in
    fp32; both give the values of widening w first."""
    if dispatch(impl, x.device):
        return _moe_mod.grouped_matmul(x, w.to(x.dtype), group_sizes)
    return ref.grouped_matmul_ref(x, w, group_sizes)


def opt_update(v, g, v0, buf, eta: float, gamma: float, coef: float, seed, *,
               mode: str, impl: str = "auto", inplace: bool = False):
    """Fused optimizer update of one parameter leaf: accumulator update +
    preconditioned step + prox projection in one pass, returning
    ``(new_v, new_buf)``; the one-leaf case of ``opt_update_tree``
    (``seed``: a one-element int64 tensor, or on the CPU a Python int).

    ``mode="momentum"``: buf is the momentum buffer (m ← coef·m + g, d = m;
    a bf16 buffer is re-stored with stochastic rounding under ``seed``).
    ``mode="precond"``: buf is the fp32 accumulator cover (ν = cover + g²,
    d = g/√(ν+coef), ν returned fp32 for the caller's axis reductions).
    ``inplace``: the results are written into v and buf, which are returned
    (a donating executor's step; see ``kernels/opt_update.py``)."""
    seeds = seed.reshape(1) if isinstance(seed, torch.Tensor) else [seed]
    nv, nb = opt_update_tree(v, g, v0, [buf], eta, gamma, coef, seeds, mode=mode, impl=impl,
                             inplace=inplace)
    return nv, nb[0]


def opt_update_tree(v_tree, g_tree, v0_tree, bufs, eta: float, gamma: float, coef: float,
                    seeds, *, mode: str, impl: str = "auto", inplace: bool = False):
    """The fused optimizer update over parameter trees (the
    ``core/optimizer.py`` seam): ``bufs`` and ``seeds`` hold one buffer and
    one seed a leaf in ``tree_leaves`` order (``seeds``: an int64 tensor,
    ``core.optimizer.leaf_seeds``).  On the card one launch covers every
    leaf (``opt_update_multi``); else the plain version runs leaf by leaf.
    Returns (the new parameter tree, the list of new buffers); ``inplace``
    writes them into the leaves and buffers given."""
    vs, gs, v0s = (tree_leaves(t) for t in (v_tree, g_tree, v0_tree))
    if vs and dispatch(impl, vs[0].device):
        nv, nb = _opt_mod.opt_update_multi(vs, gs, v0s, bufs, eta, gamma, coef, seeds,
                                           mode=mode, inplace=inplace)
    else:
        nv, nb = _opt_mod.plain_multi(vs, gs, v0s, bufs, eta, gamma, coef, seeds, mode=mode,
                                      inplace=inplace)
    return tree_unflatten(v_tree, nv), nb


def prox_update_tree(v_tree, g_tree, v0_tree, eta: float, gamma: float, *,
                     impl: str = "auto", inplace: bool = False):
    """The fused proximal update over parameter trees (a single tensor is a
    tree of one leaf): on the card one launch covers every leaf, each with
    all K workers (``prox_update_multi``); else the plain version runs leaf
    by leaf.  ``inplace`` writes each result into its v leaf."""
    vs, gs, v0s = (tree_leaves(t) for t in (v_tree, g_tree, v0_tree))
    if vs and dispatch(impl, vs[0].device):
        out = _prox_mod.prox_update_multi(vs, gs, v0s, eta, gamma, inplace=inplace)
    else:
        out = _prox_mod.plain_multi(vs, gs, v0s, eta, gamma, inplace=inplace)
    return tree_unflatten(v_tree, out)
