"""Mixture-of-experts block with top-k routing and two dispatch modes
(counterpart of ``repro.models.moe``).

Routing is shared (``route``): softmax over the router logits in fp32,
top-k with ties broken toward the lower expert id (as ``jax.lax.top_k``),
gates renormalised over the chosen k.  How the chosen (token, expert) pairs
reach their experts:

* ``capacity`` — the padded ``[E, C, d]`` buffer with ``C = ceil(T·k·cf/E)``
  at train time (over-capacity pairs are dropped, exactly the pairs the
  reference's ``mode="drop"`` scatter drops) or ``C = T`` at eval;
* ``sorted`` — dropless: the ``[T·k]`` assignments sorted by expert (a
  stable sort, as ``jnp.argsort``), segment sizes counted on the device,
  the expert MLP as three launches of the ragged grouped GEMM (K5 on the card)
  over the sorted ``[T·k, d]`` rows.

Training always uses ``capacity``; eval, prefill and decode use
``cfg.moe.dispatch`` (default ``sorted``).

Activations carry the worker axis K in front (``x [K, B, S, d]``) and a
layer's expert weights are ``[K, E, d, ff]`` — a strided slice of the
stacked ``[K, L, E, d, ff]`` leaf, never copied.  The sorted path folds K
into the groups: rows are sorted by (worker, expert), ``group_sizes`` has
K·E entries, and one K5 launch serves all K replicas.  Both combines
gather each (token, choice) row back and add a token's k contributions in
a fixed order — no scatter-add, whose CUDA atomics would change the
summation order from run to run (and a served greedy token with it).

Arctic's ``dense_residual`` adds an always-on MLP next to the experts.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.embeddings import ParamInit
from repro_torch.models.mlp import apply_mlp, init_mlp, linear


def init_moe(cfg: ModelConfig, init: ParamInit, lead=()):
    """The router stays fp32 whatever the parameter dtype (``moe.py:62``)."""
    m = cfg.moe
    d, ff, E = cfg.d_model, cfg.d_ff, m.n_experts
    s = d ** -0.5
    p = {"router": init.normal(lead + (d, E), s, dtype=torch.float32),
         "w_gate": init.normal(lead + (E, d, ff), s),
         "w_up": init.normal(lead + (E, d, ff), s),
         "w_down": init.normal(lead + (E, ff, d), ff ** -0.5)}
    if m.dense_residual:
        p["dense"] = init_mlp(cfg, init, lead, d_ff=m.dense_d_ff)
    return p


def capacity(cfg: ModelConfig, n_tokens: int, *, train: bool = True) -> int:
    """Per-expert buffer slots of ``capacity`` dispatch: the capacity-factor
    bound at train time, the dropless ``C = T`` at eval; padded to a
    multiple of 4, at least 4 (``moe.py:70-80``)."""
    m = cfg.moe
    c = (math.ceil(n_tokens * m.top_k * m.capacity_factor / m.n_experts)
         if train else n_tokens)
    return max(4, c + (-c) % 4)


def dispatch_buffer_bytes(cfg: ModelConfig, n_tokens: int, *,
                          mode: str = "sorted", train: bool = False,
                          dtype=torch.float32) -> int:
    """Bytes of the per-layer dispatch buffer of one replica's forward over
    ``n_tokens``: ``sorted`` gathers [T·k, d], ``capacity`` [E, C, d]."""
    m = cfg.moe
    itemsize = torch.empty((), dtype=dtype).element_size()
    if mode == "sorted":
        return n_tokens * m.top_k * cfg.d_model * itemsize
    if mode == "capacity":
        return (m.n_experts * capacity(cfg, n_tokens, train=train)
                * cfg.d_model * itemsize)
    raise ValueError(f"unknown dispatch mode {mode!r}")


def route(cfg: ModelConfig, p, xf):
    """xf [K, T, d] -> (top_g [K, T, k] fp32 renormalised, top_e [K, T, k]
    int64, gates [K, T, E] fp32).  A stable descending sort gives the
    ``jax.lax.top_k`` order: ties go to the lower expert id."""
    logits = linear(xf, p["router"].to(xf.dtype)).to(torch.float32)
    gates = torch.softmax(logits, dim=-1)
    vals, idx = torch.sort(gates, dim=-1, descending=True, stable=True)
    k = cfg.moe.top_k
    top_g, top_e = vals[..., :k], idx[..., :k]
    return top_g / torch.sum(top_g, dim=-1, keepdim=True), top_e, gates


def _sum_choices(y, K: int, T: int, k: int):
    """[K, T·k, d] contributions → [K, T, d], the k choices of each token
    added in order (deterministic on every device)."""
    y = y.reshape(K, T, k, -1)
    out = y[:, :, 0]
    for j in range(1, k):
        out = out + y[:, :, j]
    return out


def _expert_mlp(p, xe):
    """SwiGLU experts over per-expert rows: xe [K, E, C, d] -> [K, E, C, d]."""
    h = torch.matmul(xe, p["w_gate"])
    u = torch.matmul(xe, p["w_up"])
    return torch.matmul(F.silu(h) * u, p["w_down"])


def _dispatch_capacity(cfg: ModelConfig, p, xf, top_g, top_e, C: int):
    """Padded dispatch through an [E, C, d] buffer per worker (``moe.py:
    123-155``): a pair whose position in its expert's buffer is ≥ C is
    dropped, as the reference's ``mode="drop"`` scatter drops it."""
    m = cfg.moe
    K, T, d = xf.shape
    E, k = m.n_experts, m.top_k
    e_flat = top_e.reshape(K, T * k)
    t_flat = torch.arange(T, device=xf.device).repeat_interleave(k)
    g_flat = top_g.reshape(K, T * k)
    onehot = F.one_hot(e_flat, E)
    pos = torch.gather(torch.cumsum(onehot, dim=1) - onehot, 2, e_flat[..., None])[..., 0]
    keep = pos < C
    # every kept pair owns one buffer slot e·C + pos; dropped pairs go to
    # the dump slot E·C, which is cut off (no kept slot is written twice)
    slot = torch.where(keep, e_flat * C + pos, E * C)
    idx = torch.zeros((K, E * C + 1), dtype=torch.int64, device=xf.device)
    wgt = torch.zeros((K, E * C + 1), dtype=torch.float32, device=xf.device)
    idx = idx.scatter(1, slot, t_flat.expand(K, -1))[:, :E * C]
    wgt = wgt.scatter(1, slot, g_flat)[:, :E * C]
    kidx = torch.arange(K, device=xf.device)[:, None]
    xe = xf[kidx, idx].reshape(K, E, C, d)                        # dispatch
    ye = _expert_mlp(p, xe).reshape(K, E * C, d)
    ye = ye * wgt[..., None].to(ye.dtype)
    # combine: each kept pair reads its slot back; a dropped pair reads zeros
    ye = torch.cat([ye, ye.new_zeros((K, 1, d))], dim=1)
    return _sum_choices(ye[kidx, slot], K, T, k)


def _dispatch_sorted(cfg: ModelConfig, p, xf, top_g, top_e, *, impl: str = "auto"):
    """Dropless sort-based dispatch (``moe.py:158-183``), with the K workers
    folded into K·E groups: rows sorted by (worker, expert), three grouped
    GEMMs over the sorted rows, then each row gathered back to its
    (token, choice) place through the inverse permutation."""
    m = cfg.moe
    K, T, d = xf.shape
    E, k = m.n_experts, m.top_k
    dev = xf.device
    key = (top_e.reshape(K, T * k)
           + E * torch.arange(K, device=dev)[:, None]).reshape(-1)   # [K·T·k]
    order = torch.argsort(key, stable=True)
    src = torch.arange(K * T, device=dev).repeat_interleave(k)[order]
    # the segment sizes, as jnp.bincount(length=K·E): counted on the device
    # (torch.bincount reads the largest key back to size its output, a
    # device→host sync in every moe layer); integer sums are exact in any
    # order
    counts = torch.zeros(K * E, dtype=torch.int64, device=dev).index_add_(
        0, key, torch.ones_like(key))

    xs = xf.reshape(K * T, d)[src]                                  # [K·T·k, d]
    wdt = torch.promote_types(xs.dtype, p["w_gate"].dtype)
    xs = xs.to(wdt)
    gm = lambda a, w: ops.grouped_matmul(a, w.to(wdt), counts, impl=impl)
    h = gm(xs, p["w_gate"])
    u = gm(xs, p["w_up"])
    ys = gm(F.silu(h) * u, p["w_down"])
    ys = ys * top_g.reshape(-1)[order][:, None].to(ys.dtype)
    inv = torch.empty_like(order)
    inv[order] = torch.arange(order.numel(), device=dev)
    return _sum_choices(ys[inv].reshape(K, T * k, d), K, T, k)


def apply_moe(cfg: ModelConfig, p, x, *, train: bool = False, impl: str = "auto"):
    """x [K, B, S, d] -> (out [K, B, S, d], aux loss [K]).  The Switch
    load-balance loss counts the dispatched fraction over all k choices,
    normalised by k (``moe.py:186-219``)."""
    m = cfg.moe
    K, B, S, d = x.shape
    T = B * S
    E, k = m.n_experts, m.top_k
    xf = x.reshape(K, T, d)
    top_g, top_e, gates = route(cfg, p, xf)
    mode = "capacity" if train else m.dispatch
    if mode == "capacity":
        out = _dispatch_capacity(cfg, p, xf, top_g, top_e,
                                 capacity(cfg, T, train=train))
    else:
        out = _dispatch_sorted(cfg, p, xf, top_g, top_e, impl=impl)
    out = out.reshape(K, B, S, d).to(x.dtype)
    me = torch.mean(gates, dim=1)                                    # [K, E]
    ce = torch.mean(torch.sum(F.one_hot(top_e, E).to(torch.float32), dim=2), dim=1) / k
    aux = E * torch.sum(me * ce, dim=-1)
    if m.dense_residual:
        out = out + apply_mlp(cfg, p["dense"], x)
    return out, aux
