"""Optimizer seam for the local primal update (counterpart of
``repro.core.optimizer``).

CoDA's primal step is the proximal update
v ← (γ(v − η d) + η v₀) / (η + γ); the registered optimizers choose d:

  * ``sgd``             — d = g through ``kernels.ops.prox_update_tree``;
                          no ``state["opt"]`` entry.
  * ``momentum``        — heavy-ball m ← β m + g, d = m, through
                          ``kernels.ops.opt_update_tree`` (mode
                          "momentum"); a bf16 buffer is stored
                          stochastically rounded.
  * ``sm3``             — SM3-II: one accumulator vector per trailing axis;
                          ν = minⱼ accⱼ + g², d = g/√(ν + ε) through
                          ``opt_update_tree`` (mode "precond") over every
                          leaf's materialized cover, then per-axis maxes of
                          ν become the new accumulators.
  * ``shampoo_blocked`` — per ``shampoo_block``-wide chunk of the flattened
                          leaf, stats G ← G + g gᵀ and G^{-1/2} by a coupled
                          Newton–Schulz iteration every ``precond_every``
                          steps; the direction is grafted onto the
                          diagonal-AdaGrad norm; every leaf's direction then
                          goes through one ``prox_update_tree``.

On the card each of those tree calls is one launch over every leaf of the
step (K2's or K3's multi-tensor kernel), where the reference makes one
``pallas_call`` a leaf inside its compiled step.

State layout, as the reference's::

    state["opt"] = {"t": [K] int32 local-step counter,
                    "leaves": [per-parameter-leaf state, ...]}

with ``leaves`` in ``tree_leaves(params)`` order.  The state is local: it is
never averaged and never in the window payload (``core/coda``).

``step(..., inplace=True)`` is a donating executor's step: the new
parameters and the new optimizer state are written into the buffers of the
ones given (the K2/K3 launches in place; blocked Shampoo's ``s`` and ``p``
leaf by leaf, so only one leaf's temporaries and every leaf's direction are
alive at a time), and
the trees returned hold those same tensors.  The arithmetic is the same
either way, so the two are bitwise equal.

Layout.  The port keeps convolution weights OIHW where the reference keeps
them HWIO (``params.py``).  Momentum is elementwise and does not care.  SM3
keeps its accumulators, and the index j of their stochastic-rounding seeds,
in the reference's axis order: accumulator j covers the port axis
``ref_orders(params)[i][1 + j]`` of leaf i (the convolutions are found by
their place in the tree, ``params.conv_flags``).  Shampoo blocks the leaf flattened in the
reference's order (g is permuted before blocking, d back after), so both
packages run the same algorithm and carry the same state.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref
from repro_torch.params import ref_orders
from repro_torch.tree import copy_into, tree_leaves, tree_unflatten

_GOLD = 0x9E3779B9   # 2^32/φ — the classic Weyl increment
_SALT = 0x85EBCA6B
_U32 = 0xFFFFFFFF


def leaf_seeds(t, n_leaves: int) -> torch.Tensor:
    """The reference's per-(step, leaf) uint32 seeds (``_leaf_seed``,
    optimizer.py:82-85) for leaves 0…n−1, as one int64 tensor on t's
    device: (t[0]·GOLD mod 2³²) xor ((i+1)·SALT mod 2³²).  t[0] < 2³¹ and
    GOLD < 2³², so the product is exact in int64.  Computed on the device
    once per step: no host read of the step counter."""
    base = (t[0].to(torch.int64) * _GOLD) & _U32
    idx = torch.arange(1, n_leaves + 1, dtype=torch.int64, device=t.device)
    return base ^ ((idx * _SALT) & _U32)


def _plus(seed, j: int):
    """seed + j mod 2³² (the reference's ``seed + jnp.uint32(j)``)."""
    return (seed + j) & _U32


class _Sgd:
    """Stateless proximal SGD (d = g): no ``state["opt"]`` entry."""

    name = "sgd"

    def init(self, ccfg, params):
        return None

    def step(self, ccfg, opt, params, gp, ref_params, eta, *, inplace=False):
        new_params = kops.prox_update_tree(params, gp, ref_params, eta,
                                           ccfg.gamma, impl=ccfg.impl, inplace=inplace)
        return new_params, None


# the attribute that carries a step counter's value on the host
_HOST_COUNT = "_host_count"


def _stamped(t: torch.Tensor, n: int) -> torch.Tensor:
    setattr(t, _HOST_COUNT, n)
    return t


def host_count(t: torch.Tensor) -> int:
    """The step counter ``t`` ([K] int32, one value on every worker) as the
    host knows it.  ``init`` and every ``shampoo_blocked`` step stamp the
    counter they make with its value, so no step reads the device; a
    counter made anywhere else (restored from a checkpoint, converted from
    the reference's state) is read once, here, and stamped."""
    n = getattr(t, _HOST_COUNT, None)
    if n is None:
        n = int(t[0])
        _stamped(t, n)
    return n


def carry_host_count(src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """``dst``, a copy of some of ``src``'s workers, with ``src``'s stamp."""
    n = getattr(src, _HOST_COUNT, None)
    return dst if n is None else _stamped(dst, n)


def read_host_count(opt) -> None:
    """Stamp a restored optimizer state's counter: the one read of it."""
    if opt is not None:
        host_count(opt["t"])


def _tick(t: torch.Tensor, inplace: bool) -> torch.Tensor:
    """The step counter after one step: t + 1 (into t itself in place),
    stamped with its host value when t carried one."""
    n = getattr(t, _HOST_COUNT, None)
    t = t.add_(1) if inplace else t + 1
    return t if n is None else _stamped(t, n + 1)


def _counter(leaves):
    K = leaves[0].shape[0]
    return _stamped(torch.zeros((K,), dtype=torch.int32, device=leaves[0].device), 0)


class _Momentum:
    """Heavy-ball momentum through the fused opt_update kernel."""

    name = "momentum"

    def init(self, ccfg, params):
        leaves = tree_leaves(params)
        return {"t": _counter(leaves),
                "leaves": [torch.zeros(l.shape, dtype=ccfg.opt_dtype,
                                       device=l.device) for l in leaves]}

    def step(self, ccfg, opt, params, gp, ref_params, eta, *, inplace=False):
        seeds = leaf_seeds(opt["t"], len(opt["leaves"]))
        new_params, new_m = kops.opt_update_tree(params, gp, ref_params, opt["leaves"], eta,
                                                 ccfg.gamma, ccfg.opt_beta, seeds,
                                                 mode="momentum", impl=ccfg.impl,
                                                 inplace=inplace)
        return new_params, {"t": _tick(opt["t"], inplace), "leaves": new_m}


def _ref_shape(v, order) -> list[int]:
    return [v.shape[a] for a in order]


class _SM3:
    """SM3-II: per-trailing-axis accumulator vectors (in the reference's axis
    order), min-of-covers inner update fused with the prox step (kernel
    mode "precond")."""

    name = "sm3"

    def init(self, ccfg, params):
        leaves = tree_leaves(params)
        K = leaves[0].shape[0]
        z = lambda *s, device: torch.zeros((K, *s), dtype=ccfg.opt_dtype,
                                           device=device)
        return {"t": _counter(leaves),
                "leaves": [[z(device=l.device)] if l.dim() == 1 else
                           [z(d, device=l.device) for d in _ref_shape(l, o)[1:]]
                           for l, o in zip(leaves, ref_orders(params))]}

    def step(self, ccfg, opt, params, gp, ref_params, eta, *, inplace=False):
        vs = tree_leaves(params)
        orders = ref_orders(params)
        seeds = leaf_seeds(opt["t"], len(vs))
        dt = ccfg.opt_dtype
        # the covers leaf by leaf, as the reference's jnp builds them, then one
        # K3 "precond" launch over every leaf's (v, g, v0, cover)
        covers = []
        for v, accs, order in zip(vs, opt["leaves"], orders):
            K = v.shape[0]
            if v.dim() == 1:
                cover = accs[0].to(torch.float32)
            else:
                cover = None
                for j, a in enumerate(accs):     # j: the reference's axis 1+j
                    shape = [K] + [1] * (v.dim() - 1)
                    shape[order[1 + j]] = a.shape[1]
                    c = a.to(torch.float32).reshape(shape)
                    cover = c if cover is None else torch.minimum(cover, c)
                cover = cover.expand(v.shape)
            if inplace:
                # ν goes into a materialized cover of our own, never into an
                # accumulator: those are per-axis reductions of ν, made below
                cover = cover.clone(memory_format=torch.contiguous_format)
            covers.append(cover)
        new_params, nus = kops.opt_update_tree(params, gp, ref_params, covers, eta, ccfg.gamma,
                                               ccfg.opt_eps, seeds, mode="precond",
                                               impl=ccfg.impl, inplace=inplace)
        del covers
        new_s = []
        for i, (v, accs, order, nu) in enumerate(zip(vs, opt["leaves"], orders, nus)):
            if v.dim() == 1:
                upd = [kref.stochastic_round(nu, seeds[i], dt)]
            else:
                upd = []
                for j in range(v.dim() - 1):
                    p = order[1 + j]
                    red = [a for a in range(1, v.dim()) if a != p]
                    if inplace and red and dt == torch.float32:
                        # fp32 keeps the max as it is: straight into the
                        # accumulator
                        upd.append(torch.amax(nu, dim=red, out=accs[j]))
                        continue
                    # jnp.max(axis=()) reduces nothing; torch.amax(dim=[])
                    # would reduce every axis
                    mx = torch.amax(nu, dim=red) if red else nu
                    upd.append(kref.stochastic_round(
                        mx, _plus(seeds[i], j + 1) if dt != torch.float32 else 0, dt))
            new_s.append(copy_into(accs, upd) if inplace else upd)
        return new_params, {"t": _tick(opt["t"], inplace), "leaves": new_s}


# relative ridge for the blocked-Shampoo inverse root, as a fraction of tr(G)
# (the reference's _SHAMPOO_RIDGE, optimizer.py:190-198: keeps bf16-rounded
# stats PSD and bounds the whitening ratio)
_SHAMPOO_RIDGE = 0.1


def _inv_sqrt_psd(a, eps: float, iters: int = 15, *, out=None):
    """A^{-1/2} for (nearly) PSD batched [..., b, b] by the coupled
    Newton–Schulz iteration with the trace-relative ridge
    δ = ε + 0.1·tr(A) (``repro.core.optimizer._inv_sqrt_psd``, :201-225).
    The products are batched fp32 ``torch.matmul``, as the reference leaves
    them to XLA; TF32 is off in the entry points.  ``out``: an fp32 tensor
    the result is written into."""
    b = a.shape[-1]
    eye = torch.eye(b, dtype=torch.float32, device=a.device)
    tr = torch.diagonal(a, dim1=-2, dim2=-1).sum(-1)[..., None, None]
    a = a + (eps + _SHAMPOO_RIDGE * tr) * eye
    c = torch.diagonal(a, dim1=-2, dim2=-1).sum(-1)[..., None, None]
    y = a / c
    z = eye.expand(a.shape)
    for _ in range(iters):
        t = 0.5 * (3.0 * eye - z @ y)
        y = y @ t
        z = t @ z
    return torch.mul(z, kref.rsqrt(c), out=out)


class _ShampooBlocked:
    """Blocked full-matrix preconditioning on the leaf flattened in the
    reference's axis order: per-block stats G ← G + g gᵀ, G^{-1/2} refreshed
    every ``precond_every`` local steps, the step grafted onto the
    diagonal-AdaGrad norm, then ``prox_update``."""

    name = "shampoo_blocked"

    def _geom(self, ccfg, l):
        N = math.prod(l.shape[1:]) if l.dim() > 1 else 1
        b = min(ccfg.shampoo_block, N)
        return N, b, -(-N // b)

    def init(self, ccfg, params):
        leaves = tree_leaves(params)
        K = leaves[0].shape[0]
        out = []
        for l in leaves:
            _, b, nb = self._geom(ccfg, l)
            eye = torch.eye(b, dtype=torch.float32, device=l.device)
            out.append({"s": torch.zeros((K, nb, b, b), dtype=ccfg.opt_dtype,
                                         device=l.device),
                        "p": eye.expand(K, nb, b, b).to(ccfg.opt_dtype).clone()})
        return {"t": _counter(leaves), "leaves": out}

    def step(self, ccfg, opt, params, gp, ref_params, eta, *, inplace=False):
        vs, gs = tree_leaves(params), tree_leaves(gp)
        t = opt["t"]
        # the reference's lax.cond(t[0] % precond_every == 0), decided on the
        # host's copy of the step counter: no read of the device
        n = host_count(t)
        refresh = n % ccfg.precond_every == 0
        seeds = leaf_seeds(t, len(vs))
        dt = ccfg.opt_dtype
        ds, new_s = [], []
        for i, (v, g, st, order) in enumerate(zip(vs, gs, opt["leaves"], ref_orders(params))):
            K = v.shape[0]
            N, b, nb = self._geom(ccfg, v)
            gf = g.permute(order).to(torch.float32).reshape(K, N)
            gb = F.pad(gf, (0, nb * b - N)).reshape(K, nb, b)
            outer = gb[..., :, None] * gb[..., None, :]
            # fp32 state in place: the statistics and a refreshed root are
            # made in their own buffers (the same operations, no copy after)
            own = inplace and dt == torch.float32
            stats = st["s"].add_(outer) if own else st["s"].to(torch.float32) + outer
            del outer
            pre = (_inv_sqrt_psd(stats, ccfg.opt_eps, out=st["p"] if own else None)
                   if refresh else st["p"].to(torch.float32))
            db = torch.einsum("knbc,knc->knb", pre, gb)
            df = db.reshape(K, nb * b)[:, :N]
            # graft the preconditioned direction onto the diagonal-AdaGrad
            # step's per-worker norm (the stats diagonal is Σg²)
            diag = torch.diagonal(stats, dim1=-2, dim2=-1)
            ga = (gb * kref.rsqrt(diag + ccfg.opt_eps)).reshape(K, nb * b)[:, :N]
            gn = torch.sqrt(torch.sum(ga * ga, dim=1, keepdim=True))
            dn = torch.sqrt(torch.sum(df * df, dim=1, keepdim=True))
            d = (df * gn / (dn + 1e-30)).reshape(_ref_shape(v, order))
            d = d.permute([order.index(a) for a in range(v.dim())]).contiguous()
            ds.append(d)
            del gf, gb, db, df, diag, ga, d     # this leaf's temporaries go before the next's
            new = {"s": kref.stochastic_round(stats, seeds[i], dt),
                   "p": kref.stochastic_round(pre, _plus(seeds[i], 1), dt)}
            del stats, pre
            new_s.append(copy_into(st, new) if inplace else new)
        # every leaf's direction, then one K2 launch over all of them
        new_params = kops.prox_update_tree(params, tree_unflatten(params, ds), ref_params, eta,
                                           ccfg.gamma, impl=ccfg.impl, inplace=inplace)
        return new_params, {"t": _tick(t, inplace), "leaves": new_s}


REGISTRY = {o.name: o for o in (_Sgd(), _Momentum(), _SM3(), _ShampooBlocked())}


def names() -> tuple[str, ...]:
    return tuple(REGISTRY)


def for_config(ccfg):
    return REGISTRY[ccfg.optimizer]


def state_bytes(opt_state) -> int:
    """Per-worker optimizer-state bytes (leaf bytes over the leading worker
    axis, as ``coda.model_bytes`` counts).  Local bytes only: never part of
    a window payload."""
    if opt_state is None:
        return 0
    return sum(l.numel() // l.shape[0] * l.element_size()
               for l in tree_leaves(opt_state))


def abstract_state_bytes(ccfg, params) -> int:
    """``state_bytes`` from shapes alone: the optimizer's ``init`` runs on
    ``meta`` copies of the parameter leaves, so nothing is allocated."""
    meta = tree_unflatten(params, [torch.empty(l.shape, dtype=l.dtype, device="meta")
                                   for l in tree_leaves(params)])
    return state_bytes(for_config(ccfg).init(ccfg, meta))
