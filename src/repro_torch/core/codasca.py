"""CODASCA — CoDA with stochastic controlled averaging for heterogeneous
data (Yuan et al., ICML 2021), counterpart of ``repro.core.codasca``.

Every primal/dual variable v gets a worker-local control variate c_k(v)
(``cv_params``/``cv_duals``, leading [K] axis) and a global one c(v)
(``cg_params``/``cg_duals``, replicated over [K]).  Each of the I local
steps applies the corrected gradient

    g̃ = g + (c − c_k)

with the difference taken first, so equal variates give an exact zero:
the first window, homogeneous batches and K = 1 are bitwise CoDA.  At the
window end c_k is refreshed to the worker's mean raw gradient over the
window and c to the worker mean of the fresh c_k, in the same buckets as
the model average (``core/bucketing.py``): one averaging per window, twice
the payload.  The raw-gradient accumulator is fp32 whatever
``param_dtype`` is; the refresh casts back to the wire dtype once.
"""
from __future__ import annotations

import contextlib

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import bucketing, coda
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten


def extend_state(state: coda.CoDAState) -> coda.CoDAState:
    """Add zero control variates to a CoDA state, each in its own buffer."""
    zt = lambda t: tree_map(torch.zeros_like, t)
    new = dict(state)
    new["cv_params"], new["cg_params"] = zt(state["params"]), zt(state["params"])
    new["cv_duals"], new["cg_duals"] = zt(state["duals"]), zt(state["duals"])
    return new


def _corr(g, c, ck):
    return g + (c - ck)


def local_step(mcfg: ModelConfig, ccfg: coda.CoDAConfig, state, batch, eta, *,
               inplace: bool = False):
    """One control-variate-corrected primal-dual update on every worker.
    Returns (new_state, per-worker losses [K], raw gradients (gp, gd)): the
    raw gradients feed the window's variate refresh.  ``inplace``: as
    ``coda.apply_grads``."""
    losses, (gp, gd), hs = coda.grad_step_scores(mcfg, ccfg, state, batch)
    gp_c = tree_map(_corr, gp, state["cg_params"], state["cv_params"])
    gd_c = {k: _corr(g, state["cg_duals"][k], state["cv_duals"][k]) for k, g in gd.items()}
    new = coda.apply_grads(ccfg, state, (gp_c, gd_c), eta, inplace=inplace)
    del gp_c, gd_c
    if "sk_new" in state:
        new["sk_new"] = coda.sketch_update(ccfg, state["sk_new"], hs, batch["labels"],
                                           inplace=inplace)
    return new, losses, (gp, gd)


def run_window(mcfg: ModelConfig, ccfg: coda.CoDAConfig, state, window_batch, eta, *,
               wa=None, ring=None, communicate: bool = True, faults=None, defer_to=None,
               pending=None, inplace: bool = False):
    """I corrected local steps + the combined average-and-refresh (masked
    when ``faults`` are given), with server momentum when β > 0.  ``wa`` /
    ``ring`` / ``defer_to`` / ``pending`` / ``inplace``: as
    ``coda.run_window`` (in place, the refresh writes ``cv``/``cg`` into
    their own buffers); the refresh rides the model average's buckets, so a
    window is still one collective per dtype bucket, of twice the payload.
    Returns (new_state, losses [I, K])."""
    I = window_batch["labels"].shape[0]
    wire = {"params": state["params"], "duals": state["duals"]}
    acc = [torch.zeros(l.shape, dtype=torch.float32, device=l.device)
           for l in tree_leaves(wire)]
    del wire
    start_params = coda.start_copy(ccfg, state, communicate=communicate, inplace=inplace,
                                   pending=pending)
    losses = []
    for i in range(I):
        with pending.reads(i) if pending is not None else contextlib.nullcontext():
            state, loss, (gp, gd) = local_step(mcfg, ccfg, state,
                                               {k: v[i] for k, v in window_batch.items()},
                                               eta, inplace=inplace)
            for a, g in zip(acc, tree_leaves({"params": gp, "duals": gd})):
                a.add_(g)                 # fp32 += the raw gradient, widened
        del gp, gd
        losses.append(loss)
    if pending is not None:
        pending.settle()
    if communicate:
        wire = {"params": state["params"], "duals": state["duals"]}
        cv = []
        for w in tree_leaves(wire):      # free each fp32 sum as it is used
            cv.append(bucketing.div(acc.pop(0), I).to(w.dtype))
        cv_new = tree_unflatten(wire, cv)
        del cv, wire
        state = coda.average_window(ccfg, state, cv_new, faults, wa=wa, ring=ring,
                                    start_params=start_params, defer_to=defer_to,
                                    inplace=inplace)
    return state, torch.stack(losses)


def window_step(mcfg: ModelConfig, ccfg: coda.CoDAConfig, state, window_batch, eta, *,
                communicate: bool = True, faults=None, inplace: bool = False):
    """The same surface as ``coda.window_step``: (state, losses [I], each
    the mean over workers)."""
    state, losses = run_window(mcfg, ccfg, state, window_batch, eta,
                               communicate=communicate, faults=faults, inplace=inplace)
    return state, losses.mean(dim=1)
