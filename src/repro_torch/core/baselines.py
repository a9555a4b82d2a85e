"""Baselines the paper compares against (counterpart of
``repro.core.baselines``).

* PPD-SG (Liu et al. 2020b) — single machine: CoDA with K = 1, I = 1.
* NP-PPD-SG — naive parallel: CoDA with I = 1 (averaging after every local
  step; Table 1 row 2).
* Parallel minibatch SGD on binary cross-entropy — the "standard loss
  minimization" strawman of the introduction, through the registered
  dual-free ``bce`` objective and the executors' own loss
  (``coda.grad_step_scores``).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import coda
from repro_torch.models import model as M
from repro_torch.tree import tree_leaves, tree_map


def params_k(params) -> int:
    """The stacked worker count of a [K, ...] parameter tree."""
    return tree_leaves(params)[0].shape[0]


def ppd_sg_config(ccfg: coda.CoDAConfig) -> coda.CoDAConfig:
    return dataclasses.replace(ccfg, n_workers=1)


def np_ppd_sg_window(mcfg: ModelConfig, ccfg: coda.CoDAConfig, state,
                     window_batch, eta):
    """NP-PPD-SG: average after *every* local step of the window
    (``window_batch`` leaves [I, K, B, ...]).  Returns (state, losses [I],
    each the mean over workers)."""
    losses = []
    for i in range(window_batch["labels"].shape[0]):
        state, loss = coda.local_step(mcfg, ccfg, state,
                                      {k: v[i] for k, v in window_batch.items()},
                                      eta)
        state = coda.average(state)
        losses.append(torch.mean(loss))
    return state, torch.stack(losses)


# --------------------------------------------------------------------------
# BCE-SGD baseline (loss minimization, not AUC)
# --------------------------------------------------------------------------
def bce_init(mcfg: ModelConfig, K: int, *, generator: torch.Generator | None = None,
             dtype=torch.float32):
    """One replica of ``M.init_params`` stacked K times (on the CPU; move
    the tree to run elsewhere)."""
    params = M.init_params(mcfg, generator=generator, dtype=dtype)
    return tree_map(lambda x: x[None].expand((K,) + x.shape).clone(), params)


def bce_step(mcfg: ModelConfig, params, batch, eta, *, impl: str = "auto"):
    """One synchronous parallel-SGD step on BCE: every worker's gradient
    (through the executors' loss with the empty dual tree), averaged over
    the workers (a bf16 leaf summed in fp32 and rounded once, as
    ``jnp.mean``), then w ← w − η·ḡ.  Returns (params, mean loss)."""
    ccfg = coda.CoDAConfig(n_workers=params_k(params), objective="bce",
                           impl=impl)
    losses, (gp, _), _ = coda.grad_step_scores(
        mcfg, ccfg, {"params": params, "duals": {}}, batch)
    mean = lambda g: torch.mean(g.to(torch.float32), dim=0, keepdim=True).to(g.dtype)
    new = tree_map(lambda p, g: p.detach() - eta * mean(g).expand(g.shape),
                   params, gp)
    return new, torch.mean(losses)
