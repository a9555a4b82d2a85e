"""Optimizer seam for the local primal update (counterpart of
``repro.core.optimizer``).

This slice ports ``sgd`` — the stateless proximal step
v ← (γ(v − η g) + η v₀) / (η + γ) through ``kernels.ops.prox_update_tree``.
``momentum``, ``sm3`` and ``shampoo_blocked`` (with the fused
``opt_update`` kernel) come later (ROADMAP Queue 1, item 7).
"""
from __future__ import annotations

from repro_torch.kernels import ops as kops


class _Sgd:
    """Stateless proximal SGD (d = g): no ``state["opt"]`` entry."""

    name = "sgd"

    def init(self, ccfg, params):
        return None

    def step(self, ccfg, opt, params, gp, ref_params, eta):
        new_params = kops.prox_update_tree(params, gp, ref_params, eta,
                                           ccfg.gamma, impl=ccfg.impl)
        return new_params, None


REGISTRY = {"sgd": _Sgd}
# registered in the reference, not ported yet (ROADMAP Queue 1, item 7)
UNPORTED = ("momentum", "sm3", "shampoo_blocked")


def names() -> tuple[str, ...]:
    return tuple(REGISTRY) + UNPORTED


def for_config(ccfg):
    if ccfg.optimizer not in REGISTRY:
        raise NotImplementedError(f"optimizer {ccfg.optimizer!r} is not "
                                  "ported yet (ROADMAP Queue 1 item 7)")
    return REGISTRY[ccfg.optimizer]()
