"""Min-max objectives for the CoDA executors (counterpart of
``repro.core.objective``).

Ported: the ``auc`` objective (the paper's eq. 2 with duals a, b, α), the
``Objective`` seam it plugs into with its ``metric`` factory, and the
evaluation metrics ``roc_auc`` / ``partial_auc``; ``pauc_dro`` and ``bce``
come later (ROADMAP Queue 1, item 3).

The worker axis is written out: ``loss`` takes scores ``h [K, T]``, labels
``y [K, T]`` and duals ``{field: [K]}`` and returns per-worker losses
``[K]``.  ``AUCFunction`` wires the fused kernel's closed-form partials
into autograd, so a single launch serves every worker and no custom
Function ever needs vmapping:

    ∂F/∂h = 2(1-p)(h-a)·1⁺ + 2p(h-b)·1⁻ + 2(1+α)(p·1⁻ − (1-p)·1⁺)
    ∂F/∂a = −2(1-p)(h-a)·1⁺        ∂F/∂b = −2p(h-b)·1⁻
    ∂F/∂α = 2(p·h·1⁻ − (1-p)·h·1⁺) − 2p(1-p)α
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import ops as kops

_EPS = 1e-12


class AUCFunction(torch.autograd.Function):
    """Per-worker mean of F(w,a,b,α;z): ``apply(h, y, a, b, alpha, p, impl)``
    → loss [K].  The backward only scales the forward's partials by the
    cotangent (``repro.core.objective.auc_F``'s VJP, lines 84-91)."""

    @staticmethod
    def forward(ctx, h, y, a, b, alpha, p, impl):
        loss, dh, da, db, dalpha = kops.auc_loss(h, y, a, b, alpha, p,
                                                 impl=impl)
        ctx.save_for_backward(dh.to(h.dtype), da, db, dalpha)
        return loss

    @staticmethod
    def backward(ctx, ct):
        dh, da, db, dalpha = ctx.saved_tensors
        return (ct[:, None] * dh, None, ct * da, ct * db, ct * dalpha, None,
                None)


def auc_F(h, y, a, b, alpha, p: float, impl: str = "auto"):
    """Per-worker mean of F over the batch.  h, y: [K, T]; a, b, alpha: [K]."""
    return AUCFunction.apply(h, y, a, b, alpha, p, impl)


def optimal_alpha(h, y, eps: float = _EPS):
    """Closed-form maximizer α*(v) = E[h|y=-1] − E[h|y=1] (paper eq. 8) on
    each worker's batch: h, y [K, m] → [K] (Algorithm 1 lines 4–7)."""
    h = h.to(torch.float32)
    pos = y.to(torch.float32)
    neg = 1.0 - pos
    mean_neg = torch.sum(h * neg, -1) / torch.clamp(torch.sum(neg, -1), min=eps)
    mean_pos = torch.sum(h * pos, -1) / torch.clamp(torch.sum(pos, -1), min=eps)
    return mean_neg - mean_pos


def roc_auc(scores, labels) -> float:
    """Exact (tie-aware) empirical AUC via rank statistics, in float64.

    Tied scores contribute 1/2 per pair (average ranks).  Single-class
    inputs return 0.0, as ``repro.core.objective.roc_auc`` does."""
    s = scores.detach().reshape(-1).to(torch.float64)
    y = labels.detach().reshape(-1).to(torch.float64)
    ss, order = torch.sort(s)
    first = torch.searchsorted(ss, ss, right=False).to(torch.float64) + 1
    last = torch.searchsorted(ss, ss, right=True).to(torch.float64)
    ranks = torch.empty_like(s)
    ranks[order] = 0.5 * (first + last)
    n_pos = torch.sum(y)
    n_neg = torch.sum(1.0 - y)
    sum_pos_ranks = torch.sum(ranks * y)
    auc = (sum_pos_ranks - n_pos * (n_pos + 1) / 2) / torch.clamp(n_pos * n_neg,
                                                                   min=_EPS)
    return float(auc)


def partial_auc(scores, labels, beta: float = 0.3) -> float:
    """One-way partial AUC at FPR ≤ ``beta``, normalized to [0, 1]: the
    positives ranked against the hardest ⌈β·n⁻⌉ negatives, ties 1/2, in
    float64 NumPy (``repro.core.objective.partial_auc``, objective.py:135,
    line for line).  Single-class inputs return 0.0."""
    s = np.asarray(scores, np.float64)
    y = np.asarray(labels, np.float64)
    sp = s[y > 0.5]
    sn = s[y <= 0.5]
    if len(sp) == 0 or len(sn) == 0:
        return 0.0
    k = max(1, int(np.ceil(beta * len(sn))))
    hard = np.sort(sn)[::-1][:k]        # hardest k negatives by score
    pooled = np.concatenate([sp, hard])
    order = np.argsort(pooled, kind="mergesort")
    sorted_ = pooled[order]
    first = np.searchsorted(sorted_, sorted_, side="left") + 1
    last = np.searchsorted(sorted_, sorted_, side="right")
    ranks = np.empty_like(pooled)
    ranks[order] = 0.5 * (first + last)
    n_pos = float(len(sp))
    sum_pos_ranks = float(ranks[:len(sp)].sum())
    return float((sum_pos_ranks - n_pos * (n_pos + 1) / 2) / (n_pos * k))


class Objective:
    """One min-max objective: dual state + loss + update/boundary rules
    (see ``repro.core.objective.Objective``)."""

    name: str = ""
    prox_refs: tuple[str, ...] = ()     # duals under proximal regularization
    stage_fields: tuple[str, ...] = ()  # duals re-estimated at stage ends
    metric_name: str = "auc"            # what ``metric`` reports

    def init_duals(self, K: int, device) -> dict[str, torch.Tensor]:
        raise NotImplementedError

    def loss(self, h, y, duals, impl: str = "auto"):
        """F(w, duals; z) per worker: h, y [K, T], duals {field: [K]} → [K]."""
        raise NotImplementedError

    def dual_step(self, duals, grads, ref_duals, eta, gamma):
        """Prox for ``prox_refs`` fields (against their ``ref_duals`` slot),
        ascent for the rest (the reference's projected-descent fields come
        with ``pauc_dro``)."""
        new = {}
        for k, v in duals.items():
            if k in self.prox_refs:
                new[k] = (gamma * (v - eta * grads[k])
                          + eta * ref_duals[k]) / (eta + gamma)
            else:
                new[k] = v + eta * grads[k]
        return new

    def stage_duals(self, h, y, duals) -> dict[str, torch.Tensor]:
        """Closed-form re-estimates for ``stage_fields``, one value per
        worker ([K]); the caller worker-means them."""
        return {}

    def metric(self, backend: str = "exact", **kw):
        """This objective's reporting metric as a mergeable
        ``repro_torch.metrics.streaming.Metric`` (``backend`` ∈ {exact,
        sketch}; sketch kwargs ``bins``/``lo``/``hi`` pass through)."""
        from repro_torch.metrics import streaming  # deferred: metrics finalizes here

        return streaming.make_metric(self.metric_name, backend, **kw)


class AUCObjective(Objective):
    """Ying et al. min-max AUC (paper eq. 2): duals (a, b, α)."""

    name = "auc"
    prox_refs = ("a", "b")
    stage_fields = ("alpha",)

    def __init__(self, p_pos: float = 0.5):
        self.p_pos = p_pos

    def init_duals(self, K: int, device):
        z = lambda: torch.zeros((K,), dtype=torch.float32, device=device)
        return {"a": z(), "b": z(), "alpha": z()}

    def loss(self, h, y, duals, impl: str = "auto"):
        return auc_F(h, y, duals["a"], duals["b"], duals["alpha"], self.p_pos,
                     impl)

    def stage_duals(self, h, y, duals):
        return {"alpha": optimal_alpha(h, y)}


REGISTRY = {"auc": AUCObjective}
# registered in the reference, not ported yet (ROADMAP Queue 1, item 3)
UNPORTED = ("pauc_dro", "bce")


def names() -> tuple[str, ...]:
    return tuple(REGISTRY) + UNPORTED


def for_config(ccfg) -> Objective:
    """Build the configured objective from a ``CoDAConfig``."""
    name = getattr(ccfg, "objective", "auc")
    if name not in REGISTRY:
        raise NotImplementedError(f"objective {name!r} is not ported yet "
                                  "(ROADMAP Queue 1 item 3)")
    return REGISTRY[name](p_pos=ccfg.p_pos)
