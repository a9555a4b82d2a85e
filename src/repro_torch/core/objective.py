"""Min-max objectives for the CoDA executors (counterpart of
``repro.core.objective``).

Every registered objective of the reference is here, behind the
``Objective`` seam with its ``metric`` factory:

  * ``auc``      — the paper's eq. 2 with duals a, b, α, through the fused
                   ``auc_loss`` kernel;
  * ``pauc_dro`` — one-way partial AUC at FPR ≤ β as a KL-DRO min-max: a
                   fourth dual λ (projected descent at ``lam_min``) and the
                   negatives reweighted by softmax(ℓ/λ);
  * ``bce``      — dual-free binary cross-entropy on the sigmoid scores
                   ``M.score`` returns (the reference feeds it the same).

and the evaluation metrics ``roc_auc`` / ``partial_auc``.

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
import torch.nn.functional as F

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
    descent: tuple[str, ...] = ()       # min-player duals (projected descent)
    stage_fields: tuple[str, ...] = ()  # duals re-estimated at stage ends
    metric_name: str = "auc"            # what ``metric`` reports

    def init_duals(self, K: int, device) -> dict[str, torch.Tensor]:
        raise NotImplementedError

    def loss(self, h, y, duals, impl: str = "auto"):
        """F(w, duals; z) per worker: h, y [K, T], duals {field: [K]} → [K]."""
        raise NotImplementedError

    def dual_step(self, duals, grads, ref_duals, eta, gamma):
        """Prox for ``prox_refs`` fields (against their ``ref_duals`` slot),
        projected descent for ``descent`` fields, ascent for the rest."""
        new = {}
        for k, v in duals.items():
            if k in self.prox_refs:
                new[k] = (gamma * (v - eta * grads[k])
                          + eta * ref_duals[k]) / (eta + gamma)
            elif k in self.descent:
                new[k] = self.project(k, v - eta * grads[k])
            else:
                new[k] = v + eta * grads[k]
        return new

    def project(self, field: str, value):
        """Feasibility projection for ``descent`` fields (identity here)."""
        return value

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

    @property
    def eval_metric(self):
        """Removed, as in the reference (``objective.py:227``): raises."""
        raise AttributeError(
            "Objective.eval_metric was removed by the Metric redesign: use "
            "Objective.metric(backend) — a mergeable Metric with init/"
            "update/merge/finalize (repro_torch.metrics.streaming); one-shot "
            "evaluation is metric('exact').compute(scores, labels).")


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


class PAUCDROObjective(Objective):
    """One-way partial AUC at FPR ≤ β as a KL-DRO min-max
    (``repro.core.objective.PAUCDROObjective``, objective.py:262-351).

    The negative-side expectation of the AUC surrogate,
    ℓ_j = (h_j − b)² + 2(1+α)h_j, is replaced by its KL-DRO value
    λρ + λ·log E⁻[exp(ℓ_j/λ)] with ρ = log(1/β); λ is a fourth dual
    (``lam``), minimized by projected descent onto λ ≥ ``lam_min``.  All
    arithmetic is fp32 over ``[K, T]``, one row per worker."""

    name = "pauc_dro"
    prox_refs = ("a", "b")
    descent = ("lam",)
    stage_fields = ("alpha",)
    metric_name = "pauc"

    def __init__(self, p_pos: float = 0.5, beta: float = 0.3,
                 lam_init: float = 1.0, lam_min: float = 0.05):
        self.p_pos = p_pos
        self.beta = beta
        self.lam_init = lam_init
        self.lam_min = lam_min
        self.rho = float(np.log(1.0 / beta))

    def init_duals(self, K: int, device):
        z = lambda: torch.zeros((K,), dtype=torch.float32, device=device)
        return {"a": z(), "b": z(), "alpha": z(),
                "lam": torch.full((K,), self.lam_init, dtype=torch.float32,
                                  device=device)}

    def _lam(self, duals):
        # torch.maximum, not clamp: at λ = lam_min (where ``project`` puts
        # it) both split the gradient in half, as jnp.maximum does
        lam = duals["lam"]
        return torch.maximum(lam, torch.full_like(lam, self.lam_min))

    def _neg_losses(self, h, duals):
        b, alpha = duals["b"][:, None], duals["alpha"][:, None]
        return (h - b) ** 2 + 2.0 * (1.0 + alpha) * h

    @staticmethod
    def _neg_safe(neg):
        """The negatives mask, or all ones on a worker with no negative:
        the inner log-sum-exp always runs on a non-empty mask, so an
        all-positive batch leaks no NaN into the gradient (the reference's
        double-where guard, objective.py:316-324)."""
        has_neg = torch.sum(neg, dim=-1) > 0
        return has_neg, torch.where(has_neg[:, None], neg, torch.ones_like(neg))

    def loss(self, h, y, duals, impl: str = "auto"):
        p = self.p_pos
        h = h.to(torch.float32)
        pos = y.to(torch.float32)
        neg = 1.0 - pos
        n_pos = torch.sum(pos, dim=-1)
        a, alpha = duals["a"], duals["alpha"]
        lam = self._lam(duals)
        mean_pos = lambda z: torch.sum(z * pos, dim=-1) / torch.clamp(n_pos, min=_EPS)
        pos_side = ((1.0 - p) * mean_pos((h - a[:, None]) ** 2)
                    - 2.0 * (1.0 + alpha) * (1.0 - p) * mean_pos(h)
                    - p * (1.0 - p) * alpha * alpha)
        has_neg, neg_safe = self._neg_safe(neg)
        # logsumexp(x, b=m) = logsumexp(x + log m): a masked entry is −inf,
        # whose softmax weight, and so gradient, is exactly 0
        lse = torch.logsumexp(self._neg_losses(h, duals) / lam[:, None]
                              + torch.log(neg_safe), dim=-1)
        dro = lam * (self.rho + lse - torch.log(torch.sum(neg_safe, dim=-1)))
        return pos_side + torch.where(has_neg, p * dro, torch.zeros_like(dro))

    def project(self, field: str, value):
        return torch.clamp(value, min=self.lam_min)

    def stage_duals(self, h, y, duals):
        """α* = E_q[h | y=-1] − E[h | y=1] with the negatives weighted by
        q ∝ exp(ℓ/λ) (``optimal_alpha`` tilted toward the hard negatives)."""
        h = h.to(torch.float32)
        pos = y.to(torch.float32)
        has_neg, neg_safe = self._neg_safe(1.0 - pos)
        logits = self._neg_losses(h, duals) / self._lam(duals)[:, None]
        logits = torch.where(neg_safe > 0.5, logits, float("-inf"))
        q = torch.softmax(logits, dim=-1)
        mean_neg = torch.where(has_neg, torch.sum(q * h, dim=-1), 0.0)
        mean_pos = torch.sum(h * pos, dim=-1) / torch.clamp(torch.sum(pos, dim=-1),
                                                            min=_EPS)
        return {"alpha": mean_neg - mean_pos}

    def metric(self, backend: str = "exact", **kw):
        kw.setdefault("beta", self.beta)
        return super().metric(backend, **kw)


class BCEObjective(Objective):
    """Dual-free binary cross-entropy (``repro.core.objective.BCEObjective``,
    objective.py:354-381): the dual tree is empty, so the executors run
    plain distributed SGD with no dual payload.

    The reference's docstring speaks of logits, but its executors hand the
    loss what ``M.score`` returns, the sigmoid of the score head; so does
    the port, and both take ``log_sigmoid`` of that same value."""

    name = "bce"
    metric_name = "auc"

    def __init__(self, p_pos: float = 0.5):
        self.p_pos = p_pos  # unused by the loss; kept for a uniform ctor

    def init_duals(self, K: int, device):
        return {}

    def loss(self, h, y, duals, impl: str = "auto"):
        h = h.to(torch.float32)
        y = y.to(torch.float32)
        return -torch.mean(y * F.logsigmoid(h) + (1.0 - y) * F.logsigmoid(-h),
                           dim=-1)


REGISTRY = {"auc": AUCObjective, "pauc_dro": PAUCDROObjective,
            "bce": BCEObjective}


def names() -> tuple[str, ...]:
    return tuple(REGISTRY)


def for_config(ccfg) -> Objective:
    """Build the configured objective from a ``CoDAConfig``."""
    name = getattr(ccfg, "objective", "auc")
    if name == "pauc_dro":
        return PAUCDROObjective(p_pos=ccfg.p_pos, beta=ccfg.pauc_beta)
    return REGISTRY[name](p_pos=ccfg.p_pos)
