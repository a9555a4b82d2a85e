"""Mergeable score sketches for streaming tie-aware AUC / pAUC@FPR≤β
(counterpart of ``repro.metrics.streaming``).

A ``ScoreSketch`` holds two fp32 count vectors ``pos[B]``, ``neg[B]`` over
``B`` equal-width bins on ``[lo, hi)`` (scores outside are clipped into the
end bins).  ``update`` histograms a batch, ``merge`` adds counts, and
``auc_from_counts`` / ``pauc_from_counts`` finalize with the computable
resolution bounds ``auc_resolution`` / ``pauc_resolution``:

    |AUC_sketch − AUC_exact| ≤ Σ_b p_b·n_b / (2·P·N)

(the derivation is in the reference's module docstring).  Counts are
integer-valued fp32, so every addition is exact while a count stays below
2²⁴: merge order, and the order of the atomics that ``update_counts`` uses
on the card, cannot change a count.

Two binning paths share one fp32 formula and one scale constant, so they
put every score in the same bin as the reference: ``_bin_index_np`` on the
host (NumPy) and ``bin_index`` on tensors (the training path's
``update_counts``, which runs on the device).

``Metric`` is the mergeable evaluation protocol (``init``, ``update``,
``merge``, ``finalize``, ``resolution``, ``state_bytes``), with the
``exact`` backend (``ExactMetric``, through ``objective.roc_auc`` /
``objective.partial_auc``) and the ``sketch`` backend (``SketchMetric``);
``make_metric(kind, backend)`` builds either.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

DEFAULT_BINS = 2048
DEFAULT_RANGE: tuple[float, float] = (-8.0, 8.0)


def _host(x) -> np.ndarray:
    """A score or label array as fp32 numpy, from numpy or any tensor."""
    if isinstance(x, torch.Tensor):
        x = x.detach().to("cpu", torch.float32).numpy()
    return np.asarray(x, np.float32)


# --------------------------------------------------------------------------
# binning — one fp32 formula shared by the host and tensor paths
# --------------------------------------------------------------------------
def _scale(lo: float, hi: float, bins: int) -> float:
    """The fp32 bins/(hi−lo) factor, as a Python float holding an fp32
    value, so both paths multiply by the same constant."""
    return float(np.float32(bins / (hi - lo)))


def _bin_index_np(scores, lo: float, hi: float, bins: int) -> np.ndarray:
    s = _host(scores).ravel()
    t = (np.clip(s, np.float32(lo), np.float32(hi)) - np.float32(lo))
    idx = np.floor(t * np.float32(_scale(lo, hi, bins))).astype(np.int64)
    return np.clip(idx, 0, bins - 1)


def bin_index(scores, lo: float, hi: float, bins: int):
    """Tensor twin of the host binning (``repro.metrics.streaming.bin_index``,
    streaming.py:123-128): clip, subtract lo, multiply by the fp32 scale,
    floor — each an fp32 operation on fp32-exact constants."""
    s = scores.to(torch.float32)
    t = torch.clamp(s, float(np.float32(lo)), float(np.float32(hi))) - float(np.float32(lo))
    idx = torch.floor(t * _scale(lo, hi, bins)).to(torch.int64)
    return torch.clamp(idx, 0, bins - 1)


def update_counts(pos, neg, scores, labels, lo: float, hi: float):
    """Scatter-add a batch of scores into fp32 count vectors, row by row:
    ``pos``/``neg`` [..., bins], ``scores``/``labels`` [..., T] with the
    same leading axes (the training path passes [K, bins] and [K, B], one
    row per worker).  Returns new (pos, neg).

    ``index_add`` runs with atomics on CUDA, in no fixed order; the added
    values are 0 and 1 and every count stays an integer below 2²⁴, so each
    sum is exact whatever the order."""
    bins = pos.shape[-1]
    rows = pos.numel() // bins
    idx = bin_index(scores.reshape(rows, -1), lo, hi, bins)
    idx = (idx + bins * torch.arange(rows, device=idx.device)[:, None]).reshape(-1)
    w = (labels.reshape(-1) > 0.5).to(torch.float32)
    return (pos.reshape(-1).index_add(0, idx, w).reshape(pos.shape),
            neg.reshape(-1).index_add(0, idx, 1.0 - w).reshape(neg.shape))


# --------------------------------------------------------------------------
# the host-side sketch
# --------------------------------------------------------------------------
@dataclasses.dataclass
class ScoreSketch:
    """Fixed-size mergeable (pos, neg) score histogram.

    ``under``/``over`` count the scores that fell outside ``[lo, hi)`` and
    were saturated into an end bin (host-side only: they do not ride the
    training wire, so a sketch lifted from the training state carries zeros
    and exposes ``edge_mass`` as the observable upper bound instead)."""

    pos: np.ndarray  # fp32 [bins] positive-score counts
    neg: np.ndarray  # fp32 [bins] negative-score counts
    lo: float
    hi: float
    under: float = 0.0  # scores < lo, saturated into bin 0
    over: float = 0.0   # scores >= hi, saturated into bin B-1

    @property
    def bins(self) -> int:
        return int(self.pos.shape[-1])

    @property
    def nbytes(self) -> int:
        return int(self.pos.nbytes + self.neg.nbytes)

    @property
    def count(self) -> int:
        return int(float(self.pos.sum() + self.neg.sum()))

    @property
    def clipped(self) -> float:
        """Exact fraction of observed scores saturated at the range ends."""
        c = self.count
        return float(self.under + self.over) / c if c else 0.0

    @property
    def edge_mass(self) -> float:
        """Fraction of all counts in the two end bins (≥ the clipped
        fraction, computable from the counts alone)."""
        c = self.count
        if not c:
            return 0.0
        return float(self.pos[0] + self.pos[-1] +
                     self.neg[0] + self.neg[-1]) / c


def empty_sketch(bins: int = DEFAULT_BINS, lo: float = DEFAULT_RANGE[0],
                 hi: float = DEFAULT_RANGE[1]) -> ScoreSketch:
    if bins < 1:
        raise ValueError(f"bins must be >= 1, got {bins}")
    if not hi > lo:
        raise ValueError(f"need hi > lo, got [{lo}, {hi})")
    return ScoreSketch(np.zeros(bins, np.float32), np.zeros(bins, np.float32),
                       float(lo), float(hi))


def update(sk: ScoreSketch, scores, labels) -> ScoreSketch:
    """Histogram a batch of (score, label) pairs; returns a new sketch."""
    s = _host(scores).ravel()
    y = _host(labels).ravel()
    if s.shape != y.shape:
        raise ValueError(f"scores {s.shape} vs labels {y.shape}")
    idx = _bin_index_np(s, sk.lo, sk.hi, sk.bins)
    pos, neg = sk.pos.copy(), sk.neg.copy()
    is_pos = y > 0.5
    np.add.at(pos, idx[is_pos], np.float32(1.0))
    np.add.at(neg, idx[~is_pos], np.float32(1.0))
    under = sk.under + float(np.count_nonzero(s < np.float32(sk.lo)))
    over = sk.over + float(np.count_nonzero(s >= np.float32(sk.hi)))
    return ScoreSketch(pos, neg, sk.lo, sk.hi, under, over)


def merge(a: ScoreSketch, b: ScoreSketch) -> ScoreSketch:
    """Exact (associative, commutative) elementwise count addition."""
    if a.bins != b.bins or a.lo != b.lo or a.hi != b.hi:
        raise ValueError(
            f"incompatible sketches: {a.bins}@[{a.lo},{a.hi}) vs "
            f"{b.bins}@[{b.lo},{b.hi})")
    return ScoreSketch(a.pos + b.pos, a.neg + b.neg, a.lo, a.hi,
                       a.under + b.under, a.over + b.over)


def sketch_from_rows(sk_tree, lo: float, hi: float,
                     row: int = 0) -> ScoreSketch:
    """Lift one row of a training-state sketch subtree (``state["sk_acc"]``
    — {"pos": [K, B], "neg": [K, B]}) to a host ``ScoreSketch``.  After a
    window average every row of ``sk_acc`` is identical, so row 0 is the
    global accumulator."""
    return ScoreSketch(_host(sk_tree["pos"][row]), _host(sk_tree["neg"][row]),
                       float(lo), float(hi))


def worker_sketches(sk_tree, lo: float, hi: float) -> list:
    """Every row of a per-worker sketch subtree (``state["sk_loc"]``, the
    never-averaged per-worker counts) as one host sketch each."""
    return [sketch_from_rows(sk_tree, lo, hi, row=k)
            for k in range(int(sk_tree["pos"].shape[0]))]


# --------------------------------------------------------------------------
# finalize: counts → AUC / pAUC + computable resolution bounds
# --------------------------------------------------------------------------
def _counts64(pos, neg):
    p = _host(pos).astype(np.float64).ravel()
    n = _host(neg).astype(np.float64).ravel()
    return p, n, float(p.sum()), float(n.sum())


def auc_from_counts(pos, neg) -> float:
    """Tie-aware AUC from bin counts (same-bin pairs score 1/2)."""
    p, n, P, N = _counts64(pos, neg)
    if P <= 0 or N <= 0:
        return 0.0
    below = np.concatenate([[0.0], np.cumsum(n)[:-1]])
    return float(np.sum(p * (below + 0.5 * n)) / (P * N))


def auc_resolution(pos, neg) -> float:
    """Deterministic bound on |AUC_sketch − AUC_exact|."""
    p, n, P, N = _counts64(pos, neg)
    if P <= 0 or N <= 0:
        return 0.0
    return float(np.sum(p * n) / (2.0 * P * N))


def _select_hard_negatives(n: np.ndarray, k: int) -> np.ndarray:
    """Per-bin counts of the k highest-scoring negatives: whole bins from
    the top down, a partial count in the cutoff bin."""
    above = np.cumsum(n[::-1])[::-1] - n  # negatives in strictly higher bins
    return np.clip(float(k) - above, 0.0, n)


def _pauc_k(beta: float, N: float) -> int:
    # the exact estimator's k (objective.partial_auc)
    return max(1, int(np.ceil(beta * N)))


def pauc_from_counts(pos, neg, beta: float) -> float:
    """Tie-aware pAUC@FPR≤β from bin counts: positives ranked against the
    k = max(1, ceil(β·N)) hardest negatives, selected by bin."""
    p, n, P, N = _counts64(pos, neg)
    if P <= 0 or N <= 0:
        return 0.0
    sel = _select_hard_negatives(n, _pauc_k(beta, N))
    k = float(sel.sum())
    below = np.concatenate([[0.0], np.cumsum(sel)[:-1]])
    return float(np.sum(p * (below + 0.5 * sel)) / (P * k))


def pauc_resolution(pos, neg, beta: float) -> float:
    """Deterministic bound on |pAUC_sketch − pAUC_exact|."""
    p, n, P, N = _counts64(pos, neg)
    if P <= 0 or N <= 0:
        return 0.0
    sel = _select_hard_negatives(n, _pauc_k(beta, N))
    k = float(sel.sum())
    return float(np.sum(p * sel) / (2.0 * P * k))


# --------------------------------------------------------------------------
# the Metric protocol + backends
# --------------------------------------------------------------------------
class Metric:
    """Mergeable evaluation metric: ``init``/``update``/``merge``/
    ``finalize`` (+ ``resolution``/``state_bytes`` introspection)."""

    name: str = "metric"
    backend: str = ""

    def init(self):
        raise NotImplementedError

    def update(self, state, scores, labels):
        raise NotImplementedError

    def merge(self, a, b):
        raise NotImplementedError

    def finalize(self, state) -> float:
        raise NotImplementedError

    def resolution(self, state) -> float:
        """Bound on |finalize(state) − exact|; 0.0 for exact backends."""
        return 0.0

    def state_bytes(self, state) -> int:
        raise NotImplementedError

    def compute(self, scores, labels) -> float:
        """One-shot convenience: init → update → finalize."""
        return self.finalize(self.update(self.init(), scores, labels))


class ExactMetric(Metric):
    """Materialise-everything backend: state is a list of (scores, labels)
    chunks, finalized through ``objective.roc_auc`` /
    ``objective.partial_auc``."""

    backend = "exact"

    def __init__(self, beta: float | None = None):
        self.beta = None if beta is None else float(beta)
        self.name = "auc" if beta is None else "pauc"

    def init(self):
        return []

    def update(self, state, scores, labels):
        s, y = _host(scores).ravel(), _host(labels).ravel()
        if s.shape != y.shape:
            raise ValueError(f"scores {s.shape} vs labels {y.shape}")
        return list(state) + [(s, y)]

    def merge(self, a, b):
        return list(a) + list(b)

    def finalize(self, state) -> float:
        from repro_torch.core import objective  # deferred: objective builds Metrics

        if not state:
            return 0.0
        s = np.concatenate([c[0] for c in state])
        y = np.concatenate([c[1] for c in state])
        if self.beta is None:
            return objective.roc_auc(torch.from_numpy(s), torch.from_numpy(y))
        return objective.partial_auc(s, y, self.beta)

    def state_bytes(self, state) -> int:
        return int(sum(c[0].nbytes + c[1].nbytes for c in state))


class SketchMetric(Metric):
    """Fixed-size streaming backend over ``ScoreSketch`` states."""

    backend = "sketch"

    def __init__(self, beta: float | None = None, *,
                 bins: int = DEFAULT_BINS, lo: float = DEFAULT_RANGE[0],
                 hi: float = DEFAULT_RANGE[1]):
        empty_sketch(bins, lo, hi)  # validate once, loudly
        self.beta = None if beta is None else float(beta)
        self.name = "auc" if beta is None else "pauc"
        self.bins, self.lo, self.hi = int(bins), float(lo), float(hi)

    def init(self) -> ScoreSketch:
        return empty_sketch(self.bins, self.lo, self.hi)

    def update(self, state, scores, labels):
        return update(state, scores, labels)

    def merge(self, a, b):
        return merge(a, b)

    def finalize(self, state) -> float:
        if self.beta is None:
            return auc_from_counts(state.pos, state.neg)
        return pauc_from_counts(state.pos, state.neg, self.beta)

    def resolution(self, state) -> float:
        if self.beta is None:
            return auc_resolution(state.pos, state.neg)
        return pauc_resolution(state.pos, state.neg, self.beta)

    def state_bytes(self, state) -> int:
        return state.nbytes


def make_metric(kind: str = "auc", backend: str = "exact", *,
                beta: float = 0.3, bins: int = DEFAULT_BINS,
                lo: float = DEFAULT_RANGE[0],
                hi: float = DEFAULT_RANGE[1]) -> Metric:
    """Build a metric: ``kind`` ∈ {auc, pauc}, ``backend`` ∈ {exact, sketch}.
    ``beta`` applies to pauc only; ``bins``/``lo``/``hi`` to sketch only."""
    if kind not in ("auc", "pauc"):
        raise ValueError(f"unknown metric kind {kind!r} (auc | pauc)")
    b = beta if kind == "pauc" else None
    if backend == "exact":
        return ExactMetric(b)
    if backend == "sketch":
        return SketchMetric(b, bins=bins, lo=lo, hi=hi)
    raise ValueError(f"unknown metric backend {backend!r} (exact | sketch)")
