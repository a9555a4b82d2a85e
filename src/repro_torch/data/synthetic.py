"""Synthetic imbalanced binary-classification data with a planted signal
(counterpart of ``repro.data.synthetic``), drawn from numpy generators.

The reference's three modalities are ported, matching the ported model
families: ``features`` (mlp), ``images`` (cnn) and ``tokens`` (dense:
positive sequences over-sample a motif token set).  The batch setting is the
reference's: a fixed dataset, negatives dropped to reach the target
positive ratio, then partitioned across K workers (IID or Dirichlet(α)
label skew), and machine k only ever draws from shard k.

``jax.random`` streams cannot be reproduced here, so the draws differ from
the reference's; the equivalence tests replay the reference's windows
instead.  The dataset lives on ``device`` and windows are gathered there,
so the host only draws indices.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

# the fraction of the vocabulary that is "motif" tokens (the reference's
# ``DataConfig.motif_frac`` default; no ported caller sets another)
MOTIF_FRAC = 0.1


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """The reference's ``DataConfig`` fields that the ported kinds read."""

    kind: str = "features"     # features | images | tokens
    p_pos: float = 0.5
    vocab_size: int = 512
    seq_len: int = 64
    image_hw: int = 32
    n_features: int = 64
    signal: float = 1.0        # planted signal strength
    hard_neg_frac: float = 0.0  # features only: the fraction of negatives
                                # drawn near the positives (hard_negative_features)


def _draw(rng: np.random.Generator, dcfg: DataConfig, labels: np.ndarray) -> dict:
    """labels: [n] float32 → input dict with a leading [n] axis."""
    n = labels.shape[0]
    if dcfg.kind == "tokens":
        # positives take a motif token with probability signal·0.25
        # (``repro/data/synthetic.py:59-67``)
        n_motif = max(1, int(dcfg.vocab_size * MOTIF_FRAC))
        base = rng.integers(0, dcfg.vocab_size, (n, dcfg.seq_len))
        motif = rng.integers(0, n_motif, (n, dcfg.seq_len))
        use = rng.random((n, dcfg.seq_len)) < (dcfg.signal * 0.25 * labels[:, None])
        return {"tokens": np.where(use, motif, base).astype(np.int64)}
    if dcfg.kind == "images":
        hw = dcfg.image_hw
        x = rng.standard_normal((n, hw * hw, 3), dtype=np.float32)
        x += ((labels * 2 - 1) * dcfg.signal * 0.2)[:, None, None].astype(np.float32)
        return {"images": x}
    if dcfg.kind != "features":
        raise ValueError(f"unknown data kind {dcfg.kind!r} "
                         "(want features | images | tokens)")
    x = rng.standard_normal((n, dcfg.n_features), dtype=np.float32)
    if dcfg.hard_neg_frac > 0.0:
        u = rng.random(n, dtype=np.float32)
        return {"features": hard_negative_features(x, u, labels, dcfg)}
    x += ((labels * 2 - 1) * dcfg.signal * 0.3)[:, None].astype(np.float32)
    return {"features": x}


def hard_negative_features(x: np.ndarray, u: np.ndarray, labels: np.ndarray,
                           dcfg: DataConfig) -> np.ndarray:
    """The heteroscedastic negatives of ``repro/data/synthetic.py:73-93``
    from the draws: x [..., n_features] standard normal, u [...] uniform,
    labels [...] float32.  A negative with u < ``hard_neg_frac`` is hard:
    it sits at +0.25·s on the first half of the features, nearly on top of
    the positives, and at −0.2·s on the second half, where the positives sit
    at +0.2·s; the easy negatives stay at −0.3·s and 0.  Only the second
    half tells a hard negative from a positive, which is what partial-AUC
    training (``pauc_dro``) has to find.  fp32 throughout, as the
    reference's, so the same draws give the same bits."""
    half = x.shape[-1] // 2
    hard = ((u < dcfg.hard_neg_frac) & (labels < 0.5)).astype(np.float32)
    s = dcfg.signal
    prim = np.where(hard > 0.5, np.float32(0.25 * s),
                    (labels * 2 - 1) * np.float32(0.3) * np.float32(s))
    sec = np.float32(0.2 * s) * labels - np.float32(0.2 * s) * hard
    x = np.array(x, dtype=np.float32)
    x[..., :half] += prim[..., None]
    x[..., half:] += sec[..., None]
    return x


def sample_online(rng: np.random.Generator, dcfg: DataConfig, shape, *,
                  device: str | torch.device = "cpu") -> dict:
    """The online setting (``repro/data/synthetic.py:99``): iid draws with
    y ~ Bernoulli(``p_pos``), no fixed dataset.  ``shape`` is the batch's
    leading shape, e.g. (I, K, B); the labels are drawn first, then the
    inputs through ``_draw``.  Returns {input: tensor [*shape, ...],
    "labels": float32 [*shape]} on ``device``."""
    shape = tuple(shape)
    labels = (rng.random(shape) < dcfg.p_pos).astype(np.float32)
    batch = _draw(rng, dcfg, labels.reshape(-1))
    out = {k: torch.from_numpy(v.reshape(shape + v.shape[1:])).to(device)
           for k, v in batch.items()}
    out["labels"] = torch.from_numpy(labels).to(device)
    return out


def dirichlet_partition(rng: np.random.Generator, labels: np.ndarray,
                        n_workers: int, alpha: float):
    """Dirichlet(α) label-skew partition: per class c, q_c ~ Dir(α·1_K)
    decides the fraction of class-c samples each worker gets.  The shards
    tile [0, n) exactly; empty shards are topped up from the largest."""
    shards = [[] for _ in range(n_workers)]
    for c in np.unique(labels):
        idx = rng.permutation(np.nonzero(labels == c)[0])
        q = rng.dirichlet(np.full(n_workers, alpha))
        cuts = np.round(np.cumsum(q)[:-1] * len(idx)).astype(int)
        for k, part in enumerate(np.split(idx, cuts)):
            shards[k].append(part)
    shards = [np.concatenate(s) for s in shards]
    for k in range(n_workers):  # no worker may starve
        while len(shards[k]) == 0:
            donor = int(np.argmax([len(s) for s in shards]))
            shards[k], shards[donor] = shards[donor][-1:], shards[donor][:-1]
    return [rng.permutation(s) for s in shards]


class ShardedDataset:
    """Fixed dataset partitioned across K workers (machine k sees shard k).

    ``seed`` seeds three independent numpy streams: the data, the
    partition, and the minibatch draws (``draw_rng``, whose state a
    checkpoint carries so a resumed run draws the same windows)."""

    def __init__(self, dcfg: DataConfig, n: int, n_workers: int, *,
                 seed: int = 0, target_p: float | None = None,
                 dirichlet_alpha: float | None = None,
                 device: str | torch.device = "cpu"):
        self.dcfg = dcfg
        self.device = torch.device(device)
        data_ss, part_ss, draw_ss = np.random.SeedSequence(seed).spawn(3)
        rng = np.random.default_rng(data_ss)
        labels = (rng.random(n) < 0.5).astype(np.float32)
        if target_p is not None and target_p > 0.5:
            # keep all positives, drop negatives (paper §5 "Data")
            keep_neg = (1 - target_p) / target_p
            keep = (labels > 0.5) | (rng.random(n) < keep_neg)
            labels = labels[keep]
            n = len(labels)
        inputs = _draw(rng, dcfg, labels)
        self.inputs = {k: torch.from_numpy(v).to(self.device)
                       for k, v in inputs.items()}
        self.labels = torch.from_numpy(labels).to(self.device)
        self.n = n
        self.K = n_workers
        self.p_pos = float(labels.mean())
        self.dirichlet_alpha = dirichlet_alpha
        part = np.random.default_rng(part_ss)
        if dirichlet_alpha is None or not np.isfinite(dirichlet_alpha):
            perm = part.permutation(n)
            per = n // n_workers
            self.shards = [perm[k * per:(k + 1) * per] for k in range(n_workers)]
        else:
            self.shards = dirichlet_partition(part, labels, n_workers,
                                              dirichlet_alpha)
        self.shard_sizes = [len(s) for s in self.shards]
        self.shard_p_pos = [float(labels[s].mean()) if len(s) else 0.0
                            for s in self.shards]
        self.draw_rng = np.random.default_rng(draw_ss)

    def _gather(self, idx: np.ndarray) -> dict:
        ix = torch.from_numpy(idx).to(self.device)
        out = {k: v[ix] for k, v in self.inputs.items()}
        out["labels"] = self.labels[ix]
        return out

    def _pick(self, shape) -> np.ndarray:
        """Indices with replacement, worker k from shard k: shape [..., K, m]."""
        *lead, K, m = shape
        cols = [s[self.draw_rng.integers(0, len(s), size=tuple(lead) + (m,))]
                for s in self.shards]
        return np.stack(cols, axis=-2)

    def sample_window(self, I: int, B: int) -> dict:
        """[I, K, B, ...] minibatches; worker k draws only from shard k."""
        return self._gather(self._pick((I, self.K, B)))

    def sample_alpha_batch(self, m: int) -> dict:
        """[K, m, ...] minibatch for the stage-end α re-estimate."""
        return self._gather(self._pick((self.K, m)))

    def full(self, max_n: int = 4096) -> dict:
        n = min(self.n, max_n)
        out = {k: v[:n] for k, v in self.inputs.items()}
        out["labels"] = self.labels[:n]
        return out
