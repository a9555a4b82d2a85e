"""Synthetic imbalanced binary-classification data with a planted signal
(counterpart of ``repro.data.synthetic``), drawn from numpy generators.

Two of the reference's three modalities are ported, matching the ported
model families: ``features`` (mlp) and ``images`` (cnn); ``tokens`` arrives
with the model zoo (ROADMAP Queue 1, item 11).  The batch setting is the
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


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """The reference's ``DataConfig`` fields that the ported kinds read
    (``tokens`` and the hard-negative mix come with the model zoo and
    ``pauc_dro``)."""

    kind: str = "features"     # features | images
    p_pos: float = 0.5
    image_hw: int = 32
    n_features: int = 64
    signal: float = 1.0        # planted signal strength


def _draw(rng: np.random.Generator, dcfg: DataConfig, labels: np.ndarray) -> dict:
    """labels: [n] float32 → input dict with a leading [n] axis."""
    n = labels.shape[0]
    if dcfg.kind == "images":
        hw = dcfg.image_hw
        x = rng.standard_normal((n, hw * hw, 3), dtype=np.float32)
        x += ((labels * 2 - 1) * dcfg.signal * 0.2)[:, None, None].astype(np.float32)
        return {"images": x}
    if dcfg.kind != "features":
        raise NotImplementedError(f"data kind {dcfg.kind!r} is not ported yet "
                                  "(ROADMAP Queue 1 item 11, model zoo)")
    x = rng.standard_normal((n, dcfg.n_features), dtype=np.float32)
    x += ((labels * 2 - 1) * dcfg.signal * 0.3)[:, None].astype(np.float32)
    return {"features": x}


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
    partition, and the minibatch draws."""

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
        self._draw_rng = np.random.default_rng(draw_ss)

    def _gather(self, idx: np.ndarray) -> dict:
        ix = torch.from_numpy(idx).to(self.device)
        out = {k: v[ix] for k, v in self.inputs.items()}
        out["labels"] = self.labels[ix]
        return out

    def _pick(self, shape) -> np.ndarray:
        """Indices with replacement, worker k from shard k: shape [..., K, m]."""
        *lead, K, m = shape
        cols = [s[self._draw_rng.integers(0, len(s), size=tuple(lead) + (m,))]
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
