"""Seed-deterministic fault injection for windowed training, counterpart
of ``repro.core.faults`` (numpy only, so the port keeps its own copy and
replays the reference's schedule bitwise).

A ``FaultPlan`` schedules three fault kinds against the K-worker window
loop, replayable from a seed:

  * **dropout** — with probability ``dropout`` a worker misses one window:
    its delta never reaches the merge (weight 0) but it receives the merged
    state (resync 1), the partial-participation model of Yuan et al. 2021.
  * **straggle** — with probability ``straggle`` a worker's window delta is
    delayed by ``straggle_windows`` windows.  While in flight it is absent
    AND keeps its own local state (resync 0).  On arrival, a delay
    d ≤ ``max_staleness`` merges the stale delta with the weight
    ``staleness_discount ** d``; beyond that the delta is dropped and the
    worker only re-syncs from the merged state (the round never waits).
  * **crash** — ``crashes = ((worker, window), ...)``: from its crash
    window on, a worker contributes weight 0 forever and passively tracks
    the merged state (its replica keeps its shape: a crash is a data event,
    not a shape event).

Per window ``w`` the plan yields two float32 [K] vectors consumed by the
masked window averaging (``core/bucketing.py``):

  * ``weights`` u_k — the worker's weight in the masked mean (1 fresh, 0
    absent, ``discount**d`` for a rejoining straggler);
  * ``resync`` r_k — 1 if the worker adopts the merged state after the
    merge, 0 if it keeps its own iterate (mid-straggle only).

The schedule is computed sequentially (window w depends on the straggle
history of windows < w) and cached, so ``window(w)`` is cheap and two
plans built from the same arguments replay identically — the determinism
that ``coda.fit``'s crash-resume relies on.  The plan never yields an
all-absent window: it first re-admits a dropped worker, else force-merges
an in-flight straggler; if every worker has crashed it raises.

``staleness_discount`` defaults to 0.5: powers of two survive the cast to
bf16 exactly, so the weight-prescaled rows stay exact in bf16 buckets.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """Seed-replayable per-window fault schedule for K workers."""
    n_workers: int
    seed: int = 0
    dropout: float = 0.0           # per-window per-worker dropout prob
    straggle: float = 0.0          # per-window prob a fresh worker straggles
    straggle_windows: int = 1      # straggler delay d, measured in windows
    max_staleness: int = 0         # merge stale deltas up to this delay
    staleness_discount: float = 0.5
    crashes: tuple = ()            # ((worker, window), ...): permanent deaths

    def __post_init__(self):
        if self.n_workers < 1:
            raise ValueError(f"n_workers must be >= 1, got {self.n_workers}")
        if not 0.0 <= self.dropout < 1.0:
            raise ValueError(f"dropout must be in [0, 1), got {self.dropout}")
        if not 0.0 <= self.straggle < 1.0:
            raise ValueError(f"straggle must be in [0, 1), got "
                             f"{self.straggle}")
        if self.straggle_windows < 1:
            raise ValueError(f"straggle_windows must be >= 1, got "
                             f"{self.straggle_windows}")
        if self.max_staleness < 0:
            raise ValueError(f"max_staleness must be >= 0, got "
                             f"{self.max_staleness}")
        if not 0.0 < self.staleness_discount <= 1.0:
            raise ValueError(f"staleness_discount must be in (0, 1], got "
                             f"{self.staleness_discount}")
        for c in self.crashes:
            k, w = c
            if not (0 <= k < self.n_workers) or w < 0:
                raise ValueError(f"bad crash entry {c!r} for "
                                 f"{self.n_workers} workers")
        # the sequential schedule cache: windows are generated in order from
        # one Generator so window w's straggle state sees windows < w.  A
        # frozen dataclass may still carry mutable cache state.
        object.__setattr__(self, "_rng", np.random.default_rng(self.seed))
        object.__setattr__(self, "_windows", [])
        object.__setattr__(self, "_straggling",
                           np.zeros(self.n_workers, np.int64))
        object.__setattr__(self, "_crash_at",
                           {k: w for k, w in self.crashes})

    @classmethod
    def from_config(cls, ccfg) -> "FaultPlan":
        """Build the plan a ``CoDAConfig``'s fault knobs describe (the path
        ``coda.fit`` takes when ``ccfg.faults_enabled``)."""
        return cls(
            n_workers=ccfg.n_workers,
            seed=ccfg.fault_seed,
            dropout=1.0 - ccfg.participation,
            straggle=ccfg.straggler_prob,
            straggle_windows=ccfg.straggler_windows,
            max_staleness=ccfg.max_staleness,
            staleness_discount=ccfg.staleness_discount,
            crashes=tuple(ccfg.crashes),
        )

    # -- schedule generation ------------------------------------------------
    def _next_window(self):
        """Append one window to the cache (called in window order only)."""
        w = len(self._windows)
        K = self.n_workers
        # both vectors are drawn every window regardless of worker state so
        # the random stream — and therefore the whole schedule — is a pure
        # function of (seed, window index)
        drop = self._rng.random(K) < self.dropout
        sflip = self._rng.random(K) < self.straggle
        u = np.ones(K, np.float32)
        r = np.ones(K, np.float32)
        dropped, in_flight = [], []
        for k in range(K):
            if self._crash_at.get(k, w + 1) <= w:
                u[k] = 0.0                       # dead: weight 0, track merged
                continue
            if self._straggling[k] > 0:
                self._straggling[k] -= 1
                if self._straggling[k] == 0:     # stale delta arrives now
                    d = self.straggle_windows
                    if d <= self.max_staleness:
                        u[k] = np.float32(self.staleness_discount) ** d
                    else:
                        u[k] = 0.0               # too stale: drop + re-sync
                else:                            # still in flight
                    u[k], r[k] = 0.0, 0.0
                    in_flight.append(k)
                continue
            if sflip[k]:
                self._straggling[k] = self.straggle_windows
                u[k], r[k] = 0.0, 0.0
                in_flight.append(k)
                continue
            if drop[k]:
                u[k] = 0.0
                dropped.append(k)
        if float(u.sum()) == 0.0:
            # never an all-absent window: re-admit a dropped worker, else
            # force-merge an in-flight straggler at full weight
            if dropped:
                u[dropped[0]] = 1.0
            elif in_flight:
                k = in_flight[0]
                self._straggling[k] = 0
                u[k], r[k] = 1.0, 1.0
            else:
                raise RuntimeError(
                    "FaultPlan: every worker has crashed before window "
                    f"{w}; no participants remain")
        self._windows.append((u, r))

    def window(self, w: int):
        """(weights, resync) float32 [K] vectors for window ``w``."""
        if w < 0:
            raise ValueError(f"window index must be >= 0, got {w}")
        while len(self._windows) <= w:
            self._next_window()
        u, r = self._windows[w]
        return u.copy(), r.copy()

    def participants(self, w: int) -> np.ndarray:
        """Binary participation mask for window ``w`` (u_k > 0)."""
        u, _ = self.window(w)
        return (u > 0).astype(np.float32)
