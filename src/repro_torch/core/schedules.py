"""Stagewise schedules for CoDA (Theorem 1) and the practical variants used
in the paper's experiments (§5: T_s = T₀·3^s, η_s = η₀/3^s, fixed or growing
I).  Pure-Python copy of ``repro.core.schedules``.
"""
from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class Stage:
    s: int
    eta: float
    T: int        # inner iterations this stage
    I: int        # communication interval (average every I local steps)
    m: int        # minibatch size for the stage-end α re-estimation


@dataclasses.dataclass(frozen=True)
class ScheduleConfig:
    n_workers: int
    eta0: float = 0.1
    T0: int = 200
    I0: int = 0            # 0 => Theorem-1 rule I_s = max(1, 1/sqrt(K·η_s))
    m0: int = 64
    mode: str = "practical"  # "practical" (×3 stagewise) | "theorem1"
    # Theorem-1 constants (only used in mode="theorem1")
    mu_over_L: float = 0.05
    p_pos: float = 0.5
    grow_I: bool = False   # Appendix-H variant: I_s = I0 · 3^{s-1}


def theorem1_c(mu_over_L: float) -> float:
    return mu_over_L / (5.0 + mu_over_L)


def stage(cfg: ScheduleConfig, s: int) -> Stage:
    """1-indexed stage s."""
    K = cfg.n_workers
    if cfg.mode == "theorem1":
        c = theorem1_c(cfg.mu_over_L)
        eta = cfg.eta0 * K * math.exp(-(s - 1) * c)
        T = max(1, int(math.ceil(cfg.T0 * math.exp((s - 1) * c) / (cfg.eta0 * K))))
        I = max(1, int(round(1.0 / math.sqrt(K * eta))))
        p = cfg.p_pos
        pt = max(p, 1 - p)
        C = 3 * pt ** (1 / math.log(1 / pt)) / (2 * math.log(1 / pt))
        eta_next = cfg.eta0 * K * math.exp(-s * c)
        T_next = max(1, int(math.ceil(cfg.T0 * math.exp(s * c) / (cfg.eta0 * K))))
        m = int(math.ceil(max(
            (1 + C) / (eta_next ** 2 * T_next * p ** 2 * (1 - p) ** 2),
            math.log(max(K, 2)) / math.log(1 / pt))))
        m = min(m, 100_000)  # practical clamp
        return Stage(s, eta, T, I, max(m, cfg.m0))
    # practical: the paper's experimental setting
    eta = cfg.eta0 / (3 ** (s - 1))
    T = cfg.T0 * (3 ** (s - 1))
    if cfg.I0 <= 0:
        I = max(1, int(round(1.0 / math.sqrt(K * eta))))
    elif cfg.grow_I:
        I = cfg.I0 * (3 ** (s - 1))
    else:
        I = cfg.I0
    return Stage(s, eta, T, min(I, T), cfg.m0)


def stages(cfg: ScheduleConfig, n_stages: int):
    return [stage(cfg, s) for s in range(1, n_stages + 1)]
