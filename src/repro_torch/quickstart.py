"""Quickstart: distributed AUC maximization with CoDA in a few seconds
(the twin of the reference's ``examples/quickstart.py``).

Builds an imbalanced synthetic dataset (p = 0.71, the paper's setting),
partitions it across K = 4 simulated workers (each worker only ever draws
from its own shard, as in Algorithm 1), and runs 3 proximal-point stages
of CoDA with communication every I = 8 local steps.  Every local step
launches the ``auc_loss`` kernel once and ``prox_update`` once over every
parameter leaf on the card.

    PYTHONPATH=src python -m repro_torch.quickstart              # on the card
    PYTHONPATH=src python -m repro_torch.quickstart --device cpu

The data come from numpy generators, so the draws differ from the
reference's ``jax.random`` streams; ``run`` takes the initial state, the
samplers and the held-out split as arguments, so the reference's own can be
replayed through it.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch import disable_tf32, resolve_device
from repro_torch.configs.base import mlp_config
from repro_torch.core import coda, objective, schedules
from repro_torch.data import DataConfig, ShardedDataset
from repro_torch.models import model as M
from repro_torch.tree import tree_map

K, I, BATCH = 4, 8, 32
N_DATA, N_TEST, N_STAGES, T0, ETA0 = 8192, 2048, 3, 64, 0.5
MCFG = mlp_config(n_features=32, d=64)
DCFG = DataConfig(kind="features", n_features=32, signal=1.5)


def test_auc(state, test) -> float:
    """Worker 0's replica scored on the held-out split."""
    params0 = tree_map(lambda x: x[:1], state["params"])
    with torch.no_grad():
        h, _ = M.score(MCFG, params0, {"features": test["features"][None]})
    return objective.roc_auc(h[0], test["labels"])


def run(state, p_pos: float, test, sample_window, sample_alpha_batch) -> dict:
    """Fit from ``state`` (consumed: ``coda.fit``'s executor donates it) and
    print the reference's summary lines; the samplers are ``coda.fit``'s.
    Returns the history, the counters and the final test AUC."""
    ccfg = coda.CoDAConfig(n_workers=K, p_pos=p_pos)
    sched = schedules.ScheduleConfig(n_workers=K, eta0=ETA0, T0=T0, I0=I)
    res = coda.fit(state, MCFG, ccfg, sched, N_STAGES,
                   sample_window=sample_window,
                   sample_alpha_batch=sample_alpha_batch)
    auc = test_auc(res.state, test)
    print(f"iterations            : {res.iterations}")
    print(f"communication rounds  : {res.comm_rounds} "
          f"(naive parallel would need {res.iterations + N_STAGES})")
    print(f"bytes/round/worker    : {coda.model_bytes(res.state):,}")
    print(f"final test AUC        : {auc:.4f}")
    return {"history": res.history, "iterations": res.iterations,
            "comm_rounds": res.comm_rounds, "auc": auc, "state": res.state}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda unless you ask for cpu)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    if device.type == "cuda":
        disable_tf32()
    ds = ShardedDataset(DCFG, N_DATA, K, seed=args.seed, target_p=0.71,
                        device=device)
    print(f"dataset: n={ds.n}, positive ratio={ds.p_pos:.3f}, {K} workers")
    ccfg = coda.CoDAConfig(n_workers=K, p_pos=ds.p_pos)
    # run hands the state to fit, which consumes it: no name here keeps it
    out = run(coda.init_state(MCFG, ccfg, generator=torch.Generator().manual_seed(args.seed),
                              device=device), ds.p_pos, ds.full(N_TEST),
              sample_window=lambda i: ds.sample_window(i, BATCH),
              sample_alpha_batch=ds.sample_alpha_batch)
    assert out["auc"] > 0.85
    return out


if __name__ == "__main__":
    main()
