"""End-to-end driver: CoDA-train a ~100M-parameter dense transformer scorer
for a few hundred steps on synthetic imbalanced sequence data (the twin of
the reference's ``examples/train_100m.py``).

The model is a qwen-family decoder (d=768, 12 layers, GQA 12:4, vocab
8192): 88,115,713 parameters by ``count_params``, as the reference counts
them.  Every local step launches ``auc_loss`` once, ``prox_update`` once
over every parameter leaf and ``flash_attention`` once per layer on the
card.

    PYTHONPATH=src python -m repro_torch.train_100m --steps 200 --workers 2
    PYTHONPATH=src python -m repro_torch.train_100m --device cpu --steps 16

The data come from numpy generators and the weights from a torch
generator, so the numbers differ from the reference's ``jax.random``
streams; the printed lines are the reference's.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch import disable_tf32, resolve_device
from repro_torch.configs import get_config
from repro_torch.core import coda, objective, schedules
from repro_torch.data import DataConfig, ShardedDataset
from repro_torch.models import model as M
from repro_torch.tree import tree_map


def build_config():
    base = get_config("qwen2.5-14b")
    return dataclasses.replace(
        base, name="qwen-100m", n_layers=12, d_model=768, n_heads=12,
        n_kv_heads=4, d_ff=2048, vocab_size=8192, head_dim=0)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--workers", type=int, default=2)
    ap.add_argument("--interval", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--eval-n", type=int, default=256)
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda unless you ask for cpu)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    if device.type == "cuda":
        disable_tf32()

    mcfg = build_config()
    n = M.count_params(mcfg)
    print(f"model: {mcfg.name}, {n / 1e6:.1f}M params, "
          f"K={args.workers}, I={args.interval}")
    dcfg = DataConfig(kind="tokens", vocab_size=mcfg.vocab_size, seq_len=args.seq,
                      signal=1.0)
    ds = ShardedDataset(dcfg, 4096, args.workers, seed=args.seed, target_p=0.71,
                        device=device)
    ccfg = coda.CoDAConfig(n_workers=args.workers, p_pos=ds.p_pos)
    stages = max(1, args.steps * args.workers // 256)
    sched = schedules.ScheduleConfig(
        n_workers=args.workers, eta0=0.2,
        T0=max(args.interval, args.steps // max(stages, 1)), I0=args.interval)
    test = ds.full(args.eval_n)

    def auc(state) -> float:
        params0 = tree_map(lambda x: x[:1], state["params"])
        with torch.no_grad():
            h, _ = M.score(mcfg, params0, {"tokens": test["tokens"][None]})
        return objective.roc_auc(h[0], test["labels"])

    # fit takes the only reference to the state: its executor donates it
    held = [coda.init_state(mcfg, ccfg, generator=torch.Generator().manual_seed(args.seed),
                            device=device)]
    t0 = time.time()
    res = coda.fit(held.pop(), mcfg, ccfg, sched, stages,
                   sample_window=lambda i: ds.sample_window(i, args.batch),
                   sample_alpha_batch=lambda m: ds.sample_alpha_batch(min(m, 64)))
    dt = time.time() - t0
    print(f"trained {res.iterations} iterations in {dt / 60:.1f} min "
          f"({dt / max(res.iterations, 1):.2f} s/iter)")
    print(f"communication rounds: {res.comm_rounds} "
          f"(I=1 naive parallel: {res.iterations + stages})")
    final = auc(res.state)
    print(f"final test AUC: {final:.4f}")
    losses = [h[2] for h in res.history]
    print(f"loss: first5={sum(losses[:5]) / 5:.4f} "
          f"last5={sum(losses[-5:]) / 5:.4f}")
    return {"n_params": n, "iterations": res.iterations, "comm_rounds": res.comm_rounds,
            "auc": final, "history": res.history}


if __name__ == "__main__":
    main()
