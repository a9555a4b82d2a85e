"""CoDA training launcher (counterpart of ``repro.launch.train``).

Runs the CoDA main path on one device: the K workers are a batched tensor
axis (the reference's ``--executor vmap``), every local step launches the
hand-written ``auc_loss`` kernel once and ``prox_update`` once per
parameter leaf.  It takes the reference's flags; those of features not
ported yet are rejected with the ROADMAP item that will bring them.

The device is ``cuda`` unless ``--device cpu`` is given; asking for
``cuda`` without a card raises.

Examples:
  PYTHONPATH=src python -m repro_torch.launch.train            # mlp defaults
  PYTHONPATH=src python -m repro_torch.launch.train --arch resnet50 \
      --stages 1 --t0 16 --interval 8
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
      --arch resnet50 --smoke --stages 1 --t0 4 --interval 2 --batch 8
"""
from __future__ import annotations

import argparse
import statistics
import time

import numpy as np
import torch

from repro_torch import disable_tf32, resolve_device
from repro_torch.configs import get_config, get_smoke_config, mlp_config
from repro_torch.core import coda, objective, schedules
from repro_torch.data import DataConfig, ShardedDataset
from repro_torch.models import model as M
from repro_torch.tree import tree_leaves, tree_map

DEFAULT_BINS = 2048   # repro.metrics.streaming.DEFAULT_BINS (flag default only)


def data_config_for(mcfg, p_pos: float) -> DataConfig:
    if mcfg.family == "mlp":
        return DataConfig(kind="features", p_pos=p_pos, n_features=mcfg.n_features)
    if mcfg.family == "cnn":
        return DataConfig(kind="images", p_pos=p_pos, image_hw=32)
    raise NotImplementedError(f"family {mcfg.family!r} is not ported yet "
                              "(ROADMAP Queue 1 item 11, model zoo)")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="mlp", help="mlp | resnet50")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced same-family config")
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda unless you ask for cpu)")
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--stages", type=int, default=3)
    ap.add_argument("--t0", type=int, default=60)
    ap.add_argument("--eta0", type=float, default=0.5)
    ap.add_argument("--interval", type=int, default=8, help="I (0 = Thm-1 rule)")
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--p-pos", type=float, default=0.71)
    ap.add_argument("--n-data", type=int, default=8192)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--dirichlet-alpha", type=float, default=float("inf"),
                    help="Dirichlet(α) label-skew across the K shards "
                         "(inf = IID even split, the paper's setting)")
    ap.add_argument("--compress", choices=["", "int8"], default="",
                    help="int8 = compressed averaging")
    ap.add_argument("--executor", default="vmap",
                    help="vmap = the single-device worker-batched executor")
    # the reference's flags for features not ported yet: accepted, and
    # rejected unless left at their defaults (see UNPORTED_FLAGS)
    ap.add_argument("--algorithm", default="coda")
    ap.add_argument("--objective", default="auc")
    ap.add_argument("--pauc-beta", type=float, default=0.3)
    ap.add_argument("--server-momentum", type=float, default=0.0)
    ap.add_argument("--optimizer", default="sgd")
    ap.add_argument("--opt-dtype", default="fp32")
    ap.add_argument("--opt-beta", type=float, default=0.9)
    ap.add_argument("--opt-eps", type=float, default=1e-6)
    ap.add_argument("--shampoo-block", type=int, default=32)
    ap.add_argument("--precond-every", type=int, default=1)
    ap.add_argument("--participation", type=float, default=1.0)
    ap.add_argument("--straggler-prob", type=float, default=0.0)
    ap.add_argument("--straggler-windows", type=int, default=1)
    ap.add_argument("--max-staleness", type=int, default=0)
    ap.add_argument("--fault-seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--policy", default="replica")
    ap.add_argument("--overlap", action="store_true")
    ap.add_argument("--overlap-chunks", type=int, default=4)
    ap.add_argument("--force-host-devices", type=int, default=0)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--metrics", default="exact")
    ap.add_argument("--metric-interval", type=int, default=0)
    ap.add_argument("--metric-bins", type=int, default=DEFAULT_BINS)
    return ap


# flag → ROADMAP item that ports it; a non-default value is rejected
UNPORTED_FLAGS = {
    "algorithm": "Queue 1 item 8 (CODASCA)",
    "objective": "Queue 1 item 3 (objectives)",
    "pauc_beta": "Queue 1 item 3 (objectives)",
    "server_momentum": "Queue 1 item 8 (server momentum)",
    "optimizer": "Queue 1 item 7 (optimizer seam)",
    "opt_dtype": "Queue 1 item 7 (optimizer seam)",
    "opt_beta": "Queue 1 item 7 (optimizer seam)",
    "opt_eps": "Queue 1 item 7 (optimizer seam)",
    "shampoo_block": "Queue 1 item 7 (optimizer seam)",
    "precond_every": "Queue 1 item 7 (optimizer seam)",
    "participation": "Queue 1 item 8 (faults)",
    "straggler_prob": "Queue 1 item 8 (faults)",
    "straggler_windows": "Queue 1 item 8 (faults)",
    "max_staleness": "Queue 1 item 8 (faults)",
    "fault_seed": "Queue 1 item 8 (faults)",
    "ckpt_dir": "Queue 1 item 9 (checkpoints)",
    "ckpt_every": "Queue 1 item 9 (checkpoints)",
    "resume": "Queue 1 item 9 (checkpoints)",
    "executor": "Queue 1 item 10 (distributed executor)",
    "policy": "Queue 1 item 10 (distributed executor)",
    "overlap": "Queue 1 item 10 (distributed executor)",
    "overlap_chunks": "Queue 1 item 10 (distributed executor)",
    "force_host_devices": "Queue 1 item 10 (distributed executor)",
    "multi_pod": "Queue 1 item 10 (distributed executor)",
    "metrics": "Queue 1 item 6 (streaming metrics)",
    "metric_interval": "Queue 1 item 6 (streaming metrics)",
    "metric_bins": "Queue 1 item 6 (streaming metrics)",
}


def reject_unported(ap: argparse.ArgumentParser, args) -> None:
    for name, item in UNPORTED_FLAGS.items():
        if getattr(args, name) != ap.get_default(name):
            ap.error(f"--{name.replace('_', '-')}={getattr(args, name)!r} is "
                     f"not ported to repro_torch yet (ROADMAP {item})")


def main(argv=None) -> dict:
    """Parse ``argv``, train, print the reference's summary lines, and
    return a summary dict (used by ``chip_smoke.py``)."""
    ap = build_parser()
    args = ap.parse_args(argv)
    reject_unported(ap, args)
    device = resolve_device(args.device)
    if device.type == "cuda":
        disable_tf32()

    if args.arch == "mlp":
        mcfg = mlp_config()
    elif args.smoke:
        mcfg = get_smoke_config(args.arch)
    else:
        mcfg = get_config(args.arch)

    dcfg = data_config_for(mcfg, args.p_pos)
    ds = ShardedDataset(dcfg, args.n_data, args.workers, seed=args.seed,
                        target_p=args.p_pos,
                        dirichlet_alpha=args.dirichlet_alpha, device=device)
    print(f"dataset: n={ds.n} p_pos={ds.p_pos:.3f} workers={args.workers}")
    if np.isfinite(args.dirichlet_alpha):
        pp = np.array(ds.shard_p_pos)
        print(f"non-IID shards (Dirichlet α={args.dirichlet_alpha:g}): "
              f"sizes={ds.shard_sizes} shard p_pos "
              f"[{pp.min():.2f}, {pp.max():.2f}] (std {pp.std():.3f})")

    ccfg = coda.CoDAConfig(n_workers=args.workers, p_pos=ds.p_pos,
                           avg_compress=args.compress)
    sched = schedules.ScheduleConfig(n_workers=args.workers, eta0=args.eta0,
                                     T0=args.t0, I0=args.interval,
                                     p_pos=ds.p_pos)
    gen = torch.Generator().manual_seed(args.seed)
    state = coda.init_state(mcfg, ccfg, generator=gen, device=device)
    leaves = tree_leaves(state["params"])
    n_params = sum(l.numel() for l in leaves) // args.workers
    print(f"model: {mcfg.name} params/worker={n_params:,} leaves={len(leaves)} "
          f"device={device}")

    test = ds.full(2048)

    def test_scores(st, chunk: int = 512):
        params0 = tree_map(lambda x: x[:1], st["params"])
        key = "features" if mcfg.family == "mlp" else "images"
        with torch.no_grad():
            hs = [M.score(mcfg, params0, {key: test[key][i:i + chunk][None]})[0][0]
                  for i in range(0, test["labels"].shape[0], chunk)]
        return torch.cat(hs)

    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    res = coda.fit(state, mcfg, ccfg, sched, args.stages,
                   sample_window=lambda i: ds.sample_window(i, args.batch),
                   sample_alpha_batch=lambda m: ds.sample_alpha_batch(m),
                   executor=args.executor)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    h_test = test_scores(res.state)
    auc = objective.roc_auc(h_test, test["labels"])
    print(f"done: {res.iterations} iters, {res.comm_rounds} comm rounds, "
          f"{dt:.1f}s, test AUC={auc:.4f}")
    compress = args.compress or None
    stage_list = schedules.stages(sched, args.stages)
    total = coda.comm_bytes(stage_list, res.state, compress,
                            stage_bytes=coda.stage_payload_bytes(ccfg))
    per_round = coda.window_payload_bytes(res.state, compress)
    print(f"bytes/round/worker={per_round:,} (schedule total {total:,})")
    # the first window carries one-off set-up (allocator growth, cuDNN
    # algorithm choice); the steady per-step time excludes it
    steady = res.step_seconds[1:] or res.step_seconds
    ms_per_step = 1e3 * statistics.median(steady)
    return {"auc": auc, "iterations": res.iterations, "history": res.history,
            "ms_per_local_step": ms_per_step, "leaves": len(leaves),
            "state": res.state, "test_scores": h_test}


if __name__ == "__main__":
    main()
