"""CoDA training launcher (counterpart of ``repro.launch.train``).

Runs CoDA on one device: the K workers are a batched tensor axis (the
reference's ``--executor vmap``).  Every local step launches the
hand-written ``auc_loss`` kernel once, then per parameter leaf one
``prox_update`` (``--optimizer sgd``, the default, and ``shampoo_blocked``)
or one ``opt_update`` (``momentum``, ``sm3``); the dense transformers
(``--arch stablelm-1.6b | qwen2.5-14b | phi3-medium-14b | chatglm3-6b``,
on the reference's ``tokens`` data at ``seq_len=64``) also launch
``flash_attention`` once per attention layer in every forward, and the MoE
transformers (``--arch dbrx-132b | arctic-480b``) ``grouped_matmul`` three
times per moe layer in every eval forward (the stage-end α batches and the
held-out chunks; local steps dispatch by capacity and launch none).  It
takes the reference's flags; those of features not ported yet are rejected
with the ROADMAP item that will bring them.  ``--n-layers`` (the port's
own) cuts a dense or moe config's depth so a full-width model trains on
one card.

Metric reporting, as the reference's: ``--metrics exact`` scores the
held-out split every ``--metric-interval`` windows; ``--metrics sketch``
turns on the in-training streaming sketch (``CoDAConfig.stream_bins =
--metric-bins``), whose report line shows the training-stream AUC with its
resolution bound and the per-worker AUC skew.

The device is ``cuda`` unless ``--device cpu`` is given; asking for
``cuda`` without a card raises.

Examples:
  PYTHONPATH=src python -m repro_torch.launch.train            # mlp defaults
  PYTHONPATH=src python -m repro_torch.launch.train --arch resnet50 \
      --stages 1 --t0 16 --interval 8
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
      --arch resnet50 --smoke --stages 1 --t0 4 --interval 2 --batch 8
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
      --optimizer momentum --opt-dtype bf16
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
      --metrics sketch --metric-interval 4
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
      --arch stablelm-1.6b --smoke --stages 2 --t0 30 --interval 8
  PYTHONPATH=src python -m repro_torch.launch.train --arch stablelm-1.6b \
      --n-layers 2 --stages 1 --t0 16 --n-data 1024     # full width, 2 layers
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
      --arch dbrx-132b --smoke --stages 2 --t0 30 --interval 8
"""
from __future__ import annotations

import argparse
import dataclasses
import statistics
import time

import numpy as np
import torch

from repro_torch import disable_tf32, resolve_device
from repro_torch.configs import DENSE_ARCHS, MOE_ARCHS, get_config, get_smoke_config, mlp_config
from repro_torch.core import coda, objective, optimizer, schedules
from repro_torch.data import DataConfig, ShardedDataset
from repro_torch.kernels import auc_loss as _auc_mod
from repro_torch.kernels import flash_attention as _fa_mod
from repro_torch.kernels import moe_dispatch as _moe_mod
from repro_torch.kernels import opt_update as _opt_mod
from repro_torch.kernels import prox_update as _prox_mod
from repro_torch.metrics import report as metric_report
from repro_torch.metrics import streaming
from repro_torch.models import model as M
from repro_torch.tree import tree_leaves, tree_map

KERNELS = {"auc_loss": _auc_mod, "prox_update": _prox_mod,
           "opt_update": _opt_mod, "flash_attention": _fa_mod,
           "grouped_matmul": _moe_mod}

# the held-out split is scored in chunks of this many examples (one
# forward each: per layer one flash_attention, and three grouped_matmul in
# an moe layer)
TEST_CHUNK = 512


def data_config_for(mcfg, p_pos: float) -> DataConfig:
    if mcfg.family == "mlp":
        return DataConfig(kind="features", p_pos=p_pos, n_features=mcfg.n_features)
    if mcfg.family == "cnn":
        return DataConfig(kind="images", p_pos=p_pos, image_hw=32)
    if mcfg.family in M.LM_FAMILIES:
        return DataConfig(kind="tokens", p_pos=p_pos, vocab_size=mcfg.vocab_size,
                          seq_len=64)
    raise NotImplementedError(f"family {mcfg.family!r} is not ported yet "
                              "(ROADMAP Queue 1 item 11, model zoo)")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="mlp",
                    help=f"mlp | resnet50 | {' | '.join(DENSE_ARCHS + MOE_ARCHS)}")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced same-family config")
    ap.add_argument("--n-layers", type=int, default=0,
                    help="cut a dense or moe config's depth to this many "
                         "layers (0 = the config's own; widths stay as they are)")
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
    ap.add_argument("--optimizer", choices=list(optimizer.names()),
                    default="sgd",
                    help="local primal optimizer (core/optimizer.py "
                         "registry); its state stays local, never on the "
                         "wire")
    ap.add_argument("--opt-dtype", choices=["fp32", "bf16"], default="fp32",
                    help="storage dtype for optimizer accumulators; bf16 "
                         "halves optimizer-state bytes (fp32 master math, "
                         "stochastically rounded stores)")
    ap.add_argument("--opt-beta", type=float, default=0.9,
                    help="momentum coefficient (--optimizer momentum)")
    ap.add_argument("--opt-eps", type=float, default=1e-6,
                    help="preconditioner damping (sm3 / shampoo_blocked)")
    ap.add_argument("--shampoo-block", type=int, default=32,
                    help="block size b of shampoo_blocked's [b, b] "
                         "statistics")
    ap.add_argument("--precond-every", type=int, default=1,
                    help="recompute the shampoo inverse root every N local "
                         "steps")
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
    metric_report.add_metric_args(ap)
    return ap


# flag → ROADMAP item that ports it; a non-default value is rejected
UNPORTED_FLAGS = {
    "algorithm": "Queue 1 item 8 (CODASCA)",
    "objective": "Queue 1 item 3 (objectives)",
    "pauc_beta": "Queue 1 item 3 (objectives)",
    "server_momentum": "Queue 1 item 8 (server momentum)",
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
}


def reject_unported(ap: argparse.ArgumentParser, args) -> None:
    for name, item in UNPORTED_FLAGS.items():
        if getattr(args, name) != ap.get_default(name):
            ap.error(f"--{name.replace('_', '-')}={getattr(args, name)!r} is "
                     f"not ported to repro_torch yet (ROADMAP {item})")


def main(argv=None) -> dict:
    """Parse ``argv``, train, print the reference's summary lines, and
    return a summary dict (used by ``chip_smoke.py``), with the kernel
    launches made during training under ``launches``."""
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
    if args.n_layers:
        if mcfg.family not in M.LM_FAMILIES:
            ap.error(f"--n-layers cuts a dense or moe config's depth; {args.arch} "
                     f"is {mcfg.family}")
        mcfg = dataclasses.replace(mcfg, n_layers=args.n_layers)

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
                           avg_compress=args.compress,
                           stream_bins=args.metric_bins
                           if args.metrics == "sketch" else 0,
                           optimizer=args.optimizer,
                           opt_dtype=torch.bfloat16
                           if args.opt_dtype == "bf16" else torch.float32,
                           opt_beta=args.opt_beta,
                           opt_eps=args.opt_eps,
                           shampoo_block=args.shampoo_block,
                           precond_every=args.precond_every)
    sched = schedules.ScheduleConfig(n_workers=args.workers, eta0=args.eta0,
                                     T0=args.t0, I0=args.interval,
                                     p_pos=ds.p_pos)
    gen = torch.Generator().manual_seed(args.seed)
    state = coda.init_state(mcfg, ccfg, generator=gen, device=device)
    leaves = tree_leaves(state["params"])
    n_params = sum(l.numel() for l in leaves) // args.workers
    print(f"model: {mcfg.name} params/worker={n_params:,} leaves={len(leaves)} "
          f"device={device}")
    if args.optimizer != "sgd":
        print(f"optimizer: {args.optimizer} ({args.opt_dtype}) "
              f"state={optimizer.abstract_state_bytes(ccfg, state['params']):,} "
              "B/worker (local only — never on the wire)")

    test = ds.full(2048)

    def test_scores(st, chunk: int = TEST_CHUNK):
        params0 = tree_map(lambda x: x[:1], st["params"])
        key = next(k for k in test if k != "labels")
        with torch.no_grad():
            hs = [M.score(mcfg, params0, {key: test[key][i:i + chunk][None]})[0][0]
                  for i in range(0, test["labels"].shape[0], chunk)]
        return torch.cat(hs)

    # the eval hook reports through the shared metric plumbing: sketch mode
    # lifts the in-training accumulator (state["sk_acc"]) to the host; exact
    # mode scores the held-out split
    obj = objective.for_config(ccfg)
    lo, hi = ccfg.stream_range
    met = obj.metric("sketch", bins=args.metric_bins, lo=lo, hi=hi) \
        if args.metrics == "sketch" else obj.metric("exact")
    n_evals = [0]

    def report(tick, mstate, n_seen: int) -> float:
        print(metric_report.metric_line("train", tick, met, mstate, n_seen=n_seen))
        return met.finalize(mstate)

    def eval_fn(st) -> float:
        n_evals[0] += 1
        if args.metrics == "sketch":
            sk = streaming.sketch_from_rows(st["sk_acc"], lo, hi)
            out = report(f"eval {n_evals[0]}", sk, int(sk.count))
            print(metric_report.worker_skew_line(
                "train", f"eval {n_evals[0]}", met, st["sk_loc"], lo, hi))
            return out
        ms = met.update(met.init(), test_scores(st), test["labels"])
        return report(f"eval {n_evals[0]}", ms, int(test["labels"].numel()))

    if device.type == "cuda":
        torch.cuda.synchronize(device)
    before = {k: m.launches for k, m in KERNELS.items()}
    t0 = time.perf_counter()
    res = coda.fit(state, mcfg, ccfg, sched, args.stages,
                   sample_window=lambda i: ds.sample_window(i, args.batch),
                   sample_alpha_batch=lambda m: ds.sample_alpha_batch(m),
                   eval_every=args.metric_interval,
                   eval_fn=eval_fn if args.metric_interval else None,
                   executor=args.executor)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    launches = {k: m.launches - before[k] for k, m in KERNELS.items()}
    h_test = test_scores(res.state)
    auc = objective.roc_auc(h_test, test["labels"])
    print(f"done: {res.iterations} iters, {res.comm_rounds} comm rounds, "
          f"{dt:.1f}s, test AUC={auc:.4f}")
    if args.metrics == "sketch":
        sk = streaming.sketch_from_rows(res.state["sk_acc"], lo, hi)
        report("final train-stream", sk, int(sk.count))
        print(metric_report.worker_skew_line("train", "final", met,
                                             res.state["sk_loc"], lo, hi))
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
            "state": res.state, "test_scores": h_test, "launches": launches,
            "n_test": int(test["labels"].shape[0]), "stages": len(stage_list),
            "opt_state_bytes": coda.opt_state_bytes(res.state)}


if __name__ == "__main__":
    main()
