"""CoDA training launcher (counterpart of ``repro.launch.train``).

Executors (``--executor``): ``vmap`` runs the K workers as a batched
tensor axis on one device; ``shard_map`` lays them over ranks of
``torch.distributed`` (core/coda_sharded.py): one rank a card under NCCL,
R = ``torch.cuda.device_count()``, or R = ``--force-host-devices`` gloo
ranks on the CPU; under ``torchrun`` (``WORLD_SIZE`` set) it joins that
group instead.  The I local steps issue no collective, and each window
one all_reduce per dtype bucket (``--compress int8``: an s8 + f32
all_gather pair; ``--overlap``: window pairs whose averagings run as
``--overlap-chunks`` point-to-point rings).  Rank 0 prints and returns the
summary; ``--policy`` and ``--multi-pod`` choose the mesh and the worker
axes, as in the reference.  Every local step launches the
hand-written ``auc_loss`` kernel once, then one ``prox_update`` launch
over every parameter leaf (``--optimizer sgd``, the default, and
``shampoo_blocked``) or one ``opt_update`` launch (``momentum``, ``sm3``);
the dense transformers
(``--arch stablelm-1.6b | qwen2.5-14b | phi3-medium-14b | chatglm3-6b``,
on the reference's ``tokens`` data at ``seq_len=64``) also launch
``flash_attention`` once per attention layer in every forward, and the MoE
transformers (``--arch dbrx-132b | arctic-480b``) ``grouped_matmul`` three
times per moe layer in every eval forward (the stage-end α batches and the
held-out chunks; local steps dispatch by capacity and launch none).  It
takes the reference's flags: ``--algorithm codasca`` (control-variate
corrected local steps, twice the window payload), ``--server-momentum``,
the fault-injection knobs (``--participation``, ``--straggler-prob``,
``--straggler-windows``, ``--max-staleness``, ``--fault-seed``: the masked
averaging) and the crash-resume checkpoints (``--ckpt-dir`` with
``--ckpt-every``, ``--resume``; ``--ckpt-dir`` alone saves the final
state).  ``--n-layers`` (the port's
own) cuts a transformer config's depth so a full-width model trains on
one card (an encoder-decoder's encoder too), and prints what it cut on a
``reduced:`` line.  The vlm and audio families (``--arch internvl2-2b``,
``--arch seamless-m4t-medium``) get the reference's modality stubs on top
of the token batches (``make_batch_adapters``): ``n_patches`` patch
embeddings in front of the tokens, or ``seq_len`` frames under
``seq_len // decoder_fraction`` target tokens; ``--arch hymba-1.5b`` runs
the hybrid stack, its SSM branch beside every attention layer, and
``--arch xlstm-350m`` the ssm family's mLSTM/sLSTM layers on token-only
batches (no attention: ``flash_attention`` is not launched).

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
      --objective pauc_dro --pauc-beta 0.3          # or --objective bce
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
      --arch stablelm-1.6b --smoke --stages 2 --t0 30 --interval 8
  PYTHONPATH=src python -m repro_torch.launch.train --arch stablelm-1.6b \
      --n-layers 2 --stages 1 --t0 16 --n-data 1024     # full width, 2 layers
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
      --arch dbrx-132b --smoke --stages 2 --t0 30 --interval 8
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
      --arch hymba-1.5b --smoke --stages 2 --t0 30   # or internvl2-2b, seamless-m4t-medium
  PYTHONPATH=src python -m repro_torch.launch.train --arch internvl2-2b \
      --n-layers 2 --stages 1 --t0 16 --n-data 1024     # full width, 2 layers
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
      --arch xlstm-350m --smoke --stages 2 --t0 30 [--optimizer sm3]
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
      --algorithm codasca --dirichlet-alpha 0.1 --participation 0.75
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
      --ckpt-dir build/ckpt --ckpt-every 4 --resume
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
      --executor shard_map --force-host-devices 4 [--overlap] [--compress int8]
  PYTHONPATH=src python -m repro_torch.launch.train --executor shard_map  # every card
"""
from __future__ import annotations

import argparse
import contextlib
import copy
import dataclasses
import os
import statistics
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import disable_tf32, resolve_device
from repro_torch.configs import (DENSE_ARCHS, MOE_ARCHS, ZOO_ARCHS, get_config,
                                  get_smoke_config, mlp_config)
from repro_torch.checkpoint import checkpoint
from repro_torch.core import bucketing, coda, objective, optimizer, schedules
from repro_torch.data import DataConfig, ShardedDataset
from repro_torch.kernels import auc_loss as _auc_mod
from repro_torch.kernels import flash_attention as _fa_mod
from repro_torch.kernels import moe_dispatch as _moe_mod
from repro_torch.kernels import opt_update as _opt_mod
from repro_torch.kernels import prox_update as _prox_mod
from repro_torch.launch import mesh as mesh_mod
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
    raise ValueError(f"no data kind for family {mcfg.family!r}")


def make_batch_adapters(mcfg, seed: int, device):
    """The modality stubs on top of a token batch (``launch/train.py:
    99-117``): vlm batches get ``n_patches`` patch embeddings of width d in
    front of their first ``seq_len - n_patches`` tokens (at least one);
    audio batches get ``seq_len`` frames of width d and keep their first
    ``seq_len // decoder_fraction`` tokens as the decoder's targets.  The
    reference draws the stub with the same key for every batch, so it
    carries no signal from batch to batch; here one stub ([n_patches, d] or
    [seq_len, d], standard normal) is drawn once from a CPU generator
    seeded by ``seed`` and broadcast to every example.  Other families pass
    through."""
    if mcfg.family not in ("vlm", "audio"):
        return lambda b: b
    stubs = {}

    def stub(n: int):
        if n not in stubs:
            gen = torch.Generator().manual_seed(seed)
            stubs[n] = torch.randn((n, mcfg.d_model), generator=gen).to(device)
        return stubs[n]

    def adapt(b):
        b = dict(b)
        lead, S = tuple(b["tokens"].shape[:-1]), b["tokens"].shape[-1]
        if mcfg.family == "vlm":
            b["patches"] = stub(mcfg.n_patches).expand(lead + (mcfg.n_patches, mcfg.d_model))
            b["tokens"] = b["tokens"][..., :max(1, S - mcfg.n_patches)]
        else:
            b["frames"] = stub(S).expand(lead + (S, mcfg.d_model))
            b["tokens"] = b["tokens"][..., :max(1, S // mcfg.decoder_fraction)]
        return b

    return adapt


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="mlp",
                    help=f"mlp | resnet50 | {' | '.join(DENSE_ARCHS + MOE_ARCHS + ZOO_ARCHS)}")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced same-family config")
    ap.add_argument("--n-layers", type=int, default=0,
                    help="cut a transformer config's depth to this many "
                         "layers, an encoder-decoder's encoder too (0 = the "
                         "config's own; widths stay as they are)")
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
    ap.add_argument("--executor", choices=["vmap", "shard_map"], default="vmap",
                    help="vmap = the single-device worker-batched executor; "
                         "shard_map = the workers over torch.distributed ranks, "
                         "one all_reduce per dtype bucket a window")
    ap.add_argument("--algorithm", choices=["coda", "codasca"], default="coda",
                    help="codasca = control-variate corrected local steps "
                         "for heterogeneous (non-IID) shards")
    ap.add_argument("--objective", choices=list(objective.names()),
                    default="auc",
                    help="min-max objective (core/objective.py registry): "
                         "auc = the paper's; pauc_dro = one-way partial AUC "
                         "via KL-DRO; bce = dual-free cross-entropy")
    ap.add_argument("--pauc-beta", type=float, default=0.3,
                    help="FPR budget β for --objective pauc_dro and its "
                         "reported pAUC@β")
    ap.add_argument("--server-momentum", type=float, default=0.0,
                    help="β for server momentum on the averaged iterate "
                         "(0 = off; the buffer is replicated, no extra "
                         "wire bytes)")
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
    ap.add_argument("--participation", type=float, default=1.0,
                    help="per-window probability a worker's contribution "
                         "makes the merge (< 1 turns on fault injection: the "
                         "masked participant-mean averaging)")
    ap.add_argument("--straggler-prob", type=float, default=0.0,
                    help="per-window probability a worker starts straggling")
    ap.add_argument("--straggler-windows", type=int, default=1,
                    help="how many windows a straggler's contribution lags")
    ap.add_argument("--max-staleness", type=int, default=0,
                    help="merge straggler contributions up to this many "
                         "windows late (discounted weight); later ones are "
                         "dropped and the worker re-synced")
    ap.add_argument("--fault-seed", type=int, default=0,
                    help="seed of the replayable fault schedule (core/faults.py)")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=0,
                    help="with --ckpt-dir: save the state and the loop "
                         "counters every N windows (resume with --resume)")
    ap.add_argument("--resume", action="store_true",
                    help="resume from the latest checkpoint in --ckpt-dir "
                         "(bitwise the uninterrupted run)")
    ap.add_argument("--policy", choices=["replica", "fsdp"], default="replica",
                    help="worker placement: replica = workers over the data "
                         "axis; fsdp = workers over the pod axis only")
    ap.add_argument("--overlap", action="store_true",
                    help="shard_map only: feed window pairs whose averagings run "
                         "as chunked point-to-point rings instead of all_reduce "
                         "(same mean, same bytes)")
    ap.add_argument("--overlap-chunks", type=int, default=4,
                    help="ring chains per dtype bucket under --overlap")
    ap.add_argument("--force-host-devices", type=int, default=0,
                    help="with --device cpu: the number of gloo ranks "
                         "--executor shard_map runs (on the card: one rank a card)")
    ap.add_argument("--multi-pod", action="store_true",
                    help="use the 3-axis (pod, data, model) mesh layout")
    metric_report.add_metric_args(ap)
    return ap


def main(argv=None) -> dict:
    """Parse ``argv``, train, print the reference's summary lines, and
    return a summary dict (used by ``chip_smoke.py``), with the kernel
    launches and the collectives made during training under ``launches``
    and ``collectives``.  ``--executor shard_map`` runs on R ranks (this
    process is rank 0, the others are spawned and print nothing), or on
    the group ``torchrun`` set up."""
    argv = sys.argv[1:] if argv is None else list(argv)
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.overlap and args.executor != "shard_map":
        raise SystemExit("--overlap needs --executor shard_map (the vmap "
                         "oracle has no wire to overlap)")
    device = resolve_device(args.device)
    if args.executor == "vmap":
        return _train(args)
    if device.type == "cuda" and args.force_host_devices:
        ap.error("--force-host-devices sets the number of CPU ranks (--device cpu); "
                 "on the card shard_map runs one rank a card")
    backend = "nccl" if device.type == "cuda" else "gloo"
    if "WORLD_SIZE" in os.environ:            # torchrun started this rank
        rank = int(os.environ["RANK"])
        mesh_mod.init_rank(backend, int(os.environ.get("LOCAL_RANK", rank)),
                           int(os.environ["WORLD_SIZE"]))
        try:
            with contextlib.redirect_stdout(open(os.devnull, "w")) if rank \
                    else contextlib.nullcontext():
                return _train(args)
        finally:
            dist.destroy_process_group()
    world = torch.cuda.device_count() if device.type == "cuda" \
        else max(args.force_host_devices, 1)
    return mesh_mod.run_ranks(_rank_main, world, (argv,), backend=backend)


def _rank_main(rank: int, argv: list) -> dict:
    """One spawned rank of ``--executor shard_map``."""
    return _train(build_parser().parse_args(argv))


def _train(args) -> dict:
    device = resolve_device(args.device)
    sharded = args.executor == "shard_map"
    if sharded and device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
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
            build_parser().error(f"--n-layers cuts a language model's depth; "
                                 f"{args.arch} is {mcfg.family}")
        cut = {"n_layers": args.n_layers}
        if mcfg.is_encoder_decoder:
            cut["encoder_layers"] = args.n_layers
        print("reduced: " + ", ".join(f"{k} {getattr(mcfg, k)} -> {v}"
                                      for k, v in cut.items()) + " (widths as published)")
        mcfg = dataclasses.replace(mcfg, **cut)

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
                           algorithm=args.algorithm,
                           objective=args.objective,
                           pauc_beta=args.pauc_beta,
                           server_momentum=args.server_momentum,
                           overlap_chunks=args.overlap_chunks if args.overlap else 0,
                           stream_bins=args.metric_bins
                           if args.metrics == "sketch" else 0,
                           participation=args.participation,
                           straggler_prob=args.straggler_prob,
                           straggler_windows=args.straggler_windows,
                           max_staleness=args.max_staleness,
                           fault_seed=args.fault_seed,
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
    n_leaves = len(tree_leaves(state["params"]))
    n_params = sum(l.numel() for l in tree_leaves(state["params"])) // args.workers
    print(f"model: {mcfg.name} params/worker={n_params:,} leaves={n_leaves} "
          f"device={device}")
    if args.optimizer != "sgd":
        print(f"optimizer: {args.optimizer} ({args.opt_dtype}) "
              f"state={optimizer.abstract_state_bytes(ccfg, state['params']):,} "
              "B/worker (local only — never on the wire)")
    if ccfg.faults_enabled:
        print(f"fault injection: participation={args.participation:g} "
              f"straggler_prob={args.straggler_prob:g} "
              f"(lag {args.straggler_windows}, max_staleness "
              f"{args.max_staleness}) seed={args.fault_seed}")
    mesh = None
    if sharded:
        mesh = mesh_mod.make_worker_mesh(multi_pod=args.multi_pod)
        print(f"mesh: {mesh_mod.axis_sizes(mesh)} policy={args.policy} "
              f"devices={mesh.size()}")
    exe = coda.make_executor(mcfg, ccfg, args.executor, mesh=mesh, policy=args.policy)

    adapt = make_batch_adapters(mcfg, args.seed, device)
    test = adapt(ds.full(2048))
    inputs = [k for k in test if k != "labels"]

    def test_scores(st, chunk: int = TEST_CHUNK):
        params0 = tree_map(lambda x: x[:1], st["params"])
        with torch.no_grad():
            hs = [M.score(mcfg, params0, {k: test[k][i:i + chunk][None] for k in inputs})[0][0]
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
                "train", f"eval {n_evals[0]}", met, exe.gather(st["sk_loc"]), lo, hi))
            return out
        ms = met.update(met.init(), test_scores(st), test["labels"])
        return report(f"eval {n_evals[0]}", ms, int(test["labels"].numel()))

    if device.type == "cuda":
        torch.cuda.synchronize(device)
    # each rank keeps its own workers' rows, and fit takes the only reference:
    # its executor donates the state, writing every step into it
    held = [exe.place(state)]
    del state
    before = {k: m.launches for k, m in KERNELS.items()}
    comm_before = copy.deepcopy(bucketing.collectives)
    t0 = time.perf_counter()
    res = coda.fit(held.pop(), mcfg, ccfg, sched, args.stages,
                   sample_window=lambda i: adapt(ds.sample_window(i, args.batch)),
                   sample_alpha_batch=lambda m: adapt(ds.sample_alpha_batch(m)),
                   eval_every=args.metric_interval,
                   eval_fn=eval_fn if args.metric_interval else None,
                   executor=exe,
                   ckpt_dir=args.ckpt_dir if args.ckpt_every else "",
                   ckpt_every=args.ckpt_every, resume=args.resume, rng=ds.draw_rng)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    launches = {k: m.launches - before[k] for k, m in KERNELS.items()}
    comms = {k: {f: v[f] - comm_before[k][f] for f in v}
             for k, v in bucketing.collectives.items()}
    h_test = test_scores(res.state)
    auc = objective.roc_auc(h_test, test["labels"])
    extra, metric = "", None
    if obj.metric_name != "auc":
        metric = obj.metric("exact").compute(h_test, test["labels"])
        extra = f", test {obj.metric_name}@{args.pauc_beta:g}={metric:.4f}"
    print(f"done: {res.iterations} iters, {res.comm_rounds} comm rounds, "
          f"{dt:.1f}s, test AUC={auc:.4f}{extra}")
    if args.metrics == "sketch":
        sk = streaming.sketch_from_rows(res.state["sk_acc"], lo, hi)
        report("final train-stream", sk, int(sk.count))
        print(metric_report.worker_skew_line("train", "final", met,
                                             exe.gather(res.state["sk_loc"]), lo, hi))
    compress = args.compress or None
    stage_list = schedules.stages(sched, args.stages)
    total = coda.comm_bytes(stage_list, res.state, compress,
                            stage_bytes=coda.stage_payload_bytes(ccfg))
    per_round = coda.window_payload_bytes(res.state, compress)
    print(f"bytes/round/worker={per_round:,} (schedule total {total:,})")
    if args.overlap:
        print(overlap_line(res, exe, args.overlap_chunks))
    if args.ckpt_dir and not args.ckpt_every:
        # the final state only; --ckpt-every owns the directory for the
        # window checkpoints --resume restarts from
        whole = exe.gather(res.state)
        if exe.rank == 0:
            path = checkpoint.save(args.ckpt_dir, res.iterations, whole,
                                   {"auc": auc, "arch": mcfg.name})
            print("checkpoint:", path)
        del whole
    # the first window carries one-off set-up (allocator growth, cuDNN
    # algorithm choice); the steady per-step time excludes it (none when a
    # resumed run had no window left to run)
    steady = res.step_seconds[1:] or res.step_seconds
    ms_per_step = 1e3 * statistics.median(steady) if steady else float("nan")
    return {"auc": auc, "metric": metric, "iterations": res.iterations,
            "history": res.history,
            "ms_per_local_step": ms_per_step, "leaves": n_leaves,
            "bytes_per_round": per_round, "comm_rounds": res.comm_rounds,
            "step_seconds": res.step_seconds,
            "state": res.state, "test_scores": h_test, "launches": launches,
            "collectives": comms,
            "mesh": None if mesh is None else mesh_mod.axis_sizes(mesh),
            "n_test": int(test["labels"].shape[0]), "stages": len(stage_list),
            "opt_state_bytes": coda.opt_state_bytes(res.state)}


def overlap_line(res, exe, chunks: int) -> str:
    """What the overlapped pairs ran: the first window's averaging under the
    second window's local steps, and which averaged leaves waited on what."""
    sm = getattr(exe, "overlap_summary", {})
    if not sm:
        return (f"overlap: no window pair ran, {res.exposed_bytes:,} bytes exposed "
                f"(chunks={chunks})")
    units = (f"{sm['chains']} independent ring chains" if sm["chains"]
             else f"{sm['units']} per-row reductions (one rank: no hops)")
    extra = (f", {sm['also_other_units']} of them also on the weight-lane unit their finish "
             "needs" if sm["also_other_units"] else "")
    return (f"overlap: {res.overlapped_bytes:,} bytes in the first window of each pair, "
            f"averaged as {units} under the second window's local steps; its "
            f"{sm['leaves']} averaged leaves each wait whole, where first read, on the units "
            f"that cover their rows{extra}; {res.exposed_bytes:,} exposed (chunks={chunks})")


if __name__ == "__main__":
    main()
