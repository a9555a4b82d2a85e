"""Serving launcher (counterpart of ``repro.launch.serve``): drives the
continuous-batching engine on a smoke config with a synthetic request trace
and prints the reference's lines — the first requests' tokens, the
throughput line, the latency line and, with ``--labeled``, the streaming
AUC over served traffic.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch dbrx-132b --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch dbrx-132b \\
      --trace batch --requests 24 --labeled --metrics sketch --metric-interval 8

Like the reference it serves smoke configs only (the dense, moe, vlm,
hybrid and ssm families: ``--arch internvl2-2b``, ``--arch hymba-1.5b``,
``--arch xlstm-350m``; the engine refuses the encoder-decoder, as the
reference's does).  The parameters are drawn from a CPU generator seeded by
``--seed`` and moved to the device, so the card and the CPU serve the same
weights.  The device is ``cuda`` unless ``--device cpu`` is given; asking
for ``cuda`` without a card raises.  On the card every moe layer of every
step launches K5 three times.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch import disable_tf32, resolve_device
from repro_torch.configs import get_smoke_config
from repro_torch.metrics import report as metric_report
from repro_torch.metrics import streaming
from repro_torch.models import model as M
from repro_torch.serving import ServingEngine
from repro_torch.serving import loadgen as LG
from repro_torch.tree import tree_map


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="stablelm-1.6b")
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda unless you ask for cpu)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--max-len", type=int, default=96)
    ap.add_argument("--prefill-chunk", type=int, default=8)
    ap.add_argument("--queue-limit", type=int, default=None)
    ap.add_argument("--admission", default="fifo", choices=["fifo", "sjf"])
    ap.add_argument("--prefix-cache", type=int, default=0,
                    help="LRU entries for the prompt-prefix cache (0 = off)")
    ap.add_argument("--trace", default="batch",
                    choices=["batch", "poisson", "bursty"])
    ap.add_argument("--rate", type=float, default=16.0,
                    help="mean arrivals/s for poisson/bursty traces")
    ap.add_argument("--deadline", type=float, default=None,
                    help="per-request deadline in seconds after arrival")
    ap.add_argument("--labeled", action="store_true",
                    help="plant ground-truth labels on the trace and report "
                         "streaming AUC over served traffic")
    ap.add_argument("--p-pos", type=float, default=0.7,
                    help="positive ratio for --labeled traces")
    ap.add_argument("--seed", type=int, default=0)
    metric_report.add_metric_args(ap)
    return ap


def main(argv=None) -> dict:
    """Serve one trace, print the reference's lines, and return the
    summary (``LG.summarize``'s record plus ``requests``, ``engine`` and
    the ``streaming`` record) for ``chip_smoke.py``."""
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    if device.type == "cuda":
        disable_tf32()
    mcfg = get_smoke_config(args.arch)
    params = M.init_params(mcfg, generator=torch.Generator().manual_seed(args.seed),
                           device=device)
    params = tree_map(lambda x: x[None], params)                    # one replica
    met = rep = None
    if args.labeled:
        met = streaming.make_metric("auc", args.metrics, bins=args.metric_bins)
        rep = metric_report.IntervalReporter(met, interval=args.metric_interval,
                                             label="serve")
    eng = ServingEngine(mcfg, params, slots=args.slots, max_len=args.max_len,
                        prefill_chunk=args.prefill_chunk,
                        queue_limit=args.queue_limit, admission=args.admission,
                        prefix_cache_size=args.prefix_cache, metric=met)
    tcfg = LG.TraceConfig(kind=args.trace, rate=args.rate, n_requests=args.requests,
                          max_new=(args.max_new, args.max_new + 1),
                          deadline=args.deadline, seed=args.seed,
                          labeled=args.labeled, p_pos=args.p_pos)
    on_step = None
    if rep is not None and rep.interval > 0:
        on_step = lambda e: rep.tick(e.n_scored, lambda: e.metric_state)
    reqs, wall = LG.run_trace(eng, LG.make_trace(tcfg, mcfg.vocab_size),
                              on_step=on_step)
    for r in reqs[:4]:
        print(f"req {r.uid}: prompt[{len(r.prompt)}] {r.status} -> {r.generated}")
    m = LG.summarize(reqs, wall, eng)
    print(f"served {m['completed']}/{m['n_requests']} requests "
          f"({m['rejected']} rejected, {m['expired']} expired), "
          f"{m['generated_tokens']} tokens in {m['wall_s']:.2f}s "
          f"({m['tokens_per_s']:.1f} tok/s, slots={args.slots}, "
          f"chunk={args.prefill_chunk})")
    print(f"ttft p50/p99: {m['ttft_p50_ms']:.1f}/{m['ttft_p99_ms']:.1f} ms; "
          f"latency p50/p99: {m['latency_p50_ms']:.1f}/"
          f"{m['latency_p99_ms']:.1f} ms; ticks={m['ticks']}")
    if rep is not None:
        rep.report(f"final ({eng.n_scored} scored)", eng.metric_state,
                   n_seen=eng.n_scored)
    if not all(r.done for r in reqs):
        raise SystemExit("serve: a request was not finalized")
    return dict(m, requests=reqs, engine=eng, streaming=eng.streaming_metrics())


if __name__ == "__main__":
    main()
