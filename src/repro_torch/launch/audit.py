"""Program audit CLI, the twin of the reference's ``scripts/audit.py``: the
rule engine (``analysis/audit.py``: R1 collective placement, R2 buffer
reuse, R3 host-sync and dtype lint, R4 the build/load and chunk-shape
budget, R5 static kernel checks) over every distinct program the port
runs:

  * training: executors × {coda, codasca} × {fp32, int8} × {blocking,
    overlap}, minus what the config layer rejects (int8 × overlap; the
    batched executor has no wire to overlap), the masked (partial
    participation) legs, a replicated partition (K = 1 on R > 1 ranks),
    and the optimizer legs (sgd, sm3, shampoo_blocked on each executor);
  * serving: the engine's tick under a mixed prefill/decode workload;
  * kernels: each kernel once through the seam under ``impl="auto"`` and
    ``"ref"``, and the launch geometry at the paths' shapes.

The sharded legs run on R ranks of ``launch/mesh.run_ranks``: NCCL, one
rank a card, on the card; ``--force-host-devices N`` gloo ranks on the CPU
(else one).  Every leg writes one record to the JSON artifact; the exit
status is 0 if and only if every rule passed on every leg.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.audit --device cpu --smoke \\
      --force-host-devices 4 --json audit.json
  PYTHONPATH=src python -m repro_torch.launch.audit --only shard_map/codasca
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
import traceback

import torch


@dataclasses.dataclass(frozen=True)
class Leg:
    name: str
    kind: str                  # "training" | "serving" | "kernels"
    executor: str = "vmap"
    algorithm: str = "coda"
    compress: str = ""
    schedule: str = "blocking"
    masked: bool = False
    optimizer: str = ""
    workers: int = 0           # K; 0: one worker a rank
    impl: str = "auto"


def build_legs(n_devices: int) -> list[Leg]:
    """The audit matrix, as the reference's ``build_legs``."""
    legs = []
    for algorithm in ("coda", "codasca"):
        for compress in ("", "int8"):
            tag = compress or "fp32"
            legs.append(Leg(f"vmap/{algorithm}/{tag}/blocking", "training", "vmap",
                            algorithm, compress))
            legs.append(Leg(f"shard_map/{algorithm}/{tag}/blocking", "training", "shard_map",
                            algorithm, compress))
            if not compress:
                legs.append(Leg(f"shard_map/{algorithm}/{tag}/overlap", "training",
                                "shard_map", algorithm, compress, "overlap"))
    for algorithm in ("coda", "codasca"):
        for schedule in ("blocking", "overlap"):
            legs.append(Leg(f"shard_map/{algorithm}/fp32/{schedule}/masked", "training",
                            "shard_map", algorithm, "", schedule, masked=True))
    legs.append(Leg("shard_map/coda/int8/blocking/masked", "training", "shard_map", "coda",
                    "int8", masked=True))
    if n_devices > 1:          # K = 1 does not divide R ranks: replicated, no wire
        legs.append(Leg("shard_map/coda/fp32/blocking/replicated", "training", "shard_map",
                        workers=1))
    for opt in ("sgd", "sm3", "shampoo_blocked"):
        for executor in ("vmap", "shard_map"):
            legs.append(Leg(f"opt/{opt}/{executor}", "training", executor, optimizer=opt))
    legs.append(Leg("serving/chunk_step", "serving"))
    for impl in ("auto", "ref"):
        legs.append(Leg(f"kernels/{impl}", "kernels", impl=impl))
    return legs


def _model(smoke: bool):
    from repro_torch.configs.base import mlp_config
    if smoke:
        return mlp_config(n_features=16, d=32), 2
    return mlp_config(n_features=64, d=128), 3


# chunks a dtype bucket on the overlap legs: at 2, the smoke mlp's masked
# legs put the weight lanes in the chunk after the first layer's, so the
# second window's first matmul waits on every chunk and none can overlap
OVERLAP_CHUNKS = 4


def _ccfg(leg: Leg, K: int):
    from repro_torch.core.coda import CoDAConfig
    if leg.optimizer:
        return CoDAConfig(n_workers=K, optimizer=leg.optimizer, opt_dtype=torch.bfloat16,
                          shampoo_block=16, precond_every=2)
    kw = dict(participation=0.5, straggler_prob=0.25, max_staleness=1) if leg.masked else {}
    return CoDAConfig(n_workers=K, algorithm=leg.algorithm, avg_compress=leg.compress,
                      overlap_chunks=OVERLAP_CHUNKS if leg.schedule == "overlap" else 0, **kw)


def run_leg(leg: Leg, *, n_devices: int, smoke: bool, device, mesh=None,
            local_steps_hook=None):
    """One leg's report (``analysis.audit.AuditReport``)."""
    from repro_torch.analysis import audit as A
    query = torch.device(device).type == "cuda"
    if leg.kind == "kernels":
        progs, static = A.capture_kernel_launches(impl=leg.impl, device=device,
                                                  tag=leg.name, query=query)
        return A.run_rules(progs, static)
    if leg.kind == "serving":
        progs = A.capture_serving_programs(slots=2, max_len=32, prefill_chunk=4, device=device,
                                           tag=leg.name, query=query)
        return A.run_rules(progs)
    mcfg, I = _model(smoke)
    ccfg = _ccfg(leg, leg.workers or n_devices)
    kw = dict(I=I, B=8, tag=leg.name, device=device, query=query)
    if leg.executor == "shard_map":
        kw.update(mesh=mesh, policy="replica", local_steps_hook=local_steps_hook)
    progs = A.capture_training_programs(mcfg, ccfg, executor=leg.executor, **kw)
    return A.run_rules(progs)


def _record(leg: Leg, fn) -> dict:
    t0 = time.perf_counter()
    try:
        rec = fn().to_dict()
    except Exception as e:     # a crashed capture is a failed leg, recorded
        rec = {"ok": False, "n_checked": 0, "n_findings": 1,
               "rules": {"capture": {"checked": [], "findings": [
                   {"program": leg.name, "message": f"{type(e).__name__}: {e}"}],
                   "waived": []}},
               "details": {"trace": traceback.format_exc()[-2000:]}}
    rec["leg"] = leg.name
    rec["seconds"] = round(time.perf_counter() - t0, 3)
    return rec


def sharded_legs_on_rank(rank: int, names: list, n_devices: int, smoke: bool, device_type: str,
                         local_steps_hook=None) -> list:
    """Every rank runs the named sharded legs in order (their collectives
    meet); rank 0's records are the result."""
    from repro_torch.launch import mesh as M
    device = torch.device(f"cuda:{rank}") if device_type == "cuda" else torch.device("cpu")
    mesh = M.make_worker_mesh(n_devices)
    legs = {leg.name: leg for leg in build_legs(n_devices)}
    return [_record(legs[n], lambda leg=legs[n]: run_leg(
        leg, n_devices=n_devices, smoke=smoke, device=device, mesh=mesh,
        local_steps_hook=local_steps_hook)) for n in names]


def run_matrix(device, *, n_devices: int = 1, smoke: bool = True, only: str | None = None,
               verbose: bool = True) -> dict:
    """Run the matrix (``only``: the legs whose name holds it) and return
    the artifact ``{"ok", "n_devices", "device", "smoke", "legs"}``."""
    from repro_torch.launch import mesh as M
    device = torch.device(device)
    legs = [leg for leg in build_legs(n_devices) if only is None or only in leg.name]
    sharded = [leg.name for leg in legs if leg.executor == "shard_map"]
    records = {}
    if sharded:
        backend = "nccl" if device.type == "cuda" else "gloo"
        for rec in M.run_ranks(sharded_legs_on_rank, n_devices,
                               (sharded, n_devices, smoke, device.type), backend=backend):
            records[rec["leg"]] = rec
    for leg in legs:
        if leg.executor != "shard_map":
            records[leg.name] = _record(leg, lambda leg=leg: run_leg(
                leg, n_devices=n_devices, smoke=smoke, device=device))
    out = [records[leg.name] for leg in legs]
    if verbose:
        for rec in out:
            print_record(rec)
    return {"ok": all(r["ok"] for r in out), "n_devices": n_devices, "device": str(device),
            "smoke": bool(smoke), "legs": out}


def print_record(rec: dict) -> None:
    status = "ok" if rec["ok"] else "FAIL"
    print(f"[{status}] {rec['leg']} ({rec['n_checked']} checks, {rec['n_findings']} findings, "
          f"{rec['seconds']}s)", flush=True)
    for rule, r in rec["rules"].items():
        for f in r["findings"]:
            print(f"    [{rule}] {f['program']}: {f['message']}")
        for w in r.get("waived", []):
            print(f"    [{rule}] waived {w['program']} at {w['site']}: {w['name']}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true",
                    help="the small mlp and short windows (the CI matrix)")
    ap.add_argument("--json", metavar="PATH", help="write the audit artifact here")
    ap.add_argument("--only", metavar="SUBSTR", help="run only legs whose name holds SUBSTR")
    ap.add_argument("--list", action="store_true", help="print the leg names and exit")
    ap.add_argument("--force-host-devices", type=int, default=0, metavar="N",
                    help="N gloo ranks on the CPU for the sharded legs")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from repro_torch import disable_tf32, resolve_device
    device = resolve_device(args.device)
    if args.force_host_devices and device.type != "cpu":
        raise SystemExit("--force-host-devices runs gloo ranks on the CPU: pass --device cpu")
    n_devices = args.force_host_devices or (torch.cuda.device_count()
                                            if device.type == "cuda" else 1)
    legs = [leg for leg in build_legs(n_devices) if args.only is None or args.only in leg.name]
    if not legs:
        print(f"no legs match --only {args.only!r}", file=sys.stderr)
        return 2
    if args.list:
        for leg in legs:
            print(leg.name)
        return 0
    disable_tf32()
    artifact = run_matrix(device, n_devices=n_devices, smoke=args.smoke, only=args.only)
    if args.json:
        with open(args.json, "w") as fh:
            json.dump(artifact, fh, indent=2)
        print(f"wrote {args.json}")
    print("audit:", "ok" if artifact["ok"] else "FAILED")
    return 0 if artifact["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
