"""Quickest proof that the PyTorch port runs on an NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints its own lines; any failure exits non-zero before the
last line):
  1. device check — no CUDA means exit 1; prints nvidia-smi's name and
     power limit;
  2. builds the CUDA kernels from ``src/repro_torch/kernels/csrc`` (nvcc)
     and prints the build time and ptxas's register report;
  3. holds each kernel against its plain PyTorch version on the card at the
     main path's shapes (and a few ragged ones), and times kernel and plain
     version with CUDA events after warm-up;
  4. one main-path local step with the kernels and with the plain versions
     from the same state: the parameters must agree;
  5. the main path, mlp at the launcher's defaults (coda, auc, sgd, K=4,
     I=8, B=32, 3 stages): finite losses, test AUC > 0.9, and the launch
     counters equal local steps (auc_loss) and local steps × 6 (prox_update);
  6. the main path, ResNet50 at full width (K=4, B=32, 32×32 images, one
     stage of two windows): ms per local step, peak memory, finite losses,
     and counters equal local steps and local steps × 153;
  7. one more window of each path under torch.profiler: device busy time,
     idle share, the hand-written kernels' device time, the top kernels;
then the ``{"kernels": [...]}`` line, nvidia-smi's line, and the
``{"ok": true, ...}`` line.  It imports nothing of JAX.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))

# Device memory rate (bytes/s) and fp32 peak outside the tensor cores
# (operations/s) by card, from NVIDIA's data sheets (SXM part at 700 W).
CARDS = {"H100 PCIe": (2.0e12, 51e12), "H100 NVL": (3.9e12, 60e12),
         "H100": (3.35e12, 67e12), "H200": (4.8e12, 67e12)}
AUC_OPS_PER_SCORE = 40      # fp32 operations per score in the auc_loss kernel
PROX_OPS_PER_ELEMENT = 6    # 3 mul, 1 sub, 1 add, 1 div


def nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def card_rates(name: str) -> tuple[float, float]:
    for key, rates in CARDS.items():   # most specific names first
        if key in name:
            return rates
    raise SystemExit(f"no memory/compute rates on record for {name!r}")


def cuda_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Mean device time of ``fn`` in ms, CUDA events around ``iters`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_profile(fn):
    """Run ``fn`` once under torch.profiler.  Returns (host wall ms, device
    busy ms, {kernel name: device ms summed over its launches}).  Busy time
    is the union of the kernels' intervals: cuDNN may run kernels of one
    grouped convolution concurrently, so the per-kernel sum can exceed it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    per: dict[str, float] = {}
    spans = []
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False):
            per[e.name] = per.get(e.name, 0.0) + e.device_time_total / 1e3
            spans.append((e.time_range.start, e.time_range.end))
    busy, reach = 0.0, float("-inf")
    for start, end in sorted(spans):
        if end > reach:
            busy += end - max(start, reach)
            reach = end
    return wall, busy / 1e3, per


def kernel_device_ms(fn, tag: str, calls: int = 20) -> float:
    """Device time per call of the kernels whose names contain ``tag``,
    from the profiler (no host time in it); 0.0 if the profiler saw none."""
    _, _, per = device_profile(lambda: [fn() for _ in range(calls)])
    return sum(v for k, v in per.items() if tag in k) / calls


def bound_ms(n_bytes: float, n_ops: float, rates) -> tuple[float, str]:
    t_bytes, t_ops = n_bytes / rates[0] * 1e3, n_ops / rates[1] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_auc_loss(dev, rates, gen):
    from repro_torch.kernels import ref
    from repro_torch.kernels.auc_loss import auc_loss
    atol, rtol = 1e-5, 1e-4
    rows = []
    for K, T in ((1, 7), (4, 100), (4, 513), (4, 32), (8, 4096)):
        h = torch.rand((K, T), generator=gen).to(dev)
        y = (torch.rand((K, T), generator=gen) < 0.71).float().to(dev)
        a, b, al = (torch.randn((K,), generator=gen).mul(0.3).to(dev)
                    for _ in range(3))
        got = auc_loss(h, y, a, b, al, 0.71)
        want = ref.auc_loss_ref(h, y, a, b, al, 0.71)
        torch.cuda.synchronize()
        err = max(float((g - w).abs().max()) for g, w in zip(got, want))
        ok = all(bool(((g - w).abs() <= atol + rtol * w.abs()).all())
                 for g, w in zip(got, want))
        again = auc_loss(h, y, a, b, al, 0.71)
        stable = all(bool(torch.equal(g, x)) for g, x in zip(got, again))
        if not (ok and stable):
            raise SystemExit(f"auc_loss [{K},{T}] disagrees with its plain "
                             f"version: max_abs_err={err} stable={stable}")
        ms = cuda_ms(lambda: auc_loss(h, y, a, b, al, 0.71))
        plain = cuda_ms(lambda: ref.auc_loss_ref(h, y, a, b, al, 0.71))
        dev_ms = kernel_device_ms(lambda: auc_loss(h, y, a, b, al, 0.71), "auc_loss")
        bnd, by = bound_ms(12 * K * T + 28 * K, AUC_OPS_PER_SCORE * K * T, rates)
        rows.append({"shape": [K, T], "max_abs_err": err, "ms": ms,
                     "device_ms": dev_ms, "plain_ms": plain, "bound_ms": bnd,
                     "bound_by": by})
        print(f"auc_loss [{K},{T}]: max_abs_err={err:.3g} (atol {atol}, rtol "
              f"{rtol}) kernel {ms * 1e3:.2f} us (device {dev_ms * 1e3:.2f} us), "
              f"plain {plain * 1e3:.2f} us, bound {bnd * 1e3:.3f} us ({by})")
    return rows


def check_prox_update(dev, rates, gen):
    from repro_torch.configs import get_config
    from repro_torch.kernels import ref
    from repro_torch.kernels.prox_update import prox_update
    from repro_torch.models import model as M
    from repro_torch.tree import tree_leaves
    K = 4
    leaf_sizes = [l.numel() for l in tree_leaves(M.init_params(get_config("resnet50")))]
    cases = [(n, dt) for n in (5, 1000, 4097, K * max(leaf_sizes))
             for dt in (torch.float32, torch.bfloat16)]
    rows = []
    for n, dt in cases:
        v, g, v0 = (torch.randn((n,), generator=gen).to(dev, dt) for _ in range(3))
        got = prox_update(v, g, v0, 0.05, 0.5)
        want = ref.prox_update_ref(v, g, v0, 0.05, 0.5)
        torch.cuda.synchronize()
        tol = 2e-2 if dt == torch.bfloat16 else 1e-6
        err = float((got.float() - want.float()).abs().max())
        if got.dtype != dt or not err <= tol:
            raise SystemExit(f"prox_update n={n} {dt} disagrees with its plain "
                             f"version: max_abs_err={err} (tol {tol})")
        ms = cuda_ms(lambda: prox_update(v, g, v0, 0.05, 0.5))
        plain = cuda_ms(lambda: ref.prox_update_ref(v, g, v0, 0.05, 0.5))
        dev_ms = kernel_device_ms(lambda: prox_update(v, g, v0, 0.05, 0.5),
                                  "prox_update")
        bnd, by = bound_ms(4 * n * v.element_size(), PROX_OPS_PER_ELEMENT * n, rates)
        dname = str(dt).replace("torch.", "")
        rows.append({"shape": [n], "dtype": dname, "max_abs_err": err,
                     "tol": tol, "ms": ms, "device_ms": dev_ms, "plain_ms": plain,
                     "bound_ms": bnd, "bound_by": by})
        print(f"prox_update n={n} {dname}: max_abs_err={err:.3g} (tol {tol}) "
              f"kernel {ms * 1e3:.2f} us (device {dev_ms * 1e3:.2f} us), plain "
              f"{plain * 1e3:.2f} us, bound {bnd * 1e3:.3f} us ({by})")
    # one ResNet50 local step's sweep: every leaf × K, one launch per leaf
    leaves = [tuple(torch.randn((K * s,), generator=gen).to(dev) for _ in range(3))
              for s in leaf_sizes]
    sweep = lambda fn: [fn(v, g, v0, 0.05, 0.5) for v, g, v0 in leaves]
    ms = cuda_ms(lambda: sweep(prox_update), iters=10)
    plain = cuda_ms(lambda: sweep(ref.prox_update_ref), iters=10)
    dev_ms = kernel_device_ms(lambda: sweep(prox_update), "prox_update", calls=5)
    n = K * sum(leaf_sizes)
    bnd, by = bound_ms(16 * n, PROX_OPS_PER_ELEMENT * n, rates)
    rows.append({"shape": [n], "dtype": "float32",
                 "what": f"resnet50 local step: {len(leaf_sizes)} leaves x K={K}",
                 "launches": len(leaf_sizes), "ms": ms, "device_ms": dev_ms,
                 "plain_ms": plain, "bound_ms": bnd, "bound_by": by})
    print(f"prox_update resnet50 step ({len(leaf_sizes)} launches, {n:,} "
          f"elements): kernel {ms:.3f} ms (device {dev_ms:.3f} ms), plain "
          f"{plain:.3f} ms, bound {bnd:.3f} ms ({by})")
    del leaves
    return rows


def check_step(dev):
    """One mlp local step with the kernels and with the plain versions."""
    from repro_torch.configs import mlp_config
    from repro_torch.core import coda
    from repro_torch.tree import tree_leaves
    mcfg = mlp_config()
    g = torch.Generator().manual_seed(1)
    y = (torch.rand((4, 32), generator=g) < 0.71).float()
    batch = {"features": (torch.randn((4, 32, 64), generator=g)
                          + 0.3 * (2 * y[..., None] - 1)).to(dev),
             "labels": y.to(dev)}
    out = {}
    for impl in ("kernel", "ref"):
        ccfg = coda.CoDAConfig(n_workers=4, p_pos=0.71, impl=impl)
        st = coda.init_state(mcfg, ccfg, generator=torch.Generator().manual_seed(0),
                             device=dev)
        out[impl] = coda.local_step(mcfg, ccfg, st, batch, 0.5)
    err = max(float((a - b).abs().max()) for a, b in
              zip(tree_leaves(out["kernel"][0]), tree_leaves(out["ref"][0])))
    lerr = float((out["kernel"][1] - out["ref"][1]).abs().max())
    print(f"main-path step (mlp), kernels vs plain versions: params max_abs_err="
          f"{err:.3g}, losses max_abs_err={lerr:.3g} (atol 1e-5)")
    if not (err <= 1e-5 and lerr <= 1e-5):
        raise SystemExit("the main-path step with kernels disagrees with the "
                         "plain versions")


def run_main_path(label: str, argv: list[str], leaves_per_step: int):
    from repro_torch.kernels import auc_loss as auc_mod
    from repro_torch.kernels import prox_update as prox_mod
    from repro_torch.launch import train
    torch.cuda.reset_peak_memory_stats()
    auc_mod.launches = prox_mod.launches = 0
    out = train.main(argv)
    counts = {"auc_loss": auc_mod.launches, "prox_update": prox_mod.launches}
    steps = out["iterations"]
    losses = [h[2] for h in out["history"]]
    peak = torch.cuda.max_memory_allocated()
    print(f"{label}: {steps} local steps, {out['ms_per_local_step']:.3f} ms per "
          f"local step (steady median), peak memory {peak / 2**30:.3f} GiB, "
          f"launches {counts}, first/last window loss {losses[0]:.5f}/"
          f"{losses[-1]:.5f}, test AUC {out['auc']:.4f}")
    if not all(math.isfinite(x) for x in losses):
        raise SystemExit(f"{label}: non-finite loss in {losses}")
    if out["leaves"] != leaves_per_step:
        raise SystemExit(f"{label}: {out['leaves']} leaves, expected {leaves_per_step}")
    want = {"auc_loss": steps, "prox_update": steps * leaves_per_step}
    if counts != want:
        raise SystemExit(f"{label}: launch counts {counts}, expected {want}")
    scores = out["test_scores"]
    if not (scores.dim() == 1 and bool(torch.isfinite(scores).all())):
        raise SystemExit(f"{label}: test scores not a finite vector")
    return out, counts


def profile_window(label: str, arch: str, state, dev) -> dict:
    """Where one window (I=8 local steps + the average) of a main path spends
    its time: host wall time, device busy time, the hand-written kernels'
    share, and the kernels that take the most device time."""
    from repro_torch.configs import get_config, mlp_config
    from repro_torch.core import coda
    mcfg = mlp_config() if arch == "mlp" else get_config(arch)
    ccfg = coda.CoDAConfig(n_workers=4, p_pos=0.71)
    g = torch.Generator().manual_seed(2)
    y = (torch.rand((8, 4, 32), generator=g) < 0.71).float()
    if mcfg.family == "mlp":
        wb = {"features": torch.randn((8, 4, 32, 64), generator=g)}
    else:
        wb = {"images": torch.randn((8, 4, 32, 32 * 32, 3), generator=g)}
    wb = {k: v.to(dev) for k, v in wb.items()} | {"labels": y.to(dev)}
    coda.window_step(mcfg, ccfg, state, wb, 0.5)          # warm-up
    wall, busy, per = device_profile(lambda: coda.window_step(mcfg, ccfg, state, wb, 0.5))
    ours = {tag: sum(v for k, v in per.items() if tag in k)
            for tag in ("auc_loss", "prox_update")}
    top = sorted(per.items(), key=lambda kv: -kv[1])[:6]
    out = {"path": label, "local_steps": 8, "wall_ms": wall, "device_busy_ms": busy,
           "kernel_sum_ms": sum(per.values()), "idle_share": 1.0 - busy / wall,
           "hand_written_ms": ours,
           "top_kernels_ms": {k[:90]: v for k, v in top}}
    print(f"profile {label} window: wall {wall:.3f} ms, device busy {busy:.3f} ms "
          f"(idle share {1.0 - busy / wall:.3f}; kernel time summed "
          f"{sum(per.values()):.3f} ms), auc_loss {ours['auc_loss']:.4f} ms, "
          f"prox_update {ours['prox_update']:.4f} ms")
    print(json.dumps({"profile": out}))
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch import disable_tf32
    from repro_torch.kernels import _build

    smi = nvidia_smi()
    print(f"device: {smi} | torch {torch.__version__} cuda {torch.version.cuda} "
          f"| count {torch.cuda.device_count()}")
    rates = card_rates(torch.cuda.get_device_name(0))
    dev = torch.device("cuda:0")
    disable_tf32()

    t0 = time.perf_counter()
    lib_path = _build.build(verbose=True)
    print(f"build: {os.path.relpath(lib_path, ROOT)} in "
          f"{time.perf_counter() - t0:.2f} s")

    gen = torch.Generator().manual_seed(0)
    auc_rows = check_auc_loss(dev, rates, gen)
    prox_rows = check_prox_update(dev, rates, gen)
    check_step(dev)

    mlp, mlp_counts = run_main_path("main path mlp", [], 6)
    if not mlp["auc"] > 0.9:
        raise SystemExit(f"main path mlp: test AUC {mlp['auc']:.4f} <= 0.9")
    rn, rn_counts = run_main_path(
        "main path resnet50", ["--arch", "resnet50", "--stages", "1", "--t0",
                               "16", "--n-data", "1024"], 153)
    profile_window("mlp", "mlp", mlp["state"], dev)
    profile_window("resnet50", "resnet50", rn["state"], dev)

    def row(name, replaces, rows, head, by_path):
        h = rows[head]
        err = max(r.get("max_abs_err", 0.0) for r in rows)
        tol = "atol 1e-5 + rtol 1e-4" if name == "auc_loss" else "1e-6 f32, 2e-2 bf16"
        return {"name": name, "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/coda_kernels.cu",
                "wrapper": f"src/repro_torch/kernels/{name}.py",
                "replaces": replaces, "launches": sum(by_path.values()),
                "launches_by_path": by_path, "max_abs_err": err, "tol": tol,
                "shape": h["shape"], "ms": h["ms"], "device_ms": h["device_ms"],
                "plain_ms": h["plain_ms"],
                "bound_ms": h["bound_ms"], "bound_by": h["bound_by"],
                "library_ms": None, "max_err": err, "kernel_us": h["ms"] * 1e3,
                "plain_us": h["plain_ms"] * 1e3, "bound_us": h["bound_ms"] * 1e3,
                "shapes": rows}

    # headline shapes: auc_loss at the launcher's [K, B] = [4, 32]; prox_update
    # at ResNet50's largest leaf × K in fp32
    auc_head = next(i for i, r in enumerate(auc_rows) if r["shape"] == [4, 32])
    big = max(r["shape"][0] for r in prox_rows if "what" not in r)
    prox_head = next(i for i, r in enumerate(prox_rows)
                     if r["shape"] == [big] and r["dtype"] == "float32")
    kernels = [
        row("auc_loss", "src/repro/kernels/auc_loss.py:61", auc_rows, auc_head,
            {"mlp": mlp_counts["auc_loss"], "resnet50": rn_counts["auc_loss"]}),
        row("prox_update", "src/repro/kernels/prox_update.py:39", prox_rows,
            prox_head, {"mlp": mlp_counts["prox_update"],
                        "resnet50": rn_counts["prox_update"]}),
    ]
    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
