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
     version with CUDA events after warm-up: auc_loss within atol 1e-5 +
     rtol 1e-4, prox_update and opt_update bitwise (opt_update's bf16
     stochastic-rounding bits included, and equal to prox_update at
     coef = 0), each with a ResNet50 local step's sweep of 153 launches;
  4. one mlp local step per optimizer (sgd, momentum with a bf16 buffer,
     sm3, shampoo_blocked) with the kernels and with the plain versions from
     the same state: the parameters must agree;
  5. the paths through ``train.main``, each with every launch counter set
     to 0 just before and read just after: mlp at the launcher's defaults
     (coda, auc, K=4, I=8, B=32, 3 stages) with sgd, momentum (bf16
     buffer), sm3, shampoo_blocked and the streaming sketch (``--metrics
     sketch --metric-interval 4``); ResNet50 at full width (K=4, B=32,
     32×32 images, one stage of 16 local steps) with sgd, momentum (bf16
     buffer) and sm3.  Counters: auc_loss = local steps; prox_update or
     opt_update = local steps × leaves (6 mlp, 153 ResNet50), the other 0;
     the sketch counts local steps × K × B scores.  Finite losses; ms per
     local step, peak memory and optimizer state bytes;
  6. one more window under torch.profiler of mlp, ResNet50 and ResNet50 +
     momentum: device busy time, idle share, the hand-written kernels'
     device time, the top kernels;
  7. the mlp paths again with ``--device cpu``: each test AUC within 0.01 of
     the card's;
then the ``{"kernels": [...]}`` line, nvidia-smi's line, and the
``{"ok": true, ...}`` line.  It imports nothing of JAX.
"""
from __future__ import annotations

import json
import math
import os
import re
import subprocess
import sys
import threading
import time

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))

# Device memory rate (bytes/s) and fp32 peak outside the tensor cores
# (operations/s) by card, from NVIDIA's data sheets (SXM part at 700 W).
CARDS = {"H100 PCIe": (2.0e12, 51e12), "H100 NVL": (3.9e12, 60e12),
         "H100": (3.35e12, 67e12), "H200": (4.8e12, 67e12)}
AUC_OPS_PER_SCORE = 40      # fp32 operations per score in the auc_loss kernel
PROX_OPS_PER_ELEMENT = 6    # 3 mul, 1 sub, 1 add, 1 div
# fp32 operations per element of opt_update: momentum = 1 mul + 1 add + the
# prox step; precond = 1 mul, 2 add, 1 sqrt, 1 div, 1 mul + the prox step.
# (The bf16 store's integer hash, ~12 integer operations, is not fp32 work.)
OPT_OPS_PER_ELEMENT = {"momentum": 2 + PROX_OPS_PER_ELEMENT,
                       "precond": 6 + PROX_OPS_PER_ELEMENT}
MLP_LEAVES, RN_LEAVES = 6, 153
RN_ARGS = ["--arch", "resnet50", "--stages", "1", "--t0", "16", "--n-data", "1024"]


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
    from repro_torch.kernels import ref
    from repro_torch.kernels.prox_update import prox_update
    K = 4
    leaf_sizes = resnet_leaf_sizes()
    cases = [(n, dt) for n in (5, 1000, 4097, K * max(leaf_sizes))
             for dt in (torch.float32, torch.bfloat16)]
    rows = []
    for n, dt in cases:
        v, g, v0 = (torch.randn((n,), generator=gen).to(dev, dt) for _ in range(3))
        got = prox_update(v, g, v0, 0.05, 0.5)
        want = ref.prox_update_ref(v, g, v0, 0.05, 0.5)
        torch.cuda.synchronize()
        tol = 0.0   # bitwise: the same fp32 operations in the same order
        err = float((got.float() - want.float()).abs().max())
        if got.dtype != dt or not torch.equal(got, want):
            raise SystemExit(f"prox_update n={n} {dt} is not bitwise its plain "
                             f"version: max_abs_err={err}")
        ms = cuda_ms(lambda: prox_update(v, g, v0, 0.05, 0.5))
        plain = cuda_ms(lambda: ref.prox_update_ref(v, g, v0, 0.05, 0.5))
        dev_ms = kernel_device_ms(lambda: prox_update(v, g, v0, 0.05, 0.5),
                                  "prox_update")
        bnd, by = bound_ms(4 * n * v.element_size(), PROX_OPS_PER_ELEMENT * n, rates)
        dname = str(dt).replace("torch.", "")
        rows.append({"shape": [n], "dtype": dname, "max_abs_err": err,
                     "tol": tol, "ms": ms, "device_ms": dev_ms, "plain_ms": plain,
                     "bound_ms": bnd, "bound_by": by})
        print(f"prox_update n={n} {dname}: max_abs_err={err:.3g} (bitwise) "
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


def resnet_leaf_sizes():
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.tree import tree_leaves
    return [l.numel() for l in tree_leaves(M.init_params(get_config("resnet50")))]


def _bits(t):
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


def check_opt_update(dev, rates, gen):
    """opt_update against its plain version: bitwise in every mode and dtype,
    the bf16 buffer's stochastic-rounding bits included; and at coef = 0
    with an fp32 buffer, bitwise prox_update."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.opt_update import opt_update
    from repro_torch.kernels.prox_update import prox_update
    K = 4
    leaf_sizes = resnet_leaf_sizes()
    big = K * max(leaf_sizes)
    f32, bf16 = torch.float32, torch.bfloat16
    variants = [("momentum", f32, f32), ("momentum", f32, bf16), ("precond", f32, f32)]
    cases = [(n, *v) for n in (5, 1000, 4097, big) for v in variants]
    cases += [(big, "momentum", bf16, bf16), (big, "precond", bf16, f32)]
    seed = torch.tensor([0x9E3779B9 ^ 0x85EBCA6B], dtype=torch.int64, device=dev)
    rows = []
    for n, mode, vdt, bdt in cases:
        v, g, v0, b = (torch.randn((n,), generator=gen) for _ in range(4))
        v, g, v0 = (t.to(dev, vdt) for t in (v, g, v0))
        b = (b.abs() if mode == "precond" else b).to(dev, bdt)
        coef = 0.9 if mode == "momentum" else 1e-6
        args = (v, g, v0, b, 0.05, 0.5, coef, seed)
        got = opt_update(*args, mode=mode)
        want = ref.opt_update_ref(*args, mode=mode)
        torch.cuda.synchronize()
        err = max(float((x.float() - y.float()).abs().max()) for x, y in zip(got, want))
        if not all(x.dtype == y.dtype and torch.equal(_bits(x), _bits(y))
                   for x, y in zip(got, want)):
            raise SystemExit(f"opt_update n={n} {mode} v {vdt} buf {bdt} is not "
                             f"bitwise its plain version: max_abs_err={err}")
        if mode == "momentum" and bdt == f32 and vdt == f32:
            nv, nm = opt_update(v, g, v0, torch.zeros_like(b), 0.05, 0.5, 0.0, seed,
                                mode="momentum")
            if not (torch.equal(nv, prox_update(v, g, v0, 0.05, 0.5)) and torch.equal(nm, g)):
                raise SystemExit(f"opt_update n={n} at coef=0 is not prox_update bitwise")
        ms = cuda_ms(lambda: opt_update(*args, mode=mode))
        plain = cuda_ms(lambda: ref.opt_update_ref(*args, mode=mode), iters=10)
        dev_ms = kernel_device_ms(lambda: opt_update(*args, mode=mode), "opt_update")
        nbytes = n * (4 * v.element_size() + 2 * b.element_size())
        bnd, by = bound_ms(nbytes, OPT_OPS_PER_ELEMENT[mode] * n, rates)
        name = lambda d: str(d).replace("torch.", "")
        rows.append({"shape": [n], "mode": mode, "dtype": name(vdt), "buf_dtype": name(bdt),
                     "max_abs_err": err, "ms": ms, "device_ms": dev_ms,
                     "plain_ms": plain, "bound_ms": bnd, "bound_by": by})
        print(f"opt_update n={n} {mode} v {name(vdt)} buf {name(bdt)}: bitwise "
              f"(max_abs_err={err:.3g}) kernel {ms * 1e3:.2f} us (device "
              f"{dev_ms * 1e3:.2f} us), plain {plain * 1e3:.2f} us, bound "
              f"{bnd * 1e3:.3f} us ({by})")
    # one ResNet50 local step's sweep, one launch per leaf, as the momentum
    # (bf16 buffer) and sm3 paths run it
    for mode, bdt in (("momentum", bf16), ("precond", f32)):
        leaves = [(torch.randn((K * s,), generator=gen).to(dev),
                   torch.randn((K * s,), generator=gen).to(dev),
                   torch.randn((K * s,), generator=gen).to(dev),
                   torch.rand((K * s,), generator=gen).to(dev, bdt)) for s in leaf_sizes]
        coef = 0.9 if mode == "momentum" else 1e-6
        sweep = lambda fn: [fn(v, g, v0, b, 0.05, 0.5, coef, seed, mode=mode)
                            for v, g, v0, b in leaves]
        ms = cuda_ms(lambda: sweep(opt_update), iters=10)
        plain = cuda_ms(lambda: sweep(ref.opt_update_ref), iters=3, warmup=1)
        dev_ms = kernel_device_ms(lambda: sweep(opt_update), "opt_update", calls=5)
        n = K * sum(leaf_sizes)
        bnd, by = bound_ms(n * (16 + 2 * torch.finfo(bdt).bits // 8),
                           OPT_OPS_PER_ELEMENT[mode] * n, rates)
        rows.append({"shape": [n], "mode": mode, "dtype": "float32",
                     "buf_dtype": str(bdt).replace("torch.", ""),
                     "what": f"resnet50 local step: {len(leaf_sizes)} leaves x K={K}",
                     "launches": len(leaf_sizes), "ms": ms, "device_ms": dev_ms,
                     "plain_ms": plain, "bound_ms": bnd, "bound_by": by})
        print(f"opt_update resnet50 step {mode} buf {bdt} ({len(leaf_sizes)} launches, "
              f"{n:,} elements): kernel {ms:.3f} ms (device {dev_ms:.3f} ms), plain "
              f"{plain:.3f} ms, bound {bnd:.3f} ms ({by})")
        del leaves
    return rows


STEP_OPTIMIZERS = [("sgd", torch.float32), ("momentum", torch.bfloat16),
                   ("sm3", torch.float32), ("shampoo_blocked", torch.float32)]


def check_step(dev):
    """One mlp local step per optimizer with the kernels and with the plain
    versions, from the same state."""
    from repro_torch.configs import mlp_config
    from repro_torch.core import coda
    from repro_torch.tree import tree_leaves
    mcfg = mlp_config()
    g = torch.Generator().manual_seed(1)
    y = (torch.rand((4, 32), generator=g) < 0.71).float()
    batch = {"features": (torch.randn((4, 32, 64), generator=g)
                          + 0.3 * (2 * y[..., None] - 1)).to(dev),
             "labels": y.to(dev)}
    for name, odt in STEP_OPTIMIZERS:
        out = {}
        for impl in ("kernel", "ref"):
            ccfg = coda.CoDAConfig(n_workers=4, p_pos=0.71, impl=impl, optimizer=name,
                                   opt_dtype=odt)
            st = coda.init_state(mcfg, ccfg, generator=torch.Generator().manual_seed(0),
                                 device=dev)
            out[impl] = coda.local_step(mcfg, ccfg, st, batch, 0.5)
        err = max(float((a.float() - b.float()).abs().max()) for a, b in
                  zip(tree_leaves(out["kernel"][0]["params"]),
                      tree_leaves(out["ref"][0]["params"])))
        lerr = float((out["kernel"][1] - out["ref"][1]).abs().max())
        print(f"main-path step (mlp, {name} {str(odt)[6:]}), kernels vs plain versions: "
              f"params max_abs_err={err:.3g}, losses max_abs_err={lerr:.3g} (atol 1e-5)")
        if not (err <= 1e-5 and lerr <= 1e-5):
            raise SystemExit(f"the {name} step with kernels disagrees with the plain "
                             "versions")


def run_main_path(label: str, argv: list[str], leaves_per_step: int,
                  per_leaf: str = "prox_update"):
    """Drive ``train.main(argv)`` with every launch counter set to 0 just
    before and read just after; ``per_leaf`` is the kernel launched once per
    parameter leaf per local step (the other per-leaf kernel must stay 0)."""
    from repro_torch.launch import train
    torch.cuda.reset_peak_memory_stats()
    for mod in train.KERNELS.values():
        mod.launches = 0
    out = train.main(argv)
    counts = {k: mod.launches for k, mod in train.KERNELS.items()}
    steps = out["iterations"]
    # fit's history holds each window's loss, then, on eval windows, the
    # eval value under the same (stage, iteration): keep the losses
    hist = out["history"]
    losses = [h[2] for i, h in enumerate(hist) if i == 0 or hist[i - 1][:2] != h[:2]]
    peak = torch.cuda.max_memory_allocated()
    out["peak_bytes"] = peak
    print(f"{label}: {steps} local steps, {out['ms_per_local_step']:.3f} ms per "
          f"local step (steady median), peak memory {peak / 2**30:.3f} GiB, "
          f"optimizer state {out['opt_state_bytes']:,} B/worker, launches {counts}, "
          f"first/last window loss {losses[0]:.5f}/{losses[-1]:.5f}, test AUC "
          f"{out['auc']:.4f}")
    if not all(math.isfinite(x) for x in losses):
        raise SystemExit(f"{label}: non-finite loss in {losses}")
    if out["leaves"] != leaves_per_step:
        raise SystemExit(f"{label}: {out['leaves']} leaves, expected {leaves_per_step}")
    want = {"auc_loss": steps, "prox_update": 0, "opt_update": 0}
    want[per_leaf] = steps * leaves_per_step
    if counts != want or out["launches"] != want:
        raise SystemExit(f"{label}: launch counts {counts} (main's {out['launches']}), "
                         f"expected {want}")
    scores = out["test_scores"]
    if not (scores.dim() == 1 and bool(torch.isfinite(scores).all())):
        raise SystemExit(f"{label}: test scores not a finite vector")
    return out, counts


# (label, launcher arguments, the kernel launched once per leaf per step)
MLP_PATHS = [
    ("mlp", [], "prox_update"),
    ("mlp_momentum", ["--optimizer", "momentum", "--opt-dtype", "bf16"], "opt_update"),
    ("mlp_sm3", ["--optimizer", "sm3"], "opt_update"),
    ("mlp_shampoo", ["--optimizer", "shampoo_blocked"], "prox_update"),
    ("mlp_sketch", ["--metrics", "sketch", "--metric-interval", "4"], "prox_update"),
]
RN_PATHS = [
    ("resnet50", [], "prox_update"),
    ("resnet50_momentum", ["--optimizer", "momentum", "--opt-dtype", "bf16"], "opt_update"),
    ("resnet50_sm3", ["--optimizer", "sm3"], "opt_update"),
]


class CpuTwins:
    """The mlp paths' commands again with ``--device cpu``, one process after
    another in a background thread at the lowest CPU priority (``nice``), so
    the CPU runs overlap the card's phases; ``stop`` ends the running
    process, whatever state the script is in."""

    def __init__(self, paths, threads: int = 6):
        self.paths, self.threads = paths, threads
        self.auc: dict[str, float] = {}
        self.errors: list[str] = []
        self._lock = threading.Lock()
        self._proc = None
        self._stopped = False
        self._thread = threading.Thread(target=self._run, daemon=True)

    def start(self):
        self._thread.start()
        return self

    def _run(self):
        env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
                   OMP_NUM_THREADS=str(self.threads))
        for label, args, _ in self.paths:
            with self._lock:
                if self._stopped:
                    return
                self._proc = subprocess.Popen(
                    ["nice", "-n", "19", sys.executable, "-m", "repro_torch.launch.train",
                     "--device", "cpu", *args], cwd=ROOT, env=env,
                    stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            out, err = self._proc.communicate()
            found = re.search(r"^done: .* test AUC=(\d\.\d+)$", out, re.M)
            if self._proc.returncode != 0 or not found:
                self.errors.append(f"{label}: exit {self._proc.returncode}\n"
                                   f"{out[-1500:]}{err[-1500:]}")
            else:
                self.auc[label] = float(found.group(1))

    def wait(self, timeout: float = 900.0):
        t0 = time.perf_counter()
        self._thread.join(timeout)
        if self._thread.is_alive():
            raise SystemExit(f"the CPU runs of the mlp paths took over {timeout:.0f} s")
        if self.errors:
            raise SystemExit("a CPU run of an mlp path failed:\n" + "\n".join(self.errors))
        print(f"cpu runs: waited {time.perf_counter() - t0:.1f} s for the --device cpu "
              "runs of the mlp paths")

    def stop(self):
        with self._lock:
            self._stopped = True
            if self._proc is not None and self._proc.poll() is None:
                self._proc.kill()
                self._proc.wait()


def profile_window(label: str, arch: str, state, dev, **ccfg_kw) -> dict:
    """Where one window (I=8 local steps + the average) of a main path spends
    its time: host wall time, device busy time, the hand-written kernels'
    share, and the kernels that take the most device time."""
    from repro_torch.configs import get_config, mlp_config
    from repro_torch.core import coda
    mcfg = mlp_config() if arch == "mlp" else get_config(arch)
    ccfg = coda.CoDAConfig(n_workers=4, p_pos=0.71, **ccfg_kw)
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
            for tag in ("auc_loss", "prox_update", "opt_update")}
    top = sorted(per.items(), key=lambda kv: -kv[1])[:6]
    out = {"path": label, "local_steps": 8, "wall_ms": wall, "device_busy_ms": busy,
           "kernel_sum_ms": sum(per.values()), "idle_share": 1.0 - busy / wall,
           "hand_written_ms": ours,
           "top_kernels_ms": {k[:90]: v for k, v in top}}
    print(f"profile {label} window: wall {wall:.3f} ms, device busy {busy:.3f} ms "
          f"(idle share {1.0 - busy / wall:.3f}; kernel time summed "
          f"{sum(per.values()):.3f} ms), auc_loss {ours['auc_loss']:.4f} ms, "
          f"prox_update {ours['prox_update']:.4f} ms, opt_update "
          f"{ours['opt_update']:.4f} ms")
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

    twins = CpuTwins(MLP_PATHS).start()
    try:
        return run_phases(dev, rates, twins)
    finally:
        twins.stop()


def run_phases(dev, rates, twins) -> int:
    gen = torch.Generator().manual_seed(0)
    auc_rows = check_auc_loss(dev, rates, gen)
    prox_rows = check_prox_update(dev, rates, gen)
    opt_rows = check_opt_update(dev, rates, gen)
    check_step(dev)

    runs, counts = {}, {}
    for label, args, per_leaf in MLP_PATHS:
        runs[label], counts[label] = run_main_path(f"main path {label}", args,
                                                   MLP_LEAVES, per_leaf)
    if not runs["mlp"]["auc"] > 0.9:
        raise SystemExit(f"main path mlp: test AUC {runs['mlp']['auc']:.4f} <= 0.9")
    sk = runs["mlp_sketch"]["state"]["sk_acc"]
    n_scored = int(sk["pos"][0].sum() + sk["neg"][0].sum())
    want = runs["mlp_sketch"]["iterations"] * 4 * 32
    print(f"main path mlp_sketch: the merged sketch counts {n_scored:,} scores "
          f"(local steps × K × B = {want:,})")
    if n_scored != want:
        raise SystemExit("main path mlp_sketch: sketch count disagrees")
    profile_window("mlp", "mlp", runs["mlp"]["state"], dev)
    for label, args, per_leaf in RN_PATHS:
        runs[label], counts[label] = run_main_path(f"main path {label}", RN_ARGS + args,
                                                   RN_LEAVES, per_leaf)
    profile_window("resnet50", "resnet50", runs["resnet50"]["state"], dev)
    prof = profile_window("resnet50_momentum", "resnet50", runs["resnet50_momentum"]["state"],
                          dev, optimizer="momentum", opt_dtype=torch.bfloat16)
    n_step = 4 * sum(resnet_leaf_sizes())
    k3_bound, _ = bound_ms(20 * n_step, OPT_OPS_PER_ELEMENT["momentum"] * n_step, rates)
    print(f"profile resnet50_momentum: opt_update {prof['hand_written_ms']['opt_update'] / 8:.4f} "
          f"ms of device time per local step ({RN_LEAVES} launches) against a bound of "
          f"{k3_bound:.4f} ms (20 B per element, bf16 buffer)")

    # the mlp paths on the CPU, same commands: test AUC within 0.01
    twins.wait()
    for label, _, _ in MLP_PATHS:
        card, cpu = runs[label]["auc"], twins.auc[label]
        print(f"main path {label}: test AUC {card:.4f} on the card, {cpu:.4f} with "
              f"--device cpu (|diff| {abs(card - cpu):.4f}, limit 0.01)")
        if not abs(card - cpu) <= 0.01:
            raise SystemExit(f"main path {label}: card and CPU test AUC differ by more "
                             "than 0.01")

    def row(name, replaces, rows, head, tol):
        h = rows[head]
        by_path = {label: c[name] for label, c in counts.items()}
        err = max(r.get("max_abs_err", 0.0) for r in rows)
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
    # at ResNet50's largest leaf × K in fp32; opt_update there too, momentum
    # with the bf16 buffer the launcher paths use
    auc_head = next(i for i, r in enumerate(auc_rows) if r["shape"] == [4, 32])
    big = max(r["shape"][0] for r in prox_rows if "what" not in r)
    prox_head = next(i for i, r in enumerate(prox_rows)
                     if r["shape"] == [big] and r["dtype"] == "float32")
    opt_head = next(i for i, r in enumerate(opt_rows)
                    if r["shape"] == [big] and "what" not in r and r["mode"] == "momentum"
                    and r["dtype"] == "float32" and r["buf_dtype"] == "bfloat16")
    kernels = [
        row("auc_loss", "src/repro/kernels/auc_loss.py:61", auc_rows, auc_head,
            "atol 1e-5 + rtol 1e-4"),
        row("prox_update", "src/repro/kernels/prox_update.py:39", prox_rows, prox_head,
            "bitwise (0) in f32 and bf16"),
        row("opt_update", "src/repro/kernels/opt_update.py:72", opt_rows, opt_head,
            "bitwise (0): v and buffer in every mode and dtype, bf16 rounding bits "
            "included; coef=0 equals prox_update bitwise"),
    ]
    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
