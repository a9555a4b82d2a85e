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
     version with CUDA events after warm-up: auc_loss (one launch a call,
     bitwise equal from call to call) within atol 1e-5 + rtol 1e-4,
     prox_update and opt_update bitwise (opt_update's bf16
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
  7. the smoke paths again with ``--device cpu``: each test AUC within 0.01 of
     the card's;
  8. K4 flash_attention against its plain version (``ref.attention_full``)
     on the card, fp32 within atol 2e-5 + rtol 2e-5 (through
     flash_fwd_tf32x3 at head_dim 64 and 128, its max and mean error printed
     beside SDPA's, its bound 3× the operations at the TF32 rate beside the
     fp32 FFMA bound; through flash_fwd at head_dim 32), bf16 through
     flash_fwd (head_dim 16/32) within one bf16 ulp (rtol 2^-7) + atol
     1e-4, bf16 through flash_fwd_wgmma (head_dim 64/128) within rtol 2^-7
     + atol 2^-9·max|v| + 1e-4 (P rounded to bf16 before P·V) and within
     2× SDPA's max and 1.5× its mean error against the fp32 plain version,
     at stablelm-1.6b's training shape [128, 64, 32, 64] and prefill shape
     [4, 2048, 32, 64] (causal, and with window 256), qwen2.5-14b's GQA
     [1, 2048, 40/8, 128] (and with window 256), chatglm3-6b's prefill
     shape [4, 2048, 32/2, 128], dbrx-132b's [2, 1024, 48/8, 128] and its
     smoke training shape [128, 64, 4/2, 128] (two heads a block), MQA,
     non-causal S=512 against Skv=2048, a ragged S=1000 (head_dim 64 and
     128) and a smoke width (head_dim 32, fp32 and bf16); each routed to
     the variant ``launch_geometry`` names (its counter checked), timed
     with CUDA events and the profiler (the profiler's time only when it
     recorded every launch the wrapper counted, else CUDA events, marked)
     beside its bound, the plain version and SDPA; the backward against
     autograd through the plain version at the training shape;
  9. full-depth fp32 prefills at full width, one replica each:
     stablelm-1.6b (24 layers, 1,644,369,921 parameters, head_dim 64) and
     chatglm3-6b (28 layers, 6,243,588,097 parameters, head_dim 128):
     ``prefill_step`` on [B=4, S=2048] tokens with the kernel and with
     ``impl="ref"`` (scores, last logits and bf16 caches compared), exactly
     one K4 launch per layer, all flash_fwd_tf32x3, ms per prefill,
     tokens/s, peak memory and a profile of one prefill (K4's and the
     GEMMs' shares);
 10. stablelm-1.6b CoDA training at full width, depth cut to 2 layers
     (K=4, B=32, S=64, sgd, one stage of 16 local steps) through
     ``train.main`` with exact launch counts of auc_loss, prox_update and
     flash_attention (every K4 launch flash_fwd_tf32x3), and a profiled
     window; and ``--arch stablelm-1.6b
     --smoke`` on the card, its test AUC within 0.01 of the same command
     with ``--device cpu`` (run with the mlp paths' CPU twins);
 11. K5 grouped_matmul against its plain version (``ref.grouped_matmul_ref``)
     on the card, fp32 within atol = rtol = 5e-5 and bf16 within one bf16
     ulp + atol 1e-4, at dbrx-132b's decode (N=16, gmm_rows) and prefill
     (N=8192, gmm_tiles) expert shapes in fp32 and its prefill shape in
     bf16, arctic-480b's (128 experts, N=8 and 4096) in bf16 (gmm_wgmma),
     K-folded strided weights in both dtypes, the reference's edge tables,
     N = 1 and aligned ragged groups in bf16; each case's kernel checked
     against the one ``launch_geometry`` names; group
     sizes from a seeded top-k routing; each timed beside its bound (the hit
     experts' bytes or the operations), the plain version and
     torch._grouped_mm where the installed torch takes the inputs (run with
     the kernel checks of phase 3);
 12. dbrx-132b at full width with 2 of 40 layers (7,751,337,985 fp32
     parameters, one replica): ``prefill_step`` on [B=2, S=1024] with the
     kernels and with ``impl="ref"`` (2 K4 and 6 K5 launches per prefill,
     every K4 launch flash_fwd_tf32x3 and every K5 launch gmm_tiles;
     scores, logits and caches compared, a profile with the K5, K4 and
     cuBLAS shares); then the same parameters through ``ServingEngine``
     (4 slots, max_len 64, chunk 8, a batch trace of 8 requests) with
     ``impl="auto"`` and ``"ref"``: tokens equal (a flip only at a printed
     near tie), scores within 1e-4, K5 launches = 3 × 2 × serve steps; ms
     per prefill and decode tick, tokens/s, TTFT and latency, a profiled
     decode tick against K5's bound;
 13. ``--arch dbrx-132b --smoke`` training (K5 only in eval forwards; every
     K4 launch flash_fwd_tf32x3, two heads a block) and
     ``launch/serve.py --arch dbrx-132b --labeled --metrics sketch`` on the
     card with exact launch counts, against their ``--device cpu`` twins:
     test AUC within 0.01; the printed requests' tokens equal and the served
     AUC within 0.01;
then the ``{"kernels": [...]}`` line (all five kernels), nvidia-smi's line,
and the ``{"ok": true, ...}`` line.  It imports nothing of JAX.
"""
from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import math
import os
import re
import statistics
import subprocess
import sys
import threading
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))

# Device memory rate (bytes/s) and fp32 peak outside the tensor cores
# (operations/s) by card, from NVIDIA's data sheets (SXM part at 700 W).
CARDS = {"H100 PCIe": (2.0e12, 51e12), "H100 NVL": (3.9e12, 60e12),
         "H100": (3.35e12, 67e12), "H200": (4.8e12, 67e12)}
# dense bf16 tensor-core peak (operations/s), the bound for bf16 inputs;
# the dense TF32 peak is half of it (NVIDIA's data sheet: 495 TFLOP/s on the
# H100 SXM), the rate of flash_fwd_tf32x3's three products per fp32 product
BF16_PEAK = {"H100 PCIe": 756e12, "H100 NVL": 835e12, "H100": 989e12, "H200": 989e12}
TF32_PER_BF16 = 0.5
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


def device_profile(fn, counts: dict | None = None):
    """Run ``fn`` once under torch.profiler.  Returns (host wall ms, device
    busy ms, {kernel name: device ms summed over its launches}); ``counts``,
    if given, receives the number of recorded launches per kernel name.
    Busy time is the union of the kernels' intervals: cuDNN may run kernels
    of one grouped convolution concurrently, so the per-kernel sum can
    exceed it."""
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
            if counts is not None:
                counts[e.name] = counts.get(e.name, 0) + 1
            spans.append((e.time_range.start, e.time_range.end))
    busy, reach = 0.0, float("-inf")
    for start, end in sorted(spans):
        if end > reach:
            busy += end - max(start, reach)
            reach = end
    return wall, busy / 1e3, per


def kernel_device_ms(fn, tag: str, module, calls: int = 20,
                     kernels_per_launch: int = 1) -> tuple[float, str]:
    """Device time per call of ``fn`` from the profiler (no host time in
    it): the device time of the kernels whose names contain ``tag`` over
    ``calls`` calls.  The profiler has been seen to record fewer launches
    than were made, so its count is held against the wrapper's counter
    (``module.launches``; ``kernels_per_launch`` kernels per counted
    launch, e.g. K5's offset scan and its GEMM): the profiler's time is
    reported only when the two agree (one more try if not), else the
    CUDA-event time of ``calls`` calls.  Returns (ms, "profiler" or
    "cuda_events")."""
    for _ in range(2):
        n: dict[str, int] = {}
        before = module.launches
        _, _, per = device_profile(lambda: [fn() for _ in range(calls)], n)
        made = (module.launches - before) * kernels_per_launch
        seen = sum(c for k, c in n.items() if tag in k)
        if seen == made and made > 0:
            return sum(v for k, v in per.items() if tag in k) / calls, "profiler"
        print(f"profiler: recorded {seen} of {made} launches of {tag}")
    print(f"profiler: {tag} timed with CUDA events instead")
    return cuda_ms(fn, iters=calls), "cuda_events"


def dev_txt(ms: float, source: str, unit: str = "ms") -> str:
    """A device time for the log, marked when it is CUDA-event time."""
    scale = 1e3 if unit == "us" else 1.0
    what = "device" if source == "profiler" else "CUDA events"
    return f"{what} {ms * scale:.{2 if unit == 'us' else 4}f} {unit}"


def bound_ms(n_bytes: float, n_ops: float, rates) -> tuple[float, str]:
    t_bytes, t_ops = n_bytes / rates[0] * 1e3, n_ops / rates[1] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def bf16_peak(name: str) -> float:
    for key, rate in BF16_PEAK.items():   # most specific names first
        if key in name:
            return rate
    raise SystemExit(f"no bf16 peak on record for {name!r}")


def check_auc_loss(dev, rates, gen):
    """K1 against its plain version (atol 1e-5 + rtol 1e-4) and bitwise
    equal from call to call, at the main path's [4, 32], ragged T, T over
    several blocks and over 32 blocks (the ticket path); one kernel per
    call (the profiler's count held to the wrapper's)."""
    from repro_torch.kernels import auc_loss as K1
    from repro_torch.kernels import ref
    from repro_torch.kernels.auc_loss import auc_loss
    atol, rtol = 1e-5, 1e-4
    rows = []
    for K, T in ((1, 7), (4, 100), (4, 513), (4, 32), (8, 4096), (2, 65536)):
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
        dev_ms, dev_src = kernel_device_ms(lambda: auc_loss(h, y, a, b, al, 0.71),
                                           "auc_loss", K1)
        bnd, by = bound_ms(12 * K * T + 28 * K, AUC_OPS_PER_SCORE * K * T, rates)
        rows.append({"shape": [K, T], "ticket": K1.launch_geometry(K, T)["ticket"],
                     "max_abs_err": err, "ms": ms,
                     "device_ms": dev_ms, "device_ms_source": dev_src,
                     "plain_ms": plain, "bound_ms": bnd,
                     "bound_by": by})
        print(f"auc_loss [{K},{T}]: max_abs_err={err:.3g} (atol {atol}, rtol "
              f"{rtol}) kernel {ms * 1e3:.2f} us ({dev_txt(dev_ms, dev_src, 'us')}), "
              f"plain {plain * 1e3:.2f} us, bound {bnd * 1e3:.3f} us ({by})")
    return rows


def check_prox_update(dev, rates, gen):
    from repro_torch.kernels import prox_update as K2
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
        dev_ms, dev_src = kernel_device_ms(lambda: prox_update(v, g, v0, 0.05, 0.5),
                                           "prox_update", K2)
        bnd, by = bound_ms(4 * n * v.element_size(), PROX_OPS_PER_ELEMENT * n, rates)
        dname = str(dt).replace("torch.", "")
        rows.append({"shape": [n], "dtype": dname, "max_abs_err": err,
                     "tol": tol, "ms": ms, "device_ms": dev_ms,
                     "device_ms_source": dev_src, "plain_ms": plain,
                     "bound_ms": bnd, "bound_by": by})
        print(f"prox_update n={n} {dname}: max_abs_err={err:.3g} (bitwise) "
              f"kernel {ms * 1e3:.2f} us ({dev_txt(dev_ms, dev_src, 'us')}), plain "
              f"{plain * 1e3:.2f} us, bound {bnd * 1e3:.3f} us ({by})")
    # one ResNet50 local step's sweep: every leaf × K, one launch per leaf
    leaves = [tuple(torch.randn((K * s,), generator=gen).to(dev) for _ in range(3))
              for s in leaf_sizes]
    sweep = lambda fn: [fn(v, g, v0, 0.05, 0.5) for v, g, v0 in leaves]
    ms = cuda_ms(lambda: sweep(prox_update), iters=10)
    plain = cuda_ms(lambda: sweep(ref.prox_update_ref), iters=10)
    dev_ms, dev_src = kernel_device_ms(lambda: sweep(prox_update), "prox_update", K2,
                                       calls=5)
    n = K * sum(leaf_sizes)
    bnd, by = bound_ms(16 * n, PROX_OPS_PER_ELEMENT * n, rates)
    rows.append({"shape": [n], "dtype": "float32",
                 "what": f"resnet50 local step: {len(leaf_sizes)} leaves x K={K}",
                 "launches": len(leaf_sizes), "ms": ms, "device_ms": dev_ms,
                 "device_ms_source": dev_src, "plain_ms": plain, "bound_ms": bnd,
                 "bound_by": by})
    print(f"prox_update resnet50 step ({len(leaf_sizes)} launches, {n:,} "
          f"elements): kernel {ms:.3f} ms ({dev_txt(dev_ms, dev_src)}), plain "
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
    from repro_torch.kernels import opt_update as K3
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
        dev_ms, dev_src = kernel_device_ms(lambda: opt_update(*args, mode=mode),
                                           "opt_update", K3)
        nbytes = n * (4 * v.element_size() + 2 * b.element_size())
        bnd, by = bound_ms(nbytes, OPT_OPS_PER_ELEMENT[mode] * n, rates)
        name = lambda d: str(d).replace("torch.", "")
        rows.append({"shape": [n], "mode": mode, "dtype": name(vdt), "buf_dtype": name(bdt),
                     "max_abs_err": err, "ms": ms, "device_ms": dev_ms,
                     "device_ms_source": dev_src, "plain_ms": plain, "bound_ms": bnd,
                     "bound_by": by})
        print(f"opt_update n={n} {mode} v {name(vdt)} buf {name(bdt)}: bitwise "
              f"(max_abs_err={err:.3g}) kernel {ms * 1e3:.2f} us "
              f"({dev_txt(dev_ms, dev_src, 'us')}), plain {plain * 1e3:.2f} us, bound "
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
        dev_ms, dev_src = kernel_device_ms(lambda: sweep(opt_update), "opt_update", K3,
                                           calls=5)
        n = K * sum(leaf_sizes)
        bnd, by = bound_ms(n * (16 + 2 * torch.finfo(bdt).bits // 8),
                           OPT_OPS_PER_ELEMENT[mode] * n, rates)
        rows.append({"shape": [n], "mode": mode, "dtype": "float32",
                     "buf_dtype": str(bdt).replace("torch.", ""),
                     "what": f"resnet50 local step: {len(leaf_sizes)} leaves x K={K}",
                     "launches": len(leaf_sizes), "ms": ms, "device_ms": dev_ms,
                     "device_ms_source": dev_src, "plain_ms": plain, "bound_ms": bnd,
                     "bound_by": by})
        print(f"opt_update resnet50 step {mode} buf {bdt} ({len(leaf_sizes)} launches, "
              f"{n:,} elements): kernel {ms:.3f} ms ({dev_txt(dev_ms, dev_src)}), plain "
              f"{plain:.3f} ms, bound {bnd:.3f} ms ({by})")
        del leaves
    return rows


F32, BF16 = torch.float32, torch.bfloat16
# (label, B, S, H, KV, Skv, hd, causal, window, dtype): stablelm-1.6b's
# training shape (K·B = 128 sequences of 64 tokens) and prefill shape,
# qwen2.5-14b's GQA, chatglm3-6b's and dbrx-132b's prefill shapes, the dbrx
# smoke training shape, MQA, cross-shaped, windowed and ragged cases, and a
# smoke width; the bf16 cases at head_dim 64/128 run flash_fwd_wgmma, the
# fp32 cases at head_dim 64/128 flash_fwd_tf32x3 (two heads a block where S,
# Skv <= 64), head_dim 32 flash_fwd
ATTN_CASES = [
    ("stablelm_train", 128, 64, 32, 32, 64, 64, True, None, F32),
    ("stablelm_train_bf16", 128, 64, 32, 32, 64, 64, True, None, BF16),
    ("stablelm_prefill", 4, 2048, 32, 32, 2048, 64, True, None, F32),
    ("stablelm_prefill_bf16", 4, 2048, 32, 32, 2048, 64, True, None, BF16),
    ("stablelm_prefill_window256", 4, 2048, 32, 32, 2048, 64, True, 256, F32),
    ("stablelm_prefill_window256_bf16", 4, 2048, 32, 32, 2048, 64, True, 256, BF16),
    ("qwen_gqa", 1, 2048, 40, 8, 2048, 128, True, None, F32),
    ("qwen_gqa_bf16", 1, 2048, 40, 8, 2048, 128, True, None, BF16),
    ("qwen_gqa_window256", 1, 2048, 40, 8, 2048, 128, True, 256, F32),
    ("chatglm_prefill", 4, 2048, 32, 2, 2048, 128, True, None, F32),
    ("dbrx_prefill", 2, 1024, 48, 8, 1024, 128, True, None, F32),
    ("dbrx_smoke_train", 128, 64, 4, 2, 64, 128, True, None, F32),
    ("mqa", 2, 1024, 16, 1, 1024, 64, True, None, F32),
    ("mqa_hd128_bf16", 2, 1024, 16, 1, 1024, 128, True, None, BF16),
    ("noncausal_skv2048", 2, 512, 8, 8, 2048, 64, False, None, F32),
    ("noncausal_skv2048_hd128", 2, 512, 8, 8, 2048, 128, False, None, F32),
    ("ragged_s1000", 2, 1000, 8, 8, 1000, 64, True, None, F32),
    ("ragged_s1000_hd128", 2, 1000, 8, 8, 1000, 128, True, None, F32),
    ("ragged_s1000_hd128_bf16", 2, 1000, 8, 8, 1000, 128, True, None, BF16),
    ("smoke_hd32", 2, 256, 8, 2, 256, 32, True, None, F32),
    ("smoke_hd32_bf16", 2, 256, 8, 2, 256, 32, True, None, BF16),
]
# (atol, rtol): fp32 is the reference's own; bf16 through flash_fwd (head_dim
# 16/32): kernel and plain version both compute in fp32 and round once, so
# one bf16 ulp (≤ 2^-7 of the value) plus fp32 noise near zero
ATTN_TOL = {F32: (2e-5, 2e-5), BF16: (1e-4, 2 ** -7)}
# bf16 through flash_fwd_wgmma: it rounds each probability to bf16 before
# P·V (relative error ≤ 2^-9), as every tensor-core attention does; the
# weights sum to 1, so an output moves by at most 2^-9·max|v|; then the one
# ulp of the final rounding: atol = ATTN_P_ROUND·max|v| + 1e-4, rtol 2^-7.
# Beside it, the kernel's max and mean error against the fp32 plain version
# stay within 2× and 1.5× SDPA's own on the same inputs.
ATTN_P_ROUND = 2 ** -9
ATTN_SDPA_MAX, ATTN_SDPA_MEAN = 2.0, 1.5
LSE_ATOL = 1e-4                      # log-sum-exp of O(10) values in fp32
ATTN_BWD_TOL = 5e-5                  # atol = rtol, as tests/test_torch_attention.py


def attn_pairs(S: int, Skv: int, causal: bool, window) -> int:
    """(query, key) pairs inside the mask: the work this call's data needs."""
    from repro_torch.kernels import ref
    return int(ref._mask(torch.arange(S), torch.arange(Skv), causal, window).sum())


def sdpa_fn(q, k, v, causal: bool, window):
    """One ``scaled_dot_product_attention`` call on the same inputs (heads
    second; ``enable_gqa`` for GQA; an explicit boolean mask for the
    window).  Timed as the library yardstick only: the port never calls it."""
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    gqa = q.shape[2] != k.shape[2]
    if window is None:
        return lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                                      enable_gqa=gqa)
    pos = lambda n: torch.arange(n, device=q.device)
    mask = ref._mask(pos(q.shape[1]), pos(k.shape[1]), causal, window)
    return lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                                  enable_gqa=gqa)


def check_flash_attention(dev, rates, bf16_rate, gen):
    """K4 against its plain version at each case: output within ATTN_TOL,
    log-sum-exp within LSE_ATOL; CUDA-event time, device time, bound, the
    plain version's time and SDPA's.  Then the backward at the training
    shape against autograd through the plain version."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    rows = []
    for label, B, S, H, KV, Skv, hd, causal, window, dt in ATTN_CASES:
        q = torch.randn((B, S, H, hd), generator=gen).to(dev, dt)
        k, v = (torch.randn((B, Skv, KV, hd), generator=gen).to(dev, dt) for _ in range(2))
        kw = dict(causal=causal, window=window)
        variant = fa.launch_geometry(B, S, H, KV, Skv, hd, dt)["kernel"]
        before = fa.variant_launches[variant]
        o, lse = fa.flash_attention_fwd(q, k, v, **kw)
        want, want_lse = ref.attention_full(q, k, v, return_lse=True, **kw)
        torch.cuda.synchronize()
        if fa.variant_launches[variant] != before + 1:
            raise SystemExit(f"flash_attention {label}: {variant} was not launched")
        atol, rtol = ATTN_TOL[dt]
        if variant == "flash_fwd_wgmma":
            atol = ATTN_P_ROUND * float(v.float().abs().max()) + ATTN_TOL[BF16][0]
        diff = (o.float() - want.float()).abs()
        err = float(diff.max())
        lse_err = float((lse - want_lse).abs().max())
        if not (bool((diff <= atol + rtol * want.float().abs()).all()) and lse_err <= LSE_ATOL):
            raise SystemExit(f"flash_attention {label} disagrees with its plain version: "
                             f"max_abs_err={err} (atol {atol}, rtol {rtol}), lse err {lse_err}")
        lib = sdpa_fn(q, k, v, causal, window)
        if dt == BF16:
            # kernel and SDPA against the fp32 plain version on the same bf16 inputs
            exact = ref.attention_full(q.float(), k.float(), v.float(), **kw)
            de = (o.float() - exact).abs()
            ds = (lib().transpose(1, 2).float() - exact).abs()
            del exact
        else:
            # fp32: kernel and SDPA against the plain version, all in fp32
            de, ds = diff, (lib().transpose(1, 2) - want).abs()
        vs_sdpa = {"max_err_vs_fp32": float(de.max()), "mean_err_vs_fp32": float(de.mean()),
                   "sdpa_max_err_vs_fp32": float(ds.max()),
                   "sdpa_mean_err_vs_fp32": float(ds.mean())}
        del de, ds, diff, want
        print(f"flash_attention {label} vs the fp32 plain version: max/mean err "
              f"{vs_sdpa['max_err_vs_fp32']:.3g}/{vs_sdpa['mean_err_vs_fp32']:.3g}, SDPA "
              f"{vs_sdpa['sdpa_max_err_vs_fp32']:.3g}/{vs_sdpa['sdpa_mean_err_vs_fp32']:.3g}")
        if variant == "flash_fwd_wgmma" and not (
                vs_sdpa["max_err_vs_fp32"] <= ATTN_SDPA_MAX * vs_sdpa["sdpa_max_err_vs_fp32"]
                and vs_sdpa["mean_err_vs_fp32"]
                <= ATTN_SDPA_MEAN * vs_sdpa["sdpa_mean_err_vs_fp32"]):
            raise SystemExit(f"flash_attention {label}: error beyond {ATTN_SDPA_MAX}× "
                             f"(max) or {ATTN_SDPA_MEAN}× (mean) SDPA's: {vs_sdpa}")
        ms = cuda_ms(lambda: fa.flash_attention_fwd(q, k, v, **kw), iters=20)
        dev_ms, dev_src = kernel_device_ms(lambda: fa.flash_attention_fwd(q, k, v, **kw),
                                           "flash_fwd", fa, calls=5)
        plain = cuda_ms(lambda: ref.attention_full(q, k, v, **kw), iters=5, warmup=2)
        lib_ms = cuda_ms(lib, iters=20)
        pairs = attn_pairs(S, Skv, causal, window)
        es = q.element_size()
        n_bytes = es * (2 * B * S * H * hd + 2 * B * Skv * KV * hd) + 4 * B * H * S
        n_ops = 4 * B * H * hd * pairs        # q·k and p·v, 2 operations a product
        bnd, by = bound_ms(n_bytes, n_ops, (rates[0], rates[1] if dt == F32 else bf16_rate))
        tf32 = {}
        if variant == "flash_fwd_tf32x3":
            # three tf32 products per fp32 product on the tensor cores; the
            # fp32 FFMA bound beside it
            tf32 = {"bound_ffma_ms": bnd, "bound_ffma_by": by}
            bnd, by = bound_ms(n_bytes, 3 * n_ops, (rates[0], TF32_PER_BF16 * bf16_rate))
        dname = str(dt).replace("torch.", "")
        rows.append({"case": label, "shape": [B, S, H, KV, Skv, hd], "causal": causal,
                     "window": window, "dtype": dname, "kernel": variant, "max_abs_err": err,
                     "lse_max_abs_err": lse_err, "atol": atol, "rtol": rtol, "ms": ms,
                     "device_ms": dev_ms, "device_ms_source": dev_src,
                     "plain_ms": plain, "library_ms": lib_ms, "bound_ms": bnd,
                     "bound_by": by, **tf32, "gflop": n_ops / 1e9, "mbytes": n_bytes / 1e6,
                     **vs_sdpa})
        print(f"flash_attention {label} [B={B}, S={S}, H={H}, KV={KV}, Skv={Skv}, hd={hd}] "
              f"{'causal' if causal else 'full'} window={window} {dname} {variant}: "
              f"max_abs_err={err:.3g} (atol {atol:.3g}, rtol {rtol:g}), lse err {lse_err:.3g}; "
              f"kernel {ms:.4f} ms ({dev_txt(dev_ms, dev_src)}), plain {plain:.4f} ms, SDPA "
              f"{lib_ms:.4f} ms, bound {bnd:.4f} ms ({by}: {n_ops / 1e9:.2f} GFLOP, "
              f"{n_bytes / 1e6:.1f} MB)"
              + (f"; 3xTF32 at {TF32_PER_BF16 * bf16_rate / 1e12:.0f} TFLOP/s, fp32 FFMA bound "
                 f"{tf32['bound_ffma_ms']:.4f} ms ({tf32['bound_ffma_by']})" if tf32 else ""))
        del q, k, v, o, lse, want_lse
    # the backward (plain tensor code over the kernel's saved log-sum-exp) at
    # the training shape, against autograd through the plain version
    q = torch.randn((128, 64, 32, 64), generator=gen).to(dev).requires_grad_()
    k, v = (torch.randn((128, 64, 32, 64), generator=gen).to(dev).requires_grad_()
            for _ in range(2))
    do = torch.randn((128, 64, 32, 64), generator=gen).to(dev)
    got = torch.autograd.grad(fa.flash_attention(q, k, v, causal=True), (q, k, v), do)
    want = torch.autograd.grad(ref.attention_full(q, k, v, causal=True), (q, k, v), do)
    errs = [float((g - w).abs().max()) for g, w in zip(got, want)]
    ok = all(bool(((g - w).abs() <= ATTN_BWD_TOL * (1 + w.abs())).all())
             for g, w in zip(got, want))
    fwd = lambda: fa.flash_attention(q, k, v, causal=True)
    bwd_ms = cuda_ms(lambda: torch.autograd.grad(fwd(), (q, k, v), do), iters=10)
    plain_bwd_ms = cuda_ms(lambda: torch.autograd.grad(
        ref.attention_full(q, k, v, causal=True), (q, k, v), do), iters=10)
    bwd = {"case": "stablelm_train backward", "shape": [128, 64, 32, 32, 64, 64],
           "max_abs_err": max(errs), "errs_dq_dk_dv": errs, "tol": ATTN_BWD_TOL,
           "fwd_bwd_ms": bwd_ms, "plain_fwd_bwd_ms": plain_bwd_ms}
    print(f"flash_attention backward at the training shape: dq/dk/dv max_abs_err "
          f"{errs[0]:.3g}/{errs[1]:.3g}/{errs[2]:.3g} (atol=rtol={ATTN_BWD_TOL}); forward "
          f"+ backward {bwd_ms:.4f} ms with the kernel, {plain_bwd_ms:.4f} ms through "
          "the plain version")
    if not ok:
        raise SystemExit("flash_attention's backward disagrees with autograd through "
                         "the plain version")
    return rows, bwd


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


def zero_counts():
    """Set every launch counter to 0: each kernel's, and each variant's."""
    from repro_torch.launch import train
    for mod in train.KERNELS.values():
        mod.launches = 0
        if hasattr(mod, "zero_launches"):
            mod.zero_launches()


def read_counts() -> dict:
    from repro_torch.launch import train
    return {k: mod.launches for k, mod in train.KERNELS.items()}


def run_main_path(label: str, argv: list[str], leaves_per_step: int,
                  per_leaf: str = "prox_update", attn_layers: int = 0, moe_layers: int = 0):
    """Drive ``train.main(argv)`` with every launch counter set to 0 just
    before and read just after; ``per_leaf`` is the kernel launched once per
    parameter leaf per local step (the other per-leaf kernel must stay 0).
    ``flash_attention`` runs once per attention layer in every forward: each
    local step and each stage-end α batch inside ``fit``, then each chunk of
    the held-out split the launcher scores after it.  ``grouped_matmul``
    runs three times per moe layer in every eval forward (the stage-end α
    batches and the held-out chunks) and never in a local step."""
    from repro_torch.launch import train
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    out = train.main(argv)
    counts = read_counts()
    out["variant_launches"] = read_variants()
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
    want = {"auc_loss": steps, "prox_update": 0, "opt_update": 0,
            "flash_attention": attn_layers * (steps + out["stages"]),
            "grouped_matmul": 3 * moe_layers * out["stages"]}
    want[per_leaf] = steps * leaves_per_step
    chunks = math.ceil(out["n_test"] / train.TEST_CHUNK)
    want_all = dict(want, flash_attention=want["flash_attention"] + attn_layers * chunks,
                    grouped_matmul=want["grouped_matmul"] + 3 * moe_layers * chunks)
    if counts != want_all or out["launches"] != want:
        raise SystemExit(f"{label}: launch counts {counts} (fit's {out['launches']}), "
                         f"expected {want_all} (fit's {want})")
    scores = out["test_scores"]
    if not (scores.dim() == 1 and bool(torch.isfinite(scores).all())):
        raise SystemExit(f"{label}: test scores not a finite vector")
    return out, counts


def require_k4_variant(label: str, run: dict, variant: str, why: str) -> None:
    """Every K4 launch of a main path's run took ``variant`` (so none took
    another, flash_fwd included)."""
    k4 = run["variant_launches"]["flash_attention"]
    if k4[variant] != sum(k4.values()) or not k4[variant]:
        raise SystemExit(f"main path {label}: K4 variants {k4}, expected every launch "
                         f"{variant} ({why})")


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
# stablelm-1.6b: full width with the depth cut to 2 of 24 layers (K=4 replicas,
# their references, gradients and the step's new copy: ~33 GB at 2 layers,
# ~105 GB at 24); and the launcher's smoke config, whose test AUC is held
# against the same command with --device cpu
DENSE_LEAVES, TRAIN_LAYERS = 17, 2
LM_TRAIN_ARGS = ["--arch", "stablelm-1.6b", "--n-layers", str(TRAIN_LAYERS), "--stages", "1",
                 "--t0", "16", "--n-data", "1024"]
LM_SMOKE = ("stablelm_smoke", ["--arch", "stablelm-1.6b", "--smoke", "--stages", "2",
                               "--t0", "30"], "prox_update")
MOE_SMOKE = ("dbrx_smoke", ["--arch", "dbrx-132b", "--smoke", "--stages", "2", "--t0", "30"],
             "prox_update")
MOE_LEAVES = 18
# (label, launcher module, arguments): the commands run again with --device cpu
TWIN_PATHS = ([(label, "train", args) for label, args, _ in MLP_PATHS + [LM_SMOKE, MOE_SMOKE]]
              + [("dbrx_serve_smoke", "serve", ["--arch", "dbrx-132b", "--labeled",
                                                "--metrics", "sketch"])])


class CpuTwins:
    """The smoke paths' commands again with ``--device cpu``, one process
    after another in a background thread at the lowest CPU priority
    (``nice``), so the CPU runs overlap the card's phases; ``stop`` ends the
    running process, whatever state the script is in.  A training twin
    gives its test AUC, a serving twin its output."""

    def __init__(self, paths, threads: int = 6):
        self.paths, self.threads = paths, threads
        self.auc: dict[str, float] = {}
        self.out: dict[str, str] = {}
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
        for label, module, args in self.paths:
            with self._lock:
                if self._stopped:
                    return
                self._proc = subprocess.Popen(
                    ["nice", "-n", "19", sys.executable, "-m", f"repro_torch.launch.{module}",
                     "--device", "cpu", *args], cwd=ROOT, env=env,
                    stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            out, err = self._proc.communicate()
            found = re.search(r"^done: .* test AUC=(\d\.\d+)$", out, re.M)
            if self._proc.returncode != 0 or (module == "train" and not found):
                self.errors.append(f"{label}: exit {self._proc.returncode}\n"
                                   f"{out[-1500:]}{err[-1500:]}")
            else:
                self.out[label] = out
                if found:
                    self.auc[label] = float(found.group(1))

    def wait(self, timeout: float = 900.0):
        t0 = time.perf_counter()
        self._thread.join(timeout)
        if self._thread.is_alive():
            raise SystemExit(f"the CPU runs of the smoke paths took over {timeout:.0f} s")
        if self.errors:
            raise SystemExit("a CPU run of a smoke path failed:\n" + "\n".join(self.errors))
        print(f"cpu runs: waited {time.perf_counter() - t0:.1f} s for the --device cpu "
              "runs of the smoke paths")

    def stop(self):
        with self._lock:
            self._stopped = True
            if self._proc is not None and self._proc.poll() is None:
                self._proc.kill()
                self._proc.wait()


KERNEL_TAGS = {"auc_loss": "auc_loss", "prox_update": "prox_update",
               "opt_update": "opt_update", "flash_attention": "flash_fwd",
               "grouped_matmul": "gmm_"}


def profile_window(label: str, mcfg, state, dev, **ccfg_kw) -> dict:
    """Where one window (I=8 local steps + the average) of a main path spends
    its time: host wall time, device busy time, the hand-written kernels'
    share, and the kernels that take the most device time."""
    from repro_torch.core import coda
    ccfg = coda.CoDAConfig(n_workers=4, p_pos=0.71, **ccfg_kw)
    g = torch.Generator().manual_seed(2)
    y = (torch.rand((8, 4, 32), generator=g) < 0.71).float()
    if mcfg.family == "mlp":
        wb = {"features": torch.randn((8, 4, 32, 64), generator=g)}
    elif mcfg.family == "dense":
        wb = {"tokens": torch.randint(0, mcfg.vocab_size, (8, 4, 32, 64), generator=g)}
    else:
        wb = {"images": torch.randn((8, 4, 32, 32 * 32, 3), generator=g)}
    wb = {k: v.to(dev) for k, v in wb.items()} | {"labels": y.to(dev)}
    coda.window_step(mcfg, ccfg, state, wb, 0.5)          # warm-up
    wall, busy, per = device_profile(lambda: coda.window_step(mcfg, ccfg, state, wb, 0.5))
    ours = {name: sum(v for k, v in per.items() if tag in k)
            for name, tag in KERNEL_TAGS.items()}
    top = sorted(per.items(), key=lambda kv: -kv[1])[:6]
    out = {"path": label, "local_steps": 8, "wall_ms": wall, "device_busy_ms": busy,
           "kernel_sum_ms": sum(per.values()), "idle_share": 1.0 - busy / wall,
           "hand_written_ms": ours,
           "top_kernels_ms": {k[:90]: v for k, v in top}}
    print(f"profile {label} window: wall {wall:.3f} ms, device busy {busy:.3f} ms "
          f"(idle share {1.0 - busy / wall:.3f}; kernel time summed "
          f"{sum(per.values()):.3f} ms), auc_loss {ours['auc_loss']:.4f} ms, "
          f"prox_update {ours['prox_update']:.4f} ms, opt_update "
          f"{ours['opt_update']:.4f} ms, flash_attention {ours['flash_attention']:.4f} ms")
    print(json.dumps({"profile": out}))
    return out


# prefill with the kernels vs impl="ref" on the card, in fp32 through every
# layer: sigmoid scores, O(1) last-position logits, and the bf16 caches (one
# bf16 ulp, 2⁻⁷ relative, on top of the fp32 noise)
PREFILL_TOL = {"scores": 1e-5, "logits": 1e-4, "cache_rtol": 2 ** -7, "cache_atol": 1e-4}


# the variants every fp32 prefill launch must take: K4 at head_dim 64/128,
# K5 at ~512 rows per expert
PREFILL_K4, PREFILL_K5 = "flash_fwd_tf32x3", "gmm_tiles"


@dataclasses.dataclass(frozen=True)
class PrefillPath:
    """A model's ``prefill_step`` at full width on one replica (K = 1): the
    configuration (``n_layers`` cuts its depth; None keeps it), its parameter
    count, the [B, S] token batch, and how both were cut (printed as
    ``reduced:``)."""
    label: str
    arch: str
    n_params: int
    B: int
    S: int
    reduced: str
    n_layers: int | None = None


PREFILL_32K = "prefill_32k [B=32, S=32768] cut to [B={B}, S={S}]"
STABLELM_PREFILL = PrefillPath(
    "stablelm_prefill", "stablelm-1.6b", 1_644_369_921, 4, 2048,
    PREFILL_32K + ", one replica (K=1); full width and depth (24 layers)")
CHATGLM_PREFILL = PrefillPath(
    "chatglm_prefill", "chatglm3-6b", 6_243_588_097, 4, 2048,
    PREFILL_32K + ", one replica (K=1); full width and depth (28 layers: d=4096, 32/2 "
    "heads of 128, d_ff 13696, vocab 65,024, half-rotary 2-d RoPE, qkv bias)")
DBRX_LAYERS = 2
DBRX_PREFILL = PrefillPath(
    "dbrx_prefill", "dbrx-132b", 7_751_337_985, 2, 1024,
    f"{DBRX_LAYERS} of 40 layers (full width: d=6144, 48/8 heads of 128, 16 experts top-4, "
    "d_ff 10752, vocab 100,352), one replica (K=1); " + PREFILL_32K,
    n_layers=DBRX_LAYERS)


def run_prefill(dev, path: PrefillPath):
    """``prefill_step`` of ``path`` with the kernels (every counter set to 0
    just before one prefill and read just after: one K4 launch per layer,
    three K5 launches per moe layer, all of PREFILL_K4 and PREFILL_K5)
    and with ``impl="ref"``, compared under PREFILL_TOL; ms per prefill,
    tokens/s, peak memory, and one profiled prefill with the K4, K5 and
    cuBLAS GEMM shares.  Returns (the record, cfg, params): the serving
    phase reuses dbrx's parameters."""
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.tree import tree_leaves, tree_map
    label, B, S = path.label, path.B, path.S
    cfg = get_config(path.arch)
    if path.n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=path.n_layers)
    print(f"{label}: reduced: {path.reduced.format(B=B, S=S)}")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = M.init_params(cfg, generator=torch.Generator(device=dev).manual_seed(0),
                           device=dev)
    torch.cuda.synchronize()
    n = sum(l.numel() for l in tree_leaves(params))
    print(f"{label}: init_params on the card in {time.perf_counter() - t0:.2f} s: "
          f"{n:,} fp32 parameters ({4 * n / 1e9:.2f} GB) in {len(tree_leaves(params))} leaves")
    if n != path.n_params:
        raise SystemExit(f"{label}: {n:,} parameters, expected {path.n_params:,}")
    params = tree_map(lambda x: x[None], params)               # K = 1 (views)
    g = torch.Generator(device=dev).manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (1, B, S), generator=g, device=dev)}
    prefill = lambda impl="auto": M.prefill_step(cfg, params, batch, impl=impl)
    moe_layers = cfg.n_layers if cfg.family == "moe" else 0
    with torch.no_grad():
        prefill()                                               # warm-up
        torch.cuda.synchronize()
        zero_counts()
        s, logits, (kc, vc) = prefill()
        torch.cuda.synchronize()
        counts, variants = read_counts(), read_variants()
        want = dict.fromkeys(counts, 0) | {"flash_attention": cfg.n_layers,
                                           "grouped_matmul": 3 * moe_layers}
        k4, k5 = variants["flash_attention"], variants["grouped_matmul"]
        if (counts != want or k4[PREFILL_K4] != cfg.n_layers
                or k5[PREFILL_K5] != 3 * moe_layers):
            raise SystemExit(f"{label}: launch counts {counts} ({variants}), expected {want}, "
                             f"every K4 launch {PREFILL_K4}, every K5 launch {PREFILL_K5}")
        times = []
        for _ in range(3):
            t = time.perf_counter()
            prefill()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
        ms = sorted(times)[1]
        rs, rlogits, (rk, rv) = prefill("ref")
        torch.cuda.synchronize()
        ref_ms = []
        for _ in range(2):
            t = time.perf_counter()
            prefill("ref")
            torch.cuda.synchronize()
            ref_ms.append((time.perf_counter() - t) * 1e3)
        peak = torch.cuda.max_memory_allocated()
        errs = {"scores": float((s - rs).abs().max()),
                "logits": float((logits - rlogits).abs().max()),
                "k_cache": float((kc.float() - rk.float()).abs().max()),
                "v_cache": float((vc.float() - rv.float()).abs().max())}
        cache_ok = all(bool(((a.float() - b.float()).abs() <= PREFILL_TOL["cache_atol"]
                             + PREFILL_TOL["cache_rtol"] * b.float().abs()).all())
                       for a, b in ((kc, rk), (vc, rv)))
        finite = all(bool(torch.isfinite(t.float()).all()) for t in (s, logits, kc, vc))
        shapes_ok = (tuple(s.shape) == (1, B)
                     and tuple(logits.shape) == (1, B, cfg.vocab_size)
                     and tuple(kc.shape) == (1, cfg.n_layers, B, S, cfg.n_kv_heads,
                                             cfg.head_dim)
                     and kc.dtype == vc.dtype == torch.bfloat16)
        print(f"{label}: kernels vs impl='ref' on the card: scores max_abs_err "
              f"{errs['scores']:.3g} (atol {PREFILL_TOL['scores']}), last logits "
              f"{errs['logits']:.3g} (atol {PREFILL_TOL['logits']}), bf16 caches k "
              f"{errs['k_cache']:.3g} v {errs['v_cache']:.3g} (rtol 2^-7 + atol "
              f"{PREFILL_TOL['cache_atol']}); shapes {'ok' if shapes_ok else 'WRONG'}, "
              f"finite {finite}")
        if not (finite and shapes_ok and cache_ok and errs["scores"] <= PREFILL_TOL["scores"]
                and errs["logits"] <= PREFILL_TOL["logits"]):
            raise SystemExit(f"{label}: the prefill with kernels disagrees with impl='ref'")
        del rs, rlogits, rk, rv
        wall, busy, per = device_profile(prefill)
    total = sum(per.values())
    share = {name: sum(v for k, v in per.items() if tag in k.lower())
             for name, tag in (("flash_attention", KERNEL_TAGS["flash_attention"]),
                               ("grouped_matmul", KERNEL_TAGS["grouped_matmul"]),
                               ("cublas_gemm", "gemm"))}
    top = sorted(per.items(), key=lambda kv: -kv[1])[:6]
    tokens = B * S
    out = {"path": label, "ms_per_prefill": ms, "ms_runs": times,
           "ref_ms_per_prefill": sorted(ref_ms)[0], "tokens_per_s": tokens / ms * 1e3,
           "peak_bytes": peak, "launches": counts, "variant_launches": variants, "errs": errs,
           "profile": {"wall_ms": wall, "device_busy_ms": busy, "kernel_sum_ms": total,
                       "idle_share": 1.0 - busy / wall,
                       **{f"{k}_ms": v for k, v in share.items()},
                       **{f"{k}_share": v / total for k, v in share.items()},
                       "top_kernels_ms": {k[:90]: v for k, v in top}}}
    print(f"{label}: {ms:.2f} ms per prefill (median of {[round(t, 2) for t in times]}), "
          f"{tokens / ms * 1e3:,.0f} tokens/s, impl='ref' {sorted(ref_ms)[0]:.2f} ms; "
          f"peak memory {peak / 2**30:.2f} GiB; launches {counts}")
    print(f"profile {label}: wall {wall:.2f} ms, device busy {busy:.2f} ms (idle share "
          f"{1.0 - busy / wall:.3f}), kernel time {total:.2f} ms: "
          + ", ".join(f"{k} {v:.2f} ms ({100 * v / total:.1f} %)" for k, v in share.items()))
    print(json.dumps({"profile": out["profile"] | {"path": label}}))
    del batch, s, logits, kc, vc
    return out, cfg, params


# --------------------------------------------------------------------------
# K5 grouped_matmul, the dbrx-132b prefill and serving paths
# --------------------------------------------------------------------------
# (atol, rtol): fp32 sums of up to d_ff = 10,752 products in another order;
# bf16 one bf16 ulp (2^-7 of the value) + fp32 noise near zero, as K4
GMM_TOL = {F32: (5e-5, 5e-5), BF16: (1e-4, 2 ** -7)}


def routed_sizes(seed: int, T: int, E: int, k: int, R: int = 1):
    """Group sizes [R·E] of a seeded top-k routing of T tokens per replica
    over random router logits (numpy), rows sorted by (replica, expert)."""
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((R, T, E))
    top = np.argsort(-logits, axis=-1, kind="stable")[..., :k]
    return np.concatenate([np.bincount(top[r].ravel(), minlength=E) for r in range(R)])


def grouped_mm_fn(x, w, sizes):
    """One ``torch._grouped_mm`` call on the same inputs, where the installed
    torch offers one for them (the library yardstick; the port never calls
    it).  Returns (fn or None, why not)."""
    if not hasattr(torch, "_grouped_mm"):
        return None, f"torch {torch.__version__} has no torch._grouped_mm"
    if w.dim() != 3:
        return None, "torch._grouped_mm takes a [G, K, N] weight, not a strided K-fold view"
    offs = torch.cumsum(sizes, 0).to(torch.int32)
    fn = lambda: torch._grouped_mm(x, w, offs=offs, out_dtype=x.dtype)
    try:
        fn()
        torch.cuda.synchronize()
    except Exception as e:     # the yardstick only: the port's path has no try
        return None, f"torch._grouped_mm refused {x.dtype}: {type(e).__name__}: {str(e)[:160]}"
    return fn, ""


def gmm_bound(x, w, sizes, rates, bf16_rate):
    """The least time for one call on this routing, the larger of: x read,
    the hit groups' weights read and out written (bytes); 2·N·Kd·F
    operations."""
    N, Kd = x.shape
    F = w.shape[-1]
    es = x.element_size()
    hit = int((sizes > 0).sum())
    n_bytes = es * (N * Kd + hit * Kd * F + N * F)
    n_ops = 2 * N * Kd * F
    bnd, by = bound_ms(n_bytes, n_ops, (rates[0], rates[1] if x.dtype == F32 else bf16_rate))
    return bnd, by, n_bytes, n_ops


def check_grouped_matmul(dev, rates, bf16_rate) -> list:
    """K5 against its plain version on the card at dbrx-132b's and
    arctic-480b's full-width expert shapes (decode and prefill), with
    K-folded strided weights, and at the reference's edge tables: within
    GMM_TOL; CUDA-event time, device time, the bound, the plain version's
    time and torch._grouped_mm's."""
    from repro_torch.kernels import moe_dispatch as md
    from repro_torch.kernels import ref
    g = torch.Generator(device=dev).manual_seed(7)
    rows = []

    def case(label, x, w, sizes_np, iters, want_kernel=None):
        sizes = torch.from_numpy(np.asarray(sizes_np, np.int64)).to(dev)
        atol, rtol = GMM_TOL[x.dtype]
        G = ref.n_groups(w)
        kernel = md.launch_geometry(x.shape[0], x.shape[1], G, w.shape[-1], x.dtype,
                                    md.tma_aligned(x, w))["kernel"]
        if want_kernel is not None and kernel != want_kernel:
            raise SystemExit(f"grouped_matmul {label}: routed to {kernel}, not {want_kernel}")
        before = md.variant_launches[kernel]
        got = md.grouped_matmul(x, w, sizes)
        want = ref.grouped_matmul_ref(x, w, sizes)
        torch.cuda.synchronize()
        if md.variant_launches[kernel] != before + 1:
            raise SystemExit(f"grouped_matmul {label}: {kernel} was not launched")
        diff = (got.float() - want.float()).abs()
        err = float(diff.max())
        if not bool((diff <= atol + rtol * want.float().abs()).all()):
            raise SystemExit(f"grouped_matmul {label} disagrees with its plain version: "
                             f"max_abs_err={err} (atol {atol}, rtol {rtol})")
        del got, want, diff
        fn = lambda: md.grouped_matmul(x, w, sizes)
        ms = cuda_ms(fn, iters=iters, warmup=1)
        dev_ms, dev_src = kernel_device_ms(fn, "gmm_", md, calls=max(2, iters // 4),
                                           kernels_per_launch=2)   # offset scan + GEMM
        plain = cuda_ms(lambda: ref.grouped_matmul_ref(x, w, sizes), iters=max(2, iters // 2),
                        warmup=1)
        lib, why = grouped_mm_fn(x, w, sizes)
        lib_ms = cuda_ms(lib, iters=iters, warmup=1) if lib is not None else None
        bnd, by, n_bytes, n_ops = gmm_bound(x, w, sizes, rates, bf16_rate)
        hit = int((sizes > 0).sum())
        dname = str(x.dtype).replace("torch.", "")
        rows.append({"case": label, "N": x.shape[0], "Kd": x.shape[1], "F": w.shape[-1],
                     "groups": G, "hit_groups": hit, "dtype": dname, "kernel": kernel,
                     "max_abs_err": err, "atol": atol, "rtol": rtol, "ms": ms,
                     "device_ms": dev_ms, "device_ms_source": dev_src, "plain_ms": plain,
                     "library_ms": lib_ms,
                     "library_note": why, "bound_ms": bnd, "bound_by": by,
                     "gbytes": n_bytes / 1e9, "gflop": n_ops / 1e9})
        lib_txt = f"{lib_ms:.4f} ms" if lib_ms is not None else f"none ({why})"
        print(f"grouped_matmul {label} [N={x.shape[0]}, Kd={x.shape[1]}, F={w.shape[-1]}, "
              f"G={G}, {hit} hit] {dname} {kernel}: max_abs_err={err:.3g} (atol {atol:g}, "
              f"rtol {rtol:g}); kernel {ms:.4f} ms ({dev_txt(dev_ms, dev_src)}), plain "
              f"{plain:.4f} ms, torch._grouped_mm {lib_txt}, bound {bnd:.4f} ms ({by}: "
              f"{n_bytes / 1e9:.3f} GB, {n_ops / 1e9:.1f} GFLOP)")

    def randn(shape, dt=F32, scale=1.0):
        return torch.randn(shape, generator=g, device=dev).mul_(scale).to(dt)

    # every weight at the model's init scale, Kd^-0.5 (moe.py:58-61), so the
    # outputs are O(1) as in the MoE layer and the tolerances are those of it

    # dbrx-132b: 16 experts, top-4, d 6144, d_ff 10752, fp32 (the model's
    # dtype), then its prefill shape in bf16: ~512 rows per expert, where the
    # tensor cores and not the weight bytes bound gmm_wgmma
    d, ff, E = 6144, 10752, 16
    w_up, w_down = randn((E, d, ff), scale=d ** -0.5), randn((E, ff, d), scale=ff ** -0.5)
    for label, T, iters, kern in (("dbrx_decode", 4, 20, "gmm_rows"),
                                  ("dbrx_prefill", 2048, 3, "gmm_tiles")):
        sizes = routed_sizes(1, T, E, 4)
        case(f"{label}_gate", randn((T * 4, d)), w_up, sizes, iters, kern)
        case(f"{label}_down", randn((T * 4, ff)), w_down, sizes, iters, kern)
    w_up = w_up.to(BF16)
    del w_down
    case("dbrx_prefill_gate_bf16", randn((8192, d), BF16), w_up, routed_sizes(1, 2048, E, 4),
         5, "gmm_wgmma")
    del w_up
    torch.cuda.empty_cache()
    # arctic-480b: 128 experts, top-2, d 7168, d_ff 4864, bf16 (8.9 GB of weights)
    d, ff, E = 7168, 4864, 128
    w = randn((E, d, ff), BF16, d ** -0.5)
    for label, T, iters in (("arctic_decode_bf16", 4, 20), ("arctic_prefill_bf16", 2048, 5)):
        case(label, randn((T * 2, d), BF16), w, routed_sizes(2, T, E, 2), iters, "gmm_wgmma")
    del w
    torch.cuda.empty_cache()
    # K-folded groups: 4 replicas × 16 experts, a strided layer slice of a
    # [4, 2, 16, d, ff] stack at dbrx's smoke width, in both dtypes
    sizes = routed_sizes(3, 64, 16, 4, R=4)
    for dt, kern in ((F32, "gmm_tiles"), (BF16, "gmm_wgmma")):
        stack = randn((4, 2, 16, 128, 256), dt, 128 ** -0.5)
        case(f"kfold_4x16_strided_{str(dt)[6:]}", randn((int(sizes.sum()), 128), dt),
             stack[:, 1], sizes, 20, kern)
    # edges: the reference's group tables with Kd and F off the tiles, N = 1,
    # the 128-row kernel on ragged segments in both dtypes; gmm_wgmma on
    # aligned ragged groups with empty ones (Kd 136, F 520) and at N = 1
    for i, gs in enumerate(([3, 0, 6, 1], [0, 0, 10, 0], [10, 0, 0, 0], [1, 2, 3, 4])):
        case(f"table{i}_{'_'.join(map(str, gs))}", randn((sum(gs), 130)),
             randn((4, 130, 515), scale=130 ** -0.5), gs, 10, "gmm_rows")
    case("n1", randn((1, 6144)), randn((4, 6144, 1000), scale=6144 ** -0.5), [0, 1, 0, 0], 10,
         "gmm_rows")
    case("n1_bf16", randn((1, 6144), BF16), randn((4, 6144, 1000), BF16, 6144 ** -0.5),
         [0, 1, 0, 0], 10, "gmm_wgmma")
    for dt in (F32, BF16):
        case(f"tiles_ragged_{str(dt)[6:]}", randn((273, 96), dt),
             randn((4, 96, 300), dt, 96 ** -0.5), [70, 0, 200, 3], 10, "gmm_tiles")
    gs = [70, 0, 200, 3, 0]
    case("aligned_ragged_bf16", randn((sum(gs), 136), BF16), randn((5, 136, 520), BF16,
                                                                    136 ** -0.5), gs, 10,
         "gmm_wgmma")
    return rows


SERVE_KW = dict(slots=4, max_len=64, prefill_chunk=8)
SERVE_TRACE = dict(kind="batch", n_requests=8, prompt_len=(8, 33), max_new=(8, 9), seed=0)
SERVE_SCORE_ATOL = 1e-4          # score-head logits after 2 fp32 layers
SERVE_GAP_TOL = 1e-4             # top-2 logit gap below which a token may flip


def read_variants() -> dict:
    """Launches of each kernel variant since the counters were last set to
    0: {kernel: {variant: launches}} for the kernels that have variants."""
    from repro_torch.launch import train
    return {k: dict(mod.variant_launches) for k, mod in train.KERNELS.items()
            if hasattr(mod, "variant_launches")}


def _top2_gap(cfg, params, prompt, generated, j) -> float:
    """The impl='ref' top-2 logit gap at generated step j of one request,
    served alone (rows are independent through the model)."""
    from repro_torch.serving import decode as D
    seq = list(prompt) + list(generated[:j])
    dev = params["lm_head"].device
    toks = torch.tensor([seq], dtype=torch.int64, device=dev)
    cache = D.init_cache(cfg, 1, len(seq), dtype=torch.float32, device=dev)
    with torch.no_grad():
        _, logits = D.prefill(cfg, params, cache, toks, impl="ref")
    top = torch.topk(logits[0], 2).values
    return float(top[0] - top[1])


def _serve(cfg, params, impl, tick_log=None):
    """One engine over SERVE_TRACE; ``tick_log`` receives (serve steps, host
    ms) per tick — each tick ends in the engine's read of its tokens."""
    from repro_torch.serving import ServingEngine
    from repro_torch.serving import loadgen as LG
    eng = ServingEngine(cfg, params, impl=impl, **SERVE_KW)
    on_step = None
    if tick_log is not None:
        last = [time.perf_counter(), 0]

        def on_step(e):
            now = time.perf_counter()
            tick_log.append((e.steps - last[1], (now - last[0]) * 1e3))
            last[:] = [now, e.steps]
    trace = LG.make_trace(LG.TraceConfig(**SERVE_TRACE), cfg.vocab_size)
    reqs, wall = LG.run_trace(eng, trace, on_step=on_step)
    return eng, reqs, wall


def run_dbrx_serve(rates, cfg, params) -> dict:
    """The dbrx-132b parameters (2 full-width layers) through the
    continuous-batching engine: a batch trace of 8 requests with
    impl='auto', then a second engine with impl='ref'; tokens equal (a flip
    allowed only at a near tie of the ref run, printed), scores within
    SERVE_SCORE_ATOL, exactly 3 × 2 K5 launches per serve step; ms per
    prefill and per decode tick, tokens/s, TTFT and latency; one profiled
    decode tick."""
    from repro_torch.kernels import moe_dispatch as md
    from repro_torch.serving import Request, ServingEngine
    from repro_torch.serving import loadgen as LG
    print(f"dbrx_serve: the dbrx_prefill parameters; engine {SERVE_KW}; trace {SERVE_TRACE}")
    with torch.no_grad():
        warm = ServingEngine(cfg, params, **SERVE_KW)          # allocator warm-up
        warm.add_request(Request(uid=-1, prompt=list(range(1, 12)), max_new_tokens=2))
        warm.run()
        torch.cuda.synchronize()
        zero_counts()
        ticks = []
        eng, reqs, wall = _serve(cfg, params, "auto", ticks)
        counts, variants = read_counts(), read_variants()
        want = dict.fromkeys(counts, 0) | {"grouped_matmul": 3 * DBRX_LAYERS * eng.steps}
        if counts != want:
            raise SystemExit(f"dbrx_serve: launch counts {counts}, expected {want} (3 × "
                             f"{DBRX_LAYERS} layers × {eng.steps} serve steps)")
        summary = LG.summarize(reqs, wall, eng)
        _, rreqs, _ = _serve(cfg, params, "ref")
    flips = []
    for r, rr in zip(reqs, rreqs, strict=True):
        if r.status != "done" or rr.status != "done":
            raise SystemExit(f"dbrx_serve: request {r.uid} ended {r.status}/{rr.status}")
        if r.generated != rr.generated:
            j = next(i for i, (a, b) in enumerate(zip(r.generated, rr.generated)) if a != b)
            gap = _top2_gap(cfg, params, r.prompt_used, rr.generated, j)
            flips.append({"uid": r.uid, "step": j, "gap": gap})
            print(f"dbrx_serve: request {r.uid} differs from impl='ref' first at generated "
                  f"step {j} ({r.generated[j]} vs {rr.generated[j]}); the ref run's top-2 "
                  f"logit gap there is {gap:.3g} (limit {SERVE_GAP_TOL})")
            if not gap < SERVE_GAP_TOL:
                raise SystemExit("dbrx_serve: tokens differ from impl='ref' away from a tie")
    score_err = max(abs(r.score - rr.score) for r, rr in zip(reqs, rreqs))
    if not score_err <= SERVE_SCORE_ATOL:
        raise SystemExit(f"dbrx_serve: scores differ from impl='ref' by {score_err}")
    pre = [ms for c, ms in ticks if c == SERVE_KW["prefill_chunk"]]
    dec = [ms for c, ms in ticks if c == 1]
    print(f"dbrx_serve: {len(reqs)} requests, {eng.ticks} ticks ({len(pre)} prefill, "
          f"{len(dec)} decode), {eng.steps} serve steps; tokens equal to impl='ref' in "
          f"{len(reqs) - len(flips)} of {len(reqs)} requests, scores max_abs_err "
          f"{score_err:.3g} (atol {SERVE_SCORE_ATOL}); launches {counts}")
    print(f"dbrx_serve: {statistics.median(pre):.2f} ms per prefill tick (median), "
          f"{statistics.median(dec):.2f} ms per decode tick (median), "
          f"{summary['tokens_per_s']:.1f} tokens/s, TTFT p50/p99 {summary['ttft_p50_ms']:.1f}/"
          f"{summary['ttft_p99_ms']:.1f} ms, latency p50/p99 {summary['latency_p50_ms']:.1f}/"
          f"{summary['latency_p99_ms']:.1f} ms")
    # one decode tick under the profiler: 4 requests past their one-tick
    # prefill; K5's calls are recorded to bound them by the experts they hit
    seen = []
    real = md.grouped_matmul

    def recording(x, w, sizes):
        seen.append((tuple(x.shape), w.shape[-1], x.element_size(), sizes.clone()))
        return real(x, w, sizes)

    with torch.no_grad():
        peng = ServingEngine(cfg, params, **SERVE_KW)
        for i in range(4):
            peng.add_request(Request(uid=i, prompt=[7 + i] * 8, max_new_tokens=4))
        peng.step()
        torch.cuda.synchronize()
        md.grouped_matmul = recording
        try:
            wall_t, busy_t, per = device_profile(peng.step)
        finally:
            md.grouped_matmul = real
    k5 = sum(v for k, v in per.items() if "gmm_" in k)
    bound = 0.0
    for (N, Kd), F, es, sizes in seen:
        hit = int((sizes > 0).sum())
        bound += bound_ms(es * (N * Kd + hit * Kd * F + N * F), 2 * N * Kd * F, rates)[0]
    total = sum(per.values())
    prof = {"wall_ms": wall_t, "device_busy_ms": busy_t, "idle_share": 1.0 - busy_t / wall_t,
            "kernel_sum_ms": total, "grouped_matmul_ms": k5,
            "grouped_matmul_calls": len(seen), "grouped_matmul_bound_ms": bound,
            "grouped_matmul_share": k5 / total,
            "top_kernels_ms": {k[:90]: v for k, v in
                               sorted(per.items(), key=lambda kv: -kv[1])[:6]}}
    print(f"profile dbrx_serve decode tick: wall {wall_t:.2f} ms, device busy {busy_t:.2f} "
          f"ms (idle share {1.0 - busy_t / wall_t:.3f}); grouped_matmul {k5:.3f} ms over "
          f"{len(seen)} calls against a bound of {bound:.3f} ms (bytes of the hit experts), "
          f"{100 * k5 / total:.1f} % of kernel time")
    print(json.dumps({"profile": prof | {"path": "dbrx_serve_decode_tick"}}))
    return {"path": "dbrx_serve", "launches": counts, "variant_launches": variants,
            "steps": eng.steps, "ticks": eng.ticks,
            "ms_per_prefill_tick": statistics.median(pre),
            "ms_per_decode_tick": statistics.median(dec), "flips": flips,
            "score_max_abs_err": score_err, "profile": prof,
            **{k: summary[k] for k in ("tokens_per_s", "ttft_p50_ms", "ttft_p99_ms",
                                       "latency_p50_ms", "latency_p99_ms",
                                       "generated_tokens", "wall_s")}}


SERVE_SMOKE = ("dbrx_serve_smoke", ["--arch", "dbrx-132b", "--labeled", "--metrics",
                                    "sketch"])


def run_serve_smoke() -> tuple[dict, dict, str]:
    """``launch/serve.py --arch dbrx-132b --labeled --metrics sketch`` on the
    card, every counter set to 0 just before: exactly 3 × 2 K5 launches per
    serve step and no other kernel."""
    from repro_torch.launch import serve
    label, args = SERVE_SMOKE
    zero_counts()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = serve.main(args)
    text = buf.getvalue()
    print(text, end="")
    counts = read_counts()
    out["variant_launches"] = read_variants()
    steps = out["engine"].steps
    want = dict.fromkeys(counts, 0) | {"grouped_matmul": 3 * 2 * steps}
    print(f"main path {label}: {out['completed']} requests, {steps} serve steps, "
          f"launches {counts}")
    if counts != want:
        raise SystemExit(f"{label}: launch counts {counts}, expected {want}")
    return out, counts, text


def serve_lines(text: str):
    """The ``req …`` lines and the final streaming AUC of serve.py's output."""
    reqs = re.findall(r"^req \d+: .*$", text, re.M)
    auc = re.search(r"^\[serve\] final .*streaming auc=(\d\.\d+)", text, re.M)
    return reqs, float(auc.group(1)) if auc else None


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
    name = torch.cuda.get_device_name(0)
    rates, bf16_rate = card_rates(name), bf16_peak(name)
    dev = torch.device("cuda:0")
    disable_tf32()

    t0 = time.perf_counter()
    lib = _build.build(verbose=True)        # one nvcc per source, then the link
    print(f"build: {os.path.relpath(lib, ROOT)} in "
          f"{time.perf_counter() - t0:.2f} s")

    twins = CpuTwins(TWIN_PATHS).start()
    try:
        return run_phases(dev, rates, bf16_rate, twins)
    finally:
        twins.stop()


def run_phases(dev, rates, bf16_rate, twins) -> int:
    from repro_torch.configs import get_config, mlp_config
    gen = torch.Generator().manual_seed(0)
    auc_rows = check_auc_loss(dev, rates, gen)
    prox_rows = check_prox_update(dev, rates, gen)
    opt_rows = check_opt_update(dev, rates, gen)
    attn_rows, attn_bwd = check_flash_attention(dev, rates, bf16_rate, gen)
    gmm_rows = check_grouped_matmul(dev, rates, bf16_rate)
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
    profile_window("mlp", mlp_config(), runs["mlp"]["state"], dev)
    for label, args, per_leaf in RN_PATHS:
        runs[label], counts[label] = run_main_path(f"main path {label}", RN_ARGS + args,
                                                   RN_LEAVES, per_leaf)
    profile_window("resnet50", get_config("resnet50"), runs["resnet50"]["state"], dev)
    prof = profile_window("resnet50_momentum", get_config("resnet50"),
                          runs["resnet50_momentum"]["state"], dev, optimizer="momentum",
                          opt_dtype=torch.bfloat16)
    n_step = 4 * sum(resnet_leaf_sizes())
    k3_bound, _ = bound_ms(20 * n_step, OPT_OPS_PER_ELEMENT["momentum"] * n_step, rates)
    print(f"profile resnet50_momentum: opt_update {prof['hand_written_ms']['opt_update'] / 8:.4f} "
          f"ms of device time per local step ({RN_LEAVES} launches) against a bound of "
          f"{k3_bound:.4f} ms (20 B per element, bf16 buffer)")

    for label, _, _ in RN_PATHS:
        runs[label].pop("state")                 # free the card for stablelm

    # full-depth fp32 prefills: stablelm-1.6b (head_dim 64) and chatglm3-6b
    # (head_dim 128), every K4 launch flash_fwd_tf32x3
    prefills = {}
    for path in (STABLELM_PREFILL, CHATGLM_PREFILL):
        prefills[path.label], _, params = run_prefill(dev, path)
        counts[path.label] = prefills[path.label]["launches"]
        del params
        torch.cuda.empty_cache()
    # stablelm-1.6b CoDA training at full width, 2 layers; the smoke config
    # (its CPU twin runs in the background)
    print(f"main path stablelm_train: reduced: {TRAIN_LAYERS} of 24 layers (full width "
          "d=2048, 32 heads, d_ff 5632, vocab 100,352), K=4, B=32, S=64, one stage of 16 "
          "local steps")
    label = "stablelm_train"
    runs[label], counts[label] = run_main_path(f"main path {label}", LM_TRAIN_ARGS,
                                               DENSE_LEAVES, attn_layers=TRAIN_LAYERS)
    require_k4_variant(label, runs[label], "flash_fwd_tf32x3", "fp32, head_dim 64")
    lm_cfg = dataclasses.replace(get_config("stablelm-1.6b"), n_layers=TRAIN_LAYERS)
    profile_window(label, lm_cfg, runs[label].pop("state"), dev)
    torch.cuda.empty_cache()
    label, args, per_leaf = LM_SMOKE
    runs[label], counts[label] = run_main_path(f"main path {label}", args, DENSE_LEAVES,
                                               per_leaf, attn_layers=2)
    torch.cuda.empty_cache()

    # dbrx-132b: prefill and the serving engine at full width, 2 layers;
    # then the launchers' smoke configs (their CPU twins run in the background)
    dbrx_prefill, dbrx_cfg, dbrx_params = run_prefill(dev, DBRX_PREFILL)
    prefills[DBRX_PREFILL.label] = dbrx_prefill
    counts["dbrx_prefill"] = dbrx_prefill["launches"]
    dbrx_serve = run_dbrx_serve(rates, dbrx_cfg, dbrx_params)
    counts["dbrx_serve"] = dbrx_serve["launches"]
    del dbrx_params
    torch.cuda.empty_cache()
    label, args, per_leaf = MOE_SMOKE
    runs[label], counts[label] = run_main_path(f"main path {label}", args, MOE_LEAVES,
                                               per_leaf, attn_layers=2, moe_layers=2)
    require_k4_variant(label, runs[label], "flash_fwd_tf32x3", "fp32, head_dim 128")
    serve_out, counts["dbrx_serve_smoke"], serve_text = run_serve_smoke()

    # the same commands on the CPU: test AUC within 0.01; the served tokens
    # equal and the served AUC within 0.01
    twins.wait()
    card_reqs, card_auc = serve_lines(serve_text)
    cpu_reqs, cpu_auc = serve_lines(twins.out["dbrx_serve_smoke"])
    print(f"main path dbrx_serve_smoke: {len(card_reqs)} printed requests, equal to "
          f"--device cpu: {card_reqs == cpu_reqs}; served AUC {card_auc} on the card, "
          f"{cpu_auc} with --device cpu (limit 0.01)")
    if not (card_reqs and card_reqs == cpu_reqs and card_auc is not None
            and cpu_auc is not None and abs(card_auc - cpu_auc) <= 0.01):
        raise SystemExit("main path dbrx_serve_smoke: the card and the CPU served "
                         f"differently:\n{card_reqs}\n{cpu_reqs}")
    for label, module, _ in TWIN_PATHS:
        if module != "train":
            continue
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
                "device_ms_source": h["device_ms_source"],
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
    # launches of each K4/K5 variant on each path (counters set to 0 just
    # before each path, read just after), and each variant's headline case
    variants = {label: r["variant_launches"] for label, r in runs.items()}
    variants.update({label: r["variant_launches"] for label, r in prefills.items()},
                    dbrx_serve=dbrx_serve["variant_launches"],
                    dbrx_serve_smoke=serve_out["variant_launches"])

    def variant_rows(name, rows, heads):
        """Each variant's launches by path, its cases and largest error, and
        its headline cases' numbers (the first is ``head``)."""
        keys = ("ms", "device_ms", "device_ms_source", "plain_ms", "bound_ms", "bound_by",
                "library_ms", "bound_ffma_ms", "shape")
        out = {}
        for variant, cases in heads.items():
            by_path = {label: v[name][variant] for label, v in variants.items()}
            at = {c: {k: r[k] for k in keys if k in r}
                  for r in rows for c in cases if r["case"] == c}
            out[variant] = {
                "launches": sum(by_path.values()), "launches_by_path": by_path,
                "cases": [r["case"] for r in rows if r["kernel"] == variant],
                "max_abs_err": max(r["max_abs_err"] for r in rows if r["kernel"] == variant),
                "head": cases[0], **at[cases[0]], "heads": at}
        return out

    # flash_attention: headline at stablelm-1.6b's prefill shape in fp32, the
    # shape where the prefill path spends its attention time (flash_fwd_tf32x3,
    # so its bound is 3xTF32's)
    h = next(r for r in attn_rows if r["case"] == "stablelm_prefill")
    by_path = {label: c["flash_attention"] for label, c in counts.items()}
    f32_err = max(r["max_abs_err"] for r in attn_rows if r["dtype"] == "float32")
    kernels.append({
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "wrapper": "src/repro_torch/kernels/flash_attention.py",
        "replaces": "src/repro/kernels/flash_attention.py:94",
        "launches": sum(by_path.values()), "launches_by_path": by_path,
        "max_abs_err": f32_err,
        "max_abs_err_bf16": max(r["max_abs_err"] for r in attn_rows
                                if r["dtype"] == "bfloat16"),
        "tol": (f"(atol, rtol) fp32 {ATTN_TOL[F32]}, bf16 {ATTN_TOL[BF16]}; "
                f"lse atol {LSE_ATOL}"),
        "shape": h["shape"], "ms": h["ms"], "device_ms": h["device_ms"],
                "device_ms_source": h["device_ms_source"],
        "plain_ms": h["plain_ms"], "bound_ms": h["bound_ms"], "bound_by": h["bound_by"],
        "library_ms": h["library_ms"], "library": "torch.nn.functional."
        "scaled_dot_product_attention", "max_err": f32_err,
        "kernel_us": h["ms"] * 1e3, "plain_us": h["plain_ms"] * 1e3,
        "bound_us": h["bound_ms"] * 1e3, "shapes": attn_rows, "backward": attn_bwd,
        "variants": variant_rows("flash_attention", attn_rows,
                                 {"flash_fwd": ["smoke_hd32"],
                                  "flash_fwd_wgmma": ["stablelm_prefill_bf16"],
                                  "flash_fwd_tf32x3": ["stablelm_prefill", "chatglm_prefill",
                                                       "qwen_gqa", "dbrx_prefill"]}),
        "prefills": {label: {k: prefills[label][k] for k in (
            "ms_per_prefill", "ref_ms_per_prefill", "tokens_per_s", "peak_bytes", "errs")}
            for label in (STABLELM_PREFILL.label, CHATGLM_PREFILL.label)}})
    # grouped_matmul: headline at dbrx-132b's decode gate/up shape in fp32,
    # the call every moe layer of every served token makes twice
    h = next(r for r in gmm_rows if r["case"] == "dbrx_decode_gate")
    by_path = {label: c["grouped_matmul"] for label, c in counts.items()}
    kernels.append({
        "name": "grouped_matmul", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/moe_dispatch.cu",
        "wrapper": "src/repro_torch/kernels/moe_dispatch.py",
        "replaces": "src/repro/kernels/moe_dispatch.py:71",
        "launches": sum(by_path.values()), "launches_by_path": by_path,
        "max_abs_err": max(r["max_abs_err"] for r in gmm_rows if r["dtype"] == "float32"),
        "max_abs_err_bf16": max(r["max_abs_err"] for r in gmm_rows
                                if r["dtype"] == "bfloat16"),
        "tol": f"(atol, rtol) fp32 {GMM_TOL[F32]}, bf16 {GMM_TOL[BF16]}",
        "shape": [h["N"], h["Kd"], h["F"], h["groups"]], "ms": h["ms"],
        "device_ms": h["device_ms"], "device_ms_source": h["device_ms_source"], "plain_ms": h["plain_ms"], "bound_ms": h["bound_ms"],
        "bound_by": h["bound_by"], "library_ms": h["library_ms"],
        "library": "torch._grouped_mm", "library_note": h["library_note"],
        "max_err": h["max_abs_err"], "kernel_us": h["ms"] * 1e3,
        "plain_us": h["plain_ms"] * 1e3, "bound_us": h["bound_ms"] * 1e3, "shapes": gmm_rows,
        "variants": variant_rows("grouped_matmul", gmm_rows,
                                 {"gmm_rows": ["dbrx_decode_gate"],
                                  "gmm_tiles": ["dbrx_prefill_gate"],
                                  "gmm_wgmma": ["arctic_prefill_bf16"]}),
        "prefill": {k: dbrx_prefill[k] for k in ("ms_per_prefill", "ref_ms_per_prefill",
                                                 "tokens_per_s", "peak_bytes", "errs")},
        "serve": {k: v for k, v in dbrx_serve.items() if k != "profile"}})
    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
