"""Compare variants of K5's fp32 ``gmm_tiles`` kernel on the card.

    python3 scripts/gmm_tiles_variants.py [--out build/gmm_tiles_variants/results.json]

Each variant is a patched copy of ``src/repro_torch/kernels/csrc`` (a list
of source substitutions below), built with nvcc into its own library under
``build/gmm_tiles_variants/<name>/`` and loaded in place of the package's
(``_build.load``), so ``csrc/`` itself is never touched.  For each variant
it prints ptxas's register and spill report for ``gmm_tiles<float>``,
checks two ragged cases against the plain version (atol = rtol 5e-5), and
times, with CUDA events, the dbrx-132b prefill expert shapes (N = 8192 rows
of a seeded top-4 routing over 16 experts, 6144→10752 and 10752→6144, two
rounds) and one dense group (the same GEMM without group tails) beside
``torch.matmul`` (cuBLAS, fp32, TF32 off).  Since gmm_tf32x3 takes every
fp32 prefill call that TMA can read, x is copied to a base 4 bytes past a
16-byte boundary, so these calls still route to gmm_tiles.  Needs a CUDA
card and nvcc.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.kernels import _build  # noqa: E402

# the shipped kernel, and what each alternative changes in moe_dispatch.cu
VARIANTS = {
    "shipped": [],
    "no_tail_skip": [("    if (hi_live) tile_fma<8>(acc, as, bs, ty, tx);\n"
                      "    else if (lo_live) tile_fma<4>(acc, as, bs, ty, tx);",
                      "    tile_fma<8>(acc, as, bs, ty, tx);")],
    "four_stages": [("constexpr int kTileStages = 3;", "constexpr int kTileStages = 4;")],
    "one_block_per_sm": [("__launch_bounds__(kTileThreads, 2)",
                          "__launch_bounds__(kTileThreads, 1)")],
}


def build(name: str, subs) -> ctypes.CDLL:
    d = os.path.join(ROOT, "build", "gmm_tiles_variants", name)
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(_build.CSRC, d)
    path = os.path.join(d, "moe_dispatch.cu")
    src = open(path).read()
    for old, new in subs:
        if old not in src:
            raise SystemExit(f"{name}: the source no longer holds {old!r}")
        src = src.replace(old, new)
    open(path, "w").write(src)
    out = os.path.join(d, "lib.so")
    i = _build.NVCC_FLAGS.index("-I")
    flags = _build.NVCC_FLAGS[:i] + _build.NVCC_FLAGS[i + 2:]
    cmd = [_build.nvcc(), *flags, "-shared", "-I", d, "-Xptxas", "-v", "-o", out, path,
           os.path.join(d, "coda_kernels.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode:
        raise SystemExit(f"{name}: nvcc failed\n{proc.stderr[-3000:]}")
    lines = (proc.stdout + proc.stderr).splitlines()
    for j, line in enumerate(lines):
        if "gmm_tilesIf" in line and "Function properties" in line:
            print(f"{name}: {lines[j + 1].strip()}; {lines[j + 2].strip()}")
    lib = ctypes.CDLL(out)
    for fn in ("grouped_matmul", "coda_error_string"):
        restype, argtypes = _build._SIGNATURES[fn]
        getattr(lib, fn).restype, getattr(lib, fn).argtypes = restype, argtypes
    return lib


def event_ms(fn, iters: int) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "gmm_tiles_variants",
                                                  "results.json"))
    args = ap.parse_args()
    import numpy as np
    import torch
    from repro_torch.kernels import moe_dispatch as md
    from repro_torch.kernels import ref
    if not torch.cuda.is_available():
        print("gmm_tiles_variants: needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    libs = {name: build(name, subs) for name, subs in VARIANTS.items()}
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(7)
    randn = lambda shape, scale=1.0: torch.randn(shape, generator=g, device=dev).mul_(scale)
    top = np.argsort(-np.random.default_rng(1).standard_normal((2048, 16)), axis=-1,
                     kind="stable")[:, :4]
    sizes = torch.as_tensor(np.bincount(top.ravel(), minlength=16)).to(dev)
    def unaligned(x):       # a base TMA cannot read: the gmm_tiles route
        buf = torch.empty(x.numel() + 1, device=dev)
        return buf[1:].view(x.shape).copy_(x)

    d, ff = 6144, 10752
    shapes = {"gate": (unaligned(randn((8192, d))), randn((16, d, ff), d ** -0.5)),
              "down": (unaligned(randn((8192, ff))), randn((16, ff, d), ff ** -0.5))}
    ragged = [(unaligned(randn((273, 96))), randn((4, 96, 300), 96 ** -0.5), [70, 0, 200, 3]),
              (randn((400, 130)), randn((4, 130, 515), 130 ** -0.5), [100, 0, 300, 0])]
    for x, w in shapes.values():
        assert md.launch_geometry(8192, x.shape[1], 16, w.shape[-1], torch.float32,
                                  md.tma_aligned(x, w))["kernel"] == "gmm_tiles"
    res: dict[str, list | float] = {}
    for _ in range(2):
        for name, lib in libs.items():
            _build.load = lambda lib=lib: lib
            for x, w, gs in ragged:
                s = torch.tensor(gs, device=dev)
                if not torch.allclose(md.grouped_matmul(x, w, s), ref.grouped_matmul_ref(x, w, s),
                                      atol=5e-5, rtol=5e-5):
                    raise SystemExit(f"{name}: disagrees with the plain version")
            for label, (x, w) in shapes.items():
                ms = event_ms(lambda: md.grouped_matmul(x, w, sizes), 4)
                res.setdefault(f"{name}/{label}", []).append(ms)
    one = torch.tensor([8192], device=dev)
    x, w = shapes["gate"]
    for name, lib in libs.items():
        _build.load = lambda lib=lib: lib
        res[f"{name}/dense"] = event_ms(lambda: md.grouped_matmul(x, w[:1], one), 3)
    res["torch.matmul/dense"] = event_ms(lambda: torch.matmul(x, w[0]), 3)
    for key, val in res.items():
        print(f"{key}: {val} ms")
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    json.dump(res, open(args.out, "w"), indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
