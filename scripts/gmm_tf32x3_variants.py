"""Compare variants of K5's fp32 ``gmm_tf32x3`` kernel on the card, beside
``gmm_tiles`` and ``torch._grouped_mm`` on the same values.

    python3 scripts/gmm_tf32x3_variants.py [--variants shipped,stages3] [--rounds 2]
        [--out build/gmm_tf32x3_variants/results.json]

Each variant is a patched copy of ``src/repro_torch/kernels/csrc`` (a list
of source substitutions below), built with nvcc into its own library under
``build/gmm_tf32x3_variants/<name>/`` and loaded in place of the package's
(``_build.load``), so ``csrc/`` itself is never touched.  For each variant
it prints ptxas's register and spill report for ``gmm_tf32x3``, checks
ragged cases (empty groups, short tails, Kd and F off the tiles, a deep Kd)
against the plain version (atol = rtol 5e-5), and at the dbrx-132b prefill
expert shapes (N = 8192 rows of a seeded top-4 routing over 16 experts,
6144→10752 and 10752→6144, weights at the init scale Kd^-0.5) holds it to
the plain version and reports its error against a float64 product, then
times it with CUDA events in turns with ``gmm_tiles`` (x copied to a base
off 16 bytes, which TMA cannot read) and ``torch._grouped_mm``: tiles,
variants, variants reversed, tiles, ``rounds`` times.  Needs a CUDA card
and nvcc.
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

# the shipped kernel, and what each alternative changes in moe_dispatch.cu.
# The diag_ variants compute wrong sums on purpose: each takes one piece of
# work away (the small products, the x split, w's tile loads — half the
# bytes a stage moves — or the w split) to show what that piece costs; they
# are timed, not checked.
_W = "    hopper::wgmma_tf32_rs_n128(part, "
_SMALL = (_W + "as[kk], hopper::desc_sw128(xb + 32 * kk, 0, 1024), kk > 0);\n",
          _W + "ab[kk], hopper::desc_sw128(xs + 32 * kk, 0, 1024), 1);\n",
          _W + "ab[kk], hopper::desc_sw128(xb + 32 * kk, 0, 1024), 1);\n")
# the shipped source blocks the candidate designs replace, and theirs
_SRC = open(os.path.join(_build.CSRC, "moe_dispatch.cu")).read()


def _block(start: str, end: str) -> str:
    """The shipped source from ``start`` up to (not including) ``end``."""
    a = _SRC.index(start)
    return _SRC[a:_SRC.index(end, a)]


_SPLIT_LOOP = _block("      for (int it = sid;", "      hopper::fence_proxy_async();")
_CONSUME_LOOP = _block("  uint32_t ab[4][4], as[4][4];", "  // acc[4j + e]")
_SPLIT2_LOOP = """\
      auto put = [&](const float4& lo, const float4& hi, int o0, int o1) {
        uint4 b, sm;
        split_tf32(lo.x, b.x, sm.x);
        split_tf32(lo.z, b.y, sm.y);
        split_tf32(hi.x, b.z, sm.z);
        split_tf32(hi.z, b.w, sm.w);
        *reinterpret_cast<uint4*>(xb + o0) = b;
        *reinterpret_cast<uint4*>(xs + o0) = sm;
        split_tf32(lo.y, b.x, sm.x);
        split_tf32(lo.w, b.y, sm.y);
        split_tf32(hi.y, b.z, sm.z);
        split_tf32(hi.w, b.w, sm.w);
        *reinterpret_cast<uint4*>(xb + o1) = b;
        *reinterpret_cast<uint4*>(xs + o1) = sm;
      };
      constexpr int kItems = kTfBM * (kTfBK / 8);
      for (int it = sid; it < kItems; it += 2 * kTfSplitters) {
        const int it2 = it + kTfSplitters;
        const bool two = it2 < kItems;
        const int n = it % kTfBM, kk = it / kTfBM, n2 = it2 % kTfBM, kk2 = it2 / kTfBM;
        const int o0 = n * 128 + (((2 * kk) ^ (n & 7)) << 4);
        const int o1 = n * 128 + (((2 * kk + 1) ^ (n & 7)) << 4);
        const int p0 = n2 * 128 + (((2 * kk2) ^ (n2 & 7)) << 4);
        const int p1 = n2 * 128 + (((2 * kk2 + 1) ^ (n2 & 7)) << 4);
        const float4 lo = *reinterpret_cast<const float4*>(xb + o0);
        const float4 hi = *reinterpret_cast<const float4*>(xb + o1);
        float4 lo2 = lo, hi2 = hi;
        if (two) {
          lo2 = *reinterpret_cast<const float4*>(xb + p0);
          hi2 = *reinterpret_cast<const float4*>(xb + p1);
        }
        put(lo, hi, o0, o1);
        if (two) put(lo2, hi2, p0, p1);
      }
"""
_PREFETCH_LOOP = """\
  uint32_t ab[2][4][4], as[2][4][4];
  hopper::mbar_wait(&full[0], 0);
  tf_load_w(smem + 2 * kTfTile, fl, t4, ab[0], as[0]);
  auto step = [&](int i, uint32_t (&cb)[4][4], uint32_t (&cs)[4][4], uint32_t (&nb)[4][4],
                  uint32_t (&ns)[4][4]) {
    const int s = i % kTfStages;
    const uint8_t* st = smem + s * kTfStageBytes;
    hopper::mbar_wait(&ready[s], (i / kTfStages) & 1);
    tf_issue(part, cb, cs, st, st + kTfTile);
    if (i + 1 < nk) {
      const int s1 = (i + 1) % kTfStages;
      hopper::mbar_wait(&full[s1], ((i + 1) / kTfStages) & 1);
      tf_load_w(smem + s1 * kTfStageBytes + 2 * kTfTile, fl, t4, nb, ns);
    }
    hopper::wgmma_wait<0>();
    hopper::fence_regs(part);
    hopper::fence_regs(cb);
    hopper::fence_regs(cs);
    hopper::mbar_arrive(&empty[s]);
#pragma unroll
    for (int j = 0; j < 64; ++j) acc[j] += part[j];
  };
  for (int i = 0; i < nk; i += 2) {
    step(i, ab[0], as[0], ab[1], as[1]);
    if (i + 1 < nk) step(i + 1, ab[1], as[1], ab[0], as[0]);
  }
"""
_NREG_PRODUCER = ("setmaxnreg.dec.sync.aligned.u32 40;", "setmaxnreg.dec.sync.aligned.u32 56;")
_NREG_CONSUMER = ("setmaxnreg.inc.sync.aligned.u32 232;", "setmaxnreg.inc.sync.aligned.u32 224;")
VARIANTS = {
    "shipped": [],
    "stages3": [("constexpr int kTfStages = 4;", "constexpr int kTfStages = 3;")],
    "cvt_rna": [("  return (__float_as_uint(v) + 0x1000u) & 0xffffe000u;",
                 "  return hopper::tf32_rna(v);")],
    # candidate designs: the splitters keep two x items in flight (both
    # loads before either's stores; registers 56 / 224), and the consumers
    # load and split the next stage's w fragment while this stage's chain
    # runs (a second fragment, 32 more registers)
    "split2": [(_SPLIT_LOOP, _SPLIT2_LOOP), _NREG_PRODUCER, _NREG_CONSUMER],
    "prefetch_w": [(_CONSUME_LOOP, _PREFETCH_LOOP)],
    "split2_prefetch_w": [(_SPLIT_LOOP, _SPLIT2_LOOP), _NREG_PRODUCER, _NREG_CONSUMER,
                          (_CONSUME_LOOP, _PREFETCH_LOOP)],
    "diag_big_only": [(_SMALL[0], ""), (_SMALL[1], ""),
                      (_SMALL[2], _SMALL[2].replace(", 1);", ", kk > 0);"))],
    "diag_no_x_split": [("      for (int it = sid; it < kTfBM * (kTfBK / 8); it += kTfSplitters) {",
                         "      for (int it = sid; it < 0; it += kTfSplitters) {")],
    "diag_no_w_load": [("          hopper::mbar_expect_tx(&full[s], 2 * kTfTile);",
                        "          hopper::mbar_expect_tx(&full[s], kTfTile);"),
                       ("          for (int j = 0; j < kTfBN / 32; ++j)\n",
                        "          for (int j = 0; j < 0; ++j)\n")],
    "diag_no_w_split": [("      split_tf32(v.x, ab[kk][2 * h], as[kk][2 * h]);",
                         "      ab[kk][2 * h] = as[kk][2 * h] = __float_as_uint(v.x);"),
                        ("      split_tf32(v.y, ab[kk][2 * h + 1], as[kk][2 * h + 1]);",
                         "      ab[kk][2 * h + 1] = as[kk][2 * h + 1] = __float_as_uint(v.y);")],
}


def build(name: str, subs) -> ctypes.CDLL:
    d = os.path.join(ROOT, "build", "gmm_tf32x3_variants", name)
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
        print(f"{name}: nvcc failed, skipped\n{proc.stderr[-3000:]}")
        return None
    lines = (proc.stdout + proc.stderr).splitlines()
    for j, line in enumerate(lines):
        if "gmm_tf32x3" in line and "Function properties" in line:
            print(f"{name}: {lines[j + 1].strip()}; {lines[j + 2].strip()}")
        if "gmm_tf32x3" in line and ("C75" in line or "wgmma" in line.lower()):
            print(f"{name}: ptxas: {line.strip()}")
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


def unaligned_copy(x):
    """x's values at a base 4 bytes past a 16-byte boundary (gmm_tiles's route)."""
    import torch
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    return buf[1:].view(x.shape).copy_(x)


def f64_product(x, w, sizes_np):
    import torch
    out = torch.empty((x.shape[0], w.shape[-1]), dtype=torch.float64, device=x.device)
    r0 = 0
    for g, n in enumerate(int(v) for v in sizes_np):
        if n:
            out[r0:r0 + n] = x[r0:r0 + n].double() @ w[g].double()
        r0 += n
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--iters", type=int, default=4)
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "gmm_tf32x3_variants",
                                                  "results.json"))
    args = ap.parse_args()
    import numpy as np
    import torch
    from repro_torch.kernels import moe_dispatch as md
    from repro_torch.kernels import ref
    if not torch.cuda.is_available():
        print("gmm_tf32x3_variants: needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi)
    names = args.variants.split(",")
    shipped_load = _build.load
    libs = {name: build(name, VARIANTS[name]) for name in names}
    libs = {name: lib for name, lib in libs.items() if lib is not None}
    names = list(libs)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(7)
    randn = lambda shape, scale=1.0: torch.randn(shape, generator=g, device=dev).mul_(scale)
    top = np.argsort(-np.random.default_rng(1).standard_normal((2048, 16)), axis=-1,
                     kind="stable")[:, :4]
    sizes_np = np.bincount(top.ravel(), minlength=16)
    sizes = torch.as_tensor(sizes_np).to(dev)
    d, ff = 6144, 10752
    shapes = {"gate": (randn((8192, d)), randn((16, d, ff), d ** -0.5)),
              "down": (randn((8192, ff)), randn((16, ff, d), ff ** -0.5))}
    ragged = [([70, 0, 200, 3, 0], 100, 300), ([64, 65, 1, 130], 64, 256),
              ([600, 424, 0, 300], 1024, 1032)]
    res: dict = {"device": smi}
    for name, lib in libs.items():
        if name.startswith("diag_"):
            continue
        _build.load = lambda lib=lib: lib
        for gs, Kd, F in ragged:
            x, w = randn((sum(gs), Kd)), randn((len(gs), Kd, F), Kd ** -0.5)
            s = torch.tensor(gs, device=dev)
            assert md.launch_geometry(sum(gs), Kd, len(gs), F, torch.float32,
                                      md.tma_aligned(x, w))["kernel"] == "gmm_tf32x3"
            err = float((md.grouped_matmul(x, w, s) - ref.grouped_matmul_ref(x, w, s)).abs().max())
            print(f"{name}: ragged {gs} Kd={Kd} F={F}: max_abs_err {err:.3g}")
            if err > 5e-5:
                raise SystemExit(f"{name}: disagrees with the plain version")
        for label, (x, w) in shapes.items():
            got = md.grouped_matmul(x, w, sizes)
            want = ref.grouped_matmul_ref(x, w, sizes)
            ok = bool(((got - want).abs() <= 5e-5 + 5e-5 * want.abs()).all())
            e64 = float((got.double() - f64_product(x, w, sizes_np)).abs().max())
            res[f"{name}/{label}/err"] = float((got - want).abs().max())
            res[f"{name}/{label}/err_vs_f64"] = e64
            print(f"{name}: dbrx {label}: max_abs_err {res[f'{name}/{label}/err']:.3g} "
                  f"(within 5e-5 + 5e-5·|want|: {ok}), against float64 {e64:.3g}")
            if not ok:
                raise SystemExit(f"{name}: disagrees with the plain version at dbrx {label}")
            del got, want
    _build.load = shipped_load
    xu = {label: unaligned_copy(x) for label, (x, _) in shapes.items()}
    for label, (x, w) in shapes.items():
        got = md.grouped_matmul(xu[label], w, sizes)
        res[f"gmm_tiles/{label}/err_vs_f64"] = float(
            (got.double() - f64_product(x, w, sizes_np)).abs().max())
        e64 = res[f"gmm_tiles/{label}/err_vs_f64"]
        print(f"gmm_tiles: dbrx {label}: against float64 {e64:.3g}")
        del got
    offs = torch.cumsum(sizes, 0).to(torch.int32)
    for _ in range(args.rounds):
        for order in (names, names[::-1]):
            for label, (x, w) in shapes.items():
                _build.load = shipped_load
                res.setdefault(f"gmm_tiles/{label}", []).append(
                    event_ms(lambda: md.grouped_matmul(xu[label], w, sizes), args.iters))
                for name in order:
                    _build.load = lambda lib=libs[name]: lib
                    res.setdefault(f"{name}/{label}", []).append(
                        event_ms(lambda: md.grouped_matmul(x, w, sizes), args.iters))
                if hasattr(torch, "_grouped_mm"):
                    res.setdefault(f"torch._grouped_mm/{label}", []).append(event_ms(
                        lambda: torch._grouped_mm(x, w, offs=offs, out_dtype=x.dtype),
                        args.iters))
    _build.load = shipped_load
    for key, val in res.items():
        print(f"{key}: {val}")
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    json.dump(res, open(args.out, "w"), indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
