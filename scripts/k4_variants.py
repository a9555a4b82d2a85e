"""K4's fp32 variants side by side on the card: flash_fwd_tf32x3 and flash_fwd.

    python3 scripts/k4_variants.py        # from the repository root, on a CUDA card

Builds the kernel library with ptxas's report (registers, spills and any
C75xx "wgmma serialized" note of flash_fwd_tf32x3), then, at fp32
head_dim-64 shapes (the packed two-heads-a-block edges, stablelm-1.6b's
training and prefill shapes, windows, MQA, non-causal and ragged cases),
runs flash_fwd_tf32x3 and flash_fwd through the library's C entry point
on the same inputs, holds flash_fwd_tf32x3 against the plain version
(``ref.attention_full``) at fp32's tolerance (atol 2e-5 + rtol 2e-5, lse
atol 1e-4), prints both variants' max and mean error beside SDPA's, and
times both variants and SDPA with CUDA events at the larger shapes.
Exits 1 if a case disagrees.  Imports nothing of JAX.
"""
import os
import subprocess
import sys
import time

import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
from repro_torch import disable_tf32  # noqa: E402
from repro_torch.kernels import _build, ref  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402

# (label, B, S, H, KV, Skv, causal, window); head_dim 64
CASES = [
    ("small", 3, 64, 4, 4, 64, True, None),
    ("packed_h_odd", 2, 64, 5, 5, 64, True, None),
    ("packed_gqa_ragged", 2, 48, 6, 2, 48, True, None),
    ("packed_mqa_full", 2, 64, 4, 1, 64, False, None),
    ("packed_s_gt_skv", 2, 33, 4, 4, 17, False, None),
    ("packed_window", 2, 64, 8, 8, 64, True, 16),
    ("s64_skv65", 2, 64, 4, 4, 65, False, None),
    ("gqa", 2, 256, 8, 2, 256, True, None),
    ("mqa_win_ragged", 1, 1000, 8, 1, 1000, True, 256),
    ("noncausal_both_ragged", 1, 200, 4, 4, 333, False, None),
    ("window_no_causal", 2, 130, 2, 2, 130, False, 50),
    ("stablelm_train", 128, 64, 32, 32, 64, True, None),
    ("stablelm_prefill", 4, 2048, 32, 32, 2048, True, None),
    ("stablelm_prefill_window256", 4, 2048, 32, 32, 2048, True, 256),
    ("mqa", 2, 1024, 16, 1, 1024, True, None),
    ("noncausal_skv2048", 2, 512, 8, 8, 2048, False, None),
    ("ragged_s1000", 2, 1000, 8, 8, 1000, True, None),
]
VARIANT_ID = {"flash_fwd": 0, "flash_fwd_tf32x3": 2}   # the C entry point's argument


def build_report() -> None:
    """Compile the sources once more with ptxas's report and print the new
    kernel's lines (the library the run uses is built by ``_build``)."""
    out = os.path.join(_build.BUILD_DIR, "k4_variants_report.so")
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    t0 = time.perf_counter()
    proc = subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o", out,
                           *map(str, _build.sources())], capture_output=True, text=True)
    lines = (proc.stdout + proc.stderr).splitlines()
    for i, line in enumerate(lines):
        if "tf32x3" in line or "C75" in line or "error" in line.lower():
            print(line[:300])
            for nxt in lines[i + 1:i + 4]:
                if "Used" in nxt or "spill" in nxt:
                    print("   ", nxt.strip()[:300])
    print(f"nvcc rc {proc.returncode} in {time.perf_counter() - t0:.1f} s", flush=True)
    if proc.returncode:
        print("\n".join(lines[-40:]))
        sys.exit(1)


def run(lib, variant, q, k, v, causal, window):
    B, S, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    o = torch.empty_like(q)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    err = lib.flash_attention_forward(0, hd, VARIANT_ID[variant], q.data_ptr(), k.data_ptr(),
                                      v.data_ptr(), o.data_ptr(), lse.data_ptr(), B, S, H, Skv,
                                      KV, int(causal), -1 if window is None else window,
                                      hd ** -0.5, torch.cuda.current_stream().cuda_stream)
    _build.check(err, variant)
    return o, lse


def ms(fn, iters: int = 20) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def sdpa(q, k, v, causal, window):
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    gqa = q.shape[2] != k.shape[2]
    if window is None:
        return lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                                      enable_gqa=gqa)
    pos = lambda n: torch.arange(n, device=q.device)
    mask = ref._mask(pos(q.shape[1]), pos(k.shape[1]), causal, window)
    return lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask, enable_gqa=gqa)


def main() -> int:
    if not torch.cuda.is_available():
        print("k4_variants: needs a CUDA card", file=sys.stderr)
        return 1
    disable_tf32()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    build_report()
    lib = _build.load()
    print(f"flash_fwd_tf32x3 shared memory: {lib.flash_attention_tf32x3_smem_bytes(64)} B "
          f"(launch_geometry: {fa.launch_geometry(4, 2048, 32, 32, 2048, 64)['smem_bytes']} B)")
    dev, gen = torch.device("cuda"), torch.Generator().manual_seed(0)
    bad = 0
    for label, B, S, H, KV, Skv, causal, window in CASES:
        q = torch.randn((B, S, H, 64), generator=gen).to(dev)
        k, v = (torch.randn((B, Skv, KV, 64), generator=gen).to(dev) for _ in range(2))
        o, lse = run(lib, "flash_fwd_tf32x3", q, k, v, causal, window)
        want, want_lse = ref.attention_full(q, k, v, causal=causal, window=window,
                                            return_lse=True)
        d = (o - want).abs()
        lse_err = float((lse - want_lse).abs().max())
        ok = bool((d <= 2e-5 + 2e-5 * want.abs()).all()) and lse_err <= 1e-4
        d0 = (run(lib, "flash_fwd", q, k, v, causal, window)[0] - want).abs()
        lib_fn = sdpa(q, k, v, causal, window)
        ds = (lib_fn().transpose(1, 2) - want).abs()
        bad += not ok
        print(f"{label} [{B}, {S}, {H}/{KV}, Skv {Skv}] causal={causal} window={window}: "
              f"ok={ok}; max/mean err flash_fwd_tf32x3 {float(d.max()):.3g}/"
              f"{float(d.mean()):.3g} (lse {lse_err:.3g}), flash_fwd {float(d0.max()):.3g}/"
              f"{float(d0.mean()):.3g}, SDPA {float(ds.max()):.3g}/{float(ds.mean()):.3g}",
              flush=True)
        if S >= 1000 or B >= 128:
            t_new = ms(lambda: run(lib, "flash_fwd_tf32x3", q, k, v, causal, window))
            t_old = ms(lambda: run(lib, "flash_fwd", q, k, v, causal, window))
            t_new2 = ms(lambda: run(lib, "flash_fwd_tf32x3", q, k, v, causal, window))
            print(f"   CUDA events: flash_fwd_tf32x3 {t_new:.4f} / {t_new2:.4f} ms, flash_fwd "
                  f"{t_old:.4f} ms, SDPA {ms(lib_fn):.4f} ms", flush=True)
    print("all cases agree" if not bad else f"{bad} cases disagree")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
