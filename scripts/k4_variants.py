"""K4's fp32 variants side by side on the card: flash_fwd_tf32x3 and flash_fwd.

    python3 scripts/k4_variants.py                # from the repository root, on a CUDA card
    python3 scripts/k4_variants.py --hd 128       # only the head_dim-128 cases
    python3 scripts/k4_variants.py --prefill chatglm3-6b   # a full-depth prefill, both ways

Builds the kernel library with ptxas's report (registers, spills and any
C75xx "wgmma serialized" note of flash_fwd_tf32x3), then, at fp32
head_dim-64 and head_dim-128 shapes (the packed two-heads-a-block edges,
stablelm-1.6b's training and prefill shapes, qwen2.5-14b's GQA, dbrx-132b's
and chatglm3-6b's prefill shapes, windows, MQA, non-causal and ragged
cases), runs flash_fwd_tf32x3 and flash_fwd through the library's C entry
point on the same inputs, holds flash_fwd_tf32x3 against the plain version
(``ref.attention_full``) at fp32's tolerance (atol 2e-5 + rtol 2e-5, lse
atol 1e-4), prints both variants' max and mean error beside SDPA's, and
times both variants and SDPA with CUDA events at the larger shapes, in
turns (new, old, new).  Exits 1 if a case disagrees.  With ``--prefill
ARCH`` it instead runs ``prefill_step`` of that dense model at full width
and depth on [B=4, S=2048] tokens (one replica, seeded weights), with K4's
fp32 calls forced onto flash_fwd and as the wrapper routes them
(flash_fwd_tf32x3), in turns (before, after, after, before), and prints ms
per prefill and tokens/s of each.  Imports nothing of JAX.
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

# (label, B, S, H, KV, Skv, causal, window, head_dim)
CASES = [
    ("small", 3, 64, 4, 4, 64, True, None, 64),
    ("packed_h_odd", 2, 64, 5, 5, 64, True, None, 64),
    ("packed_gqa_ragged", 2, 48, 6, 2, 48, True, None, 64),
    ("packed_mqa_full", 2, 64, 4, 1, 64, False, None, 64),
    ("packed_s_gt_skv", 2, 33, 4, 4, 17, False, None, 64),
    ("packed_window", 2, 64, 8, 8, 64, True, 16, 64),
    ("s64_skv65", 2, 64, 4, 4, 65, False, None, 64),
    ("gqa", 2, 256, 8, 2, 256, True, None, 64),
    ("mqa_win_ragged", 1, 1000, 8, 1, 1000, True, 256, 64),
    ("noncausal_both_ragged", 1, 200, 4, 4, 333, False, None, 64),
    ("window_no_causal", 2, 130, 2, 2, 130, False, 50, 64),
    ("stablelm_train", 128, 64, 32, 32, 64, True, None, 64),
    ("stablelm_prefill", 4, 2048, 32, 32, 2048, True, None, 64),
    ("stablelm_prefill_window256", 4, 2048, 32, 32, 2048, True, 256, 64),
    ("mqa", 2, 1024, 16, 1, 1024, True, None, 64),
    ("noncausal_skv2048", 2, 512, 8, 8, 2048, False, None, 64),
    ("ragged_s1000", 2, 1000, 8, 8, 1000, True, None, 64),
    # head_dim 128: 32-key tiles; packed (S, Skv <= 64) means two tiles a head
    ("hd128_small", 3, 64, 4, 4, 64, True, None, 128),
    ("hd128_packed_h_odd", 2, 64, 5, 5, 64, True, None, 128),
    ("hd128_packed_gqa_ragged", 2, 48, 6, 2, 48, True, None, 128),
    ("hd128_packed_one_tile", 2, 20, 4, 2, 32, False, None, 128),
    ("hd128_packed_s_gt_skv", 2, 33, 4, 4, 17, False, None, 128),
    ("hd128_packed_window", 2, 64, 8, 8, 64, True, 16, 128),
    ("hd128_s64_skv65", 2, 64, 4, 4, 65, False, None, 128),
    ("hd128_gqa", 2, 256, 8, 2, 256, True, None, 128),
    ("hd128_mqa_win_ragged", 1, 1000, 8, 1, 1000, True, 256, 128),
    ("hd128_noncausal_both_ragged", 1, 200, 4, 4, 333, False, None, 128),
    ("hd128_window_no_causal", 2, 130, 2, 2, 130, False, 50, 128),
    ("dbrx_smoke_train", 128, 64, 4, 2, 64, True, None, 128),
    ("qwen_gqa", 1, 2048, 40, 8, 2048, True, None, 128),
    ("dbrx_prefill", 2, 1024, 48, 8, 1024, True, None, 128),
    ("chatglm_prefill", 4, 2048, 32, 2, 2048, True, None, 128),
    ("hd128_noncausal_skv2048", 2, 512, 8, 8, 2048, False, None, 128),
    ("hd128_ragged_s1000", 2, 1000, 8, 8, 1000, True, None, 128),
]
VARIANT_ID = {"flash_fwd": 0, "flash_fwd_tf32x3": 2}   # the C entry point's argument


def build_report() -> None:
    """Compile K4's source once more with ptxas's report and print the
    tf32x3 kernels' lines (the library the run uses is built by
    ``_build``)."""
    out = os.path.join(_build.BUILD_DIR, "k4_variants_report.o")
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    t0 = time.perf_counter()
    proc = subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o", out,
                           str(_build.ATTN_SOURCE)], capture_output=True, text=True)
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


def prefill_before_after(arch: str, B: int = 4, S: int = 2048) -> int:
    """ms per prefill of ``arch`` with K4 on flash_fwd (before) and as
    routed (after), in turns; the outputs of the two must agree at the
    prefill tolerance of chip_smoke.py (scores 1e-5, last logits 1e-4)."""
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.tree import tree_map
    dev = torch.device("cuda")
    cfg = get_config(arch)
    params = M.init_params(cfg, generator=torch.Generator(device=dev).manual_seed(0), device=dev)
    params = tree_map(lambda x: x[None], params)
    g = torch.Generator(device=dev).manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (1, B, S), generator=g, device=dev)}
    routed = fa.launch_geometry
    on_flash_fwd = lambda *a: routed(*a[:7], False)     # as if the bases were unaligned

    def prefill(before: bool):
        fa.launch_geometry = on_flash_fwd if before else routed
        try:
            fa.zero_launches()
            out = M.prefill_step(cfg, params, batch)
            torch.cuda.synchronize()
            return out, dict(fa.variant_launches)
        finally:
            fa.launch_geometry = routed

    def timed(before: bool) -> float:
        t = []
        for _ in range(3):
            t0 = time.perf_counter()
            prefill(before)
            t.append((time.perf_counter() - t0) * 1e3)
        return sorted(t)[1]

    with torch.no_grad():
        (s0, l0, _), v0 = prefill(True)
        (s1, l1, _), v1 = prefill(False)
        print(f"{arch} prefill [{B}, {S}], {cfg.n_layers} layers: K4 launches before {v0}, "
              f"after {v1}; after vs before: scores {float((s0 - s1).abs().max()):.3g}, last "
              f"logits {float((l0 - l1).abs().max()):.3g}", flush=True)
        ok = (float((s0 - s1).abs().max()) <= 1e-5 and float((l0 - l1).abs().max()) <= 1e-4
              and v0["flash_fwd"] == v1["flash_fwd_tf32x3"] == cfg.n_layers)
        del s0, l0, s1, l1
        t = [timed(True), timed(False), timed(False), timed(True)]
    tok = B * S
    print(f"{arch} prefill ms (median of 3 each, in turns before/after/after/before): "
          f"{t[0]:.2f} / {t[1]:.2f} / {t[2]:.2f} / {t[3]:.2f}; tokens/s before "
          f"{tok / t[0] * 1e3:,.0f} / {tok / t[3] * 1e3:,.0f}, after {tok / t[1] * 1e3:,.0f} / "
          f"{tok / t[2] * 1e3:,.0f}", flush=True)
    return 0 if ok else 1


def main() -> int:
    if not torch.cuda.is_available():
        print("k4_variants: needs a CUDA card", file=sys.stderr)
        return 1
    disable_tf32()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    if "--prefill" in sys.argv:
        _build.load()
        return prefill_before_after(sys.argv[sys.argv.index("--prefill") + 1])
    build_report()
    lib = _build.load()
    hds = [int(sys.argv[sys.argv.index("--hd") + 1])] if "--hd" in sys.argv else [64, 128]
    for hd in fa.TF_HEAD_DIMS:
        print(f"flash_fwd_tf32x3 shared memory at head_dim {hd}: "
              f"{lib.flash_attention_tf32x3_smem_bytes(hd)} B (launch_geometry: "
              f"{fa.launch_geometry(4, 2048, 32, 32, 2048, hd)['smem_bytes']} B)")
    dev, gen = torch.device("cuda"), torch.Generator().manual_seed(0)
    bad = 0
    for label, B, S, H, KV, Skv, causal, window, hd in CASES:
        if hd not in hds:
            continue
        q = torch.randn((B, S, H, hd), generator=gen).to(dev)
        k, v = (torch.randn((B, Skv, KV, hd), generator=gen).to(dev) for _ in range(2))
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
        print(f"{label} [{B}, {S}, {H}/{KV}, Skv {Skv}, hd {hd}] causal={causal} window={window}: "
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
