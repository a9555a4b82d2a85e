"""K1 auc_loss before and after its single launch, side by side on the card.

    python3 scripts/auc_loss_before_after.py --before DIR   # from the repository root

DIR is a checkout whose ``src/repro_torch/kernels/csrc/coda_kernels.cu``
holds the two-launch form of the kernel (block partials, then
``auc_loss_finish``), e.g. ``git archive`` of an earlier commit unpacked
into a git-ignored directory.  The script builds that source alone with
nvcc, loads the current library through ``_build``, and at each shape runs
both on the same inputs: the outputs (loss, dh, da, db, dα) must be
bitwise equal to each other and from call to call, and within atol 1e-5 +
rtol 1e-4 of the plain version.  Then it times both with CUDA events in
turns (before, after, after, before), reads their device time with
torch.profiler (the kernels of one call summed), and times 100 calls of
each captured in a CUDA graph (launch gaps included, no host time).  Exits
1 on a mismatch.
Imports nothing of JAX.
"""
import ctypes
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
from repro_torch.kernels import _build, ref  # noqa: E402
from repro_torch.kernels import auc_loss as K1  # noqa: E402

SHAPES = [(1, 7), (4, 32), (4, 513), (8, 4096), (3, 33_000), (2, 65_536)]
P_POS = 0.71


def build_before(checkout: str) -> ctypes.CDLL:
    src = os.path.join(checkout, "src/repro_torch/kernels/csrc/coda_kernels.cu")
    out = os.path.join(_build.BUILD_DIR, "auc_loss_before.so")
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-I", str(_build.CSRC))]
    subprocess.run([_build.nvcc(), *flags, "-shared", "-o", out, src], check=True)
    lib = ctypes.CDLL(out)
    P = ctypes.c_void_p
    lib.coda_auc_loss.restype = ctypes.c_int
    lib.coda_auc_loss.argtypes = [P, P, P, P, P, ctypes.c_float, ctypes.c_int, ctypes.c_int,
                                  P, P, P, P]
    lib.coda_auc_rows_per_block.restype = ctypes.c_int
    return lib


def before_fn(lib, h, y, a, b, alpha):
    K, T = h.shape
    n_blocks = -(-T // lib.coda_auc_rows_per_block())
    dh = torch.empty((K, T), dtype=torch.float32, device=h.device)
    partials = torch.empty((K, n_blocks, 4), dtype=torch.float32, device=h.device)
    out = torch.empty((K, 4), dtype=torch.float32, device=h.device)
    err = lib.coda_auc_loss(h.data_ptr(), y.data_ptr(), a.data_ptr(), b.data_ptr(),
                            alpha.data_ptr(), P_POS, K, T, dh.data_ptr(), partials.data_ptr(),
                            out.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"the two-launch auc_loss failed: CUDA error {err}")
    return out[:, 0], dh, out[:, 1], out[:, 2], out[:, 3]


def events_ms(fn, iters: int = 200) -> float:
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_us(fn, calls: int = 100) -> float:
    """Per-call time of ``calls`` calls captured into one CUDA graph and
    replayed: the device's time with the launches back to back, the gaps
    between dependent kernels included and no host time."""
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(calls):
            fn()
    g.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(10):
        g.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (10 * calls) * 1e3


def device_ms(fn, calls: int = 50) -> tuple[float, int]:
    """Device time per call summed over the auc_loss kernels, and the number
    of kernels the profiler recorded per call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    ev = [e for e in prof.events()
          if e.device_type == DeviceType.CUDA and "auc_loss" in e.name]
    return sum(e.device_time_total for e in ev) / 1e3 / calls, len(ev) // calls


def main() -> int:
    if not torch.cuda.is_available() or "--before" not in sys.argv:
        print("usage (on a CUDA card): auc_loss_before_after.py --before DIR", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    old = build_before(sys.argv[sys.argv.index("--before") + 1])
    _build.load()
    dev, gen = torch.device("cuda"), torch.Generator().manual_seed(0)
    bad = 0
    for K, T in SHAPES:
        h = torch.rand((K, T), generator=gen).to(dev)
        y = (torch.rand((K, T), generator=gen) < P_POS).float().to(dev)
        a, b, al = (torch.randn((K,), generator=gen).mul(0.3).to(dev) for _ in range(3))
        after = lambda: K1.auc_loss(h, y, a, b, al, P_POS)
        before = lambda: before_fn(old, h, y, a, b, al)
        new, new2, was = after(), after(), before()
        want = ref.auc_loss_ref(h, y, a, b, al, P_POS)
        torch.cuda.synchronize()
        same = all(torch.equal(x, z) for x, z in zip(new, was))
        stable = all(torch.equal(x, z) for x, z in zip(new, new2))
        err = max(float((x - w).abs().max()) for x, w in zip(new, want))
        close = all(bool(((x - w).abs() <= 1e-5 + 1e-4 * w.abs()).all())
                    for x, w in zip(new, want))
        bad += not (same and stable and close)
        if not same:
            names = ("loss", "dh", "da", "db", "dalpha")
            ulps = {n: int((x.view(torch.int32) - z.view(torch.int32)).abs().max())
                    for n, x, z in zip(names, new, was) if not torch.equal(x, z)}
            print(f"   differs from the two-launch kernel (max ulps): {ulps}")
        geo = K1.launch_geometry(K, T)
        print(f"auc_loss [{K}, {T}] grid {geo['grid']} ticket={geo['ticket']}: bitwise equal "
              f"to the two-launch kernel {same}, run to run {stable}; max_abs_err vs the plain "
              f"version {err:.3g}", flush=True)
        t = [events_ms(before), events_ms(after), events_ms(after), events_ms(before)]
        d_before, n_before = device_ms(before)
        d_after, n_after = device_ms(after)
        gr = [graph_us(before), graph_us(after), graph_us(after), graph_us(before)]
        print(f"   CUDA events per call: before {t[0] * 1e3:.2f} / {t[3] * 1e3:.2f} us, after "
              f"{t[1] * 1e3:.2f} / {t[2] * 1e3:.2f} us; device: before {d_before * 1e3:.2f} us "
              f"({n_before} kernels a call), after {d_after * 1e3:.2f} us ({n_after}); "
              f"CUDA-graph replay per call: before {gr[0]:.2f} / {gr[3]:.2f} us, after "
              f"{gr[1]:.2f} / {gr[2]:.2f} us", flush=True)
    print("all shapes agree" if not bad else f"{bad} shapes disagree")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
