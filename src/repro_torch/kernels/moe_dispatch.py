"""K5 grouped_matmul: the CUDA kernel's wrapper and launch geometry.

Replaces the Pallas kernel ``repro/kernels/moe_dispatch.py::
grouped_matmul`` (lines 71-106, ``pallas_call`` at :87): the ragged grouped
GEMM ``out[i] = x[i] @ w[g(i)]`` of the sorted dropless MoE dispatch, rows
of ``x [N, Kd]`` sorted by group and ``group_sizes [G]`` giving the
segments, fp32 sums, the output in x's dtype.

What bounds it on the card, and the design: see ``csrc/moe_dispatch.cu``.
Decode (a few rows per expert) is bound by the bytes of the experts the
rows hit, fp32 prefill (hundreds of rows per expert) by arithmetic.
``launch_geometry`` picks one of five kernels from static facts — dtype,
alignment and the average rows per group: for bf16 when Kd, F and every
stride are multiples of 8 elements and x and w 16-byte aligned,
``gmm_wgmma_m128`` (bf16 tensor cores fed by TMA, 128-row tiles of 256
columns, two consumer warpgroups sharing each weight stage, two-block
clusters that multicast the weights to two row tiles of one group) at 64
rows per group or more and ``gmm_wgmma`` (64-row tiles, 128 columns below 16
rows per group, else 256) below; otherwise ``gmm_rows`` (8-row tiles)
below 16 rows per group; above it ``gmm_tf32x3`` (fp32 as split TF32 on
the tensor cores, TMA-fed 128×128 tiles) for fp32 when Kd, F and every
stride are multiples of 4 elements and x and w 16-byte aligned, and
``gmm_tiles`` (128×128 FFMA tiles, cp.async ring) for what TMA cannot
read.
The segment offsets are computed on the card from ``group_sizes``: the
wrapper never reads them on the host.

``w`` is ``[G, Kd, F]``, or ``[R, E, Kd, F]`` with the R workers folded
into G = R·E groups (group g = r·E + e), which is how the MoE layer passes
a layer's slice of a stacked ``[K, L, E, d, ff]`` leaf: the kernel reads
it through its strides, so the slice is never made contiguous.

The TPU kernel has no VJP and training uses capacity dispatch, so the
kernel is forward only: a CUDA call that autograd would need to
differentiate raises.  For CPU tensors the wrapper computes the plain
version (``ref.grouped_matmul_ref``, differentiable); for CUDA tensors it
launches the kernel or raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref

# Kernel launches through this wrapper (one per call that reaches the card),
# in all and by kernel.
launches = 0
variant_launches = {"gmm_rows": 0, "gmm_tiles": 0, "gmm_wgmma": 0, "gmm_tf32x3": 0,
                    "gmm_wgmma_m128": 0}

# tile geometry, as csrc/moe_dispatch.cu's constants
ROWS_BM, ROWS_BN, ROWS_THREADS = 8, 128, 128       # gmm_rows (decode)
TILE_BM, TILE_BN, TILE_THREADS = 128, 128, 256     # gmm_tiles (prefill)
TILE_STAGES, TILE_BK = 3, 16
TILE_SMEM = TILE_STAGES * (TILE_BK * (TILE_BM + 4) + TILE_BK * TILE_BN) * 4
WG_BM, WG_BK, WG_THREADS = 64, 64, 160             # gmm_wgmma (bf16)
WG_STAGES = {128: 4, 256: 5}                       # by BN
M128_BM, M128_BN, M128_THREADS, M128_STAGES = 128, 256, 384, 4  # gmm_wgmma_m128 (bf16)
# x and w tiles a stage, two barriers a stage, 1 KB of alignment slack
M128_SMEM = M128_STAGES * (M128_BM * WG_BK * 2 + WG_BK * M128_BN * 2 + 16) + 1024
TF_BM, TF_BN, TF_BK, TF_THREADS = 128, 128, 32, 384  # gmm_tf32x3 (fp32, TMA)
TF_STAGES = 4
# x, x_small and w tiles a stage, three barriers a stage, 1 KB of alignment slack
TF_SMEM = TF_STAGES * (3 * TF_BM * TF_BK * 4 + 3 * 8) + 1024
SCAN_THREADS = 1024
MAX_GROUPS = 4 * SCAN_THREADS
# below this many rows per group on average, the decode kernels run
ROWS_PER_GROUP_SMALL = 16
# from this many rows per group on average, aligned bf16 runs gmm_wgmma_m128
# (scripts/gmm_wgmma_variants.py: 1-2 % behind gmm_wgmma at 16-48 rows a
# group, where a group's rows fit one 64-row tile; 9-11 % ahead at 64)
ROWS_PER_GROUP_M128 = 64
_KERNEL_IDS = {"gmm_rows": 0, "gmm_tiles": 1, "gmm_wgmma": 2, "gmm_tf32x3": 3,
               "gmm_wgmma_m128": 4}
_DTYPES = (torch.float32, torch.bfloat16)


def wgmma_smem(bn: int) -> int:
    """gmm_wgmma's dynamic shared memory at BN = ``bn``: the ring of x and w
    stages, a full and an empty barrier per stage, 1 KB of alignment slack."""
    return WG_STAGES[bn] * (WG_BM * WG_BK * 2 + WG_BK * bn * 2 + 16) + 1024


def launch_geometry(N: int, Kd: int, G: int, F: int, dtype=torch.float32,
                    tma_ok: bool = True) -> dict:
    """Static launch geometry of one call (the counterpart of the Pallas
    kernel's ``launch_geometry``): which kernel, its row and column tiles,
    and the grid — ``round_up(N, bm)/bm + min(G, N)`` row tiles (the
    reference's ``grouped_layout`` bound) by ``ceil(F/bn)`` column tiles
    (the tile kernels launch it flattened and walk it in groups of 8 column
    tiles; ``gmm_wgmma_m128`` in two-block clusters over pairs of row
    tiles, ``cluster``, its row tiles rounded up to even).  ``tma_ok``: TMA
    can read x and w (every stride of w a multiple of 16 bytes, x and w
    16-byte aligned: ``tma_aligned``).  For bf16 when Kd and F are
    multiples of 8 and ``tma_ok``: ``gmm_wgmma_m128`` at
    ``ROWS_PER_GROUP_M128`` rows per group on average or more, else
    ``gmm_wgmma``; otherwise ``gmm_rows`` below 16 rows per group on
    average; above it ``gmm_tf32x3`` for fp32 when Kd and F are multiples
    of 4 and ``tma_ok``, else ``gmm_tiles``.  Unlike the Pallas kernel, Kd
    and F need not be padded: the edges are masked (or zero-filled by TMA),
    and Kd is a loop inside the block.  ``tma_boxes``: the TMA kernels' x
    and w tensor-map boxes."""
    small = N < ROWS_PER_GROUP_SMALL * G
    n = max(N, 1)
    if dtype == torch.bfloat16 and tma_ok and Kd % 8 == 0 and F % 8 == 0:
        if N >= ROWS_PER_GROUP_M128 * G:
            geo = {"kernel": "gmm_wgmma_m128", "bm": M128_BM, "bn": M128_BN,
                   "threads": M128_THREADS, "stages": M128_STAGES, "smem_bytes": M128_SMEM,
                   "tma_boxes": ((WG_BK, M128_BM), (64, WG_BK, 1, 1)), "cluster": 2}
        else:
            bn = 128 if small else 256
            geo = {"kernel": "gmm_wgmma", "bm": WG_BM, "bn": bn, "threads": WG_THREADS,
                   "stages": WG_STAGES[bn], "smem_bytes": wgmma_smem(bn),
                   "tma_boxes": ((WG_BK, WG_BM), (64, WG_BK, 1, 1))}
    elif small:
        geo = {"kernel": "gmm_rows", "bm": ROWS_BM, "bn": ROWS_BN,
               "threads": ROWS_THREADS, "smem_bytes": 0}
    elif dtype == torch.float32 and tma_ok and Kd % 4 == 0 and F % 4 == 0:
        geo = {"kernel": "gmm_tf32x3", "bm": TF_BM, "bn": TF_BN, "threads": TF_THREADS,
               "stages": TF_STAGES, "smem_bytes": TF_SMEM,
               "tma_boxes": ((TF_BK, TF_BM), (32, TF_BK, 1, 1))}
    else:
        geo = {"kernel": "gmm_tiles", "bm": TILE_BM, "bn": TILE_BN,
               "threads": TILE_THREADS, "stages": TILE_STAGES, "smem_bytes": TILE_SMEM}
    rows = -(-n // geo["bm"]) + min(G, n)
    # gmm_wgmma_m128's two-block clusters take pairs of row tiles
    geo["grid"] = (rows + rows % geo.get("cluster", 1), -(-F // geo["bn"]))
    return geo


def tma_aligned(x, w) -> bool:
    """Whether TMA can read x and w as gmm_wgmma and gmm_tf32x3 need: every
    stride of w (but the unit one) a multiple of 16 bytes — 8 bf16 or 4 fp32
    elements — and both bases 16-byte aligned (x is contiguous, so its row
    stride is Kd: ``launch_geometry`` checks it)."""
    _, _, s_outer, s_inner, s_k = weight_layout(w)
    per = 16 // w.element_size()
    return (all(s % per == 0 for s in (s_outer, s_inner, s_k))
            and x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0)


def vec_aligned(w) -> bool:
    """Whether gmm_tiles may copy fp32 w in 16-byte pieces: F and every
    stride of w multiples of 4 elements, the base 16-byte aligned."""
    _, _, s_outer, s_inner, s_k = weight_layout(w)
    return (all(s % 4 == 0 for s in (w.shape[-1], s_outer, s_inner, s_k))
            and w.data_ptr() % 16 == 0)


def zero_launches() -> None:
    """Set the launch counters (the total and each kernel's) to 0."""
    global launches
    launches = 0
    for name in variant_launches:
        variant_launches[name] = 0


def weight_layout(w) -> tuple[int, int, int, int, int]:
    """(G, e_in, s_outer, s_inner, s_k) of a ``[G, Kd, F]`` or
    ``[R, E, Kd, F]`` weight, strides in elements: group g starts at
    ``(g // e_in)·s_outer + (g % e_in)·s_inner``."""
    if w.dim() == 3:
        return w.shape[0], w.shape[0], 0, w.stride(0), w.stride(1)
    return w.shape[0] * w.shape[1], w.shape[1], w.stride(0), w.stride(1), w.stride(2)


def _check(x, w, group_sizes):
    if x.dim() != 2 or w.dim() not in (3, 4) or w.shape[-2] != x.shape[1]:
        raise ValueError(f"grouped_matmul wants x [N, Kd] and w [G, Kd, F] or "
                         f"[R, E, Kd, F]; got {tuple(x.shape)}, {tuple(w.shape)}")
    if group_sizes.shape != (ref.n_groups(w),):
        raise ValueError(f"grouped_matmul: group_sizes {tuple(group_sizes.shape)} "
                         f"for {ref.n_groups(w)} groups")
    if len({x.device, w.device, group_sizes.device}) != 1:
        raise ValueError("grouped_matmul inputs lie on several devices")


def grouped_matmul(x, w, group_sizes):
    """out[i] = x[i] @ w[g(i)] -> [N, F] in x's dtype (see the module
    docstring).  ``sum(group_sizes) == N`` is the caller's contract: the
    kernel does not read the sizes on the host to check it."""
    _check(x, w, group_sizes)
    if x.device.type == "cpu":
        return ref.grouped_matmul_ref(x, w, group_sizes)
    if x.device.type != "cuda":
        raise ValueError(f"grouped_matmul runs on cpu or cuda, got {x.device}")
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        raise RuntimeError("grouped_matmul's CUDA kernel is forward only (the TPU "
                           "kernel has no VJP, and training dispatches by capacity); "
                           "differentiate through impl='ref'")
    if x.dtype not in _DTYPES or w.dtype != x.dtype:
        raise ValueError(f"grouped_matmul wants x and w both float32 or both "
                         f"bfloat16, got {x.dtype}, {w.dtype}")
    if w.stride(-1) != 1:
        raise ValueError("grouped_matmul reads w's last axis with unit stride; got "
                         f"strides {w.stride()}")
    N, Kd = x.shape
    F = w.shape[-1]
    G, e_in, s_outer, s_inner, s_k = weight_layout(w)
    if G > MAX_GROUPS:
        raise ValueError(f"grouped_matmul takes at most {MAX_GROUPS} groups, got {G}")
    out = torch.empty((N, F), dtype=x.dtype, device=x.device)
    if N == 0:
        return out
    global launches
    lib = _build.load()
    x = x.contiguous()
    sizes = group_sizes.to(torch.int32).contiguous()      # on the device
    offs = torch.empty((2 * G + 2,), dtype=torch.int32, device=x.device)
    geo = launch_geometry(N, Kd, G, F, x.dtype, tma_aligned(x, w))
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.grouped_matmul(int(x.dtype == torch.bfloat16), _KERNEL_IDS[geo["kernel"]],
                             geo["bn"], x.data_ptr(), w.data_ptr(), out.data_ptr(),
                             sizes.data_ptr(), offs.data_ptr(), N, Kd, F, G, e_in,
                             s_outer, s_inner, s_k, int(vec_aligned(w)), stream)
    _build.check(err, f"grouped_matmul launch ({geo['kernel']})")
    launches += 1
    variant_launches[geo["kernel"]] += 1
    return out
