"""K5 grouped_matmul: the CUDA kernel's wrapper and launch geometry.

Replaces the Pallas kernel ``repro/kernels/moe_dispatch.py::
grouped_matmul`` (lines 71-106, ``pallas_call`` at :87): the ragged grouped
GEMM ``out[i] = x[i] @ w[g(i)]`` of the sorted dropless MoE dispatch, rows
of ``x [N, Kd]`` sorted by group and ``group_sizes [G]`` giving the
segments, fp32 sums, the output in x's dtype.

What bounds it on the card, and the design: see ``csrc/moe_dispatch.cu``.
Decode (a few rows per expert) is bound by the bytes of the experts the
rows hit, prefill (hundreds of rows per expert) by fp32 arithmetic; the
kernel picks an 8-row or a 64-row tile from the static shapes
(``launch_geometry``).  The segment offsets are computed on the card from
``group_sizes``: the wrapper never reads them on the host.

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

# Kernel launches through this wrapper (one per call that reaches the card).
launches = 0

# tile geometry, as csrc/moe_dispatch.cu's constants
ROWS_BM, ROWS_BN, ROWS_THREADS = 8, 128, 128       # gmm_rows (decode)
TILE_BM, TILE_BN, TILE_THREADS = 64, 128, 256      # gmm_tiles (prefill)
SCAN_THREADS = 1024
MAX_GROUPS = 4 * SCAN_THREADS
# below this many rows per group on average, the 8-row kernel runs
ROWS_PER_GROUP_SMALL = 16
_DTYPES = (torch.float32, torch.bfloat16)


def launch_geometry(N: int, Kd: int, G: int, F: int) -> dict:
    """Static launch geometry of one call (the counterpart of the Pallas
    kernel's ``launch_geometry``): which kernel, its row and column tiles,
    and the grid — ``round_up(N, bm)/bm + min(G, N)`` row tiles (the
    reference's ``grouped_layout`` bound) by ``ceil(F/bn)`` column tiles.
    Unlike the Pallas kernel, Kd and F need not be padded: the edges are
    masked, and Kd is a loop inside the block."""
    del Kd
    small = N < ROWS_PER_GROUP_SMALL * G
    bm, bn, threads = ((ROWS_BM, ROWS_BN, ROWS_THREADS) if small
                       else (TILE_BM, TILE_BN, TILE_THREADS))
    n = max(N, 1)
    return {"kernel": "gmm_rows" if small else "gmm_tiles", "small": small,
            "bm": bm, "bn": bn, "threads": threads,
            "grid": (-(-n // bm) + min(G, n), -(-F // bn))}


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
    geo = launch_geometry(N, Kd, G, F)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.grouped_matmul(int(x.dtype == torch.bfloat16), int(geo["small"]),
                             x.data_ptr(), w.data_ptr(), out.data_ptr(),
                             sizes.data_ptr(), offs.data_ptr(), N, Kd, F, G, e_in,
                             s_outer, s_inner, s_k, stream)
    _build.check(err, "grouped_matmul launch")
    launches += 1
    return out
