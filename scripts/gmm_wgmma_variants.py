"""Compare variants of K5's bf16 ``gmm_wgmma_m128`` kernel on the card, beside
``gmm_wgmma`` and ``torch._grouped_mm`` on the same values.

    python3 scripts/gmm_wgmma_variants.py [--variants shipped,own_w] [--rounds 5]
        [--crossover 16,32,64,96,128,256] [--prefill-rounds 10]
        [--out build/gmm_wgmma_variants/results.json]

The shipped kernel runs two-block clusters over pairs of row tiles that
multicast w.  The candidates: ``own_w``, the one-block form (every block
loads its own w); ``persistent``, that form with one block an SM walking
the tiles; ``cluster_x``, two-block clusters over pairs of column tiles
that multicast x instead of w.

Each variant is a patched copy of ``src/repro_torch/kernels/csrc`` (a list
of source substitutions below), built with nvcc into its own library under
``build/gmm_wgmma_variants/<name>/`` and loaded in place of the package's
(``_build.load``), so ``csrc/`` itself is never touched.  Which kernel a
call runs is ``launch_geometry``'s pick: the script sets
``ROWS_PER_GROUP_M128`` so that gmm_wgmma_m128 takes every aligned bf16 call
of 16 rows a group or more (each variant) or none (gmm_wgmma, from the
shipped library).  For each variant it prints ptxas's register and spill
report for ``gmm_wgmma_m128``; checks ragged cases (1-, 127-, 128- and
129-row groups, empty groups, Kd off 64, F off 256, dbrx's d) and the
dbrx-132b bf16 prefill expert shapes (N = 8192 rows of a seeded top-4
routing over 16 experts, 6144→10752 and 10752→6144, weights at the init
scale Kd^-0.5) against the plain version (atol 1e-4, rtol 2^-7) and against
``gmm_wgmma`` on the same values (bitwise); then times the dbrx shapes
with CUDA events in turns — gmm_wgmma, the variants, the variants
reversed, torch._grouped_mm — ``rounds`` times (2·rounds pairs a
variant), and counts the turns each candidate beats gmm_wgmma and the
shipped kernel in.  The ``diag_`` variants are timed, not checked
(``diag_no_w_load`` computes wrong sums on purpose).  ``--crossover`` does
the same at those rows per group (N = rows · 16 of a seeded top-4 routing
at dbrx's shapes) and at arctic-480b's expert shapes (~32 rows an
expert).  ``--prefill-rounds`` times chip_smoke.py's bf16 dbrx-132b
prefill (4 layers, [2, 1024]) on each variant's library in turns.  Needs a
CUDA card and nvcc.
"""
from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.kernels import _build  # noqa: E402

_SRC = open(os.path.join(_build.CSRC, "moe_dispatch.cu")).read()


def _block(start: str, end: str) -> str:
    """The shipped source from ``start`` up to (not including) ``end``."""
    a = _SRC.index(start)
    return _SRC[a:_SRC.index(end, a)]


_KERNEL = _block("// bf16 grouped GEMM on tensor cores, 128-row tiles", "// fp32 → tf32")
_LAUNCH_GRID = "  gmm_wgmma_m128<<<(row_tiles + 1) / 2 * 2 * col_tiles,"
_PLAIN_GRID = "  gmm_wgmma_m128<<<row_tiles * col_tiles,"

# the one-block form: every block loads its own w (the kernel before the
# two-block clusters were adopted)
_OWN_W = r"""// bf16 grouped GEMM on tensor cores, 128-row tiles (one block, its own w):
// block = 128 rows of one group × 256 columns; warpgroups 0-1 consume 64
// rows each with the same w stage, warp 8 produces (TMA).
__global__ void __launch_bounds__(kM128Threads, 1)
gmm_wgmma_m128(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap wmap,
               __nv_bfloat16* __restrict__ out, const int* __restrict__ offs, int G, int Kd,
               int F, int e_in, int row_tiles, int col_tiles) {
  constexpr int S = kM128Stages;
  constexpr int kWRegion = kWgBK * 128;
  int t, c, g, r0, m;
  raster(blockIdx.x, row_tiles, col_tiles, t, c);
  if (!find_tile(offs, G, kM128BM, t, g, r0, m)) return;
  extern __shared__ __align__(1024) uint8_t msmem_raw[];
  uint8_t* smem = hopper::align_smem_1024(msmem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + S * kM128StageBytes);
  uint64_t* empty = full + S;  // both consumer warpgroups are done with the stage
  const int f0 = c * kM128BN;
  const int nk = (Kd + kWgBK - 1) / kWgBK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], kM128Consumers);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (warp >= 8) {  // producer warpgroup: one thread issues every TMA load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (warp == 8 && lane == 0) {
      hopper::prefetch_tensormap(&xmap);
      hopper::prefetch_tensormap(&wmap);
      const int e = g % e_in, r = g / e_in;
      for (int i = 0; i < nk; ++i) {
        const int s = i % S;
        if (i >= S) hopper::mbar_wait(&empty[s], ((i / S) - 1) & 1);
        uint8_t* xs = smem + s * kM128StageBytes;
        uint8_t* ws = xs + kM128XBytes;
        hopper::mbar_expect_tx(&full[s], kM128StageBytes);
        hopper::tma_load_2d(xs, &xmap, &full[s], i * kWgBK, r0);
#pragma unroll
        for (int j = 0; j < kM128BN / 64; ++j)
          hopper::tma_load_4d(ws + j * kWRegion, &wmap, &full[s], f0 + 64 * j, i * kWgBK, e, r);
      }
    }
    return;
  }

  // consumers take the registers the producer gave back (40 → 232 a thread)
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  // warpgroup wg: rows 64·wg .. of the tile.  A warpgroup with no rows (a
  // group's last tile of ≤ 64 rows) only releases the stages, in a loop of
  // its own: a branch around the products inside their loop makes ptxas
  // serialize the wgmma chain (C7518).
  const int wg = warp / 4;
  if (64 * wg >= m) {
    for (int i = 0; i < nk; ++i) {
      hopper::mbar_wait(&full[i % S], (i / S) & 1);
      hopper::mbar_arrive(&empty[i % S]);
    }
    return;
  }
  // acc[64 × 256] in the wgmma accumulator layout; the products and their
  // order are gmm_wgmma<256>'s, so each output is bitwise gmm_wgmma's
  float acc[kM128BN / 2];
#pragma unroll
  for (int i = 0; i < kM128BN / 2; ++i) acc[i] = 0.f;
  for (int i = 0; i < nk; ++i) {
    const int s = i % S;
    hopper::mbar_wait(&full[s], (i / S) & 1);
    const uint8_t* xs = smem + s * kM128StageBytes;
    const uint64_t da = hopper::desc_sw128(xs + wg * (kM128XBytes / 2), 0, 1024);  // K-major
    const uint64_t db = hopper::desc_sw128(xs + kM128XBytes, kWRegion, 1024);       // MN-major
    hopper::fence_regs(acc);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kWgBK / 16; ++kk)
      hopper::wgmma_ss_n256<1>(acc, hopper::desc_add(da, 32 * kk), hopper::desc_add(db, 2048 * kk), 1);
    hopper::wgmma_commit();
    hopper::fence_regs(acc);
    hopper::wgmma_wait<1>();  // the previous stage's products are done: release it
    if (i > 0) hopper::mbar_arrive(&empty[(i - 1) % S]);
  }
  hopper::wgmma_wait<0>();
  hopper::fence_regs(acc);

  // rows 64·wg + 16·(warp % 4) + lane/4 (+8), columns 8j + 2·(lane % 4) (+1);
  // F % 8 == 0, so a column pair is in or out together; rows ≥ m belong to
  // the next group
  const int cc = 2 * (lane % 4);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = 64 * wg + 16 * (warp % 4) + lane / 4 + 8 * h;
    if (row >= m) continue;
    __nv_bfloat16* orow = out + (long long)(r0 + row) * F + f0 + cc;
#pragma unroll
    for (int j = 0; j < kM128BN / 8; ++j)
      if (f0 + 8 * j + cc < F)
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) =
            __floats2bfloat162_rn(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
  }
}

"""

# (a) persistent blocks, one per SM, each walking the raster order with a
# ring that runs on across tiles, so a tile's epilogue overlaps the next
# tile's loads; each tile's last stage is released before its store.  The
# walk covers only the row tiles that hold rows (offs[2G + 1]).
_PERSISTENT = r"""// bf16 grouped GEMM on tensor cores, 128-row tiles, persistent blocks
__global__ void __launch_bounds__(kM128Threads, 1)
gmm_wgmma_m128(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap wmap,
               __nv_bfloat16* __restrict__ out, const int* __restrict__ offs, int G, int Kd,
               int F, int e_in, int row_tiles, int col_tiles) {
  constexpr int S = kM128Stages;
  constexpr int kWRegion = kWgBK * 128;
  extern __shared__ __align__(1024) uint8_t msmem_raw[];
  uint8_t* smem = hopper::align_smem_1024(msmem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + S * kM128StageBytes);
  uint64_t* empty = full + S;
  const int nk = (Kd + kWgBK - 1) / kWgBK;
  const int used = offs[2 * G + 1];  // the row tiles that hold rows
  const int tiles = used * col_tiles;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], kM128Consumers);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();
  if (warp >= 8) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (warp == 8 && lane == 0) {
      hopper::prefetch_tensormap(&xmap);
      hopper::prefetch_tensormap(&wmap);
      int it = 0;
      for (int b = blockIdx.x; b < tiles; b += gridDim.x) {
        int t, c, g, r0, m;
        raster(b, used, col_tiles, t, c);
        if (!find_tile(offs, G, kM128BM, t, g, r0, m)) continue;
        const int e = g % e_in, r = g / e_in, f0 = c * kM128BN;
        for (int i = 0; i < nk; ++i, ++it) {
          const int s = it % S;
          if (it >= S) hopper::mbar_wait(&empty[s], ((it / S) - 1) & 1);
          uint8_t* xs = smem + s * kM128StageBytes;
          uint8_t* ws = xs + kM128XBytes;
          hopper::mbar_expect_tx(&full[s], kM128StageBytes);
          hopper::tma_load_2d(xs, &xmap, &full[s], i * kWgBK, r0);
#pragma unroll
          for (int j = 0; j < kM128BN / 64; ++j)
            hopper::tma_load_4d(ws + j * kWRegion, &wmap, &full[s], f0 + 64 * j, i * kWgBK, e, r);
        }
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int wg = warp / 4;
  const int cc = 2 * (lane % 4);
  int it = 0;
  for (int b = blockIdx.x; b < tiles; b += gridDim.x) {
    int t, c, g, r0, m;
    raster(b, used, col_tiles, t, c);
    if (!find_tile(offs, G, kM128BM, t, g, r0, m)) continue;
    const int f0 = c * kM128BN;
    if (64 * wg >= m) {
      for (int i = 0; i < nk; ++i, ++it) {
        hopper::mbar_wait(&full[it % S], (it / S) & 1);
        hopper::mbar_arrive(&empty[it % S]);
      }
      continue;
    }
    float acc[kM128BN / 2];
#pragma unroll
    for (int i = 0; i < kM128BN / 2; ++i) acc[i] = 0.f;
    for (int i = 0; i < nk; ++i, ++it) {
      const int s = it % S;
      hopper::mbar_wait(&full[s], (it / S) & 1);
      const uint8_t* xs = smem + s * kM128StageBytes;
      const uint64_t da = hopper::desc_sw128(xs + wg * (kM128XBytes / 2), 0, 1024);
      const uint64_t db = hopper::desc_sw128(xs + kM128XBytes, kWRegion, 1024);
      hopper::fence_regs(acc);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kWgBK / 16; ++kk)
        hopper::wgmma_ss_n256<1>(acc, hopper::desc_add(da, 32 * kk), hopper::desc_add(db, 2048 * kk), 1);
      hopper::wgmma_commit();
      hopper::fence_regs(acc);
      hopper::wgmma_wait<1>();
      if (i > 0) hopper::mbar_arrive(&empty[(it - 1) % S]);
    }
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc);
    hopper::mbar_arrive(&empty[(it - 1) % S]);  // the tile's last stage
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = 64 * wg + 16 * (warp % 4) + lane / 4 + 8 * h;
      if (row >= m) continue;
      __nv_bfloat16* orow = out + (long long)(r0 + row) * F + f0 + cc;
#pragma unroll
      for (int j = 0; j < kM128BN / 8; ++j)
        if (f0 + 8 * j + cc < F)
          *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) =
              __floats2bfloat162_rn(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
    }
  }
}

"""
_PERSISTENT_GRID = ("  int sms = 132, dev = 0;\n"
                    "  cudaGetDevice(&dev);\n"
                    "  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);\n"
                    "  gmm_wgmma_m128<<<row_tiles * col_tiles < sms ? row_tiles * col_tiles : sms,")

# (b) a two-block cluster over two column tiles of one row tile: each block
# loads 64 of the tile's 128 x rows and multicasts them to both; a stage is
# free when both blocks' consumer warpgroups are done with it (one arrival
# a warpgroup on each block's barrier).  The column tiles are padded to an
# even count (a padded tile's w is TMA's zero fill; its stores are masked).
_MC2D = r"""
// the 2-D form of hopper::tma_load_4d_multicast
__device__ __forceinline__ void tma_load_2d_mc(void* dst, const CUtensorMap* map, uint64_t* bar,
                                               int c0, int c1, uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1, {%3, %4}], [%2], %5;\n" ::"r"(hopper::smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(hopper::smem_u32(bar)), "r"(c0), "r"(c1),
      "h"(mask)
      : "memory");
}
"""
_CLUSTER_X = r"""
// bf16 grouped GEMM on tensor cores, 128-row tiles, x multicast in a pair
__global__ void __cluster_dims__(2, 1, 1) __launch_bounds__(kM128Threads, 1)
gmm_wgmma_m128(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap wmap,
               __nv_bfloat16* __restrict__ out, const int* __restrict__ offs, int G, int Kd,
               int F, int e_in, int row_tiles, int col_tiles) {
  constexpr int S = kM128Stages;
  constexpr int kWRegion = kWgBK * 128;
  int t, c, g, r0, m;
  raster(blockIdx.x, row_tiles, col_tiles, t, c);
  if (!find_tile(offs, G, kM128BM, t, g, r0, m)) return;  // both blocks of a pair
  extern __shared__ __align__(1024) uint8_t msmem_raw[];
  uint8_t* smem = hopper::align_smem_1024(msmem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + S * kM128StageBytes);
  uint64_t* empty = full + S;
  const uint32_t rank = hopper::cluster_ctarank(), peer = rank ^ 1u;
  const int f0 = c * kM128BN;
  const int nk = (Kd + kWgBK - 1) / kWgBK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 4);  // 2 blocks × 2 consumer warpgroups
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();
  hopper::cluster_sync();  // the peer's barriers exist before any multicast lands
  if (warp >= 8) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (warp == 8 && lane == 0) {
      hopper::prefetch_tensormap(&xmap);
      hopper::prefetch_tensormap(&wmap);
      const int e = g % e_in, r = g / e_in;
      for (int i = 0; i < nk; ++i) {
        const int s = i % S;
        if (i >= S) hopper::mbar_wait(&empty[s], ((i / S) - 1) & 1);
        uint8_t* xs = smem + s * kM128StageBytes;
        uint8_t* ws = xs + kM128XBytes;
        hopper::mbar_expect_tx(&full[s], kM128StageBytes);
        tma_load_2d_mc(xs + rank * (kM128XBytes / 2), &xmap, &full[s], i * kWgBK,
                       r0 + 64 * rank, 0x3);
#pragma unroll
        for (int j = 0; j < kM128BN / 64; ++j)
          hopper::tma_load_4d(ws + j * kWRegion, &wmap, &full[s], f0 + 64 * j, i * kWgBK, e, r);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int wg = warp / 4;
    const bool live = 64 * wg < m;
    const bool signal = threadIdx.x % 128 == 0;
    auto release = [&](int s) {
      hopper::mbar_arrive_cluster(&empty[s], rank, signal);
      hopper::mbar_arrive_cluster(&empty[s], peer, signal);
    };
    if (!live) {
      for (int i = 0; i < nk; ++i) {
        hopper::mbar_wait(&full[i % S], (i / S) & 1);
        release(i % S);
      }
    } else {
      float acc[kM128BN / 2];
#pragma unroll
      for (int i = 0; i < kM128BN / 2; ++i) acc[i] = 0.f;
      for (int i = 0; i < nk; ++i) {
        const int s = i % S;
        hopper::mbar_wait(&full[s], (i / S) & 1);
        const uint8_t* xs = smem + s * kM128StageBytes;
        const uint64_t da = hopper::desc_sw128(xs + wg * (kM128XBytes / 2), 0, 1024);
        const uint64_t db = hopper::desc_sw128(xs + kM128XBytes, kWRegion, 1024);
        hopper::fence_regs(acc);
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kWgBK / 16; ++kk)
          hopper::wgmma_ss_n256<1>(acc, hopper::desc_add(da, 32 * kk), hopper::desc_add(db, 2048 * kk), 1);
        hopper::wgmma_commit();
        hopper::fence_regs(acc);
        hopper::wgmma_wait<1>();
        if (i > 0) release((i - 1) % S);
      }
      hopper::wgmma_wait<0>();
      hopper::fence_regs(acc);
      const int cc = 2 * (lane % 4);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = 64 * wg + 16 * (warp % 4) + lane / 4 + 8 * h;
        if (row >= m) continue;
        __nv_bfloat16* orow = out + (long long)(r0 + row) * F + f0 + cc;
#pragma unroll
        for (int j = 0; j < kM128BN / 8; ++j)
          if (f0 + 8 * j + cc < F)
            *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) =
                __floats2bfloat162_rn(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      }
    }
  }
  hopper::cluster_sync();  // no block leaves while its peer may still arrive on its barriers
}

"""
# cluster_x's launch: each block loads 64 rows (gmm_wgmma's x box); the
# clusters pair column tiles, so there are an even number of them
_CLUSTER_X_BOX = ("  int err = hopper::encode_bf16_map(&xmap, x, 2, xdims, xstr, kM128XBox);",
                  "  int err = hopper::encode_bf16_map(&xmap, x, 2, xdims, xstr, kWgXBox);")
_CLUSTER_X_GRID = (
    "  const int col_tiles = (F + kM128BN - 1) / kM128BN;\n"
    "  // two-block clusters over pairs of row tiles: the row tiles rounded up to even\n"
    "  gmm_wgmma_m128<<<(row_tiles + 1) / 2 * 2 * col_tiles,",
    "  const int col_tiles = ((F + kM128BN - 1) / kM128BN + 1) / 2 * 2;  // pairs\n"
    "  gmm_wgmma_m128<<<row_tiles * col_tiles,")
_OWN_X = ("        tma_load_2d_mc(xs + rank * (kM128XBytes / 2), &xmap, &full[s], i * kWgBK,\n"
          "                       r0 + 64 * rank, 0x3);",
          "        hopper::tma_load_2d(xs, &xmap, &full[s], i * kWgBK, r0);")

VARIANTS = {
    "shipped": [],
    "own_w": [(_KERNEL, _OWN_W), (_LAUNCH_GRID, _PLAIN_GRID)],
    "persistent": [(_KERNEL, _PERSISTENT), (_LAUNCH_GRID, _PERSISTENT_GRID)],
    "cluster_x": [(_KERNEL, _MC2D + _CLUSTER_X), _CLUSTER_X_BOX, _CLUSTER_X_GRID],
    # diagnostics that split the candidates' costs: the persistent kernel at
    # a block a tile (its code, not its schedule); the one-block form
    # launched in two-block clusters (the cluster schedule alone); cluster_x
    # with each block loading its whole x tile itself (the pair's coupled
    # ring and remote arrivals without the multicast)
    "diag_persistent_code": [(_KERNEL, _PERSISTENT), (_LAUNCH_GRID, _PLAIN_GRID)],
    "diag_cluster_launch": [
        (_KERNEL, _OWN_W.replace(
            "__global__ void __launch_bounds__(kM128Threads, 1)\ngmm_wgmma_m128(",
            "__global__ void __cluster_dims__(2, 1, 1) __launch_bounds__(kM128Threads, 1)\n"
            "gmm_wgmma_m128(")),
        (_LAUNCH_GRID, "  gmm_wgmma_m128<<<(row_tiles * col_tiles + 1) / 2 * 2,")],
    "diag_cluster_x_own_x": [(_KERNEL, _CLUSTER_X.replace(*_OWN_X)), _CLUSTER_X_GRID],
    # the shipped kernel with a cluster-scope release on every arrival
    # through hopper::mbar_arrive_cluster (the first cluster forms had it)
    "diag_release_cluster": [("hopper.cuh", "@p mbarrier.arrive.shared::cluster.b64",
                              "@p mbarrier.arrive.release.cluster.shared::cluster.b64")],
    # w's tiles not loaded: the stage carries x alone (16 of its 48 KB), all
    # the tensor work kept — if the L2 feed binds, this runs well under
    # the shipped kernel
    "diag_no_w_load": [("        hopper::mbar_expect_tx(&full[s], kM128StageBytes);",
                        "        hopper::mbar_expect_tx(&full[s], kM128XBytes);"),
                       ("        if (share) {\n", "        if (false) {\n"),
                       ("          for (int j = 0; j < kM128BN / 64; ++j)\n"
                        "            hopper::tma_load_4d(ws + j * kWRegion",
                        "          for (int j = 0; j < 0; ++j)\n"
                        "            hopper::tma_load_4d(ws + j * kWRegion")],
}

# ragged groups for the 128-row kernel (tests/test_torch_moe.py's M128_CASES)
RAGGED = [([1, 0, 127, 128, 129, 385, 640], 136, 520), ([128, 128], 64, 256),
          ([129, 255, 0, 200], 512, 768), ([300, 0, 260], 6144, 1000)]
# launch_geometry's threshold (rows per group on average) set so that every
# aligned bf16 call of 16 rows a group or more runs gmm_wgmma_m128, or none does
M128_FROM_16, M128_NEVER = 16, 1 << 30


def start_build(name: str, subs):
    """Write the patched copy and start its nvcc (every source of the
    package's library, so a prefill runs on it too); returns (name,
    process, lib path).  A substitution (old, new) patches moe_dispatch.cu,
    (file, old, new) another file of csrc/."""
    d = os.path.join(ROOT, "build", "gmm_wgmma_variants", name)
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(_build.CSRC, d)
    for sub in subs:
        fname, old, new = sub if len(sub) == 3 else ("moe_dispatch.cu", *sub)
        src = open(os.path.join(d, fname)).read()
        if old not in src:
            raise SystemExit(f"{name}: {fname} no longer holds {old[:80]!r}")
        open(os.path.join(d, fname), "w").write(src.replace(old, new))
    out = os.path.join(d, "lib.so")
    i = _build.NVCC_FLAGS.index("-I")
    flags = _build.NVCC_FLAGS[:i] + _build.NVCC_FLAGS[i + 2:]
    cmd = [_build.nvcc(), *flags, "-shared", "-I", d, "-Xptxas", "-v", "-o", out,
           *(os.path.join(d, src.name) for src in _build.sources())]
    return name, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                  text=True), out


def finish_build(name: str, proc, out: str):
    """Wait for the build; print ptxas's report of the 128-row kernel; the
    loaded library, or None if nvcc failed."""
    text = proc.communicate()[0]
    if proc.returncode:
        print(f"{name}: nvcc failed, skipped\n{text[-3000:]}")
        return None
    lines = text.splitlines()
    for j, line in enumerate(lines):
        if "gmm_wgmma_m128" in line and "Function properties" in line:
            print(f"{name}: {lines[j + 1].strip()}; {lines[j + 2].strip()}")
        if "gmm_wgmma" in line and ("C75" in line or "serialized" in line):
            print(f"{name}: ptxas: {line.strip()}")
    lib = ctypes.CDLL(out)
    for fn, (restype, argtypes) in _build._SIGNATURES.items():
        getattr(lib, fn).restype, getattr(lib, fn).argtypes = restype, argtypes
    return lib


@contextlib.contextmanager
def on(md, lib, rows: int):
    """Calls through ``lib`` with ``md.ROWS_PER_GROUP_M128`` set to ``rows``."""
    load, threshold = _build.load, md.ROWS_PER_GROUP_M128
    _build.load, md.ROWS_PER_GROUP_M128 = (lambda: lib), rows
    try:
        yield
    finally:
        _build.load, md.ROWS_PER_GROUP_M128 = load, threshold


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


def routed(T: int, E: int, k: int, seed: int):
    import numpy as np
    top = np.argsort(-np.random.default_rng(seed).standard_normal((T, E)), axis=-1,
                     kind="stable")[:, :k]
    return np.bincount(top.ravel(), minlength=E)


def check(name, md, ref, lib, x, w, sizes, label, res) -> None:
    """The variant's 128-row kernel against the plain version and, bitwise,
    against gmm_wgmma on the same values (the shipped library)."""
    import torch
    with on(md, lib, M128_FROM_16):
        before = md.variant_launches["gmm_wgmma_m128"]
        got = md.grouped_matmul(x, w, sizes)
        if md.variant_launches["gmm_wgmma_m128"] != before + 1:
            raise SystemExit(f"{name}: {label} did not run gmm_wgmma_m128")
    with on(md, SHIPPED(), M128_NEVER):
        base = md.grouped_matmul(x, w, sizes)
    want = ref.grouped_matmul_ref(x, w, sizes)
    diff = (got.float() - want.float()).abs()
    ok = bool((diff <= 1e-4 + 2 ** -7 * want.float().abs()).all())
    same = bool(torch.equal(got, base))
    res[f"{name}/{label}/err"] = float(diff.max())
    res[f"{name}/{label}/bitwise_gmm_wgmma"] = same
    print(f"{name}: {label}: max_abs_err {float(diff.max()):.3g} (within 1e-4 + 2^-7·|want|: "
          f"{ok}); bitwise gmm_wgmma: {same}", flush=True)
    if not ok:
        raise SystemExit(f"{name}: disagrees with the plain version at {label}")


SHIPPED = _build.load


def median(v):
    return sorted(v)[len(v) // 2]


def compare(res: dict, name: str, base: str, key: str) -> None:
    """How often, turn by turn, ``name`` beat ``base`` at ``key`` (the same
    turn times both on the same values), and the median ratio."""
    a, b = res.get(f"{name}/{key}"), res.get(f"{base}/{key}")
    if a and b:
        wins = sum(x < y for x, y in zip(a, b))
        print(f"{name}/{key}: faster than {base} in {wins} of {len(a)} turns, median "
              f"{median(a):.4f} against {median(b):.4f} ms, median ratio "
              f"{median([x / y for x, y in zip(a, b)]):.3f}")


def prefill_ab(md, libs: dict, rounds: int, res: dict) -> None:
    """The bf16 dbrx-132b prefill of chip_smoke.py (4 of 40 layers at full
    width, [2, 1024], weights from seed 0) on each library in turns (the
    libraries, then reversed), ``rounds`` times; ms a prefill by CUDA events,
    the median of 3 a turn.  The outputs must be bitwise the same on every
    library, and every K5 launch gmm_wgmma_m128."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.tree import tree_map
    dev = torch.device("cuda")
    cfg = dataclasses.replace(get_config("dbrx-132b"), n_layers=4)
    params = M.init_params(cfg, generator=torch.Generator(device=dev).manual_seed(0),
                           dtype=torch.bfloat16, device=dev)
    params = tree_map(lambda x: x[None], params)
    g = torch.Generator(device=dev).manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (1, 2, 1024), generator=g, device=dev)}
    names = list(libs)
    first = {}
    with torch.no_grad():
        for name in names:
            with on(md, libs[name], md.ROWS_PER_GROUP_M128):
                M.prefill_step(cfg, params, batch)                  # warm-up
                md.zero_launches()
                s, logits, _ = M.prefill_step(cfg, params, batch)
                torch.cuda.synchronize()
                k5 = dict(md.variant_launches)
            if k5["gmm_wgmma_m128"] != 3 * cfg.n_layers or sum(k5.values()) != 3 * cfg.n_layers:
                raise SystemExit(f"prefill on {name}: K5 launches {k5}")
            if first and not (torch.equal(s, first["s"]) and torch.equal(logits, first["l"])):
                raise SystemExit(f"prefill on {name}: outputs differ from {names[0]}'s")
            first = first or {"s": s, "l": logits}
        print(f"prefill: bf16 dbrx-132b, 4 layers, [2, 1024]: outputs bitwise the same on "
              f"{names}; K5 launches {k5}", flush=True)

        def timed(name) -> float:
            ms = []
            with on(md, libs[name], md.ROWS_PER_GROUP_M128):
                for _ in range(3):
                    ms.append(event_ms(lambda: M.prefill_step(cfg, params, batch), 1))
            return median(ms)

        for _ in range(rounds):
            for order in (names, names[::-1]):
                for name in order:
                    res.setdefault(f"{name}/prefill", []).append(timed(name))
    for name in names:
        print(f"{name}/prefill: {res[f'{name}/prefill']}")
        if name != names[0]:
            compare(res, name, names[0], "prefill")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--crossover", default="16,32,64,96,128,256")
    ap.add_argument("--prefill-rounds", type=int, default=0)
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "gmm_wgmma_variants",
                                                  "results.json"))
    args = ap.parse_args()
    import torch
    from repro_torch import disable_tf32
    from repro_torch.kernels import moe_dispatch as md
    from repro_torch.kernels import ref
    if not torch.cuda.is_available():
        print("gmm_wgmma_variants: needs a CUDA card", file=sys.stderr)
        return 1
    disable_tf32()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi)
    started = [start_build(name, VARIANTS[name]) for name in args.variants.split(",")]
    libs = {name: finish_build(name, proc, out) for name, proc, out in started}
    libs = {name: lib for name, lib in libs.items() if lib is not None}
    names = list(libs)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(7)
    randn = lambda shape, scale=1.0: torch.randn(shape, generator=g, device=dev).mul_(
        scale).to(torch.bfloat16)
    E, d, ff = 16, 6144, 10752
    sizes = torch.as_tensor(routed(2048, E, 4, 1)).to(dev)
    shapes = {"gate": (randn((8192, d)), randn((E, d, ff), d ** -0.5)),
              "down": (randn((8192, ff)), randn((E, ff, d), ff ** -0.5))}
    res: dict = {"device": smi}
    for name, lib in libs.items():
        if name.startswith("diag_"):
            continue
        for gs, Kd, F in RAGGED:
            x, w = randn((sum(gs), Kd)), randn((len(gs), Kd, F), Kd ** -0.5)
            check(name, md, ref, lib, x, w, torch.tensor(gs, device=dev),
                  f"ragged {gs} Kd={Kd} F={F}", res)
        R, L = 4, 2
        stack = randn((R, L, E, 128, 512), 128 ** -0.5)
        ks = torch.randint(128, 200, (R * E,), generator=g, device=dev)
        check(name, md, ref, lib, randn((int(ks.sum()), 128)), stack[:, 1], ks,
              "kfold 4x16 strided", res)
        for label, (x, w) in shapes.items():
            check(name, md, ref, lib, x, w, sizes, f"dbrx {label}", res)

    def turn(label, x, w, sz, order):
        """gmm_wgmma (the shipped library), each variant's gmm_wgmma_m128 in
        ``order``, torch._grouped_mm: one time each on the same values."""
        with on(md, SHIPPED(), M128_NEVER):
            res.setdefault(f"gmm_wgmma/{label}", []).append(
                event_ms(lambda: md.grouped_matmul(x, w, sz), args.iters))
        for name in order:
            with on(md, libs[name], M128_FROM_16):
                res.setdefault(f"{name}/{label}", []).append(
                    event_ms(lambda: md.grouped_matmul(x, w, sz), args.iters))
        if hasattr(torch, "_grouped_mm"):
            o = torch.cumsum(sz, 0).to(torch.int32)
            res.setdefault(f"torch._grouped_mm/{label}", []).append(event_ms(
                lambda: torch._grouped_mm(x, w, offs=o, out_dtype=x.dtype), args.iters))

    def turns(label, x, w, sz):
        for _ in range(args.rounds):
            for order in (names, names[::-1]):
                turn(label, x, w, sz, order)

    for label, (x, w) in shapes.items():
        turns(label, x, w, sizes)
    # the crossover: each variant's 128-row kernel against gmm_wgmma at
    # rows per group from 16 up (N = rows · 16 of a seeded top-4 routing at
    # dbrx's shapes), then at arctic-480b's expert shapes (128 experts,
    # top-2 of 2048 tokens: ~32 rows an expert; d 7168, d_ff 4864)
    keys = list(shapes)
    for rpg in (int(v) for v in args.crossover.split(",") if v):
        sz = torch.as_tensor(routed(rpg * E // 4, E, 4, 2)).to(dev)
        n = int(sz.sum())
        for label, (x, w) in shapes.items():
            turns(f"{label}@{rpg}", x[:n].contiguous(), w, sz)
            keys.append(f"{label}@{rpg}")
    del shapes
    if args.crossover:
        Ea, da, ffa = 128, 7168, 4864
        sz = torch.as_tensor(routed(2048, Ea, 2, 3)).to(dev)
        for label, Kd, F in (("arctic gate", da, ffa), ("arctic down", ffa, da)):
            x, w = randn((4096, Kd)), randn((Ea, Kd, F), Kd ** -0.5)
            turns(label, x, w, sz)
            keys.append(label)
            del x, w
        torch.cuda.empty_cache()
    for key, val in res.items():
        print(f"{key}: {val}")
    for key in keys:
        for name in names:
            compare(res, name, "gmm_wgmma", key)
            if name != "shipped":
                compare(res, name, "shipped", key)
        compare(res, "torch._grouped_mm", "gmm_wgmma", key)
    if args.prefill_rounds:
        prefill_ab(md, {n: libs[n] for n in names if not n.startswith("diag_")},
                   args.prefill_rounds, res)
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    json.dump(res, open(args.out, "w"), indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
