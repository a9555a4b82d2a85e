// K5 grouped_matmul for Hopper (sm_90a), with a plain C interface that
// Python loads through ctypes (kernels/_build.py builds it with
// coda_kernels.cu and flash_attention.cu into one library).
//
//   grouped_matmul  replaces repro/kernels/moe_dispatch.py::grouped_matmul
//                   (Pallas, pallas_call at :87)
//
// What it computes: the ragged grouped GEMM of the sorted dropless MoE
// dispatch, out[i] = x[i] @ w[g(i)], for rows of x [N, Kd] sorted by group,
// w's groups [Kd, F] each, and group_sizes [G] (int32, on the device) giving
// the row segments.  Sums are fp32 (fp32 inputs: FFMA in gmm_rows and
// gmm_tiles, split TF32 on tensor cores in gmm_tf32x3 — never one TF32
// product; bf16 inputs: exact bf16 products summed in fp32, on tensor cores
// where gmm_wgmma runs); inputs are fp32 or bf16 (x and w of one dtype);
// out [N, F] is in x's dtype.
//
// Weights are read in place through their strides.  Group g is
// (g / e_in, g % e_in) of a [R, E = e_in, Kd, F] view — the layer slice of
// a stacked [K, L, E, d, ff] leaf, with the K workers folded into K·E
// groups — or g of a [G, Kd, F] tensor (e_in = G).  F must be the unit-
// stride axis.  Nothing is padded or copied: the TPU kernel pads x and w
// (jnp.pad into wp, moe_dispatch.py:83-85); here the kernel masks the
// ragged row, Kd and F edges itself.
//
// Design.
//  1. gmm_offsets (one block): an exclusive scan of group_sizes in shared
//     memory, writing each group's first row and first row tile to a small
//     scratch buffer.  The sizes never go to the host.
//  2. The GEMM grid is static: x = round_up(N, BM)/BM + min(G, N) row tiles
//     (the reference's grouped_layout bound, ref.py:138), y = F tiles.  A
//     block finds its group by a binary search over the tile starts; tiles
//     past the last group exit; no tile mixes two groups.
//  3. Five kernels, chosen on the host from static facts only — dtype,
//     alignment and the average rows per group
//     (kernels/moe_dispatch.py::launch_geometry): for aligned bf16
//     gmm_wgmma_m128 at 64 rows per group or more and gmm_wgmma below;
//     else gmm_rows under 16 rows per group; else gmm_tf32x3 for aligned
//     fp32 (4, below) and gmm_tiles for what TMA cannot read (fp32 or bf16
//     with Kd, F or a stride off 16 bytes, or a base off 16).
//     - gmm_wgmma (bf16 x and w, Kd and F multiples of 8, every base and
//       stride 16-byte aligned; any N): bf16 tensor cores.  A block owns one
//       64-row tile inside one group and BN = 128 (decode) or 256 (prefill)
//       output columns.  One producer warp keeps a ring of 4–5 stages full
//       with TMA: the x rows through a 2-D map that starts at the tile's
//       first row (rows past the group's end are loaded and discarded), the
//       weights through a 4-D map over the strided [R, E, Kd, F] view (the
//       K workers folded into the groups, nothing copied; MN-major, 128-byte
//       swizzle).  One consumer warpgroup runs m64nBNk16 wgmma with fp32
//       accumulators and rounds once to bf16 at the store, rows < m only,
//       with register stores (the rows past m belong to the next group).
//       Both regimes are bound by the weight bytes (a 64-row tile does 64
//       operations per weight byte read at most, under the 295 the tensor
//       cores need): at decode, 8 hit experts × 38 column tiles of 128 give
//       ~300 blocks of 1.8 MB each, two blocks per SM with 4 stages of
//       16 KB of weights in flight each, so every SM keeps ~128 KB of loads
//       in flight without split-K; at prefill the 256-column tile halves the
//       x re-reads and the block count.
//     - gmm_wgmma_m128 (what gmm_wgmma takes, at ≥ 64 rows per group on
//       average: the bf16 dbrx prefill, ~512 rows an expert).  There the
//       tensor cores could bound the call (~1.1 ms at dbrx's shapes), but a
//       64-row tile re-reads the whole w column block from L2 every 64 rows:
//       ~22.5 GB a call from L2 into shared memory, more than L2 feeds at
//       the tensor-core rate, so gmm_wgmma ran at a third of the bound.  A
//       block owns 128 rows × 256 columns: two consumer warpgroups run
//       m64n256k16 on 64 rows each with one shared w stage (~14.3 GB a
//       call), a 4-stage ring of 48 KB stages (16 KB of x through a
//       128-row box, 32 KB of w through gmm_wgmma's 4-D map; 197,696 B), a
//       stage released when both warpgroups are done with it; a producer
//       warpgroup (setmaxnreg 40, the consumers 232 for their 128
//       accumulators) whose one thread issues the loads.  Two blocks form a
//       cluster over row tiles 2p and 2p + 1 of one column tile: where both
//       lie in one group they need the same w, so each loads half of it and
//       multicasts it to both (~9.5 GB a call where every pair shares), and a
//       stage is free when both blocks' consumers are done with it; a pair
//       that straddles a group boundary loads its own w.  Each consumer's
//       products and their order are gmm_wgmma<256>'s, so the outputs are
//       bitwise gmm_wgmma's.  A warpgroup whose 64 rows all lie past the
//       group's end only releases the stages (in a loop of its own: a
//       branch inside the product loop serializes the wgmma chain).
//       Measured against the one-block form and the other candidates in
//       scripts/gmm_wgmma_variants.py (PERF.md); there, below 64 rows per
//       group most groups fit one 64-row tile, w is read once either way,
//       and gmm_wgmma is 1-2 % faster; from 64 rows this kernel is ahead.
//     - gmm_rows (the other decode calls: under 16 rows per group on
//       average): 8-row tiles, the x tile in shared memory, each thread
//       streaming one output column's weights straight from device memory
//       into registers, 16 K-steps of loads in flight before their FMAs;
//       128-column blocks, so that even 8 hit experts give a few blocks per
//       SM.  Each hit expert's weights are read once per 8 rows: bound by
//       the bytes of the hit experts' weights.
//     - gmm_tiles (prefill calls that TMA cannot read): 128×128 output
//       tiles, 256 threads with 8×8 outputs each (two 4-row by two 4-column
//       float4 slices, so shared-memory reads are float4 and conflict-free),
//       16-deep K tiles in a 3-stage cp.async ring: x transposed into shared
//       memory by 4-byte copies, w by 16-byte copies where F and the strides
//       allow, masked zero-filling copies at the ragged edge; bf16 inputs
//       are loaded through registers and stored as fp32.  fp32 FFMA, so
//       bound by the 67 TFLOP/s fp32 rate (16.15 ms at dbrx's prefill shape,
//       1.08 TFLOP; it took ~25 ms there).
//     The tile kernels walk their (row tile, column tile) grid in groups of
//     8 column tiles, columns fastest inside a group, so the blocks in
//     flight share x rows and each expert's weights in L2.
//     The Pallas kernel holds the whole padded Kd of a 128-row tile in VMEM;
//     at dbrx's d_ff that is 5.5 MB, far past 227 KB of shared memory, so
//     every kernel loops over Kd in tiles.
//  4. gmm_tf32x3 (fp32 x and w, Kd, F and every stride of w multiples of 4
//     elements, both bases 16-byte aligned, ≥ 16 rows per group on average:
//     the fp32 dbrx prefill) runs fp32 on the TF32 tensor cores as split
//     TF32 ("3xTF32", as flash_fwd_tf32x3 in flash_attention.cu): each
//     operand v = big + small, big = tf32(v), small = tf32(v − big), both
//     rounded to nearest (ties away), and x·w ≈ x_small·w_big + x_big·w_small
//     + x_big·w_big, each product of two tf32 values exact.  What is dropped
//     — x_small·w_small and the rounding of the small parts — is at most
//     3·2^-22 of |x·w| a product, under fp32 FFMA's own rounding over a sum
//     of thousands; one TF32 product (2^-11) would not meet the fp32
//     tolerances (GMM_TOL 5e-5, the prefill's 1e-5 / 1e-4).  The tensor
//     cores truncate as they accumulate (flash_attention.cu, the accuracy
//     bullet of flash_fwd_tf32x3's note: the error grows with the chain),
//     so each 32-deep stage's products go into a fresh fragment that is
//     added to the output's fp32 registers with round to nearest: the
//     truncating chain is 12 products long whatever Kd.  Its bound is 3 × 2·M·Kd·F
//     operations at 495 TFLOP/s (6.56 ms at dbrx's prefill shape), or the
//     bytes of x, the hit experts' weights and out (~1.4 ms there).
//     The layout trap: tf32 wgmma reads shared-memory operands K-major only
//     (no transpose bit), and a group's w block [Kd, F] is F-major.  So the
//     kernel computes the transposed product, outᵀ = wᵀ·xᵀ: wgmma's M is
//     output columns, its N is x rows (x is K-major as stored), and A = wᵀ
//     comes from registers — each consumer thread loads its fragment from
//     the TMA-landed w tile with 8-byte reads and splits it there, so w is
//     never rewritten in shared memory.  Accumulator row r of a warp is
//     column 2r (r < 8) or 2(r − 8) + 1, and fragment column c is k = 2c or
//     2(c − 4) + 1 of the 8-wide slice, so a thread's two columns are
//     adjacent (one 8-byte load a k, one 8-byte store an x row) and a phase
//     of loads hits 8 distinct chunks of the 128-byte swizzle (no bank
//     conflict); x's slices are stored in the same k order.  Block: 128 x
//     rows of one group (wgmma's N) × 128 columns, two consumer warpgroups of 64
//     columns (setmaxnreg 232: the output, the fresh fragment and the split
//     w fragment hold ~170 registers), and a producer warpgroup (setmaxnreg
//     40): warp 8 streams x (a 2-D map that starts at the tile's first row)
//     and w (the 4-D map over the strided [R, E, Kd, F] view, gmm_wgmma's)
//     by TMA into a 4-stage ring of 48 KB stages (x, x_small, w; 197,728 B);
//     warps 9-11 round each x tile in place to x_big, permuted as above,
//     and write x_small beside it (16-byte accesses, a stage ahead of the
//     consumers), fence to the async proxy and arrive on the stage's ready
//     barrier.  Rows < m only are stored, with register stores (the rows
//     past m belong to the next group).  What limits it on the card is in
//     PERF.md (the split's CUDA-core work, shared-memory bandwidth or the
//     wgmma issue rate: it cannot be read without ncu).
//
// Every entry point launches on the caller's stream, allocates nothing, does
// not synchronise, and returns cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

constexpr int kScanThreads = 1024;
constexpr int kMaxGroups = 4 * kScanThreads;

// gmm_rows: 8-row tiles, 128 threads × 1 column = 128 columns per block
constexpr int kRowsBM = 8;
constexpr int kRowsThreads = 128;
constexpr int kRowsTN = 1;
constexpr int kRowsBK = 64;
constexpr int kRowsUnroll = 16;
// gmm_tiles: 128×128 tiles, 256 threads × (8 rows × 8 columns), K tiles of
// 16 in a 3-stage cp.async ring
constexpr int kTileBM = 128;
constexpr int kTileBN = 128;
constexpr int kTileBK = 16;
constexpr int kTileThreads = 256;
constexpr int kTileStages = 3;
constexpr int kTileLdA = kTileBM + 4;  // padded row of the transposed x tile
constexpr int kTileStageFloats = kTileBK * kTileLdA + kTileBK * kTileBN;
constexpr int kTileSmemBytes = kTileStages * kTileStageFloats * 4;
// gmm_wgmma: 64-row tiles, BN = 128 or 256 columns, K tiles of 64 (one
// 128-byte swizzle row of x), one consumer warpgroup + one producer warp
constexpr int kWgBM = 64;
constexpr int kWgBK = 64;
constexpr int kWgThreads = 160;
constexpr int kRasterGroup = 8;  // column tiles walked together
// the tensor maps' boxes: x 64 columns (one 128-byte row) × 64 rows; w 64
// columns × 64 k-rows of one group
constexpr uint32_t kWgXBox[2] = {kWgBK, kWgBM};
constexpr uint32_t kWgWBox[4] = {64, kWgBK, 1, 1};
// gmm_wgmma_m128: 128-row tiles × 256 columns, K tiles of 64, two consumer
// warpgroups of 64 rows sharing each w stage, a producer warpgroup; a
// 4-stage ring of 48 KB stages (16 KB of x, 32 KB of w)
constexpr int kM128BM = 128;
constexpr int kM128BN = 256;
constexpr int kM128Stages = 4;
constexpr int kM128Threads = 384;
constexpr int kM128Consumers = 256;
constexpr int kM128XBytes = kM128BM * kWgBK * 2;
constexpr int kM128WBytes = kWgBK * kM128BN * 2;
constexpr int kM128StageBytes = kM128XBytes + kM128WBytes;
// the ring, a full and an empty barrier per stage, 1 KB of alignment slack
constexpr int kM128SmemBytes = kM128Stages * (kM128StageBytes + 16) + 1024;
// x's box: 64 columns (one 128-byte row) × 128 rows; w's is gmm_wgmma's
constexpr uint32_t kM128XBox[2] = {kWgBK, kM128BM};
static_assert(kM128SmemBytes <= 232448, "a block's shared memory on Hopper");
// gmm_tf32x3: 128 x rows (wgmma's N) × 128 output columns (two consumer
// warpgroups of 64: wgmma's M) a tile, K stages of 32 (one 128-byte swizzle
// row of fp32), a 4-stage ring; warpgroup 2 loads (warp 8) and splits x (9-11)
constexpr int kTfBM = 128;
constexpr int kTfBN = 128;
constexpr int kTfBK = 32;
constexpr int kTfStages = 4;
constexpr int kTfThreads = 384;
constexpr int kTfConsumers = 256;
constexpr int kTfSplitters = 96;
constexpr int kTfTile = kTfBM * kTfBK * 4;     // 16 KB: the x, x_small and w tiles alike
constexpr int kTfWRegion = kTfBK * 128;        // w: 32 columns × kTfBK k-rows
constexpr int kTfStageBytes = 3 * kTfTile;
// the ring, a full, a ready and an empty barrier per stage, 1 KB of alignment slack
constexpr int kTfSmemBytes = kTfStages * (kTfStageBytes + 3 * 8) + 1024;
// the tensor maps' boxes: x 32 k (one 128-byte row) × 128 rows; w 32
// columns × 32 k-rows of one group
constexpr uint32_t kTfXBox[2] = {kTfBK, kTfBM};
constexpr uint32_t kTfWBox[4] = {32, kTfBK, 1, 1};
static_assert(kTfBN * kTfBK * 4 == kTfTile, "the w tile is as large as the x tile");

// row tiles of a call: every group may start a partial tile
inline int gmm_row_tiles(int N, int G, int bm) { return (N + bm - 1) / bm + (G < N ? G : N); }

template <int BN>
__host__ __device__ constexpr int wg_stages() { return BN == 256 ? 5 : 4; }
template <int BN>
__host__ __device__ constexpr int wg_stage_bytes() { return kWgBM * kWgBK * 2 + kWgBK * BN * 2; }
template <int BN>
__host__ __device__ constexpr int wg_smem_bytes() {
  // the ring, a full and an empty barrier per stage, 1024 bytes of alignment slack
  return wg_stages<BN>() * (wg_stage_bytes<BN>() + 16) + 1024;
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// offs[0..G]: first row of each group (exclusive scan of max(size, 0),
// clamped to N), offs[G] = rows covered; offs[G+1 .. 2G+1]: first row tile
// of each group (tiles of bm rows), offs[2G+1] = tiles in use.
__global__ void __launch_bounds__(kScanThreads)
gmm_offsets(const int* __restrict__ sizes, int G, int N, int bm, int* __restrict__ offs) {
  __shared__ int rows_s[kScanThreads];
  __shared__ int tiles_s[kScanThreads];
  const int tid = threadIdx.x;
  const int per = (G + kScanThreads - 1) / kScanThreads;
  const int lo = min(tid * per, G), hi = min(lo + per, G);
  int r = 0, t = 0;
  for (int g = lo; g < hi; ++g) {
    const int n = max(sizes[g], 0);
    r += n;
    t += (n + bm - 1) / bm;
  }
  rows_s[tid] = r;
  tiles_s[tid] = t;
  __syncthreads();
  for (int off = 1; off < kScanThreads; off <<= 1) {  // inclusive scan
    const int rv = tid >= off ? rows_s[tid - off] : 0;
    const int tv = tid >= off ? tiles_s[tid - off] : 0;
    __syncthreads();
    rows_s[tid] += rv;
    tiles_s[tid] += tv;
    __syncthreads();
  }
  int rb = tid ? rows_s[tid - 1] : 0, tb = tid ? tiles_s[tid - 1] : 0;
  for (int g = lo; g < hi; ++g) {
    offs[g] = min(rb, N);
    offs[G + 1 + g] = tb;
    const int n = max(sizes[g], 0);
    rb += n;
    tb += (n + bm - 1) / bm;
  }
  if (tid == kScanThreads - 1) {
    offs[G] = min(rows_s[tid], N);
    offs[2 * G + 1] = tiles_s[tid];
  }
}

// The group, first row and row count of row tile t; false past the last
// group's tiles or for a tile with no rows.
__device__ __forceinline__ bool find_tile(const int* __restrict__ offs, int G, int bm,
                                          int t, int& g, int& r0, int& m) {
  const int* tile0 = offs + G + 1;
  if (t >= tile0[G]) return false;
  int a = 1, b = G;  // the first index with tile0[idx] > t lies in [1, G]
  while (a < b) {
    const int mid = (a + b) >> 1;
    if (tile0[mid] > t) b = mid; else a = mid + 1;
  }
  g = a - 1;
  r0 = offs[g] + (t - tile0[g]) * bm;
  m = min(bm, offs[g + 1] - r0);
  return m > 0;
}

// block b of a flattened (T row tiles × C column tiles) grid → (row tile
// t, column tile c): groups of kRasterGroup column tiles, columns fastest
// inside a group, so the blocks in flight read the same x rows across the
// group's columns and an expert's weights across its row tiles
__device__ __forceinline__ void raster(int b, int T, int C, int& t, int& c) {
  const int per = kRasterGroup * T;
  const int grp = b / per, idx = b - grp * per;
  const int width = min(kRasterGroup, C - grp * kRasterGroup);
  t = idx / width;
  c = grp * kRasterGroup + idx % width;
}

template <typename T>
__device__ __forceinline__ const T* group_weight(const T* w, int g, int e_in,
                                                 long long s_outer, long long s_inner) {
  return w + (long long)(g / e_in) * s_outer + (long long)(g % e_in) * s_inner;
}

template <typename T>
__global__ void __launch_bounds__(kRowsThreads)
gmm_rows(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ out,
         const int* __restrict__ offs, int G, int Kd, int F, int e_in,
         long long s_outer, long long s_inner, long long s_k) {
  int g, r0, m;
  if (!find_tile(offs, G, kRowsBM, blockIdx.x, g, r0, m)) return;
  __shared__ float xs[kRowsBK][kRowsBM];  // x tile, transposed: xs[k][row]
  const T* wg = group_weight(w, g, e_in, s_outer, s_inner);
  const int f0 = blockIdx.y * (kRowsThreads * kRowsTN) + threadIdx.x;
  float acc[kRowsBM][kRowsTN];
#pragma unroll
  for (int r = 0; r < kRowsBM; ++r)
#pragma unroll
    for (int j = 0; j < kRowsTN; ++j) acc[r][j] = 0.f;
  bool colok[kRowsTN];
#pragma unroll
  for (int j = 0; j < kRowsTN; ++j) colok[j] = f0 + j * kRowsThreads < F;

  for (int k0 = 0; k0 < Kd; k0 += kRowsBK) {
    for (int i = threadIdx.x; i < kRowsBM * kRowsBK; i += kRowsThreads) {
      const int row = i / kRowsBK, kk = i % kRowsBK;
      float v = 0.f;
      if (row < m && k0 + kk < Kd) v = to_f32(x[(long long)(r0 + row) * Kd + k0 + kk]);
      xs[kk][row] = v;
    }
    __syncthreads();
    const int kn = min(kRowsBK, Kd - k0);
    const T* wk = wg + (long long)k0 * s_k + f0;
    int kk = 0;
    for (; kk + kRowsUnroll <= kn; kk += kRowsUnroll) {
      float wv[kRowsUnroll][kRowsTN];
#pragma unroll
      for (int u = 0; u < kRowsUnroll; ++u)
#pragma unroll
        for (int j = 0; j < kRowsTN; ++j)
          wv[u][j] = colok[j] ? to_f32(wk[(long long)(kk + u) * s_k + j * kRowsThreads]) : 0.f;
#pragma unroll
      for (int u = 0; u < kRowsUnroll; ++u)
#pragma unroll
        for (int r = 0; r < kRowsBM; ++r) {
          const float xv = xs[kk + u][r];
#pragma unroll
          for (int j = 0; j < kRowsTN; ++j) acc[r][j] = fmaf(xv, wv[u][j], acc[r][j]);
        }
    }
    for (; kk < kn; ++kk) {
      float wv[kRowsTN];
#pragma unroll
      for (int j = 0; j < kRowsTN; ++j)
        wv[j] = colok[j] ? to_f32(wk[(long long)kk * s_k + j * kRowsThreads]) : 0.f;
#pragma unroll
      for (int r = 0; r < kRowsBM; ++r) {
        const float xv = xs[kk][r];
#pragma unroll
        for (int j = 0; j < kRowsTN; ++j) acc[r][j] = fmaf(xv, wv[j], acc[r][j]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int r = 0; r < kRowsBM; ++r) {
    if (r >= m) break;
    T* orow = out + (long long)(r0 + r) * F + f0;
#pragma unroll
    for (int j = 0; j < kRowsTN; ++j)
      if (colok[j]) store1(orow + j * kRowsThreads, acc[r][j]);
  }
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(hopper::smem_u32(dst)),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(hopper::smem_u32(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// one K tile of x (transposed: as[k][row]) and w (bs[k][col]) into a stage,
// zeros past m rows, Kd and F.  fp32: cp.async (16-byte w copies when vec:
// F, s_k and the group bases multiples of 4 floats); bf16: through registers.
// Thread tid copies x rows tid / BK + i·(256 / BK) at column tid % BK, and w
// rows tid / 32 + i·8 (vec: 4 columns at 4·(tid % 32)) or tid / BN + i·(256 /
// BN) (scalar: column tid % BN); xp and wp point at its first element of
// the group's first K tile, so a tile adds k0 and i times a row stride.
template <typename T>
__device__ __forceinline__ void tile_load(float* as, float* bs, const T* __restrict__ xp,
                                          const T* __restrict__ wp, int m, int k0, int Kd,
                                          int F, int f0, long long s_k, bool vec) {
  const int tid = threadIdx.x;
  constexpr int kXRows = kTileThreads / kTileBK;  // x rows per pass
  const int kx = tid % kTileBK, rx = tid / kTileBK;
  const bool kx_ok = k0 + kx < Kd;
#pragma unroll
  for (int i = 0; i < kTileBM / kXRows; ++i) {
    const int row = rx + i * kXRows;
    const bool ok = kx_ok && row < m;
    const T* src = xp + (long long)i * kXRows * Kd + k0;
    if constexpr (sizeof(T) == 4) cp_async4(as + kx * kTileLdA + row, ok ? src : xp, ok);
    else as[kx * kTileLdA + row] = ok ? to_f32(*src) : 0.f;
  }
  if constexpr (sizeof(T) == 4) {
    if (vec) {
      constexpr int kWRows = kTileThreads / (kTileBN / 4);
      const int kw = tid / (kTileBN / 4), col = 4 * (tid % (kTileBN / 4));
      const bool col_ok = f0 + col < F;  // F % 4 == 0: the 4 columns together
#pragma unroll
      for (int i = 0; i < kTileBK / kWRows; ++i) {
        const bool ok = col_ok && k0 + kw + i * kWRows < Kd;
        const T* src = wp + (long long)(k0 + i * kWRows) * s_k;
        cp_async16(bs + (kw + i * kWRows) * kTileBN + col, ok ? src : wp, ok);
      }
      return;
    }
  }
  constexpr int kWRows = kTileThreads / kTileBN;
  const int kw = tid / kTileBN, col = tid % kTileBN;
  const bool col_ok = f0 + col < F;
#pragma unroll
  for (int i = 0; i < kTileBK / kWRows; ++i) {
    const bool ok = col_ok && k0 + kw + i * kWRows < Kd;
    const T* src = wp + (long long)(k0 + i * kWRows) * s_k;
    if constexpr (sizeof(T) == 4) cp_async4(bs + (kw + i * kWRows) * kTileBN + col, ok ? src : wp, ok);
    else bs[(kw + i * kWRows) * kTileBN + col] = ok ? to_f32(*src) : 0.f;
  }
}

// acc += the stage's x rows × w columns of this thread: rows 4ty.. (and
// 64 + 4ty.. when ROWS = 8), columns 4tx.. and 64 + 4tx..
template <int ROWS>
__device__ __forceinline__ void tile_fma(float (&acc)[8][8], const float* as, const float* bs,
                                         int ty, int tx) {
#pragma unroll
  for (int kk = 0; kk < kTileBK; ++kk) {
    const float4 a0 = *reinterpret_cast<const float4*>(as + kk * kTileLdA + 4 * ty);
    const float4 a1 = ROWS == 8 ? *reinterpret_cast<const float4*>(as + kk * kTileLdA + 64 + 4 * ty)
                                : a0;
    const float4 b0 = *reinterpret_cast<const float4*>(bs + kk * kTileBN + 4 * tx);
    const float4 b1 = *reinterpret_cast<const float4*>(bs + kk * kTileBN + 64 + 4 * tx);
    const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int i = 0; i < ROWS; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

template <typename T>
__global__ void __launch_bounds__(kTileThreads, 2)
gmm_tiles(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ out,
          const int* __restrict__ offs, int G, int Kd, int F, int e_in,
          long long s_outer, long long s_inner, long long s_k, int row_tiles, int col_tiles,
          int vec) {
  int t, c, g, r0, m;
  raster(blockIdx.x, row_tiles, col_tiles, t, c);
  if (!find_tile(offs, G, kTileBM, t, g, r0, m)) return;
  extern __shared__ __align__(16) float tsmem[];
  const T* wg = group_weight(w, g, e_in, s_outer, s_inner);
  const int tid = threadIdx.x;
  const int f0 = c * kTileBN;
  const int nk = (Kd + kTileBK - 1) / kTileBK;
  // this thread's first x and w elements (see tile_load)
  const T* xp = x + (long long)(r0 + tid / kTileBK) * Kd + tid % kTileBK;
  const T* wp = (sizeof(T) == 4 && vec)
                    ? wg + (long long)(tid / (kTileBN / 4)) * s_k + f0 + 4 * (tid % (kTileBN / 4))
                    : wg + (long long)(tid / kTileBN) * s_k + f0 + tid % kTileBN;
  auto stage_a = [&](int s) { return tsmem + s * kTileStageFloats; };
  auto stage_b = [&](int s) { return tsmem + s * kTileStageFloats + kTileBK * kTileLdA; };

#pragma unroll
  for (int s = 0; s < kTileStages - 1; ++s) {
    if (s < nk) tile_load(stage_a(s), stage_b(s), xp, wp, m, s * kTileBK, Kd, F, f0, s_k, vec);
    cp_async_commit();
  }
  // thread (ty, tx): rows 4ty.. and 64 + 4ty.., columns 4tx.. and 64 + 4tx..;
  // a warp holds 4 ty × 8 tx, so each of its float4 reads of a k row is one
  // 64- or 128-byte span: one shared-memory wavefront
  const int warp = tid / 32, lane = tid % 32;
  const int ty = (warp / 2) * 4 + lane / 8, tx = (warp % 2) * 8 + lane % 8;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  // a group's last tile may hold few rows: a warp multiplies only the rows
  // it holds below m (its rows are 16·(warp / 2) + 0..15, and 64 more)
  const bool lo_live = 16 * (warp / 2) < m, hi_live = 64 + 16 * (warp / 2) < m;

  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<kTileStages - 2>();
    __syncthreads();  // tile kt is in; every thread is done with tile kt - 1
    const int nxt = kt + kTileStages - 1;
    if (nxt < nk) {
      const int s = nxt % kTileStages;
      tile_load(stage_a(s), stage_b(s), xp, wp, m, nxt * kTileBK, Kd, F, f0, s_k, vec);
    }
    cp_async_commit();
    const float* as = stage_a(kt % kTileStages);
    const float* bs = stage_b(kt % kTileStages);
    if (hi_live) tile_fma<8>(acc, as, bs, ty, tx);
    else if (lo_live) tile_fma<4>(acc, as, bs, ty, tx);
  }
  cp_async_wait<0>();
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = (i < 4 ? 0 : 64) + 4 * ty + (i & 3);
    if (row >= m) continue;
    T* orow = out + (long long)(r0 + row) * F;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = f0 + 64 * h + 4 * tx;
      if constexpr (sizeof(T) == 4) {
        if (vec) {   // F % 4 == 0: the four columns are in or out together
          if (col < F)
            *reinterpret_cast<float4*>(orow + col) =
                make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2], acc[i][4 * h + 3]);
          continue;
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (col + j < F) store1(orow + col + j, acc[i][4 * h + j]);
    }
  }
}

// bf16 grouped GEMM on tensor cores (see the header, 3): block = 64 rows of
// one group × BN columns; warps 0-3 consume (wgmma), warp 4 produces (TMA).
template <int BN>
__global__ void __launch_bounds__(kWgThreads, 1)
gmm_wgmma(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap wmap,
          __nv_bfloat16* __restrict__ out, const int* __restrict__ offs, int G, int Kd, int F,
          int e_in, int row_tiles, int col_tiles) {
  constexpr int S = wg_stages<BN>();
  constexpr int kXBytes = kWgBM * kWgBK * 2;  // 64 rows × 128 bytes
  constexpr int kWBytes = kWgBK * BN * 2;     // BN / 64 regions of 64 k-rows × 128 bytes
  constexpr int kWRegion = kWgBK * 128;
  int t, c, g, r0, m;
  raster(blockIdx.x, row_tiles, col_tiles, t, c);
  if (!find_tile(offs, G, kWgBM, t, g, r0, m)) return;
  extern __shared__ __align__(1024) uint8_t wsmem_raw[];
  uint8_t* smem = hopper::align_smem_1024(wsmem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + S * (kXBytes + kWBytes));
  uint64_t* empty = full + S;
  const int f0 = c * BN;
  const int nk = (Kd + kWgBK - 1) / kWgBK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 128);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (warp == 4) {  // producer: one thread issues every TMA load
    if (lane == 0) {
      hopper::prefetch_tensormap(&xmap);
      hopper::prefetch_tensormap(&wmap);
      const int e = g % e_in, r = g / e_in;
      for (int i = 0; i < nk; ++i) {
        const int s = i % S;
        if (i >= S) hopper::mbar_wait(&empty[s], ((i / S) - 1) & 1);
        uint8_t* xs = smem + s * (kXBytes + kWBytes);
        uint8_t* ws = xs + kXBytes;
        hopper::mbar_expect_tx(&full[s], kXBytes + kWBytes);
        hopper::tma_load_2d(xs, &xmap, &full[s], i * kWgBK, r0);
#pragma unroll
        for (int j = 0; j < BN / 64; ++j)
          hopper::tma_load_4d(ws + j * kWRegion, &wmap, &full[s], f0 + 64 * j, i * kWgBK, e, r);
      }
    }
    return;
  }

  // consumer warpgroup: acc[64 × BN] in the wgmma accumulator layout
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  for (int i = 0; i < nk; ++i) {
    const int s = i % S;
    hopper::mbar_wait(&full[s], (i / S) & 1);
    const uint8_t* xs = smem + s * (kXBytes + kWBytes);
    const uint64_t da = hopper::desc_sw128(xs, 0, 1024);                // K-major
    const uint64_t db = hopper::desc_sw128(xs + kXBytes, kWRegion, 1024);  // MN-major
    hopper::fence_regs(acc);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kWgBK / 16; ++kk) {
      if constexpr (BN == 256)
        hopper::wgmma_ss_n256<1>(acc, hopper::desc_add(da, 32 * kk), hopper::desc_add(db, 2048 * kk), 1);
      else
        hopper::wgmma_ss_n128<1>(acc, hopper::desc_add(da, 32 * kk), hopper::desc_add(db, 2048 * kk), 1);
    }
    hopper::wgmma_commit();
    hopper::fence_regs(acc);
    hopper::wgmma_wait<1>();  // the previous stage's products are done: release it
    if (i > 0) hopper::mbar_arrive(&empty[(i - 1) % S]);
  }
  hopper::wgmma_wait<0>();
  hopper::fence_regs(acc);

  // rows 16·warp + lane/4 (+8), columns 8j + 2·(lane % 4) (+1); F % 8 == 0,
  // so a column pair is in or out together; rows ≥ m belong to the next group
  const int cc = 2 * (lane % 4);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = 16 * warp + lane / 4 + 8 * h;
    if (row >= m) continue;
    __nv_bfloat16* orow = out + (long long)(r0 + row) * F + f0 + cc;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
      if (f0 + 8 * j + cc < F)
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) =
            __floats2bfloat162_rn(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
  }
}

// bf16 grouped GEMM on tensor cores, 128-row tiles (see the header, 3):
// block = 128 rows of one group × 256 columns; warpgroups 0-1 consume 64
// rows each with the same w stage, warp 8 produces (TMA).  The two blocks
// of a cluster take row tiles 2p and 2p + 1 of one column tile; where both
// lie in one group, each loads two of w's four 64-column regions and
// multicasts them to both.
__global__ void __cluster_dims__(2, 1, 1) __launch_bounds__(kM128Threads, 1)
gmm_wgmma_m128(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap wmap,
               __nv_bfloat16* __restrict__ out, const int* __restrict__ offs, int G, int Kd,
               int F, int e_in, int row_tiles, int col_tiles) {
  constexpr int S = kM128Stages;
  constexpr int kWRegion = kWgBK * 128;
  const uint32_t rank = hopper::cluster_ctarank(), peer = rank ^ 1u;
  int p, c;
  raster(blockIdx.x / 2, (row_tiles + 1) / 2, col_tiles, p, c);
  const int t = 2 * p + static_cast<int>(rank);
  int g = 0, r0 = 0, m = 0, pg = 0, pr0 = 0, pm = 0;
  const bool valid = find_tile(offs, G, kM128BM, t, g, r0, m);
  const bool peer_valid = find_tile(offs, G, kM128BM, t ^ 1, pg, pr0, pm);
  if (!valid && !peer_valid) return;  // both blocks of the pair leave
  // both tiles in one group: w's column tile is the same for both blocks
  const bool share = valid && peer_valid && pg == g;
  extern __shared__ __align__(1024) uint8_t msmem_raw[];
  uint8_t* smem = hopper::align_smem_1024(msmem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + S * kM128StageBytes);
  // one arrival a consumer warpgroup of this block (and of the peer, when
  // it shares: the peer's multicast also writes this block's stage)
  uint64_t* empty = full + S;
  const int f0 = c * kM128BN;
  const int nk = (Kd + kWgBK - 1) / kWgBK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], share ? 4 : 2);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();
  hopper::cluster_sync();  // the peer's barriers exist before its multicast lands here

  if (valid && warp >= 8) {  // producer warpgroup: one thread issues every TMA load
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
        if (share) {
#pragma unroll
          for (int j = 2 * rank; j < 2 * rank + 2; ++j)
            hopper::tma_load_4d_multicast(ws + j * kWRegion, &wmap, &full[s], f0 + 64 * j,
                                          i * kWgBK, e, r, 0x3);
        } else {
#pragma unroll
          for (int j = 0; j < kM128BN / 64; ++j)
            hopper::tma_load_4d(ws + j * kWRegion, &wmap, &full[s], f0 + 64 * j, i * kWgBK, e, r);
        }
      }
    }
  } else if (valid) {
    // consumers take the registers the producer gave back (40 → 232 a thread)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int wg = warp / 4;  // rows 64·wg .. of the tile
    const bool signal = threadIdx.x % 128 == 0;
    auto release = [&](int s) {
      hopper::mbar_arrive_cluster(&empty[s], rank, signal);
      hopper::mbar_arrive_cluster(&empty[s], peer, signal && share);
    };
    if (64 * wg >= m) {
      // no rows (a group's last tile of ≤ 64 rows): only release the
      // stages, in a loop of its own (a branch around the products inside
      // their loop makes ptxas serialize the wgmma chain, C7518)
      for (int i = 0; i < nk; ++i) {
        hopper::mbar_wait(&full[i % S], (i / S) & 1);
        release(i % S);
      }
    } else {
      // acc[64 × 256] in the wgmma accumulator layout; the products and
      // their order are gmm_wgmma<256>'s, so each output is bitwise gmm_wgmma's
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
          hopper::wgmma_ss_n256<1>(acc, hopper::desc_add(da, 32 * kk),
                                   hopper::desc_add(db, 2048 * kk), 1);
        hopper::wgmma_commit();
        hopper::fence_regs(acc);
        hopper::wgmma_wait<1>();  // the previous stage's products are done: release it
        if (i > 0) release((i - 1) % S);
      }
      hopper::wgmma_wait<0>();
      hopper::fence_regs(acc);
      // rows 64·wg + 16·(warp % 4) + lane/4 (+8), columns 8j + 2·(lane % 4)
      // (+1); F % 8 == 0, so a column pair is in or out together; rows ≥ m
      // belong to the next group
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
  // no block leaves while its peer may still multicast into it or arrive on
  // its barriers (every thread of both blocks reaches this: none returned)
  hopper::cluster_sync();
}

// fp32 → tf32, round to nearest with ties away from zero (cvt.rna.tf32.f32's
// result): half a tf32 ulp added to the magnitude's bits, the 13 low bits
// cleared — two integer operations (hopper::tf32_rna's cvt measured 1–6 %
// slower here: scripts/gmm_tf32x3_variants.py, PERF.md)
__device__ __forceinline__ uint32_t tf32_rn(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
}
// v → big = tf32(v) and small = tf32(v − big): big + small is v to 2^-22 of |v|
__device__ __forceinline__ void split_tf32(float v, uint32_t& big, uint32_t& small) {
  big = tf32_rn(v);
  small = tf32_rn(v - __uint_as_float(big));
}

// This thread's w fragments of one stage, split: the tf32 A fragment of 4
// m64nNk8 products (see the header, 4).  Accumulator row 16·wq + lane/4 is
// output column fl and row + 8 is fl + 1; fragment column t4 is k = 2·t4 of
// the 8-wide slice and t4 + 4 is k = 2·t4 + 1 — so each (k, fl..fl + 1) pair
// is one 8-byte load, and the 8 k rows a phase reads fall in 8 distinct
// 16-byte chunks of the swizzled tile (no bank conflict).
__device__ __forceinline__ void tf_load_w(const uint8_t* ws, int fl, int t4, uint32_t (&ab)[4][4],
                                          uint32_t (&as)[4][4]) {
  const uint8_t* reg = ws + (fl / 32) * kTfWRegion + (fl % 4) * 4;
  const int ch = (fl % 32) / 4;
#pragma unroll
  for (int kk = 0; kk < kTfBK / 8; ++kk)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int k = 8 * kk + 2 * t4 + h;
      const float2 v = *reinterpret_cast<const float2*>(reg + k * 128 + ((ch ^ (k & 7)) << 4));
      split_tf32(v.x, ab[kk][2 * h], as[kk][2 * h]);          // (fl, column t4 (+4))
      split_tf32(v.y, ab[kk][2 * h + 1], as[kk][2 * h + 1]);  // (fl + 1, ...)
    }
}

// issue one stage's products into a fresh fragment `part` (committed, not
// waited): 3xTF32 over 4 slices of 8 k, the small products (w_small·x_big,
// w_big·x_small) before w_big·x_big, so the tensor cores' truncating
// accumulation meets the full-size terms in 4 steps rather than 12.  xb, xs:
// the stage's x_big and x_small tiles (K-major, 128-byte rows of 32 k).
__device__ __forceinline__ void tf_issue(float (&part)[64], const uint32_t (&ab)[4][4],
                                         const uint32_t (&as)[4][4], const uint8_t* xb,
                                         const uint8_t* xs) {
  hopper::fence_regs(part);
  hopper::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kTfBK / 8; ++kk)
    hopper::wgmma_tf32_rs_n128(part, as[kk], hopper::desc_sw128(xb + 32 * kk, 0, 1024), kk > 0);
#pragma unroll
  for (int kk = 0; kk < kTfBK / 8; ++kk)
    hopper::wgmma_tf32_rs_n128(part, ab[kk], hopper::desc_sw128(xs + 32 * kk, 0, 1024), 1);
#pragma unroll
  for (int kk = 0; kk < kTfBK / 8; ++kk)
    hopper::wgmma_tf32_rs_n128(part, ab[kk], hopper::desc_sw128(xb + 32 * kk, 0, 1024), 1);
  hopper::wgmma_commit();
}

// a consumer warpgroup's K loop and store.  acc is the output in fp32
// registers; each stage's products go into a fresh fragment added to acc in
// fp32 (round to nearest), so the truncating tensor-core accumulation spans
// 32 k, not Kd.
__device__ __forceinline__ void tf_consume(uint8_t* smem, uint64_t* full, uint64_t* ready,
                                           uint64_t* empty, float* __restrict__ out, int nk,
                                           int r0, int m, int F, int f0, int fl, int t4) {
  float acc[64], part[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = part[i] = 0.f;
  uint32_t ab[4][4], as[4][4];
  for (int i = 0; i < nk; ++i) {
    const int s = i % kTfStages;
    const uint32_t ph = (i / kTfStages) & 1;
    const uint8_t* st = smem + s * kTfStageBytes;
    hopper::mbar_wait(&full[s], ph);
    tf_load_w(st + 2 * kTfTile, fl, t4, ab, as);
    hopper::mbar_wait(&ready[s], ph);
    tf_issue(part, ab, as, st, st + kTfTile);
    hopper::wgmma_wait<0>();
    hopper::fence_regs(part);
    hopper::fence_regs(ab);
    hopper::fence_regs(as);
    hopper::mbar_arrive(&empty[s]);
#pragma unroll
    for (int j = 0; j < 64; ++j) acc[j] += part[j];
  }
  // acc[4j + e]: x row 8j + 2·t4 + (e & 1), column fl + (e >> 1); F % 4 == 0
  // and fl is even, so a column pair is in or out together; rows ≥ m belong
  // to the next group
  const int f = f0 + fl;
  if (f >= F) return;
  float* o = out + static_cast<long long>(r0) * F + f;
#pragma unroll
  for (int j = 0; j < kTfBM / 8; ++j) {
    const int n = 8 * j + 2 * t4;
    if (n < m)
      *reinterpret_cast<float2*>(o + static_cast<long long>(n) * F) =
          make_float2(acc[4 * j], acc[4 * j + 2]);
    if (n + 1 < m)
      *reinterpret_cast<float2*>(o + static_cast<long long>(n + 1) * F) =
          make_float2(acc[4 * j + 1], acc[4 * j + 3]);
  }
}

// fp32 grouped GEMM as split TF32 on tensor cores (see the header, 4): block
// = 128 rows of one group × 128 columns; warpgroups 0-1 consume (wgmma),
// warp 8 loads (TMA), warps 9-11 split x.
__global__ void __launch_bounds__(kTfThreads, 1)
gmm_tf32x3(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap wmap,
           float* __restrict__ out, const int* __restrict__ offs, int G, int Kd, int F,
           int e_in, int row_tiles, int col_tiles) {
  constexpr int S = kTfStages;
  int t, c, g, r0, m;
  raster(blockIdx.x, row_tiles, col_tiles, t, c);
  if (!find_tile(offs, G, kTfBM, t, g, r0, m)) return;
  extern __shared__ __align__(1024) uint8_t tsmem_raw[];
  // stage s: x (rounded in place to x_big), x_small, w
  uint8_t* smem = hopper::align_smem_1024(tsmem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + S * kTfStageBytes);  // x and w landed
  uint64_t* ready = full + S;  // x_big and x_small written
  uint64_t* empty = ready + S;  // both consumer warpgroups are done with the stage
  const int f0 = c * kTfBN;
  const int nk = (Kd + kTfBK - 1) / kTfBK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&ready[s], kTfSplitters);
      hopper::mbar_init(&empty[s], kTfConsumers);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (warp >= 8) {  // producer warpgroup: warp 8 loads, warps 9-11 split
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (warp == 8) {
      if (lane == 0) {
        hopper::prefetch_tensormap(&xmap);
        hopper::prefetch_tensormap(&wmap);
        const int e = g % e_in, r = g / e_in;
        for (int i = 0; i < nk; ++i) {
          const int s = i % S;
          if (i >= S) hopper::mbar_wait(&empty[s], ((i / S) - 1) & 1);
          uint8_t* st = smem + s * kTfStageBytes;
          hopper::mbar_expect_tx(&full[s], 2 * kTfTile);
          hopper::tma_load_2d(st, &xmap, &full[s], i * kTfBK, r0);
#pragma unroll
          for (int j = 0; j < kTfBN / 32; ++j)
            hopper::tma_load_4d(st + 2 * kTfTile + j * kTfWRegion, &wmap, &full[s], f0 + 32 * j,
                                i * kTfBK, e, r);
        }
      }
      return;
    }
    // splitters: each item is one x row's 8-wide k slice (two 16-byte
    // chunks, swizzled by row % 8), rounded in place to x_big and written
    // as x_small, with its k order (0, 2, 4, 6, 1, 3, 5, 7) as tf_load_w
    // pairs the w fragment's columns; consecutive threads take consecutive
    // rows, so a phase's 8 chunks are distinct banks
    const int sid = threadIdx.x - 9 * 32;
    for (int i = 0; i < nk; ++i) {
      const int s = i % S;
      hopper::mbar_wait(&full[s], (i / S) & 1);
      uint8_t* xb = smem + s * kTfStageBytes;
      uint8_t* xs = xb + kTfTile;
      for (int it = sid; it < kTfBM * (kTfBK / 8); it += kTfSplitters) {
        const int n = it % kTfBM, kk = it / kTfBM;
        const int o0 = n * 128 + (((2 * kk) ^ (n & 7)) << 4);
        const int o1 = n * 128 + (((2 * kk + 1) ^ (n & 7)) << 4);
        const float4 lo = *reinterpret_cast<const float4*>(xb + o0);
        const float4 hi = *reinterpret_cast<const float4*>(xb + o1);
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
      }
      hopper::fence_proxy_async();
      hopper::mbar_arrive(&ready[s]);
    }
    return;
  }
  // consumers take the registers the producer gave back (40 → 232 a thread)
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int fl = 64 * (warp / 4) + 16 * (warp % 4) + 2 * (lane / 4);  // column in the tile
  tf_consume(smem, full, ready, empty, out, nk, r0, m, F, f0, fl, lane % 4);
}

template <typename K>
int set_smem(K kernel, int bytes) {
  return static_cast<int>(
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
}

template <typename T>
int launch(int kernel, const void* x, const void* w, void* out, const int* sizes, int* offs,
           int N, int Kd, int F, int G, int e_in, long long s_outer, long long s_inner,
           long long s_k, int vec, cudaStream_t stream) {
  const int bm = kernel == 0 ? kRowsBM : kTileBM;
  gmm_offsets<<<1, kScanThreads, 0, stream>>>(sizes, G, N, bm, offs);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int row_tiles = gmm_row_tiles(N, G, bm);
  const T* xp = static_cast<const T*>(x);
  const T* wp = static_cast<const T*>(w);
  T* op = static_cast<T*>(out);
  if (kernel == 0) {
    const dim3 grid(row_tiles, (F + kRowsThreads * kRowsTN - 1) / (kRowsThreads * kRowsTN));
    gmm_rows<T><<<grid, kRowsThreads, 0, stream>>>(xp, wp, op, offs, G, Kd, F, e_in, s_outer,
                                                  s_inner, s_k);
  } else {
    static bool attr_set = false;  // per instantiation, once per process
    if (!attr_set) {
      const int e = set_smem(gmm_tiles<T>, kTileSmemBytes);
      if (e != 0) return e;
      attr_set = true;
    }
    const int col_tiles = (F + kTileBN - 1) / kTileBN;
    gmm_tiles<T><<<row_tiles * col_tiles, kTileThreads, kTileSmemBytes, stream>>>(
        xp, wp, op, offs, G, Kd, F, e_in, s_outer, s_inner, s_k, row_tiles, col_tiles, vec);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int BN>
int launch_wgmma(const void* x, const void* w, void* out, const int* sizes, int* offs, int N,
                 int Kd, int F, int G, int e_in, long long s_outer, long long s_inner,
                 long long s_k, cudaStream_t stream) {
  const int R = G / e_in;
  if (R == 1) s_outer = static_cast<long long>(e_in) * s_inner;  // a [G, Kd, F] weight
  CUtensorMap xmap, wmap;
  const uint64_t xdims[2] = {static_cast<uint64_t>(Kd), static_cast<uint64_t>(N)};
  const uint64_t xstr[1] = {static_cast<uint64_t>(Kd) * 2};
  int err = hopper::encode_bf16_map(&xmap, x, 2, xdims, xstr, kWgXBox);
  if (err != 0) return err;
  const uint64_t wdims[4] = {static_cast<uint64_t>(F), static_cast<uint64_t>(Kd),
                             static_cast<uint64_t>(e_in), static_cast<uint64_t>(R)};
  const uint64_t wstr[3] = {static_cast<uint64_t>(s_k) * 2, static_cast<uint64_t>(s_inner) * 2,
                            static_cast<uint64_t>(s_outer) * 2};
  err = hopper::encode_bf16_map(&wmap, w, 4, wdims, wstr, kWgWBox);
  if (err != 0) return err;
  gmm_offsets<<<1, kScanThreads, 0, stream>>>(sizes, G, N, kWgBM, offs);
  cudaError_t cerr = cudaGetLastError();
  if (cerr != cudaSuccess) return static_cast<int>(cerr);
  static bool attr_set = false;  // per instantiation, once per process
  if (!attr_set) {
    err = set_smem(gmm_wgmma<BN>, wg_smem_bytes<BN>());
    if (err != 0) return err;
    attr_set = true;
  }
  const int row_tiles = gmm_row_tiles(N, G, kWgBM);
  const int col_tiles = (F + BN - 1) / BN;
  gmm_wgmma<BN><<<row_tiles * col_tiles, kWgThreads, wg_smem_bytes<BN>(), stream>>>(
      xmap, wmap, static_cast<__nv_bfloat16*>(out), offs, G, Kd, F, e_in, row_tiles, col_tiles);
  return static_cast<int>(cudaGetLastError());
}

int launch_wgmma_m128(const void* x, const void* w, void* out, const int* sizes, int* offs,
                      int N, int Kd, int F, int G, int e_in, long long s_outer,
                      long long s_inner, long long s_k, cudaStream_t stream) {
  const int R = G / e_in;
  if (R == 1) s_outer = static_cast<long long>(e_in) * s_inner;  // a [G, Kd, F] weight
  CUtensorMap xmap, wmap;
  const uint64_t xdims[2] = {static_cast<uint64_t>(Kd), static_cast<uint64_t>(N)};
  const uint64_t xstr[1] = {static_cast<uint64_t>(Kd) * 2};
  int err = hopper::encode_bf16_map(&xmap, x, 2, xdims, xstr, kM128XBox);
  if (err != 0) return err;
  const uint64_t wdims[4] = {static_cast<uint64_t>(F), static_cast<uint64_t>(Kd),
                             static_cast<uint64_t>(e_in), static_cast<uint64_t>(R)};
  const uint64_t wstr[3] = {static_cast<uint64_t>(s_k) * 2, static_cast<uint64_t>(s_inner) * 2,
                            static_cast<uint64_t>(s_outer) * 2};
  err = hopper::encode_bf16_map(&wmap, w, 4, wdims, wstr, kWgWBox);
  if (err != 0) return err;
  gmm_offsets<<<1, kScanThreads, 0, stream>>>(sizes, G, N, kM128BM, offs);
  cudaError_t cerr = cudaGetLastError();
  if (cerr != cudaSuccess) return static_cast<int>(cerr);
  static bool attr_set = false;  // once per process
  if (!attr_set) {
    err = set_smem(gmm_wgmma_m128, kM128SmemBytes);
    if (err != 0) return err;
    attr_set = true;
  }
  const int row_tiles = gmm_row_tiles(N, G, kM128BM);
  const int col_tiles = (F + kM128BN - 1) / kM128BN;
  // two-block clusters over pairs of row tiles: the row tiles rounded up to even
  gmm_wgmma_m128<<<(row_tiles + 1) / 2 * 2 * col_tiles, kM128Threads, kM128SmemBytes, stream>>>(
      xmap, wmap, static_cast<__nv_bfloat16*>(out), offs, G, Kd, F, e_in, row_tiles, col_tiles);
  return static_cast<int>(cudaGetLastError());
}

int launch_tf32x3(const void* x, const void* w, void* out, const int* sizes, int* offs, int N,
                  int Kd, int F, int G, int e_in, long long s_outer, long long s_inner,
                  long long s_k, cudaStream_t stream) {
  const int R = G / e_in;
  if (R == 1) s_outer = static_cast<long long>(e_in) * s_inner;  // a [G, Kd, F] weight
  CUtensorMap xmap, wmap;
  const uint64_t xdims[2] = {static_cast<uint64_t>(Kd), static_cast<uint64_t>(N)};
  const uint64_t xstr[1] = {static_cast<uint64_t>(Kd) * 4};
  int err = hopper::encode_f32_map(&xmap, x, 2, xdims, xstr, kTfXBox);
  if (err != 0) return err;
  const uint64_t wdims[4] = {static_cast<uint64_t>(F), static_cast<uint64_t>(Kd),
                             static_cast<uint64_t>(e_in), static_cast<uint64_t>(R)};
  const uint64_t wstr[3] = {static_cast<uint64_t>(s_k) * 4, static_cast<uint64_t>(s_inner) * 4,
                            static_cast<uint64_t>(s_outer) * 4};
  err = hopper::encode_f32_map(&wmap, w, 4, wdims, wstr, kTfWBox);
  if (err != 0) return err;
  gmm_offsets<<<1, kScanThreads, 0, stream>>>(sizes, G, N, kTfBM, offs);
  cudaError_t cerr = cudaGetLastError();
  if (cerr != cudaSuccess) return static_cast<int>(cerr);
  static bool attr_set = false;  // once per process
  if (!attr_set) {
    err = set_smem(gmm_tf32x3, kTfSmemBytes);
    if (err != 0) return err;
    attr_set = true;
  }
  const int row_tiles = gmm_row_tiles(N, G, kTfBM);
  const int col_tiles = (F + kTfBN - 1) / kTfBN;
  gmm_tf32x3<<<row_tiles * col_tiles, kTfThreads, kTfSmemBytes, stream>>>(
      xmap, wmap, static_cast<float*>(out), offs, G, Kd, F, e_in, row_tiles, col_tiles);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x [N, Kd] contiguous, out [N, F] contiguous, one dtype for x, w and out
// (bf16 = 0 → fp32, 1 → bf16).  w: group g at w + (g / e_in)·s_outer +
// (g % e_in)·s_inner, element (k, f) at + k·s_k + f (strides in elements).
// sizes [G] int32 on the device, summing to N; offs: 2G + 2 int32 of
// scratch.  kernel: 0 gmm_rows (8-row tiles), 1 gmm_tiles (128-row tiles;
// vec = 1 takes 16-byte copies of fp32 w: F, s_k, s_inner, s_outer
// multiples of 4 and w 16-byte aligned), 2 gmm_wgmma (bf16 only, 64-row
// tiles of bn = 128 or 256 columns; Kd, F and the strides multiples of 8,
// x and w 16-byte aligned), 3 gmm_tf32x3 (fp32 only, 128 × 128 tiles; Kd,
// F and the strides multiples of 4, x and w 16-byte aligned), 4
// gmm_wgmma_m128 (bf16 only, 128-row tiles of bn = 256 columns; what
// gmm_wgmma takes).
int grouped_matmul(int bf16, int kernel, int bn, const void* x, const void* w, void* out,
                   const int* sizes, int* offs, int N, int Kd, int F, int G, int e_in,
                   long long s_outer, long long s_inner, long long s_k, int vec, void* stream) {
  if (N <= 0 || Kd <= 0 || F <= 0 || G <= 0 || G > kMaxGroups || e_in <= 0 ||
      G % e_in != 0 || kernel < 0 || kernel > 4 ||
      (kernel == 0 && (F + kRowsThreads * kRowsTN - 1) / (kRowsThreads * kRowsTN) > 65535))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kernel == 4) {
    if (!bf16 || Kd % 8 || F % 8 || s_k % 8 || s_inner % 8 || s_outer % 8 || bn != kM128BN ||
        reinterpret_cast<uintptr_t>(x) % 16 || reinterpret_cast<uintptr_t>(w) % 16)
      return static_cast<int>(cudaErrorInvalidValue);
    return launch_wgmma_m128(x, w, out, sizes, offs, N, Kd, F, G, e_in, s_outer, s_inner, s_k,
                             s);
  }
  if (kernel == 3) {
    if (bf16 || Kd % 4 || F % 4 || s_k % 4 || s_inner % 4 || s_outer % 4 ||
        reinterpret_cast<uintptr_t>(x) % 16 || reinterpret_cast<uintptr_t>(w) % 16 ||
        reinterpret_cast<uintptr_t>(out) % 8)
      return static_cast<int>(cudaErrorInvalidValue);
    return launch_tf32x3(x, w, out, sizes, offs, N, Kd, F, G, e_in, s_outer, s_inner, s_k, s);
  }
  if (kernel == 2) {
    if (!bf16 || Kd % 8 || F % 8 || s_k % 8 || s_inner % 8 || s_outer % 8 ||
        (bn != 128 && bn != 256))
      return static_cast<int>(cudaErrorInvalidValue);
    return bn == 256 ? launch_wgmma<256>(x, w, out, sizes, offs, N, Kd, F, G, e_in, s_outer,
                                         s_inner, s_k, s)
                     : launch_wgmma<128>(x, w, out, sizes, offs, N, Kd, F, G, e_in, s_outer,
                                         s_inner, s_k, s);
  }
  return bf16 ? launch<__nv_bfloat16>(kernel, x, w, out, sizes, offs, N, Kd, F, G, e_in,
                                      s_outer, s_inner, s_k, 0, s)
              : launch<float>(kernel, x, w, out, sizes, offs, N, Kd, F, G, e_in, s_outer,
                              s_inner, s_k, vec, s);
}

// the static tile geometry, for the wrapper's launch_geometry to check
// against: [rows BM, rows BN, tiles BM, tiles BN, max groups, tiles smem
// bytes, wgmma BM, wgmma smem bytes at BN 128, at BN 256, tf32x3 BM,
// tf32x3 BN, tf32x3 smem bytes, wgmma_m128 BM, BN, smem bytes]
void grouped_matmul_geometry(int* out) {
  out[0] = kRowsBM;
  out[1] = kRowsThreads * kRowsTN;
  out[2] = kTileBM;
  out[3] = kTileBN;
  out[4] = kMaxGroups;
  out[5] = kTileSmemBytes;
  out[6] = kWgBM;
  out[7] = wg_smem_bytes<128>();
  out[8] = wg_smem_bytes<256>();
  out[9] = kTfBM;
  out[10] = kTfBN;
  out[11] = kTfSmemBytes;
  out[12] = kM128BM;
  out[13] = kM128BN;
  out[14] = kM128SmemBytes;
}

// The launch geometry of one call as the launchers above make it, for the
// wrapper's launch_geometry to be held against: kernel 0 gmm_rows, 1
// gmm_tiles, 2 gmm_wgmma at bn 128 or 256 columns, 3 gmm_tf32x3, 4
// gmm_wgmma_m128 at bn 256.  out:
// grid x, y, z, threads a block, dynamic shared memory bytes, rows a tile,
// columns a tile, then the x and w tensor maps' boxes (2 + 4 dims; zeros
// for gmm_rows and gmm_tiles).  The offsets scan before it is one block of
// kScanThreads.  Returns 0, or -1 for an unknown kernel or bn.
int grouped_matmul_launch_geometry(int kernel, int bn, int N, int G, int F, int* out) {
  for (int i = 0; i < 13; ++i) out[i] = 0;
  out[2] = 1;
  if (kernel == 0) {
    const int cols = kRowsThreads * kRowsTN;
    out[0] = gmm_row_tiles(N, G, kRowsBM);
    out[1] = (F + cols - 1) / cols;
    out[3] = kRowsThreads;
    out[5] = kRowsBM;
    out[6] = cols;
  } else if (kernel == 1) {
    out[0] = gmm_row_tiles(N, G, kTileBM) * ((F + kTileBN - 1) / kTileBN);
    out[1] = 1;
    out[3] = kTileThreads;
    out[4] = kTileSmemBytes;
    out[5] = kTileBM;
    out[6] = kTileBN;
  } else if (kernel == 2 && (bn == 128 || bn == 256)) {
    out[0] = gmm_row_tiles(N, G, kWgBM) * ((F + bn - 1) / bn);
    out[1] = 1;
    out[3] = kWgThreads;
    out[4] = bn == 256 ? wg_smem_bytes<256>() : wg_smem_bytes<128>();
    out[5] = kWgBM;
    out[6] = bn;
    for (int i = 0; i < 2; ++i) out[7 + i] = static_cast<int>(kWgXBox[i]);
    for (int i = 0; i < 4; ++i) out[9 + i] = static_cast<int>(kWgWBox[i]);
  } else if (kernel == 3) {
    out[0] = gmm_row_tiles(N, G, kTfBM) * ((F + kTfBN - 1) / kTfBN);
    out[1] = 1;
    out[3] = kTfThreads;
    out[4] = kTfSmemBytes;
    out[5] = kTfBM;
    out[6] = kTfBN;
    for (int i = 0; i < 2; ++i) out[7 + i] = static_cast<int>(kTfXBox[i]);
    for (int i = 0; i < 4; ++i) out[9 + i] = static_cast<int>(kTfWBox[i]);
  } else if (kernel == 4 && bn == kM128BN) {
    out[0] = (gmm_row_tiles(N, G, kM128BM) + 1) / 2 * 2 * ((F + kM128BN - 1) / kM128BN);
    out[1] = 1;
    out[3] = kM128Threads;
    out[4] = kM128SmemBytes;
    out[5] = kM128BM;
    out[6] = kM128BN;
    for (int i = 0; i < 2; ++i) out[7 + i] = static_cast<int>(kM128XBox[i]);
    for (int i = 0; i < 4; ++i) out[9 + i] = static_cast<int>(kWgWBox[i]);
  } else {
    return -1;
  }
  return 0;
}

}  // extern "C"
