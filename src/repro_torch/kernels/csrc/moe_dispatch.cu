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
// the row segments.  Sums are fp32 (FFMA, no tensor cores, no TF32); inputs
// are fp32 or bf16 (x and w of one dtype); out [N, F] is in x's dtype.
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
//  3. Two regimes, chosen on the host from the static shapes (average rows
//     per group, kernels/moe_dispatch.py::launch_geometry):
//     - gmm_rows (decode: 1–4 rows per expert): 8-row tiles, the x tile in
//       shared memory, each thread streaming one output column's weights
//       straight from device memory into registers, 16 K-steps of loads in
//       flight before their FMAs; 128-column blocks, so that even 8 hit
//       experts give a few blocks per SM.  Each hit expert's weights are
//       read once per 8 rows: bound by the bytes of the hit experts' weights.
//     - gmm_tiles (prefill: hundreds of rows per expert): 64×128 output
//       tiles, 16-deep K tiles through shared memory (x transposed), 4×8
//       outputs per thread, the next K tile's loads held in registers while
//       the current one is multiplied.  Bound by fp32 arithmetic.
//     The Pallas kernel holds the whole padded Kd of a 128-row tile in VMEM;
//     at dbrx's d_ff that is 5.5 MB, far past 227 KB of shared memory, so
//     both kernels loop over Kd in tiles.
//
// Every entry point launches on the caller's stream, allocates nothing, does
// not synchronise, and returns cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kScanThreads = 1024;
constexpr int kMaxGroups = 4 * kScanThreads;

// gmm_rows: 8-row tiles, 128 threads × 1 column = 128 columns per block
constexpr int kRowsBM = 8;
constexpr int kRowsThreads = 128;
constexpr int kRowsTN = 1;
constexpr int kRowsBK = 64;
constexpr int kRowsUnroll = 16;
// gmm_tiles: 64×128 tiles, 256 threads × (4 rows × 8 columns), K tiles of 16
constexpr int kTileBM = 64;
constexpr int kTileBN = 128;
constexpr int kTileBK = 16;
constexpr int kTileThreads = 256;

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

template <typename T>
__global__ void __launch_bounds__(kTileThreads, 2)
gmm_tiles(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ out,
          const int* __restrict__ offs, int G, int Kd, int F, int e_in,
          long long s_outer, long long s_inner, long long s_k) {
  int g, r0, m;
  if (!find_tile(offs, G, kTileBM, blockIdx.x, g, r0, m)) return;
  constexpr int kLdA = kTileBM + 4;  // padded row of the transposed x tile
  __shared__ __align__(16) float as[kTileBK][kLdA];
  __shared__ __align__(16) float bs[kTileBK][kTileBN];
  constexpr int kA = kTileBM * kTileBK / kTileThreads;  // 4 x values per thread
  constexpr int kB = kTileBK * kTileBN / kTileThreads;  // 8 w values per thread
  const T* wg = group_weight(w, g, e_in, s_outer, s_inner);
  const int tid = threadIdx.x;
  const int f0 = blockIdx.y * kTileBN;
  float ra[kA], rb[kB];

  auto gload = [&](int k0) {
#pragma unroll
    for (int i = 0; i < kA; ++i) {
      const int e = tid + i * kTileThreads, row = e / kTileBK, kk = e % kTileBK;
      ra[i] = (row < m && k0 + kk < Kd)
                  ? to_f32(x[(long long)(r0 + row) * Kd + k0 + kk]) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < kB; ++i) {
      const int e = tid + i * kTileThreads, kk = e / kTileBN, col = e % kTileBN;
      rb[i] = (k0 + kk < Kd && f0 + col < F)
                  ? to_f32(wg[(long long)(k0 + kk) * s_k + f0 + col]) : 0.f;
    }
  };
  auto sstore = [&]() {
#pragma unroll
    for (int i = 0; i < kA; ++i) {
      const int e = tid + i * kTileThreads;
      as[e % kTileBK][e / kTileBK] = ra[i];
    }
#pragma unroll
    for (int i = 0; i < kB; ++i) {
      const int e = tid + i * kTileThreads;
      bs[e / kTileBN][e % kTileBN] = rb[i];
    }
  };

  const int ty = tid / 16, tx = tid % 16;  // rows 4ty.., columns 4tx.. and 64 + 4tx..
  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  gload(0);
  sstore();
  __syncthreads();
  for (int k0 = 0; k0 < Kd; k0 += kTileBK) {
    const bool more = k0 + kTileBK < Kd;
    if (more) gload(k0 + kTileBK);  // in flight while this tile is multiplied
#pragma unroll
    for (int kk = 0; kk < kTileBK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&as[kk][4 * ty]);
      const float4 b0 = *reinterpret_cast<const float4*>(&bs[kk][4 * tx]);
      const float4 b1 = *reinterpret_cast<const float4*>(&bs[kk][64 + 4 * tx]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
    if (more) {
      sstore();
      __syncthreads();
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = 4 * ty + i;
    if (row >= m) break;
    T* orow = out + (long long)(r0 + row) * F;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = f0 + (j < 4 ? 4 * tx + j : 64 + 4 * tx + j - 4);
      if (col < F) store1(orow + col, acc[i][j]);
    }
  }
}

template <typename T>
int launch(int small, const void* x, const void* w, void* out, const int* sizes, int* offs,
           int N, int Kd, int F, int G, int e_in, long long s_outer, long long s_inner,
           long long s_k, cudaStream_t stream) {
  const int bm = small ? kRowsBM : kTileBM;
  const int bn = small ? kRowsThreads * kRowsTN : kTileBN;
  gmm_offsets<<<1, kScanThreads, 0, stream>>>(sizes, G, N, bm, offs);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((N + bm - 1) / bm + (G < N ? G : N), (F + bn - 1) / bn);
  const T* xp = static_cast<const T*>(x);
  const T* wp = static_cast<const T*>(w);
  T* op = static_cast<T*>(out);
  if (small)
    gmm_rows<T><<<grid, kRowsThreads, 0, stream>>>(xp, wp, op, offs, G, Kd, F, e_in,
                                                  s_outer, s_inner, s_k);
  else
    gmm_tiles<T><<<grid, kTileThreads, 0, stream>>>(xp, wp, op, offs, G, Kd, F, e_in,
                                                   s_outer, s_inner, s_k);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x [N, Kd] contiguous, out [N, F] contiguous, one dtype for x, w and out
// (bf16 = 0 → fp32, 1 → bf16).  w: group g at w + (g / e_in)·s_outer +
// (g % e_in)·s_inner, element (k, f) at + k·s_k + f (strides in elements).
// sizes [G] int32 on the device, summing to N; offs: 2G + 2 int32 of
// scratch.  small = 1 runs gmm_rows (8-row tiles), 0 gmm_tiles (64-row).
int grouped_matmul(int bf16, int small, const void* x, const void* w, void* out,
                   const int* sizes, int* offs, int N, int Kd, int F, int G, int e_in,
                   long long s_outer, long long s_inner, long long s_k, void* stream) {
  if (N <= 0 || Kd <= 0 || F <= 0 || G <= 0 || G > kMaxGroups || e_in <= 0 ||
      G % e_in != 0 || (F + kTileBN - 1) / kTileBN > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<__nv_bfloat16>(small, x, w, out, sizes, offs, N, Kd, F, G, e_in,
                                      s_outer, s_inner, s_k, s)
              : launch<float>(small, x, w, out, sizes, offs, N, Kd, F, G, e_in, s_outer,
                              s_inner, s_k, s);
}

// the static tile geometry, for the wrapper's launch_geometry to check
// against: [rows BM, rows BN, tiles BM, tiles BN, max groups]
void grouped_matmul_geometry(int* out) {
  out[0] = kRowsBM;
  out[1] = kRowsThreads * kRowsTN;
  out[2] = kTileBM;
  out[3] = kTileBN;
  out[4] = kMaxGroups;
}

}  // extern "C"
