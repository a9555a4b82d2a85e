// CoDA main-path kernels for Hopper (sm_90a), with a plain C interface that
// Python loads through ctypes (see kernels/_build.py).
//
//   coda_auc_loss          replaces repro/kernels/auc_loss.py::auc_loss (Pallas)
//   coda_prox_update_multi replaces repro/kernels/prox_update.py::prox_update,
//                          one launch over every leaf of a step
//   coda_opt_update_multi  replaces repro/kernels/opt_update.py::opt_update,
//                          one launch over every leaf of a step
//
// Every entry point launches on the caller's stream, allocates nothing,
// does not synchronise, and returns cudaGetLastError() so the wrapper can
// raise on a refused launch.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// auc_loss: one pass over the scores of every worker, in one launch.
//
// Grid (ceil(T / kAucRows), K): block (i, k) reads kAucRows scores and labels
// of worker k, writes dh for them, and reduces its four partial sums
// (Σ f′, Σ ∂a, Σ ∂b, Σ ∂α′) with warp shuffles and shared memory.
//   * T ≤ kAucRows (one block per worker, as on every CoDA path): the block
//     finishes the worker itself and writes (loss, da, db, dα);
//   * otherwise each block writes its sums to partials[k, i, :], and the
//     last block of worker k to finish — found by a per-worker ticket, a
//     release-acquire atomic add, which it then resets to 0 for the next
//     call — sums the partials in a fixed order (lane-strided, then
//     warp_sum) and finishes the worker.
// The ticket is the only atomic; the sums have none, so repeated runs are
// bitwise identical, and the results are bitwise those of the earlier form
// of this kernel (block partials, then a second launch that summed them in
// the same order).
//
// The per-row constants of F and ∂α (−p(1−p)α² and −2p(1−p)α, which the
// TPU kernel masks by `live` and sums) are added once when a worker is
// finished: Σ live = T, so the result is the same sum without T rounding
// steps.
// ---------------------------------------------------------------------------
constexpr int kAucThreads = 256;
constexpr int kAucRowsPerThread = 4;
constexpr int kAucRows = kAucThreads * kAucRowsPerThread;  // rows per block

// blocks of a worker's row of the grid
inline int auc_blocks(int T) { return (T + kAucRows - 1) / kAucRows; }

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// component c of a worker's result from its summed partial v, each
// operation an explicitly rounded intrinsic, so that no contraction of the
// compiler's choosing changes a bit: loss = v/T − α·(α·pq) as one fused
// multiply-add; dα = v/T − α·(pq + pq), rounded after each step
__device__ __forceinline__ float auc_finish(float v, int c, float Tf, float alpha, float pq) {
  const float r = __fdiv_rn(v, Tf);
  if (c == 0) return __fmaf_rn(-alpha, __fmul_rn(alpha, pq), r);  // the −p(1−p)α² term
  if (c == 3) return __fsub_rn(r, __fmul_rn(alpha, __fadd_rn(pq, pq)));  // −2p(1−p)α
  return r;
}

// tickets[k] += 1 with release-acquire semantics at device scope, returning
// the old value: the caller's earlier writes are visible to the thread that
// takes a later ticket, and what that thread reads after its own ticket
// sees them (a release sequence on tickets[k]; no full fence needed)
__device__ __forceinline__ unsigned int take_ticket(unsigned int* t) {
  unsigned int old;
  asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], 1;\n" : "=r"(old) : "l"(t) : "memory");
  return old;
}

__global__ void __launch_bounds__(kAucThreads)
auc_loss_kernel(const float* __restrict__ h, const float* __restrict__ y,
                const float* __restrict__ a_, const float* __restrict__ b_,
                const float* __restrict__ alpha_, float p, int T,
                float* __restrict__ dh, float* __restrict__ partials,
                unsigned int* __restrict__ tickets, float* __restrict__ out) {
  const int k = blockIdx.y;
  const float a = a_[k], b = b_[k], alpha = alpha_[k];
  const float q = 1.0f - p;
  const float Tf = static_cast<float>(T);
  const long long base = static_cast<long long>(k) * T;
  float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
#pragma unroll
  for (int j = 0; j < kAucRowsPerThread; ++j) {
    const int t = blockIdx.x * kAucRows + j * kAucThreads + threadIdx.x;
    if (t < T) {
      const float hv = h[base + t];
      const float pos = y[base + t];
      const float neg = 1.0f - pos;
      const float dah = hv - a;
      const float dbh = hv - b;
      const float cross = p * hv * neg - q * hv * pos;
      s0 += q * dah * dah * pos + p * dbh * dbh * neg + 2.0f * (1.0f + alpha) * cross;
      s1 += -2.0f * q * dah * pos;
      s2 += -2.0f * p * dbh * neg;
      s3 += 2.0f * cross;
      const float g = 2.0f * q * dah * pos + 2.0f * p * dbh * neg
                      + 2.0f * (1.0f + alpha) * (p * neg - q * pos);
      dh[base + t] = g / Tf;
    }
  }
  __shared__ float red[kAucThreads / 32][4];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  s0 = warp_sum(s0);
  s1 = warp_sum(s1);
  s2 = warp_sum(s2);
  s3 = warp_sum(s3);
  if (lane == 0) {
    red[warp][0] = s0;
    red[warp][1] = s1;
    red[warp][2] = s2;
    red[warp][3] = s3;
  }
  __syncthreads();
  if (warp != 0) return;
  const float pq = __fmul_rn(__fsub_rn(1.0f, p), p);
  const int n_blocks = gridDim.x;
  float sums[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) sums[c] = warp_sum(lane < kAucThreads / 32 ? red[lane][c] : 0.f);
  if (n_blocks == 1) {  // the block is the worker: finish it
    if (lane == 0) {
#pragma unroll
      for (int c = 0; c < 4; ++c) out[k * 4 + c] = auc_finish(sums[c], c, Tf, alpha, pq);
    }
    return;
  }
  // a block's four sums are one float4 of partials [K, n_blocks, 4]
  float4* part = reinterpret_cast<float4*>(partials) + static_cast<long long>(k) * n_blocks;
  unsigned int ticket = 0;
  if (lane == 0) {
    part[blockIdx.x] = make_float4(sums[0], sums[1], sums[2], sums[3]);
    ticket = take_ticket(&tickets[k]);  // releases the partial just written
  }
  ticket = __shfl_sync(0xffffffffu, ticket, 0);
  if (ticket != static_cast<unsigned int>(n_blocks - 1)) return;
  // the last block of worker k: lane 0's ticket acquired every other block's
  // partials, and the warp barrier orders the other lanes' reads after it;
  // each component summed lane-strided, then across the warp
  __syncwarp();
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int i = lane; i < n_blocks; i += 32) {
    const float4 x = __ldcg(part + i);
    v.x += x.x;
    v.y += x.y;
    v.z += x.z;
    v.w += x.w;
  }
  const float vs[4] = {warp_sum(v.x), warp_sum(v.y), warp_sum(v.z), warp_sum(v.w)};
  if (lane == 0) {
#pragma unroll
    for (int c = 0; c < 4; ++c) out[k * 4 + c] = auc_finish(vs[c], c, Tf, alpha, pq);
    tickets[k] = 0;  // ready for the next call
  }
}

// ---------------------------------------------------------------------------
// prox_update and opt_update: multi-tensor kernels, one launch over every
// parameter leaf of a local step (each leaf with its leading K worker axis).
//
//   prox_update: v ← (γ(v − ηg) + ηv₀) / (η + γ)
//   opt_update:  momentum  m = coef·m + g, d = m (a bf16 m stored through the
//                          reference's hash-based stochastic rounding);
//                precond   ν = cover + g², d = g · (1/√(ν + coef)) (ν in fp32);
//                then the prox step with d in place of g.
//
// What bounds them on the card: bytes.  K2 reads 3 and writes 1 value an
// element (16 B in fp32, 8 B in bf16), K3 reads 4 and writes 2 (24 B in
// fp32, 20 B with a bf16 buffer), against about 6 and 10 fp32 operations.
// A step's leaves range from a 256-element GroupNorm scale to a 9,437,184-
// element convolution (ResNet50 at K = 4), so one launch a leaf paid a
// launch and a wrapper call for each: the design is one launch for all.
//
//   * The leaf table is a kernel parameter passed by value (up to kMaxLeaves
//     leaves, ~27 KB for K3: sm_90 takes 32,764 B of parameters), so a launch
//     copies nothing to the device first.  Each leaf carries its pointers,
//     its element count, a dtype code and its first tile; K3's also the index
//     of its seed in the step's seeds tensor (read on the device).  A tree of
//     more leaves is split into more launches of the same kernel.
//   * A block owns one (leaf, tile) pair, found by a binary search over the
//     leaves' first tiles, so the dtype branch is uniform within a block.  A
//     thread takes kVecsPerThread 16-byte vectors of v (16 elements of an
//     fp32 v, 32 of a bf16 one), so a block moves the same bytes of v
//     whatever its dtype: a large leaf is many tiles, a small one a single
//     partial tile.
//   * A thread's elements are groups of W = 4 (fp32 only) or W = 8 (any bf16
//     array) consecutive elements at (u·threads + t)·W, so each access is
//     16 bytes: a float4 per 4 fp32 elements, 8 bf16 in a uint4.  The
//     registers hold the loaded words (Raw), converted to fp32 where used.
//     Where a pointer of the leaf is not 16-byte aligned, or for a group
//     past the leaf's end, the same arithmetic runs one element at a time.
//   * In place (out == v, K3's out_buf == buf; what a donating executor's
//     step launches): no pointer carries __restrict__, and each thread loads
//     its whole share of the tile before it stores any of it.  Its elements
//     are its own, so no other thread reads what it writes.
//
// Bitwise agreement with the plain versions (kernels/ref.py) is the point:
// every fp32 operation is an explicitly rounded intrinsic in the plain
// version's order (no FMA contraction changes a bit); bf16 stores round to
// nearest even like torch's casts; 1/√x is __fsqrt_rn then __fdiv_rn, two
// correctly rounded steps that plain PyTorch repeats (__frsqrt_rn would be
// one step, which no PyTorch operation reproduces); the hash runs in native
// uint32 arithmetic, which wraps mod 2³²; and coef = 0 with an fp32 buffer
// is prox_update bitwise.  η, γ and coef are runtime arguments: a new stage
// launches the same kernel.
// ---------------------------------------------------------------------------
constexpr int kMultiThreads = 256;
constexpr int kVecsPerThread = 4;                        // 16-byte vectors of v a thread
constexpr int kMaxLeaves = 384;                          // leaves a launch

// elements a tile (a block): kVecsPerThread 16-byte vectors of v a thread,
// 16 elements of an fp32 v, 32 of a bf16 one
__host__ __device__ __forceinline__ long long tile_elems(bool bf16) {
  return static_cast<long long>(kMultiThreads) * kVecsPerThread * (bf16 ? 8 : 4);
}

// K2's dtype codes, by (v and v0, g): g may be fp32 under bf16 parameters
// (blocked Shampoo's step)
constexpr int kProxF32 = 0, kProxBf16 = 1, kProxBf16G32 = 2;
// K3's dtype codes, by (v, g and v0 | the buffer)
constexpr int kOptF32F32 = 0, kOptF32Bf16 = 1, kOptBf16F32 = 2, kOptBf16Bf16 = 3;
constexpr int kModeMomentum = 0;
constexpr int kModePrecond = 1;

struct ProxLeaf {
  void* v;
  const void* g;
  const void* v0;
  void* out;       // == v: in place
  long long n;     // elements
  int tile0;       // the leaf's first tile (block) in the launch
  int code;
};

struct OptLeaf {
  void* v;
  const void* g;
  const void* v0;
  void* buf;
  void* out_v;     // == v: in place
  void* out_buf;   // == buf: in place
  long long n;
  int tile0;
  int code;
  int seed;        // index into the launch's seeds
  int pad;
};

template <typename Leaf>
struct Table {
  const long long* seeds;   // K3: one int64 a leaf holding a uint32; K2: null
  int count;                // leaves, none empty, ordered by tile0
  Leaf leaf[kMaxLeaves];
};

inline long long tiles_of(long long n, bool bf16) {
  return (n + tile_elems(bf16) - 1) / tile_elems(bf16);
}
// whether a leaf's v is bf16, by kernel (1 prox_update, 2 opt_update) and code
inline bool bf16_v(int kernel, long long code) { return kernel == 1 ? code != 0 : code >= 2; }

// the last leaf whose first tile is at most `tile` (leaves are not empty, so
// that leaf holds it)
template <typename Leaf>
__device__ __forceinline__ int find_leaf(const Leaf* leaf, int count, int tile) {
  int lo = 0, hi = count - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (leaf[mid].tile0 <= tile) {
      lo = mid;
    } else {
      hi = mid - 1;
    }
  }
  return lo;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<unsigned long long>(p) & 15) == 0;
}

// W consecutive elements of an array of T (a group) as the 16-byte words that
// hold them: registers hold the loaded bytes, and an element becomes fp32
// only where it is used, so a bf16 array takes half the registers of an
// fp32 one
template <typename T, int W>
struct Raw {
  static_assert(W * sizeof(T) % 16 == 0, "a group is whole 16-byte words");
  uint4 w[W * sizeof(T) / 16];
};

__device__ __forceinline__ unsigned& lane(uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}
__device__ __forceinline__ unsigned lane(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// element j of a group, in fp32 (bf16 → fp32 is the bits shifted up)
template <typename T, int W>
__device__ __forceinline__ float elem(const Raw<T, W>& r, int j) {
  if constexpr (sizeof(T) == 4) {
    return __uint_as_float(lane(r.w[j / 4], j % 4));
  } else {
    const unsigned x = lane(r.w[j / 8], (j % 8) / 2);
    return __uint_as_float(j % 2 ? x & 0xFFFF0000u : x << 16);
  }
}

// the group of p at e: 16-byte loads when `fast`, else one element at a time
// (0 past the leaf's end, never stored)
template <typename T, int W>
__device__ __forceinline__ void load_group(Raw<T, W>& r, const T* p, long long e, long long n,
                                           bool fast) {
  constexpr int kWords = W * sizeof(T) / 16;
  if (fast) {
#pragma unroll
    for (int k = 0; k < kWords; ++k) r.w[k] = reinterpret_cast<const uint4*>(p + e)[k];
    return;
  }
#pragma unroll
  for (int k = 0; k < kWords; ++k) r.w[k] = make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
  for (int j = 0; j < W; ++j) {
    if (e + j >= n) continue;
    if constexpr (sizeof(T) == 4) {
      lane(r.w[j / 4], j % 4) = __float_as_uint(to_f32(p[e + j]));
    } else {
      const unsigned b = reinterpret_cast<const unsigned short*>(p)[e + j];
      lane(r.w[j / 8], (j % 8) / 2) |= b << (16 * (j % 2));
    }
  }
}

__device__ __forceinline__ unsigned bf16_bits(float x) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));
}

// W values x to p + e through 16-byte stores, bf16 rounded to nearest even
template <int W>
__device__ __forceinline__ void store_vec(float* p, long long e, const float* x) {
#pragma unroll
  for (int k = 0; k < W; k += 4)
    *reinterpret_cast<float4*>(p + e + k) = make_float4(x[k], x[k + 1], x[k + 2], x[k + 3]);
}
template <int W>
__device__ __forceinline__ void store_vec(__nv_bfloat16* p, long long e, const float* x) {
  static_assert(W == 8, "a bf16 vector is 8 elements");
  *reinterpret_cast<uint4*>(p + e) =
      make_uint4(bf16_bits(x[0]) | (bf16_bits(x[1]) << 16), bf16_bits(x[2]) | (bf16_bits(x[3]) << 16),
                 bf16_bits(x[4]) | (bf16_bits(x[5]) << 16), bf16_bits(x[6]) | (bf16_bits(x[7]) << 16));
}

// A thread's share of a tile: the groups e0 + (u·threads + t)·W, u < U.
template <int W>
__device__ __forceinline__ long long group_start(long long e0, int u) {
  return e0 + (static_cast<long long>(u) * kMultiThreads + threadIdx.x) * W;
}

template <int W, typename T>
__device__ __forceinline__ void store_group(T* p, long long e, long long n, bool fast,
                                            const float* x) {
  if (fast) {
    store_vec<W>(p, e, x);
  } else {
#pragma unroll
    for (int j = 0; j < W; ++j)
      if (e + j < n) store(p + e + j, x[j]);
  }
}

// The prox step of one element, in fp32: every operation explicitly rounded.
__device__ __forceinline__ float prox_value(float vf, float df, float v0f, float eta,
                                            float gamma, float denom) {
  const float num = __fadd_rn(__fmul_rn(gamma, __fsub_rn(vf, __fmul_rn(eta, df))),
                              __fmul_rn(eta, v0f));
  return __fdiv_rn(num, denom);
}

// K2 over one tile of leaf L: T is v's, v0's and the result's type, TG g's;
// W elements a group, kVecsPerThread 16-byte vectors of v a thread
template <typename T, typename TG, int W>
__device__ __forceinline__ void prox_tile(const ProxLeaf& L, long long e0, float eta,
                                          float gamma, float denom) {
  constexpr int U = kVecsPerThread * 16 / sizeof(T) / W;
  const T* v = static_cast<const T*>(L.v);
  const TG* g = static_cast<const TG*>(L.g);
  const T* v0 = static_cast<const T*>(L.v0);
  T* out = static_cast<T*>(L.out);
  const long long n = L.n;
  const bool aligned = aligned16(L.v) && aligned16(L.g) && aligned16(L.v0) && aligned16(L.out);
  Raw<T, W> vr[U], v0r[U];
  Raw<TG, W> gr[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const long long e = group_start<W>(e0, u);
    const bool fast = aligned && e + W <= n;
    load_group(vr[u], v, e, n, fast);
    load_group(gr[u], g, e, n, fast);
    load_group(v0r[u], v0, e, n, fast);
  }
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const long long e = group_start<W>(e0, u);
    float r[W];
#pragma unroll
    for (int j = 0; j < W; ++j)
      r[j] = prox_value(elem(vr[u], j), elem(gr[u], j), elem(v0r[u], j), eta, gamma, denom);
    store_group<W>(out, e, n, aligned && e + W <= n, r);
  }
}

__global__ void __launch_bounds__(kMultiThreads)
prox_update_multi_kernel(const __grid_constant__ Table<ProxLeaf> t, float eta,
                         float gamma) {
  const int tile = static_cast<int>(blockIdx.x);
  const ProxLeaf& L = t.leaf[find_leaf(t.leaf, t.count, tile)];
  const long long e0 = static_cast<long long>(tile - L.tile0) * tile_elems(L.code != kProxF32);
  const float denom = __fadd_rn(eta, gamma);
  if (L.code == kProxF32) {
    prox_tile<float, float, 4>(L, e0, eta, gamma, denom);
  } else if (L.code == kProxBf16) {
    prox_tile<__nv_bfloat16, __nv_bfloat16, 8>(L, e0, eta, gamma, denom);
  } else {
    prox_tile<__nv_bfloat16, float, 8>(L, e0, eta, gamma, denom);
  }
}

__device__ __forceinline__ unsigned mix_bits(unsigned x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

// The new momentum buffer in bf16: add 16 hashed low bits and truncate.  A
// NaN left after the truncation becomes the quiet NaN with its sign (0x7FC0
// / 0xFFC0), as the reference's fp32→bf16 conversion gives.
__device__ __forceinline__ unsigned rounded_bits(float acc, unsigned seed) {
  const unsigned xi = __float_as_uint(acc);
  const unsigned r = mix_bits(xi ^ seed) & 0xFFFFu;
  const unsigned yi = (xi + r) & 0xFFFF0000u;
  if ((yi & 0x7FFFFFFFu) > 0x7F800000u) return (yi >> 31) ? 0xFFC0u : 0x7FC0u;
  return yi >> 16;
}

// W accumulators to the buffer at e: fp32 as they are, bf16 stochastically
// rounded under `seed`
template <int W>
__device__ __forceinline__ void store_buf_group(float* p, long long e, long long n, bool fast,
                                                const float* acc, unsigned) {
  store_group<W>(p, e, n, fast, acc);
}
template <int W>
__device__ __forceinline__ void store_buf_group(__nv_bfloat16* p, long long e, long long n,
                                                bool fast, const float* acc, unsigned seed) {
  static_assert(W == 8, "a bf16 vector is 8 elements");
  unsigned short* q = reinterpret_cast<unsigned short*>(p);
  if (fast) {
    unsigned w[W / 2];
#pragma unroll
    for (int k = 0; k < W / 2; ++k)
      w[k] = rounded_bits(acc[2 * k], seed) | (rounded_bits(acc[2 * k + 1], seed) << 16);
    *reinterpret_cast<uint4*>(q + e) = make_uint4(w[0], w[1], w[2], w[3]);
  } else {
#pragma unroll
    for (int j = 0; j < W; ++j)
      if (e + j < n) q[e + j] = static_cast<unsigned short>(rounded_bits(acc[j], seed));
  }
}

// One element's accumulator (the new buffer value) and direction d.
template <int kMode>
__device__ __forceinline__ float opt_direction(float gf, float bf, float coef, float* acc) {
  if (kMode == kModeMomentum) {
    *acc = __fadd_rn(__fmul_rn(coef, bf), gf);
    return *acc;
  }
  *acc = __fadd_rn(bf, __fmul_rn(gf, gf));
  return __fmul_rn(gf, __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(*acc, coef))));
}

// K3 over one tile of leaf L: T is v's, g's and v0's type, B the buffer's
template <int kMode, typename T, typename B, int W>
__device__ __forceinline__ void opt_tile(const OptLeaf& L, long long e0, float eta, float gamma,
                                         float coef, float denom, unsigned seed) {
  constexpr int U = kVecsPerThread * 16 / sizeof(T) / W;
  const T* v = static_cast<const T*>(L.v);
  const T* g = static_cast<const T*>(L.g);
  const T* v0 = static_cast<const T*>(L.v0);
  const B* buf = static_cast<const B*>(L.buf);
  T* out_v = static_cast<T*>(L.out_v);
  B* out_buf = static_cast<B*>(L.out_buf);
  const long long n = L.n;
  const bool aligned = aligned16(L.v) && aligned16(L.g) && aligned16(L.v0) &&
                       aligned16(L.buf) && aligned16(L.out_v) && aligned16(L.out_buf);
  Raw<T, W> vr[U], gr[U], v0r[U];
  Raw<B, W> br[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const long long e = group_start<W>(e0, u);
    const bool fast = aligned && e + W <= n;
    load_group(vr[u], v, e, n, fast);
    load_group(gr[u], g, e, n, fast);
    load_group(v0r[u], v0, e, n, fast);
    load_group(br[u], buf, e, n, fast);
  }
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const long long e = group_start<W>(e0, u);
    const bool fast = aligned && e + W <= n;
    float acc[W], r[W];
#pragma unroll
    for (int j = 0; j < W; ++j) {
      const float d = opt_direction<kMode>(elem(gr[u], j), elem(br[u], j), coef, &acc[j]);
      r[j] = prox_value(elem(vr[u], j), d, elem(v0r[u], j), eta, gamma, denom);
    }
    store_buf_group<W>(out_buf, e, n, fast, acc, seed);
    store_group<W>(out_v, e, n, fast, r);
  }
}

template <int kMode>
__global__ void __launch_bounds__(kMultiThreads)
opt_update_multi_kernel(const __grid_constant__ Table<OptLeaf> t, float eta, float gamma,
                        float coef) {
  const int tile = static_cast<int>(blockIdx.x);
  const OptLeaf& L = t.leaf[find_leaf(t.leaf, t.count, tile)];
  const long long e0 = static_cast<long long>(tile - L.tile0) * tile_elems(L.code >= kOptBf16F32);
  const float denom = __fadd_rn(eta, gamma);
  const unsigned seed = static_cast<unsigned>(t.seeds[L.seed]);
  using bf16 = __nv_bfloat16;
  if (L.code == kOptF32F32) {
    opt_tile<kMode, float, float, 4>(L, e0, eta, gamma, coef, denom, seed);
  } else if (L.code == kOptBf16F32) {
    opt_tile<kMode, bf16, float, 8>(L, e0, eta, gamma, coef, denom, seed);
  } else if constexpr (kMode == kModeMomentum) {   // the bf16 buffers: momentum only
    if (L.code == kOptF32Bf16) {
      opt_tile<kMode, float, bf16, 8>(L, e0, eta, gamma, coef, denom, seed);
    } else {
      opt_tile<kMode, bf16, bf16, 8>(L, e0, eta, gamma, coef, denom, seed);
    }
  }
}

// The table of the caller's rows ptrs [count, P] and meta [count, M] (n, code
// and, for K3, the seed index), empty leaves left out; returns the tiles of
// the launch, or -1 for a row the kernel cannot take.
long long fill(Table<ProxLeaf>& t, int count, const long long* ptrs,
               const long long* meta) {
  long long tiles = 0;
  t.seeds = nullptr;
  t.count = 0;
  for (int i = 0; i < count; ++i) {
    const long long n = meta[2 * i], code = meta[2 * i + 1];
    if (n < 0 || code < kProxF32 || code > kProxBf16G32) return -1;
    if (n == 0) continue;
    ProxLeaf& L = t.leaf[t.count++];
    const long long* p = ptrs + 4 * i;
    L.v = reinterpret_cast<void*>(p[0]);
    L.g = reinterpret_cast<const void*>(p[1]);
    L.v0 = reinterpret_cast<const void*>(p[2]);
    L.out = reinterpret_cast<void*>(p[3]);
    L.n = n;
    L.tile0 = static_cast<int>(tiles);
    L.code = static_cast<int>(code);
    tiles += tiles_of(n, bf16_v(1, code));
    if (tiles > 0x7FFFFFFFLL) return -1;
  }
  return tiles;
}

long long fill(Table<OptLeaf>& t, int count, const long long* ptrs,
               const long long* meta, const void* seeds, int mode) {
  long long tiles = 0;
  t.seeds = static_cast<const long long*>(seeds);
  t.count = 0;
  for (int i = 0; i < count; ++i) {
    const long long n = meta[3 * i], code = meta[3 * i + 1], seed = meta[3 * i + 2];
    const bool bf16_buf = code == kOptF32Bf16 || code == kOptBf16Bf16;
    if (n < 0 || code < kOptF32F32 || code > kOptBf16Bf16 || seed < 0 ||
        (mode == kModePrecond && bf16_buf))
      return -1;
    if (n == 0) continue;
    OptLeaf& L = t.leaf[t.count++];
    const long long* p = ptrs + 6 * i;
    L.v = reinterpret_cast<void*>(p[0]);
    L.g = reinterpret_cast<const void*>(p[1]);
    L.v0 = reinterpret_cast<const void*>(p[2]);
    L.buf = reinterpret_cast<void*>(p[3]);
    L.out_v = reinterpret_cast<void*>(p[4]);
    L.out_buf = reinterpret_cast<void*>(p[5]);
    L.n = n;
    L.tile0 = static_cast<int>(tiles);
    L.code = static_cast<int>(code);
    L.seed = static_cast<int>(seed);
    L.pad = 0;
    tiles += tiles_of(n, bf16_v(2, code));
    if (tiles > 0x7FFFFFFFLL) return -1;
  }
  return tiles;
}

// one tensor's bytes [lo, hi) in an aliasing check, and whether it is written
struct Span {
  unsigned long long lo, hi;
  bool written;
};

}  // namespace

extern "C" {

// h, y: [K, T] fp32; a, b, alpha: [K] fp32; dh: [K, T] fp32; out: [K, 4]
// fp32 = (loss, da, db, dalpha) per worker.  One launch.  When T exceeds
// coda_auc_rows_per_block(): partials is [K, ceil(T / rows), 4] fp32
// scratch and tickets [K] uint32, zero before the first call and left zero
// by every call (calls that share tickets must run on one stream); else
// both may be null.
int coda_auc_loss(const void* h, const void* y, const void* a, const void* b,
                  const void* alpha, float p, int K, int T, void* dh,
                  void* partials, void* tickets, void* out, void* stream) {
  if (K > 0 && T > 0) {
    const int n_blocks = auc_blocks(T);
    if (n_blocks > 1 && (partials == nullptr || tickets == nullptr))
      return static_cast<int>(cudaErrorInvalidValue);
    auc_loss_kernel<<<dim3(n_blocks, K), kAucThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(h), static_cast<const float*>(y),
        static_cast<const float*>(a), static_cast<const float*>(b),
        static_cast<const float*>(alpha), p, T, static_cast<float*>(dh),
        static_cast<float*>(partials), static_cast<unsigned int*>(tickets),
        static_cast<float*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

int coda_auc_rows_per_block(void) { return kAucRows; }

// The launch geometry the entry points here use, for the wrappers'
// launch_geometry to be held against.  kernel 0: auc_loss over k workers of
// n scores (sizes unused); out = grid x, y, z, threads a block, dynamic
// shared memory bytes.  kernel 1 prox_update, 2 opt_update: a step over n
// leaves, leaves[2i] elements and leaves[2i + 1] the dtype code of leaf i (k
// unused), its non-empty leaves kMaxLeaves a launch in order; out = the
// largest launch's grid x, y, z, threads, shared bytes, then launches, leaves
// a launch at most, elements a tile of an fp32 v and of a bf16 v.  Returns
// 0, or -1 for an unknown kernel or dtype code.
int coda_kernels_geometry(int kernel, long long n, int k, const long long* leaves,
                          long long* out) {
  if (kernel == 0) {
    out[0] = auc_blocks(static_cast<int>(n));
    out[1] = k;
    out[3] = kAucThreads;
  } else if (kernel == 1 || kernel == 2) {
    long long launches = 0, grid = 0, tiles = 0;
    int in_launch = 0;
    for (long long i = 0; i < n; ++i) {
      const long long size = leaves[2 * i], code = leaves[2 * i + 1];
      if (code < 0 || code > (kernel == 1 ? kProxBf16G32 : kOptBf16Bf16)) return -1;
      if (size <= 0) continue;
      if (in_launch == kMaxLeaves || in_launch == 0) {
        ++launches;
        in_launch = 0;
        tiles = 0;
      }
      ++in_launch;
      tiles += tiles_of(size, bf16_v(kernel, code));
      grid = tiles > grid ? tiles : grid;
    }
    out[0] = grid;
    out[1] = 1;
    out[3] = kMultiThreads;
    out[5] = launches;
    out[6] = kMaxLeaves;
    out[7] = tile_elems(false);
    out[8] = tile_elems(true);
  } else {
    return -1;
  }
  out[2] = 1;
  out[4] = 0;
  return 0;
}

// The wrappers' aliasing rule for an in-place step, over count leaves (any
// number) in a launch's own layout: kernel 1 prox_update (ptrs [count, 4],
// meta [count, 2]), kernel 2 opt_update (ptrs [count, 6], meta [count, 3]).
// Each leaf's v (and K3's buf) is written, its g and v0 read, and the
// seeds' seeds_bytes from seeds are read.  No written byte may be one that
// any other span reads or writes.  The spans are sorted and swept once:
// O(n log n).  Returns 0 when they lie apart, 1 when they overlap, -1 for
// an unknown kernel or dtype code.
int coda_multi_apart(int kernel, long long count, const long long* ptrs, const long long* meta,
                     const void* seeds, long long seeds_bytes) {
  if (kernel != 1 && kernel != 2) return -1;
  const int cols = kernel == 1 ? 4 : 6, mcols = kernel == 1 ? 2 : 3;
  std::vector<Span> s;
  s.reserve(static_cast<size_t>(count) * 4 + 1);
  auto add = [&s](long long p, long long bytes, bool written) {
    const auto lo = static_cast<unsigned long long>(p);
    s.push_back({lo, lo + static_cast<unsigned long long>(bytes), written});
  };
  for (long long i = 0; i < count; ++i) {
    const long long* p = ptrs + cols * i;
    const long long n = meta[mcols * i], code = meta[mcols * i + 1];
    if (code < 0 || code > (kernel == 1 ? kProxBf16G32 : kOptBf16Bf16)) return -1;
    if (n <= 0) continue;
    const long long vb = bf16_v(kernel, code) ? 2 : 4;
    add(p[0], n * vb, true);                                   // v
    if (kernel == 1) {
      add(p[1], n * (code == kProxBf16 ? 2 : 4), false);       // g
      add(p[2], n * vb, false);                                // v0
    } else {
      add(p[1], n * vb, false);
      add(p[2], n * vb, false);
      add(p[3], n * (code == kOptF32Bf16 || code == kOptBf16Bf16 ? 2 : 4), true);  // buf
    }
  }
  if (seeds != nullptr && seeds_bytes > 0)
    add(reinterpret_cast<long long>(seeds), seeds_bytes, false);
  std::sort(s.begin(), s.end(), [](const Span& a, const Span& b) {
    return a.lo != b.lo ? a.lo < b.lo : a.hi < b.hi;
  });
  unsigned long long reach = 0, reach_w = 0;   // the furthest end so far: any span, written
  for (size_t k = 0; k < s.size(); ++k) {
    if (k > 0 && (s[k].lo < reach_w || (s[k].written && s[k].lo < reach))) return 1;
    reach = std::max(reach, s[k].hi);
    if (s[k].written) reach_w = std::max(reach_w, s[k].hi);
  }
  return 0;
}

// One launch of K2 over count ≤ kMaxLeaves leaves.  ptrs: [count, 4] int64
// (v, g, v0, out; out == v writes in place, and then v must not overlap any
// leaf's g or v0 or another leaf's v); meta: [count, 2] int64 (elements, dtype
// code: 0 all fp32, 1 all bf16, 2 bf16 v and v0 with an fp32 g).  Both are
// host arrays, read before the call returns.  Empty leaves are skipped.
int coda_prox_update_multi(int count, const long long* ptrs, const long long* meta, float eta,
                           float gamma, void* stream) {
  if (count < 0 || count > kMaxLeaves) return static_cast<int>(cudaErrorInvalidValue);
  Table<ProxLeaf> t;
  const long long tiles = fill(t, count, ptrs, meta);
  if (tiles < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (tiles > 0)
    prox_update_multi_kernel<<<static_cast<unsigned>(tiles), kMultiThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(t, eta, gamma);
  return static_cast<int>(cudaGetLastError());
}

// One launch of K3 over count ≤ kMaxLeaves leaves.  mode: 0 momentum, 1
// precond.  ptrs: [count, 6] int64 (v, g, v0, buf, out_v, out_buf; out_v ==
// v and out_buf == buf write in place, and then neither may overlap g, v0,
// the seeds or another leaf's memory); meta: [count, 3] int64 (elements, dtype
// code: 0 v fp32 buffer fp32, 1 v fp32 buffer bf16, 2 v bf16 buffer fp32, 3
// both bf16 — precond takes an fp32 buffer only — and the index of the
// leaf's seed in seeds, a device int64 tensor whose elements hold uint32s).
int coda_opt_update_multi(int mode, int count, const long long* ptrs, const long long* meta,
                          const void* seeds, float eta, float gamma, float coef, void* stream) {
  if (count < 0 || count > kMaxLeaves || seeds == nullptr ||
      (mode != kModeMomentum && mode != kModePrecond))
    return static_cast<int>(cudaErrorInvalidValue);
  Table<OptLeaf> t;
  const long long tiles = fill(t, count, ptrs, meta, seeds, mode);
  if (tiles < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (tiles > 0) {
    const auto s = static_cast<cudaStream_t>(stream);
    const unsigned grid = static_cast<unsigned>(tiles);
    if (mode == kModeMomentum) {
      opt_update_multi_kernel<kModeMomentum><<<grid, kMultiThreads, 0, s>>>(t, eta, gamma, coef);
    } else {
      opt_update_multi_kernel<kModePrecond><<<grid, kMultiThreads, 0, s>>>(t, eta, gamma, coef);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

const char* coda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
