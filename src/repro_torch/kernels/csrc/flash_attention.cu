// K4 flash_attention for Hopper (sm_90a), with a plain C interface that
// Python loads through ctypes (see kernels/_build.py, which builds it with
// coda_kernels.cu into one library; coda_error_string names its errors).
//
//   flash_attention_forward  replaces repro/kernels/flash_attention.py::
//                            flash_attention (Pallas, pallas_call at :120)
//
// What it computes: GQA attention o = softmax(q·kᵀ/√hd + mask)·v per
// (batch, query head), query head h reading KV head h / G, with causal and
// static sliding-window masks (a window w keeps kv > q − w), and the per-row
// log-sum-exp of the masked scores (fp32 [B, H, S]) that the backward needs.
// The mask sentinel is -1e30, not -inf, as the Pallas kernel's: a row whose
// first visited tile holds no valid key then gets exp(0) = 1 weights there,
// which the rescale exp(-1e30 − m) = 0 wipes once a valid key arrives.
//
// Design.  The TPU kernel runs a sequential KV grid axis with m, l and acc
// in VMEM scratch; here a block owns one 64-row query tile of one head of
// one batch row (grid = (q tiles, H, B)) and loops over the KV tiles inside
// the causal/window band itself, skipping the tiles outside it as the
// Pallas kernel's pl.when(needed) does.  The q tile (pre-scaled by hd^-0.5,
// transposed) sits in shared memory for the whole loop; each 64-row K/V tile
// is streamed through shared memory; 256 threads compute the 64×64 score
// tile as 4×4 register tiles in fp32 FFMA (no tensor cores, no TF32), keep
// the running max m, denominator l and the 4×(hd/16) output accumulator of
// their rows in fp32 registers, and pass the probabilities to the P·V
// product through shared memory.  l is floored at 1e-30.  Ragged S and Skv
// are masked at the edge (no S % 64 requirement).  Inputs are fp32 or bf16
// (converted to fp32 on the way into shared memory); o is written in q's
// dtype.  Query tiles are walked last-first, so the longest causal rows
// start first.
//
// What bounds it: at the prefill shape [4, 2048, 32, 64] (causal) the
// scores and P·V are ~68.7 GFLOP of fp32 against ~67 MB of q, k, v and o,
// so fp32 arithmetic bounds it (~1.03 ms at 67 TFLOP/s); at the training
// shape [128, 64, 32, 64] each (b, h) has one tile and bytes bound it.
// Shared-memory traffic per FFMA is what keeps this simple kernel below
// the arithmetic bound; the two variants below take the tensor cores.
//
// flash_fwd_wgmma: the variant for bf16 q/k/v with head_dim 64 or 128 (the
// head_dims of every full-width config), chosen on the host from the dtype
// and head_dim (kernels/flash_attention.py::launch_geometry); bf16 at
// head_dim 16/32 keeps flash_fwd, as does fp32 there (fp32 at head_dim 64
// and 128 takes flash_fwd_tf32x3, below).  bf16 attention at the prefill
// shape does ~69 GFLOP against 67 MB, over the tensor cores' ridge: the
// bound is bf16 tensor-core arithmetic (0.07 ms at 989 TFLOP/s), which
// FFMA cannot approach.  Design:
//   * a block owns 128 query rows of one (head, batch row): two consumer
//     warpgroups of 64 rows each and a producer warpgroup (384 threads),
//     which hands its registers to the consumers (setmaxnreg 24 / 240);
//   * the producer loads the q tile once and streams the band's K and V
//     tiles (128 keys) through a ring of 3 (hd 64) or 2 (hd 128) stages by
//     TMA, each completing on its own full barrier; consumers release a
//     stage on its empty barrier.  The tensor maps keep B, S (or Skv) and
//     heads as separate dimensions, so a ragged tile's rows past S or Skv
//     are zeros, never the next batch row's; GQA reads KV head h / G
//     through the coordinates;
//   * S = q·kᵀ is one wgmma chain (m64n128k16, both operands K-major in
//     shared memory, 128-byte swizzle); the scores are scaled to log2 units
//     and masked in fp32 registers with the same −1e30 sentinel (causal,
//     static window, ragged S and Skv), only in tiles the mask reaches;
//   * online softmax in registers: each row's max and sum over the four
//     threads that share it (two shuffles), the output accumulator rescaled,
//     exp2 of scores pre-multiplied by log2(e)·hd^-½;
//   * O += P·V: P rounded to bf16 in registers is the A operand (the
//     accumulator layout is the A-fragment layout), V the B operand from
//     shared memory, MN-major (hd contiguous: wgmma's transpose bit);
//   * a software pipeline in each warpgroup: q·kᵀ of the next tile is
//     issued before P·V of this one, and its softmax runs on the CUDA cores
//     while P·V runs on the tensor cores (the loop's last tile is peeled,
//     so every iteration commits the same two groups: ptxas then keeps the
//     wgmma chain asynchronous);
//   * o = O / max(l, 1e-30) stored in bf16; lse = m·ln2 + log l in fp32, as
//     flash_fwd; query tiles are walked last-first (longest causal rows
//     first), KV tiles outside the causal/window band skipped.
// Its numbers differ from flash_fwd's by design: P is rounded to bf16 before
// P·V, as in every tensor-core attention (SDPA's flash backend included);
// the error model and tolerance are stated in chip_smoke.py (ATTN_TOL).
//
// flash_fwd_tf32x3: the variant for fp32 q/k/v with head_dim 64 (stablelm's)
// or 128 (qwen's, phi3's, chatglm's, dbrx's), chosen on the host from the
// dtype, head_dim and 16-byte-aligned bases; one template, HD = 64 or 128.
// flash_fwd is bound by fp32 FFMA (1.03 ms at stablelm's prefill shape) and
// in practice by shared-memory reads per FFMA.  Here q·kᵀ and P·V run on the
// TF32 tensor cores as split TF32 ("3xTF32"): each fp32 operand x = big +
// small with big = tf32(x) and small = tf32(x − big) (round to nearest,
// ties away), and a·b ≈ a_small·b_big + a_big·b_small + a_big·b_big, each
// product exact, accumulated in fp32.  What is dropped — a_small·b_small
// and the rounding of the small parts — is at most 3·2^-22 of |a·b|, so the
// result is held to fp32's tolerance.  Its bound at stablelm's prefill
// shape is 3 × 68.7 GFLOP at 495 TFLOP/s = 0.417 ms; at chatglm3-6b's [4,
// 2048, 32/2, 128] 3 × 137 GFLOP, 0.83 ms.  Design:
//   * flash_fwd_wgmma's block: 128 query rows, two consumer warpgroups of
//     64 rows and a producer warpgroup (setmaxnreg 40 / 232); when S and Skv
//     are both ≤ 64 (the training shapes: one K/V tile per head at HD 64,
//     two at HD 128) the block packs two heads instead, one per consumer
//     warpgroup; the producer interleaves the two heads' tiles, so with two
//     stages each head keeps its own stage and neither warpgroup idles;
//   * a K, V or Vᵀ tile is 16 KB in fp32: 64 keys at HD 64, 32 keys at HD
//     128.  Warp 8 of the producer streams K and V tiles by TMA over 4-D
//     tensor maps (boxes of 32 dims × BK keys, HD / 32 of them a tile) into
//     rings of 2 stages; warps 9-11 split each stage in shared memory: K
//     rounded in place to K_big and K_small written beside it; V (keys ×
//     dims, as TMA lands it) transposed into Vᵀ_big and Vᵀ_small (dims ×
//     keys), because tf32 wgmma takes both shared-memory operands K-major
//     only (no transpose bit) and P·V reduces over keys.  The split runs in
//     the producer's otherwise idle warps, a stage ahead of the consumers,
//     and costs no device-memory bytes (a pre-pass kernel would write and
//     read Vᵀ twice); each splitter fences its stores to the async proxy
//     and arrives on the stage's ready barrier.  K, V and Vᵀ have separate
//     rings and barriers, so a K stage is refilled once its q·kᵀ is done;
//     81 KB a stage, with q_small 193 KB in all at HD 64 and 230,512 B of
//     the 232,448 a block may use at HD 128 (where a 64-key tile, 32 KB,
//     would need 160 KB a stage: that is why the tile halves);
//   * q·scale is loaded once per block straight into registers as tf32 A
//     fragments and split there: q_big stays in registers (HD / 2 a
//     thread), q_small goes to a K-major tile in shared memory (an SS
//     operand), which leaves registers for the per-tile P·V fragment;
//   * accuracy: the tensor cores add each product group into the fp32
//     accumulator with truncation (measured on the card: with O
//     accumulated by wgmma across the row, the error grew with the number
//     of KV tiles to 10× fp32 FFMA's, and a 24-layer prefill's logits
//     drifted past 1e-4).  So the small products are issued before the big
//     ones, and each tile's P·V goes into a fresh fragment that is added
//     to O in fp32 registers (round to nearest), folded into the rescale:
//     O = (O + P_i·V_i)·corr;
//   * S = q·kᵀ: one chain of 3·HD / 8 m64nBKk8 tf32 wgmmas (3 per 8-wide
//     slice) into one fp32 fragment; the softmax is flash_fwd_wgmma's (log2
//     units, −1e30 sentinel, ragged S and Skv, causal and window bands);
//   * O += P·V: P is split in registers.  The f32 accumulator holds keys
//     2t, 2t + 1 of each 8-key slice on thread t of a quad, while the tf32
//     A fragment wants columns t and t + 4; P's registers are used as they
//     are (key 2t as column t, key 2t + 1 as column t + 4) and the
//     splitters write each 8-key group of a Vᵀ row in the same order (0, 2,
//     4, 6, 1, 3, 5, 7), so no shuffle or shared-memory trip is needed.
//     P·V is m64n64k8 products: at HD 128 two of them a tile (dims 0-63,
//     then 64-127) through one 32-register fragment, each added to O as it
//     completes.  A consumer at HD 128 holds q_big (64 registers), O (64),
//     the P·V fragment (32), S (16) and P's two parts (32): 208 of its 232;
//     with 64-key tiles and a 64-register fragment it would need 288;
//   * the pipeline of flash_fwd_wgmma (next tile's q·kᵀ before this tile's
//     P·V — at HD 128 before its first half — last tile peeled); o stored
//     in fp32 and lse as flash_fwd's.
//
// Every entry point launches on the caller's stream, allocates nothing,
// does not synchronise, and returns cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // key rows per KV tile
constexpr int kThreads = 256;  // 16 × 16: thread (ty, tx) owns rows 4ty..4ty+3
constexpr int kLdQ = kBQ + 4;  // padded row of the transposed q / P tiles
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// four bf16 (8 bytes) → fp32, exactly: a bf16 is the high half of an fp32
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
}

__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <int HD>
constexpr int smem_floats() {
  // qt [HD][kLdQ], ks [kBK][HD + 1], vs [kBK][HD], pt [kBK][kLdQ]
  return HD * kLdQ + kBK * (HD + 1) + kBK * HD + kBK * kLdQ;
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, T* __restrict__ o, float* __restrict__ lse,
          int S, int H, int Skv, int KV, int causal, int window, float scale) {
  constexpr int NE = HD / 16;  // output columns per thread
  extern __shared__ __align__(16) float smem[];
  float* qt = smem;                       // [HD][kLdQ], q · scale, transposed
  float* ks = qt + HD * kLdQ;             // [kBK][HD + 1]
  float* vs = ks + kBK * (HD + 1);        // [kBK][HD]
  float* pt = vs + kBK * HD;              // [kBK][kLdQ], P transposed

  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;  // last tile first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const long long q_row = static_cast<long long>(H) * HD;    // stride of s
  const long long kv_row = static_cast<long long>(KV) * HD;  // stride of c
  const T* qb = q + static_cast<long long>(b) * S * q_row + static_cast<long long>(h) * HD;
  const T* kb = k + static_cast<long long>(b) * Skv * kv_row + static_cast<long long>(kvh) * HD;
  const T* vb = v + static_cast<long long>(b) * Skv * kv_row + static_cast<long long>(kvh) * HD;

  // q tile → qt[d][r] (scaled, transposed; rows past S are zeros)
  for (int idx = tid; idx < kBQ * HD / 4; idx += kThreads) {
    const int r = idx / (HD / 4), d = (idx % (HD / 4)) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + r < S) x = load4(qb + (q0 + r) * q_row + d);
    qt[(d + 0) * kLdQ + r] = x.x * scale;
    qt[(d + 1) * kLdQ + r] = x.y * scale;
    qt[(d + 2) * kLdQ + r] = x.z * scale;
    qt[(d + 3) * kLdQ + r] = x.w * scale;
  }

  // KV tiles inside the band of this q tile (pl.when(needed) in Pallas)
  int kv_hi = Skv;
  if (causal) kv_hi = min(Skv, q0 + kBQ);
  int kv_lo = 0;
  if (window >= 0) kv_lo = max(0, q0 - window + 1);
  kv_lo = (kv_lo / kBK) * kBK;

  float m[4], l[4], acc[4][NE];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NE; ++j) acc[i][j] = 0.f;
  }

  for (int k0 = kv_lo; k0 < kv_hi; k0 += kBK) {
    __syncthreads();  // the previous tile's readers are done
    for (int idx = tid; idx < kBK * HD / 4; idx += kThreads) {
      const int r = idx / (HD / 4), d = (idx % (HD / 4)) * 4;
      float4 kx = make_float4(0.f, 0.f, 0.f, 0.f), vx = kx;
      if (k0 + r < Skv) {
        kx = load4(kb + (k0 + r) * kv_row + d);
        vx = load4(vb + (k0 + r) * kv_row + d);
      }
      float* kr = ks + r * (HD + 1) + d;
      kr[0] = kx.x; kr[1] = kx.y; kr[2] = kx.z; kr[3] = kx.w;
      *reinterpret_cast<float4*>(vs + r * HD + d) = vx;
    }
    __syncthreads();

    // scores s[i][j] for rows 4ty+i, keys tx+16j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      const float4 qv = *reinterpret_cast<const float4*>(qt + d * kLdQ + 4 * ty);
      const float qa[4] = {qv.x, qv.y, qv.z, qv.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float kv = ks[(tx + 16 * j) * (HD + 1) + d];
#pragma unroll
        for (int i = 0; i < 4; ++i) s[i][j] = fmaf(qa[i], kv, s[i][j]);
      }
    }

    // mask, online softmax update, P → shared memory
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + 4 * ty + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + tx + 16 * j;
        bool ok = kp < Skv;
        if (causal) ok = ok && kp <= qp;
        if (window >= 0) ok = ok && kp > qp - window;
        if (!ok) s[i][j] = kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        sum += p;
        pt[(tx + 16 * j) * kLdQ + 4 * ty + i] = p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < NE; ++j) acc[i][j] *= corr;
    }
    __syncthreads();

    // acc += P · V over this tile's keys
#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      const float4 pv = *reinterpret_cast<const float4*>(pt + c * kLdQ + 4 * ty);
      const float pa[4] = {pv.x, pv.y, pv.z, pv.w};
      float va[NE];
      if constexpr (NE % 4 == 0) {
#pragma unroll
        for (int j = 0; j < NE; j += 4) {
          const float4 x = *reinterpret_cast<const float4*>(vs + c * HD + tx * NE + j);
          va[j] = x.x; va[j + 1] = x.y; va[j + 2] = x.z; va[j + 3] = x.w;
        }
      } else {
#pragma unroll
        for (int j = 0; j < NE; ++j) va[j] = vs[c * HD + tx * NE + j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NE; ++j) acc[i][j] = fmaf(pa[i], va[j], acc[i][j]);
    }
  }

  // o = acc / max(l, 1e-30) in q's dtype; lse = m + log l
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q0 + 4 * ty + i;
    if (qp >= S) continue;
    const float li = fmaxf(l[i], 1e-30f);
    T* orow = o + (static_cast<long long>(b) * S + qp) * q_row +
              static_cast<long long>(h) * HD + tx * NE;
#pragma unroll
    for (int j = 0; j < NE; ++j) store1(orow + j, acc[i][j] / li);
    if (tx == 0)
      lse[(static_cast<long long>(b) * H + h) * S + qp] = m[i] + logf(li);
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int B, int S, int H, int Skv, int KV, int causal, int window,
           float scale, cudaStream_t stream) {
  constexpr int bytes = smem_floats<HD>() * static_cast<int>(sizeof(float));
  static bool attr_set = false;  // per instantiation, once per process
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_set = true;
  }
  const dim3 grid((S + kBQ - 1) / kBQ, H, B);
  flash_fwd<T, HD><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, S, H, Skv, KV,
      causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_hd(int hd, const void* q, const void* k, const void* v, void* o,
                float* lse, int B, int S, int H, int Skv, int KV, int causal,
                int window, float scale, cudaStream_t stream) {
  switch (hd) {
    case 16: return launch<T, 16>(q, k, v, o, lse, B, S, H, Skv, KV, causal, window, scale, stream);
    case 32: return launch<T, 32>(q, k, v, o, lse, B, S, H, Skv, KV, causal, window, scale, stream);
    case 64: return launch<T, 64>(q, k, v, o, lse, B, S, H, Skv, KV, causal, window, scale, stream);
    case 128: return launch<T, 128>(q, k, v, o, lse, B, S, H, Skv, KV, causal, window, scale, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}


// ------------------------------------------------------------ flash_fwd_wgmma
constexpr int kWgBQ = 128;        // query rows per block: two warpgroups of 64
constexpr int kWgBK = 128;        // keys per K/V tile
constexpr int kWgThreads = 384;   // warpgroups 0-1 consume, warpgroup 2 produces
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

template <int HD>
__host__ __device__ constexpr int wg_stages() { return HD == 64 ? 3 : 2; }
template <int HD>
__host__ __device__ constexpr int wg_smem_bytes() {
  // q [128 × HD], K and V [kWgBK × HD] per stage (bf16), 1 + 3 barriers per
  // stage, 1024 bytes of alignment slack
  return kWgBQ * HD * 2 + wg_stages<HD>() * (2 * kWgBK * HD * 2 + 24) + 8 + 1024;
}

// the rows a consumer thread owns and what masks them
struct WgRows {
  int row0;   // first of the thread's two query rows (the other is row0 + 8)
  int qw;     // first query row of the warpgroup
  int cc;     // 2·(lane % 4): the thread's first column in each 8-wide slice
  int Skv, causal, window;
  float scale_log2;
};

// issue S = q·kᵀ over HD / 16 slices of 16 (committed, not waited)
template <int HD>
__device__ __forceinline__ void issue_scores(float (&sacc)[kWgBK / 2], const uint8_t* qw_s,
                                             const uint8_t* k_stage) {
  constexpr int kQRegion = 64 * 128, kKVRegion = kWgBK * 128;
  hopper::fence_regs(sacc);
  hopper::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const uint64_t da = hopper::desc_sw128(qw_s + (kk / 4) * kQRegion + 32 * (kk % 4), 0, 1024);
    const uint64_t db = hopper::desc_sw128(k_stage + (kk / 4) * kKVRegion + 32 * (kk % 4), 0, 1024);
    hopper::wgmma_ss_n128<0>(sacc, da, db, kk > 0);
  }
  hopper::wgmma_commit();
}

// issue O += P·V for the V tile in stage v_stage (committed, not waited;
// the caller has fenced O and P)
template <int HD>
__device__ __forceinline__ void issue_pv(float (&oacc)[HD / 2], const uint32_t (&pa)[kWgBK / 16][4],
                                         const uint8_t* v_stage) {
  const uint64_t dv = hopper::desc_sw128(v_stage, kWgBK * 128, 1024);
#pragma unroll
  for (int kk = 0; kk < kWgBK / 16; ++kk) {
    if constexpr (HD == 128)
      hopper::wgmma_rs_n128<1>(oacc, pa[kk], hopper::desc_add(dv, 2048 * kk), 1);
    else
      hopper::wgmma_rs_n64<1>(oacc, pa[kk], hopper::desc_add(dv, 2048 * kk), 1);
  }
  hopper::wgmma_commit();
}

// the scores of the BK-key tile at k0 → scaled to log2 units, masked where the
// mask reaches the tile, the online softmax's m and l updated, the rescale
// of O in corr and the probabilities (fp32) in sacc; each row lives on the
// four threads lane & ~3 .. lane | 3
template <int BK>
__device__ __forceinline__ void softmax_tile(float (&sacc)[BK / 2], float (&m)[2], float (&l)[2],
                                             float (&corr)[2], int k0, const WgRows& w) {
  const bool edge = k0 + BK > w.Skv || (w.causal && k0 + BK - 1 > w.qw) ||
                    (w.window >= 0 && k0 <= w.qw + 63 - w.window);
#pragma unroll
  for (int j = 0; j < BK / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float v = sacc[4 * j + e] * w.scale_log2;
      if (edge) {
        const int kp = k0 + 8 * j + w.cc + (e & 1), qp = w.row0 + 8 * (e >> 1);
        bool ok = kp < w.Skv;
        if (w.causal) ok = ok && kp <= qp;
        if (w.window >= 0) ok = ok && kp > qp - w.window;
        if (!ok) v = kNegInf;
      }
      sacc[4 * j + e] = v;
    }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mx = kNegInf;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
      mx = fmaxf(mx, fmaxf(sacc[4 * j + 2 * r], sacc[4 * j + 2 * r + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m[r], mx);
    corr[r] = exp2f(m[r] - m_new);
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      const float p0 = exp2f(sacc[4 * j + 2 * r] - m_new);
      const float p1 = exp2f(sacc[4 * j + 2 * r + 1] - m_new);
      sacc[4 * j + 2 * r] = p0;
      sacc[4 * j + 2 * r + 1] = p1;
      sum += p0 + p1;
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    l[r] = l[r] * corr[r] + sum;
    m[r] = m_new;
  }
}

// P (the probabilities in sacc) rounded to bf16, as wgmma's A fragments:
// slice kk holds keys 16kk .. 16kk + 15
__device__ __forceinline__ void pack_p(const float (&sacc)[kWgBK / 2], uint32_t (&pa)[kWgBK / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < kWgBK / 16; ++kk) {
    pa[kk][0] = hopper::pack_bf16(sacc[8 * kk], sacc[8 * kk + 1]);
    pa[kk][1] = hopper::pack_bf16(sacc[8 * kk + 2], sacc[8 * kk + 3]);
    pa[kk][2] = hopper::pack_bf16(sacc[8 * kk + 4], sacc[8 * kk + 5]);
    pa[kk][3] = hopper::pack_bf16(sacc[8 * kk + 6], sacc[8 * kk + 7]);
  }
}

template <int HD>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_fwd_wgmma(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
                const __grid_constant__ CUtensorMap vmap, __nv_bfloat16* __restrict__ o,
                float* __restrict__ lse, int S, int H, int Skv, int KV, int causal, int window,
                float scale_log2) {
  constexpr int NST = wg_stages<HD>();
  constexpr int NHB = HD / 64;                   // 64-wide column regions of a row
  constexpr int kQRegion = 64 * 128;             // 64 rows × 128 bytes
  constexpr int kKVRegion = kWgBK * 128;         // 128 keys × 128 bytes
  constexpr int kTileBytes = kWgBK * HD * 2;     // one K (or V) tile
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = hopper::align_smem_1024(smem_raw);
  uint8_t* qs = smem;                                  // [2 wg][NHB][64 × 128 B]
  uint8_t* ks = qs + kWgBQ * HD * 2;                   // [NST][NHB][kWgBK × 128 B]
  uint8_t* vs = ks + NST * kTileBytes;
  uint64_t* kfull = reinterpret_cast<uint64_t*>(vs + NST * kTileBytes);
  uint64_t* vfull = kfull + NST;
  uint64_t* empty = vfull + NST;
  uint64_t* qfull = empty + NST;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kWgBQ;  // last tile first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  // KV tiles inside the band of this block's rows (pl.when(needed) in Pallas)
  int kv_hi = causal ? min(Skv, q0 + kWgBQ) : Skv;
  int kv_lo = window >= 0 ? max(0, q0 - window + 1) : 0;
  kv_lo = (kv_lo / kWgBK) * kWgBK;
  const int ntiles = kv_hi > kv_lo ? (kv_hi - kv_lo + kWgBK - 1) / kWgBK : 0;
  const int n_wg = q0 + 64 < S ? 2 : 1;  // a warpgroup whose rows all lie past S exits
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < NST; ++s) {
      hopper::mbar_init(&kfull[s], 1);
      hopper::mbar_init(&vfull[s], 1);
      hopper::mbar_init(&empty[s], 128 * n_wg);
    }
    hopper::mbar_init(qfull, 1);
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (warp >= 8) {  // producer warpgroup: one thread issues every TMA load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (warp == 8 && lane == 0) {
      hopper::prefetch_tensormap(&qmap);
      hopper::prefetch_tensormap(&kmap);
      hopper::prefetch_tensormap(&vmap);
      hopper::mbar_expect_tx(qfull, kWgBQ * HD * 2);
#pragma unroll
      for (int w = 0; w < 2; ++w)
#pragma unroll
        for (int j = 0; j < NHB; ++j)
          hopper::tma_load_4d(qs + (w * NHB + j) * kQRegion, &qmap, qfull, 64 * j, h,
                              q0 + 64 * w, b);
      for (int i = 0; i < ntiles; ++i) {
        const int s = i % NST, k0 = kv_lo + i * kWgBK;
        if (i >= NST) hopper::mbar_wait(&empty[s], ((i / NST) - 1) & 1);
        hopper::mbar_expect_tx(&kfull[s], kTileBytes);
#pragma unroll
        for (int j = 0; j < NHB; ++j)
          hopper::tma_load_4d(ks + s * kTileBytes + j * kKVRegion, &kmap, &kfull[s], 64 * j, kvh,
                              k0, b);
        hopper::mbar_expect_tx(&vfull[s], kTileBytes);
#pragma unroll
        for (int j = 0; j < NHB; ++j)
          hopper::tma_load_4d(vs + s * kTileBytes + j * kKVRegion, &vmap, &vfull[s], 64 * j, kvh,
                              k0, b);
      }
    }
    return;
  }
  // consumers take the registers the producer gave back (24 → 240 a thread)
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
  const int wg = warp / 4;
  if (wg >= n_wg) return;

  // this thread's two rows (accumulator layout): 16·(warp % 4) + lane / 4 (+8)
  const int qw = q0 + 64 * wg;
  const int row0 = qw + 16 * (warp % 4) + lane / 4;
  const int cc = 2 * (lane % 4);
  float sacc[kWgBK / 2], oacc[HD / 2];
#pragma unroll
  for (int i = 0; i < kWgBK / 2; ++i) sacc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) oacc[i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f}, corr[2];
  uint32_t pa[kWgBK / 16][4];
  const uint8_t* qw_s = qs + wg * NHB * kQRegion;
  const WgRows rows{row0, qw, cc, Skv, causal, window, scale_log2};
  hopper::mbar_wait(qfull, 0);

  // Software pipeline: q·kᵀ of tile i + 1 is issued before P·V of tile i,
  // and its softmax runs on the CUDA cores while P·V_i runs on the tensor
  // cores; P_{i+1} replaces P_i in pa only once P·V_i has completed.
  if (ntiles > 0) {
    hopper::mbar_wait(&kfull[0], 0);
    issue_scores<HD>(sacc, qw_s, ks);
    hopper::wgmma_wait<0>();
    hopper::fence_regs(sacc);
    softmax_tile<kWgBK>(sacc, m, l, corr, kv_lo, rows);  // O is 0: corr unused
    pack_p(sacc, pa);
  }
  // every tile but the last: q·kᵀ of the next tile, then P·V of this one
  for (int i = 0; i + 1 < ntiles; ++i) {
    const int s = i % NST, s1 = (i + 1) % NST;
    hopper::mbar_wait(&kfull[s1], ((i + 1) / NST) & 1);
    issue_scores<HD>(sacc, qw_s, ks + s1 * kTileBytes);
    hopper::mbar_wait(&vfull[s], (i / NST) & 1);
    hopper::fence_regs(oacc);
    hopper::wgmma_fence();
    issue_pv<HD>(oacc, pa, vs + s * kTileBytes);
    hopper::wgmma_wait<1>();  // q·kᵀ of tile i + 1 is done; P·V of tile i may run on
    hopper::fence_regs(sacc);
    softmax_tile<kWgBK>(sacc, m, l, corr, kv_lo + (i + 1) * kWgBK, rows);
    hopper::wgmma_wait<0>();
    hopper::fence_regs(oacc);
    hopper::fence_regs(pa);
    hopper::mbar_arrive(&empty[s]);
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      oacc[4 * j] *= corr[0];
      oacc[4 * j + 1] *= corr[0];
      oacc[4 * j + 2] *= corr[1];
      oacc[4 * j + 3] *= corr[1];
    }
    pack_p(sacc, pa);
  }
  if (ntiles > 0) {  // the last tile's P·V
    const int s = (ntiles - 1) % NST;
    hopper::mbar_wait(&vfull[s], ((ntiles - 1) / NST) & 1);
    hopper::fence_regs(oacc);
    hopper::wgmma_fence();
    issue_pv<HD>(oacc, pa, vs + s * kTileBytes);
    hopper::wgmma_wait<0>();
    hopper::fence_regs(oacc);
    hopper::fence_regs(pa);
  }

  // o = O / max(l, 1e-30) in bf16; lse = m·ln2 + log l
  const long long q_row = static_cast<long long>(H) * HD;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qp = row0 + 8 * r;
    if (qp >= S) continue;
    const float li = fmaxf(l[r], 1e-30f);
    const float inv = 1.f / li;
    __nv_bfloat16* orow = o + (static_cast<long long>(b) * S + qp) * q_row +
                          static_cast<long long>(h) * HD + cc;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) =
          __floats2bfloat162_rn(oacc[4 * j + 2 * r] * inv, oacc[4 * j + 2 * r + 1] * inv);
    if (lane % 4 == 0)
      lse[(static_cast<long long>(b) * H + h) * S + qp] = m[r] * kLn2 + logf(li);
  }
}

template <int HD>
int launch_wgmma(const void* q, const void* k, const void* v, void* o, float* lse, int B, int S,
                 int H, int Skv, int KV, int causal, int window, float scale,
                 cudaStream_t stream) {
  constexpr int bytes = wg_smem_bytes<HD>();
  CUtensorMap qm, km, vm;
  const uint64_t e = 2;  // bytes per bf16
  const uint64_t qdims[4] = {HD, static_cast<uint64_t>(H), static_cast<uint64_t>(S),
                             static_cast<uint64_t>(B)};
  const uint64_t qstr[3] = {HD * e, static_cast<uint64_t>(H) * HD * e,
                            static_cast<uint64_t>(S) * H * HD * e};
  const uint32_t qbox[4] = {64, 1, 64, 1};
  const uint64_t kdims[4] = {HD, static_cast<uint64_t>(KV), static_cast<uint64_t>(Skv),
                             static_cast<uint64_t>(B)};
  const uint64_t kstr[3] = {HD * e, static_cast<uint64_t>(KV) * HD * e,
                            static_cast<uint64_t>(Skv) * KV * HD * e};
  const uint32_t kbox[4] = {64, 1, kWgBK, 1};
  int err = hopper::encode_bf16_map(&qm, q, 4, qdims, qstr, qbox);
  if (err == 0) err = hopper::encode_bf16_map(&km, k, 4, kdims, kstr, kbox);
  if (err == 0) err = hopper::encode_bf16_map(&vm, v, 4, kdims, kstr, kbox);
  if (err != 0) return err;
  static bool attr_set = false;  // per instantiation, once per process
  if (!attr_set) {
    const cudaError_t cerr = cudaFuncSetAttribute(
        flash_fwd_wgmma<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (cerr != cudaSuccess) return static_cast<int>(cerr);
    attr_set = true;
  }
  const dim3 grid((S + kWgBQ - 1) / kWgBQ, H, B);
  flash_fwd_wgmma<HD><<<grid, kWgThreads, bytes, stream>>>(
      qm, km, vm, static_cast<__nv_bfloat16*>(o), lse, S, H, Skv, KV, causal, window,
      scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

// ----------------------------------------------------------- flash_fwd_tf32x3
constexpr int kTfBQ = 128;                     // query rows per block: two warpgroups of 64
constexpr int kTfBK64 = 64;                    // keys per K/V tile at head_dim 64
constexpr int kTfBK128 = 32;                   // keys per K/V tile at head_dim 128
constexpr int kTfThreads = 384;                // warpgroups 0-1 consume, 2 loads and splits
constexpr int kTfStages = 2;                   // depth of the K, V and Vᵀ rings
constexpr int kTfSplitters = 96;               // warps 9-11 of the producer warpgroup
constexpr int kTfPack = 64;                    // two heads a block when S, Skv ≤ this
constexpr int kTfPvN = 64;                     // dims of one P·V product (m64n64k8)

// the tile geometry at head_dim HD: BK keys a tile (64 at HD 64, 32 at HD
// 128, so that one fp32 K, V or Vᵀ tile is 16 KB at both), and the byte
// sizes of the 128-byte-wide swizzle regions of each tile kind
template <int HD>
struct TfTile {
  static constexpr int BK = HD == 64 ? kTfBK64 : kTfBK128;
  static constexpr int kTile = BK * HD * 4;      // one fp32 K, V or Vᵀ tile
  static constexpr int kQTile = 64 * HD * 4;     // one warpgroup's q_small
  static constexpr int kQRegion = 64 * 128;      // q_small: 64 rows × 32 dims
  static constexpr int kKVRegion = BK * 128;     // K, K_small, V: BK keys × 32 dims
  static constexpr int kVtRegion = HD * 128;     // Vᵀ: HD dims × 32 keys
  static constexpr int kHalves = HD / kTfPvN;    // P·V products a tile, n64 each
};

template <int HD>
__host__ __device__ constexpr int tf_smem_bytes() {
  // q_small of each consumer warpgroup (64 rows × HD dims); per stage: K
  // (rounded in place), K_small, V as loaded, Vᵀ_big, Vᵀ_small and 7
  // barriers; 1024 bytes of alignment slack.  HD 64: 197,744 B; HD 128:
  // 230,512 B of the 232,448 a block may use
  return 2 * TfTile<HD>::kQTile + kTfStages * (5 * TfTile<HD>::kTile + 7 * 8) + 1024;
}

// x → big = tf32(x) and small = tf32(x − big), both rounded to nearest (ties
// away): big + small is x to 2^-22 of |x|
__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
  big = hopper::tf32_rna(x);
  small = hopper::tf32_rna(x - __uint_as_float(big));
}

// one m64nNk8 tf32 product, N = 32 or 64: A from registers or shared memory
template <int N>
__device__ __forceinline__ void tf32_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t db,
                                        int scale_d) {
  if constexpr (N == 64)
    hopper::wgmma_tf32_rs_n64(d, a, db, scale_d);
  else
    hopper::wgmma_tf32_rs_n32(d, a, db, scale_d);
}
template <int N>
__device__ __forceinline__ void tf32_ss(float (&d)[N / 2], uint64_t da, uint64_t db, int scale_d) {
  if constexpr (N == 64)
    hopper::wgmma_tf32_ss_n64(d, da, db, scale_d);
  else
    hopper::wgmma_tf32_ss_n32(d, da, db, scale_d);
}

// issue S = q·kᵀ as 3xTF32 over HD / 8 slices of 8 dims into one fp32
// fragment (committed, not waited): the small products first (q_small·K_big,
// q_big·K_small), then q_big·K_big, so the tensor cores' truncating
// accumulation meets the full-size sum in HD / 8 steps rather than 3·HD / 8.
// qs: this warpgroup's q_small in shared memory; kb/ks: the rounded K tile
// and K_small; all K-major (a 128-byte row of 32 dims, HD / 32 regions)
template <int HD>
__device__ __forceinline__ void issue_scores_tf32(float (&sacc)[TfTile<HD>::BK / 2],
                                                  const uint32_t (&qb)[HD / 8][4],
                                                  const uint8_t* qs, const uint8_t* kb,
                                                  const uint8_t* ks) {
  using T = TfTile<HD>;
  hopper::fence_regs(sacc);
  hopper::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < HD / 8; ++kk) {
    const int oq = (kk / 4) * T::kQRegion + 32 * (kk % 4);
    const int ok = (kk / 4) * T::kKVRegion + 32 * (kk % 4);
    tf32_ss<T::BK>(sacc, hopper::desc_sw128(qs + oq, 0, 1024),
                   hopper::desc_sw128(kb + ok, 0, 1024), kk > 0);
  }
#pragma unroll
  for (int kk = 0; kk < HD / 8; ++kk) {
    const int ok = (kk / 4) * T::kKVRegion + 32 * (kk % 4);
    tf32_rs<T::BK>(sacc, qb[kk], hopper::desc_sw128(ks + ok, 0, 1024), 1);
  }
#pragma unroll
  for (int kk = 0; kk < HD / 8; ++kk) {
    const int ok = (kk / 4) * T::kKVRegion + 32 * (kk % 4);
    tf32_rs<T::BK>(sacc, qb[kk], hopper::desc_sw128(kb + ok, 0, 1024), 1);
  }
  hopper::wgmma_commit();
}

// issue dims 64·half .. 64·half + 63 of this tile's P·V as 3xTF32 over BK / 8
// slices of 8 keys into a fresh fp32 fragment pv (committed, not waited; the
// caller has fenced pv and P), small products first; the caller adds pv to
// O in fp32 (round to nearest), so O's truncating tensor-core accumulation
// spans one tile, not the row.  vb/vs: Vᵀ_big and Vᵀ_small, K-major (a
// 128-byte row of 32 keys per dim, BK / 32 regions, keys permuted as
// split_p's)
template <int HD>
__device__ __forceinline__ void issue_pv_tf32(float (&pv)[kTfPvN / 2],
                                              const uint32_t (&pb)[TfTile<HD>::BK / 8][4],
                                              const uint32_t (&ps)[TfTile<HD>::BK / 8][4],
                                              const uint8_t* vb, const uint8_t* vs, int half) {
  using T = TfTile<HD>;
  const int o0 = half * kTfPvN * 128;  // the half's first Vᵀ row
#pragma unroll
  for (int kk = 0; kk < T::BK / 8; ++kk) {
    const int off = o0 + (kk / 4) * T::kVtRegion + 32 * (kk % 4);
    hopper::wgmma_tf32_rs_n64(pv, ps[kk], hopper::desc_sw128(vb + off, 0, 1024), kk > 0);
  }
#pragma unroll
  for (int kk = 0; kk < T::BK / 8; ++kk) {
    const int off = o0 + (kk / 4) * T::kVtRegion + 32 * (kk % 4);
    hopper::wgmma_tf32_rs_n64(pv, pb[kk], hopper::desc_sw128(vs + off, 0, 1024), 1);
  }
#pragma unroll
  for (int kk = 0; kk < T::BK / 8; ++kk) {
    const int off = o0 + (kk / 4) * T::kVtRegion + 32 * (kk % 4);
    hopper::wgmma_tf32_rs_n64(pv, pb[kk], hopper::desc_sw128(vb + off, 0, 1024), 1);
  }
  hopper::wgmma_commit();
}

// P (the probabilities in sacc) split into tf32 A fragments.  The f32
// accumulator gives this thread keys 8kk + 2t and 8kk + 2t + 1 (t = lane % 4)
// of its rows r and r + 8; the tf32 A fragment wants columns t and t + 4.  So
// column t carries key 2t and column t + 4 key 2t + 1, and the Vᵀ rows store
// each 8-key group in the same order (0, 2, 4, 6, 1, 3, 5, 7): no shuffles.
template <int BK>
__device__ __forceinline__ void split_p(const float (&sacc)[BK / 2], uint32_t (&pb)[BK / 8][4],
                                        uint32_t (&ps)[BK / 8][4]) {
#pragma unroll
  for (int kk = 0; kk < BK / 8; ++kk) {
    split_tf32(sacc[4 * kk], pb[kk][0], ps[kk][0]);      // row r,     key 2t
    split_tf32(sacc[4 * kk + 2], pb[kk][1], ps[kk][1]);  // row r + 8, key 2t
    split_tf32(sacc[4 * kk + 1], pb[kk][2], ps[kk][2]);  // row r,     key 2t + 1
    split_tf32(sacc[4 * kk + 3], pb[kk][3], ps[kk][3]);  // row r + 8, key 2t + 1
  }
}

// O = (O + P·V)·corr in fp32 for the dims of P·V product `half` (pv holds
// them in the n64 accumulator layout: pv[4j + e] is oacc[32·half + 4j + e])
template <int HD>
__device__ __forceinline__ void add_pv(float (&oacc)[HD / 2], const float (&pv)[kTfPvN / 2],
                                       const float (&corr)[2], int half) {
#pragma unroll
  for (int j = 0; j < kTfPvN / 8; ++j) {
    float* o = oacc + (kTfPvN / 2) * half + 4 * j;
    o[0] = (o[0] + pv[4 * j]) * corr[0];
    o[1] = (o[1] + pv[4 * j + 1]) * corr[0];
    o[2] = (o[2] + pv[4 * j + 2]) * corr[1];
    o[3] = (o[3] + pv[4 * j + 3]) * corr[1];
  }
}

template <int HD>
__global__ void __launch_bounds__(kTfThreads, 1)
flash_fwd_tf32x3(const __grid_constant__ CUtensorMap kmap, const __grid_constant__ CUtensorMap vmap,
                 const float* __restrict__ q, float* __restrict__ o, float* __restrict__ lse,
                 int S, int H, int Skv, int KV, int causal, int window, float scale,
                 int packed) {
  using T = TfTile<HD>;
  constexpr int NST = kTfStages, BK = T::BK, TILE = T::kTile;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = hopper::align_smem_1024(smem_raw);
  uint8_t* qsml = smem;                          // [2 wg][HD / 32 regions: 64 rows × 32 dims]
  uint8_t* kbig = qsml + 2 * T::kQTile;          // [NST][HD / 32 regions: BK keys × 32 dims]
  uint8_t* ksml = kbig + NST * TILE;
  uint8_t* vraw = ksml + NST * TILE;             // [NST][HD / 32 regions: BK keys × 32 dims]
  uint8_t* vtb = vraw + NST * TILE;              // [NST][BK / 32 regions: HD dims × 32 keys]
  uint8_t* vts = vtb + NST * TILE;
  uint64_t* kfull = reinterpret_cast<uint64_t*>(vts + NST * TILE);  // K landed (TMA)
  uint64_t* kready = kfull + NST;    // K rounded in place and K_small written
  uint64_t* kempty = kready + NST;   // the consumers' q·kᵀ has read the K stage
  uint64_t* vfull = kempty + NST;    // V landed (TMA)
  uint64_t* vfree = vfull + NST;     // the splitters have read V
  uint64_t* vtready = vfree + NST;   // Vᵀ_big and Vᵀ_small written
  uint64_t* vtempty = vtready + NST; // the consumers' P·V has read the Vᵀ stage

  // packed (S, Skv ≤ 64): the block owns heads h0 and h0 + 1, one per
  // consumer warpgroup, and the producer interleaves their tiles (load i is
  // tile i / n_wg of head h0 + i % n_wg: with two heads and two stages each
  // head keeps its own stage); else 128 query rows of head h0, the
  // warpgroups sharing the band's K/V tiles
  const int q0 = packed ? 0 : (gridDim.x - 1 - blockIdx.x) * kTfBQ;  // last tile first
  const int h0 = packed ? 2 * blockIdx.y : blockIdx.y, b = blockIdx.z;
  const int G = H / KV;
  // KV tiles inside the band of this block's rows (pl.when(needed) in Pallas)
  int kv_hi = causal ? min(Skv, min(S, q0 + kTfBQ)) : Skv;
  int kv_lo = window >= 0 ? max(0, q0 - window + 1) : 0;
  kv_lo = (kv_lo / BK) * BK;
  const int ntiles = kv_hi > kv_lo ? (kv_hi - kv_lo + BK - 1) / BK : 0;
  // consumer warpgroups (one whose rows all lie past S, or whose head is past
  // H, exits) and the tiles the producer loads
  const int n_wg = packed ? min(2, H - h0) : (q0 + 64 < S ? 2 : 1);
  const int heads = packed ? n_wg : 1;           // heads whose tiles the producer loads
  const int nloads = ntiles * heads;
  const int readers = 128 * (packed ? 1 : n_wg);  // consumer threads that read a stage
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < NST; ++s) {
      hopper::mbar_init(&kfull[s], 1);
      hopper::mbar_init(&kready[s], kTfSplitters);
      hopper::mbar_init(&kempty[s], readers);
      hopper::mbar_init(&vfull[s], 1);
      hopper::mbar_init(&vfree[s], kTfSplitters);
      hopper::mbar_init(&vtready[s], kTfSplitters);
      hopper::mbar_init(&vtempty[s], readers);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (warp >= 8) {  // producer warpgroup: warp 8 loads, warps 9-11 split
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (warp == 8) {
      if (lane == 0) {
        hopper::prefetch_tensormap(&kmap);
        hopper::prefetch_tensormap(&vmap);
        for (int i = 0; i < nloads; ++i) {
          const int s = i % NST;
          const int k0 = kv_lo + (i / heads) * BK, kvh = (h0 + i % heads) / G;
          if (i >= NST) hopper::mbar_wait(&kempty[s], ((i / NST) - 1) & 1);
          hopper::mbar_expect_tx(&kfull[s], TILE);
#pragma unroll
          for (int j = 0; j < HD / 32; ++j)
            hopper::tma_load_4d(kbig + s * TILE + j * T::kKVRegion, &kmap, &kfull[s], 32 * j,
                                kvh, k0, b);
          if (i >= NST) hopper::mbar_wait(&vfree[s], ((i / NST) - 1) & 1);
          hopper::mbar_expect_tx(&vfull[s], TILE);
#pragma unroll
          for (int j = 0; j < HD / 32; ++j)
            hopper::tma_load_4d(vraw + s * TILE + j * T::kKVRegion, &vmap, &vfull[s], 32 * j,
                                kvh, k0, b);
        }
      }
      return;
    }
    // splitters: K → K_big (in place) and K_small, elementwise at the same
    // offsets; V [keys][dims] → Vᵀ_big and Vᵀ_small [dims][keys], keys
    // permuted within each group of 8 as split_p pairs them
    const int sid = threadIdx.x - 9 * 32, sw = sid / 32;
    // this lane's key within a 32-key region, and its column in a Vᵀ row
    const int c = (lane & ~7) | ((lane & 1) << 2) | ((lane & 7) >> 1);
    for (int i = 0; i < nloads; ++i) {
      const int s = i % NST;
      const uint32_t ph = (i / NST) & 1;
      hopper::mbar_wait(&kfull[s], ph);
      float4* kb4 = reinterpret_cast<float4*>(kbig + s * TILE);
      float4* ks4 = reinterpret_cast<float4*>(ksml + s * TILE);
      for (int e = sid; e < TILE / 16; e += kTfSplitters) {
        const float4 x = kb4[e];
        uint32_t b0, b1, b2, b3, s0, s1, s2, s3;
        split_tf32(x.x, b0, s0);
        split_tf32(x.y, b1, s1);
        split_tf32(x.z, b2, s2);
        split_tf32(x.w, b3, s3);
        kb4[e] = make_float4(__uint_as_float(b0), __uint_as_float(b1), __uint_as_float(b2),
                             __uint_as_float(b3));
        ks4[e] = make_float4(__uint_as_float(s0), __uint_as_float(s1), __uint_as_float(s2),
                             __uint_as_float(s3));
      }
      hopper::fence_proxy_async();
      hopper::mbar_arrive(&kready[s]);

      hopper::mbar_wait(&vfull[s], ph);
      if (i >= NST) hopper::mbar_wait(&vtempty[s], ph ^ 1);
      const uint8_t* vr = vraw + s * TILE;
      float* tb = reinterpret_cast<float*>(vtb + s * TILE);
      float* ts = reinterpret_cast<float*>(vts + s * TILE);
      // (32-key region kb, dims 4dc .. 4dc + 3)
      for (int t = sw; t < (BK / 32) * (HD / 4); t += 3) {
        const int kb = t / (HD / 4), dc = t % (HD / 4);
        const int key = 32 * kb + lane;
        const float4 x = *reinterpret_cast<const float4*>(
            vr + (dc / 8) * T::kKVRegion + key * 128 + (((dc % 8) ^ (key % 8)) << 4));
        const float xs[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int n = 4 * dc + e;
          const int off =
              kb * (T::kVtRegion / 4) + n * 32 + ((((c >> 2) ^ (n & 7)) << 2) | (c & 3));
          uint32_t big, small;
          split_tf32(xs[e], big, small);
          tb[off] = __uint_as_float(big);
          ts[off] = __uint_as_float(small);
        }
      }
      hopper::fence_proxy_async();
      hopper::mbar_arrive(&vtready[s]);
      hopper::mbar_arrive(&vfree[s]);
    }
    return;
  }
  // consumers take the registers the producer gave back (40 → 232 a thread)
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int wg = warp / 4;
  if (wg >= n_wg) return;

  // this thread's head and two rows (accumulator layout): 16·(warp % 4) +
  // lane / 4 (+8); its tile t is the producer's load t·heads + sb
  const int h = h0 + (packed ? wg : 0), sb = packed ? wg : 0;
  const int qw = q0 + (packed ? 0 : 64 * wg);
  const int row0 = qw + 16 * (warp % 4) + lane / 4;
  const int t4 = lane % 4;
  const long long q_row = static_cast<long long>(H) * HD;
  // q·scale split once per block: q_big as tf32 A fragments in registers
  // (rows row0, row0 + 8; dims 8kk + t4, +4), q_small into this warpgroup's
  // K-major tile in shared memory (an operand from shared memory, which
  // leaves registers for the per-tile P·V fragment)
  uint32_t qb[HD / 8][4];
  uint8_t* qs_w = qsml + wg * T::kQTile;
  {
    const float* qr = q + (static_cast<long long>(b) * S + row0) * q_row +
                      static_cast<long long>(h) * HD + t4;
    const bool in0 = row0 < S, in1 = row0 + 8 < S;
    const int rl = row0 - qw;  // the row within the warpgroup's 64
#pragma unroll
    for (int kk = 0; kk < HD / 8; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool in = (e & 1) ? in1 : in0;
        const float x = in ? __ldg(qr + (e & 1) * 8 * q_row + 8 * kk + 4 * (e >> 1)) * scale : 0.f;
        uint32_t small;
        split_tf32(x, qb[kk][e], small);
        const int r = rl + 8 * (e & 1), d = 8 * kk + t4 + 4 * (e >> 1);
        *reinterpret_cast<uint32_t*>(qs_w + (d / 32) * T::kQRegion + r * 128 +
                                     ((((d % 32) >> 2) ^ (r & 7)) << 4) + (d & 3) * 4) = small;
      }
    hopper::fence_proxy_async();
    hopper::named_barrier_sync(1 + wg, 128);
  }
  float sacc[BK / 2], oacc[HD / 2], pv[kTfPvN / 2];
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) sacc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) oacc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < kTfPvN / 2; ++i) pv[i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f}, corr[2];
  uint32_t pb[BK / 8][4], ps[BK / 8][4];
  const WgRows rows{row0, qw, 2 * t4, Skv, causal, window, kLog2e};  // q holds the scale

  // the pipeline of flash_fwd_wgmma: q·kᵀ of tile i + 1 is issued before P·V
  // of tile i, and its softmax runs while P·V_i (its first n64 half at HD
  // 128) is on the tensor cores
  if (ntiles > 0) {
    const int s = sb % NST;
    hopper::mbar_wait(&kready[s], (sb / NST) & 1);
    issue_scores_tf32<HD>(sacc, qb, qs_w, kbig + s * TILE, ksml + s * TILE);
    hopper::wgmma_wait<0>();
    hopper::fence_regs(sacc);
    hopper::mbar_arrive(&kempty[s]);
    softmax_tile<BK>(sacc, m, l, corr, kv_lo, rows);  // O is 0: corr unused
    split_p<BK>(sacc, pb, ps);
  }
  for (int i = 0; i + 1 < ntiles; ++i) {
    const int j = sb + i * heads, j1 = j + heads, s = j % NST, s1 = j1 % NST;
    hopper::mbar_wait(&kready[s1], (j1 / NST) & 1);
    issue_scores_tf32<HD>(sacc, qb, qs_w, kbig + s1 * TILE, ksml + s1 * TILE);
    hopper::mbar_wait(&vtready[s], (j / NST) & 1);
    hopper::fence_regs(pv);
    hopper::wgmma_fence();
    issue_pv_tf32<HD>(pv, pb, ps, vtb + s * TILE, vts + s * TILE, 0);
    hopper::wgmma_wait<1>();  // q·kᵀ of tile i + 1 is done; P·V of tile i may run on
    hopper::fence_regs(sacc);
    hopper::mbar_arrive(&kempty[s1]);
    softmax_tile<BK>(sacc, m, l, corr, kv_lo + (i + 1) * BK, rows);
    hopper::wgmma_wait<0>();
    hopper::fence_regs(pv);
    add_pv<HD>(oacc, pv, corr, 0);  // O = (O + P_i·V_i) · corr, in fp32
#pragma unroll
    for (int half = 1; half < T::kHalves; ++half) {
      hopper::fence_regs(pv);
      hopper::wgmma_fence();
      issue_pv_tf32<HD>(pv, pb, ps, vtb + s * TILE, vts + s * TILE, half);
      hopper::wgmma_wait<0>();
      hopper::fence_regs(pv);
      add_pv<HD>(oacc, pv, corr, half);
    }
    hopper::fence_regs(pb);
    hopper::fence_regs(ps);
    hopper::mbar_arrive(&vtempty[s]);
    split_p<BK>(sacc, pb, ps);
  }
  if (ntiles > 0) {  // the last tile's P·V
    const int j = sb + (ntiles - 1) * heads, s = j % NST;
    const float one[2] = {1.f, 1.f};
    hopper::mbar_wait(&vtready[s], (j / NST) & 1);
#pragma unroll
    for (int half = 0; half < T::kHalves; ++half) {
      hopper::fence_regs(pv);
      hopper::wgmma_fence();
      issue_pv_tf32<HD>(pv, pb, ps, vtb + s * TILE, vts + s * TILE, half);
      hopper::wgmma_wait<0>();
      hopper::fence_regs(pv);
      add_pv<HD>(oacc, pv, one, half);
    }
    hopper::fence_regs(pb);
    hopper::fence_regs(ps);
  }

  // o = O / max(l, 1e-30) in fp32; lse = m·ln2 + log l
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qp = row0 + 8 * r;
    if (qp >= S) continue;
    const float li = fmaxf(l[r], 1e-30f);
    float* orow = o + (static_cast<long long>(b) * S + qp) * q_row +
                  static_cast<long long>(h) * HD + 2 * t4;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<float2*>(orow + 8 * j) =
          make_float2(oacc[4 * j + 2 * r] / li, oacc[4 * j + 2 * r + 1] / li);
    if (t4 == 0) lse[(static_cast<long long>(b) * H + h) * S + qp] = m[r] * kLn2 + logf(li);
  }
}

template <int HD>
int launch_tf32x3(const void* q, const void* k, const void* v, void* o, float* lse, int B, int S,
                  int H, int Skv, int KV, int causal, int window, float scale,
                  cudaStream_t stream) {
  constexpr int bytes = tf_smem_bytes<HD>();
  const uint64_t e = 4;  // bytes per fp32
  CUtensorMap km, vm;
  const uint64_t kdims[4] = {HD, static_cast<uint64_t>(KV), static_cast<uint64_t>(Skv),
                             static_cast<uint64_t>(B)};
  const uint64_t kstr[3] = {HD * e, static_cast<uint64_t>(KV) * HD * e,
                            static_cast<uint64_t>(Skv) * KV * HD * e};
  const uint32_t kbox[4] = {32, 1, TfTile<HD>::BK, 1};
  int err = hopper::encode_f32_map(&km, k, 4, kdims, kstr, kbox);
  if (err == 0) err = hopper::encode_f32_map(&vm, v, 4, kdims, kstr, kbox);
  if (err != 0) return err;
  static bool attr_set = false;  // per instantiation, once per process
  if (!attr_set) {
    const cudaError_t cerr = cudaFuncSetAttribute(
        flash_fwd_tf32x3<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (cerr != cudaSuccess) return static_cast<int>(cerr);
    attr_set = true;
  }
  // S, Skv ≤ 64 (one warpgroup's rows; one K/V tile at HD 64, two at HD
  // 128): two heads per block, one per warpgroup
  const int packed = S <= kTfPack && Skv <= kTfPack;
  const dim3 grid = packed ? dim3(1, (H + 1) / 2, B) : dim3((S + kTfBQ - 1) / kTfBQ, H, B);
  flash_fwd_tf32x3<HD><<<grid, kTfThreads, bytes, stream>>>(
      km, vm, static_cast<const float*>(q), static_cast<float*>(o), lse, S, H, Skv, KV, causal,
      window, scale, packed);
  return static_cast<int>(cudaGetLastError());
}
}  // namespace

extern "C" {

// q [B, S, H, hd], k/v [B, Skv, KV, hd], o [B, S, H, hd] (contiguous, one
// dtype: bf16 = 0 → fp32, 1 → bf16); lse [B, H, S] fp32.  window < 0 means
// no window.  hd ∈ {16, 32, 64, 128}; H % KV == 0.  variant: 0 flash_fwd,
// 1 flash_fwd_wgmma (bf16, hd 64 or 128, q/k/v 16-byte aligned), 2
// flash_fwd_tf32x3 (fp32, hd 64 or 128, q/k/v 16-byte aligned).
int flash_attention_forward(int bf16, int hd, int variant, const void* q, const void* k,
                            const void* v, void* o, float* lse, int B, int S,
                            int H, int Skv, int KV, int causal, int window,
                            float scale, void* stream) {
  if (B <= 0 || S <= 0 || Skv <= 0 || H <= 0 || KV <= 0 || H % KV != 0 ||
      B > 65535 || H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (variant == 2) {
    if (bf16) return static_cast<int>(cudaErrorInvalidValue);
    switch (hd) {
      case 64: return launch_tf32x3<64>(q, k, v, o, lse, B, S, H, Skv, KV, causal, window, scale, s);
      case 128: return launch_tf32x3<128>(q, k, v, o, lse, B, S, H, Skv, KV, causal, window, scale, s);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  if (variant == 1) {
    if (!bf16) return static_cast<int>(cudaErrorInvalidValue);
    switch (hd) {
      case 64: return launch_wgmma<64>(q, k, v, o, lse, B, S, H, Skv, KV, causal, window, scale, s);
      case 128: return launch_wgmma<128>(q, k, v, o, lse, B, S, H, Skv, KV, causal, window, scale, s);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  if (variant != 0) return static_cast<int>(cudaErrorInvalidValue);
  return bf16 ? dispatch_hd<__nv_bfloat16>(hd, q, k, v, o, lse, B, S, H, Skv, KV, causal, window, scale, s)
              : dispatch_hd<float>(hd, q, k, v, o, lse, B, S, H, Skv, KV, causal, window, scale, s);
}

int flash_attention_smem_bytes(int hd) {
  switch (hd) {
    case 16: return smem_floats<16>() * 4;
    case 32: return smem_floats<32>() * 4;
    case 64: return smem_floats<64>() * 4;
    case 128: return smem_floats<128>() * 4;
    default: return -1;
  }
}

int flash_attention_wgmma_smem_bytes(int hd) {
  switch (hd) {
    case 64: return wg_smem_bytes<64>();
    case 128: return wg_smem_bytes<128>();
    default: return -1;
  }
}

int flash_attention_tf32x3_smem_bytes(int hd) {
  switch (hd) {
    case 64: return tf_smem_bytes<64>();
    case 128: return tf_smem_bytes<128>();
    default: return -1;
  }
}

}  // extern "C"
