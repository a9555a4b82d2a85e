// K4 flash_attention for Hopper (sm_90a), with a plain C interface that
// Python loads through ctypes (see kernels/_build.py, which builds it with
// coda_kernels.cu into one library; coda_error_string names its errors).
//
//   flash_attention_forward  replaces repro/kernels/flash_attention.py::
//                            flash_attention (Pallas, pallas_call at :120);
//                            one of four variants, then, at rows with no
//                            valid key, flash_fill_no_key
//
// What it computes: GQA attention o = softmax(q·kᵀ/√hd + mask)·v per
// (batch, query head), query head h reading KV head h / G, with causal and
// static sliding-window masks (a window w keeps kv > q − w), and the per-row
// log-sum-exp of the masked scores (fp32 [B, H, S]) that the backward needs.
// The mask sentinel is -1e30, not -inf, as the Pallas kernel's: a row whose
// first visited tile holds no valid key then gets exp(0) = 1 weights there,
// which the rescale exp(-1e30 − m) = 0 wipes once a valid key arrives.
// A row with no valid key at all (a window that closes before the keys
// begin: row q ≥ Skv + window − 1, or every row of a causal mask with
// window 0) is the fill's: the reference (repro/kernels/ref.py::
// attention_full) softmaxes Skv equal sentinels, so such a row's o is the
// mean of its KV head's V over all Skv keys and its lse is −1e30 (−1e30 +
// log Skv rounds to it in fp32).  Whatever a variant writes there (flash_fwd
// the mean over the tiles it visits, flash_fwd_pingpong o = 0) is
// overwritten by flash_fill_no_key (at the end of the file), which
// flash_attention_forward launches after the variant when such rows exist.
// The Pallas kernel itself gives the mean over the blocks its early-out
// visits there, which depends on its block size; the port follows the
// reference function.
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
// flash_fwd_wgmma: the first tensor-core form for bf16 q/k/v with head_dim
// 64 or 128 (the head_dims of every full-width config); flash_fwd_pingpong
// (below) now takes those calls, and flash_fwd_wgmma stays as its yardstick,
// reached through the entry point's variant id.  bf16 at head_dim 16/32
// keeps flash_fwd, as does fp32 there (fp32 at head_dim 64 and 128 takes
// flash_fwd_tf32x3, below).  bf16 attention at the prefill
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
// flash_fwd_pingpong: the variant for bf16 q/k/v with head_dim 64 or 128
// and 16-byte-aligned bases, chosen on the host (kernels/flash_attention.py::
// launch_geometry).  flash_fwd_wgmma reaches 25-38 % of its bound: both its
// consumer warpgroups wait on the same K/V barriers, so they issue their
// products together and then run their softmaxes together, and at head_dim
// 64 one score's softmax (an exp2 at the SFU's 16 a clock an SM, plus the
// scale, max, sum and bf16 pack) costs about as much as its 256 FLOP of
// products (4,096 bf16 FLOP a clock an SM): the tensor cores idle about
// half of each tile.  The name is FA3's ping-pong schedule (Shah et al.
// 2024, §3.1), in which the consumer warpgroups take turns on the tensor
// cores at named barriers; measured against this kernel (the script's
// `turns` candidate, 10 turns a shape), the turns gain 0-1 % at head_dim 64
// and cost 1.8-3.1 % at 128, so the warpgroups share each K/V stage in
// phase as flash_fwd_wgmma's do.  Design:
//   * consumer warpgroups of 64 query rows and a producer warpgroup whose
//     one thread issues every TMA load over the same 4-D maps as
//     flash_fwd_wgmma's ([B, S|Skv, heads, HD]; GQA through the
//     coordinates): three consumers at head_dim 64 (192 rows a block,
//     setmaxnreg 24 / 160: a consumer holds 64 + 32 + 32 score, output and
//     P registers), two at head_dim 128 (128 rows, 40 / 232; three would
//     spill and pass the shared memory a block may use); in each warpgroup
//     the pipeline of flash_fwd_wgmma (next tile's q·kᵀ before this tile's
//     P·V, last tile peeled, no branch around the products);
//   * one ex2 a score: the scores stay raw, the max is taken on them, and
//     p = ex2.approx(s·c − m·c) with c = log2(e)·hd^-½ is one FFMA and one
//     MUFU.EX2 (about 2 ulp, far below P's 2^-9 rounding); a row whose keys
//     are all masked so far takes 0 as its base, so its sentinel scores give
//     0 and l stays 0;
//   * K and V stages released separately (K once q·kᵀ is done, V once P·V
//     is), K loaded one tile ahead of V as the consumers read them; 4 stages
//     at HD 64 (6 measured 1.5-2 % slower), 2 at HD 128 (3 measured 2-2.5 %
//     slower, in 9-10 of 10 turns at each head_dim-128 prefill shape; why is
//     not read);
//   * S, Skv ≤ 64 (the training shapes): two heads an item, one per
//     consumer warpgroup, with 64-key tiles (a 128-key tile would be half
//     padding); the producer interleaves the two heads' tiles (each may read
//     another KV head), and an odd H leaves the last item one head;
//   * persistent blocks at head_dim 128 and when packed: one block an SM
//     walks the items longest causal rows first, and the producer loads the
//     next item's q and first K/V tiles while the consumers finish the last
//     P·V and store the item (each item's own prologue and epilogue were
//     exposed otherwise: 2,048 blocks of ~8.5 tiles at stablelm's prefill,
//     4,096 one-tile blocks at its training shape).  At head_dim 64
//     unpacked the three-warpgroup block runs one item a block: at 160
//     registers the persistent walk spills and serializes the wgmma chain;
//   * o = O / max(l, 1e-30) in bf16 stored from registers; lse = m·hd^-½ +
//     log l in fp32.  A row with no valid key at all (a window that closes
//     before the keys begin, S ≥ Skv + window) keeps l = 0 and the kernel
//     writes o = 0 there, as the Pallas kernel's rows whose every KV block
//     it skips get; flash_fill_no_key then overwrites those rows with the
//     reference's mean of V and lse = −1e30 (see the header).
// The candidates and diagnostics behind these choices (turns or none,
// ex2 on or off, V's loads on or off, persistent or not, two or three
// consumer warpgroups) are scripts/k4_bf16_variants.py's.
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

// one query tile a block row, a block for each (tile, head, batch row)
inline dim3 fwd_grid(int S, int H, int B) { return dim3((S + kBQ - 1) / kBQ, H, B); }

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
  const dim3 grid = fwd_grid(S, H, B);
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
// the K and V tensor maps' box: 64 dims (one 128-byte row) × kWgBK keys
constexpr uint32_t kWgKBox[4] = {64, 1, kWgBK, 1};
inline dim3 wg_grid(int S, int H, int B) { return dim3((S + kWgBQ - 1) / kWgBQ, H, B); }
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
  int err = hopper::encode_bf16_map(&qm, q, 4, qdims, qstr, qbox);
  if (err == 0) err = hopper::encode_bf16_map(&km, k, 4, kdims, kstr, kWgKBox);
  if (err == 0) err = hopper::encode_bf16_map(&vm, v, 4, kdims, kstr, kWgKBox);
  if (err != 0) return err;
  static bool attr_set = false;  // per instantiation, once per process
  if (!attr_set) {
    const cudaError_t cerr = cudaFuncSetAttribute(
        flash_fwd_wgmma<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (cerr != cudaSuccess) return static_cast<int>(cerr);
    attr_set = true;
  }
  const dim3 grid = wg_grid(S, H, B);
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
  // the K and V tensor maps' box: 32 dims (one 128-byte row) × BK keys
  static constexpr uint32_t kKBox[4] = {32, 1, BK, 1};
};

// S, Skv ≤ kTfPack (one warpgroup's rows; one K/V tile at HD 64, two at HD
// 128): two heads a block, one per consumer warpgroup
inline bool tf_packed(int S, int Skv) { return S <= kTfPack && Skv <= kTfPack; }
inline dim3 tf_grid(int S, int Skv, int H, int B) {
  return tf_packed(S, Skv) ? dim3(1, (H + 1) / 2, B) : dim3((S + kTfBQ - 1) / kTfBQ, H, B);
}

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
  int err = hopper::encode_f32_map(&km, k, 4, kdims, kstr, TfTile<HD>::kKBox);
  if (err == 0) err = hopper::encode_f32_map(&vm, v, 4, kdims, kstr, TfTile<HD>::kKBox);
  if (err != 0) return err;
  static bool attr_set = false;  // per instantiation, once per process
  if (!attr_set) {
    const cudaError_t cerr = cudaFuncSetAttribute(
        flash_fwd_tf32x3<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (cerr != cudaSuccess) return static_cast<int>(cerr);
    attr_set = true;
  }
  const int packed = tf_packed(S, Skv);
  const dim3 grid = tf_grid(S, Skv, H, B);
  flash_fwd_tf32x3<HD><<<grid, kTfThreads, bytes, stream>>>(
      km, vm, static_cast<const float*>(q), static_cast<float*>(o), lse, S, H, Skv, KV, causal,
      window, scale, packed);
  return static_cast<int>(cudaGetLastError());
}

// --------------------------------------------------------- flash_fwd_pingpong
constexpr int kPpBK = 128;         // keys a K/V tile
constexpr int kPpPackBK = 64;      // keys a K/V tile when a block packs two heads
constexpr int kPpPack = 64;        // two heads a block when S, Skv ≤ this
constexpr int kPpConsumers64 = 3;  // consumer warpgroups of 64 query rows at head_dim 64
constexpr int kPpConsumers128 = 2; // the same at head_dim 128, and in a packed block
// the K and V tensor maps' box: 64 dims (one 128-byte row) × the tile's keys
constexpr uint32_t kPpKBox[4] = {64, 1, kPpBK, 1};
constexpr uint32_t kPpPackKBox[4] = {64, 1, kPpPackBK, 1};

__host__ __device__ inline bool pp_packed(int S, int Skv) { return S <= kPpPack && Skv <= kPpPack; }
// the consumer warpgroups of a block (64 query rows each, or one head each
// when packed), and whether its blocks are persistent: head_dim 64 unpacked
// runs three warpgroups, a block an item; head_dim 128, and every packed
// call, two, with a persistent block an SM walking the items
__host__ __device__ constexpr int pp_consumers(int hd, bool packed) {
  return hd == 64 && !packed ? kPpConsumers64 : kPpConsumers128;
}
__host__ __device__ constexpr bool pp_persistent(int hd, bool packed) {
  return !(hd == 64 && !packed);
}
template <int HD>
__host__ __device__ constexpr int pp_stages() { return HD == 64 ? 4 : 2; }
template <int HD>
__host__ __device__ constexpr int pp_smem_bytes() {
  // q [64 rows a consumer warpgroup × HD], K and V [kPpBK keys × HD] per
  // stage (bf16; a packed call's 64-key tiles and two warpgroups use less
  // of it), 4 barriers a stage, a q-full and a q-empty barrier a consumer
  // warpgroup, 1024 bytes of alignment slack.  HD 64: 156,848 B; HD 128:
  // 164,960 B
  return 64 * pp_consumers(HD, false) * HD * 2 + pp_stages<HD>() * 2 * kPpBK * HD * 2 +
         (4 * pp_stages<HD>() + 2 * pp_consumers(HD, false)) * 8 + 1024;
}
// a call's items: (query tile, head, batch row), or (head pair, batch row)
// when packed; and its blocks: one an item, or one an SM (at most) when
// persistent
__host__ __device__ inline int pp_items(int hd, int S, int Skv, int H, int B) {
  const bool packed = pp_packed(S, Skv);
  const int bq = 64 * pp_consumers(hd, packed);
  return packed ? (H + 1) / 2 * B : (S + bq - 1) / bq * H * B;
}
inline int pp_blocks(int hd, int S, int Skv, int H, int B) {
  const int items = pp_items(hd, S, Skv, H, B);
  if (!pp_persistent(hd, pp_packed(S, Skv))) return items;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return items < sms ? items : sms;
}

// issue S = q·kᵀ for a BK-key tile over HD / 16 slices of 16 (committed, not
// waited); both operands K-major, 128-byte swizzle
template <int HD, int BK>
__device__ __forceinline__ void pp_issue_scores(float (&sacc)[BK / 2], const uint8_t* qw_s,
                                                const uint8_t* k_stage) {
  constexpr int kQRegion = 64 * 128, kKVRegion = BK * 128;
  hopper::fence_regs(sacc);
  hopper::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const uint64_t da = hopper::desc_sw128(qw_s + (kk / 4) * kQRegion + 32 * (kk % 4), 0, 1024);
    const uint64_t db = hopper::desc_sw128(k_stage + (kk / 4) * kKVRegion + 32 * (kk % 4), 0, 1024);
    if constexpr (BK == 128)
      hopper::wgmma_ss_n128<0>(sacc, da, db, kk > 0);
    else
      hopper::wgmma_ss_n64<0>(sacc, da, db, kk > 0);
  }
  hopper::wgmma_commit();
}

// issue O += P·V for a BK-key V tile (committed, not waited; the caller has
// fenced O and P): P from registers, V MN-major (hd contiguous)
template <int HD, int BK>
__device__ __forceinline__ void pp_issue_pv(float (&oacc)[HD / 2], const uint32_t (&pa)[BK / 16][4],
                                            const uint8_t* v_stage) {
  const uint64_t dv = hopper::desc_sw128(v_stage, BK * 128, 1024);
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    if constexpr (HD == 128)
      hopper::wgmma_rs_n128<1>(oacc, pa[kk], hopper::desc_add(dv, 2048 * kk), 1);
    else
      hopper::wgmma_rs_n64<1>(oacc, pa[kk], hopper::desc_add(dv, 2048 * kk), 1);
  }
  hopper::wgmma_commit();
}

// the online softmax of a BK-key tile of raw scores at k0: masked with the
// −1e30 sentinel where the mask reaches the tile, m (raw units) and l
// updated, O's rescale in corr and the probabilities in sacc, each one
// ex2(s·c − m·c) with c = log2(e)·hd^-½: one FFMA and one MUFU.EX2 a score.
// A row with no valid key yet (m = −1e30) takes 0 as its base, so its masked
// scores give ex2(−1e30·c) = 0 and l stays 0 until a valid key arrives.
template <int BK>
__device__ __forceinline__ void pp_softmax(float (&sacc)[BK / 2], float (&m)[2], float (&l)[2],
                                           float (&corr)[2], int k0, const WgRows& w) {
  const bool edge = k0 + BK > w.Skv || (w.causal && k0 + BK - 1 > w.qw) ||
                    (w.window >= 0 && k0 <= w.qw + 63 - w.window);
  if (edge) {
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kp = k0 + 8 * j + w.cc + (e & 1), qp = w.row0 + 8 * (e >> 1);
        bool ok = kp < w.Skv;
        if (w.causal) ok = ok && kp <= qp;
        if (w.window >= 0) ok = ok && kp > qp - w.window;
        if (!ok) sacc[4 * j + e] = kNegInf;
      }
  }
  const float c = w.scale_log2;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mx = kNegInf;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
      mx = fmaxf(mx, fmaxf(sacc[4 * j + 2 * r], sacc[4 * j + 2 * r + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m[r], mx);
    const float mc = m_new == kNegInf ? 0.f : m_new * c;
    corr[r] = hopper::ex2((m[r] - m_new) * c);
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      const float p0 = hopper::ex2(fmaf(sacc[4 * j + 2 * r], c, -mc));
      const float p1 = hopper::ex2(fmaf(sacc[4 * j + 2 * r + 1], c, -mc));
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

// P rounded to bf16 as wgmma's A fragments: slice kk holds keys 16kk .. +15
template <int BK>
__device__ __forceinline__ void pp_pack(const float (&sacc)[BK / 2], uint32_t (&pa)[BK / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    pa[kk][0] = hopper::pack_bf16(sacc[8 * kk], sacc[8 * kk + 1]);
    pa[kk][1] = hopper::pack_bf16(sacc[8 * kk + 2], sacc[8 * kk + 3]);
    pa[kk][2] = hopper::pack_bf16(sacc[8 * kk + 4], sacc[8 * kk + 5]);
    pa[kk][3] = hopper::pack_bf16(sacc[8 * kk + 6], sacc[8 * kk + 7]);
  }
}

// one item of a call: its first query row and head, batch row, band of KV
// tiles, consumer warpgroups with rows (or heads), and heads whose tiles the
// producer loads
struct PpItem {
  int q0, h0, b, kv_lo, ntiles, n_wg, heads;
};
// item t, longest causal rows first: unpacked, t → query tile n_qt − 1 −
// t / (H·B) of head t % H, batch row t % (H·B) / H; packed, t → heads 2p,
// 2p + 1 (p = t % ⌈H/2⌉) of batch row t / ⌈H/2⌉
template <int BK, int NC, bool Packed>
__device__ __forceinline__ PpItem pp_item(int t, int S, int H, int B, int Skv, int causal,
                                          int window) {
  PpItem it;
  if constexpr (Packed) {
    const int pairs = (H + 1) / 2;
    it.q0 = 0;
    it.h0 = 2 * (t % pairs);
    it.b = t / pairs;
  } else {
    const int n_qt = (S + 64 * NC - 1) / (64 * NC), hb = t % (H * B);
    it.q0 = (n_qt - 1 - t / (H * B)) * 64 * NC;
    it.h0 = hb % H;
    it.b = hb / H;
  }
  // KV tiles inside the band of the item's rows (pl.when(needed) in Pallas)
  const int kv_hi = causal ? min(Skv, it.q0 + 64 * NC) : Skv;
  const int kv_lo = window >= 0 ? max(0, it.q0 - window + 1) : 0;
  it.kv_lo = (kv_lo / BK) * BK;
  it.ntiles = kv_hi > it.kv_lo ? (kv_hi - it.kv_lo + BK - 1) / BK : 0;
  it.n_wg = Packed ? min(NC, H - it.h0) : min(NC, (S - it.q0 + 63) / 64);
  it.heads = Packed ? it.n_wg : 1;
  return it;
}

// Unpacked: an item is 64·NC query rows of one (head, batch row), its
// consumer warpgroups sharing each K/V tile.  Packed (S, Skv ≤ 64): an item
// is heads h0 and h0 + 1 of a batch row, one per consumer warpgroup, and
// the producer interleaves their tiles (load i of an item is tile i / heads
// of head h0 + i % heads).  Persistent: each block walks items blockIdx.x +
// k·gridDim.x; the K/V ring and its barriers' phases run on across items,
// and the producer loads an item's q (once the consumer warpgroup's last
// q·kᵀ of the previous item is done: qempty) and first K/V tiles while the
// consumers finish the previous item's last P·V and store it.  An item with
// no K/V tile (its rows have no valid key) issues no product.
template <int HD, bool Packed>
__global__ void __launch_bounds__(128 * (pp_consumers(HD, Packed) + 1), 1)
flash_fwd_pingpong(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
                   const __grid_constant__ CUtensorMap vmap, __nv_bfloat16* __restrict__ o,
                   float* __restrict__ lse, int B, int S, int H, int Skv, int KV, int causal,
                   int window, float scale_log2) {
  constexpr int NC = pp_consumers(HD, Packed);
  constexpr bool kPersistent = pp_persistent(HD, Packed);
  constexpr int BK = Packed ? kPpPackBK : kPpBK;
  constexpr int NST = pp_stages<HD>();
  constexpr int NHB = HD / 64;                   // 64-wide column regions of a row
  constexpr int kQRegion = 64 * 128;             // 64 rows × 128 bytes
  constexpr int kKVRegion = BK * 128;            // BK keys × 128 bytes
  constexpr int kTileBytes = BK * HD * 2;        // one K (or V) tile
  constexpr int kStageBytes = kPpBK * HD * 2;    // a stage's room (packed tiles use half)
  // registers: NC = 3, 24 / 160 a thread; NC = 2, 40 / 232 (65,536 at most)
  constexpr int kProducerRegs = NC == 3 ? 24 : 40;
  constexpr int kConsumerRegs = NC == 3 ? 160 : 232;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = hopper::align_smem_1024(smem_raw);
  uint8_t* qs = smem;                                  // [consumer wg][NHB][64 × 128 B]
  uint8_t* ks = qs + 64 * NC * HD * 2;                 // [NST][NHB][BK × 128 B]
  uint8_t* vs = ks + NST * kStageBytes;
  uint64_t* kfull = reinterpret_cast<uint64_t*>(vs + NST * kStageBytes);
  uint64_t* vfull = kfull + NST;
  uint64_t* kempty = vfull + NST;  // the consumers' q·kᵀ has read the K stage
  uint64_t* vempty = kempty + NST; // the consumers' P·V has read the V stage
  uint64_t* qfull = vempty + NST;  // [consumer wg]
  uint64_t* qempty = qfull + NC;   // [consumer wg]: its last q·kᵀ of an item is done

  const int G = H / KV;
  const int items = pp_items(HD, S, Skv, H, B);
  // unpacked, every consumer warpgroup releases every stage (one with no
  // rows in an item waits for the item's stages and releases them too, so
  // the count holds across items); packed, a stage is read by its head's
  const int readers = Packed ? 128 : 128 * NC;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < NST; ++s) {
      hopper::mbar_init(&kfull[s], 1);
      hopper::mbar_init(&vfull[s], 1);
      hopper::mbar_init(&kempty[s], readers);
      hopper::mbar_init(&vempty[s], readers);
    }
    for (int w = 0; w < NC; ++w) {
      hopper::mbar_init(&qfull[w], 1);
      hopper::mbar_init(&qempty[w], 128);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (warp >= 4 * NC) {  // producer warpgroup: one thread issues every TMA load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs) : "memory");
    if (warp == 4 * NC && lane == 0) {
      hopper::prefetch_tensormap(&qmap);
      hopper::prefetch_tensormap(&kmap);
      hopper::prefetch_tensormap(&vmap);
      int base = 0;            // the block's loads before this item's
      int qloads[NC] = {};     // q loads of each consumer warpgroup so far
      auto produce = [&](int t) {
        const PpItem it = pp_item<BK, NC, Packed>(t, S, H, B, Skv, causal, window);
        for (int w = 0; w < it.n_wg; ++w) {
          if (qloads[w] > 0) hopper::mbar_wait(&qempty[w], (qloads[w] - 1) & 1);
          ++qloads[w];
          hopper::mbar_expect_tx(&qfull[w], 64 * HD * 2);
#pragma unroll
          for (int j = 0; j < NHB; ++j)
            hopper::tma_load_4d(qs + (w * NHB + j) * kQRegion, &qmap, &qfull[w], 64 * j,
                                Packed ? it.h0 + w : it.h0, Packed ? 0 : it.q0 + 64 * w, it.b);
        }
        // K runs one load ahead of V, as the consumers read them: K_{i+1}
        // (for q·kᵀ of the next tile) before V_i (for P·V of this one)
        const int nloads = it.ntiles * it.heads;
        for (int i = 0; i <= nloads; ++i) {
          if (i < nloads) {
            const int g = base + i, s = g % NST;
            const int k0 = it.kv_lo + (i / it.heads) * BK, kvh = (it.h0 + i % it.heads) / G;
            if (g >= NST) hopper::mbar_wait(&kempty[s], ((g / NST) - 1) & 1);
            hopper::mbar_expect_tx(&kfull[s], kTileBytes);
#pragma unroll
            for (int j = 0; j < NHB; ++j)
              hopper::tma_load_4d(ks + s * kStageBytes + j * kKVRegion, &kmap, &kfull[s], 64 * j,
                                  kvh, k0, it.b);
          }
          if (i > 0) {
            const int l = i - 1, g = base + l, s = g % NST;
            const int k0 = it.kv_lo + (l / it.heads) * BK, kvh = (it.h0 + l % it.heads) / G;
            if (g >= NST) hopper::mbar_wait(&vempty[s], ((g / NST) - 1) & 1);
            hopper::mbar_expect_tx(&vfull[s], kTileBytes);
#pragma unroll
            for (int j = 0; j < NHB; ++j)
              hopper::tma_load_4d(vs + s * kStageBytes + j * kKVRegion, &vmap, &vfull[s], 64 * j,
                                  kvh, k0, it.b);
          }
        }
        base += nloads;
      };
      if constexpr (kPersistent) {
        for (int t = blockIdx.x; t < items; t += gridDim.x) produce(t);
      } else {
        produce(blockIdx.x);
      }
    }
    return;
  }
  // consumers take the registers the producer gave back
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs) : "memory");
  const int wg = warp / 4;
  const bool last_wg = wg == NC - 1;
  const int cc = 2 * (lane % 4);
  const long long q_row = static_cast<long long>(H) * HD;
  const float lse_scale = scale_log2 * kLn2;
  const uint8_t* qw_s = qs + wg * NHB * kQRegion;
  int base = 0;   // the block's loads before this item's
  int qwaits = 0; // this warpgroup's q loads so far

  auto consume = [&](int t) {
    const PpItem it = pp_item<BK, NC, Packed>(t, S, H, B, Skv, causal, window);
    const int ntiles = it.ntiles, heads = it.heads, kv_lo = it.kv_lo;
    if (wg >= it.n_wg) {  // no rows (or no head) in this item
      if (!Packed)          // unpacked, release the item's stages all the same
        for (int i = 0; i < ntiles; ++i) {
          const int g = base + i, s = g % NST;
          hopper::mbar_wait(&kfull[s], (g / NST) & 1);
          hopper::mbar_arrive(&kempty[s]);
          hopper::mbar_wait(&vfull[s], (g / NST) & 1);
          hopper::mbar_arrive(&vempty[s]);
        }
      base += ntiles * heads;
      return;
    }

    // this thread's head and two rows (accumulator layout): 16·(warp % 4) +
    // lane / 4 (+8); its tile i is the block's load base + i·heads + sb
    const int h = Packed ? it.h0 + wg : it.h0;
    const int sb = base + (Packed ? wg : 0);
    const int qw = Packed ? 0 : it.q0 + 64 * wg;
    const int row0 = qw + 16 * (warp % 4) + lane / 4;
    // causal, unpacked: a warpgroup other than the last stops its products at
    // the last K/V tile its rows reach (with 192-row items and 128-key tiles,
    // up to one tile and a half fewer a warpgroup)
    int ntw = ntiles;
    if (!Packed && causal && !last_wg)
      ntw = min(ntiles, (min(min(S, qw + 64), Skv) - kv_lo + BK - 1) / BK);
    float sacc[BK / 2], oacc[HD / 2];
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) sacc[i] = 0.f;
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) oacc[i] = 0.f;
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f}, corr[2];
    uint32_t pa[BK / 16][4];
    const WgRows rows{row0, qw, cc, Skv, causal, window, scale_log2};
    hopper::mbar_wait(&qfull[wg], qwaits & 1);
    ++qwaits;

    // The pipeline of flash_fwd_wgmma: q·kᵀ of tile i + 1 issued before P·V
    // of tile i, the last tile peeled, no branch around the products.
    if (ntiles > 0) {
      const int s = sb % NST;
      hopper::mbar_wait(&kfull[s], (sb / NST) & 1);
      pp_issue_scores<HD, BK>(sacc, qw_s, ks + s * kStageBytes);
      hopper::wgmma_wait<0>();
      hopper::fence_regs(sacc);
      hopper::mbar_arrive(&kempty[s]);
      pp_softmax<BK>(sacc, m, l, corr, kv_lo, rows);  // O is 0: corr unused
      pp_pack<BK>(sacc, pa);
    }
    for (int i = 0; i + 1 < ntw; ++i) {
      const int j = sb + i * heads, j1 = j + heads, s = j % NST, s1 = j1 % NST;
      hopper::mbar_wait(&kfull[s1], (j1 / NST) & 1);
      hopper::mbar_wait(&vfull[s], (j / NST) & 1);
      pp_issue_scores<HD, BK>(sacc, qw_s, ks + s1 * kStageBytes);
      hopper::fence_regs(oacc);
      hopper::wgmma_fence();
      pp_issue_pv<HD, BK>(oacc, pa, vs + s * kStageBytes);
      hopper::wgmma_wait<1>();  // q·kᵀ of tile i + 1 is done; P·V of tile i may run on
      hopper::fence_regs(sacc);
      hopper::mbar_arrive(&kempty[s1]);
      pp_softmax<BK>(sacc, m, l, corr, kv_lo + (i + 1) * BK, rows);
      hopper::wgmma_wait<0>();
      hopper::fence_regs(oacc);
      hopper::fence_regs(pa);
      hopper::mbar_arrive(&vempty[s]);
#pragma unroll
      for (int c = 0; c < HD / 8; ++c) {
        oacc[4 * c] *= corr[0];
        oacc[4 * c + 1] *= corr[0];
        oacc[4 * c + 2] *= corr[1];
        oacc[4 * c + 3] *= corr[1];
      }
      pp_pack<BK>(sacc, pa);
    }
    // every q·kᵀ of the item is done: the producer may load the next q
    if constexpr (kPersistent) hopper::mbar_arrive(&qempty[wg]);
    if (ntw > 0) {  // the last tile's P·V
      const int j = sb + (ntw - 1) * heads, s = j % NST;
      hopper::mbar_wait(&vfull[s], (j / NST) & 1);
      hopper::fence_regs(oacc);
      hopper::wgmma_fence();
      pp_issue_pv<HD, BK>(oacc, pa, vs + s * kStageBytes);
      hopper::wgmma_wait<0>();
      hopper::fence_regs(oacc);
      hopper::fence_regs(pa);
      hopper::mbar_arrive(&vempty[s]);
    }
    // the item's tiles past this warpgroup's rows: wait for them and release
    // them (every consumer warpgroup releases every stage)
    for (int i = ntw; i < ntiles; ++i) {
      const int g = sb + i, s = g % NST;
      hopper::mbar_wait(&kfull[s], (g / NST) & 1);
      hopper::mbar_arrive(&kempty[s]);
      hopper::mbar_wait(&vfull[s], (g / NST) & 1);
      hopper::mbar_arrive(&vempty[s]);
    }
    base += ntiles * heads;

    // o = O / max(l, 1e-30) in bf16; lse = m·hd^-½ + log l
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qp = row0 + 8 * r;
      if (qp >= S) continue;
      const float li = fmaxf(l[r], 1e-30f);
      const float inv = 1.f / li;
      __nv_bfloat16* orow = o + (static_cast<long long>(it.b) * S + qp) * q_row +
                            static_cast<long long>(h) * HD + cc;
#pragma unroll
      for (int c = 0; c < HD / 8; ++c)
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * c) =
            __floats2bfloat162_rn(oacc[4 * c + 2 * r] * inv, oacc[4 * c + 2 * r + 1] * inv);
      if (lane % 4 == 0)
        lse[(static_cast<long long>(it.b) * H + h) * S + qp] = m[r] * lse_scale + logf(li);
    }
  };
  if constexpr (kPersistent) {
    for (int t = blockIdx.x; t < items; t += gridDim.x) consume(t);
  } else {
    consume(blockIdx.x);
  }
}

template <int HD, bool Packed>
int launch_pp(const CUtensorMap& qm, const CUtensorMap& km, const CUtensorMap& vm, void* o,
              float* lse, int B, int S, int H, int Skv, int KV, int causal, int window,
              float scale_log2, cudaStream_t stream) {
  constexpr int bytes = pp_smem_bytes<HD>();
  static bool attr_set = false;  // per instantiation, once per process
  if (!attr_set) {
    const cudaError_t cerr = cudaFuncSetAttribute(
        flash_fwd_pingpong<HD, Packed>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (cerr != cudaSuccess) return static_cast<int>(cerr);
    attr_set = true;
  }
  flash_fwd_pingpong<HD, Packed>
      <<<pp_blocks(HD, S, Skv, H, B), 128 * (pp_consumers(HD, Packed) + 1), bytes, stream>>>(
          qm, km, vm, static_cast<__nv_bfloat16*>(o), lse, B, S, H, Skv, KV, causal, window,
          scale_log2);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int launch_pingpong(const void* q, const void* k, const void* v, void* o, float* lse, int B,
                    int S, int H, int Skv, int KV, int causal, int window, float scale,
                    cudaStream_t stream) {
  const bool packed = pp_packed(S, Skv);
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
  const uint32_t* kbox = packed ? kPpPackKBox : kPpKBox;
  int err = hopper::encode_bf16_map(&qm, q, 4, qdims, qstr, qbox);
  if (err == 0) err = hopper::encode_bf16_map(&km, k, 4, kdims, kstr, kbox);
  if (err == 0) err = hopper::encode_bf16_map(&vm, v, 4, kdims, kstr, kbox);
  if (err != 0) return err;
  return packed ? launch_pp<HD, true>(qm, km, vm, o, lse, B, S, H, Skv, KV, causal, window,
                                      scale * kLog2e, stream)
                : launch_pp<HD, false>(qm, km, vm, o, lse, B, S, H, Skv, KV, causal, window,
                                       scale * kLog2e, stream);
}

// One launch of the variant the caller names (the wrapper's pick, or a
// check's yardstick); see flash_attention_forward.
int launch_variant(int bf16, int hd, int variant, const void* q, const void* k, const void* v,
                   void* o, float* lse, int B, int S, int H, int Skv, int KV, int causal,
                   int window, float scale, cudaStream_t s) {
  if (variant == 3) {
    if (!bf16) return static_cast<int>(cudaErrorInvalidValue);
    switch (hd) {
      case 64: return launch_pingpong<64>(q, k, v, o, lse, B, S, H, Skv, KV, causal, window, scale, s);
      case 128: return launch_pingpong<128>(q, k, v, o, lse, B, S, H, Skv, KV, causal, window, scale, s);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
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

// The first query row with no valid key, or S if every row has one
// (kernels/flash_attention.py::no_key_rows is the same arithmetic).  Row q
// keeps the keys kv > q − window (and kv ≤ q when causal); the last key is
// Skv − 1, so with a window every row q ≥ Skv + window − 1 has none, and a
// causal mask with window 0 (kv ≤ q and kv > q) leaves no row a key.
// Without a window key 0 is valid for every row.
int no_key_first(int S, int Skv, int causal, int window) {
  if (window < 0) return S;
  if (causal && window == 0) return 0;
  const long long first = static_cast<long long>(Skv) + window - 1;
  return first < S ? static_cast<int>(first) : S;
}

// flash_fill_no_key: the reference's value at rows with no valid key (see
// the header).  It replaces no Pallas kernel of its own: it completes K4's
// contract after whichever variant ran.  A block per (KV head, batch row).
// Sum: a key's row of the head is kChunks 16-byte pieces of kVec values;
// thread (p, j) adds piece j of the keys p, p + kStripes, … in order, in
// fp32 (16-byte loads where v is 16-byte aligned, else the same values one
// by one: the same sums either way); the kStripes partial sums of a column
// are then added in order p = 0, 1, …, scaled by 1/Skv and rounded once to
// o's dtype.  Write: that row goes into rows first … S − 1 of the G query
// heads that read this KV head (G·HD contiguous elements a row, 16-byte
// stores), and lse = −1e30f there.  Bytes bind it: V read once, those rows
// of o and lse written once.
constexpr int kFillThreads = 512;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T, int HD, bool Vec>
__global__ void __launch_bounds__(kFillThreads)
flash_fill_no_key(const T* __restrict__ v, T* __restrict__ o, float* __restrict__ lse, int S,
                  int H, int Skv, int KV, int first) {
  constexpr int kVec = 16 / static_cast<int>(sizeof(T));  // values a 16-byte piece
  constexpr int kChunks = HD / kVec;                      // pieces a head's row
  constexpr int kStripes = kFillThreads / kChunks;        // keys summed side by side
  __shared__ float part[kStripes][HD];
  __shared__ uint4 mean[kChunks];                         // the mean in o's dtype
  const int kvh = blockIdx.x, b = blockIdx.y, G = H / KV;
  const int j = threadIdx.x % kChunks, p = threadIdx.x / kChunks;
  const long long kv_row = static_cast<long long>(KV) * HD;  // stride of a key
  const T* vb = v + static_cast<long long>(b) * Skv * kv_row + static_cast<long long>(kvh) * HD +
                j * kVec;
  float acc[kVec];
#pragma unroll
  for (int e = 0; e < kVec; ++e) acc[e] = 0.f;
#pragma unroll 4
  for (int c = p; c < Skv; c += kStripes) {
    const T* src = vb + c * kv_row;
    uint4 raw;
    T* x = reinterpret_cast<T*>(&raw);
    if constexpr (Vec) {
      raw = __ldg(reinterpret_cast<const uint4*>(src));
    } else {
#pragma unroll
      for (int e = 0; e < kVec; ++e) x[e] = src[e];
    }
#pragma unroll
    for (int e = 0; e < kVec; ++e) acc[e] += to_f32(x[e]);
  }
#pragma unroll
  for (int e = 0; e < kVec; ++e) part[p][j * kVec + e] = acc[e];
  __syncthreads();
  if (threadIdx.x < HD) {
    float sum = 0.f;
#pragma unroll 8
    for (int i = 0; i < kStripes; ++i) sum += part[i][threadIdx.x];
    store1(reinterpret_cast<T*>(mean) + threadIdx.x, sum * (1.f / static_cast<float>(Skv)));
  }
  __syncthreads();

  // o: a row of this KV head's query heads is per_row 16-byte stores;
  // rstep rows a pass of the block (one row, looped, when per_row passes
  // the block's threads)
  const int per_row = G * kChunks;
  const int rstep = max(1, kFillThreads / per_row);
  const int r0 = threadIdx.x / per_row;
  const long long row = static_cast<long long>(H) * kChunks;  // stride of a query row
  uint4* ob = reinterpret_cast<uint4*>(o) + static_cast<long long>(b) * S * row +
              static_cast<long long>(kvh) * per_row;
  if (r0 < rstep)
    for (int r = first + r0; r < S; r += rstep)
      for (int i = threadIdx.x % per_row; i < per_row; i += kFillThreads)
        ob[r * row + i] = mean[i % kChunks];
  // lse [B, H, S]: rows first … S − 1 of the G heads
  float* lb = lse + (static_cast<long long>(b) * H + static_cast<long long>(kvh) * G) * S;
  for (int g = 0; g < G; ++g)
    for (int r = first + threadIdx.x; r < S; r += kFillThreads)
      lb[static_cast<long long>(g) * S + r] = kNegInf;
}

template <typename T, int HD>
int launch_fill(const void* v, void* o, float* lse, int B, int S, int H, int Skv, int KV,
                int first, cudaStream_t stream) {
  const dim3 grid(KV, B);
  if (reinterpret_cast<uintptr_t>(v) % 16 == 0)
    flash_fill_no_key<T, HD, true><<<grid, kFillThreads, 0, stream>>>(
        static_cast<const T*>(v), static_cast<T*>(o), lse, S, H, Skv, KV, first);
  else
    flash_fill_no_key<T, HD, false><<<grid, kFillThreads, 0, stream>>>(
        static_cast<const T*>(v), static_cast<T*>(o), lse, S, H, Skv, KV, first);
  return static_cast<int>(cudaGetLastError());
}

// rows first … S − 1 of o [B, S, H, hd] (16-byte aligned) and lse [B, H, S]
int fill_no_key(int bf16, int hd, const void* v, void* o, float* lse, int B, int S, int H,
                int Skv, int KV, int first, cudaStream_t s) {
  if (reinterpret_cast<uintptr_t>(o) % 16 != 0)
    return static_cast<int>(cudaErrorMisalignedAddress);
  switch (hd) {
    case 16: return bf16 ? launch_fill<__nv_bfloat16, 16>(v, o, lse, B, S, H, Skv, KV, first, s)
                         : launch_fill<float, 16>(v, o, lse, B, S, H, Skv, KV, first, s);
    case 32: return bf16 ? launch_fill<__nv_bfloat16, 32>(v, o, lse, B, S, H, Skv, KV, first, s)
                         : launch_fill<float, 32>(v, o, lse, B, S, H, Skv, KV, first, s);
    case 64: return bf16 ? launch_fill<__nv_bfloat16, 64>(v, o, lse, B, S, H, Skv, KV, first, s)
                         : launch_fill<float, 64>(v, o, lse, B, S, H, Skv, KV, first, s);
    case 128: return bf16 ? launch_fill<__nv_bfloat16, 128>(v, o, lse, B, S, H, Skv, KV, first, s)
                          : launch_fill<float, 128>(v, o, lse, B, S, H, Skv, KV, first, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
}  // namespace

extern "C" {

// q [B, S, H, hd], k/v [B, Skv, KV, hd], o [B, S, H, hd] (contiguous, one
// dtype: bf16 = 0 → fp32, 1 → bf16); lse [B, H, S] fp32.  window < 0 means
// no window.  hd ∈ {16, 32, 64, 128}; H % KV == 0.  variant: 0 flash_fwd,
// 1 flash_fwd_wgmma (bf16, hd 64 or 128, q/k/v 16-byte aligned), 2
// flash_fwd_tf32x3 (fp32, hd 64 or 128, q/k/v 16-byte aligned), 3
// flash_fwd_pingpong (bf16, hd 64 or 128, q/k/v 16-byte aligned).  When
// some rows have no valid key (no_key_first < S), flash_fill_no_key then
// writes the reference's o and lse there, on the same stream, whichever
// variant ran.
int flash_attention_forward(int bf16, int hd, int variant, const void* q, const void* k,
                            const void* v, void* o, float* lse, int B, int S,
                            int H, int Skv, int KV, int causal, int window,
                            float scale, void* stream) {
  if (B <= 0 || S <= 0 || Skv <= 0 || H <= 0 || KV <= 0 || H % KV != 0 ||
      B > 65535 || H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int err = launch_variant(bf16, hd, variant, q, k, v, o, lse, B, S, H, Skv, KV, causal,
                                 window, scale, s);
  if (err != 0) return err;
  const int first = no_key_first(S, Skv, causal, window);
  return first < S ? fill_no_key(bf16, hd, v, o, lse, B, S, H, Skv, KV, first, s) : 0;
}

// flash_fill_no_key alone on rows first … S − 1 (0 ≤ first < S), as
// flash_attention_forward launches it: for a check to time it and hold it
// against its plain version.  o must be 16-byte aligned.
int flash_attention_fill_no_key(int bf16, int hd, const void* v, void* o, float* lse, int B,
                                int S, int H, int Skv, int KV, int first, void* stream) {
  if (B <= 0 || S <= 0 || Skv <= 0 || H <= 0 || KV <= 0 || H % KV != 0 || B > 65535 ||
      first < 0 || first >= S)
    return static_cast<int>(cudaErrorInvalidValue);
  return fill_no_key(bf16, hd, v, o, lse, B, S, H, Skv, KV, first,
                     static_cast<cudaStream_t>(stream));
}

// no_key_first, for the wrapper's arithmetic to be held against.
int flash_attention_no_key_first(int S, int Skv, int causal, int window) {
  return no_key_first(S, Skv, causal, window);
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

int flash_attention_pingpong_smem_bytes(int hd) {
  switch (hd) {
    case 64: return pp_smem_bytes<64>();
    case 128: return pp_smem_bytes<128>();
    default: return -1;
  }
}

// The launch geometry of one call as the launchers above make it, for the
// wrapper's launch_geometry to be held against.  variant: 0 flash_fwd, 1
// flash_fwd_wgmma, 2 flash_fwd_tf32x3, 3 flash_fwd_pingpong.  out: grid x, y, z, threads a block,
// dynamic shared memory bytes, query rows a block, keys a K/V tile, stages,
// then the K/V tensor maps' box (4 dims; zeros for flash_fwd).  Returns 0,
// or -1 for a variant and head_dim with no kernel.
int flash_attention_geometry(int variant, int hd, int B, int S, int H, int Skv, int* out) {
  dim3 grid;
  const uint32_t* box = nullptr;
  if (variant == 0 && (hd == 16 || hd == 32 || hd == 64 || hd == 128)) {
    grid = fwd_grid(S, H, B);
    out[3] = kThreads;
    out[4] = flash_attention_smem_bytes(hd);
    out[5] = kBQ;
    out[6] = kBK;
    out[7] = 1;
  } else if (variant == 1 && (hd == 64 || hd == 128)) {
    grid = wg_grid(S, H, B);
    out[3] = kWgThreads;
    out[4] = flash_attention_wgmma_smem_bytes(hd);
    out[5] = kWgBQ;
    out[6] = kWgBK;
    out[7] = hd == 64 ? wg_stages<64>() : wg_stages<128>();
    box = kWgKBox;
  } else if (variant == 2 && (hd == 64 || hd == 128)) {
    grid = tf_grid(S, Skv, H, B);
    out[3] = kTfThreads;
    out[4] = flash_attention_tf32x3_smem_bytes(hd);
    out[5] = kTfBQ;
    out[6] = hd == 64 ? TfTile<64>::BK : TfTile<128>::BK;
    out[7] = kTfStages;
    box = hd == 64 ? TfTile<64>::kKBox : TfTile<128>::kKBox;
  } else if (variant == 3 && (hd == 64 || hd == 128)) {
    const bool packed = pp_packed(S, Skv);
    grid = dim3(pp_blocks(hd, S, Skv, H, B), 1, 1);
    out[3] = 128 * (pp_consumers(hd, packed) + 1);
    out[4] = flash_attention_pingpong_smem_bytes(hd);
    out[5] = 64 * pp_consumers(hd, packed);
    out[6] = packed ? kPpPackBK : kPpBK;
    out[7] = hd == 64 ? pp_stages<64>() : pp_stages<128>();
    box = packed ? kPpPackKBox : kPpKBox;
  } else {
    return -1;
  }
  out[0] = static_cast<int>(grid.x);
  out[1] = static_cast<int>(grid.y);
  out[2] = static_cast<int>(grid.z);
  for (int i = 0; i < 4; ++i) out[8 + i] = box == nullptr ? 0 : static_cast<int>(box[i]);
  return 0;
}

}  // extern "C"
