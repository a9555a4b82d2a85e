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
// the arithmetic bound; wgmma/TMA and bf16 tensor cores are later work.
//
// Every entry point launches on the caller's stream, allocates nothing,
// does not synchronise, and returns cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_runtime.h>

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

}  // namespace

extern "C" {

// q [B, S, H, hd], k/v [B, Skv, KV, hd], o [B, S, H, hd] (contiguous, one
// dtype: bf16 = 0 → fp32, 1 → bf16); lse [B, H, S] fp32.  window < 0 means
// no window.  hd ∈ {16, 32, 64, 128}; H % KV == 0.
int flash_attention_forward(int bf16, int hd, const void* q, const void* k,
                            const void* v, void* o, float* lse, int B, int S,
                            int H, int Skv, int KV, int causal, int window,
                            float scale, void* stream) {
  if (B <= 0 || S <= 0 || Skv <= 0 || H <= 0 || KV <= 0 || H % KV != 0 ||
      B > 65535 || H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
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

}  // extern "C"
