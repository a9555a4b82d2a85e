// CoDA main-path kernels for Hopper (sm_90a), with a plain C interface that
// Python loads through ctypes (see kernels/_build.py).
//
//   coda_auc_loss        replaces repro/kernels/auc_loss.py::auc_loss (Pallas)
//   coda_prox_update_*   replaces repro/kernels/prox_update.py::prox_update
//   coda_opt_update      replaces repro/kernels/opt_update.py::opt_update
//
// Every entry point launches on the caller's stream, allocates nothing,
// does not synchronise, and returns cudaGetLastError() so the wrapper can
// raise on a refused launch.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

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
// prox_update: v ← (γ(v − ηg) + ηv₀) / (η + γ), elementwise, fp32 math.
//
// A grid-stride pass over the flat leaf (all K workers at once).  Each
// operation is an explicitly rounded fp32 intrinsic in the plain version's
// order, so no FMA contraction changes the result; bf16 stores round to
// nearest even like torch's and jax's casts.  η and γ are runtime
// arguments: a new stage launches the same kernel.
// ---------------------------------------------------------------------------
constexpr int kProxThreads = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

template <typename T>
__global__ void __launch_bounds__(kProxThreads)
prox_update_kernel(const T* __restrict__ v, const T* __restrict__ g,
                   const T* __restrict__ v0, T* __restrict__ out, long long n,
                   float eta, float gamma) {
  const float denom = __fadd_rn(eta, gamma);
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    const float vf = to_f32(v[i]);
    const float gf = to_f32(g[i]);
    const float v0f = to_f32(v0[i]);
    const float num = __fadd_rn(__fmul_rn(gamma, __fsub_rn(vf, __fmul_rn(eta, gf))),
                                __fmul_rn(eta, v0f));
    store(out + i, __fdiv_rn(num, denom));
  }
}

template <typename T>
int launch_prox(const void* v, const void* g, const void* v0, void* out,
                long long n, float eta, float gamma, void* stream) {
  if (n > 0) {
    long long blocks = (n + kProxThreads - 1) / kProxThreads;
    if (blocks > 132LL * 16) blocks = 132LL * 16;  // 16 blocks per SM, then stride
    prox_update_kernel<T><<<static_cast<unsigned>(blocks), kProxThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(v), static_cast<const T*>(g),
        static_cast<const T*>(v0), static_cast<T*>(out), n, eta, gamma);
  }
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// opt_update: the fused local-optimizer step, one pass over a flat leaf.
//
// Replaces repro/kernels/opt_update.py::opt_update (Pallas, pallas_call at
// :86).  Per element it reads v, g, v0 and the buffer and writes v' and the
// new buffer:
//   momentum: m = coef·m + g, d = m; m is stored in the buffer's dtype,
//             bf16 through the reference's hash-based stochastic rounding;
//   precond:  ν = cover + g², d = g · (1/√(ν + coef)); ν is stored in fp32;
// then the prox step of prox_update: v' = (γ(v − ηd) + ηv₀) / (η + γ).
//
// What bounds it on the card: bytes.  4 reads and 2 writes per element —
// 24 B in fp32, 20 B with a bf16 momentum buffer — against about 10 fp32
// operations and a 5-step integer hash.  The design is the plain grid-stride
// pass of prox_update: one coalesced read of each input and one write of
// each output, fp32 master math, η, γ, coef as runtime arguments.
//
// Bitwise agreement with the plain version (kernels/ref.py) is the point:
//   * every fp32 operation is an explicitly rounded intrinsic in the plain
//     version's order, so no FMA contraction changes a bit, and coef = 0
//     with an fp32 buffer is prox_update bitwise;
//   * 1/√x is __fsqrt_rn then __fdiv_rn — two correctly rounded steps that
//     plain PyTorch repeats exactly on the CPU and on CUDA (__frsqrt_rn
//     would be one step, which no PyTorch operation reproduces);
//   * the hash runs in native uint32 arithmetic, which wraps mod 2³²;
//   * the seed is read from device memory (one int64 holding a uint32), so
//     the caller never has to bring the step counter to the host.
// ---------------------------------------------------------------------------
constexpr int kOptThreads = 256;
constexpr int kModeMomentum = 0;
constexpr int kModePrecond = 1;

__device__ __forceinline__ unsigned mix_bits(unsigned x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

// The new momentum buffer: fp32 as is; bf16 by adding 16 hashed low bits and
// truncating.  A NaN left after the truncation becomes the quiet NaN with
// its sign (0x7FC0 / 0xFFC0), as the reference's fp32→bf16 conversion gives.
__device__ __forceinline__ void store_buf(float* p, float acc, unsigned) { *p = acc; }
__device__ __forceinline__ void store_buf(__nv_bfloat16* p, float acc, unsigned seed) {
  const unsigned xi = __float_as_uint(acc);
  const unsigned r = mix_bits(xi ^ seed) & 0xFFFFu;
  const unsigned yi = (xi + r) & 0xFFFF0000u;
  unsigned short hi = static_cast<unsigned short>(yi >> 16);
  if ((yi & 0x7FFFFFFFu) > 0x7F800000u) hi = (yi >> 31) ? 0xFFC0 : 0x7FC0;
  *reinterpret_cast<unsigned short*>(p) = hi;
}

template <int kMode, typename T, typename B>
__global__ void __launch_bounds__(kOptThreads)
opt_update_kernel(const T* __restrict__ v, const T* __restrict__ g,
                  const T* __restrict__ v0, const B* __restrict__ buf,
                  T* __restrict__ out_v, B* __restrict__ out_buf, long long n,
                  float eta, float gamma, float coef,
                  const long long* __restrict__ seed_p) {
  const unsigned seed = static_cast<unsigned>(*seed_p);
  const float denom = __fadd_rn(eta, gamma);
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    const float vf = to_f32(v[i]);
    const float gf = to_f32(g[i]);
    const float v0f = to_f32(v0[i]);
    const float bf = to_f32(buf[i]);
    float d;
    if (kMode == kModeMomentum) {
      const float acc = __fadd_rn(__fmul_rn(coef, bf), gf);
      d = acc;
      store_buf(out_buf + i, acc, seed);
    } else {
      const float acc = __fadd_rn(bf, __fmul_rn(gf, gf));
      d = __fmul_rn(gf, __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(acc, coef))));
      store_buf(out_buf + i, acc, seed);
    }
    const float num = __fadd_rn(__fmul_rn(gamma, __fsub_rn(vf, __fmul_rn(eta, d))),
                                __fmul_rn(eta, v0f));
    store(out_v + i, __fdiv_rn(num, denom));
  }
}

template <int kMode, typename T, typename B>
int launch_opt(const void* v, const void* g, const void* v0, const void* buf,
               void* out_v, void* out_buf, long long n, float eta, float gamma,
               float coef, const void* seed, void* stream) {
  if (n > 0) {
    long long blocks = (n + kOptThreads - 1) / kOptThreads;
    if (blocks > 132LL * 16) blocks = 132LL * 16;  // 16 blocks per SM, then stride
    opt_update_kernel<kMode, T, B><<<static_cast<unsigned>(blocks), kOptThreads, 0,
                                     static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(v), static_cast<const T*>(g),
        static_cast<const T*>(v0), static_cast<const B*>(buf),
        static_cast<T*>(out_v), static_cast<B*>(out_buf), n, eta, gamma, coef,
        static_cast<const long long*>(seed));
  }
  return static_cast<int>(cudaGetLastError());
}

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
    const int n_blocks = (T + kAucRows - 1) / kAucRows;
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

int coda_prox_update_f32(const void* v, const void* g, const void* v0, void* out,
                         long long n, float eta, float gamma, void* stream) {
  return launch_prox<float>(v, g, v0, out, n, eta, gamma, stream);
}

int coda_prox_update_bf16(const void* v, const void* g, const void* v0, void* out,
                          long long n, float eta, float gamma, void* stream) {
  return launch_prox<__nv_bfloat16>(v, g, v0, out, n, eta, gamma, stream);
}

// mode: 0 momentum, 1 precond; v_bf16 / buf_bf16: 0 fp32, 1 bf16 (v, g, v0
// share one dtype; precond takes an fp32 buffer only).  seed: one int64 on
// the device holding a uint32.  Out of place: out_v, out_buf are the
// caller's fresh tensors of v's and buf's shape and dtype.
int coda_opt_update(int mode, int v_bf16, int buf_bf16, const void* v,
                    const void* g, const void* v0, const void* buf, void* out_v,
                    void* out_buf, long long n, float eta, float gamma,
                    float coef, const void* seed, void* stream) {
#define CODA_OPT(M, T, B) \
  launch_opt<M, T, B>(v, g, v0, buf, out_v, out_buf, n, eta, gamma, coef, seed, stream)
  if (mode == kModeMomentum) {
    if (!v_bf16 && !buf_bf16) return CODA_OPT(kModeMomentum, float, float);
    if (!v_bf16 && buf_bf16) return CODA_OPT(kModeMomentum, float, __nv_bfloat16);
    if (v_bf16 && !buf_bf16) return CODA_OPT(kModeMomentum, __nv_bfloat16, float);
    return CODA_OPT(kModeMomentum, __nv_bfloat16, __nv_bfloat16);
  }
  if (mode == kModePrecond && !buf_bf16) {
    if (!v_bf16) return CODA_OPT(kModePrecond, float, float);
    return CODA_OPT(kModePrecond, __nv_bfloat16, float);
  }
#undef CODA_OPT
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* coda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
