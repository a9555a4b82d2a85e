// CoDA main-path kernels for Hopper (sm_90a), with a plain C interface that
// Python loads through ctypes (see kernels/_build.py).
//
//   coda_auc_loss        replaces repro/kernels/auc_loss.py::auc_loss (Pallas)
//   coda_prox_update_*   replaces repro/kernels/prox_update.py::prox_update
//
// Every entry point launches on the caller's stream, allocates nothing,
// does not synchronise, and returns cudaGetLastError() so the wrapper can
// raise on a refused launch.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

// ---------------------------------------------------------------------------
// auc_loss: one pass over the scores of every worker.
//
// Grid (ceil(T / kAucRows), K): block (i, k) reads kAucRows scores and labels
// of worker k, writes dh for them, and reduces its four partial sums
// (Σ f′, Σ ∂a, Σ ∂b, Σ ∂α′) into partials[k, i, :] with warp shuffles and
// shared memory.  A second launch, one warp per worker, sums those partials
// in a fixed order.  No atomics: repeated runs are bitwise identical.
//
// The per-row constants of F and ∂α (−p(1−p)α² and −2p(1−p)α, which the
// TPU kernel masks by `live` and sums) are added once in the finishing
// kernel: Σ live = T, so the result is the same sum without T rounding
// steps.
// ---------------------------------------------------------------------------
constexpr int kAucThreads = 256;
constexpr int kAucRowsPerThread = 4;
constexpr int kAucRows = kAucThreads * kAucRowsPerThread;  // rows per block

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

__global__ void __launch_bounds__(kAucThreads)
auc_loss_blocks(const float* __restrict__ h, const float* __restrict__ y,
                const float* __restrict__ a_, const float* __restrict__ b_,
                const float* __restrict__ alpha_, float p, int T,
                float* __restrict__ dh, float* __restrict__ partials) {
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
  if (warp == 0) {
    float* out = partials + (static_cast<long long>(k) * gridDim.x + blockIdx.x) * 4;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      float v = lane < kAucThreads / 32 ? red[lane][c] : 0.f;
      v = warp_sum(v);
      if (lane == 0) out[c] = v;
    }
  }
}

__global__ void __launch_bounds__(32)
auc_loss_finish(const float* __restrict__ partials, int n_blocks,
                const float* __restrict__ alpha_, float p, int T,
                float* __restrict__ out) {
  const int k = blockIdx.x;
  const int lane = threadIdx.x;
  const float* src = partials + static_cast<long long>(k) * n_blocks * 4;
  const float Tf = static_cast<float>(T);
  const float alpha = alpha_[k];
  const float pq = p * (1.0f - p);
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    float v = 0.f;
    for (int i = lane; i < n_blocks; i += 32) v += src[i * 4 + c];
    v = warp_sum(v);
    if (lane == 0) {
      float r = v / Tf;
      if (c == 0) r -= pq * alpha * alpha;   // loss: the −p(1−p)α² term
      if (c == 3) r -= 2.0f * pq * alpha;    // dα: the −2p(1−p)α term
      out[k * 4 + c] = r;
    }
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

}  // namespace

extern "C" {

// h, y: [K, T] fp32; a, b, alpha: [K] fp32; dh: [K, T] fp32;
// partials: [K, ceil(T / coda_auc_rows_per_block()), 4] fp32 scratch;
// out: [K, 4] fp32 = (loss, da, db, dalpha) per worker.
int coda_auc_loss(const void* h, const void* y, const void* a, const void* b,
                  const void* alpha, float p, int K, int T, void* dh,
                  void* partials, void* out, void* stream) {
  if (K > 0 && T > 0) {
    const int n_blocks = (T + kAucRows - 1) / kAucRows;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    auc_loss_blocks<<<dim3(n_blocks, K), kAucThreads, 0, s>>>(
        static_cast<const float*>(h), static_cast<const float*>(y),
        static_cast<const float*>(a), static_cast<const float*>(b),
        static_cast<const float*>(alpha), p, T, static_cast<float*>(dh),
        static_cast<float*>(partials));
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    auc_loss_finish<<<K, 32, 0, s>>>(static_cast<const float*>(partials), n_blocks,
                                     static_cast<const float*>(alpha), p, T,
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

const char* coda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
