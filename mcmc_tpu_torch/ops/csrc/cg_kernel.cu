// Fixed-iteration conjugate gradients on the SGS chain's packed
// conditioning systems, one masked K x K system per chain.  Two kernels
// share the solver (cg_iterate) and differ only in how the system reaches
// shared memory:
//
// mix_cg_kernel replaces mcmc_tpu/ops/cg_kernel.py::lanes_mix_masked_cg
// (the Pallas TPU kernel; body _cg_lanes_mix_kernel, solver _cg_core).
// Same function and contract as the plain PyTorch version beside it,
// mcmc_tpu_torch/ops/cg_kernel.py::mix_masked_cg_reference:
//   1. build A[i][j] = S(h2_ij) * m_i * m_j, plus eps + (1 - m_j) on the
//      diagonal, with h2_ij = q0*dj*dj + q1*dj*di + q2*di*di (di = ia_i -
//      ia_j, dj = ja_i - ja_j) and S the static Gaussian+exponential
//      mixture evaluated as ops/covariance.py::eval_mixture_static orders
//      it: the Gaussian family, then the exponential; per dyadic family ONE
//      expf(-b0 * x) and repeated squaring by rising k, terms summed in that
//      order (x = h2, or sqrt(h2) for the exponential family); per-term
//      expf for a non-dyadic family.  The mixture arrives as a by-value
//      kernel parameter (MixParams).
//
// masked_cg_kernel replaces mcmc_tpu/ops/cg_kernel.py::lanes_masked_cg
// (body _cg_lanes_kernel, system _masked_system, solver _cg_core), the
// solve of a covariance with no mixture fit (a spherical variogram), with
// the plain version ops/cg_kernel.py::masked_cg_reference:
//   1. load A = Sigma * m_j * m_i, plus eps + (1 - m_i) on the diagonal,
//      from the given (N, K, K) Sigma.  Like _cg_core, which reads block j
//      of the (K*K, B) system as column j, the kernel takes row j of Sigma
//      as column j (Sigma is symmetric), so the load is a straight
//      coalesced copy of the chain's K*K words.
//
// Both then
//   2. run n_iters iterations of _cg_core from x = 0 on b = m * rhs, with
//      its 1e-30 guards on both denominators, the matvec summed over j in
//      rising order as _cg_core sums its blocks;
//   3. write w = x * m.
//
// What bounds them on an H100: latency.  Per chain the work is n_iters x
// (K^2 multiply-adds + two K-long dot products) on data that fits one
// SM's shared memory, with three barriers per iteration on the critical
// path, plus ~K^2 = 2304 mixture evaluations (mix) or one 9.2 KB load of
// Sigma (masked).  By the card's peak rates both are bound by float32
// operations (113-151 MFLOP at 512 chains, ~2 us; the masked kernel's
// 4.7 MB of Sigma take ~1.4 us), far below the latency of n_iters
// dependent iterations.  Design: one CTA of 64 threads per chain
// (thread i owns row i; K <= 64, idle lanes carry zeros), the system in
// shared memory column-major (A[j*K + i], 9.2 KB at K = 48) so the threads
// of a warp read consecutive words, the search direction broadcast from
// shared memory, dot products by warp shuffles and one shared-memory pass:
// no atomics, so every run gives identical results.  The TPU version's
// batch-in-lanes layout, 128-lane padding and lane-block VMEM budget are
// dropped.
//
// Build (plain C interface, loaded with ctypes):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false \
//        -shared -Xcompiler -fPIC -o libcg_kernel.so cg_kernel.cu
// -fmad=false keeps every a*b+c as two roundings, as the plain version's
// separate PyTorch operations compute it.

#include <cuda_runtime.h>
#include <math.h>

constexpr int kThreads = 64;    // = the largest K the kernels take
constexpr int kMaxTerms = 16;

// The mixture parameters (mirrored by ctypes in ops/cg_kernel.py).  At
// namespace scope, not in the anonymous namespace: the extern "C" launcher
// takes a pointer to them and would otherwise get internal linkage.
struct MixFamily {
  int in_h;     // 1: the family decays in sqrt(h2) (exponential)
  int dyadic;   // 1: rates nb0 * 2^k, one expf and repeated squaring
  float nb0;    // -b0, the negated base rate (dyadic)
  int n;        // number of terms
  int k[kMaxTerms];        // dyadic: the exponents, rising
  float nrate[kMaxTerms];  // non-dyadic: the negated rates, in order
  float amp[kMaxTerms];    // the amplitudes
};

struct MixParams {
  int n_fam;
  MixFamily fam[2];
  float q[3];
};

namespace {

__device__ __forceinline__ float mixture(const MixParams& mix, float h2) {
  float out = 0.0f;
  for (int f = 0; f < mix.n_fam; ++f) {
    const MixFamily& fam = mix.fam[f];
    const float x = fam.in_h ? sqrtf(h2) : h2;
    float s = 0.0f;
    if (fam.dyadic) {
      float E = expf(x * fam.nb0);
      int k_cur = 0;
      for (int t = 0; t < fam.n; ++t) {
        while (k_cur < fam.k[t]) {
          E = E * E;
          ++k_cur;
        }
        const float term = E * fam.amp[t];
        s = t == 0 ? term : s + term;
      }
    } else {
      for (int t = 0; t < fam.n; ++t) {
        const float term = expf(x * fam.nrate[t]) * fam.amp[t];
        s = t == 0 ? term : s + term;
      }
    }
    out = f == 0 ? s : out + s;
  }
  return out;
}

// jnp.maximum(x, 1e-30): the guard, with NaN passed through
__device__ __forceinline__ float guard(float x) {
  return (x >= 1e-30f || isnan(x)) ? x : 1e-30f;
}

// Sum over the CTA's 64 threads; every thread gets the total.
__device__ __forceinline__ float cta_sum(float v, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  const float s = red[0] + red[1];
  __syncthreads();  // red is reused by the next sum
  return s;
}

// _cg_core on the CTA's system A (shared memory, column-major): thread i
// owns row i (m, rh its mask and right-hand side, both 0 where i >= K).
// Returns row i of x after n_iters iterations.  Callers synchronise after
// writing A.
__device__ __forceinline__ float cg_iterate(const float* A, int K, float m,
                                            float rh, int n_iters,
                                            float* p_s, float* red) {
  const int i = threadIdx.x;
  const bool active = i < K;
  float x = 0.0f;
  float r = m * rh;
  float p = r;
  float rs = cta_sum(r * r, red);
  for (int it = 0; it < n_iters; ++it) {
    p_s[i] = p;
    __syncthreads();
    float q = 0.0f;
    if (active) {
      q = A[i] * p_s[0];
      for (int j = 1; j < K; ++j) q = q + A[j * K + i] * p_s[j];
    }
    const float pAp = cta_sum(p * q, red);
    const float alpha = rs / guard(pAp);
    x = x + alpha * p;
    r = r - alpha * q;
    const float rs_new = cta_sum(r * r, red);
    p = r + (rs_new / guard(rs)) * p;
    rs = rs_new;
  }
  return x;
}

__global__ void __launch_bounds__(kThreads)
mix_cg_kernel(const float* __restrict__ iaf, const float* __restrict__ jaf,
              const float* __restrict__ mask, const float* __restrict__ rhs,
              const float* __restrict__ eps, float* __restrict__ out, int K,
              int n_iters, MixParams mix) {
  extern __shared__ float A[];  // (K, K), A[j * K + i] = A[i][j]
  __shared__ float ia_s[kThreads], ja_s[kThreads], m_s[kThreads];
  __shared__ float p_s[kThreads];
  __shared__ float red[kThreads / 32];

  const int n = blockIdx.x;
  const int i = threadIdx.x;
  const bool active = i < K;
  const size_t base = (size_t)n * K;
  float ia = 0.0f, ja = 0.0f, m = 0.0f, rh = 0.0f;
  if (active) {
    ia = iaf[base + i];
    ja = jaf[base + i];
    m = mask[base + i];
    rh = rhs[base + i];
  }
  ia_s[i] = ia;
  ja_s[i] = ja;
  m_s[i] = m;
  const float e = eps[n];
  const float q0 = mix.q[0], q1 = mix.q[1], q2 = mix.q[2];
  __syncthreads();

  // ---- the masked system, column j of row i -----------------------------
  if (active) {
    for (int j = 0; j < K; ++j) {
      const float dif = ia - ia_s[j];
      const float djf = ja - ja_s[j];
      const float h2 = q0 * djf * djf + q1 * djf * dif + q2 * dif * dif;
      float a = mixture(mix, h2) * m * m_s[j];
      if (i == j) a = a + (e + (1.0f - m_s[j]));
      A[j * K + i] = a;
    }
  }
  __syncthreads();

  const float x = cg_iterate(A, K, m, rh, n_iters, p_s, red);
  if (active) out[base + i] = x * m;
}

__global__ void __launch_bounds__(kThreads)
masked_cg_kernel(const float* __restrict__ sigma,
                 const float* __restrict__ mask,
                 const float* __restrict__ rhs,
                 const float* __restrict__ eps, float* __restrict__ out,
                 int K, int n_iters) {
  extern __shared__ float A[];  // (K, K), A[j * K + i] = Sigma[j][i]
  __shared__ float m_s[kThreads];
  __shared__ float p_s[kThreads];
  __shared__ float red[kThreads / 32];

  const int n = blockIdx.x;
  const int i = threadIdx.x;
  const bool active = i < K;
  const size_t base = (size_t)n * K;
  float m = 0.0f, rh = 0.0f;
  if (active) {
    m = mask[base + i];
    rh = rhs[base + i];
  }
  m_s[i] = m;
  const float e = eps[n];
  __syncthreads();

  // ---- the masked system: Sigma row j as column j (_masked_system) -------
  const float* S = sigma + (size_t)n * K * K;
  const int KK = K * K;
  for (int t = i; t < KK; t += kThreads) {
    const int j = t / K;
    const int c = t - j * K;
    float a = S[t] * m_s[j] * m_s[c];
    if (c == j) a = a + (e + (1.0f - m_s[c]));
    A[t] = a;
  }
  __syncthreads();

  const float x = cg_iterate(A, K, m, rh, n_iters, p_s, red);
  if (active) out[base + i] = x * m;
}

}  // namespace

extern "C" int mcmc_mix_masked_cg(const void* iaf, const void* jaf,
                                  const void* mask, const void* rhs,
                                  const void* eps, void* out,
                                  const MixParams* mix, int n_chains, int K,
                                  int n_iters, void* stream) {
  if (n_chains <= 0) return 0;
  if (K < 1 || K > kThreads) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)K * K * sizeof(float);
  mix_cg_kernel<<<n_chains, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)iaf, (const float*)jaf, (const float*)mask,
      (const float*)rhs, (const float*)eps, (float*)out, K, n_iters, *mix);
  return (int)cudaGetLastError();
}

extern "C" int mcmc_masked_cg(const void* sigma, const void* mask,
                              const void* rhs, const void* eps, void* out,
                              int n_chains, int K, int n_iters,
                              void* stream) {
  if (n_chains <= 0) return 0;
  if (K < 1 || K > kThreads) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)K * K * sizeof(float);
  masked_cg_kernel<<<n_chains, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)sigma, (const float*)mask, (const float*)rhs,
      (const float*)eps, (float*)out, K, n_iters);
  return (int)cudaGetLastError();
}

extern "C" const char* mcmc_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
