// Batched standard normals from a counter-based generator: the CRF chain's
// half-spectrum proposal noise.
//
// Replaces mcmc_tpu/ops/noise_kernel.py::batched_normal (the Pallas TPU
// kernel; body _noise_kernel), which draws its bits from the TPU's
// hardware PRNG.  The card has no such generator, so the bits come from
// Philox4x32-10 (Salmon et al., SC'11; the constants curand and Random123
// use), keyed by one 64-bit seed per launch and countered by (call,
// chain, 0, 0): every output is a pure function of (seed, chain, index),
// whatever the launch layout.  The plain PyTorch version beside it,
// mcmc_tpu_torch/ops/noise_kernel.py::batched_normal_reference, computes
// the same words in int64 arithmetic.  Then the JAX kernel's transform,
// exactly as noise_kernel.py:67-76 writes it:
//   bits -> low 24 bits; u1 = bits1 * 2^-24 + 2^-25, u2 = bits2 * 2^-24;
//   r = sqrt(-2 log u1), t = 2 pi u2;
//   rows [0, R/2) get r cos t, rows [R/2, R) get r sin t
// (flat pair index q within each half).  The u1 offset caps r at
// sqrt(50 ln 2) ~ 5.887: the normal tail is cut there, as on the TPU.
// One Philox call gives four words, so two (u1, u2) pairs, so four
// normals: pair 2c takes words (0, 1), pair 2c + 1 words (2, 3).
//
// What bounds it on an H100: bytes.  The launch writes N * R * C float32
// (768 x 160 x 41 x 4 B = 20.2 MB, ~6 us at 3.35 TB/s) and reads one
// seed; the Philox rounds are integer multiply-highs and the transform a
// log, a sqrt and a sin/cos per pair, well under the card's rates.
// Design: one thread per Philox call, 256 threads a block, a flat grid
// over (chain, call); each thread writes its four normals as scalar
// stores at 2c, 2c + 1 of each half, so a warp's stores cover contiguous
// words (R * C is no multiple of 4 at C = 41, so no vector stores).  The
// seed is read from device memory: the host never waits for it.
//
// Build (plain C interface, loaded with ctypes):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false \
//        -shared -Xcompiler -fPIC -o libnoise_kernel.so noise_kernel.cu
// -fmad=false keeps u1's multiply and add two roundings, as the plain
// version computes them; logf, sqrtf, sinf and cosf are the accurate
// (not fast-math) forms, as PyTorch's CUDA log, sqrt, sin and cos.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr uint32_t kM0 = 0xD2511F53u;  // Philox4x32 multipliers
constexpr uint32_t kM1 = 0xCD9E8D57u;
constexpr uint32_t kW0 = 0x9E3779B9u;  // Weyl key increments
constexpr uint32_t kW1 = 0xBB67AE85u;

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint32_t k0,
                                               uint32_t k1) {
#pragma unroll
  for (int round = 0; round < 10; ++round) {
    if (round > 0) {
      k0 += kW0;
      k1 += kW1;
    }
    const uint32_t lo0 = kM0 * c.x, hi0 = __umulhi(kM0, c.x);
    const uint32_t lo1 = kM1 * c.z, hi1 = __umulhi(kM1, c.z);
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
  }
  return c;
}

// noise_kernel.py:67-76 on one (bits1, bits2) pair
__device__ __forceinline__ void box_muller(uint32_t b1, uint32_t b2,
                                           float& zc, float& zs) {
  const float u1 = (float)(b1 & 0xFFFFFFu) * 5.9604644775390625e-08f
                   + 2.98023223876953125e-08f;  // 2^-24, 2^-25
  const float u2 = (float)(b2 & 0xFFFFFFu) * 5.9604644775390625e-08f;
  const float r = sqrtf(-2.0f * logf(u1));
  const float t = 6.28318530717958647692f * u2;
  zc = r * cosf(t);
  zs = r * sinf(t);
}

__global__ void __launch_bounds__(kThreads)
noise_kernel(const long long* __restrict__ seed, float* __restrict__ out,
             int n_chains, int pairs, int calls) {
  const long long g = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (g >= (long long)n_chains * calls) return;
  const int chain = (int)(g / calls);
  const int call = (int)(g - (long long)chain * calls);
  const unsigned long long s = (unsigned long long)seed[0];
  const uint4 w = philox4x32_10(make_uint4((uint32_t)call, (uint32_t)chain,
                                           0u, 0u),
                                (uint32_t)s, (uint32_t)(s >> 32));
  float* o = out + (size_t)chain * 2 * pairs;
  const int q = 2 * call;
  float zc, zs;
  box_muller(w.x, w.y, zc, zs);
  o[q] = zc;
  o[pairs + q] = zs;
  if (q + 1 < pairs) {
    box_muller(w.z, w.w, zc, zs);
    o[q + 1] = zc;
    o[pairs + q + 1] = zs;
  }
}

}  // namespace

// (n_chains, rows, cols) float32 normals into out; rows even.
extern "C" int mcmc_batched_normal(const void* seed, void* out, int n_chains,
                                   int rows, int cols, void* stream) {
  if (n_chains <= 0 || rows <= 0 || cols <= 0) return 0;
  if (rows % 2) return (int)cudaErrorInvalidValue;
  const int pairs = rows / 2 * cols;
  const int calls = (pairs + 1) / 2;
  const long long threads = (long long)n_chains * calls;
  const unsigned blocks = (unsigned)((threads + kThreads - 1) / kThreads);
  noise_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const long long*)seed, (float*)out, n_chains, pairs, calls);
  return (int)cudaGetLastError();
}

extern "C" const char* mcmc_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
