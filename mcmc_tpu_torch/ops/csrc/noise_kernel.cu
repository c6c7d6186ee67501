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
// What bounds it on an H100: instruction issue.  The launch writes
// N * R * C float32 (768 x 160 x 41 x 4 B = 20.2 MB, ~6 us at 3.35 TB/s)
// and reads one seed, but each Philox call costs ~80 integer instructions
// and each of its two Box-Muller pairs an accurate log, sqrt and sin/cos
// (~70 more), about as long on the issue slots as the bytes take.  Design,
// to spend the issue slots on that arithmetic alone:
//   - a 2D grid, the chain in blockIdx.x (up to 2^31 - 1 chains) and the
//     chain's blocks of calls along blockIdx.y, strided by gridDim.y
//     where a chain needs more than 65,535 of them: no division to find
//     either;
//   - kCalls Philox calls per thread, kThreads apart, so the seed load,
//     the key schedule (ten round keys, kept in registers) and the
//     pointer arithmetic are shared by them, and each warp's stores of
//     one call still cover contiguous words;
//   - sincosf: one range reduction for the sin and the cos of t; CUDA's
//     sincosf returns the same bits as sinf and cosf;
//   - where pairs = R/2 * C is even (3,280 at the headline), float2
//     stores of the two adjacent pairs of a call into each half; an odd
//     count takes scalar stores in the same kernel (a uniform branch).
// The seed is read from device memory: the host never waits for it.
//
// The keyed entry (mcmc_batched_normal_keyed), for a farm seeded with a
// list of per-chain seeds: the same kernel with chain c keyed by its own
// (k0, k1) = keys[c] and countered by (step low word, slot, call, step
// high word), the step an int64 read from device memory.  Every output
// is then a pure function of (key c, step, slot, index), so chain c's
// normals do not depend on the other chains; the plain version is
// mcmc_tpu_torch/ops/noise_kernel.py::batched_normal_keyed_reference.
// The design is the single-seed entry's: one key schedule a block (its
// chain's) instead of one a launch is a change of inputs, and the
// single-seed entry's bits are unchanged (a template flag).
//
// Build (plain C interface, loaded with ctypes):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false \
//        -shared -Xcompiler -fPIC -o libnoise_kernel.so noise_kernel.cu
// -fmad=false keeps u1's multiply and add two roundings, as the plain
// version computes them; logf, sqrtf and sincosf are the accurate (not
// fast-math) forms, as PyTorch's CUDA log, sqrt, sin and cos.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 64;  // threads a block
constexpr int kCalls = 2;     // Philox calls a thread
constexpr int kRounds = 10;
constexpr uint32_t kM0 = 0xD2511F53u;  // Philox4x32 multipliers
constexpr uint32_t kM1 = 0xCD9E8D57u;
constexpr uint32_t kW0 = 0x9E3779B9u;  // Weyl key increments
constexpr uint32_t kW1 = 0xBB67AE85u;

struct Keys {
  uint32_t k0[kRounds], k1[kRounds];
};

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, const Keys& k) {
#pragma unroll
  for (int round = 0; round < kRounds; ++round) {
    const uint32_t lo0 = kM0 * c.x, hi0 = __umulhi(kM0, c.x);
    const uint32_t lo1 = kM1 * c.z, hi1 = __umulhi(kM1, c.z);
    c = make_uint4(hi1 ^ c.y ^ k.k0[round], lo1, hi0 ^ c.w ^ k.k1[round],
                   lo0);
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
  float s, c;
  sincosf(t, &s, &c);
  zc = r * c;
  zs = r * s;
}

// kKeyed: key keys[chain], counter (step lo, slot, call, step hi); else
// key seed[0], counter (call, chain, 0, 0)
template <bool kKeyed>
__global__ void __launch_bounds__(kThreads)
noise_kernel(const long long* __restrict__ seed,
             const uint2* __restrict__ keys, uint32_t slot,
             float* __restrict__ out, int pairs, int calls) {
  const int chain = blockIdx.x;
  Keys k;
  uint32_t step_lo = 0, step_hi = 0;
  if (kKeyed) {
    const uint2 key = keys[chain];
    k.k0[0] = key.x;
    k.k1[0] = key.y;
    const unsigned long long s = (unsigned long long)seed[0];
    step_lo = (uint32_t)s;
    step_hi = (uint32_t)(s >> 32);
  } else {
    const unsigned long long s = (unsigned long long)seed[0];
    k.k0[0] = (uint32_t)s;
    k.k1[0] = (uint32_t)(s >> 32);
  }
#pragma unroll
  for (int round = 1; round < kRounds; ++round) {
    k.k0[round] = k.k0[round - 1] + kW0;
    k.k1[round] = k.k1[round - 1] + kW1;
  }
  float* cos_half = out + (size_t)chain * 2 * pairs;
  float* sin_half = cos_half + pairs;
  const bool paired = (pairs & 1) == 0;  // uniform over the launch
  // calls < 2^29 (the wrapper takes fewer than 2^31 normals), so the
  // stride never overflows
  for (int first = blockIdx.y * (kThreads * kCalls) + threadIdx.x;
       first < calls; first += gridDim.y * (kThreads * kCalls)) {
#pragma unroll
    for (int j = 0; j < kCalls; ++j) {
      const int call = first + j * kThreads;
      if (call >= calls) break;
      const uint4 ctr =
          kKeyed ? make_uint4(step_lo, slot, (uint32_t)call, step_hi)
                 : make_uint4((uint32_t)call, (uint32_t)chain, 0u, 0u);
      const uint4 w = philox4x32_10(ctr, k);
      const int q = 2 * call;
      float c0, s0, c1, s1;
      box_muller(w.x, w.y, c0, s0);
      if (paired) {  // q + 1 < pairs, and both halves 8-byte aligned
        box_muller(w.z, w.w, c1, s1);
        *reinterpret_cast<float2*>(cos_half + q) = make_float2(c0, c1);
        *reinterpret_cast<float2*>(sin_half + q) = make_float2(s0, s1);
      } else {
        cos_half[q] = c0;
        sin_half[q] = s0;
        if (q + 1 < pairs) {
          box_muller(w.z, w.w, c1, s1);
          cos_half[q + 1] = c1;
          sin_half[q + 1] = s1;
        }
      }
    }
  }
}

template <bool kKeyed>
int launch_noise(const void* seed, const void* keys, int slot, void* out,
                 int n_chains, int rows, int cols, void* stream) {
  if (n_chains <= 0 || rows <= 0 || cols <= 0) return 0;
  if (rows % 2) return (int)cudaErrorInvalidValue;
  const int pairs = rows / 2 * cols;
  const int calls = (pairs + 1) / 2;
  const int blocks = (calls + kThreads * kCalls - 1) / (kThreads * kCalls);
  const dim3 grid(n_chains, blocks < 65535 ? blocks : 65535);
  noise_kernel<kKeyed><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const long long*)seed, (const uint2*)keys, (uint32_t)slot,
      (float*)out, pairs, calls);
  return (int)cudaGetLastError();
}

}  // namespace

// (n_chains, rows, cols) float32 normals into out; rows even.
extern "C" int mcmc_batched_normal(const void* seed, void* out, int n_chains,
                                   int rows, int cols, void* stream) {
  return launch_noise<false>(seed, nullptr, 0, out, n_chains, rows, cols,
                             stream);
}

// The keyed entry: keys (n_chains, 2) uint32, step one int64, both in
// device memory.
extern "C" int mcmc_batched_normal_keyed(const void* keys, const void* step,
                                         void* out, int slot, int n_chains,
                                         int rows, int cols, void* stream) {
  return launch_noise<true>(step, keys, slot, out, n_chains, rows, cols,
                            stream);
}

extern "C" const char* mcmc_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
