// Per-chain draws: all of a chain-farm step's uniforms, indices and
// normals for every chain in one launch, each chain from its own Philox
// key.
//
// The port's own kernel, for a farm seeded with a list of per-chain seeds
// (mcmc_tpu_torch/utils/rng.py::PerChainStreams).  It replaces no Pallas
// kernel: the JAX package draws these values with jax.random under vmap
// (mcmc_tpu/models/chain_crf.py, chain_sgs.py), one key per chain.  The
// plain PyTorch version beside it is mcmc_tpu_torch/ops/chain_draws.py::
// chain_draws_reference; built with -fmad=false, the two agree bitwise.
//
// A static draw plan (at most kMaxEntries entries, passed by value as a
// __grid_constant__ parameter) lists (slot, kind, count, n, lo, out
// column, first call) per entry.  Chain c's call j of an entry is
// Philox4x32-10 keyed by keys[c] and countered by (step low word, slot,
// j, step high word), the step an int64 read from device memory, so
// every value is a pure function of (key c, step, slot, index).  The
// conversions (ops/chain_draws.py's docstring):
//   uniform: word e % 4 of call e / 4, (w >> 8) * 2^-24 in [0, 1);
//   index:   words (2(e%2), 2(e%2)+1) of call e / 2 as x = w_a 2^32 + w_b,
//            lo + umul64hi(x, n): the high word of the 64 x 32-bit
//            product, bias below 2^-32;
//   normal:  call e / 4 -> (r cos t, r sin t) of words (0, 1), then of
//            words (2, 3), by noise_kernel.cu's Box-Muller (the JAX
//            kernel's transform, mcmc_tpu/ops/noise_kernel.py:67-76).
//
// What bounds it on an H100: at the SGS headline (512 chains, 6,400
// normals and two indices, an index and a uniform a chain) instruction
// issue, as for the noise kernel: ~80 integer instructions a Philox call
// and an accurate log, sqrt and sincos a pair of normals, against 13 MB
// of stores (~4 us at 3.35 TB/s); at the CRF headline (768 chains, seven
// values a chain) the launch itself.  Design:
//   - one thread a Philox call over a flat grid of chains x calls: the
//     entry is found by a walk over at most kMaxEntries first calls (a
//     branch uniform within a warp except at entry boundaries);
//   - each call stores its 4 floats or 2 int64 as one 16-byte store:
//     every entry's columns start at a multiple of 16 bytes and each
//     chain's row is a multiple of 16 bytes (the wrapper's layout), so
//     neighbouring threads write neighbouring 16-byte chunks; an entry's
//     last, partial call stores its values one by one;
//   - the ten round keys are derived in registers as the rounds go: one
//     call a thread shares nothing a precomputed schedule would save.
//
// Build (plain C interface, loaded with ctypes):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false \
//        -shared -Xcompiler -fPIC -o libchain_draws.so chain_draws.cu
// -fmad=false keeps u1's multiply and add two roundings; logf, sqrtf and
// sincosf are the accurate forms, as PyTorch's CUDA log, sqrt, sin, cos.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxEntries = 16;
constexpr int kRounds = 10;
constexpr uint32_t kM0 = 0xD2511F53u;  // Philox4x32 multipliers
constexpr uint32_t kM1 = 0xCD9E8D57u;
constexpr uint32_t kW0 = 0x9E3779B9u;  // Weyl key increments
constexpr uint32_t kW1 = 0xBB67AE85u;
constexpr int kUniform = 0, kIndex = 1, kNormal = 2;

struct Entry {
  long long lo;
  uint32_t n;
  int slot, kind, count, out, call0;
};

struct Plan {
  Entry e[kMaxEntries];
  int n_entries, calls, floats, ints;
};

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint32_t k0,
                                               uint32_t k1) {
#pragma unroll
  for (int round = 0; round < kRounds; ++round) {
    const uint32_t lo0 = kM0 * c.x, hi0 = __umulhi(kM0, c.x);
    const uint32_t lo1 = kM1 * c.z, hi1 = __umulhi(kM1, c.z);
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
    k0 += kW0;
    k1 += kW1;
  }
  return c;
}

// noise_kernel.cu's box_muller (mcmc_tpu/ops/noise_kernel.py:67-76)
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

__device__ __forceinline__ void store4(float* dst, int rem, float a,
                                       float b, float c, float d) {
  if (rem >= 4) {
    *reinterpret_cast<float4*>(dst) = make_float4(a, b, c, d);
  } else {
    dst[0] = a;
    if (rem > 1) dst[1] = b;
    if (rem > 2) dst[2] = c;
  }
}

__global__ void __launch_bounds__(kThreads)
chain_draws_kernel(const uint2* __restrict__ keys,
                   const long long* __restrict__ step,
                   const __grid_constant__ Plan plan, int total,
                   float* __restrict__ fout, long long* __restrict__ iout) {
  // total = chains x calls < 2^31 (the wrapper's check): 32-bit division
  const int t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= total) return;
  const int chain = t / plan.calls;
  const int g = t - chain * plan.calls;
  int k = 0;
  while (k + 1 < plan.n_entries && g >= plan.e[k + 1].call0) ++k;
  const Entry& en = plan.e[k];
  const uint32_t j = (uint32_t)(g - en.call0);
  const unsigned long long s = (unsigned long long)step[0];
  const uint2 key = keys[chain];
  const uint4 w = philox4x32_10(
      make_uint4((uint32_t)s, (uint32_t)en.slot, j, (uint32_t)(s >> 32)),
      key.x, key.y);
  if (en.kind == kIndex) {
    long long* dst = iout + (size_t)chain * plan.ints + en.out + 2 * j;
    const unsigned long long x0 = ((unsigned long long)w.x << 32) | w.y;
    const unsigned long long x1 = ((unsigned long long)w.z << 32) | w.w;
    const long long i0 = en.lo + (long long)__umul64hi(x0, en.n);
    const long long i1 = en.lo + (long long)__umul64hi(x1, en.n);
    if (en.count - 2 * (int)j >= 2) {
      *reinterpret_cast<longlong2*>(dst) = make_longlong2(i0, i1);
    } else {
      dst[0] = i0;
    }
    return;
  }
  float* dst = fout + (size_t)chain * plan.floats + en.out + 4 * j;
  const int rem = en.count - 4 * (int)j;
  if (en.kind == kUniform) {
    store4(dst, rem, (float)(w.x >> 8) * 5.9604644775390625e-08f,
           (float)(w.y >> 8) * 5.9604644775390625e-08f,
           (float)(w.z >> 8) * 5.9604644775390625e-08f,
           (float)(w.w >> 8) * 5.9604644775390625e-08f);
  } else {
    float c0, s0, c1 = 0.0f, s1 = 0.0f;
    box_muller(w.x, w.y, c0, s0);
    if (rem > 2) box_muller(w.z, w.w, c1, s1);
    store4(dst, rem, c0, s0, c1, s1);
  }
}

}  // namespace

// table: n_entries rows of (slot, kind, count, n, lo, out column, first
// call) as int64, in host memory; keys (n_chains, 2) uint32 and step one
// int64 in device memory; fout (n_chains, floats) float32 and iout
// (n_chains, ints) int64, floats % 4 == 0 and ints % 2 == 0, both 16-byte
// aligned.
extern "C" int mcmc_chain_draws(const void* keys, const void* step,
                                const long long* table, int n_entries,
                                int n_chains, int calls, int floats,
                                int ints, void* fout, void* iout,
                                void* stream) {
  if (n_chains <= 0 || calls <= 0) return 0;
  if (n_entries <= 0 || n_entries > kMaxEntries || floats % 4 || ints % 2 ||
      (uintptr_t)fout % 16 || (uintptr_t)iout % 16)
    return (int)cudaErrorInvalidValue;
  Plan plan = {};
  for (int k = 0; k < n_entries; ++k) {
    const long long* row = table + 7 * k;
    plan.e[k].slot = (int)row[0];
    plan.e[k].kind = (int)row[1];
    plan.e[k].count = (int)row[2];
    plan.e[k].n = (uint32_t)row[3];
    plan.e[k].lo = row[4];
    plan.e[k].out = (int)row[5];
    plan.e[k].call0 = (int)row[6];
    if (plan.e[k].kind < kUniform || plan.e[k].kind > kNormal ||
        (k > 0 && plan.e[k].call0 < plan.e[k - 1].call0))
      return (int)cudaErrorInvalidValue;
  }
  plan.n_entries = n_entries;
  plan.calls = calls;
  plan.floats = floats;
  plan.ints = ints;
  const long long total = (long long)n_chains * calls;
  if (total > 0x7FFFFFFFLL - kThreads) return (int)cudaErrorInvalidValue;
  const int blocks = (int)((total + kThreads - 1) / kThreads);
  chain_draws_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint2*)keys, (const long long*)step, plan, (int)total,
      (float*)fout, (long long*)iout);
  return (int)cudaGetLastError();
}

extern "C" const char* mcmc_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
