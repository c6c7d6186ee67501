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
// What bounds it on an H100: at the SGS headline (512 chains, 1,604
// Philox calls a chain: three indices, 6,400 normals and a uniform) it
// writes 13.1 MB (3.9 us at 3.35 TB/s), and each call costs a Philox
// round function (20 IMAD.WIDE and 20 LOP3) and, for normals, two
// accurate log, sqrt and sincos pairs: instruction issue takes longer
// than the bytes; at the CRF headline (768 chains, six calls a chain) the
// launch itself.  Two grids, by the launch's calls (the first design, a
// flat grid of one thread a call, divided the thread index by the calls
// a chain and derived every call's round keys itself, and left a fourth
// wave ~4 % full at the SGS headline):
//   - past a wave of calls (kWave), tiles: the chain in blockIdx.x and
//     the chain's tiles of kThreads x kCalls calls along blockIdx.y
//     (strided by gridDim.y past 65,535 tiles), as noise_kernel.cu lays
//     out its grid: no division, one key load and one key schedule (ten
//     round keys, in uniform registers) a thread, shared by its kCalls
//     calls, kThreads apart; 32 registers, so 2,048 threads an SM;
//   - up to a wave (the CRF headline's 4,608 calls), one call a thread
//     over a flat grid of the chains' calls, chain-major: 18 CTAs where
//     tiles of a chain would take 768;
//   - a thread finds each call's entry by walking on from the previous
//     call's (the plan is ordered by first call), a branch uniform within
//     a warp except at entry boundaries; its Philox rounds run as
//     straight-line code, so a tile thread's multiplies interleave, and
//     only the conversions branch on the kind;
//   - each call stores its 4 floats or 2 int64 as one 16-byte store:
//     every entry's columns start at a multiple of 16 bytes and each
//     chain's row is a multiple of 16 bytes (the wrapper's layout), so
//     neighbouring threads write neighbouring 16-byte chunks; an entry's
//     last, partial call stores its values one by one.
// The 32-byte stack frame is sincosf's slow path (Payne-Hanek, for
// |t| > 105,615), which t = 2 pi u2 < 2 pi never takes: no local memory
// is touched (a build with __sincosf has none; ab_draw_kernel.py).
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

constexpr int kThreads = 128;  // threads a tile CTA
constexpr int kCalls = 2;      // Philox calls a tile thread
constexpr int kFlatThreads = 256;  // threads a flat CTA
// calls that one call a thread runs at once on an H100 (132 SMs x 2048
// resident threads): past it, tiles
constexpr long long kWave = 132 * 2048;
constexpr int kMaxEntries = 16;
constexpr int kMaxTiles = 65535;  // gridDim.y's limit
// the most calls a chain: a tile thread's first call plus the grid's
// stride (kMaxTiles tiles of kThreads x kCalls) stays below 2^31 (the
// wrapper's bound, under 2^31 floats and 2^31 ints a chain, keeps calls
// below 2^30 + 2^29)
constexpr int kMaxChainCalls = 0x7FFFFFFF - kMaxTiles * kThreads * kCalls;
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

struct Keys {
  uint32_t k0[kRounds], k1[kRounds];
};

__device__ __forceinline__ Keys key_schedule(uint2 key) {
  Keys k;
  k.k0[0] = key.x;
  k.k1[0] = key.y;
#pragma unroll
  for (int round = 1; round < kRounds; ++round) {
    k.k0[round] = k.k0[round - 1] + kW0;
    k.k1[round] = k.k1[round - 1] + kW1;
  }
  return k;
}

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

// call j of entry en with Philox words w: its values into the chain's
// rows (the conversions of the header)
__device__ __forceinline__ void convert_store(const Entry& en, uint32_t j,
                                              uint4 w, float* frow,
                                              long long* irow) {
  if (en.kind == kIndex) {
    long long* dst = irow + en.out + 2 * j;
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
  float* dst = frow + en.out + 4 * j;
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

// the entry of call g, walking on from entry e
__device__ __forceinline__ int entry_of(const Plan& plan, int g, int e) {
  while (e + 1 < plan.n_entries && g >= plan.e[e + 1].call0) ++e;
  return e;
}

// tiles of a chain's calls, kCalls a thread (launches past a wave)
__global__ void __launch_bounds__(kThreads)
tiled_kernel(const uint2* __restrict__ keys,
             const long long* __restrict__ step,
             const __grid_constant__ Plan plan, float* __restrict__ fout,
             long long* __restrict__ iout) {
  const int chain = blockIdx.x;
  const Keys k = key_schedule(keys[chain]);
  const unsigned long long s = (unsigned long long)step[0];
  const uint32_t step_lo = (uint32_t)s, step_hi = (uint32_t)(s >> 32);
  float* frow = fout + (size_t)chain * plan.floats;
  long long* irow = iout + (size_t)chain * plan.ints;
  int e = 0;  // the entry of the thread's latest call: calls only grow
  // calls <= kMaxChainCalls (the launcher's check): no int overflows
  for (int first = blockIdx.y * (kThreads * kCalls) + threadIdx.x;
       first < plan.calls; first += gridDim.y * (kThreads * kCalls)) {
    int ent[kCalls];
    uint4 w[kCalls];
#pragma unroll
    for (int c = 0; c < kCalls; ++c) {
      const int g = first + c * kThreads;
      e = entry_of(plan, g, e);
      ent[c] = e;
      w[c] = make_uint4(step_lo, (uint32_t)plan.e[e].slot,
                        (uint32_t)(g - plan.e[e].call0), step_hi);
    }
#pragma unroll
    for (int c = 0; c < kCalls; ++c) w[c] = philox4x32_10(w[c], k);
#pragma unroll
    for (int c = 0; c < kCalls; ++c) {
      const int g = first + c * kThreads;
      if (g >= plan.calls) break;
      const Entry& en = plan.e[ent[c]];
      convert_store(en, (uint32_t)(g - en.call0), w[c], frow, irow);
    }
  }
}

// one call a thread over the chains' calls, chain-major (launches up to
// a wave)
__global__ void __launch_bounds__(kFlatThreads)
flat_kernel(const uint2* __restrict__ keys,
            const long long* __restrict__ step,
            const __grid_constant__ Plan plan, int total,
            float* __restrict__ fout, long long* __restrict__ iout) {
  const int f = blockIdx.x * kFlatThreads + threadIdx.x;
  if (f >= total) return;
  const int chain = f / plan.calls;
  const int g = f - chain * plan.calls;
  const Entry& en = plan.e[entry_of(plan, g, 0)];
  const unsigned long long s = (unsigned long long)step[0];
  const uint4 w = philox4x32_10(
      make_uint4((uint32_t)s, (uint32_t)en.slot, (uint32_t)(g - en.call0),
                 (uint32_t)(s >> 32)),
      key_schedule(keys[chain]));
  convert_store(en, (uint32_t)(g - en.call0), w,
                fout + (size_t)chain * plan.floats,
                iout + (size_t)chain * plan.ints);
}

__global__ void empty_kernel() {}

bool tiled(long long total) { return total > kWave; }

// the grid and CTA width of a launch of n_chains x calls
void draw_launch(int n_chains, int calls, dim3* grid, int* threads) {
  const long long total = (long long)n_chains * calls;
  if (tiled(total)) {
    const int tiles = (calls + kThreads * kCalls - 1) / (kThreads * kCalls);
    *grid = dim3(n_chains, tiles < kMaxTiles ? tiles : kMaxTiles);
    *threads = kThreads;
  } else {
    *grid = dim3((unsigned)((total + kFlatThreads - 1) / kFlatThreads));
    *threads = kFlatThreads;
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
  if (n_entries <= 0 || n_entries > kMaxEntries || calls > kMaxChainCalls ||
      floats % 4 || ints % 2 ||
      (uintptr_t)fout % 16 || (uintptr_t)iout % 16)
    return (int)cudaErrorInvalidValue;
  Plan plan = {};
  for (int k = 0; k < n_entries; ++k) {
    const long long* row = table + 7 * k;
    if (row[2] > 0x7FFFFFFFLL || row[5] > 0x7FFFFFFFLL ||
        row[6] > 0x7FFFFFFFLL)
      return (int)cudaErrorInvalidValue;
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
  if (total > 0x7FFFFFFFLL - kFlatThreads) return (int)cudaErrorInvalidValue;
  dim3 grid;
  int threads;
  draw_launch(n_chains, calls, &grid, &threads);
  const cudaStream_t st = (cudaStream_t)stream;
  if (tiled(total)) {
    tiled_kernel<<<grid, threads, 0, st>>>((const uint2*)keys,
                                           (const long long*)step, plan,
                                           (float*)fout, (long long*)iout);
  } else {
    flat_kernel<<<grid, threads, 0, st>>>(
        (const uint2*)keys, (const long long*)step, plan, (int)total,
        (float*)fout, (long long*)iout);
  }
  return (int)cudaGetLastError();
}

// The launch for ``n_chains`` chains of ``calls`` Philox calls: out =
// threads a CTA, CTAs, Philox calls a thread, registers a thread, local
// memory bytes a thread, resident CTAs an SM (the CUDA occupancy API).
extern "C" int mcmc_chain_draws_info(int n_chains, int calls, int* out) {
  const bool tile = tiled((long long)n_chains * calls);
  const void* fn = tile ? (const void*)tiled_kernel
                        : (const void*)flat_kernel;
  dim3 grid;
  int threads;
  draw_launch(n_chains, calls, &grid, &threads);
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return (int)err;
  int resident = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, fn,
                                                      threads, 0);
  if (err != cudaSuccess) return (int)err;
  out[0] = threads;
  out[1] = (int)(grid.x * grid.y);
  out[2] = tile ? kCalls : 1;
  out[3] = attr.numRegs;
  out[4] = (int)attr.localSizeBytes;
  out[5] = resident;
  return 0;
}

// An empty kernel on the grid of a launch for ``n_chains`` chains of
// ``calls`` Philox calls: the floor that launch pays whatever it computes.
extern "C" int mcmc_chain_draws_empty(int n_chains, int calls,
                                      void* stream) {
  if (n_chains <= 0 || calls <= 0) return 0;
  dim3 grid;
  int threads;
  draw_launch(n_chains, calls, &grid, &threads);
  empty_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}

extern "C" const char* mcmc_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
