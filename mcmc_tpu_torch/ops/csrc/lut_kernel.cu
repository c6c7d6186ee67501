// Uniform-grid LUT interpolation: the SGS chain's inverse normal-score
// transform over all chains' windows in one elementwise pass.
//
// Replaces mcmc_tpu/ops/lut_kernel.py::lut_interp (the Pallas TPU kernel,
// _lookup_positions).  Same function and contract as the plain PyTorch
// version beside it, mcmc_tpu_torch/ops/lut_kernel.py::
// lut_interp_reference (ops/transforms.py::lut_lookup):
//   t = clip((x - lo) * scale, 0, hi),  i = (int)t,  f = t - i,
//   y = T[i][0] * (1 - f) + T[i][1] * f,   NaN in -> the same NaN out,
// with hi the float32 rounding of n - 1.000001 (4095.0 for n = 4096), so i
// reaches the last row n - 1 and no further.  No NaN is ever converted to
// an int (undefined on the card): fmaxf(NaN, 0) is 0, so a NaN indexes row
// 0 and its result is then replaced by the NaN itself.  Built with
// -fmad=false, every operation is one float32 rounding, as in the plain
// version's separate PyTorch operations: the two agree bitwise.
//
// What bounds it on an H100: device-memory bytes, 8 B per element (x in, y
// out; N * SB^2 = 663,552 elements at 512 chains, SB = 36: 5.3 MB, 1.6 us
// at 3.35 TB/s), plus one 8-byte table row per element that the 32 KB
// table serves from L1/L2.  At one element a thread the launch needed
// three rounds of CTAs, each paying a DRAM trip for x and then an L1/L2
// trip for the row before its store.  Design:
//   - a group of 4 consecutive elements a thread, at 16-byte boundaries
//     of x: one 16-byte load of x and, where y has x's alignment modulo
//     16 bytes (always for the dispatcher's fresh output and an aligned
//     x), one 16-byte store of y.  A group cut by either end of the array
//     loads and stores its elements one by one in the same launch, and a
//     y aligned otherwise than x takes scalar stores (a uniform flag);
//   - one group a thread and no grid-stride loop: 165,888 threads, 648
//     CTAs of 256 at the headline, within the card's one wave of 1,056;
//   - each thread issues its four table-row loads (float2, through the
//     read-only cache) before its first lerp, so it waits for one DRAM
//     trip and one L1/L2 trip in all.
// The table is not staged in shared memory: 648 CTAs each copying 32 KB
// would read ~21 MB from L2 against 5.3 MB of real traffic.
// What bounds it in practice, measured on an H100 SXM at 700 W
// (ab_lut_kernel.py): the launch.  An empty kernel on the same 648 CTAs
// takes ~2.5 us back to back and this kernel ~5.1 us, about the same as
// the one-element-a-thread design it replaced (whose empty grid takes
// ~3.3 us).
// Removing the launch (fusing the lookup into its neighbour) is what
// would move it.
//
// Build (plain C interface, loaded with ctypes):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false \
//        -shared -Xcompiler -fPIC -o liblut_kernel.so lut_kernel.cu

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kGroup = 4;  // elements a thread: one float4 of x and of y

__device__ __forceinline__ void load_vec(const float* p, float* v) {
  const float4 q = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = q.x;
  v[1] = q.y;
  v[2] = q.z;
  v[3] = q.w;
}

__device__ __forceinline__ void store_vec(float* p, const float* r) {
  *reinterpret_cast<float4*>(p) = make_float4(r[0], r[1], r[2], r[3]);
}

__global__ void __launch_bounds__(kThreads)
lut_kernel(const float* __restrict__ x, const float2* __restrict__ table,
           float* __restrict__ y, float lo, float scale, float hi,
           long long count, int skew, bool vector_store,
           long long groups) {
  const long long g = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (g >= groups) return;
  // the group's first element; x + e0 is aligned to a vector access
  const long long e0 = g * kGroup - skew;
  const bool whole = e0 >= 0 && e0 + kGroup <= count;
  float v[kGroup];
  if (whole) {
    load_vec(x + e0, v);
  } else {
#pragma unroll
    for (int k = 0; k < kGroup; ++k) {
      const long long e = e0 + k;
      v[k] = (e >= 0 && e < count) ? x[e] : 0.0f;
    }
  }
  int i[kGroup];
  float f[kGroup];
#pragma unroll
  for (int k = 0; k < kGroup; ++k) {
    const float t = fminf(fmaxf((v[k] - lo) * scale, 0.0f), hi);
    i[k] = (int)t;  // t in [0, hi]: truncation is floor
    f[k] = t - (float)i[k];
  }
  float2 pair[kGroup];
#pragma unroll
  for (int k = 0; k < kGroup; ++k) pair[k] = __ldg(table + i[k]);
  float r[kGroup];
#pragma unroll
  for (int k = 0; k < kGroup; ++k)
    r[k] = isnan(v[k]) ? v[k]
                       : pair[k].x * (1.0f - f[k]) + pair[k].y * f[k];
  if (whole && vector_store) {
    store_vec(y + e0, r);
  } else {
#pragma unroll
    for (int k = 0; k < kGroup; ++k) {
      const long long e = e0 + k;
      if (e >= 0 && e < count) y[e] = r[k];
    }
  }
}

__global__ void empty_kernel() {}

constexpr uintptr_t kVecBytes = kGroup * sizeof(float);

long long lut_groups(const void* x, long long count, int* skew) {
  *skew = (int)(((uintptr_t)x % kVecBytes) / sizeof(float));
  return (count + *skew + kGroup - 1) / kGroup;
}

}  // namespace

extern "C" int mcmc_lut_interp(const void* x, const void* table, void* y,
                               float lo, float scale, float hi, int n,
                               long long count, void* stream) {
  if (count <= 0) return 0;
  if (n < 2 || !(hi < (float)n)) return (int)cudaErrorInvalidValue;
  if ((uintptr_t)x % sizeof(float) || (uintptr_t)y % sizeof(float))
    return (int)cudaErrorMisalignedAddress;
  int skew = 0;
  const long long groups = lut_groups(x, count, &skew);
  const long long blocks = (groups + kThreads - 1) / kThreads;
  if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  const bool vector_store =
      (uintptr_t)x % kVecBytes == (uintptr_t)y % kVecBytes;
  lut_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const float2*)table, (float*)y, lo, scale, hi,
      count, skew, vector_store, groups);
  return (int)cudaGetLastError();
}

// The launch for ``count`` elements of x at address ``x``: out = [CTAs,
// threads a CTA, registers a thread, local (spill) bytes a thread,
// resident CTAs a multiprocessor].
extern "C" int mcmc_lut_info(const void* x, long long count, int* out) {
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, (const void*)lut_kernel);
  if (e != cudaSuccess) return (int)e;
  int resident = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &resident, (const void*)lut_kernel, kThreads, 0);
  if (e != cudaSuccess) return (int)e;
  int skew = 0;
  out[0] = (int)((lut_groups(x, count, &skew) + kThreads - 1) / kThreads);
  out[1] = kThreads;
  out[2] = attr.numRegs;
  out[3] = (int)attr.localSizeBytes;
  out[4] = resident;
  return 0;
}

// An empty kernel on ``blocks`` CTAs of the LUT's width: the floor a
// launch of that grid pays whatever it computes.
extern "C" int mcmc_empty_launch(int blocks, void* stream) {
  if (blocks <= 0) return 0;
  empty_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}

extern "C" const char* mcmc_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
