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
// reaches the last row n - 1 and no further.  A NaN is tested before any
// indexing: converting it to int is undefined on the card.  Built with
// -fmad=false, every operation is one float32 rounding, as in the plain
// version's separate PyTorch operations: the two agree bitwise.
//
// What bounds it on an H100: device-memory bytes, 8 B per element (x in, y
// out; N * SB^2 = 663,552 elements at 512 chains, SB = 36), plus one 8-byte
// table read per element that the 32 KB table serves from L1/L2.  Design:
// a grid-stride loop of 256-thread CTAs, one element per thread per turn,
// and the table row (T[i][0], T[i][1]) as one float2 load through the
// read-only cache.  The TPU version's R-row lane-shuffle gather and its
// (rows, 128) padding are dropped; the table is not staged in shared
// memory, since a CTA touches only a few of its rows.
//
// Build (plain C interface, loaded with ctypes):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false \
//        -shared -Xcompiler -fPIC -o liblut_kernel.so lut_kernel.cu

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
lut_kernel(const float* __restrict__ x, const float2* __restrict__ table,
           float* __restrict__ y, float lo, float scale, float hi,
           long long count) {
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long e = (long long)blockIdx.x * kThreads + threadIdx.x;
       e < count; e += stride) {
    const float v = x[e];
    if (isnan(v)) {
      y[e] = v;
      continue;
    }
    const float t = fminf(fmaxf((v - lo) * scale, 0.0f), hi);
    const int i = (int)t;  // t >= 0: truncation is floor
    const float f = t - (float)i;
    const float2 pair = __ldg(table + i);
    y[e] = pair.x * (1.0f - f) + pair.y * f;
  }
}

}  // namespace

extern "C" int mcmc_lut_interp(const void* x, const void* table, void* y,
                               float lo, float scale, float hi, int n,
                               long long count, void* stream) {
  if (count <= 0) return 0;
  if (n < 2 || !(hi < (float)n)) return (int)cudaErrorInvalidValue;
  long long blocks = (count + kThreads - 1) / kThreads;
  if (blocks > 132 * 16) blocks = 132 * 16;  // 16 CTAs per SM, then stride
  lut_kernel<<<(int)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const float2*)table, (float*)y, lo, scale, hi,
      count);
  return (int)cudaGetLastError();
}

extern "C" const char* mcmc_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
