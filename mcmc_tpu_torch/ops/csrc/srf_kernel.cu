// The gstools-SRF proposal's harmonic sum, batched over chains:
//
//   out[c, i, k] = sqrt(1/M) * (sum_j z1[c,j] cos(phi) + sum_j z2[c,j] sin(phi)),
//   phi = y_i * ky[c,j] + x_k * kx[c,j],  x_k = k * res, y_i = i * res,
//
// for kv (n, 2, M) [kx; ky], z1 and z2 (n, M), out (n, ny, nx), all
// float32.  It replaces the XLA ops of mcmc_tpu/ops/srf.py:114-123
// (srf_field: a (ny, nx, M) phase tensor, cos, sin and two tensordots);
// there is no Pallas kernel at that site, so this is the port's own
// kernel, like chain_draws.cu.  Its plain PyTorch version is
// mcmc_tpu_torch/ops/srf_kernel.py::srf_harmonics_reference.
//
// What bounds it on an H100: instruction issue.  The launch reads
// 16 * M bytes a chain and writes 4 * ny * nx (32 MB at the CRF headline,
// 768 chains x 80 x 80, M = 1000: ~0.01 ms at 3.35 TB/s), but it takes
// one accurate sincosf a term, n * ny * nx * M = 4.92e9 terms there, at
// some 25-40 instructions each.  The operations' own bound (4 float32
// operations a term, the separable product's count) is 0.29 ms; this
// direct form spends ~10x that on the range reductions and polynomials.
// A simple design:
//   - one CTA per (tile of kThreads * kCells cells, chain): the chain in
//     blockIdx.y, its tile in blockIdx.x;
//   - the chain's (kx, ky, z1, z2) staged once into dynamic shared memory
//     as one float4 a mode (16 * M bytes, 16 KB at M = 1000), read back
//     as a broadcast (every thread the same mode, no bank conflict);
//   - each thread keeps kCells cells' two sums in registers and walks the
//     modes in order j = 0 .. M-1: kCells independent sincosf chains for
//     the schedulers to interleave;
//   - the stores at the end are coalesced (cell q + r * kThreads).
//
// Rounding, to match the plain version:
//   - phi is two products and a sum, each rounded (__fmul_rn, __fadd_rn),
//     in the JAX order y*ky + x*kx: for large phases a one-ulp change of
//     phi is another cosine (the library is built with -fmad=false too);
//   - sincosf is CUDA's accurate form (not __sincosf, no fast math): at
//     the Matern headline |k| reaches ~2,690 / range and phases ~1.1e4
//     rad, the Exponential's Cauchy-like tail ~1e8 rad, where the
//     hardware approximations are far off.  sincosf returns the bits of
//     sinf and cosf, which PyTorch's CUDA sin and cos call;
//   - the sums are fmaf in mode order; the plain version sums in other
//     orders, so the two differ by float32 rounding of the sums.
//
// Build (plain C interface, loaded with ctypes):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false \
//        -shared -Xcompiler -fPIC -o libsrf_kernel.so srf_kernel.cu

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;  // threads a CTA
constexpr int kCells = 4;      // cells a thread

__global__ void __launch_bounds__(kThreads)
srf_kernel(const float* __restrict__ kv, const float* __restrict__ z1,
           const float* __restrict__ z2, float* __restrict__ out,
           int n_modes, int ny, int nx, float res, float norm) {
  extern __shared__ float4 modes[];  // (kx, ky, z1, z2) of each mode
  const int chain = blockIdx.y;
  const float* kx = kv + (size_t)chain * 2 * n_modes;
  const float* ky = kx + n_modes;
  const float* a = z1 + (size_t)chain * n_modes;
  const float* b = z2 + (size_t)chain * n_modes;
  for (int j = threadIdx.x; j < n_modes; j += kThreads)
    modes[j] = make_float4(kx[j], ky[j], a[j], b[j]);
  __syncthreads();

  const int cells = ny * nx;
  const int first = blockIdx.x * (kThreads * kCells) + threadIdx.x;
  float xs[kCells], ys[kCells], sc[kCells], ss[kCells];
#pragma unroll
  for (int r = 0; r < kCells; ++r) {
    int q = first + r * kThreads;
    q = q < cells ? q : 0;  // a cell past the grid is computed, not stored
    const int i = q / nx;
    xs[r] = __fmul_rn((float)(q - i * nx), res);
    ys[r] = __fmul_rn((float)i, res);
    sc[r] = 0.0f;
    ss[r] = 0.0f;
  }
  for (int j = 0; j < n_modes; ++j) {
    const float4 m = modes[j];
#pragma unroll
    for (int r = 0; r < kCells; ++r) {
      const float phi = __fadd_rn(__fmul_rn(ys[r], m.y),
                                  __fmul_rn(xs[r], m.x));
      float s, c;
      sincosf(phi, &s, &c);
      sc[r] = fmaf(m.z, c, sc[r]);
      ss[r] = fmaf(m.w, s, ss[r]);
    }
  }
  float* dst = out + (size_t)chain * cells;
#pragma unroll
  for (int r = 0; r < kCells; ++r) {
    const int q = first + r * kThreads;
    if (q < cells) dst[q] = __fmul_rn(__fadd_rn(sc[r], ss[r]), norm);
  }
}

}  // namespace

// (n_chains, ny, nx) float32 fields into out from kv (n_chains, 2, n_modes)
// and z1, z2 (n_chains, n_modes); norm = sqrt(1 / n_modes) in float32.
// The caller keeps n_chains <= 65535, ny * nx < 2^31 and 16 * n_modes
// within the 48 KB of dynamic shared memory a CTA gets without opting in.
extern "C" int mcmc_srf_harmonics(const void* kv, const void* z1,
                                  const void* z2, void* out, int n_chains,
                                  int n_modes, int ny, int nx, float res,
                                  float norm, void* stream) {
  if (n_chains <= 0 || ny <= 0 || nx <= 0) return 0;
  if (n_modes <= 0 || n_chains > 65535) return (int)cudaErrorInvalidValue;
  const int cells = ny * nx;
  const int per_cta = kThreads * kCells;
  const dim3 grid((cells + per_cta - 1) / per_cta, n_chains);
  srf_kernel<<<grid, kThreads, (size_t)n_modes * sizeof(float4),
               (cudaStream_t)stream>>>(
      (const float*)kv, (const float*)z1, (const float*)z2, (float*)out,
      n_modes, ny, nx, res, norm);
  return (int)cudaGetLastError();
}

// The kernel's registers and local (spill) bytes a thread and resident
// CTAs a multiprocessor at n_modes modes: out[0], out[1], out[2].
extern "C" int mcmc_srf_kernel_info(int n_modes, int* out) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, srf_kernel);
  if (err != cudaSuccess) return (int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, srf_kernel, kThreads, (size_t)n_modes * sizeof(float4));
  if (err != cudaSuccess) return (int)err;
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  out[2] = blocks;
  return 0;
}

extern "C" const char* mcmc_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
