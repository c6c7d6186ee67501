// SGS window extract and window writeback: the per-chain (SB, SB) windows
// of one SGS step, read out of and written back into the chain state.
//
// Replace mcmc_tpu/ops/sgs_window_kernel.py::make_window_extract and
// ::make_window_writeback (the Pallas TPU kernels).  Same function and
// contract as the plain PyTorch versions beside them,
// mcmc_tpu_torch/ops/sgs_window_kernel.py::window_extract_reference and
// ::window_writeback_reference:
//   extract:   out[i, k]      = cons[k, sx+r, sy+c]          for k <  NP
//              out[i, NP + k] = fields[i, k, sx+r, sy+c]     for k <  NS
//   writeback: fields[i, k, sx+r, sy+c] = new_w[i, k, r, c]  if write[i]
// for r, c < SB.  Pure copies, so both agree with the plain versions
// bitwise.  The starts arrive clamped into [0, H-SB] x [0, W-SB] by the
// caller (models/chain_sgs.py::window_start, floor division done there).
//
// What bounds it on an H100: device-memory bytes and latency.  Extract
// reads and writes (NP + NS) * SB^2 * 4 B per chain (73 KB at NP = 10,
// NS = 4, SB = 36), writeback at most NS * SB^2 * 4 B per chain; no
// arithmetic.  Design: one CTA of 256 threads per chain, threads striding
// over the flat (plane, row, col) output index so that a warp touches
// contiguous columns of a row.  The TPU version's (8, 128)-aligned slabs,
// dynamic rolls and VMEM-resident const planes are dropped: a CTA reads
// the global planes at any start directly.  A rejected chain's CTA
// returns before touching memory.
//
// Build (plain C interface, loaded with ctypes):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false \
//        -shared -Xcompiler -fPIC -o libsgs_window_kernel.so \
//        sgs_window_kernel.cu

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
window_extract_kernel(const float* __restrict__ cons,
                      const float* __restrict__ fields,
                      const int* __restrict__ sx_arr,
                      const int* __restrict__ sy_arr,
                      float* __restrict__ out, int NP, int NS, int H, int W,
                      int SB) {
  const int n = blockIdx.x;
  const int sx = sx_arr[n];
  const int sy = sy_arr[n];
  const size_t hw = (size_t)H * W;
  const int win = SB * SB;
  const int total = (NP + NS) * win;
  const float* state = fields + (size_t)n * NS * hw;
  float* o = out + (size_t)n * total;
  for (int e = threadIdx.x; e < total; e += kThreads) {
    const int k = e / win;
    const int rc = e - k * win;
    const int r = rc / SB;
    const int c = rc - r * SB;
    const size_t at = (size_t)(sx + r) * W + (sy + c);
    o[e] = k < NP ? cons[k * hw + at] : state[(k - NP) * hw + at];
  }
}

__global__ void __launch_bounds__(kThreads)
window_writeback_kernel(float* __restrict__ fields,
                        const float* __restrict__ new_w,
                        const int* __restrict__ sx_arr,
                        const int* __restrict__ sy_arr,
                        const bool* __restrict__ write, int NS, int H, int W,
                        int SB) {
  const int n = blockIdx.x;
  if (!write[n]) return;
  const int sx = sx_arr[n];
  const int sy = sy_arr[n];
  const size_t hw = (size_t)H * W;
  const int win = SB * SB;
  const int total = NS * win;
  float* state = fields + (size_t)n * NS * hw;
  const float* src = new_w + (size_t)n * total;
  for (int e = threadIdx.x; e < total; e += kThreads) {
    const int k = e / win;
    const int rc = e - k * win;
    const int r = rc / SB;
    const int c = rc - r * SB;
    state[k * hw + (size_t)(sx + r) * W + (sy + c)] = src[e];
  }
}

}  // namespace

extern "C" int mcmc_window_extract(const void* cons, const void* fields,
                                   const void* sx, const void* sy, void* out,
                                   int n_chains, int NP, int NS, int H, int W,
                                   int SB, void* stream) {
  if (n_chains <= 0) return 0;
  window_extract_kernel<<<n_chains, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)cons, (const float*)fields, (const int*)sx,
      (const int*)sy, (float*)out, NP, NS, H, W, SB);
  return (int)cudaGetLastError();
}

extern "C" int mcmc_window_writeback(void* fields, const void* new_w,
                                     const void* sx, const void* sy,
                                     const void* write, int n_chains, int NS,
                                     int H, int W, int SB, void* stream) {
  if (n_chains <= 0) return 0;
  window_writeback_kernel<<<n_chains, kThreads, 0, (cudaStream_t)stream>>>(
      (float*)fields, (const float*)new_w, (const int*)sx, (const int*)sy,
      (const bool*)write, NS, H, W, SB);
  return (int)cudaGetLastError();
}

extern "C" const char* mcmc_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
