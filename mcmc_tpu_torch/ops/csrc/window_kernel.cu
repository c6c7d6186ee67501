// Fused CRF window update: one Metropolis-Hastings step's window phase for
// every chain of a batch, in one launch.
//
// Replaces mcmc_tpu/ops/window_kernel.py::make_fused_window_update (the
// Pallas TPU kernel).  Same function and contract as the plain PyTorch
// version beside it, mcmc_tpu_torch/ops/window_kernel.py::
// fused_window_update_reference:
//   A. finish the proposal: standardize the raw spectral field over the
//      (h, w) block (two-pass f32 mean and population variance, +1e-12 on
//      the std), times the sampled scale and the size's edge mask (skipped
//      when the caller passes a finished field, `prefinished`);
//   B. perturb the bed over block x update region by f * crf_weight, and
//      sum over the block the NaN-safe squared mass-conservation residual
//      (new and old, over block x mc mask), the data-misfit pair (planes
//      6-7) and the thickness-violation flag;
//   C. take the MH decision with the reference's f32 expression:
//      loss_next = loss_prev + delta + delta_data (inf on violation),
//      accept = u <= min(1, exp(loss_prev - loss_next));
//   D. on accept only, write the residual and resample count over the
//      block, then the new bed.  The one-cell ring outside the block keeps
//      its stale residual, as in the reference's incremental scheme.
//
// The residual at an in-block cell uses the GLOBAL numpy-gradient stencil
// (central inside the domain, one-sided at true domain edges) with the
// neighbours' perturbed bed recomputed on the fly.  By the window
// invariant of models/chain_crf.py this equals the windowed residual.
//
// What bounds it on an H100: device-memory bytes.  Per chain it reads about
// 9 planes x (h+2)(w+2) x 4 B and writes at most 3 x h*w x 4 B; the
// arithmetic is a few dozen flops per cell.  Design: one CTA of 256 threads
// per chain.  The finished (B, B) proposal is staged in shared memory; the
// planes are read straight from global memory, row-contiguous across a
// warp.  Every reduction stays inside the CTA, so no atomics are needed and
// results are identical run to run.  `fields` is updated in place (the
// Pallas kernel aliases it input to output the same way); a rejected chain
// is not written at all.
//
// Hazard in phase D: the residual recomputation reads the neighbours' OLD
// bed, so every residual is written before a barrier and only then the
// beds.  Geometry arrives precomputed by the wrapper with floor semantics:
// C++ integer division truncates toward zero, so none of it is done here.
//
// Build (plain C interface, loaded with ctypes):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false \
//        -shared -Xcompiler -fPIC -o libwindow_kernel.so window_kernel.cu
// -fmad=false keeps a*b+c as two rounded operations, as PyTorch's eager
// kernels compute it, so the kernel tracks the plain version closely.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// geom row: bxmin, bxmax, bymin, bymax, off_x, off_y, h, w, size_idx
constexpr int kGeom = 9;
// fvals row: u, loss_prev, sigma_mc, resolution, sigma_data, scale
constexpr int kFvals = 6;

__device__ __forceinline__ float nansq(float x) {
  const float s = x * x;
  return isnan(s) ? 0.0f : s;
}

// Sum of K per-thread values over the CTA; every thread gets the totals.
template <int K>
__device__ __forceinline__ void cta_sum(float (&v)[K],
                                        float (*scratch)[K]) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v[k] += __shfl_down_sync(0xffffffffu, v[k], off);
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) scratch[warp][k] = v[k];
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < K; ++k) {
    float s = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += scratch[w][k];
    v[k] = s;
  }
  __syncthreads();  // scratch may be reused right after
}

struct Chain {
  const float *surf, *velx, *vely, *forcing, *mp, *crfw, *cond, *dmask;
  float *bed, *res, *rsm;
  const float* f;  // finished proposal, (B, B) in shared memory
  int H, W, B, bxmin, bxmax, bymin, bymax, off_x, off_y;
  float resolution;

  __device__ __forceinline__ bool in_block(int r, int c) const {
    return r >= bxmin && r < bxmax && c >= bymin && c < bymax;
  }
  __device__ __forceinline__ float upd(int i) const {
    const float m = mp[i];
    return m - 2.0f * floorf(m * 0.5f);  // maskpack mod 2
  }
  // bed + pert, pert = f * crf_weight on block x update region, else 0
  __device__ __forceinline__ float bed_new(int r, int c) const {
    const int i = r * W + c;
    float pert = 0.0f;
    if (in_block(r, c) && upd(i) > 0.0f)
      pert = f[(r - off_x) * B + (c - off_y)] * crfw[i];
    return bed[i] + pert;
  }
  __device__ __forceinline__ float flux_x(int r, int c) const {
    return velx[r * W + c] * (surf[r * W + c] - bed_new(r, c));
  }
  __device__ __forceinline__ float flux_y(int r, int c) const {
    return vely[r * W + c] * (surf[r * W + c] - bed_new(r, c));
  }
  // numpy-gradient mass-conservation residual at (r, c) of the new bed
  __device__ float residual(int r, int c) const {
    const float two_r = 2.0f * resolution;
    float dx, dy;
    if (c == 0)
      dx = (flux_x(r, 1) - flux_x(r, 0)) / resolution;
    else if (c == W - 1)
      dx = (flux_x(r, W - 1) - flux_x(r, W - 2)) / resolution;
    else
      dx = (flux_x(r, c + 1) - flux_x(r, c - 1)) / two_r;
    if (r == 0)
      dy = (flux_y(1, c) - flux_y(0, c)) / resolution;
    else if (r == H - 1)
      dy = (flux_y(H - 1, c) - flux_y(H - 2, c)) / resolution;
    else
      dy = (flux_y(r + 1, c) - flux_y(r - 1, c)) / two_r;
    return dx + dy + forcing[r * W + c];
  }
};

__global__ void __launch_bounds__(kThreads)
fused_window_kernel(const float* __restrict__ consts,
                    float* __restrict__ fields,
                    const float* __restrict__ fraw,
                    const float* __restrict__ edge,
                    const int* __restrict__ geom,
                    const float* __restrict__ fvals,
                    float* __restrict__ acc_out,
                    float* __restrict__ delta_out,
                    float* __restrict__ ddata_out,
                    int H, int W, int B, int use_data_loss, int prefinished) {
  extern __shared__ float f_s[];  // (B, B)
  __shared__ float scratch[kWarps][5];
  __shared__ float scratch1[kWarps][1];
  __shared__ int ok_s;

  const int n = blockIdx.x;
  const int tid = threadIdx.x;
  const int* g = geom + (size_t)n * kGeom;
  const float* fv = fvals + (size_t)n * kFvals;
  const size_t hw = (size_t)H * W;

  Chain ch;
  ch.surf = consts;
  ch.velx = consts + hw;
  ch.vely = consts + 2 * hw;
  ch.forcing = consts + 3 * hw;
  ch.mp = consts + 4 * hw;
  ch.crfw = consts + 5 * hw;
  ch.cond = consts + 6 * hw;
  ch.dmask = consts + 7 * hw;
  ch.bed = fields + (size_t)n * 3 * hw;
  ch.res = ch.bed + hw;
  ch.rsm = ch.bed + 2 * hw;
  ch.f = f_s;
  ch.H = H;
  ch.W = W;
  ch.B = B;
  ch.bxmin = g[0];
  ch.bxmax = g[1];
  ch.bymin = g[2];
  ch.bymax = g[3];
  ch.off_x = g[4];
  ch.off_y = g[5];
  const int bh = g[6];
  const int bw = g[7];
  const int size_idx = g[8];
  const float u = fv[0];
  const float loss_prev = fv[1];
  const float sigma = fv[2];
  ch.resolution = fv[3];
  const float sigma_data = fv[4];
  const float scale = fv[5];

  // ---- phase A: the finished proposal in shared memory -----------------
  const float* raw = fraw + (size_t)n * B * B;
  for (int i = tid; i < B * B; i += kThreads) f_s[i] = raw[i];
  __syncthreads();
  if (!prefinished) {
    const float nblk = fmaxf((float)(bh * bw), 1.0f);
    float s[1] = {0.0f};
    for (int i = tid; i < B * B; i += kThreads)
      if (i / B < bh && i % B < bw) s[0] += f_s[i];
    cta_sum<1>(s, scratch1);
    const float mean = s[0] / nblk;
    float q[1] = {0.0f};
    for (int i = tid; i < B * B; i += kThreads)
      if (i / B < bh && i % B < bw) {
        const float d = f_s[i] - mean;
        q[0] += d * d;
      }
    cta_sum<1>(q, scratch1);
    const float denom = sqrtf(q[0] / nblk) + 1e-12f;
    const float* em = edge + (size_t)size_idx * B * B;
    for (int i = tid; i < B * B; i += kThreads) {
      const bool inb = i / B < bh && i % B < bw;
      f_s[i] = inb ? ((f_s[i] - mean) / denom) * scale * em[i] : 0.0f;
    }
    __syncthreads();
  }

  // ---- phase B: loss sums and the thickness guard over the block -------
  const int rows = max(ch.bxmax - ch.bxmin, 0);
  const int cols = max(ch.bymax - ch.bymin, 0);
  const int ncell = rows * cols;
  float v[5] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};  // s_new s_old d_new d_old viol
  for (int k = tid; k < ncell; k += kThreads) {
    const int r = ch.bxmin + k / cols;
    const int c = ch.bymin + k % cols;
    const int i = r * W + c;
    const float bn = ch.bed_new(r, c);
    if (ch.upd(i) > 0.0f && (ch.surf[i] - bn) <= 0.0f) v[4] = 1.0f;
    if (ch.mp[i] >= 2.0f) {
      v[0] += nansq(ch.residual(r, c));
      v[1] += nansq(ch.res[i]);
    }
    if (use_data_loss && ch.dmask[i] > 0.0f) {
      v[2] += nansq(bn - ch.cond[i]);
      v[3] += nansq(ch.bed[i] - ch.cond[i]);
    }
  }
  cta_sum<5>(v, scratch);

  // ---- phase C: the MH decision ----------------------------------------
  if (tid == 0) {
    const float delta = (v[0] - v[1]) / (2.0f * sigma * sigma);
    const float delta_data =
        use_data_loss ? (v[2] - v[3]) / (2.0f * sigma_data * sigma_data)
                      : 0.0f;
    const bool viol = v[4] > 0.0f;
    float loss_next = loss_prev + delta + delta_data;
    if (viol) loss_next = INFINITY;
    const float e = expf(loss_prev - loss_next);
    const float rate = isnan(e) ? e : fminf(1.0f, e);  // NaN propagates
    const bool ok = (u <= rate) && !viol;
    acc_out[n] = ok ? 1.0f : 0.0f;
    delta_out[n] = ok ? delta : 0.0f;
    ddata_out[n] = ok ? delta_data : 0.0f;
    ok_s = ok;
  }
  __syncthreads();
  if (!ok_s) return;

  // ---- phase D: in-place writeback, residuals before beds --------------
  for (int k = tid; k < ncell; k += kThreads) {
    const int r = ch.bxmin + k / cols;
    const int c = ch.bymin + k % cols;
    const int i = r * W + c;
    ch.res[i] = ch.residual(r, c);
    ch.rsm[i] = ch.rsm[i] + ch.upd(i);
  }
  __syncthreads();
  for (int k = tid; k < ncell; k += kThreads) {
    const int r = ch.bxmin + k / cols;
    const int c = ch.bymin + k % cols;
    ch.bed[r * W + c] = ch.bed_new(r, c);  // reads only its own cell
  }
}

}  // namespace

extern "C" int mcmc_fused_window_update(
    const void* consts, void* fields, const void* fraw, const void* edge,
    const void* geom, const void* fvals, void* acc, void* delta,
    void* ddata, int n_chains, int H, int W, int B, int use_data_loss,
    int prefinished, void* stream) {
  if (n_chains <= 0) return 0;
  const size_t smem = (size_t)B * B * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fused_window_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  fused_window_kernel<<<n_chains, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)consts, (float*)fields, (const float*)fraw,
      (const float*)edge, (const int*)geom, (const float*)fvals, (float*)acc,
      (float*)delta, (float*)ddata, H, W, B, use_data_loss, prefinished);
  return (int)cudaGetLastError();
}

extern "C" const char* mcmc_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
