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
// (central inside the domain, one-sided at true domain edges).  By the
// window invariant of models/chain_crf.py this equals the windowed
// residual.
//
// What bounds it on an H100: bytes, most of them served by L2.  Per chain
// it reads about 9 planes x (h+2)(w+2) x 4 B and writes at most
// 3 x h*w x 4 B; the six const planes (6.3 MB at 512^2) are shared by all
// chains and stay in the 50 MB L2, so device memory sees mostly the
// chains' own bed and residual windows and proposals.  The arithmetic is a
// few dozen flops per cell.  Design: one CTA of 256 threads per chain,
// small enough that six CTAs share an SM and 768 chains run in one wave:
//   - the thickness surf - bed_new of every window cell (the block and its
//     one-cell ring, clipped to the domain) is computed once and staged in
//     a (B + 3, B + 2) shared tile (27.2 KB at B = 80; row 0 is spare),
//     sized by the wrapper (ops/window_kernel.py::window_launch_config),
//     which passes its threads and dynamic shared bytes to the launch;
//     the stencil reads the tile and velx / vely, never a recomputed bed;
//   - each block cell's new residual is stored into the tile, in place of
//     the thickness of the cell above it, once every cell that reads that
//     thickness has its residual: all of them come no later in the flat
//     block order, so one barrier a pass of 256 cells orders it;
//   - phase D writes the staged residuals; only bed_new, a multiply and
//     an add from the proposal, is recomputed rather than kept;
//   - every cell loop walks its rectangle in flat order, thread t taking
//     cells t, t + 256, ...; a thread steps its (row, col) by
//     (256 / cols, 256 % cols), so no loop divides.  A warp covers
//     contiguous row segments, so its loads coalesce;
//   - with every chain resident at once, the launch lasts as long as the
//     slowest CTA's chain of memory round trips, so each thread loads two
//     block cells (four canvas cells in phase A) before it computes on
//     them, and phase D reads its cells before it writes them;
//   - every sum is taken in that order (a thread's cells in rising flat
//     index, then a fixed CTA tree) and every value with the same float
//     operations, so the staging changes no bit: the sums, the decision
//     and the fields are those of the unstaged, one-cell-at-a-time
//     computation of the same order.
// Every reduction stays inside the CTA, so no atomics are needed and
// results are identical run to run.  `fields` is updated in place (the
// Pallas kernel aliases it input to output the same way); a rejected chain
// is not written at all.  Every residual reads the old bed (through the
// tile) before phase D writes any bed.  Geometry arrives precomputed by
// the wrapper with floor semantics: C++ integer division truncates toward
// zero, so none of it is done here.
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
constexpr int kMinBlocks = 6;  // CTAs an SM must hold: 768 chains, 132 SMs
constexpr int kCanvas = 4;     // canvas cells a thread loads at once
constexpr int kCells = 2;      // block cells a thread loads at once

// geom row: bxmin, bxmax, bymin, bymax, off_x, off_y, h, w, size_idx
constexpr int kGeom = 9;
// fvals row: u, loss_prev, sigma_mc, resolution, sigma_data, scale
constexpr int kFvals = 6;

__device__ __forceinline__ float nansq(float x) {
  const float s = x * x;
  return isnan(s) ? 0.0f : s;
}

__device__ __forceinline__ float upd(float m) {
  return m - 2.0f * floorf(m * 0.5f);  // maskpack mod 2
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

// One thread's walk over a rectangle `cols` wide in flat order: cells
// k = threadIdx.x, + kThreads, ...; (a, b) is cell k's (row, col).  Only
// the start divides.
struct Walk {
  int a, b, da, db, cols;
  __device__ __forceinline__ explicit Walk(int cols_) : cols(cols_) {
    a = threadIdx.x / cols;
    b = threadIdx.x - a * cols;
    da = kThreads / cols;
    db = kThreads - da * cols;
  }
  __device__ __forceinline__ void next() {
    a += da;
    b += db;
    if (b >= cols) {
      b -= cols;
      ++a;
    }
  }
};

__global__ void __launch_bounds__(kThreads, kMinBlocks)
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
  // tile[(wr + 1) * S + wc]: window cell (wr, wc) = global (r0 + wr,
  // c0 + wc); first its thickness, then, for a block cell's upper
  // neighbour, the block cell's new residual
  extern __shared__ float tile[];
  __shared__ float scratch[kWarps][5];
  __shared__ float scratch1[kWarps][1];
  __shared__ int ok_s;

  const int n = blockIdx.x;
  const int tid = threadIdx.x;
  const int* g = geom + (size_t)n * kGeom;
  const float* fv = fvals + (size_t)n * kFvals;
  const size_t hw = (size_t)H * W;
  const float* surf = consts;
  const float* velx = consts + hw;
  const float* vely = consts + 2 * hw;
  const float* forcing = consts + 3 * hw;
  const float* mp = consts + 4 * hw;
  const float* crfw = consts + 5 * hw;
  const float* cond = consts + 6 * hw;
  const float* dmask = consts + 7 * hw;
  float* bed = fields + (size_t)n * 3 * hw;
  float* res = bed + hw;
  float* rsm = bed + 2 * hw;
  const int bxmin = g[0], bxmax = g[1], bymin = g[2], bymax = g[3];
  const int off_x = g[4], off_y = g[5], bh = g[6], bw = g[7];
  const float* raw = fraw + (size_t)n * B * B;
  const float* em = edge + (size_t)g[8] * B * B;
  const float u = fv[0];
  const float loss_prev = fv[1];
  const float sigma = fv[2];
  const float resolution = fv[3];
  const float sigma_data = fv[4];
  const float scale = fv[5];

  // ---- phase A: the proposal's mean and std over its (h, w) block -------
  // kCanvas canvas cells a thread per pass, all loaded before they are
  // summed in order; a cell outside the block adds an exact 0 (a sum
  // that starts at +0 is never -0)
  float mean = 0.0f, denom = 1.0f;
  if (!prefinished) {
    const int nc = B * B;
    const float nblk = fmaxf((float)(bh * bw), 1.0f);
    float s[1] = {0.0f};
    Walk ws(B);
    for (int i0 = 0; i0 < nc; i0 += kCanvas * kThreads) {
      float x[kCanvas];
#pragma unroll
      for (int j = 0; j < kCanvas; ++j, ws.next()) {
        const int i = i0 + j * kThreads + tid;
        x[j] = (i < nc && ws.a < bh && ws.b < bw) ? raw[i] : 0.0f;
      }
#pragma unroll
      for (int j = 0; j < kCanvas; ++j) s[0] += x[j];
    }
    cta_sum<1>(s, scratch1);
    mean = s[0] / nblk;
    float q[1] = {0.0f};
    Walk wq(B);
    for (int i0 = 0; i0 < nc; i0 += kCanvas * kThreads) {
      float x[kCanvas];
      bool in[kCanvas];
#pragma unroll
      for (int j = 0; j < kCanvas; ++j, wq.next()) {
        const int i = i0 + j * kThreads + tid;
        in[j] = i < nc && wq.a < bh && wq.b < bw;
        x[j] = in[j] ? raw[i] : 0.0f;
      }
#pragma unroll
      for (int j = 0; j < kCanvas; ++j) {
        const float d = x[j] - mean;
        q[0] += in[j] ? d * d : 0.0f;
      }
    }
    cta_sum<1>(q, scratch1);
    denom = sqrtf(q[0] / nblk) + 1e-12f;
  }
  // the finished proposal at a block cell (r, c), and its perturbation
  auto pert = [&](int r, int c, int i, float m) -> float {
    if (!(upd(m) > 0.0f)) return 0.0f;
    const int p = (r - off_x) * B + (c - off_y);
    const float f =
        prefinished ? raw[p] : ((raw[p] - mean) / denom) * scale * em[p];
    return f * crfw[i];
  };

  // ---- phase B: stage the window's thickness; the sums over the block --
  const int rows = max(bxmax - bxmin, 0);
  const int cols = max(bymax - bymin, 0);
  const int ncell = rows * cols;
  const int r0 = max(bxmin - 1, 0), r1 = min(bxmax + 1, H);
  const int c0 = max(bymin - 1, 0), c1 = min(bymax + 1, W);
  const int S = B + 2;
  // block cell (a, b): thickness at tile row a + e + 1, column b + f; its
  // residual goes one row up, into the upper neighbour's slot
  const int e = bxmin - r0, f = bymin - c0;
  float v[5] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};  // s_new s_old d_new d_old viol
  if (ncell > 0) {
    // kCells block cells a thread per pass, in order; each pass loads
    // their planes before it computes, so the loads overlap
    Walk wk(cols);
    for (int k0 = 0; k0 < ncell; k0 += kCells * kThreads) {
      int a[kCells], b[kCells];
      bool live[kCells];
      float m[kCells], b0[kCells], sf[kCells];
#pragma unroll
      for (int j = 0; j < kCells; ++j, wk.next()) {
        a[j] = wk.a;
        b[j] = wk.b;
        live[j] = k0 + j * kThreads + tid < ncell;
        if (live[j]) {
          const int i = (bxmin + a[j]) * W + bymin + b[j];
          m[j] = mp[i];
          b0[j] = bed[i];
          sf[j] = surf[i];
        }
      }
#pragma unroll
      for (int j = 0; j < kCells; ++j) {
        if (!live[j]) continue;
        const int r = bxmin + a[j], c = bymin + b[j];
        const int i = r * W + c;
        const float bn = b0[j] + pert(r, c, i, m[j]);
        const float th = sf[j] - bn;
        tile[(a[j] + e + 1) * S + b[j] + f] = th;
        if (upd(m[j]) > 0.0f && th <= 0.0f) v[4] = 1.0f;
        if (m[j] >= 2.0f) v[1] += nansq(res[i]);
        if (use_data_loss && dmask[i] > 0.0f) {
          v[2] += nansq(bn - cond[i]);
          v[3] += nansq(b0[j] - cond[i]);
        }
      }
    }
    // the ring: the window's rows above and below the block (when inside
    // the domain), then its columns left and right of the block
    const int wcols = c1 - c0;
    const int n_top = e * wcols, n_bot = (r1 - bxmax) * wcols;
    const int n_left = f * rows, n_right = (c1 - bymax) * rows;
    const int n_ring = n_top + n_bot + n_left + n_right;
    for (int t = tid; t < n_ring; t += kThreads) {
      int r, c;
      if (t < n_top) {
        r = r0;
        c = c0 + t;
      } else if (t < n_top + n_bot) {
        r = bxmax;
        c = c0 + t - n_top;
      } else if (t < n_top + n_bot + n_left) {
        r = bxmin + t - n_top - n_bot;
        c = c0;
      } else {
        r = bxmin + t - n_top - n_bot - n_left;
        c = bymax;
      }
      const int i = r * W + c;
      tile[(r - r0 + 1) * S + (c - c0)] = surf[i] - (bed[i] + 0.0f);
    }
    __syncthreads();

    // the new residuals, kCells * kThreads cells a pass: every reader of
    // a cell's upper neighbour's thickness comes no later in the flat
    // order, so after the pass's barrier that slot takes the residual
    const float two_r = 2.0f * resolution;
    Walk wr(cols);
    for (int k0 = 0; k0 < ncell; k0 += kCells * kThreads) {
      int slot[kCells];  // -1 past the block
      float rn[kCells];
#pragma unroll
      for (int j = 0; j < kCells; ++j, wr.next()) {
        const bool live = k0 + j * kThreads + tid < ncell;
        slot[j] = live ? (wr.a + e) * S + wr.b + f : -1;
        if (!live) continue;
        const int r = bxmin + wr.a, c = bymin + wr.b;
        const int i = r * W + c;
        const int t = slot[j] + S;  // the cell's own thickness
        const float* th = tile;     // fluxes: velocity x thickness
        float dx, dy;
        if (c == 0)
          dx = (velx[i + 1] * th[t + 1] - velx[i] * th[t]) / resolution;
        else if (c == W - 1)
          dx = (velx[i] * th[t] - velx[i - 1] * th[t - 1]) / resolution;
        else
          dx = (velx[i + 1] * th[t + 1] - velx[i - 1] * th[t - 1]) / two_r;
        if (r == 0)
          dy = (vely[i + W] * th[t + S] - vely[i] * th[t]) / resolution;
        else if (r == H - 1)
          dy = (vely[i] * th[t] - vely[i - W] * th[t - S]) / resolution;
        else
          dy = (vely[i + W] * th[t + S] - vely[i - W] * th[t - S]) / two_r;
        rn[j] = dx + dy + forcing[i];
        if (mp[i] >= 2.0f) v[0] += nansq(rn[j]);
      }
      __syncthreads();
#pragma unroll
      for (int j = 0; j < kCells; ++j)
        if (slot[j] >= 0) tile[slot[j]] = rn[j];
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
    const float ex = expf(loss_prev - loss_next);
    const float rate = isnan(ex) ? ex : fminf(1.0f, ex);  // NaN propagates
    const bool ok = (u <= rate) && !viol;
    acc_out[n] = ok ? 1.0f : 0.0f;
    delta_out[n] = ok ? delta : 0.0f;
    ddata_out[n] = ok ? delta_data : 0.0f;
    ok_s = ok;
  }
  __syncthreads();
  if (!ok_s || ncell == 0) return;

  // ---- phase D: in-place writeback of the block -------------------------
  // kCells cells a pass, all read before any is written (they are
  // distinct cells, so the stores cannot feed the loads)
  Walk wd(cols);
  for (int k0 = 0; k0 < ncell; k0 += kCells * kThreads) {
    int ix[kCells];  // -1 past the block
    float rn[kCells], rs[kCells], bn[kCells];
#pragma unroll
    for (int j = 0; j < kCells; ++j, wd.next()) {
      const bool live = k0 + j * kThreads + tid < ncell;
      const int r = bxmin + wd.a, c = bymin + wd.b;
      ix[j] = live ? r * W + c : -1;
      if (!live) continue;
      const int i = ix[j];
      const float m = mp[i];
      rn[j] = tile[(wd.a + e) * S + wd.b + f];
      rs[j] = rsm[i] + upd(m);
      bn[j] = bed[i] + pert(r, c, i, m);
    }
#pragma unroll
    for (int j = 0; j < kCells; ++j) {
      if (ix[j] < 0) continue;
      res[ix[j]] = rn[j];
      rsm[ix[j]] = rs[j];
      bed[ix[j]] = bn[j];
    }
  }
}

// The wrapper's launch configuration: kThreads threads and `smem` bytes of
// dynamic shared memory; the runtime refuses a tile it cannot hold.
cudaError_t prepare(int threads, int smem) {
  if (threads != kThreads || smem < 0) return cudaErrorInvalidValue;
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(fused_window_kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              smem);
}

}  // namespace

extern "C" int mcmc_fused_window_update(
    const void* consts, void* fields, const void* fraw, const void* edge,
    const void* geom, const void* fvals, void* acc, void* delta,
    void* ddata, int n_chains, int H, int W, int B, int use_data_loss,
    int prefinished, int threads, int smem, void* stream) {
  if (n_chains <= 0) return 0;
  const cudaError_t e = prepare(threads, smem);
  if (e != cudaSuccess) return (int)e;
  fused_window_kernel<<<n_chains, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)consts, (float*)fields, (const float*)fraw,
      (const float*)edge, (const int*)geom, (const float*)fvals, (float*)acc,
      (float*)delta, (float*)ddata, H, W, B, use_data_loss, prefinished);
  return (int)cudaGetLastError();
}

// The wrapper's launch configuration on this card: out = [static shared
// bytes, registers a thread, local (spill) bytes a thread, resident CTAs a
// multiprocessor].
extern "C" int mcmc_fused_window_info(int threads, int smem, int* out) {
  cudaError_t e = prepare(threads, smem);
  if (e != cudaSuccess) return (int)e;
  cudaFuncAttributes attr;
  e = cudaFuncGetAttributes(&attr, fused_window_kernel);
  if (e != cudaSuccess) return (int)e;
  int resident = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &resident, fused_window_kernel, kThreads, smem);
  if (e != cudaSuccess) return (int)e;
  out[0] = (int)attr.sharedSizeBytes;
  out[1] = attr.numRegs;
  out[2] = (int)attr.localSizeBytes;
  out[3] = resident;
  return 0;
}

extern "C" const char* mcmc_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
