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
// What bounds it on an H100: device-memory bytes.  Extract reads and
// writes (NP + NS) * SB^2 * 4 B per chain (73 KB at NP = 10, NS = 4,
// SB = 36: 56.8 MB, 17 us at 3.35 TB/s for 512 chains), writeback
// NS * SB^2 * 4 B each way per writing chain (21 MB, 6.3 us).  A copy
// nears that rate only with megabytes of loads in flight card-wide and
// few instructions per element.  The first design (one 256-thread CTA
// per chain, a flat loop with two integer divisions, a select and one
// dependent load per trip) had neither: ~0.5 MB in flight, ~71 dependent
// round trips a thread; it ran at 0.35 (extract) and 0.27 (writeback) of
// the bound.  The writeback is further held by its pattern: 144-byte
// rows at any 4-byte offset in a 2 GB state, each in another DRAM page,
// whose end sectors are written only in part and must be merged with
// device memory.  Measured at the headline on an H100
// (ab_window_kernels.py): rows of whole sectors reach 0.43-0.51 of the
// bound, and partial end sectors cost a fifth more.
//
// Design: one CTA of 128 threads per (chain, plane), grid (N, planes):
// 7,168 CTAs for extract at 512 chains, 2,048 for writeback, 16 of them
// resident an SM.  Thread t takes the flat elements t, t + 128, ... of
// its region in passes of a fixed number of items and issues every load
// of a pass into registers before its first store: 7 (extract) or 5
// (writeback) loads in flight a thread, 5-8 MB card-wide.  (One pass at
// SB = 36, with more registers and fewer resident CTAs, ran slower.)
// The strided side (rows of cons or fields at any start) is walked
// without a division: each item's column and offsets step forward by the
// thread stride, computed once, with one carry (struct Walk).  Where the
// rows of fields start on 32-byte sectors (W % 8 == 0, as at the
// headline) the writeback covers whole sectors: each row from sy rounded down to a multiple of 8 to
// sy + SB rounded up, the cells beside the window read and written back
// unchanged (0.0197 ms against 0.0238 within the window).  Elsewhere it
// writes the window's own cells.  The contiguous side stays 4 bytes a
// thread: 16-byte accesses there bought nothing for extract (0.0271 ms
// against 0.0269) and cost the writeback 42 % (four store instructions a
// warp into every sector).  A rejected chain's writeback CTAs return
// before any load.
//
// Build (plain C interface, loaded with ctypes):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false \
//        -shared -Xcompiler -fPIC -o libsgs_window_kernel.so \
//        sgs_window_kernel.cu

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;    // threads a CTA
constexpr int kMinCtas = 16;     // resident CTAs an SM: 2,048 threads, so
                                 // at most 32 registers a thread
constexpr int kItems = 7;        // elements a thread a pass
constexpr int kSectorItems = 5;  // the same, full-sector writeback

// A thread's walk over the flat offsets e0, e0 + S, e0 + 2S, ... of a
// region of ``cols`` columns: the column c = e % cols and the offsets
// (e / cols) * W + c of a plane with row stride W and (e / cols) * P + c
// of one with row stride P, stepped forward by S with no division
// (S % cols < cols: one carry).
struct Walk {
  int c, off, off2;
  const int dc, step, step2, wrap, wrap2, cols;
  __device__ Walk(int e0, int S, int cols_, int W, int P)
      : c(e0 % cols_), off((e0 / cols_) * W + e0 % cols_),
        off2((e0 / cols_) * P + e0 % cols_), dc(S % cols_),
        step((S / cols_) * W + S % cols_), step2((S / cols_) * P + S % cols_),
        wrap(W - cols_), wrap2(P - cols_), cols(cols_) {}
  __device__ __forceinline__ void next() {
    c += dc;
    off += step;
    off2 += step2;
    if (c >= cols) {
      c -= cols;
      off += wrap;
      off2 += wrap2;
    }
  }
};

// One (SB, SB) window between a plane with row stride W and a contiguous
// block: gather (plane -> block) or scatter, 4-byte accesses.
template <bool kScatter>
__device__ __forceinline__ void copy_window(const float* __restrict__ src,
                                            float* __restrict__ dst, int W,
                                            int SB) {
  const int win = SB * SB;
  Walk w(threadIdx.x, kThreads, SB, W, SB);
  for (int base = threadIdx.x; base < win; base += kThreads * kItems) {
    float v[kItems];
    int off[kItems];
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      off[i] = w.off;
      w.next();
      if (base + i * kThreads < win)
        v[i] = kScatter ? src[base + i * kThreads] : src[off[i]];
    }
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      if (base + i * kThreads < win) {
        if (kScatter)
          dst[off[i]] = v[i];
        else
          dst[base + i * kThreads] = v[i];
      }
    }
  }
}

// The writeback of one window into a plane whose rows start on 32-byte
// sectors (W % 8 == 0): each row written over whole sectors, columns
// [sy - lead, sy - lead + span) with lead = sy % 8, the cells beside the
// window rewritten with the values just read from them.  No sector is
// written in part, so the L2 never has to merge one with device memory.
// ``dst`` points at (sx, sy - lead); no other CTA touches this plane.
__device__ __forceinline__ void writeback_sectors(
    const float* __restrict__ src, float* dst, int W, int SB, int lead) {
  const int span = (lead + SB + 7) & ~7;
  const int n = SB * span;
  Walk w(threadIdx.x, kThreads, span, W, SB);
  for (int base = threadIdx.x; base < n; base += kThreads * kSectorItems) {
    float v[kSectorItems];
    int off[kSectorItems];
#pragma unroll
    for (int i = 0; i < kSectorItems; ++i) {
      off[i] = w.off;
      const float* p = (unsigned)(w.c - lead) < (unsigned)SB
                           ? src + (w.off2 - lead)
                           : dst + w.off;
      w.next();
      if (base + i * kThreads < n) v[i] = *p;
    }
#pragma unroll
    for (int i = 0; i < kSectorItems; ++i)
      if (base + i * kThreads < n) dst[off[i]] = v[i];
  }
}

// Grid (N, NP + NS): CTA (n, k) copies plane k of chain n's window.
__global__ void __launch_bounds__(kThreads, kMinCtas)
window_extract_kernel(const float* __restrict__ cons,
                      const float* __restrict__ fields,
                      const int* __restrict__ sx_arr,
                      const int* __restrict__ sy_arr,
                      float* __restrict__ out, int NP, int NS, int H, int W,
                      int SB) {
  const int n = blockIdx.x;
  const int k = blockIdx.y;
  const size_t hw = (size_t)H * W;
  const size_t at = (size_t)sx_arr[n] * W + sy_arr[n];
  const float* src = (k < NP ? cons + k * hw
                             : fields + ((size_t)n * NS + (k - NP)) * hw) + at;
  copy_window<false>(src, out + ((size_t)n * (NP + NS) + k) * SB * SB, W,
                     SB);
}

// Grid (N, NS): CTA (n, k) writes plane k of chain n's window, if write[n].
template <bool kFullSectors>
__global__ void __launch_bounds__(kThreads, kMinCtas)
window_writeback_kernel(float* fields, const float* __restrict__ new_w,
                        const int* __restrict__ sx_arr,
                        const int* __restrict__ sy_arr,
                        const bool* __restrict__ write, int NS, int H, int W,
                        int SB) {
  const int n = blockIdx.x;
  if (!write[n]) return;
  const size_t plane = (size_t)n * NS + blockIdx.y;
  const int sy = sy_arr[n];
  const float* src = new_w + plane * SB * SB;
  float* row = fields + plane * H * W + (size_t)sx_arr[n] * W;
  if (kFullSectors)
    writeback_sectors(src, row + (sy & ~7), W, SB, sy & 7);
  else
    copy_window<true>(src, row + sy, W, SB);
}

// The full-sector writeback needs every row of fields to start on a
// 32-byte sector: W % 8 == 0 and a 32-byte aligned base.
bool full_sectors(int W, const void* fields, bool allow) {
  return allow && W % 8 == 0 && (uintptr_t)fields % 32 == 0;
}

// The walks' in-plane offsets run up to ~(H + one pass of rows) * W and
// are 32-bit.
bool offsets_fit(int H, int W) {
  return (long long)(H + kThreads * (kItems + kSectorItems)) * W < INT_MAX;
}

const void* writeback_kernel(bool sectors) {
  return sectors ? (const void*)window_writeback_kernel<true>
                 : (const void*)window_writeback_kernel<false>;
}

int launch_writeback(void* fields, const void* new_w, const void* sx,
                     const void* sy, const void* write, int n_chains, int NS,
                     int H, int W, int SB, void* stream, bool allow_sectors) {
  if (n_chains <= 0) return 0;
  if (!offsets_fit(H, W)) return (int)cudaErrorInvalidValue;
  const dim3 grid(n_chains, NS);
  auto* kernel = full_sectors(W, fields, allow_sectors)
                     ? window_writeback_kernel<true>
                     : window_writeback_kernel<false>;
  kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (float*)fields, (const float*)new_w, (const int*)sx, (const int*)sy,
      (const bool*)write, NS, H, W, SB);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int mcmc_window_extract(const void* cons, const void* fields,
                                   const void* sx, const void* sy, void* out,
                                   int n_chains, int NP, int NS, int H, int W,
                                   int SB, void* stream) {
  if (n_chains <= 0) return 0;
  if (!offsets_fit(H, W)) return (int)cudaErrorInvalidValue;
  window_extract_kernel<<<dim3(n_chains, NP + NS), kThreads, 0,
                          (cudaStream_t)stream>>>(
      (const float*)cons, (const float*)fields, (const int*)sx,
      (const int*)sy, (float*)out, NP, NS, H, W, SB);
  return (int)cudaGetLastError();
}

extern "C" int mcmc_window_writeback(void* fields, const void* new_w,
                                     const void* sx, const void* sy,
                                     const void* write, int n_chains, int NS,
                                     int H, int W, int SB, void* stream) {
  return launch_writeback(fields, new_w, sx, sy, write, n_chains, NS, H, W,
                          SB, stream, true);
}

// The writeback held to its window's own cells (partial sectors), to
// measure what the full-sector path buys (ab_window_kernels.py).
extern "C" int mcmc_window_writeback_in_window(
    void* fields, const void* new_w, const void* sx, const void* sy,
    const void* write, int n_chains, int NS, int H, int W, int SB,
    void* stream) {
  return launch_writeback(fields, new_w, sx, sy, write, n_chains, NS, H, W,
                          SB, stream, false);
}

// A kernel's launch on the current card, ``which`` choosing it (0 the
// extract, 1 the writeback within the window, 2 the full-sector
// writeback); out = [threads a CTA, registers a thread, local (spill)
// bytes a thread, resident CTAs a multiprocessor].
extern "C" int mcmc_window_info(int which, int* out) {
  const void* fn = which == 0 ? (const void*)window_extract_kernel
                              : writeback_kernel(which == 2);
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, fn);
  if (e != cudaSuccess) return (int)e;
  int resident = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, fn, kThreads,
                                                    0);
  if (e != cudaSuccess) return (int)e;
  out[0] = kThreads;
  out[1] = attr.numRegs;
  out[2] = (int)attr.localSizeBytes;
  out[3] = resident;
  return 0;
}

extern "C" const char* mcmc_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
