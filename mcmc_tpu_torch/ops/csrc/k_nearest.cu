// The SGS step's K-nearest selection and its packed system's inputs, one
// CTA a chain.
//
// The port's own kernel: the JAX package finds the K-th smallest squared
// distance by integer bisection in XLA ops (mcmc_tpu/models/chain_sgs.py::
// _k_nearest_valid) and has no Pallas kernel for it.  Same function and
// contract as the plain PyTorch version beside it, mcmc_tpu_torch/ops/
// k_nearest_kernel.py::k_nearest_reference (kthvalue, two cumsum scans,
// searchsorted, then the gathers and casts), bit for bit.  For chain n's
// (SB, SB) window, cell c = i * SB + j, and key = rd_i^2 + cd_j^2 (an
// integer):
//   candidate = cond[c] && key <= D;
//   T = the K-th smallest key of the candidates (none where fewer than K
//   candidates exist);
//   taken: every candidate with key < T, then those at T by lowest c, in
//   window-index order, to at most K; slot r of the K outputs holds the
//   r-th cell taken:
//   idx = c, sel = 1, m_sel = 1, iaf = c / SB, jaf = c % SB,
//   rhs_p = z_w[c] - z_u[c];
//   an empty slot (fewer than K candidates): idx = SB^2 - 1, sel = 0,
//   m_sel = 0, iaf = jaf = SB - 1, rhs_p = 0, as clamp(searchsorted) and
//   the masks give them.
// The plain version's distance test, fl(fl(sqrt(key)) * resolution) <=
// radius in float32, is monotone in the exact integer key for a positive
// resolution, so it holds for the keys 0 .. D and no others: the
// dispatcher finds D once on the host, in float32 as the plain version
// rounds (k_nearest_kernel.py::_max_key), and the kernel tests integers.
// Built with -fmad=false, the one float operation, z_w - z_u, rounds as
// PyTorch's does.
//
// What bounds it on an H100: neither bytes nor operations.  At the farm's
// headline (512 chains, SB = 36, K = 48) it reads 0.66 MB of masks, 0.29 MB
// of distances and 0.2 MB of the taken cells' z values and writes 0.61 MB:
// 0.5 us at 3.35 TB/s.  What it replaces was some forty launches over
// (512, 1296) planes and a radix select (kthvalue), 150 us or more a step.
// So one CTA holds a chain's whole selection in shared memory, the latency
// of a few dependent steps is the cost, and the design keeps those few
// and short:
//   1. the CTA stages the chain's row and column distances in shared
//      memory and zeroes a histogram of the keys, one 16-bit count for
//      each key 0 .. 2 (SB - 1)^2, two to a 32-bit word, while the mask's
//      first bytes are on their way;
//   2. the threads take the cells in turn (cell c by thread c % 256: the
//      mask's bytes coalesced, eight of a thread loaded at once), write
//      each cell's key to shared memory as 16 bits (0xFFFF for no
//      candidate) and count each candidate's key in the histogram (shared
//      atomics on the word: the counts do not depend on their order, and
//      none passes 16 bits);
//   3. each thread sums its run of histogram words; one block-wide scan of
//      those sums finds the key where the running count reaches K: T, and
//      the cells strictly nearer than T;
//   4. each thread reads the keys of its run of consecutive cells from
//      shared memory and counts the strict cells and the ties at T; one
//      block-wide scan of the two counts, packed in 16 bits each, gives
//      every cell its rank among the cells taken (a strict cell after all
//      the ties that are taken before it), and the thread writes each cell
//      it takes into a table of slots at its rank (over the histogram,
//      which is read no more);
//   5. a thread a slot writes its six outputs, a taken cell's (its z
//      values loaded then, all together) or an empty slot's, coalesced.
// Eight barriers, two trips to device memory (the distances and the mask
// together, the taken cells' z values).  One wave: at the headline 512 CTAs of 256
// threads on 132 multiprocessors.  Shared memory holds the histogram, the
// keys and the distances, about 6 SB^2 bytes: the launcher refuses an SB
// that does not fit a CTA's opt-in shared memory, or whose SB^2 cells do
// not fit the 15 bits step 4 gives a count (mcmc_k_nearest_max_sb: SB <=
// 181), and takes any K in 1 .. SB^2.  The distances are taken as the
// step makes them, 0 <= rd, cd < SB; others are clamped there, so that no
// key falls outside the histogram.
//
// Build (plain C interface, loaded with ctypes):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false \
//        -shared -Xcompiler -fPIC -o libk_nearest.so k_nearest.cu

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kFar = 0xFFFF;          // the key of a cell that is no candidate
constexpr int kDefaultSmem = 48 * 1024;
constexpr int kMaxCells = 0x7FFF;     // step 4 packs two counts in an int
constexpr int kBatch = 8;             // cells a thread loads at once, step 2

__host__ __device__ inline int n_bins(int SB) {
  return 2 * (SB - 1) * (SB - 1) + 1;
}

__host__ __device__ inline int n_words(int SB) {
  return (n_bins(SB) + 1) / 2;
}

// dynamic shared bytes a CTA: the histogram's words, the row and column
// distances, the cells' 16-bit keys
__host__ __device__ inline long long smem_bytes(int SB) {
  return 4LL * (n_words(SB) + 2 * SB) + 2LL * SB * SB;
}

// The exclusive sum of v over the CTA's threads in thread order, and the
// sum over all of them in *total.  Two barriers; ``warp_sums`` is this
// call's own.
__device__ int exclusive_sum(int v, int* warp_sums, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = lane < kWarps ? warp_sums[lane] : 0;
#pragma unroll
    for (int o = 1; o < kWarps; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += y;
    }
    if (lane < kWarps) warp_sums[lane] = w;
  }
  __syncthreads();
  *total = warp_sums[kWarps - 1];
  return x - v + (warp > 0 ? warp_sums[warp - 1] : 0);
}

__global__ void __launch_bounds__(kThreads)
k_nearest_kernel(const uint8_t* __restrict__ cond,
                 const long long* __restrict__ rd,
                 const long long* __restrict__ cd,
                 const float* __restrict__ z_w, const float* __restrict__ z_u,
                 int max_key, int SB, int K, long long* __restrict__ idx,
                 bool* __restrict__ sel, float* __restrict__ m_sel,
                 float* __restrict__ iaf, float* __restrict__ jaf,
                 float* __restrict__ rhs_p) {
  extern __shared__ unsigned smem[];
  __shared__ int sums_bins[kWarps], sums_cells[kWarps];
  __shared__ int s_T, s_strict;
  const int nw = n_words(SB);
  unsigned* hist = smem;              // key b counted in word b / 2, half b % 2
  int* s_rd = (int*)(smem + nw);
  int* s_cd = s_rd + SB;
  uint16_t* keys = (uint16_t*)(s_cd + SB);
  const int tid = threadIdx.x;
  const long long n = blockIdx.x;
  const int cells = SB * SB;
  cond += n * cells;
  z_w += n * cells;
  z_u += n * cells;
  idx += n * K;
  sel += n * K;
  m_sel += n * K;
  iaf += n * K;
  jaf += n * K;
  rhs_p += n * K;

  // 1. the mask's first cells in flight; the distances, clamped into the
  // window; the histogram zeroed
  uint8_t mask[kBatch];
#pragma unroll
  for (int k = 0; k < kBatch; ++k) {
    const int c = k * kThreads + tid;
    mask[k] = c < cells ? cond[c] : 0;
  }
  for (int w = tid; w < nw; w += kThreads) hist[w] = 0u;
  for (int i = tid; i < SB; i += kThreads) {
    const long long r = rd[n * SB + i], q = cd[n * SB + i];
    s_rd[i] = (int)min(r < 0 ? -r : r, (long long)(SB - 1));
    s_cd[i] = (int)min(q < 0 ? -q : q, (long long)(SB - 1));
  }
  __syncthreads();

  // 2. every cell's key, counted; cell c = i * SB + j by thread c % 256,
  // kBatch cells of a thread loaded at once
  {
    int i = tid / SB, j = tid - (tid / SB) * SB;
    const int di = kThreads / SB, dj = kThreads - di * SB;
    for (int base = 0; base < cells; base += kBatch * kThreads) {
      if (base > 0) {
#pragma unroll
        for (int k = 0; k < kBatch; ++k) {
          const int c = base + k * kThreads + tid;
          mask[k] = c < cells ? cond[c] : 0;
        }
      }
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        const int c = base + k * kThreads + tid;
        if (c < cells) {
          const int r = s_rd[i], q = s_cd[j];
          const int d2 = r * r + q * q;
          const int key = (mask[k] && d2 <= max_key) ? d2 : kFar;
          keys[c] = (uint16_t)key;
          if (key != kFar)
            atomicAdd(hist + (key >> 1), 1u << ((key & 1) * 16));
        }
        i += di;
        j += dj;
        if (j >= SB) {
          j -= SB;
          ++i;
        }
      }
    }
  }
  __syncthreads();

  // 3. T: the smallest key whose running count reaches K; where fewer than
  // K candidates exist, kFar (every candidate is then strictly nearer)
  const int wper = (nw + kThreads - 1) / kThreads;
  const int w0 = min(tid * wper, nw), w1 = min(w0 + wper, nw);
  int mine = 0;
  for (int w = w0; w < w1; ++w) mine += (hist[w] & 0xFFFF) + (hist[w] >> 16);
  int total = 0;
  const int before = exclusive_sum(mine, sums_bins, &total);
  if (total < K) {
    if (tid == 0) {
      s_T = kFar;
      s_strict = total;
    }
  } else if (before < K && before + mine >= K) {
    int b = 2 * w0, acc = before;
    for (;;) {
      const int count = (hist[b >> 1] >> ((b & 1) * 16)) & 0xFFFF;
      if (acc + count >= K) break;
      acc += count;
      ++b;
    }
    s_T = b;
    s_strict = acc;
  }
  __syncthreads();
  const int T = s_T;
  const int room = K - s_strict;  // ties at T that are taken
  const int taken = min(K, total);

  // 4. ranks: strict cells and ties before each cell, in window order,
  // over this thread's run of consecutive cells [c0, c1)
  const int per = (cells + kThreads - 1) / kThreads;
  const int c0 = min(tid * per, cells), c1 = min(c0 + per, cells);
  int counts = 0;  // strict << 16 | ties, each at most kMaxCells
  for (int c = c0; c < c1; ++c) {
    const int key = keys[c];
    counts += (key < T ? 1 << 16 : 0) + (key == T && key != kFar ? 1 : 0);
  }
  int unused = 0;
  const int start = exclusive_sum(counts, sums_cells, &unused);
  int strict = start >> 16, ties = start & 0xFFFF;
  uint16_t* slot = (uint16_t*)hist;  // the cell taken at each rank
  for (int c = c0; c < c1; ++c) {
    const int key = keys[c];
    if (key < T) {
      slot[strict + min(ties, room)] = (uint16_t)c;
      ++strict;
    } else if (key == T && key != kFar) {
      if (ties < room) slot[strict + ties] = (uint16_t)c;
      ++ties;
    }
  }
  __syncthreads();

  // 5. the K slots, a thread each: a taken cell's outputs, or an empty
  // slot's
  for (int r = tid; r < K; r += kThreads) {
    if (r < taken) {
      const int c = slot[r];
      const int i = c / SB;
      idx[r] = c;
      sel[r] = true;
      m_sel[r] = 1.0f;
      iaf[r] = (float)i;
      jaf[r] = (float)(c - i * SB);
      rhs_p[r] = __fsub_rn(z_w[c], z_u[c]);
    } else {
      idx[r] = cells - 1;
      sel[r] = false;
      m_sel[r] = 0.0f;
      iaf[r] = (float)(SB - 1);
      jaf[r] = (float)(SB - 1);
      rhs_p[r] = 0.0f;
    }
  }
}

// The largest SB whose histogram and distances, beside the kernel's static
// shared memory, fit a CTA's opt-in shared memory on the current card.
cudaError_t max_sb(int* out) {
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev);
  if (e != cudaSuccess) return e;
  cudaFuncAttributes attr;
  e = cudaFuncGetAttributes(&attr, (const void*)k_nearest_kernel);
  if (e != cudaSuccess) return e;
  const long long room = (long long)optin - (long long)attr.sharedSizeBytes;
  *out = 1;
  while ((*out + 1) * (*out + 1) <= kMaxCells && smem_bytes(*out + 1) <= room)
    ++*out;
  return cudaSuccess;
}

// Check SB against the card, opt in to the shared memory it needs.
cudaError_t launch_config(int SB, int* smem) {
  int limit = 0;
  cudaError_t e = max_sb(&limit);
  if (e != cudaSuccess) return e;
  if (SB < 1 || SB > limit) return cudaErrorInvalidValue;
  *smem = (int)smem_bytes(SB);
  if (*smem <= kDefaultSmem) return cudaSuccess;
  return cudaFuncSetAttribute((const void*)k_nearest_kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              *smem);
}

__global__ void empty_kernel() {}

}  // namespace

// ``max_key``: D, the largest key whose distance passes the radius (-1
// where none does).
extern "C" int mcmc_k_nearest(const void* cond, const void* rd,
                              const void* cd, const void* z_w,
                              const void* z_u, int max_key, int n_chains,
                              int SB, int K, void* idx, void* sel,
                              void* m_sel, void* iaf, void* jaf, void* rhs_p,
                              void* stream) {
  if (n_chains <= 0) return 0;
  if (K < 1 || (long long)K > (long long)SB * SB)
    return (int)cudaErrorInvalidValue;
  int smem = 0;
  const cudaError_t e = launch_config(SB, &smem);
  if (e != cudaSuccess) return (int)e;
  k_nearest_kernel<<<n_chains, kThreads, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)cond, (const long long*)rd, (const long long*)cd,
      (const float*)z_w, (const float*)z_u, max_key, SB, K,
      (long long*)idx, (bool*)sel, (float*)m_sel, (float*)iaf, (float*)jaf,
      (float*)rhs_p);
  return (int)cudaGetLastError();
}

// The largest SB the kernel takes on the current card.
extern "C" int mcmc_k_nearest_max_sb(int* out) { return (int)max_sb(out); }

// The launch at SB on the current card: out = [threads a CTA, dynamic
// shared bytes, static shared bytes, registers a thread, local (spill)
// bytes a thread, resident CTAs a multiprocessor].
extern "C" int mcmc_k_nearest_info(int SB, int* out) {
  int smem = 0;
  cudaError_t e = launch_config(SB, &smem);
  if (e != cudaSuccess) return (int)e;
  cudaFuncAttributes attr;
  e = cudaFuncGetAttributes(&attr, (const void*)k_nearest_kernel);
  if (e != cudaSuccess) return (int)e;
  int resident = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &resident, (const void*)k_nearest_kernel, kThreads, smem);
  if (e != cudaSuccess) return (int)e;
  out[0] = kThreads;
  out[1] = smem;
  out[2] = (int)attr.sharedSizeBytes;
  out[3] = attr.numRegs;
  out[4] = (int)attr.localSizeBytes;
  out[5] = resident;
  return 0;
}

// An empty kernel on ``blocks`` CTAs of the selection's width: the floor
// a launch of that grid pays whatever it computes.
extern "C" int mcmc_k_nearest_empty(int blocks, void* stream) {
  if (blocks <= 0) return 0;
  empty_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}

extern "C" const char* mcmc_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
