// Fixed-iteration conjugate gradients on the SGS chain's packed
// conditioning systems, one masked K x K system per chain.  Two kernels
// share the solver (cg_iterate) and differ only in how the system reaches
// shared memory:
//
// mix_cg_kernel replaces mcmc_tpu/ops/cg_kernel.py::lanes_mix_masked_cg
// (the Pallas TPU kernel; body _cg_lanes_mix_kernel, solver _cg_core).
// Same function and contract as the plain PyTorch version beside it,
// mcmc_tpu_torch/ops/cg_kernel.py::mix_masked_cg_reference:
//   1. build A[i][j] = S(h2_ij) * m_i * m_j, plus eps + (1 - m_j) on the
//      diagonal, with h2_ij = q0*dj*dj + q1*dj*di + q2*di*di (di = ia_i -
//      ia_j, dj = ja_i - ja_j) and S the static Gaussian+exponential
//      mixture evaluated as ops/covariance.py::eval_mixture_static orders
//      it: the Gaussian family, then the exponential; per dyadic family ONE
//      expf(-b0 * x) and repeated squaring by rising k, terms summed in that
//      order (x = h2, or sqrt(h2) for the exponential family); per-term
//      expf for a non-dyadic family.  The mixture arrives as a by-value
//      kernel parameter (MixParams).
//
// masked_cg_kernel replaces mcmc_tpu/ops/cg_kernel.py::lanes_masked_cg
// (body _cg_lanes_kernel, system _masked_system, solver _cg_core), the
// solve of a covariance with no mixture fit (a spherical variogram), with
// the plain version ops/cg_kernel.py::masked_cg_reference:
//   1. load A = Sigma * m_j * m_i, plus eps + (1 - m_i) on the diagonal,
//      from the given (N, K, K) Sigma.  Like _cg_core, which reads block j
//      of the (K*K, B) system as column j, the kernel takes row j of Sigma
//      as column j (Sigma is symmetric).
//
// Both then
//   2. run n_iters iterations of _cg_core from x = 0 on b = m * rhs, with
//      its 1e-30 guards on both denominators, the matvec summed over j in
//      rising order as _cg_core sums its blocks, one rounding per multiply
//      and per add;
//   3. write w = x * m.
//
// What bounds them on an H100: latency.  Per chain the work is n_iters x
// (K^2 multiply-adds + two K-long dot products) on data that fits one
// SM's shared memory, plus K(K+1)/2 = 1176 mixture evaluations at K = 48
// (mix) or one 9.2 KB load of Sigma (masked).  By the card's peak rates
// both are bound by float32 operations (~2 us at 512 chains), far below
// the latency of n_iters dependent iterations, each a 48-long chain of
// adds and two 32-lane reductions, plus two IEEE divisions.  Design, for
// that chain of latencies:
//   - one warp per chain, several independent chains in a CTA (chains per
//     CTA chosen by K, launch_config), no CTA barrier anywhere: the
//     iteration synchronises with __syncwarp and warp shuffles only, and
//     a warp past the last chain returns at once;
//   - lane l owns rows l, l + 32, ... (R = ceil(K / 32) slots, a template
//     parameter, so every per-row loop unrolls): each dot product is R
//     independent 5-step butterflies, summed by slot in rising order
//     (with at least two slots: for K <= 32 an empty second slot adds
//     +0.0); for K <= 64 the same sums as one 64-thread CTA's "warp 0 +
//     warp 1", the order the plain version has always kept;
//   - the system in shared memory row-major, each row padded to a stride
//     that is a multiple of 4 with an odd quarter (row_stride: the 8 lanes
//     of a 16-byte phase hit 8 different bank groups), so a lane reads 4
//     terms of a row in one 16-byte load; the matvec runs in blocks of 8
//     columns, two blocks in registers, each block's loads issued before
//     the previous block's adds; p is broadcast from shared memory as
//     float4 (double-buffered, so one __syncwarp an iteration suffices).
//     Rows K..32R-1 read row K - 1 and their products are dropped;
//   - mix: the build evaluates the upper triangle only (i <= j) spread
//     over all 32 lanes, 8 entries a lane at once (independent chains of
//     expf and squarings), and mirrors it.  That is bitwise safe: di and dj
//     negate exactly between (i, j) and (j, i), so every product of h2
//     keeps its bits; and the masks are 0 or 1, so S*m_i*m_j and S*m_j*m_i
//     are the same bits (S, or a zero of S's sign);
//   - masked: Sigma is copied row j into column j with cp.async (all of a
//     chain's loads in flight at once, no division per element), then
//     masked in shared memory 8 rows of Sigma at a time.
// No atomics, so every run gives identical results.  The TPU version's
// batch-in-lanes layout, 128-lane padding and lane-block VMEM budget are
// dropped; K is bounded by one warp's system in one CTA's opt-in shared
// memory (mcmc_cg_max_k: K <= 236 on an H100).
//
// Build (plain C interface, loaded with ctypes):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false \
//        -shared -Xcompiler -fPIC -o libcg_kernel.so cg_kernel.cu
// -fmad=false keeps every a*b+c as two roundings, as the plain version's
// separate PyTorch operations compute it.

#include <cuda_runtime.h>
#include <math.h>

constexpr int kMaxTerms = 16;
constexpr int kMaxSlots = 8;       // rows a lane owns: K <= 32 * kMaxSlots
constexpr int kMaxChainsPerCta = 4;
constexpr int kBuild = 8;          // mixture entries a lane evaluates at once
constexpr int kDefaultSmem = 48 * 1024;  // above it only after an opt-in

// The mixture parameters (mirrored by ctypes in ops/cg_kernel.py).  At
// namespace scope, not in the anonymous namespace: the extern "C" launcher
// takes a pointer to them and would otherwise get internal linkage.
struct MixFamily {
  int in_h;     // 1: the family decays in sqrt(h2) (exponential)
  int dyadic;   // 1: rates nb0 * 2^k, one expf and repeated squaring
  float nb0;    // -b0, the negated base rate (dyadic)
  int n;        // number of terms
  int k[kMaxTerms];        // dyadic: the exponents, rising
  float nrate[kMaxTerms];  // non-dyadic: the negated rates, in order
  float amp[kMaxTerms];    // the amplitudes
};

struct MixParams {
  int n_fam;
  MixFamily fam[2];
  float q[3];
};

namespace {

// The mixture at E values of h2 at once (independent chains of latency
// for the scheduler to interleave); per value the order of
// eval_mixture_static.
template <int E>
__device__ __forceinline__ void mixture(const MixParams& mix,
                                        const float (&h2)[E],
                                        float (&out)[E]) {
  for (int f = 0; f < mix.n_fam; ++f) {
    const MixFamily& fam = mix.fam[f];
    float x[E], s[E];
#pragma unroll
    for (int e = 0; e < E; ++e) x[e] = fam.in_h ? sqrtf(h2[e]) : h2[e];
    if (fam.dyadic) {
      float P[E];
#pragma unroll
      for (int e = 0; e < E; ++e) P[e] = expf(x[e] * fam.nb0);
      int k_cur = 0;
      for (int t = 0; t < fam.n; ++t) {
        for (; k_cur < fam.k[t]; ++k_cur) {
#pragma unroll
          for (int e = 0; e < E; ++e) P[e] = P[e] * P[e];
        }
        const float amp = fam.amp[t];
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const float term = P[e] * amp;
          s[e] = t == 0 ? term : s[e] + term;
        }
      }
    } else {
      for (int t = 0; t < fam.n; ++t) {
        const float rate = fam.nrate[t], amp = fam.amp[t];
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const float term = expf(x[e] * rate) * amp;
          s[e] = t == 0 ? term : s[e] + term;
        }
      }
    }
#pragma unroll
    for (int e = 0; e < E; ++e) out[e] = f == 0 ? s[e] : out[e] + s[e];
  }
}

// jnp.maximum(x, 1e-30): the guard, with NaN passed through
__device__ __forceinline__ float guard(float x) {
  return (x >= 1e-30f || isnan(x)) ? x : 1e-30f;
}

// The row stride of a chain's system, in floats: K rounded up to a multiple
// of 4 whose quarter is odd, so that the 8 lanes of a 16-byte shared-memory
// phase, reading 8 rows at one column, hit 8 different groups of 4 banks.
__host__ __device__ constexpr int row_stride(int K) {
  return (K + 3) / 4 % 2 ? (K + 3) / 4 * 4 : (K + 3) / 4 * 4 + 4;
}

// Shared memory of one chain (one warp), in floats, each piece 16-byte
// aligned: the mask and two scratch vectors of 32R (the window coordinates
// during the build, then the double-buffered search direction), then the
// system, K rows of row_stride(K).
__host__ __device__ constexpr int warp_floats(int K, int R) {
  return 3 * 32 * R + K * row_stride(K);
}

// Sum over the warp of a[r] * b[r], every lane's R slots: per slot the
// 5-step butterfly, then the slots summed in rising order, at least two.
template <int R>
__device__ __forceinline__ float warp_dot(const float (&a)[R],
                                          const float (&b)[R]) {
  float v[R];
#pragma unroll
  for (int r = 0; r < R; ++r) v[r] = a[r] * b[r];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int r = 0; r < R; ++r)
      v[r] += __shfl_xor_sync(0xffffffffu, v[r], off);
  }
  float s = v[0] + (R > 1 ? v[1] : 0.0f);
#pragma unroll
  for (int r = 2; r < R; ++r) s = s + v[r];
  return s;
}

// Columns j0 .. j0 + 7 of the lane's R rows, and p[j0 .. j0 + 7].
template <int R>
struct Block {
  float4 a0[R], a1[R];
  float4 p0, p1;
};

template <int R>
__device__ __forceinline__ void load_block(Block<R>& b,
                                           const float* const (&row)[R],
                                           const float* __restrict__ p,
                                           int j0) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
    b.a0[r] = *reinterpret_cast<const float4*>(row[r] + j0);
    b.a1[r] = *reinterpret_cast<const float4*>(row[r] + j0 + 4);
  }
  b.p0 = *reinterpret_cast<const float4*>(p + j0);
  b.p1 = *reinterpret_cast<const float4*>(p + j0 + 4);
}

__device__ __forceinline__ float part(const float4& v, int c) {
  return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
}

// q += the block's 8 terms in rising j (first: q = its first term)
template <int R, bool first>
__device__ __forceinline__ void add_block(const Block<R>& b, float (&q)[R]) {
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const float pc = part(c < 4 ? b.p0 : b.p1, c & 3);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float t = part(c < 4 ? b.a0[r] : b.a1[r], c & 3) * pc;
      q[r] = (first && c == 0) ? t : q[r] + t;
    }
  }
}

// q[r] = sum_j A[row r][j] * p[j], j rising, one rounding per multiply and
// per add; row[r] points at the lane's row r.  Blocks of 8 columns, two in
// registers: each block's loads (16 bytes a lane per row) are issued before
// the previous block's adds, so they arrive while that chain runs.
template <int R>
__device__ __forceinline__ void matvec(const float* const (&row)[R],
                                       const float* __restrict__ p, int K,
                                       float (&q)[R]) {
  const int nb = K >> 3;
  int j = 0;
  if (nb > 0) {
    Block<R> x, y;
    load_block(x, row, p, 0);
    load_block(y, row, p, nb > 1 ? 8 : 0);
    add_block<R, true>(x, q);
    int b = 1;
    for (; b + 1 < nb; b += 2) {
      load_block(x, row, p, 8 * (b + 1));
      add_block<R, false>(y, q);
      load_block(y, row, p, 8 * min(b + 2, nb - 1));
      add_block<R, false>(x, q);
    }
    if (b < nb) add_block<R, false>(y, q);
    j = 8 * nb;
  } else {
#pragma unroll
    for (int r = 0; r < R; ++r) q[r] = row[r][0] * p[0];
    j = 1;
  }
  for (; j < K; ++j) {
    const float pj = p[j];
#pragma unroll
    for (int r = 0; r < R; ++r) q[r] = q[r] + row[r][j] * pj;
  }
}

// _cg_core on the warp's system A (shared memory, row i at A + i * st): lane l
// owns rows l + 32r (m, rh their mask and right-hand side, both 0 past K).
// pbuf is two 32R-float buffers for the search direction.  Returns the
// lane's rows of x after n_iters iterations in x.  Callers __syncwarp
// after writing A.
template <int R>
__device__ __forceinline__ void cg_iterate(const float* A, float* pbuf,
                                           int K, const float (&m)[R],
                                           const float (&rh)[R], int n_iters,
                                           float (&x)[R]) {
  const int lane = threadIdx.x & 31;
  const int st = row_stride(K);
  const float* row[R];  // rows past K read row K - 1; their q is dropped
  float r_[R], p[R], q[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    row[r] = A + min(lane + 32 * r, K - 1) * st;
    x[r] = 0.0f;
    r_[r] = m[r] * rh[r];
    p[r] = r_[r];
  }
  float rs = warp_dot(r_, r_);
  for (int it = 0; it < n_iters; ++it) {
    float* pb = pbuf + (it & 1) * 32 * R;
#pragma unroll
    for (int r = 0; r < R; ++r) pb[lane + 32 * r] = p[r];
    __syncwarp();
    matvec<R>(row, pb, K, q);
#pragma unroll
    for (int r = 0; r < R; ++r)
      if (lane + 32 * r >= K) q[r] = 0.0f;
    const float pAp = warp_dot(p, q);
    const float alpha = rs / guard(pAp);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      x[r] = x[r] + alpha * p[r];
      r_[r] = r_[r] - alpha * q[r];
    }
    const float rs_new = warp_dot(r_, r_);
    const float beta = rs_new / guard(rs);
#pragma unroll
    for (int r = 0; r < R; ++r) p[r] = r_[r] + beta * p[r];
    rs = rs_new;
  }
}

template <int R>
__global__ void __launch_bounds__(32 * kMaxChainsPerCta)
mix_cg_kernel(const float* __restrict__ iaf, const float* __restrict__ jaf,
              const float* __restrict__ mask, const float* __restrict__ rhs,
              const float* __restrict__ eps, float* __restrict__ out,
              int n_chains, int K, int n_iters, MixParams mix) {
  constexpr int S = 32 * R;
  extern __shared__ float4 smem4[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n = blockIdx.x * (blockDim.x >> 5) + warp;
  if (n >= n_chains) return;
  float* m_s = reinterpret_cast<float*>(smem4) + warp * warp_floats(K, R);
  float* ia_s = m_s + S;  // then the search direction's two buffers
  float* ja_s = m_s + 2 * S;
  float* A = m_s + 3 * S;
  const int st = row_stride(K);

  const size_t base = (size_t)n * K;
  float m[R], rh[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = lane + 32 * r;
    const bool active = i < K;
    m[r] = active ? mask[base + i] : 0.0f;
    rh[r] = active ? rhs[base + i] : 0.0f;
    m_s[i] = m[r];
    ia_s[i] = active ? iaf[base + i] : 0.0f;
    ja_s[i] = active ? jaf[base + i] : 0.0f;
  }
  const float e_ = eps[n];
  const float q0 = mix.q[0], q1 = mix.q[1], q2 = mix.q[2];
  __syncwarp();

  // ---- the masked system: entry t of the upper triangle (i <= j, by
  // ---- columns) at lane t % 32, kBuild entries a lane at once; mirrored
  const int T = K * (K + 1) / 2;
  for (int t0 = 0; t0 < T; t0 += 32 * kBuild) {
    int ii[kBuild], jj[kBuild];
    float h2[kBuild], S_[kBuild];
#pragma unroll
    for (int e = 0; e < kBuild; ++e) {
      const int t = min(t0 + 32 * e + lane, T - 1);
      int j = (int)((sqrtf(8.0f * t + 1.0f) - 1.0f) * 0.5f);
      int first = j * (j + 1) / 2;  // column j's first entry
      if (first > t) {
        first -= j;
        --j;
      } else if (t - first > j) {
        ++j;
        first += j;
      }
      ii[e] = t - first;
      jj[e] = j;
      const float dif = ia_s[ii[e]] - ia_s[j];
      const float djf = ja_s[ii[e]] - ja_s[j];
      h2[e] = q0 * djf * djf + q1 * djf * dif + q2 * dif * dif;
    }
    mixture(mix, h2, S_);
#pragma unroll
    for (int e = 0; e < kBuild; ++e) {
      if (t0 + 32 * e + lane >= T) continue;
      const int i = ii[e], j = jj[e];
      float a = S_[e] * m_s[i] * m_s[j];
      if (i == j) {
        a = a + (e_ + (1.0f - m_s[j]));
      } else {
        A[j * st + i] = a;
      }
      A[i * st + j] = a;
    }
  }
  __syncwarp();

  float x[R];
  cg_iterate<R>(A, ia_s, K, m, rh, n_iters, x);
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int row = lane + 32 * r;
    if (row < K) out[base + row] = x[r] * m[r];
  }
}

template <int R>
__global__ void __launch_bounds__(32 * kMaxChainsPerCta)
masked_cg_kernel(const float* __restrict__ sigma,
                 const float* __restrict__ mask,
                 const float* __restrict__ rhs,
                 const float* __restrict__ eps, float* __restrict__ out,
                 int n_chains, int K, int n_iters) {
  constexpr int S = 32 * R;
  extern __shared__ float4 smem4[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n = blockIdx.x * (blockDim.x >> 5) + warp;
  if (n >= n_chains) return;
  float* m_s = reinterpret_cast<float*>(smem4) + warp * warp_floats(K, R);
  float* A = m_s + 3 * S;
  const int st = row_stride(K);

  // ---- Sigma row j into column j, every copy in flight at once ----------
  const float* Sg = sigma + (size_t)n * K * K;
  for (int j = 0; j < K; ++j) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int c = lane + 32 * r;
      if (c < K) {
        const unsigned dst =
            (unsigned)__cvta_generic_to_shared(A + c * st + j);
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
                     "l"(__cvta_generic_to_global(Sg + j * K + c)));
      }
    }
  }
  const size_t base = (size_t)n * K;
  float m[R], rh[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = lane + 32 * r;
    const bool active = i < K;
    m[r] = active ? mask[base + i] : 0.0f;
    rh[r] = active ? rhs[base + i] : 0.0f;
    m_s[i] = m[r];
  }
  const float e = eps[n];
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncwarp();

  // ---- the masked system (_masked_system), 8 rows of Sigma at a time ---
  for (int j0 = 0; j0 < K; j0 += 8) {
    float v[8][R], mj[8];
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const int j = min(j0 + jj, K - 1);
      mj[jj] = m_s[j];
#pragma unroll
      for (int r = 0; r < R; ++r)
        v[jj][r] = A[min(lane + 32 * r, K - 1) * st + j];
    }
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const int j = j0 + jj;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int c = lane + 32 * r;
        if (j < K && c < K) {
          float a = v[jj][r] * mj[jj] * m[r];
          if (c == j) a = a + (e + (1.0f - m[r]));
          A[c * st + j] = a;
        }
      }
    }
  }
  __syncwarp();

  float x[R];
  cg_iterate<R>(A, m_s + S, K, m, rh, n_iters, x);
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int row = lane + 32 * r;
    if (row < K) out[base + row] = x[r] * m[r];
  }
}

template <int R>
const void* kernel_of(int mix) {
  return mix ? (const void*)mix_cg_kernel<R>
             : (const void*)masked_cg_kernel<R>;
}

// The kernel for ``mix`` (1: mixture system, 0: given Sigma) at R slots.
const void* kernel_for(int mix, int R) {
  switch (R) {
    case 1: return kernel_of<1>(mix);
    case 2: return kernel_of<2>(mix);
    case 3: return kernel_of<3>(mix);
    case 4: return kernel_of<4>(mix);
    case 5: return kernel_of<5>(mix);
    case 6: return kernel_of<6>(mix);
    case 7: return kernel_of<7>(mix);
    case 8: return kernel_of<8>(mix);
    default: return nullptr;
  }
}

int slots(int K) { return (K + 31) / 32; }

// The largest K whose one-chain CTA fits the current card's opt-in shared
// memory, and that opt-in size.
cudaError_t card_limits(int* max_k, int* optin) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev);
  if (e != cudaSuccess) return e;
  *max_k = 0;
  for (int K = 1; K <= 32 * kMaxSlots; ++K)
    if ((long)warp_floats(K, slots(K)) * 4 <= *optin) *max_k = K;
  return cudaSuccess;
}

// The launch at K on the current card: R slots, chains per CTA (the most,
// of 4, 2 and 1, whose systems fit the default 48 KB; one above that),
// dynamic shared bytes; the opt-in made where those exceed 48 KB.
// cudaErrorInvalidValue for a K the card cannot hold.
cudaError_t launch_config(int mix, int K, int* R, int* cpb, int* smem) {
  int max_k = 0, optin = 0;
  cudaError_t e = card_limits(&max_k, &optin);
  if (e != cudaSuccess) return e;
  if (K < 1 || K > max_k) return cudaErrorInvalidValue;
  *R = slots(K);
  const int per_chain = warp_floats(K, *R) * 4;
  *cpb = kMaxChainsPerCta;
  while (*cpb > 1 && *cpb * per_chain > kDefaultSmem) *cpb >>= 1;
  *smem = *cpb * per_chain;
  if (*smem <= kDefaultSmem) return cudaSuccess;
  return cudaFuncSetAttribute(kernel_for(mix, *R),
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              *smem);
}

cudaError_t launch(int mix, int K, int n_chains, void** args, void* stream) {
  int R = 0, cpb = 0, smem = 0;
  const cudaError_t e = launch_config(mix, K, &R, &cpb, &smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((n_chains + cpb - 1) / cpb), block(32 * cpb);
  return cudaLaunchKernel(kernel_for(mix, R), grid, block, args,
                          (size_t)smem, (cudaStream_t)stream);
}

}  // namespace

extern "C" int mcmc_mix_masked_cg(const void* iaf, const void* jaf,
                                  const void* mask, const void* rhs,
                                  const void* eps, void* out,
                                  const MixParams* mix, int n_chains, int K,
                                  int n_iters, void* stream) {
  if (n_chains <= 0) return 0;
  MixParams p = *mix;
  void* args[] = {(void*)&iaf, (void*)&jaf, (void*)&mask, (void*)&rhs,
                  (void*)&eps, (void*)&out, (void*)&n_chains, (void*)&K,
                  (void*)&n_iters, (void*)&p};
  const cudaError_t e = launch(1, K, n_chains, args, stream);
  const cudaError_t last = cudaGetLastError();  // and clear it
  return (int)(e != cudaSuccess ? e : last);
}

extern "C" int mcmc_masked_cg(const void* sigma, const void* mask,
                              const void* rhs, const void* eps, void* out,
                              int n_chains, int K, int n_iters,
                              void* stream) {
  if (n_chains <= 0) return 0;
  void* args[] = {(void*)&sigma, (void*)&mask, (void*)&rhs, (void*)&eps,
                  (void*)&out, (void*)&n_chains, (void*)&K,
                  (void*)&n_iters};
  const cudaError_t e = launch(0, K, n_chains, args, stream);
  const cudaError_t last = cudaGetLastError();  // and clear it
  return (int)(e != cudaSuccess ? e : last);
}

// The largest K the kernels take on the current card.
extern "C" int mcmc_cg_max_k(int* out) {
  int optin = 0;
  return (int)card_limits(out, &optin);
}

// The launch at K on the current card, ``mix`` choosing the kernel:
// out = [threads a CTA, chains a CTA, dynamic shared bytes, static shared
// bytes, registers a thread, local (spill) bytes a thread, resident CTAs a
// multiprocessor].
extern "C" int mcmc_cg_info(int mix, int K, int* out) {
  int R = 0, cpb = 0, smem = 0;
  cudaError_t e = launch_config(mix, K, &R, &cpb, &smem);
  if (e != cudaSuccess) return (int)e;
  const void* fn = kernel_for(mix, R);
  cudaFuncAttributes attr;
  e = cudaFuncGetAttributes(&attr, fn);
  if (e != cudaSuccess) return (int)e;
  int resident = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, fn, 32 * cpb,
                                                    smem);
  if (e != cudaSuccess) return (int)e;
  out[0] = 32 * cpb;
  out[1] = cpb;
  out[2] = smem;
  out[3] = (int)attr.sharedSizeBytes;
  out[4] = attr.numRegs;
  out[5] = (int)attr.localSizeBytes;
  out[6] = resident;
  return 0;
}

extern "C" const char* mcmc_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
