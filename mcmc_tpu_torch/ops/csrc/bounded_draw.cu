// A T2 chunk's draws on the card: each cell of a chunk drawn from its
// kriging (est, var) and its uniform (or standard normal), and the float32
// score scattered into the grid, in one launch.
//
// The port's own kernel.  It replaces no Pallas kernel: the JAX package
// draws these values on the host with scipy (mcmc_tpu/geostats/sgs.py,
// truncnorm.rvs and Generator.normal), as the port's CPU path still does.
// The plain PyTorch version beside it is mcmc_tpu_torch/ops/
// bounded_draw_kernel.py::bounded_draw_reference, the same algorithm in
// float64 (its docstring gives it in full):
//   sd = max(sqrt(|var|), 1e-12);
//   bounded:   z = lo where lo == hi, else est + sd * ppf(u; a, b),
//              a = (lo - est) / sd, b = (hi - est) / sd;
//   unbounded: z = est + sd * u;
//   grid[i, j] = float32(z), rounded to nearest;
// ppf by scipy 1.17's truncnorm._ppf scheme in log space (log Phi through
// erfcx below -1, the Gaussian mass of [a, b] from the side away from the
// tail), the left case where the quantile lies at or below 0 and the right
// case, the left case of the reflected normal, elsewhere, so that the sum
// in log space never cancels; ndtri_exp(y) as scipy's, normcdfinv(exp(y))
// down to y = -700 and, below, where exp(y) nears the subnormals, kNewton
// Newton steps on log Phi from its asymptote.  CUDA's erfcx, erfc, normcdf,
// normcdfinv, log, log1p, exp and expm1 are not torch's or scipy's, so the
// kernel and the plain version agree to about 1e-15, not bitwise.  Built with
// -fmad=false, est + sd * x rounds the product and the sum apart, as numpy
// does on the host.
//
// Operands: u, lo and hi are (H, W) float64 planes read at the chunk's
// cells (u holds the bed's uniforms, drawn once on the host at the path's
// cells, so a chunk needs no slice of them), cells an (n, 2) int64 array
// of rows and columns, est and var (n,) float32; lo == hi == nullptr
// selects the unbounded draw.
//
// What bounds it on an H100: latency.  A chunk of 64 cells reads 16 B of
// cells, 8 B of (est, var) and 24 B of planes a cell and writes 4 B: 3.3 KB,
// about 1 ns at 3.35 TB/s; its float64 work is a chain of about ten
// dependent special functions a cell (normcdf twice, log1p, log, erfcx,
// exp, normcdfinv) on two warps.  So the design is one thread a cell, one
// CTA of 64 threads a chunk and no shared memory, with every cell on one
// path through the same operations: the quantile's side is chosen first
// from Phi(a) and Phi(-b), which the mass needs anyway, and the right case
// runs as the left case of (1 - q, -b, -a), so a warp whose cells fall on
// both sides of 0 takes no second path; Newton steps only below y = -700.
// (The first design computed the left case, then the right case where its
// x > 0, and polished ndtri_exp by Newton steps below y = -2: every warp
// took both cases and the steps, 48.6 us a launch in a profiled 512^2 bed
// on an H100 SXM at 700 W, a chunk 35 us longer.)  It sits inside the
// captured chunk, after the kriging solve, where it replaces the host's
// wait, scipy's draws and the upload of the draws.
//
// Build (plain C interface, loaded with ctypes):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false \
//        -shared -Xcompiler -fPIC -o libbounded_draw.so bounded_draw.cu

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 64;  // one chunk of 64 cells a CTA
constexpr int kNewton = 3;
constexpr double kSdFloor = 1e-12;
constexpr double kYHigh = -0.14541345786885906;  // log1p(-exp(-2))
constexpr double kYUnderflow = -700.0;
constexpr double kLogSqrt2Pi = 0.91893853320467267;  // log(2 pi) / 2
constexpr double kSqrt2OverPi = 0.79788456080286541;
constexpr double kSqrt1_2 = 0.70710678118654757;

// log Phi(x): erfcx below -1, as torch's and scipy's log_ndtr
__device__ double log_ndtr(double x) {
  const double t = x * kSqrt1_2;
  if (x < -1.0) return log(erfcx(-t) / 2.0) - t * t;
  return log1p(-erfc(t) / 2.0);
}

// log(exp(p) - exp(q)), p >= q
__device__ double log_diff(double p, double q) {
  return p + log1p(-exp(q - p));
}

// log(exp(p) + exp(q))
__device__ double log_sum(double p, double q) {
  const double m = fmax(p, q);
  if (m == -INFINITY) return m;
  return m + log1p(exp(fmin(p, q) - m));
}

// phi(x) / Phi(x), the slope of log Phi, without cancellation
__device__ double phi_over_ndtr(double x, double log_ndtr_x) {
  if (x < -1.0) return kSqrt2OverPi / erfcx(-x * kSqrt1_2);
  return exp(-0.5 * x * x - kLogSqrt2Pi - log_ndtr_x);
}

// the x with log Phi(x) = y, y <= 0
__device__ double ndtri_exp(double y) {
  if (y == -INFINITY) return y;
  if (y > kYHigh) return -normcdfinv(-expm1(y));
  if (y >= kYUnderflow) return normcdfinv(exp(y));
  double x = -sqrt(-2.0 * y - log(-2.0 * y) - 2.0 * kLogSqrt2Pi);
  for (int k = 0; k < kNewton; ++k) {
    const double lp = log_ndtr(x);
    x = x - (lp - y) / phi_over_ndtr(x, lp);
  }
  return x;
}

__device__ double truncnorm_ppf(double q, double a, double b) {
  double mass;
  bool left;  // the quantile lies at or below 0
  if (b <= 0.0) {
    mass = log_diff(log_ndtr(b), log_ndtr(a));
    left = true;
  } else if (a > 0.0) {
    mass = log_diff(log_ndtr(-a), log_ndtr(-b));
    left = false;
  } else {
    const double pa = normcdf(a), pb = normcdf(-b);
    mass = log1p(-pa - pb);
    left = q * (1.0 - pa - pb) <= 0.5 - pa;  // F(0) >= q
  }
  // the right case: the left case of (1 - q, -b, -a), negated
  const double x = ndtri_exp(log_sum(log_ndtr(left ? a : -b),
                                     (left ? log(q) : log1p(-q)) + mass));
  return left ? x : -x;
}

__global__ void __launch_bounds__(kThreads)
bounded_draw_kernel(float* __restrict__ grid, long long width,
                    const long long* __restrict__ cells,
                    const float* __restrict__ est,
                    const float* __restrict__ var,
                    const double* __restrict__ u,
                    const double* __restrict__ lo,
                    const double* __restrict__ hi, int n) {
  const int t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= n) return;
  const long long cell = cells[2 * t] * width + cells[2 * t + 1];
  const double e = (double)est[t];
  double sd = sqrt(fabs((double)var[t]));
  sd = sd < kSdFloor ? kSdFloor : sd;  // a NaN stays NaN, as numpy's
  double z;
  if (lo == nullptr) {
    z = e + sd * u[cell];
  } else {
    const double l = lo[cell], h = hi[cell];
    z = l == h ? l : e + sd * truncnorm_ppf(u[cell], (l - e) / sd,
                                            (h - e) / sd);
  }
  grid[cell] = __double2float_rn(z);
}

// the quantile function alone, in float64: the tests' probe of ppf
__global__ void __launch_bounds__(kThreads)
ppf_kernel(const double* __restrict__ q, const double* __restrict__ a,
           const double* __restrict__ b, double* __restrict__ out, int n) {
  const int t = blockIdx.x * kThreads + threadIdx.x;
  if (t < n) out[t] = truncnorm_ppf(q[t], a[t], b[t]);
}

}  // namespace

extern "C" int mcmc_bounded_draw(void* grid, long long width,
                                 const void* cells, const void* est,
                                 const void* var, const void* u,
                                 const void* lo, const void* hi, int n,
                                 void* stream) {
  if (n <= 0) return 0;
  if ((lo == nullptr) != (hi == nullptr)) return (int)cudaErrorInvalidValue;
  const int blocks = (n + kThreads - 1) / kThreads;
  bounded_draw_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (float*)grid, width, (const long long*)cells, (const float*)est,
      (const float*)var, (const double*)u, (const double*)lo,
      (const double*)hi, n);
  return (int)cudaGetLastError();
}

extern "C" int mcmc_truncnorm_ppf(const void* q, const void* a,
                                  const void* b, void* out, int n,
                                  void* stream) {
  if (n <= 0) return 0;
  ppf_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
               (cudaStream_t)stream>>>((const double*)q, (const double*)a,
                                       (const double*)b, (double*)out, n);
  return (int)cudaGetLastError();
}

extern "C" const char* mcmc_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
