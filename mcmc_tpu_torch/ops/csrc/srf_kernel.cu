// The gstools-SRF proposal's harmonic sum, batched over chains:
//
//   out[c, i, k] = sqrt(1/M) * (sum_m z1[c,m] cos(phi) + z2[c,m] sin(phi)),
//   phi = y_i * ky[c,m] + x_k * kx[c,m],  x_k = k * res, y_i = i * res,
//
// for kv (n, 2, M) [kx; ky], z1 and z2 (n, M), out (n, ny, nx), all
// float32.  It replaces the XLA ops of mcmc_tpu/ops/srf.py:114-123
// (srf_field: a (ny, nx, M) phase tensor, cos, sin and two tensordots);
// there is no Pallas kernel at that site, so this is the port's own
// kernel, like chain_draws.cu.  Its plain PyTorch version is
// mcmc_tpu_torch/ops/srf_kernel.py::srf_harmonics_reference.
//
// The separable product.  With a = fl(x_k kx_m) and b = fl(y_i ky_m),
// the phase's two products each rounded to float32 as the JAX package
// rounds them,
//
//   z1 cos(a+b) + z2 sin(a+b) = cos a (z1 cos b + z2 sin b)
//                             + sin a (z2 cos b - z1 sin b),
//
// so a chain's field is one matrix product, F = norm * L R^T, with
// L (ny x 2M) = [z1 cos b + z2 sin b | z2 cos b - z1 sin b] and
// R (nx x 2M) = [cos a | sin a].  A chain takes (ny + nx) M sincosf
// instead of ny nx M (40x fewer at the CRF headline, 768 chains x 80 x 80,
// M = 1000), and the product's 4 operations a term run on the tensor
// cores.
//
// What bounds it on an H100: operations.  The launch reads 16 M bytes a
// chain and writes 4 ny nx (32 MB at the headline: ~0.01 ms at 3.35
// TB/s).  The product in 3xTF32 is 3 x 2 x ny nx 2M operations a chain,
// 59 G at the headline: 0.119 ms at 495 TFLOP/s (the direct form's 4
// float32 operations a term at 67 TFLOP/s: 0.293 ms); beside it, 1.23e8
// accurate sincosf pairs on the CUDA cores.
//
// The design:
//   - one CTA per (chain, T x T output tile): the chain in blockIdx.y,
//     the tile in blockIdx.x; stores past the grid are masked.  The
//     modes go in chunks of kModes = 16, double-buffered in shared
//     memory, one __syncthreads a chunk: the threads build chunk c + 1
//     in one buffer while the warps multiply chunk c from the other;
//   - the modes: chunk c's kx, ky, z1 and z2 (256 bytes) are copied
//     into one of three shared slots with cp.async two chunks ahead, so
//     no thread waits on a global load in the chunk loop;
//   - the build: each of the tile's 2T rows is built by R threads,
//     kModes / R modes each, from the slot (16-byte broadcast reads).
//     A row i of L (grid row row0 + i): b, sincosf(b), then z1 and z2
//     folded into L's two columns; a row k of R (grid column col0 + k):
//     a, sincosf(a), then cos a and sin a split into TF32 hi and lo
//     (three planes: L, R hi, R lo).  Rows are stored as float4s at a
//     stride of 36 floats, conflict-free.  TF32 rounding is two integer
//     operations, the bits cvt.rna.tf32.f32 gives;
//   - the product: (T / 16) x R warps, warp w an m16 row tile and T / R
//     columns as m16n8 accumulator tiles.  For each k8 step it splits
//     its A fragment (L) into TF32 hi and lo and issues mma.sync.m16n8k8
//     three times a tile: lo*hi, hi*lo, then hi*hi (3xTF32: a product
//     keeps ~2^-21 of its value, against ~2^-11 for one TF32 product);
//   - a chunk's 32 k columns sum in the tensor core from 0, and the
//     chunk's partial is added to the float32 accumulators with one
//     round-to-nearest add: the tensor core's own additions truncate,
//     and over 250 k8 steps of a running sum their bias toward zero
//     could reach ~1e-5 of the unit-variance field (an estimate);
//   - the launch depends on (ny, nx) alone, never on the number of
//     chains: T = 80, R = 2 when the grid fits one tile (the farm's
//     canvas: one CTA of 320 threads a chain, 2 resident an SM), else
//     T = 32, R = 4 (a 512 x 512 field: 256 CTAs of 256 threads), as
//     measured against T in {16, 32, 48, 80} and R in {1, 2, 4} on an
//     H100.  ab_srf_kernel.py times the kernel with the build or the
//     product cut out: they overlap little within a CTA, and producer
//     and consumer warps over a ring of chunks measured slower, the
//     build then short of warps.
//
// Rounding.  The phase's products are rounded apart (__fmul_rn; the
// library is built with -fmad=false); sincosf is CUDA's accurate form
// (not __sincosf), whose slow path the Exponential's ~1e8-rad tail takes
// only (ny + nx) M times a chain.  The kernel never rounds a + b, so it
// is not the plain version's field, which rounds the phase first: it
// approximates the field on the unrounded a + b
// (mcmc_tpu_torch/testing.py::srf_separable_float64) to the 3xTF32
// products', the sincosf's and the sums' float32 rounding, ~1e-6 of the
// field; and it departs from the plain version by at most the phase
// rounding's own effect, sum_m (|z1| + |z2|) |fl(a + b) - (a + b)| times
// norm, cell by cell (testing.py::srf_rounding_bound: |cos u - cos v|
// <= |u - v|), plus that.  A cell's sums run in one fixed order set by
// (ny, nx, M) alone, with no atomics and no split over CTAs, so a
// chain's field has the same bits alone and in any batch.
//
// Build (plain C interface, loaded with ctypes):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false \
//        -shared -Xcompiler -fPIC -o libsrf_kernel.so srf_kernel.cu

#include <cuda_runtime.h>
#include <initializer_list>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kModes = 16;          // modes a chunk
constexpr int kCols = 2 * kModes;   // k columns a chunk: cos, then sin parts
constexpr int kLd = kCols + 4;      // shared row stride in floats
constexpr int kSlot = 4 * kModes;   // a chunk's kx, ky, z1, z2 in shared
constexpr int kSlots = 3;           // chunks of modes staged ahead
constexpr int kMaxDevices = 64;

// A T x T output tile, each of its 2T rows of L and R built by R threads
// (kModes / R modes each), its product by (T / 16) x R warps (an m16 row
// tile and T / R columns each).
template <int T, int R>
struct Tile {
  static constexpr int kRowTiles = T / 16;
  static constexpr int kWarps = kRowTiles * R;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kSlice = kModes / R;  // modes a thread builds
  static constexpr int kNTiles = T / (8 * R);  // n8 tiles of a warp
  static constexpr int kPlane = T * kLd;    // floats of L, R hi or R lo
  static constexpr int kBuffer = 3 * kPlane;
  static constexpr size_t kSmem =
      (2 * kBuffer + kSlots * kSlot) * sizeof(float);
  static constexpr int kMinCtas = 2;  // resident a multiprocessor
  static_assert(T % 16 == 0 && kThreads == 2 * T * R, "tile side");
  static_assert(kSlice % 4 == 0 && T % (8 * R) == 0, "threads a row");
};

// v rounded to TF32 (10 mantissa bits), to nearest with ties away from
// zero, as cvt.rna.tf32.f32 rounds a finite v, in two integer operations
__device__ __forceinline__ uint32_t to_tf32(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
}

// hi = tf32(v), lo = tf32(v - hi): v - hi is exact in float32
__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(v);
  lo = to_tf32(__fsub_rn(v, __uint_as_float(hi)));
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Start copying the modes [m0, m0 + kModes) of kx, ky, z1 and z2 into
// slot (cp.async, one group a thread; modes past n_modes are zeros).
__device__ __forceinline__ void stage_modes(float* slot, const float* kx,
                                            const float* ky, const float* z1,
                                            const float* z2, int m0,
                                            int n_modes) {
  const int t = threadIdx.x;
  if (t < kSlot) {
    const int m = m0 + t % kModes;
    const float* src = t < kModes       ? kx
                       : t < 2 * kModes ? ky
                       : t < 3 * kModes ? z1
                                        : z2;
    const int bytes = m < n_modes ? 4 : 0;
    const uint32_t dst = (uint32_t)__cvta_generic_to_shared(slot + t);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;"
                 :: "r"(dst), "l"(bytes ? src + m : src), "r"(bytes)
                 : "memory");
  }
  asm volatile("cp.async.commit_group;" ::: "memory");
}

__device__ __forceinline__ void wait_modes() {
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}

// One chunk of modes into buf from its slot.  Thread t builds row t % 2T,
// modes kSlice * (t / 2T) onward: rows r < T are L's, grid row row0 + r;
// rows T + r are R's, grid column col0 + r.  Zero modes (past n_modes)
// give L = 0 and R = (1, 0).
template <int T, int R>
__device__ __forceinline__ void produce(float* buf, const float* slot,
                                        int row0, int col0, float res) {
  using C = Tile<T, R>;
  const int t = threadIdx.x % (2 * T);
  const int first_mode = C::kSlice * (threadIdx.x / (2 * T));
  const bool left = t < T;
  const int r = left ? t : t - T;
  const float pos = __fmul_rn((float)(left ? row0 + r : col0 + r), res);
  const float* k = slot + (left ? kModes : 0);
#pragma unroll 1
  for (int q = first_mode; q < first_mode + C::kSlice; q += 4) {
    const float4 k4 = *reinterpret_cast<const float4*>(k + q);
    const float4 z14 = *reinterpret_cast<const float4*>(slot + 2 * kModes + q);
    const float4 z24 = *reinterpret_cast<const float4*>(slot + 3 * kModes + q);
    const float km[4] = {k4.x, k4.y, k4.z, k4.w};
    const float u[4] = {z14.x, z14.y, z14.z, z14.w};
    const float v[4] = {z24.x, z24.y, z24.z, z24.w};
    float first[4], second[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float s, c;
      sincosf(__fmul_rn(pos, km[j]), &s, &c);
      // L: (z1 c + z2 s, z2 c - z1 s); R (u, v = 1, 0): (c, -s)
      const float uj = left ? u[j] : 1.0f, vj = left ? v[j] : 0.0f;
      first[j] = __fadd_rn(__fmul_rn(uj, c), __fmul_rn(vj, s));
      second[j] = __fsub_rn(__fmul_rn(vj, c), __fmul_rn(uj, s));
    }
    if (left) {
      float* row = buf + r * kLd + q;
      *reinterpret_cast<float4*>(row) =
          make_float4(first[0], first[1], first[2], first[3]);
      *reinterpret_cast<float4*>(row + kModes) =
          make_float4(second[0], second[1], second[2], second[3]);
    } else {
      uint32_t ch[4], cl[4], sh[4], sl[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        split(first[j], ch[j], cl[j]);
        split(-second[j], sh[j], sl[j]);
      }
      float* hi = buf + C::kPlane + r * kLd + q;
      float* lo = hi + C::kPlane;
      *reinterpret_cast<uint4*>(hi) = make_uint4(ch[0], ch[1], ch[2], ch[3]);
      *reinterpret_cast<uint4*>(hi + kModes) =
          make_uint4(sh[0], sh[1], sh[2], sh[3]);
      *reinterpret_cast<uint4*>(lo) = make_uint4(cl[0], cl[1], cl[2], cl[3]);
      *reinterpret_cast<uint4*>(lo + kModes) =
          make_uint4(sl[0], sl[1], sl[2], sl[3]);
    }
  }
}

// The chunk's product from buf into acc: warp w's rows 16 (w % (T / 16))
// onward against its T / R columns, T / R (w / (T / 16)) onward, in 3xTF32
// from a zero partial, then one rounded add a value.  Fragments as the
// PTX ISA lays out m16n8k8 tf32: g = lane / 4, q = lane % 4; A (row g or
// g + 8, col q or q + 4), B (row q or q + 4, col g), C (row g or g + 8,
// col 2q or 2q + 1).
template <int T, int R>
__device__ __forceinline__ void consume(
    const float* buf, float (&acc)[Tile<T, R>::kNTiles][4]) {
  using C = Tile<T, R>;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int rows = 16 * (warp % C::kRowTiles);
  const int cols = (T / R) * (warp / C::kRowTiles);
  const float* a_base = buf + (rows + g) * kLd + q;
  const uint32_t* b_hi = reinterpret_cast<const uint32_t*>(
      buf + C::kPlane + (cols + g) * kLd + q);
  const uint32_t* b_lo = b_hi + C::kPlane;
  float part[C::kNTiles][4];
#pragma unroll
  for (int j = 0; j < C::kNTiles; ++j)
    part[j][0] = part[j][1] = part[j][2] = part[j][3] = 0.0f;
#pragma unroll
  for (int s = 0; s < kCols / 8; ++s) {
    const float* a = a_base + 8 * s;
    uint32_t a_hi[4], a_lo[4];
    split(a[0], a_hi[0], a_lo[0]);
    split(a[8 * kLd], a_hi[1], a_lo[1]);
    split(a[4], a_hi[2], a_lo[2]);
    split(a[8 * kLd + 4], a_hi[3], a_lo[3]);
#pragma unroll
    for (int j = 0; j < C::kNTiles; ++j) {
      const int off = 8 * j * kLd + 8 * s;
      const uint32_t h0 = b_hi[off], h1 = b_hi[off + 4];
      const uint32_t l0 = b_lo[off], l1 = b_lo[off + 4];
      mma(part[j], a_lo, h0, h1);
      mma(part[j], a_hi, l0, l1);
      mma(part[j], a_hi, h0, h1);
    }
  }
#pragma unroll
  for (int j = 0; j < C::kNTiles; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = __fadd_rn(acc[j][e], part[j][e]);
}

template <int T, int R>
__global__ void __launch_bounds__(Tile<T, R>::kThreads, Tile<T, R>::kMinCtas)
srf_kernel(const float* __restrict__ kv, const float* __restrict__ z1,
           const float* __restrict__ z2, float* __restrict__ out,
           int n_modes, int ny, int nx, int tiles_x, float res, float norm) {
  using C = Tile<T, R>;
  extern __shared__ __align__(16) float smem[];
  const int chain = blockIdx.y;
  const int row0 = (blockIdx.x / tiles_x) * T;
  const int col0 = (blockIdx.x % tiles_x) * T;
  const float* kx = kv + (size_t)chain * 2 * n_modes;
  const float* ky = kx + n_modes;
  const float* a = z1 + (size_t)chain * n_modes;
  const float* b = z2 + (size_t)chain * n_modes;

  float acc[C::kNTiles][4];
#pragma unroll
  for (int j = 0; j < C::kNTiles; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;

  // chunk c's modes in slot c % kSlots, copied two chunks ahead
  float* slots = smem + 2 * C::kBuffer;
  const int chunks = (n_modes + kModes - 1) / kModes;
  stage_modes(slots, kx, ky, a, b, 0, n_modes);
  stage_modes(slots + kSlot, kx, ky, a, b, kModes, n_modes);
  wait_modes();
  __syncthreads();
  produce<T, R>(smem, slots, row0, col0, res);
  __syncthreads();
  for (int c = 0; c < chunks; ++c) {
    if (c + 2 < chunks)
      stage_modes(slots + (c + 2) % kSlots * kSlot, kx, ky, a, b,
                  (c + 2) * kModes, n_modes);
    if (c + 1 < chunks)
      produce<T, R>(smem + ((c + 1) & 1) * C::kBuffer,
                    slots + (c + 1) % kSlots * kSlot, row0, col0, res);
    consume<T, R>(smem + (c & 1) * C::kBuffer, acc);
    wait_modes();
    __syncthreads();
  }

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int i0 = row0 + 16 * (warp % C::kRowTiles) + g;
  const int k0 = col0 + (T / R) * (warp / C::kRowTiles) + 2 * q;
  float* dst = out + (size_t)chain * ny * nx;
#pragma unroll
  for (int j = 0; j < C::kNTiles; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = i0 + (e >> 1) * 8, k = k0 + 8 * j + (e & 1);
      if (i < ny && k < nx)
        dst[(size_t)i * nx + k] = __fmul_rn(acc[j][e], norm);
    }
}

// A kernel of the family and its launch shape.
struct Variant {
  const void* fn;
  int tile, threads;
  size_t smem;
};

template <int T, int R>
Variant variant() {
  return {reinterpret_cast<const void*>(srf_kernel<T, R>), T,
          Tile<T, R>::kThreads, Tile<T, R>::kSmem};
}

// The two launches (module note): a grid within one 80 x 80 tile, and a
// larger one.  The choice depends on the grid alone, never on the number
// of chains.
Variant one_tile() { return variant<80, 2>(); }
Variant many_tiles() { return variant<32, 4>(); }
Variant pick(int ny, int nx) {
  return (ny <= 80 && nx <= 80) ? one_tile() : many_tiles();
}

// Above 48 KB of dynamic shared memory a kernel must opt in: both, once
// a device.
cudaError_t opt_in() {
  static bool done[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < kMaxDevices && done[dev])) return err;
  for (const Variant& v : {one_tile(), many_tiles()}) {
    err = cudaFuncSetAttribute(
        v.fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)v.smem);
    if (err != cudaSuccess) return err;
  }
  if (dev < kMaxDevices) done[dev] = true;
  return cudaSuccess;
}

cudaError_t launch(const Variant& v, const float* kv, const float* z1,
                   const float* z2, float* out, int n_chains, int n_modes,
                   int ny, int nx, float res, float norm,
                   cudaStream_t stream) {
  cudaError_t err = opt_in();
  if (err != cudaSuccess) return err;
  int tiles_x = (nx + v.tile - 1) / v.tile;
  const dim3 grid(((ny + v.tile - 1) / v.tile) * tiles_x, n_chains);
  void* args[] = {&kv, &z1, &z2, &out, &n_modes, &ny, &nx, &tiles_x, &res,
                  &norm};
  return cudaLaunchKernel(v.fn, grid, dim3(v.threads), args, v.smem, stream);
}

cudaError_t info(const Variant& v, int* out) {
  cudaError_t err = opt_in();
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, v.fn);
  if (err != cudaSuccess) return err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, v.fn,
                                                      v.threads, v.smem);
  if (err != cudaSuccess) return err;
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  out[2] = blocks;
  out[3] = (int)v.smem;
  out[4] = v.tile;
  out[5] = v.threads;
  return cudaSuccess;
}

}  // namespace

// (n_chains, ny, nx) float32 fields into out from kv (n_chains, 2, n_modes)
// and z1, z2 (n_chains, n_modes); norm = sqrt(1 / n_modes) in float32.
// The caller keeps n_chains <= 65535 and ny * nx < 2^31.
extern "C" int mcmc_srf_harmonics(const void* kv, const void* z1,
                                  const void* z2, void* out, int n_chains,
                                  int n_modes, int ny, int nx, float res,
                                  float norm, void* stream) {
  if (n_chains <= 0 || ny <= 0 || nx <= 0) return 0;
  if (n_modes <= 0 || n_chains > 65535) return (int)cudaErrorInvalidValue;
  return (int)launch(pick(ny, nx), (const float*)kv, (const float*)z1,
                     (const float*)z2, (float*)out, n_chains, n_modes, ny,
                     nx, res, norm, (cudaStream_t)stream);
}

// The launch a (ny, nx) grid takes: registers and local (spill) bytes a
// thread, resident CTAs a multiprocessor, dynamic shared bytes a CTA, the
// tile side and threads a CTA: out[0] .. out[5].
extern "C" int mcmc_srf_kernel_info(int ny, int nx, int* out) {
  return (int)info(pick(ny, nx), out);
}

extern "C" const char* mcmc_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
