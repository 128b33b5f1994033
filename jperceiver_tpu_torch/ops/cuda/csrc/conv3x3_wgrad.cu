// 3x3 stride-1 convolution weight-gradient (kernel K4), hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `jperceiver_tpu/ops/pallas/conv3x3.py::_wgrad_kernel`
// (a (9C, O) fp32 accumulator held in VMEM across a sequential grid of row strips, nine
// tap^T . g dots a strip). The function is that file's `_wgrad`:
//   dW[tap, c, o] = sum over pixels m of x_pad[m shifted by tap, c] * g[m, o],
// with operands in their input dtype (bf16 or fp32) and fp32 accumulation; taps that
// fall in the zero padding contribute nothing.
//
// Layout: channels-last. x is (B, H, W, C), g is (B, Ho, Wo, O); C and O are multiples of
// 64 (the wrapper zero-pads them). The result is (9, C, O) fp32, tap = ky*3 + kx.
//
// Design: a GEMM with a long reduction. The output is small (9C x O) while the reduction
// runs over M = B*Ho*Wo pixels (65,536 at the 256^2 sites), and on Hopper the blocks run in
// parallel, in no order -- nothing carries over between them as the TPU grid's VMEM
// accumulator did. So M is split: block (c-tile, o-tile, tap, split) computes a 64x64 tile
// of one tap over one range of pixels and writes it to its own fp32 partial buffer; a
// second pass sums the partials in a fixed order. No atomics, so the result is the same
// from run to run. The A tile (32 pixels x 64 channels of the shifted input) is gathered
// straight from the activation with `cp.async`, zero-filled in the padding; two stages
// overlap the next step's copies with this step's products.
//   * bf16: four warps, each a 32x32 slab, WMMA 16x16x16 bf16 fragments, fp32 accumulators.
//   * fp32: a 64x64 tile on the CUDA cores, 4x4 outputs a thread (the tensor cores would
//     round fp32 to TF32, which the contract does not allow).
// Bound on this card: 2*9*C*O*M operations against one read of x and g; at C = O = 64 and
// above that is well over the H100's ~295 bf16 operations per byte, so the tensor cores
// bound it. This first version has no wgmma or TMA; its time is recorded in PERF.md.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

#include "cp_async.cuh"

namespace {

constexpr int TILE = 64;  // c rows and o columns of a block's tile

// Where the input pixel that pixel m of the output reads through one tap lies.
__device__ __forceinline__ bool tap_source(int m, int m_end, int Ho, int Wo, int H, int W,
                                           int ky, int kx, int pad, size_t* pix) {
  if (m >= m_end) return false;
  const int ox = m % Wo;
  const int t = m / Wo;
  const int oy = t % Ho;
  const int b = t / Ho;
  const int iy = oy + ky - pad, ix = ox + kx - pad;
  if (iy < 0 || iy >= H || ix < 0 || ix >= W) return false;
  *pix = ((size_t)b * H + iy) * W + ix;
  return true;
}

namespace bf16k {

constexpr int BK = 32, THREADS = 128;
constexpr int LD = TILE + 8;  // 72 elements = 144 bytes a row
constexpr int STAGE = BK * LD;

__global__ void __launch_bounds__(THREADS)
wgrad_bf16(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ g,
           float* __restrict__ partial, int B, int H, int W, int C, int O, int Ho, int Wo,
           int pad, int chunk) {
  using namespace nvcuda;
  __shared__ __align__(128) __nv_bfloat16 As[2 * STAGE];  // [stage][m][c]
  __shared__ __align__(128) __nv_bfloat16 Bs[2 * STAGE];  // [stage][m][o]

  const int tid = threadIdx.x, warp = tid >> 5;
  const int warp_c = warp >> 1, warp_o = warp & 1;
  const int c0 = blockIdx.x * TILE, o0 = blockIdx.y * TILE;
  const int tap = blockIdx.z % 9, split = blockIdx.z / 9;
  const int ky = tap / 3, kx = tap - ky * 3;
  const int M = B * Ho * Wo;
  const int m_begin = split * chunk;
  const int m_end = min(M, m_begin + chunk);
  const int steps = (m_end - m_begin + BK - 1) / BK;

  // Thread tid moves 32 bytes (two chunks) of row tid/4 of each tile.
  const int lrow = tid >> 2, lcol = (tid & 3) * 16;

  auto load_stage = [&](int stage, int step) {
    const int m = m_begin + step * BK + lrow;
    size_t pix = 0;
    const bool in = tap_source(m, m_end, Ho, Wo, H, W, ky, kx, pad, &pix);
    const __nv_bfloat16* src = in ? x + pix * C + c0 + lcol : x;
    __nv_bfloat16* dst = As + stage * STAGE + lrow * LD + lcol;
    cp_async16(dst, src, in);
    cp_async16(dst + 8, in ? src + 8 : x, in);
    const bool gin = m < m_end;
    const __nv_bfloat16* gsrc = gin ? g + (size_t)m * O + o0 + lcol : g;
    __nv_bfloat16* gdst = Bs + stage * STAGE + lrow * LD + lcol;
    cp_async16(gdst, gsrc, gin);
    cp_async16(gdst + 8, gin ? gsrc + 8 : g, gin);
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  if (steps > 0) load_stage(0, 0);
  cp_async_commit();
  for (int s = 0; s < steps; ++s) {
    if (s + 1 < steps) load_stage((s + 1) & 1, s + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const __nv_bfloat16* a = As + (s & 1) * STAGE + warp_c * 32;
    const __nv_bfloat16* bm = Bs + (s & 1) * STAGE + warp_o * 32;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      // A = x^T: element (c, m) sits at a[m * LD + c], a column-major fragment.
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::col_major> af[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bf[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) wmma::load_matrix_sync(af[i], a + kk * LD + i * 16, LD);
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::load_matrix_sync(bf[j], bm + kk * LD + j * 16, LD);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], af[i], bf[j], acc[i][j]);
    }
    __syncthreads();
  }
  cp_async_wait<0>();

  float* out = partial + ((size_t)(split * 9 + tap) * C + c0 + warp_c * 32) * O + o0 + warp_o * 32;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(out + (size_t)i * 16 * O + j * 16, acc[i][j], O, wmma::mem_row_major);
}

}  // namespace bf16k

namespace f32k {

constexpr int BK = 16, THREADS = 256;
constexpr int LD = TILE + 4;
constexpr int STAGE = BK * LD;

__global__ void __launch_bounds__(THREADS)
wgrad_f32(const float* __restrict__ x, const float* __restrict__ g, float* __restrict__ partial,
          int B, int H, int W, int C, int O, int Ho, int Wo, int pad, int chunk) {
  __shared__ __align__(16) float As[2 * STAGE];  // [stage][m][c]
  __shared__ __align__(16) float Bs[2 * STAGE];  // [stage][m][o]

  const int tid = threadIdx.x;
  const int c0 = blockIdx.x * TILE, o0 = blockIdx.y * TILE;
  const int tap = blockIdx.z % 9, split = blockIdx.z / 9;
  const int ky = tap / 3, kx = tap - ky * 3;
  const int M = B * Ho * Wo;
  const int m_begin = split * chunk;
  const int m_end = min(M, m_begin + chunk);
  const int steps = (m_end - m_begin + BK - 1) / BK;

  // Thread tid moves chunk (tid & 15) of row tid/16 of each tile.
  const int lrow = tid >> 4, lcol = (tid & 15) * 4;

  auto load_stage = [&](int stage, int step) {
    const int m = m_begin + step * BK + lrow;
    size_t pix = 0;
    const bool in = tap_source(m, m_end, Ho, Wo, H, W, ky, kx, pad, &pix);
    cp_async16(As + stage * STAGE + lrow * LD + lcol, in ? x + pix * C + c0 + lcol : x, in);
    const bool gin = m < m_end;
    cp_async16(Bs + stage * STAGE + lrow * LD + lcol, gin ? g + (size_t)m * O + o0 + lcol : g,
               gin);
  };

  // Outputs: rows tc + 16*i, cols to + 16*j.
  const int tc = tid >> 4, to = tid & 15;
  // Blocked fp32 sums: one step's products go into `part`, 16 steps' into `mid`, the rest
  // into `acc`. Summed straight into one register, a dot product of 9C or M terms loses
  // precision in proportion to its length, and train-mode BatchNorm downstream turns that
  // into gradient error.
  float acc[4][4], mid[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = mid[i][j] = 0.0f;

  if (steps > 0) load_stage(0, 0);
  cp_async_commit();
  for (int s = 0; s < steps; ++s) {
    if (s + 1 < steps) load_stage((s + 1) & 1, s + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const float* a = As + (s & 1) * STAGE;
    const float* bm = Bs + (s & 1) * STAGE;
    float part[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) part[i][j] = 0.0f;
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = a[k * LD + tc + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = bm[k * LD + to + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) part[i][j] = fmaf(av[i], bv[j], part[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) mid[i][j] += part[i][j];
    if ((s & 15) == 15) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc[i][j] += mid[i][j];
          mid[i][j] = 0.0f;
        }
    }
    __syncthreads();
  }
  cp_async_wait<0>();
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] += mid[i][j];

  float* out = partial + ((size_t)(split * 9 + tap) * C + c0) * O + o0;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) out[(size_t)(tc + 16 * i) * O + to + 16 * j] = acc[i][j];
}

}  // namespace f32k

// out[i] = sum over splits s, in order, of partial[s][i].
__global__ void __launch_bounds__(256)
sum_splits(const float* __restrict__ partial, float* __restrict__ out, long long n, int splits) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.0f;
  for (int k = 0; k < splits; ++k) s += partial[(size_t)k * n + i];
  out[i] = s;
}

}  // namespace

// x (B, H, W, C), g (B, Ho, Wo, O) channels-last, 16-byte aligned, C and O multiples of 64;
// partial: `splits` x (9, C, O) fp32 scratch; out: (9, C, O) fp32. `chunk` pixels a split,
// a multiple of 32, with splits * chunk >= B*Ho*Wo. dtype: 0 = float32, 1 = bfloat16.
// Returns the cudaError_t of the launches.
extern "C" int jp_conv3x3_wgrad(const void* x, const void* g, float* partial, float* out, int B,
                                int H, int W, int C, int O, int pad, int chunk, int splits,
                                int dtype, void* stream) {
  const int Ho = H + 2 * pad - 2, Wo = W + 2 * pad - 2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (C % TILE != 0 || O % TILE != 0 || Ho <= 0 || Wo <= 0 || chunk % 32 != 0 || splits < 1 ||
      (long long)splits * chunk < (long long)B * Ho * Wo)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(C / TILE, O / TILE, 9 * splits);
  if (dtype == 1) {
    bf16k::wgrad_bf16<<<grid, bf16k::THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(g), partial, B,
        H, W, C, O, Ho, Wo, pad, chunk);
  } else if (dtype == 0) {
    f32k::wgrad_f32<<<grid, f32k::THREADS, 0, s>>>(static_cast<const float*>(x),
                                                    static_cast<const float*>(g), partial, B, H,
                                                    W, C, O, Ho, Wo, pad, chunk);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long n = 9LL * C * O;
  sum_splits<<<(unsigned)((n + 255) / 256), 256, 0, s>>>(partial, out, n, splits);
  return static_cast<int>(cudaGetLastError());
}
