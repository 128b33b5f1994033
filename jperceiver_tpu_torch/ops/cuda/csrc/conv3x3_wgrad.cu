// 3x3 stride-1 convolution weight-gradient (kernel K4), hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `jperceiver_tpu/ops/pallas/conv3x3.py::_wgrad_kernel`
// (a (9C, O) fp32 accumulator held in VMEM across a sequential grid of row strips, nine
// tap^T . g dots a strip). The function is that file's `_wgrad`:
//   dW[o, c, ky, kx] = sum over pixels m of x_pad[m shifted by (ky, kx), c] * g[m, o],
// with operands in their input dtype (bf16 or fp32) and fp32 accumulation; taps that
// fall in the zero padding contribute nothing. The result is fp32 and the same from run
// to run.
//
// Layout: channels-last. x is (B, H, W, C), g is (B, Ho, Wo, O); the result is written as
// (O, C, 3, 3) fp32. In bf16 x and g are read through their strides (multiples of 8
// elements, as TMA wants), so the forward's operand is reused as it is.
//
// Bound on this card (H100 SXM, 989 TFLOP/s bf16, 3.35 TB/s): 2*9*C*O*M operations for
// M = B*Ho*Wo pixels against one read of x and g, well over the ~295 bf16 operations a
// byte where the tensor cores take over at every site of the 1024^2 step. Per launch the
// bf16 bound equals K3's at the same site (0.0050 ms at 64->64 @ 256^2 up to 0.1566 ms at
// 513->256 @ 256^2; the table is in conv3x3.cu).
//
// Design: a GEMM with a long reduction, (9C x O) += x_tap^T . g over pixels. Hopper's
// blocks run in parallel and in no order -- nothing carries over between them as the TPU
// grid's VMEM accumulator did -- so the pixels are split: each split writes fp32 partials,
// and `sum_splits` adds them in a fixed order into (O, C, 3, 3).
//   * bf16: a block owns two (tap, 64-channel) items -- one per consumer warpgroup -- and
//     BN output channels (64 or 128), over one split's pixel tiles. A K step is a tile of
//     64 output pixels (a box of box_w x box_h of one image): ONE TMA load of the
//     cotangent, (64 o, box_w, box_h, 1) boxes that both warpgroups share, and per item
//     one box of x at (c0, ox0 + kx - pad, oy0 + ky - pad, b), zero-filled outside the
//     image as the padding is. Both operands are MN-major in shared memory (channels
//     contiguous, pixels along the rows, 128-byte swizzled); wgmma m64nBNk16 reads them
//     through its transpose bits. So a 128 x 128 (c, o) tile reads g once for two taps,
//     where a block per tap read it nine times. A producer warp keeps a ring of 6 stages
//     in flight behind full/empty mbarriers. `k4_plan` splits the pixels so that the
//     waves of blocks times the tiles a block sums is least. Every few tiles the
//     accumulator is added into a second fp32 sum in registers (below): wgmma's own adds
//     lose precision along a chain.
//   * fp32: a 64x64 tile of one tap on the CUDA cores, 4x4 outputs a thread, fed by
//     cp.async (the tensor cores would round fp32 to TF32, which the contract does not
//     allow), with blocked fp32 sums.
// What holds it below its bound: the L2 rate at the large sites (32 KB a K step for 2.1
// MFLOP), and at the small ones the fp32 partials, `splits` x 9C x O x 4 bytes written and
// summed again, against a few microseconds of products. Times and shares of the bound are in
// PERF.md (`chip_smoke.py` phase 7, `chip_conv_sweep.py --k4-flush`).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "cp_async.cuh"
#include "hopper.cuh"

namespace {

// ---------------------------------------------------------------------------------
// bf16: TMA + wgmma
// ---------------------------------------------------------------------------------

namespace bf16k {

constexpr int THREADS = 384;  // warpgroups 0-1 consume (wgmma), warpgroup 2 produces (TMA)

constexpr int BP = 64;        // pixels a K step
constexpr int BOX_BYTES = BP * 64 * 2;  // one (64 channels, 64 pixels) box: 8 KB

// wgmma's fp32 accumulator loses precision in its own adds, by an amount that grows with the
// number of wgmma it sums (`chip_conv_sweep.py --k4-flush`: 71x the plain version's distance
// to float64 after 1,024 tiles, where fp32 adds rounded to nearest over the same chain stay
// at 0.8x). So every `flush_tiles` tiles each consumer thread adds the accumulator into a
// second fp32 sum in registers beside it and zeroes it. Both fit up to 128 output channels
// (64 registers each at BN = 128), which is why BN stops there.
template <int BN>
struct Cfg {
  static_assert(BN == 64 || BN == 128, "the second sum sits in registers up to 128 wide");
  static constexpr int G_BOXES = BN / 64;
  static constexpr int STAGE_BYTES = (2 + G_BOXES) * BOX_BYTES;  // x for two items, then g
  static constexpr int STAGES = 196608 / STAGE_BYTES > 6 ? 6 : 196608 / STAGE_BYTES;
  static constexpr int SMEM = 1024 + STAGES * STAGE_BYTES + 2 * STAGES * 8;
};

// This thread's elements of a 64 x BN accumulator tile: pairs of columns at rows r and r + 8
// (`out` points at row r, column 0 of the tile).
template <int BN>
__device__ __forceinline__ void to_partial(const float (&acc)[BN / 2], float* out, int o_cols) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    float* lo = out + 8 * j + 2 * (lane % 4);
    *reinterpret_cast<float2*>(lo) = make_float2(acc[4 * j], acc[4 * j + 1]);
    *reinterpret_cast<float2*>(lo + (size_t)8 * o_cols) = make_float2(acc[4 * j + 2],
                                                                       acc[4 * j + 3]);
  }
}

template <int BN>
__global__ void __launch_bounds__(THREADS, 1)
wgrad_bf16_wgmma(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap gmap,
                 float* __restrict__ partial, int c_rows, int o_cols, int pad, int box_w,
                 int box_h, int tiles_x, int tiles_y, int tiles, int tiles_per_split, int kchunks,
                 int flush_tiles) {
  using Cf = Cfg<BN>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = jp::align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + Cf::STAGES * Cf::STAGE_BYTES);
  uint64_t* empty = full + Cf::STAGES;

  const int item0 = 2 * blockIdx.x;  // item = tap * kchunks + channel chunk
  const int n_items = min(2, 9 * kchunks - item0);
  const int n0 = blockIdx.y * BN;
  const int split = blockIdx.z;
  const int t_begin = split * tiles_per_split;
  const int ksteps = max(0, min(tiles, t_begin + tiles_per_split) - t_begin);
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < Cf::STAGES; ++s) {
      jp::mbar_init(&full[s], 1);
      jp::mbar_init(&empty[s], 4 * n_items);  // one arrival from each working consumer warp
    }
    jp::fence_barrier_init();
  }
  __syncthreads();

  if (wg == 2) {
    jp::setmaxnreg_dec<40>();
    if (threadIdx.x == 256) {
      for (int i = 0; i < ksteps; ++i) {
        const int s = i % Cf::STAGES;
        if (i >= Cf::STAGES) jp::mbar_wait(&empty[s], ((i / Cf::STAGES) - 1) & 1);
        const int t = t_begin + i;
        const int tx = t % tiles_x, ty = (t / tiles_x) % tiles_y, b = t / (tiles_x * tiles_y);
        const int ox0 = tx * box_w, oy0 = ty * box_h;
        unsigned char* st = smem + s * Cf::STAGE_BYTES;
        jp::mbar_expect_tx(&full[s], (n_items + Cf::G_BOXES) * BOX_BYTES);
        for (int w = 0; w < n_items; ++w) {
          const int item = item0 + w;
          const int tap = item / kchunks, c0 = (item - tap * kchunks) * 64;
          const int ky = tap / 3, kx = tap - 3 * ky;
          jp::tma_load_4d(st + w * BOX_BYTES, &xmap, &full[s], c0, ox0 + kx - pad,
                          oy0 + ky - pad, b);
        }
        for (int j = 0; j < Cf::G_BOXES; ++j)
          jp::tma_load_4d(st + (2 + j) * BOX_BYTES, &gmap, &full[s], n0 + 64 * j, ox0,
                          oy0, b);
      }
    }
  } else {
    jp::setmaxnreg_inc<232>();
    if (wg < n_items) {
      const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
      float acc[BN / 2], rsum[BN / 2];
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = rsum[i] = 0.0f;
      jp::fence_accumulator(acc);
      // Rows are the item's 64 channels, columns BN output channels.
      const int item = item0 + wg;
      const int tap = item / kchunks, c0 = (item - tap * kchunks) * 64;
      const int r = warp * 16 + lane / 4;
      float* out = partial + ((size_t)(split * 9 + tap) * c_rows + c0 + r) * o_cols + n0;
      const uint32_t x_base = jp::smem_u32(smem) + wg * BOX_BYTES;
      const uint32_t g_base = jp::smem_u32(smem) + 2 * BOX_BYTES;
      for (int i = 0; i < ksteps; ++i) {
        const int s = i % Cf::STAGES;
        jp::mbar_wait(&full[s], (i / Cf::STAGES) & 1);
        const uint32_t xa = x_base + s * Cf::STAGE_BYTES, ga = g_base + s * Cf::STAGE_BYTES;
        jp::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BP / 16; ++kk)  // 16 pixels (rows of 128 bytes) a wgmma
          jp::wgmma_m64k16<BN, 1, 1>(acc, jp::sw128_desc(xa + 2048 * kk, BOX_BYTES, 1024),
                                     jp::sw128_desc(ga + 2048 * kk, BOX_BYTES, 1024));
        jp::wgmma_commit();
        jp::wgmma_wait<1>();
        if (i > 0 && lane == 0) jp::mbar_arrive(&empty[(i - 1) % Cf::STAGES]);
        if ((i + 1) % flush_tiles == 0 && i + 1 < ksteps) {
          jp::wgmma_wait<0>();
          jp::fence_accumulator(acc);
#pragma unroll
          for (int j = 0; j < BN / 2; ++j) {
            rsum[j] += acc[j];
            acc[j] = 0.0f;
          }
          jp::fence_accumulator(acc);
        }
      }
      jp::wgmma_wait<0>();
      jp::fence_accumulator(acc);
#pragma unroll
      for (int j = 0; j < BN / 2; ++j) acc[j] = rsum[j] + acc[j];
      to_partial<BN>(acc, out, o_cols);
    }
  }
}

template <int BN>
cudaError_t launch(const CUtensorMap& xmap, const CUtensorMap& gmap, float* partial, int B,
                   int Ho, int Wo, int O, int pad, int box_w, int box_h, int kchunks, int splits,
                   int tiles_per_split, int flush_tiles, cudaStream_t stream) {
  // Above 48 KB of dynamic shared memory a kernel must ask, once.
  static const cudaError_t attr = cudaFuncSetAttribute(
      wgrad_bf16_wgmma<BN>, cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg<BN>::SMEM);
  if (attr != cudaSuccess) return attr;
  const int tiles_x = (Wo + box_w - 1) / box_w, tiles_y = (Ho + box_h - 1) / box_h;
  const int tiles = B * tiles_x * tiles_y;
  if ((long long)splits * tiles_per_split < tiles || (long long)(splits - 1) * tiles_per_split >= tiles)
    return cudaErrorInvalidValue;
  const int o_tiles = (O + BN - 1) / BN;
  const dim3 grid((9 * kchunks + 1) / 2, o_tiles, splits);
  wgrad_bf16_wgmma<BN><<<grid, THREADS, Cfg<BN>::SMEM, stream>>>(
      xmap, gmap, partial, 64 * kchunks, o_tiles * BN, pad, box_w, box_h, tiles_x, tiles_y,
      tiles, tiles_per_split, kchunks, flush_tiles);
  return cudaGetLastError();
}

}  // namespace bf16k

// ---------------------------------------------------------------------------------
// fp32: CUDA cores, exact fp32 products
// ---------------------------------------------------------------------------------

constexpr int TILE = 64;  // fp32 path: c rows and o columns of a block's tile

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

// out[o, c, tap] = sum over splits s, in order, of partial[s, tap, c, o], for c < C and
// o < O of the (splits, 9, c_rows, o_cols) partials. A block sums a tile of 8 o x 8 c x 9
// taps, one element a thread (reads in 32-byte runs along o), and writes it out through
// shared memory as 8 runs of 72 contiguous floats.
constexpr int SUM_O = 8, SUM_C = 8, SUM_THREADS = SUM_O * SUM_C * 9;

__global__ void __launch_bounds__(SUM_THREADS)
sum_splits(const float* __restrict__ partial, float* __restrict__ out, int C, int O, int c_rows,
           int o_cols, int splits) {
  __shared__ float tile[SUM_O][SUM_C * 9 + 1];
  const int o0 = blockIdx.x * SUM_O, c0 = blockIdx.y * SUM_C;
  const int ol = threadIdx.x % SUM_O, ci = (threadIdx.x / SUM_O) % SUM_C;
  const int tap = threadIdx.x / (SUM_O * SUM_C);
  const size_t n = (size_t)9 * c_rows * o_cols;
  if (c0 + ci < C && o0 + ol < O) {
    const float* p = partial + ((size_t)tap * c_rows + c0 + ci) * o_cols + o0 + ol;
    float acc = 0.0f;
    for (int k = 0; k < splits; ++k) acc += p[k * n];
    tile[ol][ci * 9 + tap] = acc;
  }
  __syncthreads();
  const int cn = min(SUM_C, C - c0);
  for (int q = threadIdx.x; q < SUM_O * SUM_C * 9; q += SUM_THREADS) {
    const int oq = q / (SUM_C * 9), r = q - oq * (SUM_C * 9);
    if (o0 + oq < O && r < cn * 9) out[((size_t)(o0 + oq) * C + c0) * 9 + r] = tile[oq][r];
  }
}

cudaError_t reduce(const float* partial, float* out, int C, int O, int c_rows, int o_cols,
                   int splits, cudaStream_t stream) {
  const dim3 grid((O + SUM_O - 1) / SUM_O, (C + SUM_C - 1) / SUM_C);
  sum_splits<<<grid, SUM_THREADS, 0, stream>>>(partial, out, C, O, c_rows, o_cols, splits);
  return cudaGetLastError();
}

}  // namespace

// bf16: x (B, H, W, C) and g (B, Ho, Wo, O) channels-last with pixel, row and image strides
// sx_* and sg_* (elements, multiples of 8); channels past C and O are never read.
// partial: `splits` x (9, 64*ceil(C/64), bn*ceil(O/bn)) fp32 scratch; out: (O, C, 3, 3)
// fp32. Pixel tiles of box_w x box_h = 64, bn output channels (64 or 128),
// tiles_per_split tiles a split: the wrapper's tile plan (`ops/cuda/conv3x3.py::k4_plan`).
// Returns the cudaError_t of the launches.
extern "C" int jp_conv3x3_wgrad_bf16(const void* x, const void* g, float* partial, float* out,
                                     int B, int H, int W, int C, long long sx_w, long long sx_h,
                                     long long sx_b, int O, long long sg_w, long long sg_h,
                                     long long sg_b, int pad, int box_w, int box_h, int bn,
                                     int splits, int tiles_per_split, int flush_tiles,
                                     void* stream) {
  const int Ho = H + 2 * pad - 2, Wo = W + 2 * pad - 2;
  if (C < 1 || O < 1 || Ho <= 0 || Wo <= 0 || !jp::tma_strides(sx_w, sx_h, sx_b) ||
      !jp::tma_strides(sg_w, sg_h, sg_b) || box_w * box_h != bf16k::BP || box_w > 256 ||
      box_h > 256 || splits < 1 || tiles_per_split < 1 || flush_tiles < 1 ||
      (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(g)) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap xmap, gmap;
  if (!jp::encode_nhwc_map(&xmap, x, B, H, W, C, sx_w, sx_h, sx_b, box_w, box_h) ||
      !jp::encode_nhwc_map(&gmap, g, B, Ho, Wo, O, sg_w, sg_h, sg_b, box_w, box_h))
    return static_cast<int>(cudaErrorInvalidValue);
  const int kchunks = (C + 63) / 64;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (bn) {
    case 64: err = bf16k::launch<64>(xmap, gmap, partial, B, Ho, Wo, O, pad, box_w, box_h, kchunks, splits, tiles_per_split, flush_tiles, s); break;
    case 128: err = bf16k::launch<128>(xmap, gmap, partial, B, Ho, Wo, O, pad, box_w, box_h, kchunks, splits, tiles_per_split, flush_tiles, s); break;
    default: err = cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const int o_cols = bn * ((O + bn - 1) / bn);
  return static_cast<int>(reduce(partial, out, C, O, 64 * kchunks, o_cols, splits, s));
}

// fp32: x (B, H, W, Cp) and g (B, Ho, Wo, Op) channels-last, 16-byte aligned, Cp and Op
// multiples of 64 with the first C and O channels real; partial: `splits` x (9, Cp, Op)
// fp32 scratch; out: (O, C, 3, 3) fp32. `chunk` pixels a split, a multiple of 32, with
// splits * chunk >= B*Ho*Wo. Returns the cudaError_t of the launches.
extern "C" int jp_conv3x3_wgrad_f32(const void* x, const void* g, float* partial, float* out,
                                    int B, int H, int W, int C, int Cp, int O, int Op, int pad,
                                    int chunk, int splits, void* stream) {
  const int Ho = H + 2 * pad - 2, Wo = W + 2 * pad - 2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Cp % TILE != 0 || Op % TILE != 0 || Cp < C || Op < O || Ho <= 0 || Wo <= 0 ||
      chunk % 32 != 0 || splits < 1 || (long long)splits * chunk < (long long)B * Ho * Wo)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(Cp / TILE, Op / TILE, 9 * splits);
  f32k::wgrad_f32<<<grid, f32k::THREADS, 0, s>>>(static_cast<const float*>(x),
                                                  static_cast<const float*>(g), partial, B, H, W,
                                                  Cp, Op, Ho, Wo, pad, chunk);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(reduce(partial, out, C, O, Cp, Op, splits, s));
}
