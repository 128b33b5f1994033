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
// (O, C, 3, 3) fp32. In bf16 and TF32 x and g are read through their strides (multiples of
// 16 bytes, as TMA wants), so the forward's operand is reused as it is.
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
//   * bf16: a block owns two (tap, 64-channel chunk) items -- one per consumer warpgroup --
//     and BN output channels (64 or 128), over one split's pixel tiles. A K step is a tile of
//     128 output pixels (a box of box_w x box_h of one image): per item a box of x at
//     (c0, ox0 + kx - pad, oy0 + ky - pad, b), zero-filled outside the image as the padding
//     is, and the cotangent's (64 o, box_w, box_h, 1) boxes that both warpgroups share.
//     Where the two items are one tap's adjacent whole chunks their two x boxes come in ONE
//     load, from a 5-D map (64 channels, W, H, chunk, B) whose chunks lie 128 bytes apart
//     (`encode_nhwc_chunk_map`), and so do the two g boxes of a 128-wide tile: two loads a
//     step in place of four (`block_items` orders the items so that most blocks pair).
//     Both operands are MN-major in shared memory (channels contiguous, pixels along the
//     rows, 128-byte swizzled); wgmma m64nBNk16 reads them through its transpose bits, 8 a
//     step. A producer warp keeps a ring of 3 stages (4 at BN = 64) in flight behind
//     full/empty mbarriers. `k4_plan` splits the pixels so that the waves of blocks times the
//     tiles a block sums, plus the partials `sum_splits` reads, is least. Every 2 steps
//     (16 wgmma) the accumulator is added into a second fp32 sum in registers (below):
//     wgmma's own adds lose precision along a chain.
//   * TF32 (fp32 operands, `torch.backends.cudnn.allow_tf32` set, as cuDNN's fp32 weight
//     gradient runs): the bf16 design's blocks, items, splits and second sum, on tiles of 64
//     pixels (a 128-byte fp32 box row holds 32 channels, so a step moves bf16's 128-pixel
//     bytes), wgmma m64nBNk8 .tf32. TF32 wgmma reads only K-major operands, and here K is the
//     pixels while both operands lie channels-contiguous. So x, a consumer's own item, is the
//     A operand through registers: scalar loads from its MN-major boxes, rounded to nearest
//     even (`round_tf32`); g, which both warpgroups share, is the B operand: the consumers
//     transpose the step's g boxes once into a K-major 128-byte-swizzled buffer, rounding on
//     the way, while the previous step's wgmma reads the other of two such buffers. The
//     pixel order along K is chosen so that the A loads and the transpose's 16-byte loads and
//     stores meet no bank conflict. x's four 32-channel boxes of a paired block come in one
//     load, g's BN / 32 in another. A stage (x and g boxes) is freed once its A fragments are
//     loaded and its g transposed: 2 stages at BN = 128, 4 at 64, beside the two buffers.
//     Bound: 2*9*C*O*M operations at 494.7 TFLOP/s (the bytes never bound it). A step moves
//     about 288 KB of shared memory (TMA's 64 KB, the transpose's 32 KB read and 32 written,
//     32 KB of A fragments, and B read by both warpgroups, 64 KB) for 2.1 MFLOP: about 1.2 us
//     at 128 bytes a clock against 0.56 us of products, so shared memory sets the step
//     (measured 1.5 us at 513 -> 256 @ 256^2, B = 3). Shares of the bound on the H100
//     (`chip_conv_sweep.py --k4-tf32`, the wrapper's call, B = 3): 64->64 @ 256^2 0.21,
//     128->128 @ 128^2 0.31, 256->256 @ 64^2 0.26, 513->256 @ 64^2 0.27, 256->256 @ 128^2
//     0.34, 513->256 @ 128^2 0.31, 256->256 @ 256^2 0.37, 513->256 @ 256^2 0.32 (B = 1:
//     0.18-0.34); 4.4-9.0x faster than the exact kernel, 0.78-1.14x cuDNN's TF32 time; within
//     0.002 of a TF32 gap of float64 on the rounded operands (cuDNN's TF32: 2.8-3.8 gaps).
//   * exact fp32 (the flag off): a 64x64 tile of one tap on the CUDA cores, 4x4 outputs a
//     thread, fed by cp.async, with blocked fp32 sums.
// What sets a bf16 step's time (`chip_conv_sweep.py --k4-anatomy`, variants of this file at
// 256 -> 256 and 513 -> 256 @ 256^2, B = 3, on the H100; PERF.md section 6): the loads, per
// load and per step more than per byte. In the 64-pixel design before this one a step took
// 0.76-0.78 us, of which loads and barriers alone took 0.58-0.60 and products on resident
// stages alone 0.40; 128 pixels a step (twice the bytes a load) took 0.53 us per 64 pixels.
// Two cluster designs were measured and dropped (PERF.md section 6): an o pair of blocks
// sharing x by TMA multicast (a quarter fewer bytes from L2) gained nothing once its
// handshake was cheap (and lost 45% with cluster-scope release/acquire), and the splits
// summed in one cluster through distributed shared memory lost to `sum_splits` (a cluster
// of 8-11 blocks leaves SMs idle). This design: 0.90-1.08 us per 128 pixels, loads alone
// 0.72-0.90, products alone 0.77-0.82; the two overlap only in part
// (both use the SM's shared memory: 64 KB written and 96 KB of wgmma operands read a step,
// which is not measured apart). At the small sites the launch's fill and `sum_splits`
// (splits x 9C x O x 4 bytes written and read again) weigh as much as the steps. Times and
// shares of the bound are in PERF.md (`chip_smoke.py` phase 7).

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

constexpr int BP = 128;       // pixels a K step (a box of box_w x box_h pixels of one image)
constexpr int BOX_BYTES = BP * 64 * 2;  // one (64 channels, 128 pixels) box: 16 KB

// wgmma's fp32 accumulator loses precision in its own adds, by an amount that grows with the
// number of wgmma it sums (`chip_conv_sweep.py --k4-flush`: 71x the plain version's distance
// to float64 after 4,096 wgmma, where fp32 adds rounded to nearest over the same chain stay
// at 0.8x). So every `flush_tiles` steps (16 wgmma) each consumer thread adds the
// accumulator into a second fp32 sum in registers beside it and zeroes it. Both fit up to
// 128 output channels (64 registers each at BN = 128), which is why BN stops there. A stage
// at BN = 128 is 64 KB (two x and two g boxes of 128 pixels), so 3 fit in shared memory.
// The cap costs less than it did at 64 pixels a step: the step is set by its loads
// (header), and a 128-wide step takes 0.90-1.08 us against 0.77-0.82 for its products alone.
template <int BN>
struct Cfg {
  static_assert(BN == 64 || BN == 128, "the second sum sits in registers up to 128 wide");
  static constexpr int G_BOXES = BN / 64;
  static constexpr int STAGE_BYTES = (2 + G_BOXES) * BOX_BYTES;  // x for two items, then g
  static constexpr int STAGES = 196608 / STAGE_BYTES;  // 3 at BN = 128, 4 at 64
  static constexpr int SMEM = 1024 + STAGES * STAGE_BYTES + 2 * STAGES * 8;
};

// This thread's elements of a 64 x BN accumulator tile: pairs of columns at rows r and r + 8
// (`out` points at row r, column 0 of the tile; rows `stride` floats apart).
template <int BN>
__device__ __forceinline__ void store_tile(const float (&acc)[BN / 2], float* out, int stride) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    float* lo = out + 8 * j + 2 * (lane % 4);
    *reinterpret_cast<float2*>(lo) = make_float2(acc[4 * j], acc[4 * j + 1]);
    *reinterpret_cast<float2*>(lo + (size_t)8 * stride) = make_float2(acc[4 * j + 2],
                                                                       acc[4 * j + 3]);
  }
}

// The (tap, 64-channel chunk) items of block j along the grid's x, and whether its two x
// boxes come in one load (one tap's two adjacent whole chunks, from the pair map). The first
// 9 * xpairs blocks take each tap's chunk pairs (2k, 2k + 1) over the C / 64 whole chunks;
// the rest take the chunks past them, `left` a tap, two items a block, tap-major.
struct Items {
  int n;
  bool paired;
  int tap[2], chunk[2];
};

__device__ __forceinline__ Items block_items(int j, int kchunks, int xpairs) {
  Items it;
  if (j < 9 * xpairs) {
    it.n = 2;
    it.paired = true;
    it.tap[0] = it.tap[1] = j / xpairs;
    it.chunk[0] = 2 * (j % xpairs);
    it.chunk[1] = it.chunk[0] + 1;
  } else {
    const int left = kchunks - 2 * xpairs, q = 2 * (j - 9 * xpairs);
    it.n = min(2, 9 * left - q);
    it.paired = false;
    for (int w = 0; w < 2; ++w) {
      const int qq = min(q + w, 9 * left - 1);
      it.tap[w] = qq / left;
      it.chunk[w] = 2 * xpairs + qq % left;
    }
  }
  return it;
}

template <int BN>
__global__ void __launch_bounds__(THREADS, 1)
wgrad_bf16_wgmma(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap gmap,
                 const __grid_constant__ CUtensorMap xpair,
                 const __grid_constant__ CUtensorMap gpair, float* __restrict__ partial,
                 int c_rows, int o_cols, int O, int pad, int box_w, int box_h, int tiles_x,
                 int tiles_y, int tiles, int tiles_per_split, int kchunks, int xpairs,
                 int flush_tiles) {
  using Cf = Cfg<BN>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = jp::align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + Cf::STAGES * Cf::STAGE_BYTES);
  uint64_t* empty = full + Cf::STAGES;

  const Items it = block_items(blockIdx.x, kchunks, xpairs);
  const int n_items = it.n;
  const int n0 = blockIdx.y * BN;
  // Both g boxes in one load where the output tile is two whole 64-channel chunks.
  const bool g_paired = BN == 128 && n0 + 128 <= O;
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
        if (it.paired) {
          const int ky = it.tap[0] / 3, kx = it.tap[0] - 3 * ky;
          jp::tma_load_5d(st, &xpair, &full[s], 0, ox0 + kx - pad, oy0 + ky - pad, it.chunk[0],
                          b);
        } else {
          for (int w = 0; w < n_items; ++w) {
            const int ky = it.tap[w] / 3, kx = it.tap[w] - 3 * ky, c0 = 64 * it.chunk[w];
            jp::tma_load_4d(st + w * BOX_BYTES, &xmap, &full[s], c0, ox0 + kx - pad,
                            oy0 + ky - pad, b);
          }
        }
        if (g_paired) {
          jp::tma_load_5d(st + 2 * BOX_BYTES, &gpair, &full[s], 0, ox0, oy0, n0 / 64, b);
        } else {
          for (int j = 0; j < Cf::G_BOXES; ++j)
            jp::tma_load_4d(st + (2 + j) * BOX_BYTES, &gmap, &full[s], n0 + 64 * j, ox0,
                            oy0, b);
        }
      }
    }
    return;
  }
  jp::setmaxnreg_inc<232>();
  if (wg < n_items) {
    const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
    float acc[BN / 2], rsum[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = rsum[i] = 0.0f;
    jp::fence_accumulator(acc);
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
    // Rows are the item's 64 channels, columns BN output channels.
    const int r = warp * 16 + lane / 4;
    store_tile<BN>(acc, partial + ((size_t)(split * 9 + it.tap[wg]) * c_rows +
                                   64 * it.chunk[wg] + r) * o_cols + n0,
                   o_cols);
  }
}

template <int BN>
cudaError_t launch(const CUtensorMap& xmap, const CUtensorMap& gmap, const CUtensorMap& xpair,
                   const CUtensorMap& gpair, float* partial, int B, int Ho, int Wo, int O,
                   int pad, int box_w, int box_h, int kchunks, int xpairs, int splits,
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
  const int left = kchunks - 2 * xpairs;
  const dim3 grid(9 * xpairs + (9 * left + 1) / 2, o_tiles, splits);
  wgrad_bf16_wgmma<BN><<<grid, THREADS, Cfg<BN>::SMEM, stream>>>(
      xmap, gmap, xpair, gpair, partial, 64 * kchunks, o_tiles * BN, O, pad, box_w, box_h,
      tiles_x, tiles_y, tiles, tiles_per_split, kchunks, xpairs, flush_tiles);
  return cudaGetLastError();
}

}  // namespace bf16k

// ---------------------------------------------------------------------------------
// fp32 on the tensor cores: TF32 operands rounded to nearest, fp32 accumulators
// ---------------------------------------------------------------------------------

namespace tf32k {

using bf16k::THREADS;
constexpr int BP = 64;                // pixels a K step
constexpr int SUB_BYTES = BP * 128;   // one (32 channels, 64 pixels) fp32 box: 8 KB
constexpr int X_BYTES = 2 * SUB_BYTES;  // an item's 64 channels: two boxes

// A stage holds the TMA boxes of a step: x for two items, then BN output channels of g, all
// pixel-major (MN-major) as they lie. The consumers transpose g into one of two K-major
// buffers beside the ring (`T_BYTES`: BP / 32 blocks of BN rows of 32 pixels), the one that
// the step's wgmma reads, while the previous step's wgmma reads the other.
template <int BN>
struct Cfg {
  static_assert(BN == 64 || BN == 128, "the second sum sits in registers up to 128 wide");
  static constexpr int G_SUBS = BN / 32;
  static constexpr int STAGE_BYTES = 2 * X_BYTES + G_SUBS * SUB_BYTES;
  static constexpr int T_BYTES = BN * BP * 4;
  static constexpr int STAGES = (227 * 1024 - 1024 - 2 * T_BYTES - 256) / STAGE_BYTES;  // 2, 4
  static constexpr int SMEM = 1024 + STAGES * STAGE_BYTES + 2 * T_BYTES + 2 * STAGES * 8;
  static constexpr int BLOCKS = BP * BN / 16;  // 4 x 4 blocks of g a step
  static_assert(BLOCKS % 256 == 0, "whole 4 x 4 blocks a consumer thread");
};

// Transpose g of stage `gs` (G_SUBS boxes of (32 o, BP pixels), a 128-byte row a pixel) into
// the K-major buffer `t` (BP / 32 blocks of BN rows of 32 pixels, a 128-byte row an output
// channel), each element rounded to TF32 on the way. Pixel order along K: K position 8k + j
// of a row holds pixel 8k + 2j for j < 4, 8k + 2(j - 4) + 1 after (what the A fragments of
// `load_a` read, so that their loads meet no bank conflict). A consumer thread moves 4 x 4
// blocks: 4 pixels (8k + e + 2i, i < 4) of 4 output channels, read as 4 16-byte rows, written
// as 4. Within each 8 threads of a warp (q = thread % 8) the blocks' 16-byte chunks fall on 8
// distinct bank groups, in both the swizzled read and the swizzled write: q picks the pixel
// quad (8 * (p / 8) + q) and the channel quad sigma(q) ^ v, v = (thread / 8) % 8.
template <int BN>
__device__ __forceinline__ void transpose_g(const unsigned char* gs, unsigned char* t, int ct) {
  using Cf = Cfg<BN>;
#pragma unroll
  for (int r = 0; r < Cf::BLOCKS / 256; ++r) {
    const int u = ct + 256 * r;
    const int q = u & 7, v = (u >> 3) & 7, rest = u >> 6;
    const int pq = 8 * (rest % (BP / 32)) + q, bx = rest / (BP / 32);
    const int j = ((((q >> 1) & 3) | ((q & 1) << 2)) ^ v);
    const int e = q & 1, p0 = 8 * (pq >> 1) + e;
    uint32_t in[4][4];  // [pixel][output channel]
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int p = p0 + 2 * i;
      const uint4 row = *reinterpret_cast<const uint4*>(gs + bx * SUB_BYTES + p * 128 +
                                                        ((j ^ (p & 7)) << 4));
      in[i][0] = jp::round_tf32(row.x);
      in[i][1] = jp::round_tf32(row.y);
      in[i][2] = jp::round_tf32(row.z);
      in[i][3] = jp::round_tf32(row.w);
    }
    unsigned char* blk = t + (pq >> 3) * (BN * 128);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int o = 32 * bx + 4 * j + i;
      *reinterpret_cast<uint4*>(blk + o * 128 + (((pq & 7) ^ (o & 7)) << 4)) =
          make_uint4(in[0][i], in[1][i], in[2][i], in[3][i]);
    }
  }
}

template <int BN>
__global__ void __launch_bounds__(THREADS, 1)
wgrad_f32_tf32_wgmma(const __grid_constant__ CUtensorMap xmap,
                     const __grid_constant__ CUtensorMap gmap,
                     const __grid_constant__ CUtensorMap xquad,
                     const __grid_constant__ CUtensorMap gchunks, float* __restrict__ partial,
                     int c_rows, int o_cols, int O, int pad, int box_w, int box_h, int tiles_x,
                     int tiles_y, int tiles, int tiles_per_split, int kchunks, int xpairs,
                     int flush_tiles) {
  using Cf = Cfg<BN>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = jp::align1024(smem_raw);
  unsigned char* tbuf = smem + Cf::STAGES * Cf::STAGE_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(tbuf + 2 * Cf::T_BYTES);
  uint64_t* empty = full + Cf::STAGES;

  const bf16k::Items it = bf16k::block_items(blockIdx.x, kchunks, xpairs);
  const int n_items = it.n;
  const int n0 = blockIdx.y * BN;
  // All of g's boxes in one load where the output tile is whole 32-channel chunks.
  const bool g_whole = n0 + BN <= O;
  const int split = blockIdx.z;
  const int t_begin = split * tiles_per_split;
  const int ksteps = max(0, min(tiles, t_begin + tiles_per_split) - t_begin);
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < Cf::STAGES; ++s) {
      jp::mbar_init(&full[s], 1);
      jp::mbar_init(&empty[s], 8);  // every consumer warp, once it has read the stage
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
        jp::mbar_expect_tx(&full[s], (2 * n_items + Cf::G_SUBS) * SUB_BYTES);
        if (it.paired) {  // the four 32-channel boxes of one tap's two whole 64-channel chunks
          const int ky = it.tap[0] / 3, kx = it.tap[0] - 3 * ky;
          jp::tma_load_5d(st, &xquad, &full[s], 0, ox0 + kx - pad, oy0 + ky - pad,
                          2 * it.chunk[0], b);
        } else {
          for (int w = 0; w < n_items; ++w) {
            const int ky = it.tap[w] / 3, kx = it.tap[w] - 3 * ky;
            for (int h = 0; h < 2; ++h)
              jp::tma_load_4d(st + w * X_BYTES + h * SUB_BYTES, &xmap, &full[s],
                              64 * it.chunk[w] + 32 * h, ox0 + kx - pad, oy0 + ky - pad, b);
          }
        }
        if (g_whole) {
          jp::tma_load_5d(st + 2 * X_BYTES, &gchunks, &full[s], 0, ox0, oy0, n0 / 32, b);
        } else {
          for (int j = 0; j < Cf::G_SUBS; ++j)
            jp::tma_load_4d(st + 2 * X_BYTES + j * SUB_BYTES, &gmap, &full[s], n0 + 32 * j,
                            ox0, oy0, b);
        }
      }
    }
    return;
  }
  // Consumers. Both warpgroups transpose g (half the blocks each) and multiply, whether or not
  // they own an item (a warpgroup past n_items multiplies what its x boxes held before and
  // stores nothing: a wgmma under a branch that ptxas cannot prove uniform is serialized).
  // Step i's wgmma reads T buffer i % 2 and A fragments in registers; while it runs, the
  // warpgroups transpose step i + 1's g into the other buffer, then wait for it, meet at a
  // barrier (both transposes written, both of step i's wgmma done with their buffer), load
  // step i + 1's A fragments and release its stage.
  jp::setmaxnreg_inc<232>();
  const int ct = threadIdx.x, warp = (ct % 128) / 32, lane = ct % 32;
  float acc[BN / 2], rsum[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = rsum[i] = 0.0f;
  jp::fence_accumulator(acc);
  // A: rows are the item's channels, 16 * warp + lane / 4 and that + 8, both in box warp / 2;
  // columns k = lane % 4 and k + 4 of an 8-pixel slab are its pixels 2k and 2k + 1 (the K
  // order of `transpose_g`). Element (pixel p, channel c) of a box lies at p * 128 +
  // (((c / 4) ^ (p % 8)) * 16) + (c % 4) * 4; p % 8 is 2k or 2k + 1 in every slab.
  const int cr = 16 * (warp & 1) + lane / 4, pk = 2 * (lane & 3);
  const int a_off[4] = {
      pk * 128 + (((cr >> 2) ^ pk) << 4) + (cr & 3) * 4,
      pk * 128 + ((((cr + 8) >> 2) ^ pk) << 4) + (cr & 3) * 4,
      (pk + 1) * 128 + (((cr >> 2) ^ (pk + 1)) << 4) + (cr & 3) * 4,
      (pk + 1) * 128 + ((((cr + 8) >> 2) ^ (pk + 1)) << 4) + (cr & 3) * 4};
  const unsigned char* x_item = smem + wg * X_BYTES + (warp >> 1) * SUB_BYTES;
  uint32_t a[BP / 8][4];
  auto load_a = [&](int s) {
    const unsigned char* xs = x_item + s * Cf::STAGE_BYTES;
#pragma unroll
    for (int kk = 0; kk < BP / 8; ++kk)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        a[kk][j] = jp::round_tf32(*reinterpret_cast<const uint32_t*>(xs + 1024 * kk + a_off[j]));
  };
  auto stage_g = [&](int s) { return smem + s * Cf::STAGE_BYTES + 2 * X_BYTES; };
  const uint32_t t_base = jp::smem_u32(tbuf);

  if (ksteps > 0) {
    jp::mbar_wait(&full[0], 0);
    transpose_g<BN>(stage_g(0), tbuf, ct);
    jp::fence_proxy_async();
    jp::consumers_sync();
    load_a(0);
    if (lane == 0) jp::mbar_arrive(&empty[0]);
  }
  for (int i = 0; i < ksteps; ++i) {
    const uint32_t tb = t_base + (i & 1) * Cf::T_BYTES;
    jp::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BP / 8; ++kk)  // 8 pixels (32 bytes of a T row) a wgmma
      jp::wgmma_m64k8_tf32<BN>(
          acc, a[kk], jp::sw128_desc(tb + (kk >> 2) * (BN * 128) + 32 * (kk & 3), 16, 1024));
    jp::wgmma_commit();
    const bool next = i + 1 < ksteps;
    const int sn = (i + 1) % Cf::STAGES;
    if (next) {
      jp::mbar_wait(&full[sn], ((i + 1) / Cf::STAGES) & 1);
      transpose_g<BN>(stage_g(sn), tbuf + ((i + 1) & 1) * Cf::T_BYTES, ct);
    }
    jp::wgmma_wait<0>();
#pragma unroll
    for (int kk = 0; kk < BP / 8; ++kk) jp::fence_operand(a[kk]);
    jp::fence_accumulator(acc);
    if ((i + 1) % flush_tiles == 0 && next) {
#pragma unroll
      for (int j = 0; j < BN / 2; ++j) {
        rsum[j] += acc[j];
        acc[j] = 0.0f;
      }
      jp::fence_accumulator(acc);
    }
    if (next) {
      jp::fence_proxy_async();
      jp::consumers_sync();
      load_a(sn);
      if (lane == 0) jp::mbar_arrive(&empty[sn]);
    }
  }
  if (wg < n_items) {
#pragma unroll
    for (int j = 0; j < BN / 2; ++j) acc[j] = rsum[j] + acc[j];
    // Rows are the item's 64 channels, columns BN output channels.
    const int r = warp * 16 + lane / 4;
    bf16k::store_tile<BN>(acc, partial + ((size_t)(split * 9 + it.tap[wg]) * c_rows +
                                          64 * it.chunk[wg] + r) * o_cols + n0,
                          o_cols);
  }
}

template <int BN>
cudaError_t launch(const CUtensorMap& xmap, const CUtensorMap& gmap, const CUtensorMap& xquad,
                   const CUtensorMap& gchunks, float* partial, int B, int Ho, int Wo, int O,
                   int pad, int box_w, int box_h, int kchunks, int xpairs, int splits,
                   int tiles_per_split, int flush_tiles, cudaStream_t stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      wgrad_f32_tf32_wgmma<BN>, cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg<BN>::SMEM);
  if (attr != cudaSuccess) return attr;
  const int tiles_x = (Wo + box_w - 1) / box_w, tiles_y = (Ho + box_h - 1) / box_h;
  const int tiles = B * tiles_x * tiles_y;
  if ((long long)splits * tiles_per_split < tiles || (long long)(splits - 1) * tiles_per_split >= tiles)
    return cudaErrorInvalidValue;
  const int o_tiles = (O + BN - 1) / BN;
  const int left = kchunks - 2 * xpairs;
  const dim3 grid(9 * xpairs + (9 * left + 1) / 2, o_tiles, splits);
  wgrad_f32_tf32_wgmma<BN><<<grid, THREADS, Cfg<BN>::SMEM, stream>>>(
      xmap, gmap, xquad, gchunks, partial, 64 * kchunks, o_tiles * BN, O, pad, box_w, box_h,
      tiles_x, tiles_y, tiles, tiles_per_split, kchunks, xpairs, flush_tiles);
  return cudaGetLastError();
}

}  // namespace tf32k

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
// fp32. Pixel tiles of box_w x box_h = 128, bn output channels (64 or 128),
// tiles_per_split tiles a split, the second sum every flush_tiles tiles: the wrapper's tile
// plan (`ops/cuda/conv3x3.py::k4_plan`). Returns the cudaError_t of the launches.
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
  // x and g as 4-D maps, read a box an item or 64 output channels, and as pair maps
  // (`encode_nhwc_chunk_map`), read two whole chunks a box where there are any (else the 4-D
  // map stands in, unread). xpairs: the pairs of whole 64-channel chunks of x a tap.
  const int xpairs = (C / 64) / 2;
  CUtensorMap xmap, gmap;
  if (!jp::encode_nhwc_map(&xmap, x, B, H, W, C, sx_w, sx_h, sx_b, box_w, box_h) ||
      !jp::encode_nhwc_map(&gmap, g, B, Ho, Wo, O, sg_w, sg_h, sg_b, box_w, box_h))
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap xpair = xmap, gpair = gmap;
  if ((xpairs > 0 &&
       !jp::encode_nhwc_chunk_map(&xpair, x, B, H, W, C, sx_w, sx_h, sx_b, box_w, box_h, 2)) ||
      (bn == 128 && O >= 128 &&
       !jp::encode_nhwc_chunk_map(&gpair, g, B, Ho, Wo, O, sg_w, sg_h, sg_b, box_w, box_h, 2)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int kchunks = (C + 63) / 64;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (bn) {
    case 64: err = bf16k::launch<64>(xmap, gmap, xpair, gpair, partial, B, Ho, Wo, O, pad, box_w, box_h, kchunks, xpairs, splits, tiles_per_split, flush_tiles, s); break;
    case 128: err = bf16k::launch<128>(xmap, gmap, xpair, gpair, partial, B, Ho, Wo, O, pad, box_w, box_h, kchunks, xpairs, splits, tiles_per_split, flush_tiles, s); break;
    default: err = cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const int o_cols = bn * ((O + bn - 1) / bn);
  return static_cast<int>(reduce(partial, out, C, O, 64 * kchunks, o_cols, splits, s));
}

// TF32: as the bf16 entry, on fp32 x and g (strides multiples of 4 elements), tiles of
// box_w x box_h = 64 pixels; the kernel rounds both operands to TF32 itself (`round_tf32`).
extern "C" int jp_conv3x3_wgrad_tf32(const void* x, const void* g, float* partial, float* out,
                                     int B, int H, int W, int C, long long sx_w, long long sx_h,
                                     long long sx_b, int O, long long sg_w, long long sg_h,
                                     long long sg_b, int pad, int box_w, int box_h, int bn,
                                     int splits, int tiles_per_split, int flush_tiles,
                                     void* stream) {
  const int Ho = H + 2 * pad - 2, Wo = W + 2 * pad - 2;
  if (C < 1 || O < 1 || Ho <= 0 || Wo <= 0 || !jp::tma_strides(sx_w, sx_h, sx_b, 4) ||
      !jp::tma_strides(sg_w, sg_h, sg_b, 4) || box_w * box_h != tf32k::BP || box_w > 256 ||
      box_h > 256 || splits < 1 || tiles_per_split < 1 || flush_tiles < 1 ||
      (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(g)) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  // x and g as 4-D maps, read a 32-channel box at a time, and as chunk maps: x four whole
  // 32-channel chunks a load (a block's two items where they are one tap's adjacent whole
  // 64-channel chunks), g bn / 32 (a whole output tile). Where there are none the 4-D map
  // stands in, unread.
  const int xpairs = (C / 64) / 2;
  CUtensorMap xmap, gmap;
  if (!jp::encode_nhwc_map(&xmap, x, B, H, W, C, sx_w, sx_h, sx_b, box_w, box_h, true) ||
      !jp::encode_nhwc_map(&gmap, g, B, Ho, Wo, O, sg_w, sg_h, sg_b, box_w, box_h, true))
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap xquad = xmap, gchunks = gmap;
  if ((xpairs > 0 && !jp::encode_nhwc_chunk_map(&xquad, x, B, H, W, C, sx_w, sx_h, sx_b, box_w,
                                                box_h, 4, true)) ||
      (O >= bn && !jp::encode_nhwc_chunk_map(&gchunks, g, B, Ho, Wo, O, sg_w, sg_h, sg_b, box_w,
                                             box_h, bn / 32, true)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int kchunks = (C + 63) / 64;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (bn) {
    case 64: err = tf32k::launch<64>(xmap, gmap, xquad, gchunks, partial, B, Ho, Wo, O, pad, box_w, box_h, kchunks, xpairs, splits, tiles_per_split, flush_tiles, s); break;
    case 128: err = tf32k::launch<128>(xmap, gmap, xquad, gchunks, partial, B, Ho, Wo, O, pad, box_w, box_h, kchunks, xpairs, splits, tiles_per_split, flush_tiles, s); break;
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
