// Fused photometric reprojection loss, forward (kernel K1) and backward (kernel K2),
// hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels `jperceiver_tpu/ops/pallas/reproj.py::_fwd_kernel` and
// `::_bwd_kernel`, together with that file's XLA-side reflect-ring fix-ups
// (`_ring_fixups`, `_fold_w`, `_fold_h`), which K2 folds in.
//
// Function (`reproj_min_pallas`): for each scale s, batch b and pixel p,
//   out[s, b, p] = min over frames f (a chain of minimums, f = 0, 1, ...) of
//     (1/C) sum_c [ 0.85 * clip((1 - SSIM(x_sbfc, y_bc; p)) / 2, 0, 1)
//                 + 0.15 * sqrt((y_bc[p] - x_sbfc[p])^2 + 1e-6) ],
// SSIM over the 3x3 window at p of the 1-pixel reflect-padded images (the edge is not
// repeated: padded row -1 mirrors row 1, padded row H mirrors row H-2), C1 = 0.01^2,
// C2 = 0.03^2, statistics mu = sum/9, sigma = sum(x^2)/9 - mu^2. Inputs are preds
// (S, B, F, C, H, W) and the target (B, C, H, W), both bf16 or both fp32, channel-planar;
// every statistic is fp32; the output is (S, B, H, W) fp32.
//
// K1 also takes, optionally, FI identity frames (FI, B, C, H, W) against the same target
// (the automask pairs of the training step) and writes each one's loss (FI, B, H, W) fp32,
// with no frame-min and no code: one launch serves both calls of the step. When asked, it
// writes a routing code per (s, b, pixel): for each link f = 1 .. F-1 of the chain
// best_f = min(best_{f-1}, rl_f), two bits saying whether rl_f was greater than (0), less
// than (1) or equal to (2) best_{f-1}.
//
// K1's design: one block per (b, tile) of 32 columns x TH rows (TH = 8, 16 or 32, picked by
// `reproj.py::k1_plan`; 32 at 1024^2, a halo of 1.13x), 8 TH threads. The block walks
// every frame that reads this target -- each scale's frames, then the identity frames --
// so the target is staged (as fp32, with its 1-pixel reflect halo) and its window
// statistics mu_y, sigma_y are formed once a tile and kept in registers for all of them.
// - The frames pass through a two-stage ring in shared memory in the operand dtype: frame
//   k+1 is copied by 16-byte `cp.async` vectors (rows reflect whole; element by element
//   through the reflect only where a vector leaves the image) while frame k computes, with
//   one barrier a frame.
// - Separable window sums: a thread owns one column and four rows of the tile. It walks
//   down the six staged rows around them, forms each row's 3-sums of x, x^2 and x*y from
//   the three columns around its own, and adds the last three rows' sums into the window
//   sums of x, x^2, x*y; the term takes the target's statistics pre-combined: 9 shared
//   loads and about 45 fp32 operations (two of them MUFU) a pixel and plane.
// Bound on this card: bytes at 3.35 TB/s (every frame and the target read once, the
// outputs and code written once). Above it: the staging alone and the arithmetic alone each
// take most of the kernel's time, and they overlap only in part (`chip_k1_sweep.py`).
//
// K2 returns d out / d preds for a cotangent (S, B, H, W) fp32, in the preds' dtype. The
// frame-min routes it as `jnp.minimum` does (a tie splits it in halves down the chain),
// read from K1's routing code, so the backward routes exactly as the forward decided; the
// clip passes 1 strictly inside [0, 1] and 1/2 on its ends, as `jnp.clip` does. With the
// window statistics of a stat pixel p and the cotangents P1 = dL/dmu_x / 9,
// P2 = 2 dL/dsigma_x / 9, P3 = dL/dsigma_xy / 9 of that window, a PADDED position q of
// the window receives P1 + P2 (x_q - mu_x) + P3 (y_q - mu_y). An image pixel gathers this
// from every padded position that holds a copy of it -- itself, and the reflect-ring copies
// where i or j is 1 or H-2 (W-2), counted as a multiplicity of 1, 2 or 4 of the stat
// pixel's term -- plus the cotangent of its own Charbonnier term. So the ring and corner
// gradients that the TPU kernel left to XLA are exact sums here, with nothing counted twice.
//
// K2's design: one block per (s, b, frame) and 32 x 32 output tile, 256 threads.
// - The frame's weight at each of the 34 x 34 stat pixels comes from the routing code and
//   the cotangent; a block whose frame gets no weight anywhere writes zeros and stops.
// - It stages the target and the frame's C planes over 36 x 36 pixels (halo 1.27x the
//   tile) in the operand dtype, rows aligned on the tile's first column: 16-byte
//   `cp.async` vectors wherever they lie in the image (rows reflect whole), element by
//   element through the reflect only where a vector leaves it.
// - One pass over the statistics per channel, only at stat pixels with weight: a thread
//   walks down a column of stat pixels keeping three staged rows in registers; the window
//   means come from three-column sums shared by the three windows that hold a row, and the
//   second moments are taken around the window means, sigma_x = sum (x - mu_x)^2 / 9 and
//   sigma_xy = sum (x - mu_x)(y - mu_y) / 9, which keeps flat (border-clamped) windows from
//   cancelling. One reciprocal of den. P1, P2, P3, mu_x and mu_y go to shared memory.
// - The gather: a thread owns four pixels of a column and reads the six stat rows around
//   them once, each term taken around its own window's means (no x^2 against mu^2).
// Bound on this card: operations (REPROJ_OPS_BWD in chip_smoke.py) against bytes, the
// larger; the staging, the shared-memory traffic of the gather and the zero weights of the
// frames that lost the min are what it pays above that.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "cp_async.cuh"

namespace {

constexpr int MAX_C = 4, MAX_F = 8;
constexpr float kC1 = 0.01f * 0.01f, kC2 = 0.03f * 0.03f;
constexpr float kSsimW = 0.85f, kL1W = 0.15f, kEps = 1e-3f, kNinth = 1.0f / 9.0f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// Padded coordinate -> image coordinate under the 1-pixel reflect pad; positions further
// out are clamped (they feed only statistics of pixels outside the image, never used).
__device__ __forceinline__ int reflect(int v, int n) {
  if (v < 0) v = -v;
  if (v >= n) v = 2 * n - 2 - v;
  return min(max(v, 0), n - 1);
}

// ----------------------------------------------------------------------------------------
// K1: forward
// ----------------------------------------------------------------------------------------

constexpr int K1_TW = 32;  // tile columns: one warp across
constexpr int K1_RPT = 4;  // output rows a thread

// A K1 block's shared memory: a two-stage ring of staged frames in T, then the target in
// fp32.
template <typename T, int C, int TH>
struct K1Layout {
  static constexpr int A = 16 / sizeof(T);        // elements in 16 bytes
  static constexpr int PITCH = 2 * A + K1_TW;      // x row: image column j0 - A + k at k
  static constexpr int VECS = PITCH / A;
  static constexpr int ROWS = TH + 2;              // image rows i0 - 1 .. i0 + TH
  static constexpr int FRAME = C * ROWS * PITCH;   // one frame's planes, in T
  static constexpr int YP = K1_TW + 2;             // target row: column j0 - 1 + q at q
  static constexpr int THREADS = K1_TW * TH / K1_RPT;
  static constexpr int BYTES = 2 * FRAME * (int)sizeof(T) + C * ROWS * YP * 4;
};

// Stage a frame's C planes (src, channel-planar) over image rows i0-1 .. i0+TH and columns
// j0-1 .. j0+32, reflect-padded. Rows map whole through the reflect, so every 16-byte vector
// of a row that lies in the image is one `cp.async`; the vectors that leave it go element
// by element (only the elements the windows read).
template <typename T, int C, int TH>
__device__ __forceinline__ void k1_stage(T* dst, const T* src, int i0, int j0, int H, int W,
                                         bool vec_rows) {
  using L = K1Layout<T, C, TH>;
  constexpr int A = L::A;
  const size_t plane = (size_t)H * W;
  for (int e = threadIdx.x; e < C * L::ROWS * L::VECS; e += L::THREADS) {
    const int v = e % L::VECS, rr = (e / L::VECS) % L::ROWS, c = e / (L::VECS * L::ROWS);
    const T* row = src + c * plane + (size_t)reflect(i0 - 1 + rr, H) * W;
    const int c0 = j0 - A + v * A;
    T* d = dst + (c * L::ROWS + rr) * L::PITCH + v * A;
    if (vec_rows && c0 >= 0 && c0 + A <= W) {
      cp_async16(d, row + c0, true);
    } else {
#pragma unroll
      for (int u = 0; u < A; ++u)
        if (v * A + u >= A - 1 && v * A + u <= A + K1_TW) d[u] = row[reflect(c0 + u, W)];
    }
  }
}

// The target's window statistics at one pixel and channel, in the form the term uses:
// 2 mu_y, mu_y^2 + C1 and sigma_y + C2.
struct TargStat {
  float m2, a, b;
};

// The per-channel loss term at one pixel from its 3x3 window sums of x, x^2 and x*y, the
// target's statistics and the centre values: with p = 2 mu_x mu_y,
//   num = (p + C1) (2 sum(xy)/9 + C2 - p),
//   den = (mu_x^2 + mu_y^2 + C1) (sum(x^2)/9 + sigma_y + C2 - mu_x^2),
// the contract's uncentred statistics, and the Charbonnier root as q rsqrt(q).
__device__ __forceinline__ float term(float sx, float sxx, float sxy, const TargStat& t,
                                      float xc, float yc) {
  const float mu_x = sx * kNinth;
  const float p = mu_x * t.m2;
  const float num = (p + kC1) * (fmaf(2.f * kNinth, sxy, kC2) - p);
  const float den = fmaf(mu_x, mu_x, t.a) * fmaf(-mu_x, mu_x, fmaf(sxx, kNinth, t.b));
  const float s = __saturatef(fmaf(-0.5f, __fdividef(num, den), 0.5f));
  const float d = yc - xc, q = fmaf(d, d, kEps * kEps);
  return fmaf(kSsimW, s, kL1W * (q * rsqrtf(q)));
}

// One channel plane of one frame: adds the term at the thread's K1_RPT pixels to acc. xs is
// the staged plane at the thread's first row and the window's left column, ys the target's.
// Row k's 3-sums enter the window sums of pixels k-2 .. k (rows k-2, k-1, k).
template <typename T, int PITCH>
__device__ __forceinline__ void k1_plane(const T* xs, const float* ys, const TargStat* ts,
                                         float* acc) {
  constexpr int YP = K1_TW + 2;
  float hx[2] = {0.f, 0.f}, hxx[2] = {0.f, 0.f}, hxy[2] = {0.f, 0.f}, xc = 0.f, yc = 0.f;
#pragma unroll
  for (int k = 0; k < K1_RPT + 2; ++k) {
    const float a0 = to_f32(xs[k * PITCH]), a1 = to_f32(xs[k * PITCH + 1]);
    const float a2 = to_f32(xs[k * PITCH + 2]);
    const float b0 = ys[k * YP], b1 = ys[k * YP + 1], b2 = ys[k * YP + 2];
    const float sx = a0 + a1 + a2, sxx = a0 * a0 + a1 * a1 + a2 * a2;
    const float sxy = a0 * b0 + a1 * b1 + a2 * b2;
    if (k >= 2)
      acc[k - 2] += term(hx[0] + hx[1] + sx, hxx[0] + hxx[1] + sxx, hxy[0] + hxy[1] + sxy,
                         ts[k - 2], xc, yc);
    hx[0] = hx[1], hxx[0] = hxx[1], hxy[0] = hxy[1];
    hx[1] = sx, hxx[1] = sxx, hxy[1] = sxy;
    xc = a1, yc = b1;
  }
}

// At most 85 registers a thread: three blocks of 256 threads (or six of 128, twelve of 64) a
// SM.
template <typename T, int C, int TH>
__global__ void __launch_bounds__(K1Layout<T, C, TH>::THREADS, 768 / K1Layout<T, C, TH>::THREADS)
reproj_fwd(const T* __restrict__ preds, const T* __restrict__ ident, const T* __restrict__ targ,
           float* __restrict__ out, uint16_t* __restrict__ code, float* __restrict__ ident_out,
           int S, int B, int F, int FI, int H, int W) {
  using L = K1Layout<T, C, TH>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ring = reinterpret_cast<T*>(smem_raw);                                       // [2][FRAME]
  float* ys = reinterpret_cast<float*>(smem_raw + 2 * L::FRAME * sizeof(T));      // [C][ROWS][YP]
  const int b = blockIdx.z, i0 = blockIdx.y * TH, j0 = blockIdx.x * K1_TW;
  const size_t plane = (size_t)H * W;
  const int NW = S * F, NK = NW + FI;  // the warped frames (s, f), then the identity frames
  const bool vec_rows = W % L::A == 0 && ((reinterpret_cast<uintptr_t>(preds) |
                                           reinterpret_cast<uintptr_t>(ident)) & 15) == 0;
  auto frame = [&](int k) -> const T* {
    return k < NW ? preds + ((size_t)((k / F) * B + b) * F + k % F) * C * plane
                  : ident + ((size_t)(k - NW) * B + b) * C * plane;
  };

  k1_stage<T, C, TH>(ring, frame(0), i0, j0, H, W, vec_rows);
  cp_async_commit();
  const T* tb = targ + (size_t)b * C * plane;
  for (int e = threadIdx.x; e < C * L::ROWS * L::YP; e += L::THREADS) {
    const int q = e % L::YP, rr = (e / L::YP) % L::ROWS, c = e / (L::YP * L::ROWS);
    ys[e] = to_f32(tb[c * plane + (size_t)reflect(i0 - 1 + rr, H) * W + reflect(j0 - 1 + q, W)]);
  }
  __syncthreads();

  // The target's window statistics at the thread's pixels, once for every frame.
  const int tx = threadIdx.x % K1_TW, ty = threadIdx.x / K1_TW;
  TargStat ts[C][K1_RPT];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const float* yc = ys + (c * L::ROWS + K1_RPT * ty) * L::YP + tx;
    float h[2] = {0.f, 0.f}, hh[2] = {0.f, 0.f};
#pragma unroll
    for (int k = 0; k < K1_RPT + 2; ++k) {
      const float b0 = yc[k * L::YP], b1 = yc[k * L::YP + 1], b2 = yc[k * L::YP + 2];
      const float s = b0 + b1 + b2, ss = b0 * b0 + b1 * b1 + b2 * b2;
      if (k >= 2) {
        const float m = (h[0] + h[1] + s) * kNinth;
        const float sig = (hh[0] + hh[1] + ss) * kNinth - m * m;
        ts[c][k - 2] = {2.f * m, fmaf(m, m, kC1), sig + kC2};
      }
      h[0] = h[1], hh[0] = hh[1];
      h[1] = s, hh[1] = ss;
    }
  }

  const int j = j0 + tx;
  float best[K1_RPT], acc[K1_RPT];
  unsigned route[K1_RPT];
  for (int k = 0; k < NK; ++k) {
    cp_async_wait<0>();
    __syncthreads();  // frame k has landed; every thread is done with frame k - 1's buffer
    if (k + 1 < NK) {
      k1_stage<T, C, TH>(ring + ((k + 1) & 1) * L::FRAME, frame(k + 1), i0, j0, H, W, vec_rows);
      cp_async_commit();
    }
    const T* xf = ring + (k & 1) * L::FRAME + K1_RPT * ty * L::PITCH + tx + L::A - 1;
#pragma unroll
    for (int p = 0; p < K1_RPT; ++p) acc[p] = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c)
      k1_plane<T, L::PITCH>(xf + c * L::ROWS * L::PITCH,
                            ys + (c * L::ROWS + K1_RPT * ty) * L::YP + tx, ts[c], acc);
    if (k < NW) {
      const int s = k / F, f = k % F;
#pragma unroll
      for (int p = 0; p < K1_RPT; ++p) {
        const float rl = acc[p] * (1.f / C);
        if (f == 0) {
          best[p] = rl;
          route[p] = 0u;
        } else {
          route[p] |= (rl < best[p] ? 1u : (rl == best[p] ? 2u : 0u)) << (2 * (f - 1));
          best[p] = fminf(best[p], rl);
        }
        const int i = i0 + K1_RPT * ty + p;
        if (f == F - 1 && i < H && j < W) {
          const size_t at = ((size_t)s * B + b) * plane + (size_t)i * W + j;
          out[at] = best[p];
          if (code != nullptr) code[at] = (uint16_t)route[p];
        }
      }
    } else {
#pragma unroll
      for (int p = 0; p < K1_RPT; ++p) {
        const int i = i0 + K1_RPT * ty + p;
        if (i < H && j < W)
          ident_out[((size_t)(k - NW) * B + b) * plane + (size_t)i * W + j] = acc[p] * (1.f / C);
      }
    }
  }
}

// ----------------------------------------------------------------------------------------
// K2: backward
// ----------------------------------------------------------------------------------------

constexpr int BT = 32;                   // output tile: BT x BT pixels
constexpr int BTHREADS = 256;            // 32 columns x 8 groups of 4 rows
constexpr int BMIN_BLOCKS = 4;           // blocks a SM: at most 64 registers a thread
constexpr int SR = BT + 4;               // staged rows: i0-2 .. i0+BT+1
constexpr int EW = BT + 2, NE = EW * EW;  // stat pixels: i0-1 .. i0+BT, j0-1 .. j0+BT
constexpr int SEG = 5, NSEG = (EW + SEG - 1) / SEG;  // stat-pass column segments
static_assert(EW * NSEG <= BTHREADS, "one stat-pass item a thread");

// Staged row layout in T: image column j0 - A + k at index k, A = 16 bytes of T, so the
// tile's first column starts a 16-byte vector; the pitch is 16-byte aligned.
template <typename T>
struct Staged {
  static constexpr int A = 16 / sizeof(T);
  static constexpr int PITCH = 2 * A + BT;
  static constexpr int VECS = PITCH / A;  // 16-byte vectors a row
};

// d out / d rl_f / C at one pixel, from the routing code and the cotangent.
__device__ __forceinline__ float frame_weight(unsigned code, float cot, int f, int F, float invC) {
  float a = cot;
  for (int k = F - 1; k >= 1; --k) {
    const unsigned o = (code >> (2 * (k - 1))) & 3u;
    const float wk = o == 1u ? a : (o == 2u ? 0.5f * a : 0.f);
    if (o == 1u) a = 0.f;
    if (o == 2u) a *= 0.5f;
    if (k == f) return wk * invC;
  }
  return a * invC;  // f == 0
}

// The gather of one channel onto pixels (4ty + k, tx) of the tile, k = 0..3: pixel (ti, tj)
// is stat (ti+1, tj+1) and staged (ti+2, tj+A); its stat neighbours are rows ti..ti+2, cols
// tj..tj+2. RING: the tile holds an image row or column 0, 1, n-2 or n-1, so reflect-ring
// copies count a stat pixel's term twice (four times at the corners).
template <typename T, bool RING>
__device__ __forceinline__ void gather(const T* xsp, const T* ysp, const float* wt,
                                       const float4* fq, const float* fmy, T* gout, int i0,
                                       int j0, int H, int W) {
  constexpr int A = Staged<T>::A, PITCH = Staged<T>::PITCH;
  const int tx = threadIdx.x % BT, ty = threadIdx.x / BT;
  const int j = j0 + tx;
  float xq[4], yq[4], acc[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    xq[k] = to_f32(xsp[(4 * ty + k + 2) * PITCH + tx + A]);
    yq[k] = to_f32(ysp[(4 * ty + k + 2) * PITCH + tx + A]);
    acc[k] = 0.f;
  }
  float mc[3];  // copies of column j in the windows of stat columns j-1, j, j+1
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    const int pj = j - 1 + q;
    mc[q] = RING ? 1.f + (j == 1 && pj == 0) + (j == W - 2 && pj == W - 1) : 1.f;
  }
#pragma unroll
  for (int s = 0; s < 6; ++s) {
    const int er = 4 * ty + s, pi = i0 - 1 + er;
    float4 fa[3];  // P1, P2, P3, mu_x
    float amy[3];
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      fa[q] = fq[er * EW + tx + q];
      amy[q] = fmy[er * EW + tx + q];
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (s < k || s > k + 2) continue;
      const int i = i0 + 4 * ty + k;
      const float mr = RING ? 1.f + (i == 1 && pi == 0) + (i == H - 2 && pi == H - 1) : 1.f;
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        const float t = fa[q].x + fa[q].y * (xq[k] - fa[q].w) + fa[q].z * (yq[k] - amy[q]);
        acc[k] += RING ? mr * mc[q] * t : t;
      }
    }
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int i = i0 + 4 * ty + k;
    if (i >= H || j >= W) continue;
    const float wd = wt[(4 * ty + k + 1) * EW + tx + 1];
    const float d = yq[k] - xq[k];
    const float g = acc[k] - kL1W * wd * d * rsqrtf(d * d + kEps * kEps);
    gout[(size_t)i * W + j] = from_f32<T>(g);
  }
}

template <typename T>
__global__ void __launch_bounds__(BTHREADS, BMIN_BLOCKS)
reproj_bwd(const T* __restrict__ preds, const T* __restrict__ targ,
           const float* __restrict__ cot, const uint16_t* __restrict__ code,
           T* __restrict__ grad, int B, int F, int C, int H, int W) {
  using S = Staged<T>;
  constexpr int A = S::A, PITCH = S::PITCH, PLANE = SR * PITCH;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* st = reinterpret_cast<T*>(smem_raw);  // [2C][SR][PITCH]: target planes, then x planes
  float* wt = reinterpret_cast<float*>(smem_raw + 2 * C * PLANE * sizeof(T));  // [NE]
  float4* fq = reinterpret_cast<float4*>(wt + NE);  // [NE] per channel: P1, P2, P3, mu_x
  float* fmy = reinterpret_cast<float*>(fq + NE);   // [NE] per channel: mu_y
  static_assert(NE % 4 == 0, "16-byte aligned statistics");
  const int sbf = blockIdx.z, f = sbf % F, sb = sbf / F, b = sb % B;
  const int i0 = blockIdx.y * BT, j0 = blockIdx.x * BT;
  const size_t plane = (size_t)H * W;
  const float invC = 1.f / C;
  const int tx = threadIdx.x % BT, ty = threadIdx.x / BT;
  T* gout = grad + (size_t)sbf * C * plane;

  // The frame's weight at the stat pixels; zero outside the image.
  bool any = false;
#pragma unroll
  for (int it = 0; it < (NE + BTHREADS - 1) / BTHREADS; ++it) {
    const int e = it * BTHREADS + threadIdx.x;
    if (e >= NE) break;
    const int pi = i0 - 1 + e / EW, pj = j0 - 1 + e % EW;
    float w = 0.f;
    if (pi >= 0 && pi < H && pj >= 0 && pj < W) {
      const size_t at = (size_t)sb * plane + (size_t)pi * W + pj;
      w = frame_weight(code[at], cot[at], f, F, invC);
    }
    wt[e] = w;
    any |= w != 0.f;
  }
  if (!__syncthreads_or(any)) {  // the frame lost the min around the whole tile
    for (int c = 0; c < C; ++c)
      for (int k = 0; k < 4; ++k) {
        const int i = i0 + 4 * ty + k, j = j0 + tx;
        if (i < H && j < W) gout[c * plane + (size_t)i * W + j] = from_f32<T>(0.f);
      }
    return;
  }

  // Stage: staged (row rr, index k) = image (reflect(i0 - 2 + rr), reflect(j0 - A + k)).
  // Rows map whole through the reflect, so every 16-byte vector of a row that lies in
  // the image is one `cp.async`; the vectors that leave it (at the tiles of the first and
  // last columns, or all when W is not a multiple of 16 bytes) go element by element.
  const T* tsrc = targ + (size_t)b * C * plane;
  const T* xsrc = preds + (size_t)sbf * C * plane;
  const bool vec_rows = W % A == 0 && ((reinterpret_cast<uintptr_t>(preds) |
                                        reinterpret_cast<uintptr_t>(targ)) & 15) == 0;
  for (int e = threadIdx.x; e < 2 * C * SR * S::VECS; e += BTHREADS) {
    const int v = e % S::VECS, rr = (e / S::VECS) % SR, pl = e / (S::VECS * SR);
    const T* row = (pl < C ? tsrc + pl * plane : xsrc + (pl - C) * plane) +
                   (size_t)reflect(i0 - 2 + rr, H) * W;
    const int c0 = j0 - A + v * A;
    T* dst = st + pl * PLANE + rr * PITCH + v * A;
    if (vec_rows && c0 >= 0 && c0 + A <= W) {
      cp_async16(dst, row + c0, true);
    } else {
#pragma unroll
      for (int u = 0; u < A; ++u)
        if (v * A + u >= A - 2 && v * A + u < A + BT + 2) dst[u] = row[reflect(c0 + u, W)];
    }
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const bool ring_tile = i0 <= 1 || i0 + BT >= H - 1 || j0 <= 1 || j0 + BT >= W - 1;
  for (int c = 0; c < C; ++c) {
    const T* ysp = st + c * PLANE;
    const T* xsp = st + (C + c) * PLANE;
    // Stat pass: stat column eq, rows er0 .. er1-1. Stat pixel (er, eq) is image
    // (i0-1+er, j0-1+eq); its window is staged rows er..er+2, indices eq+A-2 .. eq+A.
    if (threadIdx.x < EW * NSEG) {
      const int eq = threadIdx.x % EW, er0 = (threadIdx.x / EW) * SEG;
      const int er1 = min(er0 + SEG, EW);
      const T* xcol = xsp + eq + A - 2;
      const T* ycol = ysp + eq + A - 2;
      float xv[3][3], yv[3][3], sx[3], sy[3];
      for (int a = 0; a < 2; ++a) {
#pragma unroll
        for (int q = 0; q < 3; ++q) {
          xv[a][q] = to_f32(xcol[(er0 + a) * PITCH + q]);
          yv[a][q] = to_f32(ycol[(er0 + a) * PITCH + q]);
        }
        sx[a] = xv[a][0] + xv[a][1] + xv[a][2];
        sy[a] = yv[a][0] + yv[a][1] + yv[a][2];
      }
      for (int er = er0; er < er1; ++er) {
#pragma unroll
        for (int q = 0; q < 3; ++q) {
          xv[2][q] = to_f32(xcol[(er + 2) * PITCH + q]);
          yv[2][q] = to_f32(ycol[(er + 2) * PITCH + q]);
        }
        sx[2] = xv[2][0] + xv[2][1] + xv[2][2];
        sy[2] = yv[2][0] + yv[2][1] + yv[2][2];
        const int e = er * EW + eq;
        const float wd = wt[e];
        float p1 = 0.f, p2 = 0.f, p3 = 0.f, mx = 0.f, my = 0.f;
        if (wd != 0.f) {
          mx = (sx[0] + sx[1] + sx[2]) * kNinth;
          my = (sy[0] + sy[1] + sy[2]) * kNinth;
          float sxx = 0.f, syy = 0.f, sxy = 0.f;
#pragma unroll
          for (int a = 0; a < 3; ++a)
#pragma unroll
            for (int q = 0; q < 3; ++q) {
              const float dx = xv[a][q] - mx, dy = yv[a][q] - my;
              sxx += dx * dx;
              syy += dy * dy;
              sxy += dx * dy;
            }
          const float Am = 2.f * mx * my + kC1, Bn = 2.f * (sxy * kNinth) + kC2;
          const float D = mx * mx + my * my + kC1, E = (sxx + syy) * kNinth + kC2;
          const float num = Am * Bn, den = D * E;
          // clip((1 - num/den) / 2): 1 strictly inside (0, 1), 1/2 on its ends (den > 0).
          const float kclip = (num < den && num > -den) ? 1.f
                              : ((num == den || num == -den) ? 0.5f : 0.f);
          const float gq = -0.5f * kSsimW * wd * kclip;  // d / d (num/den)
          if (gq != 0.f) {
            const float inv = 1.f / den, ratio = num * inv;
            const float gA = gq * Bn * inv, gB = gq * Am * inv, t = -gq * ratio * inv;
            const float gD = t * E, gE = t * D;
            p1 = (2.f * my * gA + 2.f * mx * gD) * kNinth;
            p2 = 2.f * gE * kNinth;
            p3 = 2.f * gB * kNinth;
          }
        }
        fq[e] = make_float4(p1, p2, p3, mx);
        fmy[e] = my;
#pragma unroll
        for (int q = 0; q < 3; ++q) {
          xv[0][q] = xv[1][q];
          xv[1][q] = xv[2][q];
          yv[0][q] = yv[1][q];
          yv[1][q] = yv[2][q];
        }
        sx[0] = sx[1];
        sx[1] = sx[2];
        sy[0] = sy[1];
        sy[1] = sy[2];
      }
    }
    __syncthreads();

    if (ring_tile)
      gather<T, true>(xsp, ysp, wt, fq, fmy, gout + c * plane, i0, j0, H, W);
    else
      gather<T, false>(xsp, ysp, wt, fq, fmy, gout + c * plane, i0, j0, H, W);
    __syncthreads();  // the next channel overwrites the statistics
  }
}

template <typename T>
int smem_bwd(int C) {
  return 2 * C * SR * Staged<T>::PITCH * (int)sizeof(T) + 6 * NE * 4;
}

struct FwdArgs {
  const void *preds, *ident, *targ;
  float* out;
  void* code;
  float* ident_out;
  int S, B, F, FI, H, W;
};

template <typename T, int C, int TH>
int launch_fwd(const FwdArgs& a, cudaStream_t s) {
  using L = K1Layout<T, C, TH>;
  const dim3 grid((a.W + K1_TW - 1) / K1_TW, (a.H + TH - 1) / TH, a.B);
  cudaError_t err = cudaFuncSetAttribute(reproj_fwd<T, C, TH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, L::BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  reproj_fwd<T, C, TH><<<grid, L::THREADS, L::BYTES, s>>>(
      static_cast<const T*>(a.preds), static_cast<const T*>(a.ident),
      static_cast<const T*>(a.targ), a.out, static_cast<uint16_t*>(a.code), a.ident_out, a.S,
      a.B, a.F, a.FI, a.H, a.W);
  return static_cast<int>(cudaGetLastError());
}

// The channels and the tile rows are compile-time constants, so a thread's statistics stay in
// registers and its walks unroll.
template <typename T, int C>
int launch_fwd_th(const FwdArgs& a, int th, cudaStream_t s) {
  switch (th) {
    case 8: return launch_fwd<T, C, 8>(a, s);
    case 16: return launch_fwd<T, C, 16>(a, s);
    case 32: return launch_fwd<T, C, 32>(a, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int launch_fwd_c(const FwdArgs& a, int C, int th, cudaStream_t s) {
  switch (C) {
    case 1: return launch_fwd_th<T, 1>(a, th, s);
    case 2: return launch_fwd_th<T, 2>(a, th, s);
    case 3: return launch_fwd_th<T, 3>(a, th, s);
    case 4: return launch_fwd_th<T, 4>(a, th, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int launch_bwd(const void* preds, const void* targ, const float* cot, const void* code,
               void* grad, int S, int B, int F, int C, int H, int W, cudaStream_t s) {
  const dim3 grid((W + BT - 1) / BT, (H + BT - 1) / BT, S * B * F);
  const int bytes = smem_bwd<T>(C);
  cudaError_t err =
      cudaFuncSetAttribute(reproj_bwd<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  reproj_bwd<T><<<grid, BTHREADS, bytes, s>>>(
      static_cast<const T*>(preds), static_cast<const T*>(targ), cot,
      static_cast<const uint16_t*>(code), static_cast<T*>(grad), B, F, C, H, W);
  return static_cast<int>(cudaGetLastError());
}

bool valid(int S, int B, int F, int C, int H, int W) {
  return F >= 1 && F <= MAX_F && C >= 1 && C <= MAX_C && H >= 2 && W >= 2 && S >= 1 && B >= 1;
}

}  // namespace

// K1. preds (S, B, F, C, H, W), ident (FI, B, C, H, W) or null with FI = 0, and targ
// (B, C, H, W), contiguous, all of `dtype` (0 = float32, 1 = bfloat16); out (S, B, H, W)
// fp32; code (S, B, H, W) uint16, or null for no routing code; ident_out (FI, B, H, W) fp32;
// th the tile rows of `k1_plan` (8, 16 or 32). Returns the cudaError_t.
extern "C" int jp_reproj_fwd(const void* preds, const void* ident, const void* targ, float* out,
                             void* code, float* ident_out, int S, int B, int F, int FI, int C,
                             int H, int W, int th, int dtype, void* stream) {
  if (!valid(S, B, F, C, H, W) || FI < 0 || (FI > 0 && (ident == nullptr || ident_out == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const FwdArgs a{preds, ident, targ, out, code, ident_out, S, B, F, FI, H, W};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return launch_fwd_c<__nv_bfloat16>(a, C, th, s);
  if (dtype == 0) return launch_fwd_c<float>(a, C, th, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// K2. preds and targ as for K1, cot (S, B, H, W) fp32 and the forward's routing code;
// grad (S, B, F, C, H, W) of `dtype`.
extern "C" int jp_reproj_bwd(const void* preds, const void* targ, const float* cot,
                             const void* code, void* grad, int S, int B, int F, int C, int H,
                             int W, int dtype, void* stream) {
  if (!valid(S, B, F, C, H, W) || code == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch_bwd<__nv_bfloat16>(preds, targ, cot, code, grad, S, B, F, C, H, W, s);
  if (dtype == 0) return launch_bwd<float>(preds, targ, cot, code, grad, S, B, F, C, H, W, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
