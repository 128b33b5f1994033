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
// K2 returns d out / d preds for a cotangent (S, B, H, W) fp32, in the preds' dtype. The
// frame-min routes it as `jnp.minimum` does (a tie splits it in halves down the chain) and
// the clip passes 1 strictly inside [0, 1] and 1/2 on its ends, as `jnp.clip` does. With
// P1, P2, P3 the cotangents of the window sums of x, x^2 and x*y at each stat pixel, a
// PADDED position q receives WS(P1) + 2 x(q) WS(P2) + y(q) WS(P3), WS the sum over the
// stat pixels whose window holds q. An image pixel (i, j) gathers this from every padded
// position that holds a copy of it -- itself, and the reflect-ring copies where i or j is
// 1 or H-2 (W-2) -- plus the cotangent of its own Charbonnier term. So the ring and
// corner gradients that the TPU kernel left to XLA are exact sums here, with nothing
// counted twice.
//
// Design: one thread block per (s, b) and 8 x 32 pixel tile. K1 stages the target and
// every frame's channels of the tile plus a 1-pixel reflect halo in shared memory as fp32
// (the target's statistics are computed once for all frames) and computes each pixel's
// 3x3 sums from there. K2 stages a 2-pixel halo, computes the frame-min routing and the
// stat cotangents on the tile's 10 x 34 stat pixels, and gathers them onto the image
// pixels. Bound on this card: bytes -- each input read once and each output written once
// at 3.35 TB/s; the fp32 arithmetic, some 40 operations a pixel, channel and frame, is below
// the 67 TFLOP/s non-tensor rate at those bytes. The halo re-reads (1.33x in K1, 1.5x in
// K2) and K2's recomputation of the statistics are what this first version pays above it.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int TW = 32, TH = 8, THREADS = TW * TH;
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

// Stage the target's C channel planes and then the F*C planes of the preds of one (s, b),
// over a (rh x rw) region whose top-left image position is (r0, c0), into shared memory
// as fp32, reflect-padded.
template <typename T>
__device__ void stage(float* dst, const T* targ, const T* preds, int C, int F, int rh, int rw,
                      int r0, int c0, int H, int W) {
  const int n = rh * rw;
  const size_t plane = (size_t)H * W;
  for (int e = threadIdx.x; e < (C + F * C) * n; e += blockDim.x) {
    const int pl = e / n, k = e - pl * n;
    const int r = k / rw, q = k - r * rw;
    const T* src = pl < C ? targ + pl * plane : preds + (pl - C) * plane;
    dst[e] = to_f32(src[(size_t)reflect(r0 + r, H) * W + reflect(c0 + q, W)]);
  }
}

struct Win {
  float sx, sxx, sxy;
};

// 3x3 window sums at region position (r, q) (top-left of the window) of x, x^2 and x*y.
__device__ __forceinline__ Win window(const float* x, const float* y, int r, int q, int rw) {
  Win w = {0.f, 0.f, 0.f};
#pragma unroll
  for (int dr = 0; dr < 3; ++dr)
#pragma unroll
    for (int dq = 0; dq < 3; ++dq) {
      const float a = x[(r + dr) * rw + q + dq], b = y[(r + dr) * rw + q + dq];
      w.sx += a;
      w.sxx += a * a;
      w.sxy += a * b;
    }
  return w;
}

__device__ __forceinline__ void target_stats(const float* y, int r, int q, int rw, float* mu_y,
                                             float* sig_y) {
  float s = 0.f, ss = 0.f;
#pragma unroll
  for (int dr = 0; dr < 3; ++dr)
#pragma unroll
    for (int dq = 0; dq < 3; ++dq) {
      const float b = y[(r + dr) * rw + q + dq];
      s += b;
      ss += b * b;
    }
  *mu_y = s * kNinth;
  *sig_y = ss * kNinth - *mu_y * *mu_y;
}

// The per-channel loss term at one pixel from its window sums.
__device__ __forceinline__ float term(const Win& w, float mu_y, float sig_y, float xc, float yc) {
  const float mu_x = w.sx * kNinth;
  const float sig_x = w.sxx * kNinth - mu_x * mu_x;
  const float sig_xy = w.sxy * kNinth - mu_x * mu_y;
  const float num = (2.f * mu_x * mu_y + kC1) * (2.f * sig_xy + kC2);
  const float den = (mu_x * mu_x + mu_y * mu_y + kC1) * (sig_x + sig_y + kC2);
  const float s = fminf(fmaxf((1.f - num / den) * 0.5f, 0.f), 1.f);
  const float d = yc - xc;
  return kSsimW * s + kL1W * sqrtf(d * d + kEps * kEps);
}

// ----------------------------------------------------------------------------------------
// K1: forward
// ----------------------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(THREADS)
reproj_fwd(const T* __restrict__ preds, const T* __restrict__ targ, float* __restrict__ out,
           int B, int F, int C, int H, int W) {
  extern __shared__ float smem[];
  constexpr int RH = TH + 2, RW = TW + 2, N = RH * RW;
  float* ys = smem;          // [C][N]
  float* xs = smem + C * N;  // [F][C][N]
  const int sb = blockIdx.z, b = sb % B;
  const int i0 = blockIdx.y * TH, j0 = blockIdx.x * TW;
  const size_t plane = (size_t)H * W;

  stage(smem, targ + (size_t)b * C * plane, preds + (size_t)sb * F * C * plane, C, F, RH, RW,
        i0 - 1, j0 - 1, H, W);
  __syncthreads();

  const int tx = threadIdx.x % TW, ty = threadIdx.x / TW;
  const int i = i0 + ty, j = j0 + tx;
  if (i >= H || j >= W) return;
  float mu_y[MAX_C], sig_y[MAX_C];
  for (int c = 0; c < C; ++c) target_stats(ys + c * N, ty, tx, RW, &mu_y[c], &sig_y[c]);
  float best = 0.f;
  for (int f = 0; f < F; ++f) {
    float acc = 0.f;
    for (int c = 0; c < C; ++c) {
      const float* x = xs + (f * C + c) * N;
      const float* y = ys + c * N;
      const Win w = window(x, y, ty, tx, RW);
      acc += term(w, mu_y[c], sig_y[c], x[(ty + 1) * RW + tx + 1], y[(ty + 1) * RW + tx + 1]);
    }
    const float rl = acc * (1.f / C);
    best = f == 0 ? rl : fminf(best, rl);
  }
  out[(size_t)sb * plane + (size_t)i * W + j] = best;
}

// ----------------------------------------------------------------------------------------
// K2: backward
// ----------------------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(THREADS)
reproj_bwd(const T* __restrict__ preds, const T* __restrict__ targ,
           const float* __restrict__ cot, T* __restrict__ grad, int B, int F, int C, int H,
           int W) {
  extern __shared__ float smem[];
  constexpr int RH = TH + 4, RW = TW + 4, N = RH * RW;  // pixels, 2-pixel halo
  constexpr int EH = TH + 2, EW = TW + 2, NE = EH * EW;  // stat pixels, 1-pixel halo
  float* ys = smem;                // [C][N]
  float* xs = ys + C * N;          // [F][C][N]
  float* wt = xs + F * C * N;      // [F][NE]: d out / d (per-frame loss) / C
  float* pc = wt + F * NE;         // [C][4][NE]: P1, P2, P3, P_center of one frame
  const int sb = blockIdx.z, b = sb % B;
  const int i0 = blockIdx.y * TH, j0 = blockIdx.x * TW;
  const size_t plane = (size_t)H * W;

  stage(smem, targ + (size_t)b * C * plane, preds + (size_t)sb * F * C * plane, C, F, RH, RW,
        i0 - 2, j0 - 2, H, W);
  __syncthreads();

  // Stat pixel e = (er, eq) of the ext region is image pixel (i0-1+er, j0-1+eq); its window
  // starts at region position (er, eq), its center at (er+1, eq+1).
  for (int e = threadIdx.x; e < NE; e += blockDim.x) {
    const int er = e / EW, eq = e - er * EW;
    const int pi = i0 - 1 + er, pj = j0 - 1 + eq;
    if (pi < 0 || pi >= H || pj < 0 || pj >= W) {
      for (int f = 0; f < F; ++f) wt[f * NE + e] = 0.f;
      continue;
    }
    float mu_y[MAX_C], sig_y[MAX_C];
    for (int c = 0; c < C; ++c) target_stats(ys + c * N, er, eq, RW, &mu_y[c], &sig_y[c]);
    float rl[MAX_F];
    for (int f = 0; f < F; ++f) {
      float acc = 0.f;
      for (int c = 0; c < C; ++c) {
        const float* x = xs + (f * C + c) * N;
        const float* y = ys + c * N;
        const Win w = window(x, y, er, eq, RW);
        acc += term(w, mu_y[c], sig_y[c], x[(er + 1) * RW + eq + 1], y[(er + 1) * RW + eq + 1]);
      }
      rl[f] = acc * (1.f / C);
    }
    // best_0 = rl_0, best_k = min(best_{k-1}, rl_k); route the cotangent back down it.
    float best[MAX_F];
    best[0] = rl[0];
    for (int f = 1; f < F; ++f) best[f] = fminf(best[f - 1], rl[f]);
    float a = cot[(size_t)sb * plane + (size_t)pi * W + pj];
    for (int f = F - 1; f >= 1; --f) {
      float wf = 0.f;
      if (rl[f] < best[f - 1]) {
        wf = a;
        a = 0.f;
      } else if (rl[f] == best[f - 1]) {
        wf = 0.5f * a;
        a = 0.5f * a;
      }
      wt[f * NE + e] = wf * (1.f / C);
    }
    wt[e] = a * (1.f / C);
  }
  __syncthreads();

  const int tx = threadIdx.x % TW, ty = threadIdx.x / TW;
  const int i = i0 + ty, j = j0 + tx;
  // Padded positions holding a copy of pixel (i, j): rows i, and -1 or H when i is 1 or H-2.
  int qr[3], qc[3], nqr = 0, nqc = 0;
  qr[nqr++] = i;
  if (i == 1) qr[nqr++] = -1;
  if (i == H - 2) qr[nqr++] = H;
  qc[nqc++] = j;
  if (j == 1) qc[nqc++] = -1;
  if (j == W - 2) qc[nqc++] = W;

  for (int f = 0; f < F; ++f) {
    for (int e = threadIdx.x; e < NE; e += blockDim.x) {
      const int er = e / EW, eq = e - er * EW;
      const float wd = wt[f * NE + e];
      for (int c = 0; c < C; ++c) {
        float p1 = 0.f, p2 = 0.f, p3 = 0.f, pxc = 0.f;
        if (wd != 0.f) {
          const float* x = xs + (f * C + c) * N;
          const float* y = ys + c * N;
          float mu_y, sig_y;
          target_stats(y, er, eq, RW, &mu_y, &sig_y);
          const Win w = window(x, y, er, eq, RW);
          const float mu_x = w.sx * kNinth;
          const float sig_x = w.sxx * kNinth - mu_x * mu_x;
          const float sig_xy = w.sxy * kNinth - mu_x * mu_y;
          const float A = 2.f * mu_x * mu_y + kC1, Bn = 2.f * sig_xy + kC2;
          const float D = mu_x * mu_x + mu_y * mu_y + kC1, E = sig_x + sig_y + kC2;
          const float num = A * Bn, den = D * E;
          const float z = (1.f - num / den) * 0.5f;
          const float kclip = (z > 0.f && z < 1.f) ? 1.f : ((z == 0.f || z == 1.f) ? 0.5f : 0.f);
          const float dq = -0.5f * kSsimW * wd * kclip;  // d / d (num/den)
          const float dnum = dq / den, dden = -dq * num / (den * den);
          const float dA = dnum * Bn, dBn = dnum * A, dD = dden * E, dE = dden * D;
          const float dsig_xy = 2.f * dBn, dsig_x = dE;
          const float dmu_x = 2.f * mu_y * dA + 2.f * mu_x * dD - 2.f * mu_x * dsig_x - mu_y * dsig_xy;
          p1 = dmu_x * kNinth;
          p2 = dsig_x * kNinth;
          p3 = dsig_xy * kNinth;
          const float xc = x[(er + 1) * RW + eq + 1], yc = y[(er + 1) * RW + eq + 1];
          const float d = yc - xc;
          pxc = -kL1W * wd * d / sqrtf(d * d + kEps * kEps);
        }
        float* pcc = pc + c * 4 * NE;
        pcc[e] = p1;
        pcc[NE + e] = p2;
        pcc[2 * NE + e] = p3;
        pcc[3 * NE + e] = pxc;
      }
    }
    __syncthreads();
    if (i < H && j < W) {
      for (int c = 0; c < C; ++c) {
        const float* pcc = pc + c * 4 * NE;
        float u1 = 0.f, u2 = 0.f, u3 = 0.f;
        for (int a = 0; a < nqr; ++a)
          for (int bq = 0; bq < nqc; ++bq)
            for (int dr = -1; dr <= 1; ++dr) {
              const int pi = qr[a] + dr;
              if (pi < 0 || pi >= H) continue;
              for (int dc = -1; dc <= 1; ++dc) {
                const int pj = qc[bq] + dc;
                if (pj < 0 || pj >= W) continue;
                const int e = (pi - i0 + 1) * EW + (pj - j0 + 1);
                u1 += pcc[e];
                u2 += pcc[NE + e];
                u3 += pcc[2 * NE + e];
              }
            }
        const int ec = (ty + 1) * EW + tx + 1;
        const float xv = xs[(f * C + c) * N + (ty + 2) * RW + tx + 2];
        const float yv = ys[c * N + (ty + 2) * RW + tx + 2];
        const float g = pcc[3 * NE + ec] + u1 + 2.f * xv * u2 + yv * u3;
        grad[(((size_t)sb * F + f) * C + c) * plane + (size_t)i * W + j] = from_f32<T>(g);
      }
    }
    __syncthreads();  // the next frame overwrites pc
  }
}

int smem_fwd(int F, int C) { return (C + F * C) * (TH + 2) * (TW + 2) * 4; }
int smem_bwd(int F, int C) {
  const int n = (TH + 4) * (TW + 4), ne = (TH + 2) * (TW + 2);
  return ((C + F * C) * n + F * ne + C * 4 * ne) * 4;
}

template <typename T>
int launch(const void* preds, const void* targ, const float* cot, void* out, int S, int B, int F,
           int C, int H, int W, cudaStream_t s) {
  const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, S * B);
  if (cot == nullptr) {
    const int bytes = smem_fwd(F, C);
    cudaError_t err =
        cudaFuncSetAttribute(reproj_fwd<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    reproj_fwd<T><<<grid, THREADS, bytes, s>>>(static_cast<const T*>(preds),
                                               static_cast<const T*>(targ),
                                               static_cast<float*>(out), B, F, C, H, W);
  } else {
    const int bytes = smem_bwd(F, C);
    cudaError_t err =
        cudaFuncSetAttribute(reproj_bwd<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    reproj_bwd<T><<<grid, THREADS, bytes, s>>>(static_cast<const T*>(preds),
                                               static_cast<const T*>(targ), cot,
                                               static_cast<T*>(out), B, F, C, H, W);
  }
  return static_cast<int>(cudaGetLastError());
}

int dispatch(const void* preds, const void* targ, const float* cot, void* out, int S, int B,
             int F, int C, int H, int W, int dtype, void* stream) {
  if (F < 1 || F > MAX_F || C < 1 || C > MAX_C || H < 2 || W < 2 || S * B < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return launch<__nv_bfloat16>(preds, targ, cot, out, S, B, F, C, H, W, s);
  if (dtype == 0) return launch<float>(preds, targ, cot, out, S, B, F, C, H, W, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// preds (S, B, F, C, H, W) and targ (B, C, H, W), contiguous, both of `dtype`
// (0 = float32, 1 = bfloat16); out (S, B, H, W) fp32. Returns the cudaError_t.
extern "C" int jp_reproj_fwd(const void* preds, const void* targ, float* out, int S, int B, int F,
                             int C, int H, int W, int dtype, void* stream) {
  return dispatch(preds, targ, nullptr, out, S, B, F, C, H, W, dtype, stream);
}

// As jp_reproj_fwd, with cot (S, B, H, W) fp32; grad (S, B, F, C, H, W) of `dtype`.
extern "C" int jp_reproj_bwd(const void* preds, const void* targ, const float* cot, void* grad,
                             int S, int B, int F, int C, int H, int W, int dtype, void* stream) {
  return dispatch(preds, targ, cot, grad, S, B, F, C, H, W, dtype, stream);
}
