// Equality-mask backward of the ResNet stem's 3x3 stride-2 max-pool, hand-written for Hopper
// (sm_90a).
//
// Replaces the XLA backward `jperceiver_tpu/ops/pallas/maxpool.py::_mp3_bwd` (the JAX package
// has no Pallas kernel for it): for y = max_pool_3x3_s2(x) (window m covers inputs 2m - 1,
// 2m, 2m + 1 on each axis, out-of-image positions -inf) and a cotangent g,
//   dx[i, j] = sum over the windows (mr, mc) that hold (i, j), row window first, then column
//              window, each ascending, of (x[i, j] == y[mr, mc] ? g[mr, mc] : 0),
// every tied maximum taking the whole cotangent, each addition rounded to the operand dtype.
// `_mp3_bwd` and the plain PyTorch backward add nine terms over the stride-2 dilated grid in
// that order from zero; the terms they add beyond these are zeros, which leave a rounded sum
// unchanged, so the kernel equals them bit for bit (a zero's sign aside).
//
// An input row of even index i lies in one window (i / 2), an odd one in two ((i - 1) / 2 and
// (i + 1) / 2, the latter when it exists); the same for columns. So a thread owns one 16-byte
// channel vector of one input pixel (channels-last), reads x once and the 1, 2 or 4 (y, g)
// vector pairs of its windows, and writes dx once: no dilated tensors, no zeros tensor. bf16
// compares and adds as bf16x2 pairs (`pool_vec.cuh`). Neighbouring pixels share windows, so a
// warp's reads of y and g hit L1.
// Bound on this card: bytes at 3.35 TB/s -- x and the cotangent-sized y and g read once, dx
// written once.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "pool_vec.cuh"

namespace {

constexpr int THREADS = 256;

template <typename T, int VEC>
__global__ void __launch_bounds__(THREADS)
maxpool3x3s2_bwd_nhwc(const T* __restrict__ x, const T* __restrict__ y,
                      const T* __restrict__ g, T* __restrict__ dx, int H, int W, int Ho, int Wo,
                      int Cv, long long n) {
  using P = Pack<T, VEC>;
  const long long e = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (e >= n) return;
  const int v = (int)(e % Cv);
  long long p = e / Cv;
  const int j = (int)(p % W);
  p /= W;
  const int i = (int)(p % H);
  const int b = (int)(p / H);
  // The windows that hold row i (column j): i / 2 when even, (i -+ 1) / 2 when odd.
  const int r0 = (i - (i & 1)) / 2, r1 = min((i + (i & 1)) / 2, Ho - 1);
  const int c0 = (j - (j & 1)) / 2, c1 = min((j + (j & 1)) / 2, Wo - 1);
  const P xv = reinterpret_cast<const P*>(x)[e];
  const P* yb = reinterpret_cast<const P*>(y) + (size_t)b * Ho * Wo * Cv + v;
  const P* gb = reinterpret_cast<const P*>(g) + (size_t)b * Ho * Wo * Cv + v;
  P acc;
#pragma unroll
  for (int u = 0; u < VEC; ++u) acc.v[u] = from_f32<T>(0.f);
  for (int mr = r0; mr <= r1; ++mr)
    for (int mc = c0; mc <= c1; ++mc) {
      const size_t o = ((size_t)mr * Wo + mc) * Cv;
      vroute(acc, xv, yb[o], gb[o]);
    }
  reinterpret_cast<P*>(dx)[e] = acc;
}

template <typename T, int VEC>
int launch(const void* x, const void* y, const void* g, void* dx, int B, int H, int W, int C,
           cudaStream_t s) {
  const int Cv = C / VEC, Ho = (H - 1) / 2 + 1, Wo = (W - 1) / 2 + 1;
  const long long n = (long long)B * H * W * Cv;
  const long long blocks = (n + THREADS - 1) / THREADS;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  maxpool3x3s2_bwd_nhwc<T, VEC><<<(unsigned)blocks, THREADS, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(y), static_cast<const T*>(g),
      static_cast<T*>(dx), H, W, Ho, Wo, Cv, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x and dx (B, H, W, C), y and g (B, (H - 1) / 2 + 1, (W - 1) / 2 + 1, C): channels-last, of
// `dtype` (0 = float32, 1 = bfloat16), 16-byte aligned when `vec` channels are 16 bytes;
// `vec` is 16 bytes of channels or 1. Returns the cudaError_t of the launch.
extern "C" int jp_maxpool3x3s2_bwd(const void* x, const void* y, const void* g, void* dx, int B,
                                   int H, int W, int C, int dtype, int vec, void* stream) {
  if ((long long)B * H * W * C == 0) return 0;
  if (B < 0 || H < 0 || W < 0 || vec < 1 || C % vec) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1 && vec == 8) return launch<__nv_bfloat16, 8>(x, y, g, dx, B, H, W, C, s);
  if (dtype == 1 && vec == 1) return launch<__nv_bfloat16, 1>(x, y, g, dx, B, H, W, C, s);
  if (dtype == 0 && vec == 4) return launch<float, 4>(x, y, g, dx, B, H, W, C, s);
  if (dtype == 0 && vec == 1) return launch<float, 1>(x, y, g, dx, B, H, W, C, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
