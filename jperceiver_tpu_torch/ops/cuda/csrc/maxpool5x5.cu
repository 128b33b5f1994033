// 5x5 stride-1 SAME max-pool forward (kernel K5), hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `jperceiver_tpu/ops/pallas/maxpool.py::_fwd_kernel`
// (a 25-tap max over a -inf padded halo tile). The function is the one of that file's
// `_pool_ref` / `max_pool_5x5_s1`: out[b, y, x, c] = max over |dy|, |dx| <= 2 of
// in[b, y+dy, x+dx, c], where positions outside the image count as -inf. A max picks one
// of its inputs, so the result is exact in any order and in any dtype.
//
// Layout: channels-last (B, H, W, C). One thread owns VEC neighbouring channels of one
// output pixel and reads the 25 window positions as 16-byte vectors; neighbouring threads
// read neighbouring channels, so every load is coalesced and the overlapping windows of
// a warp are served from L1. Values are compared as fp32, which holds every bf16 value
// exactly. Bound on this card: bytes -- one read of the input and one write of the
// output -- at 3.35 TB/s.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // exact: v is one of the bf16 inputs
}

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

template <typename T, int VEC>
__global__ void __launch_bounds__(256)
maxpool5x5_nhwc(const T* __restrict__ x, T* __restrict__ y, int B, int H, int W, int C) {
  const int cv = C / VEC;
  const long long total = (long long)B * H * W * cv;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int c = (int)(i % cv) * VEC;
  long long p = i / cv;
  const int ox = (int)(p % W);
  p /= W;
  const int oy = (int)(p % H);
  const int b = (int)(p / H);

  float m[VEC];
#pragma unroll
  for (int v = 0; v < VEC; ++v) m[v] = -INFINITY;
  const int y0 = max(oy - 2, 0), y1 = min(oy + 2, H - 1);
  const int x0 = max(ox - 2, 0), x1 = min(ox + 2, W - 1);
  for (int iy = y0; iy <= y1; ++iy) {
    const T* row = x + (((size_t)b * H + iy) * W) * C + c;
    for (int ix = x0; ix <= x1; ++ix) {
      const Pack<T, VEC> q = *reinterpret_cast<const Pack<T, VEC>*>(row + (size_t)ix * C);
#pragma unroll
      for (int v = 0; v < VEC; ++v) m[v] = fmaxf(m[v], to_f32(q.v[v]));
    }
  }
  Pack<T, VEC> out;
#pragma unroll
  for (int v = 0; v < VEC; ++v) out.v[v] = from_f32<T>(m[v]);
  *reinterpret_cast<Pack<T, VEC>*>(y + (((size_t)b * H + oy) * W + ox) * C + c) = out;
}

template <typename T, int VEC>
int launch(const void* x, void* y, int B, int H, int W, int C, cudaStream_t s) {
  const long long total = (long long)B * H * W * (C / VEC);
  const int threads = 256;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  maxpool5x5_nhwc<T, VEC><<<blocks, threads, 0, s>>>(static_cast<const T*>(x),
                                                      static_cast<T*>(y), B, H, W, C);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. x and y are 16-byte aligned, channels-last.
// Returns the cudaError_t of the launch.
extern "C" int jp_maxpool5x5_fwd(const void* x, void* y, int B, int H, int W, int C, int dtype,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B * H * W * C == 0) return 0;
  if (dtype == 1) {
    return (C % 8 == 0) ? launch<__nv_bfloat16, 8>(x, y, B, H, W, C, s)
                        : launch<__nv_bfloat16, 1>(x, y, B, H, W, C, s);
  }
  if (dtype == 0) {
    return (C % 4 == 0) ? launch<float, 4>(x, y, B, H, W, C, s)
                        : launch<float, 1>(x, y, B, H, W, C, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
