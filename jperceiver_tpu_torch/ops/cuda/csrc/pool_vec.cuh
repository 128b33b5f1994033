// Channel vectors of the max-pool kernels and the arithmetic of their equality-mask
// backwards, shared by `maxpool5x5.cu` and `maxpool3x3s2.cu`.
#pragma once

#include <cuda_bf16.h>

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as PyTorch's casts
}
template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

// The backward's arithmetic on whole vectors. vmax: r = max(r, p). vroute: acc = acc +
// (a == m ? g : 0), one addition in T, as `acc + torch.where(a == m, g, 0)` computes it:
// PyTorch adds bf16 in fp32 and rounds to bf16; the sum of two bf16 values is exact in
// fp32 unless the smaller is below the larger's bf16 rounding, so that equals the single
// rounding of the native bf16x2 add. Equality treats -0 and +0 as equal either way.
template <int VEC>
__device__ __forceinline__ void vmax(Pack<float, VEC>& r, const Pack<float, VEC>& p) {
#pragma unroll
  for (int u = 0; u < VEC; ++u) r.v[u] = fmaxf(r.v[u], p.v[u]);
}
template <int VEC>
__device__ __forceinline__ void vroute(Pack<float, VEC>& acc, const Pack<float, VEC>& a,
                                       const Pack<float, VEC>& m, const Pack<float, VEC>& g) {
#pragma unroll
  for (int u = 0; u < VEC; ++u) acc.v[u] += a.v[u] == m.v[u] ? g.v[u] : 0.f;
}
template <int VEC>
__device__ __forceinline__ void vmax(Pack<__nv_bfloat16, VEC>& r,
                                     const Pack<__nv_bfloat16, VEC>& p) {
  if constexpr (VEC % 2 == 0) {
    auto* r2 = reinterpret_cast<__nv_bfloat162*>(r.v);
    const auto* p2 = reinterpret_cast<const __nv_bfloat162*>(p.v);
#pragma unroll
    for (int u = 0; u < VEC / 2; ++u) r2[u] = __hmax2(r2[u], p2[u]);
  } else {
#pragma unroll
    for (int u = 0; u < VEC; ++u) r.v[u] = __hmax(r.v[u], p.v[u]);
  }
}
template <int VEC>
__device__ __forceinline__ void vroute(Pack<__nv_bfloat16, VEC>& acc,
                                       const Pack<__nv_bfloat16, VEC>& a,
                                       const Pack<__nv_bfloat16, VEC>& m,
                                       const Pack<__nv_bfloat16, VEC>& g) {
  if constexpr (VEC % 2 == 0) {
    auto* acc2 = reinterpret_cast<__nv_bfloat162*>(acc.v);
    const auto* a2 = reinterpret_cast<const __nv_bfloat162*>(a.v);
    const auto* m2 = reinterpret_cast<const __nv_bfloat162*>(m.v);
    const auto* g2 = reinterpret_cast<const unsigned*>(g.v);
#pragma unroll
    for (int u = 0; u < VEC / 2; ++u) {
      const unsigned sel = g2[u] & __heq2_mask(a2[u], m2[u]);  // g, or +0 where unequal
      acc2[u] = __hadd2(acc2[u], *reinterpret_cast<const __nv_bfloat162*>(&sel));
    }
  } else {
#pragma unroll
    for (int u = 0; u < VEC; ++u)
      acc.v[u] = __hadd(acc.v[u], __heq(a.v[u], m.v[u]) ? g.v[u] : __float2bfloat16(0.f));
  }
}

}  // namespace
