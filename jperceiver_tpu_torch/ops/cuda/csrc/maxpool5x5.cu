// 5x5 stride-1 SAME max-pool of the CRP blocks, forward (kernel K5) and its equality-mask
// backward, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `jperceiver_tpu/ops/pallas/maxpool.py::_fwd_kernel` (a
// 25-tap max over a -inf padded halo tile) and that file's XLA backward `_mp_bwd`. The
// function is `max_pool_5x5_s1`: y[b, i, j, c] = max over |di|, |dj| <= 2 of x[b, i+di,
// j+dj, c], positions outside the image counting as -inf, computed separably as
// y = H5(r), r = W5(x), each a 5-tap max along one axis. The backward is `_mp_bwd`:
//   dr = route_H(r, y, g),  dx = route_W(x, r, dr),
//   route(a, m, g)[i] = sum over d = 0..4 of (a[i] == m[i+d-2] ? g[i+d-2] : 0),
// out-of-image m and g counting as -inf and 0. Every tied maximum gets the whole
// cotangent. Each of the five additions is rounded to the operand dtype, in window order
// from zero, and dr is rounded to the dtype between the stages: the plain PyTorch backward
// (`acc + torch.where(...)` in the dtype) bit for bit. A max picks one of its inputs, so the
// forward is exact in any order.
//
// Layout: channels-last (B, H, W, C), read as vectors of VEC channels (16 bytes, or one
// element when C is not a multiple of 16 bytes). A block owns a tile of TH output rows x
// TW output columns x CB vectors; the tile plan (`maxpool.py::k5_plan`) picks TH so that
// the small CRP pools (32^2 and 64^2 at 256 channels) still give several blocks a SM.
// - Forward: the block stages the (TH+4) x (TW+4) x CB input tile in shared memory with
//   `cp.async`, -inf written by hand where the tile leaves the image (TMA's out-of-bounds
//   fill is zero or NaN, never -inf). A thread owns one column and vector and walks down
//   the staged rows: the 5-max along W of each row (5 shared loads), then the 5-max along
//   H over the last five of those in registers. 10 comparisons an output; each input is
//   read from device memory about once (the halo rows and columns of a tile come from L2).
// - Backward: one launch stages x (TH rows x TW+8 columns, -inf outside), y and g
//   ((TH+4) x (TW+4), -inf and 0 outside). Phase A: a thread owns one column of the TW+4
//   that route_W reads and walks down it, recomputing r from the staged x and routing g
//   down the column into dr; r and dr overwrite the rows of y and g that the thread has
//   passed (no other thread reads its column). Phase B: route_W of dr onto x, 11 shared
//   loads an output. The rows a block is a template constant, so both walks unroll, and
//   bf16 runs as bf16x2 (max, equality mask, add), with no conversion to fp32.
// Bound on this card: bytes at 3.35 TB/s -- the forward reads x and writes y, the backward
// reads x, y and g and writes dx, each once.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "cp_async.cuh"
#include "pool_vec.cuh"

namespace {

// A block has (tw + 4) * cb threads; k5_plan keeps tw <= 32 and cb <= 4.
constexpr int MAX_THREADS = 256;

// One vector of the tensor at (row iy, column ix, vector cv) into shared memory, or `fill`
// in every lane where (iy, ix) is outside the image.
template <typename T, int VEC>
__device__ __forceinline__ void stage(Pack<T, VEC>* dst, const Pack<T, VEC>* img, int iy,
                                      int ix, int cv, int H, int W, int Cv, float fill) {
  if (iy >= 0 && iy < H && ix >= 0 && ix < W) {
    const Pack<T, VEC>* src = img + ((size_t)iy * W + ix) * Cv + cv;
    if constexpr (sizeof(Pack<T, VEC>) == 16) {
      cp_async16(dst, src, true);
    } else {
      *dst = *src;
    }
  } else {
    Pack<T, VEC> f;
#pragma unroll
    for (int v = 0; v < VEC; ++v) f.v[v] = from_f32<T>(fill);
    *dst = f;
  }
}

struct TileIdx {
  int b, i0, j0, c0;
};

// blockIdx.x = channel tile + tiles_c * column tile (neighbouring blocks share halos in
// L2), blockIdx.y = row tile, blockIdx.z = image.
__device__ __forceinline__ TileIdx tile_idx(int th, int tw, int cb, int Cv) {
  const int tiles_c = (Cv + cb - 1) / cb;
  return {(int)blockIdx.z, (int)blockIdx.y * th, (int)(blockIdx.x / tiles_c) * tw,
          (int)(blockIdx.x % tiles_c) * cb};
}

template <typename T, int VEC, int TH>
__global__ void __launch_bounds__(MAX_THREADS)
maxpool5x5_nhwc(const T* __restrict__ x, T* __restrict__ y, int H, int W, int Cv, int tw,
                int cb) {
  constexpr int th = TH;
  using P = Pack<T, VEC>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  P* xs = reinterpret_cast<P*>(smem_raw);  // [th + 4][tw + 4][cb]
  const TileIdx t = tile_idx(th, tw, cb, Cv);
  const int sw = tw + 4, sh = th + 4;
  const P* img = reinterpret_cast<const P*>(x) + (size_t)t.b * H * W * Cv;
  for (int e = threadIdx.x; e < sh * sw * cb; e += blockDim.x) {
    const int v = e % cb, k = e / cb;
    if (t.c0 + v < Cv)
      stage<T, VEC>(&xs[e], img, t.i0 - 2 + k / sw, t.j0 - 2 + k % sw, t.c0 + v, H, W, Cv,
                    -INFINITY);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const int v = threadIdx.x % cb, q = threadIdx.x / cb;
  const int ox = t.j0 + q, cv = t.c0 + v;
  if (q >= tw || ox >= W || cv >= Cv) return;
  P* out = reinterpret_cast<P*>(y) + ((size_t)t.b * H * W + ox) * Cv + cv;
  float ring[5][VEC];  // the W-maxima of the last five staged rows
#pragma unroll
  for (int r = 0; r < th + 4; ++r) {
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int u = 0; u < VEC; ++u) ring[a][u] = ring[a + 1][u];
    const P* row = xs + (r * sw + q) * cb + v;
#pragma unroll
    for (int u = 0; u < VEC; ++u) ring[4][u] = -INFINITY;
#pragma unroll
    for (int d = 0; d < 5; ++d) {
      const P p = row[d * cb];
#pragma unroll
      for (int u = 0; u < VEC; ++u) ring[4][u] = fmaxf(ring[4][u], to_f32(p.v[u]));
    }
    const int oy = t.i0 + r - 4;
    if (r >= 4 && oy < H) {
      P o;
#pragma unroll
      for (int u = 0; u < VEC; ++u) {
        float m = ring[0][u];
#pragma unroll
        for (int a = 1; a < 5; ++a) m = fmaxf(m, ring[a][u]);
        o.v[u] = from_f32<T>(m);  // exact: m is one of the inputs
      }
      out[(size_t)oy * W * Cv] = o;
    }
  }
}

template <typename T, int VEC, int TH>
__global__ void __launch_bounds__(MAX_THREADS)
maxpool5x5_bwd_nhwc(const T* __restrict__ x, const T* __restrict__ y, const T* __restrict__ g,
                    T* __restrict__ dx, int H, int W, int Cv, int tw, int cb) {
  constexpr int th = TH;
  using P = Pack<T, VEC>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int xw = tw + 8, sw = tw + 4, sh = th + 4;
  P* xs = reinterpret_cast<P*>(smem_raw);  // [th][tw + 8][cb]: x, columns j0-4 ..
  P* ys = xs + th * xw * cb;               // [th + 4][tw + 4][cb]: y, then r (rows 0..th-1)
  P* gs = ys + sh * sw * cb;               // [th + 4][tw + 4][cb]: g, then dr
  const TileIdx t = tile_idx(th, tw, cb, Cv);
  const size_t base = (size_t)t.b * H * W * Cv;
  const P* ximg = reinterpret_cast<const P*>(x) + base;
  const P* yimg = reinterpret_cast<const P*>(y) + base;
  const P* gimg = reinterpret_cast<const P*>(g) + base;
  for (int e = threadIdx.x; e < th * xw * cb; e += blockDim.x) {
    const int v = e % cb, k = e / cb;
    if (t.c0 + v < Cv)
      stage<T, VEC>(&xs[e], ximg, t.i0 + k / xw, t.j0 - 4 + k % xw, t.c0 + v, H, W, Cv,
                    -INFINITY);
  }
  for (int e = threadIdx.x; e < sh * sw * cb; e += blockDim.x) {
    const int v = e % cb, k = e / cb;
    if (t.c0 + v < Cv) {
      const int iy = t.i0 - 2 + k / sw, ix = t.j0 - 2 + k % sw;
      stage<T, VEC>(&ys[e], yimg, iy, ix, t.c0 + v, H, W, Cv, -INFINITY);
      stage<T, VEC>(&gs[e], gimg, iy, ix, t.c0 + v, H, W, Cv, 0.f);
    }
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const int v = threadIdx.x % cb, q = threadIdx.x / cb;
  const bool live_c = t.c0 + v < Cv;
  P zero;
#pragma unroll
  for (int u = 0; u < VEC; ++u) zero.v[u] = from_f32<T>(0.f);
  // Phase A: column q of the tw + 4 columns j0-2 .. j0+tw+1.
  if (q < sw && live_c) {
    P yr[5], gr[5];  // rows i-2 .. i+2 of y and g in this column
#pragma unroll
    for (int rr = 0; rr < th + 4; ++rr) {
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        yr[a] = yr[a + 1];
        gr[a] = gr[a + 1];
      }
      yr[4] = ys[(rr * sw + q) * cb + v];
      gr[4] = gs[(rr * sw + q) * cb + v];
      if (rr < 4) continue;
      const int i = rr - 4;
      const P* xrow = xs + (i * xw + q) * cb + v;
      P r = xrow[0], dr = zero;
#pragma unroll
      for (int d = 1; d < 5; ++d) vmax(r, xrow[d * cb]);
#pragma unroll
      for (int d = 0; d < 5; ++d) vroute(dr, r, yr[d], gr[d]);
      // Row i of this column was read at rr = i and is not read again.
      ys[(i * sw + q) * cb + v] = r;
      gs[(i * sw + q) * cb + v] = dr;
    }
  }
  __syncthreads();

  // Phase B: route_W of dr onto x at column q of the tile.
  const int ox = t.j0 + q;
  if (q >= tw || ox >= W || !live_c) return;
  P* out = reinterpret_cast<P*>(dx) + base + (size_t)ox * Cv + t.c0 + v;
#pragma unroll
  for (int i = 0; i < th; ++i) {
    const int oy = t.i0 + i;
    if (oy >= H) break;
    const P xv = xs[(i * xw + q + 4) * cb + v];
    const P* rrow = ys + (i * sw + q) * cb + v;
    const P* drow = gs + (i * sw + q) * cb + v;
    P acc = zero;
#pragma unroll
    for (int d = 0; d < 5; ++d) vroute(acc, xv, rrow[d * cb], drow[d * cb]);
    out[(size_t)oy * W * Cv] = acc;
  }
}

template <typename T, int VEC, int TH>
int launch(const void* x, const void* y, const void* g, void* dx, int B, int H, int W, int C,
           int tw, int cb, cudaStream_t s) {
  const int Cv = C / VEC;
  const dim3 grid((unsigned)(((Cv + cb - 1) / cb) * ((W + tw - 1) / tw)),
                  (unsigned)((H + TH - 1) / TH), (unsigned)B);
  const int vb = (int)sizeof(Pack<T, VEC>);
  if (g == nullptr) {
    const int bytes = (TH + 4) * (tw + 4) * cb * vb;
    cudaError_t err = cudaFuncSetAttribute(maxpool5x5_nhwc<T, VEC, TH>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    maxpool5x5_nhwc<T, VEC, TH><<<grid, tw * cb, bytes, s>>>(
        static_cast<const T*>(x), static_cast<T*>(dx), H, W, Cv, tw, cb);
  } else {
    const int bytes = (TH * (tw + 8) + 2 * (TH + 4) * (tw + 4)) * cb * vb;
    cudaError_t err = cudaFuncSetAttribute(maxpool5x5_bwd_nhwc<T, VEC, TH>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    maxpool5x5_bwd_nhwc<T, VEC, TH><<<grid, (tw + 4) * cb, bytes, s>>>(
        static_cast<const T*>(x), static_cast<const T*>(y), static_cast<const T*>(g),
        static_cast<T*>(dx), H, W, Cv, tw, cb);
  }
  return static_cast<int>(cudaGetLastError());
}

// The rows a block is a compile-time constant, so the walks down a column unroll.
template <typename T, int VEC>
int launch_th(const void* x, const void* y, const void* g, void* dx, int B, int H, int W, int C,
              int th, int tw, int cb, cudaStream_t s) {
  switch (th) {
    case 1: return launch<T, VEC, 1>(x, y, g, dx, B, H, W, C, tw, cb, s);
    case 2: return launch<T, VEC, 2>(x, y, g, dx, B, H, W, C, tw, cb, s);
    case 4: return launch<T, VEC, 4>(x, y, g, dx, B, H, W, C, tw, cb, s);
    case 8: return launch<T, VEC, 8>(x, y, g, dx, B, H, W, C, tw, cb, s);
    case 16: return launch<T, VEC, 16>(x, y, g, dx, B, H, W, C, tw, cb, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

int dispatch(const void* x, const void* y, const void* g, void* out, int B, int H, int W, int C,
             int dtype, int vec, int th, int tw, int cb, void* stream) {
  if (B * H * W * C == 0) return 0;
  if (tw < 1 || cb < 1 || vec < 1 || C % vec || (tw + 4) * cb > MAX_THREADS)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1 && vec == 8)
    return launch_th<__nv_bfloat16, 8>(x, y, g, out, B, H, W, C, th, tw, cb, s);
  if (dtype == 1 && vec == 1)
    return launch_th<__nv_bfloat16, 1>(x, y, g, out, B, H, W, C, th, tw, cb, s);
  if (dtype == 0 && vec == 4) return launch_th<float, 4>(x, y, g, out, B, H, W, C, th, tw, cb, s);
  if (dtype == 0 && vec == 1) return launch_th<float, 1>(x, y, g, out, B, H, W, C, th, tw, cb, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Channels-last tensors of `dtype` (0 = float32, 1 = bfloat16), 16-byte aligned when `vec`
// channels are 16 bytes; `vec` is 16 bytes of channels or 1; the tile (th, tw, cb) is
// `k5_plan`'s. Each returns the cudaError_t of its launch.
extern "C" int jp_maxpool5x5_fwd(const void* x, void* y, int B, int H, int W, int C, int dtype,
                                 int vec, int th, int tw, int cb, void* stream) {
  return dispatch(x, nullptr, nullptr, y, B, H, W, C, dtype, vec, th, tw, cb, stream);
}

// dx = the equality-mask backward at x with forward output y and cotangent g.
extern "C" int jp_maxpool5x5_bwd(const void* x, const void* y, const void* g, void* dx, int B,
                                 int H, int W, int C, int dtype, int vec, int th, int tw, int cb,
                                 void* stream) {
  return dispatch(x, y, g, dx, B, H, W, C, dtype, vec, th, tw, cb, stream);
}
