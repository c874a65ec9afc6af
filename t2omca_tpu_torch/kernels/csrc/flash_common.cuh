// Device helpers shared by the flash-attention kernels (flash_fwd.cu,
// flash_bwd.cu): dtype conversion, vector loads and stores of 4-element
// column groups, warp reductions, and the staging of a (T, D) slab of a
// strided tensor into shared memory as f32.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace t2o {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kAccTiles = 2;          // 4x4 output blocks held per thread
constexpr float kNegMask = -1e9f;     // NEG_MASK_VALUE of the module
constexpr float kPad = -1e30f;        // running-max start, below every mask

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float dot4(const float4 a, const float4 b,
                                      float s) {
  s = fmaf(a.x, b.x, s);
  s = fmaf(a.y, b.y, s);
  s = fmaf(a.z, b.z, s);
  return fmaf(a.w, b.w, s);
}

__device__ __forceinline__ void fma4(float a, const float4 b, float4& acc) {
  acc.x = fmaf(a, b.x, acc.x);
  acc.y = fmaf(a, b.y, acc.y);
  acc.z = fmaf(a, b.z, acc.z);
  acc.w = fmaf(a, b.w, acc.w);
}

__device__ __forceinline__ void store4(float* dst, const float4 v) {
  *reinterpret_cast<float4*>(dst) = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* dst, const float4 v) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 b = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<const uint32_t*>(&a);
  u.y = *reinterpret_cast<const uint32_t*>(&b);
  *reinterpret_cast<uint2*>(dst) = u;
}

__device__ __forceinline__ float4 load4(const float* src) {
  return *reinterpret_cast<const float4*>(src);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* src) {
  const uint2 u = *reinterpret_cast<const uint2*>(src);
  const float2 a = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

// Write columns c..c+3 (c a multiple of 4) of one output row: one vector
// store where the row is 4-element aligned (`vec`), else up to 4 strided
// scalar stores that stop at column D.
template <typename T>
__device__ __forceinline__ void write4(T* row, int64_t s_col, int c, int D,
                                      const float4 r, int vec) {
  if (vec) {
    store4(row + c, r);
    return;
  }
  const float vals[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int e = 0; e < 4; ++e)
    if (c + e < D) row[(int64_t)(c + e) * s_col] = from_f32<T>(vals[e]);
}

// Geometry of the staged slabs: D columns, padded to dp (a multiple of 4,
// the pad zero-filled) in shared rows of ld floats.
struct Slab {
  int D, dp, ld;
};

// Stage `n` rows of a (T, D) slab into shared memory as f32. Each thread
// owns one column group and issues kStageUnroll row loads before it stores
// any, so the loads' latencies overlap. With `vec` (D % 4 == 0, unit
// column stride, 4-element aligned rows) a column group is 4 elements
// loaded at once.
constexpr int kStageUnroll = 4;

template <typename T>
__device__ __forceinline__ void stage(float* dst, const T* src, int64_t s_row,
                                      int64_t s_col, int n, const Slab& g,
                                      int vec) {
  const int width = vec ? 4 : 1;              // elements per column group
  const int groups = g.dp / width;            // column groups per row
  const int rpp = kThreads / groups;          // rows per pass
  const int r0 = threadIdx.x / groups;
  const int c = (threadIdx.x - r0 * groups) * width;
  if (r0 >= rpp) return;
  for (int r = r0; r < n; r += rpp * kStageUnroll) {
    float4 buf[kStageUnroll];
#pragma unroll
    for (int u = 0; u < kStageUnroll; ++u) {
      const int rr = r + u * rpp;
      const T* row = src + (int64_t)rr * s_row;
      if (rr >= n) {
        buf[u] = make_float4(0.f, 0.f, 0.f, 0.f);
      } else if (vec) {
        buf[u] = load4(row + c);
      } else {
        buf[u].x = c < g.D ? to_f32(row[(int64_t)c * s_col]) : 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < kStageUnroll; ++u) {
      const int rr = r + u * rpp;
      if (rr < n) {
        if (vec)
          *reinterpret_cast<float4*>(dst + rr * g.ld + c) = buf[u];
        else
          dst[rr * g.ld + c] = buf[u].x;
      }
    }
  }
}

// Host side: do a tensor's rows load and store as aligned groups of 4
// elements (16-byte f32 or 8-byte bf16 vectors)? strides over (B, H, T, D).
inline bool rows_of_4(const void* ptr, const int64_t* s, int dtype) {
  const uintptr_t align = dtype == 0 ? 16 : 8;
  return reinterpret_cast<uintptr_t>(ptr) % align == 0 && s[0] % 4 == 0 &&
         s[1] % 4 == 0 && s[2] % 4 == 0 && s[3] == 1;
}

// Host side: balanced tiles of at most `cap` rows over `n` rows.
inline void balanced_tiles(int n, int cap, int* rows, int* tiles) {
  *tiles = (n + cap - 1) / cap;
  *rows = (n + *tiles - 1) / *tiles;
}

}  // namespace t2o
