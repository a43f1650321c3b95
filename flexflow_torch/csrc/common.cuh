// Shared device helpers for the port's kernels (flash_fwd.cu, flash_bwd.cu,
// flash_decode.cu, softmax_xent.cu): element conversions, 8-element vector
// loads and stores, and the f32 shared-memory tile loader.
//
// The kernels compute in f32 on values converted from the input type.  A
// product of two bf16 values is exact in f32, so an FMA over converted
// operands equals the TPU kernels' "dot in the input dtype with f32
// accumulation" up to the order of the sum.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace ff {

// The finite mask constant of the reference (_NEG_INF): exp(-1e30 - m)
// underflows to an exact 0 for any finite row max m, and never makes a NaN.
constexpr float kNegInf = -1e30f;

// dtype codes shared with flexflow_torch/ops/kernels.py.
constexpr int kFloat32 = 0;
constexpr int kBFloat16 = 1;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as astype does
}

// Rounds an f32 value through T: the reference's cast of the softmax
// numerator p to v's dtype before the P.V product.
template <typename T>
__device__ __forceinline__ float round_through(float x) {
  return to_float(from_float<T>(x));
}

// Loads 8 consecutive elements starting at p (16-byte aligned) as f32.
__device__ __forceinline__ void load8(const float* p, float* out) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* out) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

// Stores 8 f32 values at p (16-byte aligned) as T, rounding as from_float.
__device__ __forceinline__ void store8(float* p, const float* in) {
  *reinterpret_cast<float4*>(p) = make_float4(in[0], in[1], in[2], in[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(in[4], in[5], in[6], in[7]);
}

__device__ __forceinline__ void store8(__nv_bfloat16* p, const float* in) {
  uint4 raw;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(in[2 * i], in[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = raw;
}

// Copies rows [row0, row0 + rows) of a (t, hd) slab into shared memory as
// f32 with row stride ld, using every thread of the block; rows at or past
// t are zero-filled (a masked row must meet zeros: 0 * garbage could be
// NaN).  hd is a multiple of 8 and the slab 16-byte aligned.
template <typename T>
__device__ void load_tile(float* dst, const T* src, int row0, int rows, int t,
                          int hd, int ld) {
  const int per_row = hd / 8;
  for (int c = threadIdx.x; c < rows * per_row; c += blockDim.x) {
    const int r = c / per_row;
    const int d0 = (c - r * per_row) * 8;
    float vals[8];
    if (row0 + r < t) {
      load8(src + (size_t)(row0 + r) * hd + d0, vals);
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) vals[i] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) dst[r * ld + d0 + i] = vals[i];
  }
}

}  // namespace ff
