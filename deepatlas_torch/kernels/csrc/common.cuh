// Shared helpers for the hand-written Hopper kernels: element conversion
// between the storage type (float or bf16) and the float accumulators, and
// 8-wide vector stores of one voxel's channel group.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace da {

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
// round to nearest even, as torch's float -> bfloat16 cast
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Eight consecutive channels in one go; p must be 16-byte aligned.
__device__ __forceinline__ void store8(float* p, const float* v) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}
__device__ __forceinline__ void store8(__nv_bfloat16* p, const float* v) {
  union {
    uint4 u;
    __nv_bfloat162 h[4];
  } pack;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    pack.h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = pack.u;
}

// Write n <= N channels of one voxel: vector stores when the whole group of
// N (a multiple of 8) is in range and 16-byte aligned, else scalar stores.
template <int N, typename T>
__device__ __forceinline__ void store_channels(T* p, const float* v, int n,
                                               bool vec_ok) {
  if (vec_ok && n == N) {
#pragma unroll
    for (int i = 0; i < N; i += 8) store8(p + i, v + i);
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i)
      if (i < n) p[i] = from_float<T>(v[i]);
  }
}

enum DType { kFloat32 = 0, kBFloat16 = 1 };

}  // namespace da
