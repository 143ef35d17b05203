// Per-voxel channel mix into TAPS output voxels, shared by the 1x1x1 conv
// (TAPS = 1) and the k2 s2 transposed conv (TAPS = 8):
//
//   y[out(v, t), :] = x[v, :] @ w[t]   (+ bias),   w in (TAPS, Cin, Cout)
//
// Bound by bytes at the U-Net's widths: each input voxel is read once and
// each output voxel written once.  A block stages MIX_VOX voxels x MIX_CI
// input channels in shared memory with coalesced loads, and the TAPS
// weight slices for MIX_CO output channels; each thread mixes one input
// voxel into all its taps and stores each tap's MIX_CO channels with one
// vector store where the layout allows.
#pragma once

#include "common.cuh"

namespace da {

constexpr int MIX_VOX = 128;  // input voxels (= threads) of a block
constexpr int MIX_CI = 16;    // input channels per stage
constexpr int MIX_CO = 8;     // output channels of a block

// Output index rule of a 1x1x1 conv: voxel v writes voxel v.
struct SameVoxel {
  __device__ __forceinline__ int64_t operator()(int64_t v, int) const {
    return v;
  }
};

template <typename T, int TAPS, typename OutIndex>
__global__ void __launch_bounds__(MIX_VOX)
channel_mix_kernel(const T* __restrict__ x, const float* __restrict__ w,
                   const float* __restrict__ bias, T* __restrict__ y,
                   int64_t nvox, int Cin, int Cout, OutIndex out) {
  __shared__ float xs[MIX_CI][MIX_VOX + 1];
  __shared__ __align__(16) float ws[TAPS][MIX_CI][MIX_CO];
  const int tid = threadIdx.x;
  const int64_t v0 = (int64_t)blockIdx.x * MIX_VOX;
  const int co0 = blockIdx.y * MIX_CO;

  float acc[TAPS][MIX_CO];
#pragma unroll
  for (int t = 0; t < TAPS; ++t)
#pragma unroll
    for (int c = 0; c < MIX_CO; ++c) acc[t][c] = 0.f;

  for (int c0 = 0; c0 < Cin; c0 += MIX_CI) {
    __syncthreads();  // the previous stage's readers are done
    for (int i = tid; i < MIX_VOX * MIX_CI; i += MIX_VOX) {
      const int ci = i % MIX_CI, v = i / MIX_CI;
      float val = 0.f;
      if (v0 + v < nvox && c0 + ci < Cin)
        val = to_float(x[(v0 + v) * Cin + c0 + ci]);
      xs[ci][v] = val;
    }
    for (int i = tid; i < TAPS * MIX_CI * MIX_CO; i += MIX_VOX) {
      const int co = i % MIX_CO, ci = (i / MIX_CO) % MIX_CI,
                t = i / (MIX_CO * MIX_CI);
      ws[t][ci][co] = (c0 + ci < Cin && co0 + co < Cout)
                          ? w[((int64_t)t * Cin + c0 + ci) * Cout + co0 + co]
                          : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int ci = 0; ci < MIX_CI; ++ci) {
      const float xv = xs[ci][tid];
#pragma unroll
      for (int t = 0; t < TAPS; ++t) {
        const float4* wr = reinterpret_cast<const float4*>(ws[t][ci]);
#pragma unroll
        for (int q = 0; q < MIX_CO / 4; ++q) {
          const float4 wv = wr[q];
          acc[t][4 * q + 0] = fmaf(xv, wv.x, acc[t][4 * q + 0]);
          acc[t][4 * q + 1] = fmaf(xv, wv.y, acc[t][4 * q + 1]);
          acc[t][4 * q + 2] = fmaf(xv, wv.z, acc[t][4 * q + 2]);
          acc[t][4 * q + 3] = fmaf(xv, wv.w, acc[t][4 * q + 3]);
        }
      }
    }
  }

  const int64_t gv = v0 + tid;
  if (gv >= nvox) return;
  const int n = min(MIX_CO, Cout - co0);
  const bool vec_ok = (Cout % 8) == 0;
#pragma unroll
  for (int t = 0; t < TAPS; ++t) {
    if (bias != nullptr) {
#pragma unroll
      for (int c = 0; c < MIX_CO; ++c)
        if (c < n) acc[t][c] += bias[co0 + c];
    }
    store_channels<MIX_CO>(y + out(gv, t) * Cout + co0, acc[t], n, vec_ok);
  }
}

template <typename T, int TAPS, typename OutIndex>
void launch_channel_mix(const void* x, const void* w, const void* bias,
                        void* y, int64_t nvox, int Cin, int Cout,
                        OutIndex out, cudaStream_t s) {
  dim3 grid((unsigned)((nvox + MIX_VOX - 1) / MIX_VOX),
            (Cout + MIX_CO - 1) / MIX_CO);
  channel_mix_kernel<T, TAPS, OutIndex><<<grid, MIX_VOX, 0, s>>>(
      static_cast<const T*>(x), static_cast<const float*>(w),
      static_cast<const float*>(bias), static_cast<T*>(y), nvox, Cin, Cout,
      out);
}

}  // namespace da
