// 3-D convolutions on channel-last (B, D, H, W, C) tensors, for sm_90a.
//
// conv3d_k3: Conv3d kernel 3, stride 1 or 2, zero padding 1, on the float32
//   path (the wrapper sends bfloat16 to the tensor-core kernel of
//   conv3d_mma.cu; this entry point still takes bf16, for the conv tool's
//   before/after table).  Replaces the TPU
//   kernel deepatlas_tpu/pallas/conv3d.py::_conv_fwd_kernel (and its packed
//   (D, H, W*C) lane layout and banded weight bank, which exist only for
//   the TPU's 128-lane tiles).  At the U-Net's shapes (Cin 1..128, Cout
//   8..64, 16^3..128^3 voxels) the conv does 2*27*Cin*Cout flops per voxel
//   against 2*(Cin+Cout) bytes, i.e. it is bound by operations on this
//   card.  It is a direct convolution on the CUDA cores in
//   float32 (no tensor cores): a block owns a 32x4x4 tile of output voxels
//   and CO_BLK output channels, stages the input halo (34x6x6 voxels, 4
//   input channels at a time) and the matching weights in shared memory,
//   and each thread accumulates 2 voxels x CO_BLK channels in registers,
//   reading each weight vector once for both voxels (the bf16 path's
//   tensor-core implicit GEMM is conv3d_mma.cu).  With stride 2 (the
//   VoxelMorph encoder) the same
//   block owns 32x4x4 voxels of the strided output (output o reads inputs
//   2o-1..2o+1, ceil(n/2) outputs per axis), stages the 65x9x9 input halo
//   they touch 2 channels at a time, and skips the odd outputs that a
//   stride-1 conv followed by a subsample would compute and throw away.
//
// conv3d_point: 1x1x1 conv (per-voxel channel mix).  Replaces
//   deepatlas_tpu/pallas/conv3d.py::_conv_point_kernel.  Bound by bytes:
//   each voxel is read once (Cin values) and written once (Cout values).
//   It is the one-tap case of channel_mix.cuh.
//
// Both take x in float32 or bfloat16, weights and bias in float32 (the
// caller rounds weights to the compute type first), accumulate in float32
// and write the output in x's type.  Every entry point returns
// cudaGetLastError() of its launch.
#include "channel_mix.cuh"

namespace {

using da::from_float;
using da::to_float;

// ---------------------------------------------------------------- k3 conv
constexpr int TX = 32, TY = 4, TZ = 2;  // threads of a block: 256
constexpr int VZ = 2;                   // output planes per thread
constexpr int OZ = TZ * VZ;             // output tile depth
constexpr int K3_THREADS = TX * TY * TZ;

// D, H, W are the input's sizes, Do, Ho, Wo the output's; the tiles cover the
// output.  H and W are padded by 1 (Ho = ceil(H / S)), depth by pd: output
// plane o reads input planes S o - pd .. S o - pd + 2 (pd 1: the conv's
// zero padding; pd 0: a depth shard that carries its neighbours' planes;
// pd 2: the stride-1 input gradient of a pd-0 conv).
template <typename T, int CO_BLK, int S>
__global__ void __launch_bounds__(K3_THREADS)
conv3d_k3_kernel(const T* __restrict__ x, const float* __restrict__ w,
                 const float* __restrict__ bias, T* __restrict__ y, int D,
                 int H, int W, int Do, int Ho, int Wo, int Cin, int Cout,
                 int tiles_x, int tiles_y, int pd) {
  // input halo of one tile, and input channels per stage (the halo of a
  // strided tile is 6.6 times larger, so it is staged 2 channels at a time
  // to stay inside the 48 KB of static shared memory)
  constexpr int HX = S * (TX - 1) + 3, HY = S * (TY - 1) + 3,
                HZ = S * (OZ - 1) + 3;
  constexpr int HALO = HX * HY * HZ;
  constexpr int K3_CI = S == 1 ? 4 : 2;
  __shared__ float xs[K3_CI][HALO];
  __shared__ __align__(16) float ws[27][K3_CI][CO_BLK];

  const int tid = threadIdx.x;
  const int lx = tid % TX, ly = (tid / TX) % TY, lz = tid / (TX * TY);
  int t = blockIdx.x;
  const int x0 = (t % tiles_x) * TX;
  t /= tiles_x;
  const int y0 = (t % tiles_y) * TY;
  const int z0 = (t / tiles_y) * OZ;
  const int b = blockIdx.y;
  const int co0 = blockIdx.z * CO_BLK;

  const int64_t plane = (int64_t)H * W;
  const T* xb = x + (int64_t)b * D * plane * Cin;

  float acc[VZ][CO_BLK];
#pragma unroll
  for (int v = 0; v < VZ; ++v)
#pragma unroll
    for (int c = 0; c < CO_BLK; ++c) acc[v][c] = 0.f;

  for (int c0 = 0; c0 < Cin; c0 += K3_CI) {
    __syncthreads();  // the previous stage's readers are done
    // input halo, channel-fastest so one voxel's channels load together;
    // out-of-volume voxels are the conv's zero padding
    for (int i = tid; i < HALO * K3_CI; i += K3_THREADS) {
      const int ci = i % K3_CI, hv = i / K3_CI;
      const int hx = hv % HX, hy = (hv / HX) % HY, hz = hv / (HX * HY);
      const int gx = S * x0 + hx - 1, gy = S * y0 + hy - 1,
                gz = S * z0 + hz - pd;
      float v = 0.f;
      if (c0 + ci < Cin && gx >= 0 && gx < W && gy >= 0 && gy < H &&
          gz >= 0 && gz < D)
        v = to_float(xb[(gz * plane + (int64_t)gy * W + gx) * Cin + c0 + ci]);
      xs[ci][hv] = v;
    }
    // weights (3, 3, 3, Cin, Cout) -> ws[tap][ci][co], zero beyond the edge
    for (int i = tid; i < 27 * K3_CI * CO_BLK; i += K3_THREADS) {
      const int co = i % CO_BLK, ci = (i / CO_BLK) % K3_CI,
                tap = i / (CO_BLK * K3_CI);
      float v = 0.f;
      if (c0 + ci < Cin && co0 + co < Cout)
        v = w[((int64_t)tap * Cin + c0 + ci) * Cout + co0 + co];
      ws[tap][ci][co] = v;
    }
    __syncthreads();

#pragma unroll 1
    for (int kz = 0; kz < 3; ++kz) {
#pragma unroll 1
      for (int ky = 0; ky < 3; ++ky) {
#pragma unroll
        for (int kx = 0; kx < 3; ++kx) {
          const int tap = (kz * 3 + ky) * 3 + kx;
#pragma unroll
          for (int ci = 0; ci < K3_CI; ++ci) {
            float xin[VZ];
#pragma unroll
            for (int v = 0; v < VZ; ++v)
              xin[v] = xs[ci][((S * (lz * VZ + v) + kz) * HY + S * ly + ky) *
                                  HX + S * lx + kx];
            const float4* wr = reinterpret_cast<const float4*>(ws[tap][ci]);
#pragma unroll
            for (int q = 0; q < CO_BLK / 4; ++q) {
              const float4 wv = wr[q];
#pragma unroll
              for (int v = 0; v < VZ; ++v) {
                acc[v][4 * q + 0] = fmaf(xin[v], wv.x, acc[v][4 * q + 0]);
                acc[v][4 * q + 1] = fmaf(xin[v], wv.y, acc[v][4 * q + 1]);
                acc[v][4 * q + 2] = fmaf(xin[v], wv.z, acc[v][4 * q + 2]);
                acc[v][4 * q + 3] = fmaf(xin[v], wv.w, acc[v][4 * q + 3]);
              }
            }
          }
        }
      }
    }
  }

  const int ox = x0 + lx, oy = y0 + ly;
  if (ox >= Wo || oy >= Ho) return;
  const int n = min(CO_BLK, Cout - co0);
  const bool vec_ok = (Cout % 8) == 0;
#pragma unroll
  for (int v = 0; v < VZ; ++v) {
    const int oz = z0 + lz * VZ + v;
    if (oz >= Do) continue;
    if (bias != nullptr) {
#pragma unroll
      for (int c = 0; c < CO_BLK; ++c)
        if (c < n) acc[v][c] += bias[co0 + c];
    }
    T* yp = y + ((((int64_t)b * Do + oz) * Ho + oy) * Wo + ox) * Cout + co0;
    da::store_channels<CO_BLK>(yp, acc[v], n, vec_ok);
  }
}

template <typename T, int CO_BLK, int S>
void launch_k3(const void* x, const void* w, const void* bias, void* y, int B,
               int D, int H, int W, int Cin, int Cout, int pd,
               cudaStream_t s) {
  const int Do = (D + 2 * pd - 3) / S + 1, Ho = (H + S - 1) / S,
            Wo = (W + S - 1) / S;
  const int tiles_x = (Wo + TX - 1) / TX, tiles_y = (Ho + TY - 1) / TY;
  const int tiles_z = (Do + OZ - 1) / OZ;
  dim3 grid(tiles_x * tiles_y * tiles_z, B, (Cout + CO_BLK - 1) / CO_BLK);
  conv3d_k3_kernel<T, CO_BLK, S><<<grid, K3_THREADS, 0, s>>>(
      static_cast<const T*>(x), static_cast<const float*>(w),
      static_cast<const float*>(bias), static_cast<T*>(y), D, H, W, Do, Ho,
      Wo, Cin, Cout, tiles_x, tiles_y, pd);
}

template <typename T, int S>
void dispatch_k3(const void* x, const void* w, const void* bias, void* y,
                 int B, int D, int H, int W, int Cin, int Cout, int pd,
                 cudaStream_t s) {
  if (Cout <= 8)
    launch_k3<T, 8, S>(x, w, bias, y, B, D, H, W, Cin, Cout, pd, s);
  else if (Cout <= 16)
    launch_k3<T, 16, S>(x, w, bias, y, B, D, H, W, Cin, Cout, pd, s);
  else
    launch_k3<T, 32, S>(x, w, bias, y, B, D, H, W, Cin, Cout, pd, s);
}

template <typename T>
void dispatch_k3_stride(const void* x, const void* w, const void* bias,
                        void* y, int B, int D, int H, int W, int Cin,
                        int Cout, int stride, int pd, cudaStream_t s) {
  if (stride == 2)
    dispatch_k3<T, 2>(x, w, bias, y, B, D, H, W, Cin, Cout, pd, s);
  else
    dispatch_k3<T, 1>(x, w, bias, y, B, D, H, W, Cin, Cout, pd, s);
}

}  // namespace

extern "C" {

// x is (B, D, H, W, Cin); y is (B, (D + 2 pd - 3) / stride + 1,
// ceil(H/stride), ceil(W/stride), Cout); stride is 1 or 2, pd (the depth
// padding) 0, 1 or 2 (2 at stride 1 only).
int conv3d_k3(int dtype, const void* x, const void* w, const void* bias,
              void* y, int B, int D, int H, int W, int Cin, int Cout,
              int stride, int pd, void* stream) {
  if ((stride != 1 && stride != 2) || pd < 0 || pd > 3 - stride ||
      D + 2 * pd < 3)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == da::kBFloat16)
    dispatch_k3_stride<__nv_bfloat16>(x, w, bias, y, B, D, H, W, Cin, Cout,
                                      stride, pd, s);
  else
    dispatch_k3_stride<float>(x, w, bias, y, B, D, H, W, Cin, Cout, stride,
                              pd, s);
  return (int)cudaGetLastError();
}

int conv3d_point(int dtype, const void* x, const void* w, const void* bias,
                 void* y, long long nvox, int Cin, int Cout, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == da::kBFloat16)
    da::launch_channel_mix<__nv_bfloat16, 1>(x, w, bias, y, nvox, Cin, Cout,
                                             da::SameVoxel{}, s);
  else
    da::launch_channel_mix<float, 1>(x, w, bias, y, nvox, Cin, Cout,
                                     da::SameVoxel{}, s);
  return (int)cudaGetLastError();
}

}  // extern "C"
