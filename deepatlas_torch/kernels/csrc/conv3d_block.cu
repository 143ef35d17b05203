// conv3d_k3_block: Conv3d kernel 3, stride 1, zero padding 1, no bias, with
// p_blk output planes per block, on channel-last (B, D, H, W, C) tensors,
// for sm_90a.
//
// Replaces the TPU kernel deepatlas_tpu/pallas/conv3d.py::
// _conv_fwd_block_kernel (packed_conv3d_block): the same function as
// conv3d_k3 (csrc/conv3d.cu), split so that one step owns p_blk output
// planes and reads its (p_blk + 2)-plane input window once.  The TPU
// kernel's lane rolls, banded weight bank and halo DMA exist for Mosaic's
// 128-lane tiles and are not ported.
//
// Bound: like conv3d_k3, 2*27*Cin*Cout flops per voxel against 2*(Cin+Cout)
// bytes in bf16, so operations.  This version runs on the CUDA cores in
// float32.  Its design is depth register blocking: a block owns p_blk output
// planes, a 32x8 (x, y) tile and CO_BLK output channels, and stages the
// (p_blk + 2) x 10 x 34 input halo and the matching weights in shared memory,
// a few input channels at a time.  Each thread owns one (y, x) column and
// keeps p_blk x CO_BLK accumulators.  For each in-plane tap (ky, kx) and
// input channel it reads its column of the halo, every input plane once, into
// registers; each weight vector w[kz, ky, kx, ci, :] is then read once and
// applied to all p_blk outputs, output plane o taking input plane o + kz.
// So one shared-memory read of an input value serves up to 3 output planes
// (conv3d_k3 reads it again for each), and one weight read serves p_blk
// planes (conv3d_k3: 2).  CO_BLK shrinks as p_blk grows so that the
// accumulators stay at 64 floats a thread.  A depth that is not a multiple
// of p_blk is guarded here: the tail block's planes past the volume read the
// conv's zero padding and are not stored.
//
// The wrapper (kernels/conv3d.py) sends float32 tensors here and bfloat16
// ones to the tensor-core kernel conv3d_k3_block_mma (conv3d_mma.cu); the
// bfloat16 instances stay for tools/bench_block_conv_torch.py, which times
// both on the same calls.
//
// x is float32 or bfloat16, weights float32 (already rounded to x's type by
// the caller); products accumulate in float32 and y is written in x's type
// once.  The entry point returns cudaGetLastError() of its launch, or
// cudaErrorInvalidValue for a p_blk outside 1..8.
#include "common.cuh"

namespace {

using da::to_float;

constexpr int TX = 32, TY = 8;           // one thread per (y, x) column
constexpr int THREADS = TX * TY;
constexpr int HX = TX + 2, HY = TY + 2;  // the tile's in-plane halo

// shared memory of one stage: the (P + 2)-plane halo and the weights of CI
// input channels
__host__ __device__ constexpr int stage_bytes(int P, int CO, int CI) {
  return (CI * (P + 2) * HY * HX + 27 * CI * CO) * 4;
}
// 4 input channels a stage where they fit the 48 KB of static shared
// memory, else 2
__host__ __device__ constexpr int stage_channels(int P, int CO) {
  return stage_bytes(P, CO, 4) <= 48 * 1024 ? 4 : 2;
}

// At most 128 registers a thread, so that two blocks share an SM: left to
// itself the compiler gave the bf16 p_blk 4 instance 130 and one block per
// SM, and UNet_light's forward convs took 34.3 ms at p_blk 4 against 27.3 ms
// with this bound (H100, tools/bench_block_conv_torch.py).
template <typename T, int P, int CO_BLK>
__global__ void __launch_bounds__(THREADS, 2)
conv3d_k3_block_kernel(const T* __restrict__ x, const float* __restrict__ w,
                       T* __restrict__ y, int D, int H, int W, int Cin,
                       int Cout, int tiles_x, int tiles_y) {
  constexpr int CI = stage_channels(P, CO_BLK);
  constexpr int HZ = P + 2;
  constexpr int HALO = HZ * HY * HX;
  static_assert(stage_bytes(P, CO_BLK, CI) <= 48 * 1024,
                "a stage must fit the static shared memory");
  __shared__ float xs[CI][HALO];
  __shared__ __align__(16) float ws[27][CI][CO_BLK];

  const int tid = threadIdx.x;
  const int lx = tid % TX, ly = tid / TX;
  int t = blockIdx.x;
  const int x0 = (t % tiles_x) * TX;
  t /= tiles_x;
  const int y0 = (t % tiles_y) * TY;
  const int z0 = (t / tiles_y) * P;
  const int b = blockIdx.y;
  const int co0 = blockIdx.z * CO_BLK;

  const int64_t plane = (int64_t)H * W;
  const T* xb = x + (int64_t)b * D * plane * Cin;

  float acc[P][CO_BLK];
#pragma unroll
  for (int o = 0; o < P; ++o)
#pragma unroll
    for (int c = 0; c < CO_BLK; ++c) acc[o][c] = 0.f;

  for (int c0 = 0; c0 < Cin; c0 += CI) {
    __syncthreads();  // the previous stage's readers are done
    // input halo, channel-fastest so one voxel's channels load together;
    // out-of-volume voxels (the depth's tail included) are the zero padding
    for (int i = tid; i < HALO * CI; i += THREADS) {
      const int ci = i % CI, hv = i / CI;
      const int hx = hv % HX, hy = (hv / HX) % HY, hz = hv / (HX * HY);
      const int gx = x0 + hx - 1, gy = y0 + hy - 1, gz = z0 + hz - 1;
      float v = 0.f;
      if (c0 + ci < Cin && gx >= 0 && gx < W && gy >= 0 && gy < H &&
          gz >= 0 && gz < D)
        v = to_float(xb[(gz * plane + (int64_t)gy * W + gx) * Cin + c0 + ci]);
      xs[ci][hv] = v;
    }
    // weights (3, 3, 3, Cin, Cout) -> ws[tap][ci][co], zero beyond the edge
    for (int i = tid; i < 27 * CI * CO_BLK; i += THREADS) {
      const int co = i % CO_BLK, ci = (i / CO_BLK) % CI,
                tap = i / (CO_BLK * CI);
      float v = 0.f;
      if (c0 + ci < Cin && co0 + co < Cout)
        v = w[((int64_t)tap * Cin + c0 + ci) * Cout + co0 + co];
      ws[tap][ci][co] = v;
    }
    __syncthreads();

#pragma unroll 1
    for (int ky = 0; ky < 3; ++ky) {
#pragma unroll
      for (int kx = 0; kx < 3; ++kx) {
#pragma unroll
        for (int ci = 0; ci < CI; ++ci) {
          // the thread's column of the halo, every input plane once
          float xin[HZ];
#pragma unroll
          for (int i = 0; i < HZ; ++i)
            xin[i] = xs[ci][(i * HY + ly + ky) * HX + lx + kx];
          // input plane o + kz feeds output plane o through tap kz
#pragma unroll
          for (int kz = 0; kz < 3; ++kz) {
            const float4* wr = reinterpret_cast<const float4*>(
                ws[(kz * 3 + ky) * 3 + kx][ci]);
#pragma unroll
            for (int q = 0; q < CO_BLK / 4; ++q) {
              const float4 wv = wr[q];
#pragma unroll
              for (int o = 0; o < P; ++o) {
                const float v = xin[o + kz];
                acc[o][4 * q + 0] = fmaf(v, wv.x, acc[o][4 * q + 0]);
                acc[o][4 * q + 1] = fmaf(v, wv.y, acc[o][4 * q + 1]);
                acc[o][4 * q + 2] = fmaf(v, wv.z, acc[o][4 * q + 2]);
                acc[o][4 * q + 3] = fmaf(v, wv.w, acc[o][4 * q + 3]);
              }
            }
          }
        }
      }
    }
  }

  const int ox = x0 + lx, oy = y0 + ly;
  if (ox >= W || oy >= H) return;
  const int n = min(CO_BLK, Cout - co0);
  const bool vec_ok = (Cout % 8) == 0;
#pragma unroll
  for (int o = 0; o < P; ++o) {
    const int oz = z0 + o;
    if (oz < D) {  // the depth's tail planes are not stored
      T* yp = y + ((((int64_t)b * D + oz) * H + oy) * W + ox) * Cout + co0;
      da::store_channels<CO_BLK>(yp, acc[o], n, vec_ok);
    }
  }
}

template <typename T, int P, int CO_BLK>
void launch_block(const void* x, const void* w, void* y, int B, int D, int H,
                  int W, int Cin, int Cout, cudaStream_t s) {
  const int tiles_x = (W + TX - 1) / TX, tiles_y = (H + TY - 1) / TY;
  const int tiles_z = (D + P - 1) / P;
  dim3 grid(tiles_x * tiles_y * tiles_z, B, (Cout + CO_BLK - 1) / CO_BLK);
  conv3d_k3_block_kernel<T, P, CO_BLK><<<grid, THREADS, 0, s>>>(
      static_cast<const T*>(x), static_cast<const float*>(w),
      static_cast<T*>(y), D, H, W, Cin, Cout, tiles_x, tiles_y);
}

// the narrowest channel block that covers Cout, at most CO_MAX wide so that
// the P x CO_BLK accumulators stay at 64 floats a thread
template <typename T, int P>
void dispatch_cout(const void* x, const void* w, void* y, int B, int D,
                   int H, int W, int Cin, int Cout, cudaStream_t s) {
  constexpr int CO_MAX = P <= 2 ? 32 : P <= 4 ? 16 : 8;
  if constexpr (CO_MAX >= 32) {
    if (Cout > 16)
      return launch_block<T, P, 32>(x, w, y, B, D, H, W, Cin, Cout, s);
  }
  if constexpr (CO_MAX >= 16) {
    if (Cout > 8)
      return launch_block<T, P, 16>(x, w, y, B, D, H, W, Cin, Cout, s);
  }
  launch_block<T, P, 8>(x, w, y, B, D, H, W, Cin, Cout, s);
}

template <typename T>
bool dispatch_p(const void* x, const void* w, void* y, int B, int D, int H,
                int W, int Cin, int Cout, int p_blk, cudaStream_t s) {
  switch (p_blk) {
    case 1: dispatch_cout<T, 1>(x, w, y, B, D, H, W, Cin, Cout, s); break;
    case 2: dispatch_cout<T, 2>(x, w, y, B, D, H, W, Cin, Cout, s); break;
    case 3: dispatch_cout<T, 3>(x, w, y, B, D, H, W, Cin, Cout, s); break;
    case 4: dispatch_cout<T, 4>(x, w, y, B, D, H, W, Cin, Cout, s); break;
    case 5: dispatch_cout<T, 5>(x, w, y, B, D, H, W, Cin, Cout, s); break;
    case 6: dispatch_cout<T, 6>(x, w, y, B, D, H, W, Cin, Cout, s); break;
    case 7: dispatch_cout<T, 7>(x, w, y, B, D, H, W, Cin, Cout, s); break;
    case 8: dispatch_cout<T, 8>(x, w, y, B, D, H, W, Cin, Cout, s); break;
    default: return false;
  }
  return true;
}

}  // namespace

extern "C" {

// x is (B, D, H, W, Cin), w (3, 3, 3, Cin, Cout) float32, y (B, D, H, W,
// Cout); p_blk output planes per block, 1..8.
int conv3d_k3_block(int dtype, const void* x, const void* w, void* y, int B,
                    int D, int H, int W, int Cin, int Cout, int p_blk,
                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool ok =
      dtype == da::kBFloat16
          ? dispatch_p<__nv_bfloat16>(x, w, y, B, D, H, W, Cin, Cout, p_blk,
                                      s)
          : dispatch_p<float>(x, w, y, B, D, H, W, Cin, Cout, p_blk, s);
  if (!ok) return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

}  // extern "C"
