// Weight gradient of the k3 p1 conv (stride 1 or 2) on channel-last
// (B, D, H, W, C) tensors, for sm_90a.
//
// conv3d_k3_wgrad: replaces the TPU kernel
//   deepatlas_tpu/pallas/conv3d.py::_conv_wgrad_kernel.  That kernel
//   produces the gradient of a banded block-Toeplitz weight bank on packed
//   (D, H, W*C) planes and carries its sum from one sequential grid step to
//   the next; neither transfers.  Here, on plain NDHWC tensors,
//
//     dW[kz,ky,kx,ci,co] = sum_{b,d,h,w} x[b,d+kz-1,h+ky-1,w+kx-1,ci]
//                                        * g[b,d,h,w,co]
//
//   with out-of-volume x read as zero, products accumulated in float32 and
//   dW written in float32.  It does 2*27*Cin*Cout flops per voxel against
//   (Cin+Cout) elements read, so at the U-Net's widths it is bound by
//   operations, and its output is tiny (at most 27*128*64 floats) while the
//   reduction runs over millions of voxels -- the opposite of the forward
//   conv.  Parallelism therefore comes from splitting the voxels:
//
//   * a block owns CI input channels x CO output channels and walks over a
//     chunk of 32x2x2-voxel tiles, staging each tile's x halo (34x4x4) and
//     its g values in shared memory (zero beyond the volume and beyond the
//     channel counts, so ragged tiles and the conv's padding need no
//     branches in the inner loop);
//   * one warp per (kz, ky); a lane owns one input channel and CO_T output
//     channels and keeps the 3 kx taps x CO_T sums in registers for the
//     whole chunk.  It slides along x, so each step loads one new x value
//     and CO_T g values (a broadcast vector load) for 3*CO_T FMAs;
//   * each block writes its partial sums to a workspace
//     (chunks, 27, Cin, Cout) and a second small kernel adds the chunks in
//     a fixed order.  No atomics: the result is the same from run to run.
//
//   With stride 2 (the VoxelMorph encoder: g has ceil(n/2) voxels per axis
//   and output o meets inputs 2o-1..2o+1) the tiles cover g, the x halo of a
//   tile is 65x5x5 voxels, and the lane slides along x two inputs per
//   output; nothing is spent on the odd outputs that a zero-stuffed g at
//   x's resolution would multiply by zero.  The halo no longer fits static
//   shared memory, so both strides take theirs dynamically.
//
//   This first version runs on the CUDA cores in float32 (bf16 products are
//   exact in float32); a tensor-core version is the next step.
//
// x and g share one type (float32 or bfloat16).  Every entry point returns
// cudaGetLastError() of its launches.
#include "common.cuh"

namespace {

using da::to_float;

constexpr int TX = 32, TY = 2, TZ = 2;  // voxels of g in a tile
constexpr int TILE_VOX = TX * TY * TZ;
// x voxels a tile's taps touch, per axis and in all, at stride s
__host__ __device__ constexpr int halo_side(int n, int s) {
  return s * (n - 1) + 3;
}
__host__ __device__ constexpr int halo_voxels(int s) {
  return halo_side(TX, s) * halo_side(TY, s) * halo_side(TZ, s);
}
constexpr int WG_THREADS = 9 * 32;  // one warp per (kz, ky)
// blocks to aim for over the whole grid: several waves of the 132 SMs, so
// that the last, partly filled wave costs little
constexpr int TARGET_BLOCKS = 2640;

template <int N>
__device__ __forceinline__ void load_vec(float* dst, const float* src) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      const float4 v = *reinterpret_cast<const float4*>(src + i);
      dst[i] = v.x, dst[i + 1] = v.y, dst[i + 2] = v.z, dst[i + 3] = v.w;
    }
  } else {
    static_assert(N % 2 == 0, "CO_T must be even");
#pragma unroll
    for (int i = 0; i < N; i += 2) {
      const float2 v = *reinterpret_cast<const float2*>(src + i);
      dst[i] = v.x, dst[i + 1] = v.y;
    }
  }
}

struct Tiling {
  int tiles_x, tiles_y, tiles_z;
  long long n_tiles;
  int tiles_per_chunk, chunks;
};

// How the voxels of g (B, D, H, W of them) are cut into tiles and the tiles
// into chunks, for a grid of `channel_blocks` (ci, co) blocks per chunk.
Tiling make_tiling(int B, int D, int H, int W, int channel_blocks) {
  Tiling t;
  t.tiles_x = (W + TX - 1) / TX;
  t.tiles_y = (H + TY - 1) / TY;
  t.tiles_z = (D + TZ - 1) / TZ;
  t.n_tiles = (long long)B * t.tiles_x * t.tiles_y * t.tiles_z;
  long long want = (TARGET_BLOCKS + channel_blocks - 1) / channel_blocks;
  if (want > t.n_tiles) want = t.n_tiles;
  if (want < 1) want = 1;
  t.tiles_per_chunk = (int)((t.n_tiles + want - 1) / want);
  if (t.tiles_per_chunk < 1) t.tiles_per_chunk = 1;
  t.chunks = (int)((t.n_tiles + t.tiles_per_chunk - 1) / t.tiles_per_chunk);
  if (t.chunks < 1) t.chunks = 1;
  return t;
}

// Bytes of dynamic shared memory of one block: the x halo, then the g tile.
template <int CI, int CO_T, int S>
constexpr int wgrad_smem_bytes() {
  return (halo_voxels(S) * CI + TILE_VOX * (32 / CI) * CO_T) * 4;
}

// x is (B, D, H, W, Cin); g is (B, Do, Ho, Wo, Cout) with ceil(n / S) voxels
// per axis; the tiles cover g.
template <typename T, int CI, int CO_T, int S>
__global__ void __launch_bounds__(WG_THREADS)
conv3d_k3_wgrad_kernel(const T* __restrict__ x, const T* __restrict__ g,
                       float* __restrict__ partial, int D, int H, int W,
                       int Do, int Ho, int Wo, int Cin, int Cout, int tiles_x,
                       int tiles_y, int tiles_z, long long n_tiles,
                       int tiles_per_chunk) {
  constexpr int NCOG = 32 / CI;     // groups of output channels per warp
  constexpr int CO = NCOG * CO_T;   // output channels of a block
  constexpr int HX = halo_side(TX, S), HY = halo_side(TY, S);
  constexpr int HALO = halo_voxels(S);
  static_assert((HALO * CI) % 4 == 0, "the g tile must stay 16-byte aligned");
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;               // [halo voxel][ci]
  float* gs = smem + HALO * CI;   // [voxel][co]

  const int tid = threadIdx.x;
  const int k = tid / 32;  // kz * 3 + ky
  const int kz = k / 3, ky = k % 3;
  const int lane = tid % 32;
  const int ci = lane % CI, cog = lane / CI;
  const int ci0 = blockIdx.y * CI, co0 = blockIdx.z * CO;

  float acc[3][CO_T];
#pragma unroll
  for (int kx = 0; kx < 3; ++kx)
#pragma unroll
    for (int c = 0; c < CO_T; ++c) acc[kx][c] = 0.f;

  const int64_t plane = (int64_t)H * W, gplane = (int64_t)Ho * Wo;
  const int64_t t_begin = (int64_t)blockIdx.x * tiles_per_chunk;
  const int64_t t_end = min((long long)(t_begin + tiles_per_chunk), n_tiles);

  for (int64_t t = t_begin; t < t_end; ++t) {
    int64_t r = t;
    const int x0 = (int)(r % tiles_x) * TX;
    r /= tiles_x;
    const int y0 = (int)(r % tiles_y) * TY;
    r /= tiles_y;
    const int z0 = (int)(r % tiles_z) * TZ;
    const int64_t b = r / tiles_z;
    const T* xb = x + b * D * plane * Cin;
    const T* gb = g + b * Do * gplane * Cout;

    __syncthreads();  // the previous tile's readers are done
    for (int i = tid; i < HALO * CI; i += WG_THREADS) {
      const int c = i % CI, hv = i / CI;
      const int hx = hv % HX, hy = (hv / HX) % HY, hz = hv / (HX * HY);
      const int gx = S * x0 + hx - 1, gy = S * y0 + hy - 1,
                gz = S * z0 + hz - 1;
      float v = 0.f;
      if (ci0 + c < Cin && gx >= 0 && gx < W && gy >= 0 && gy < H &&
          gz >= 0 && gz < D)
        v = to_float(xb[(gz * plane + (int64_t)gy * W + gx) * Cin + ci0 + c]);
      xs[i] = v;
    }
    for (int i = tid; i < TILE_VOX * CO; i += WG_THREADS) {
      const int c = i % CO, v = i / CO;
      const int gx = x0 + v % TX, gy = y0 + (v / TX) % TY,
                gz = z0 + v / (TX * TY);
      float val = 0.f;
      if (co0 + c < Cout && gx < Wo && gy < Ho && gz < Do)
        val = to_float(
            gb[(gz * gplane + (int64_t)gy * Wo + gx) * Cout + co0 + c]);
      gs[i] = val;
    }
    __syncthreads();

#pragma unroll
    for (int zz = 0; zz < TZ; ++zz) {
#pragma unroll
      for (int yy = 0; yy < TY; ++yy) {
        const float* xr =
            xs + ((S * zz + kz) * HY + S * yy + ky) * HX * CI + ci;
        const float* gr = gs + (zz * TY + yy) * TX * CO + cog * CO_T;
        float xa = xr[0], xb1 = xr[CI];
#pragma unroll 4
        for (int xx = 0; xx < TX; ++xx) {
          // the three taps of output xx are halo columns S*xx .. S*xx + 2
          if constexpr (S == 2) xb1 = xr[(2 * xx + 1) * CI];
          const float xc = xr[(S * xx + 2) * CI];
          float gv[CO_T];
          load_vec<CO_T>(gv, gr + xx * CO);
#pragma unroll
          for (int c = 0; c < CO_T; ++c) {
            acc[0][c] = fmaf(xa, gv[c], acc[0][c]);
            acc[1][c] = fmaf(xb1, gv[c], acc[1][c]);
            acc[2][c] = fmaf(xc, gv[c], acc[2][c]);
          }
          if constexpr (S == 1) {
            xa = xb1;
            xb1 = xc;
          } else {
            xa = xc;
          }
        }
      }
    }
  }

  if (ci0 + ci >= Cin) return;
  float* p = partial + (int64_t)blockIdx.x * 27 * Cin * Cout;
#pragma unroll
  for (int kx = 0; kx < 3; ++kx) {
    float* row = p + ((int64_t)(k * 3 + kx) * Cin + ci0 + ci) * Cout;
#pragma unroll
    for (int c = 0; c < CO_T; ++c) {
      const int co = co0 + cog * CO_T + c;
      if (co < Cout) row[co] = acc[kx][c];
    }
  }
}

// dw[i] = sum over chunks of partial[chunk][i], in chunk order.
__global__ void wgrad_reduce_kernel(const float* __restrict__ partial,
                                    float* __restrict__ dw, int n,
                                    int chunks) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int c = 0; c < chunks; ++c) s += partial[(int64_t)c * n + i];
  dw[i] = s;
}

// The (CI, CO_T) variant for a channel pair: wide output groups where Cout
// allows (more FMAs per shared-memory load), 16 input channels where Cout
// leaves half of the lanes free.
enum Variant { kCi8Co8, kCi8Co16, kCi16Co16, kCi8Co32 };

Variant pick_variant(int Cin, int Cout) {
  if (Cout <= 8) return kCi8Co8;
  if (Cout <= 16) return Cin <= 8 ? kCi8Co16 : kCi16Co16;
  return kCi8Co32;
}

int channel_blocks(int Cin, int Cout) {
  int ci = 8, co = 32;
  switch (pick_variant(Cin, Cout)) {
    case kCi8Co8: co = 8; break;
    case kCi8Co16: co = 16; break;
    case kCi16Co16: ci = 16, co = 16; break;
    case kCi8Co32: break;
  }
  return ((Cin + ci - 1) / ci) * ((Cout + co - 1) / co);
}

int out_size(int n, int stride) { return (n + stride - 1) / stride; }

template <typename T, int CI, int CO_T, int S>
int launch_wgrad(const void* x, const void* g, void* partial, int B, int D,
                 int H, int W, int Cin, int Cout, cudaStream_t s) {
  constexpr int CO = (32 / CI) * CO_T;
  constexpr int smem = wgrad_smem_bytes<CI, CO_T, S>();
  const int Do = out_size(D, S), Ho = out_size(H, S), Wo = out_size(W, S);
  const Tiling t = make_tiling(B, Do, Ho, Wo, channel_blocks(Cin, Cout));
  auto kernel = conv3d_k3_wgrad_kernel<T, CI, CO_T, S>;
  if (smem > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (rc != cudaSuccess) return (int)rc;
  }
  dim3 grid(t.chunks, (Cin + CI - 1) / CI, (Cout + CO - 1) / CO);
  kernel<<<grid, WG_THREADS, smem, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(g),
      static_cast<float*>(partial), D, H, W, Do, Ho, Wo, Cin, Cout,
      t.tiles_x, t.tiles_y, t.tiles_z, t.n_tiles, t.tiles_per_chunk);
  return (int)cudaGetLastError();
}

template <typename T, int S>
int dispatch_wgrad(const void* x, const void* g, void* partial, int B, int D,
                   int H, int W, int Cin, int Cout, cudaStream_t s) {
  switch (pick_variant(Cin, Cout)) {
    case kCi8Co8:
      return launch_wgrad<T, 8, 2, S>(x, g, partial, B, D, H, W, Cin, Cout, s);
    case kCi8Co16:
      return launch_wgrad<T, 8, 4, S>(x, g, partial, B, D, H, W, Cin, Cout, s);
    case kCi16Co16:
      return launch_wgrad<T, 16, 8, S>(x, g, partial, B, D, H, W, Cin, Cout,
                                       s);
    default:
      return launch_wgrad<T, 8, 8, S>(x, g, partial, B, D, H, W, Cin, Cout, s);
  }
}

template <typename T>
int dispatch_wgrad_stride(const void* x, const void* g, void* partial, int B,
                          int D, int H, int W, int Cin, int Cout, int stride,
                          cudaStream_t s) {
  return stride == 2
             ? dispatch_wgrad<T, 2>(x, g, partial, B, D, H, W, Cin, Cout, s)
             : dispatch_wgrad<T, 1>(x, g, partial, B, D, H, W, Cin, Cout, s);
}

}  // namespace

extern "C" {

// Chunks of partial sums the launch below writes: the caller allocates a
// float32 workspace of (chunks, 27, Cin, Cout).  D, H, W are x's sizes.
int conv3d_k3_wgrad_chunks(int B, int D, int H, int W, int Cin, int Cout,
                           int stride) {
  return make_tiling(B, out_size(D, stride), out_size(H, stride),
                     out_size(W, stride), channel_blocks(Cin, Cout)).chunks;
}

// x is (B, D, H, W, Cin); g is (B, ceil(D/stride), ceil(H/stride),
// ceil(W/stride), Cout); stride is 1 or 2.
int conv3d_k3_wgrad(int dtype, const void* x, const void* g, void* partial,
                    void* dw, int B, int D, int H, int W, int Cin, int Cout,
                    int stride, void* stream) {
  if (stride != 1 && stride != 2) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rc =
      dtype == da::kBFloat16
          ? dispatch_wgrad_stride<__nv_bfloat16>(x, g, partial, B, D, H, W,
                                                 Cin, Cout, stride, s)
          : dispatch_wgrad_stride<float>(x, g, partial, B, D, H, W, Cin, Cout,
                                         stride, s);
  if (rc != 0) return rc;
  const int n = 27 * Cin * Cout;
  const int chunks = conv3d_k3_wgrad_chunks(B, D, H, W, Cin, Cout, stride);
  wgrad_reduce_kernel<<<(n + 255) / 256, 256, 0, s>>>(
      static_cast<const float*>(partial), static_cast<float*>(dw), n, chunks);
  return (int)cudaGetLastError();
}

}  // extern "C"
