// The k3 conv and its weight gradient in bfloat16 on Hopper's tensor cores
// (mma.sync m16n8k16, bf16 operands, float32 accumulators), channel-last
// (B, D, H, W, C) tensors, for sm_90a.  The float32 path keeps the CUDA-core
// kernels of conv3d.cu and conv3d_wgrad.cu.
//
// Both replace TPU kernels that compute on the MXU in bf16 with float32
// accumulation (deepatlas_tpu/pallas/conv3d.py: jnp.dot / dot_general with
// preferred_element_type=float32), so the arithmetic is the TPU kernel's
// own.  Both do 2*27*Cin*Cout flops per voxel against 2*(Cin+Cout) bytes,
// far above the card's ~295 flops/byte balance point at the U-Net's
// widths: they are bound by operations, and the tensor cores are the only
// way towards that bound (the float32 CUDA cores peak at 67 TF/s, against
// 989 for bf16 products).
//
// conv3d_k3_mma: replaces deepatlas_tpu/pallas/conv3d.py::_conv_fwd_kernel.
//   An implicit GEMM: M = output voxels, N = Cout, K = 27 taps x Cin.
//   * A block owns a 16x4x2 (x, y, z) tile of 128 output voxels and up to
//     64 output channels; each of its 4 warps owns 32 voxels (two 16-row
//     m-tiles) and all the block's channels (NT n-tiles of 8).
//   * K is walked 8 input channels at a time (a stage).  A stage's input
//     halo (18x6x4 voxels, 33x9x5 at stride 2) is staged channel-last, one
//     16-byte slot of 8 bf16 channels per voxel, and its weights as a
//     (28 x 8) x N matrix (27 taps and a zero tap).  cp.async fills the
//     next stage's halo and weights while the tensor cores work on this
//     one (two buffers).
//   * A k-chunk of 16 is two taps of the same 8 channels: an A fragment is
//     one ldmatrix.x4 of 16 voxel rows, each row one 16-byte slot, so the
//     tap's shift is a shift of whole rows and keeps their alignment; the
//     odd slot stride (16 bytes) spreads the 8 rows of a matrix over all
//     banks.  B fragments come from the weights with ldmatrix.trans (rows
//     padded by 16 bytes against bank conflicts).  Channels and taps past
//     the ends are zeros in shared memory: Cin = 1, 2 and 3 and Cout = 3
//     are padded to 8 there, never in device memory.
//   * Stride 2 (the VoxelMorph encoder): the tile covers the strided
//     output; the halo is stored with its even x columns before its odd
//     ones, so that the 2x-spread rows of a fragment sit in consecutive
//     slots again.
//   * dx of the stride-1 conv is the same kernel on the upstream gradient
//     with the adjoint weights.
//
// conv3d_k3_block_mma: kernel K, replaces deepatlas_tpu/pallas/conv3d.py::
//   _conv_fwd_block_kernel (the same conv, forward only, p_blk output
//   planes per grid step, one halo DMA serving all of them).  The same
//   kernel with a tile p_blk planes deep: 16x4xp_blk voxels, 2 p_blk warps
//   of two m-tiles each, so that a stage's (p_blk + 2)-plane halo and its
//   (28 x 8) x N weights serve 64 p_blk voxels.  At 64 output channels a
//   stage's weights are ~28 KB against a 6.9 KB halo at A's depth of 2: the
//   weights are what a deeper tile reuses.  p_blk 2 is A's own instance.
//   The planes past the depth read the zero padding and are not stored.
//   At p_blk 8 a block is 512 threads, so the launch bound holds a thread
//   to 128 registers, 64 of them the accumulators at NT = 8; at p_blk 7
//   and 8 the B fragments of a chunk are loaded in two halves to fit.
//
// conv3d_k3_dx_s2_mma: the input gradient of the stride-2 conv.  Input i
//   meets output o through tap k only where i = 2o + k - 1: per axis, even
//   i through tap 1 (o = i/2), odd i through taps 0 (o = (i+1)/2) and 2
//   (o = (i-1)/2).  The input voxels fall into 8 parity classes with 1, 2,
//   4 or 8 taps each (27 in all), so each class is a small conv over the
//   upstream gradient's grid: 1/8 of the work of the stride-1 kernel on a
//   zero-stuffed gradient, and no zero-stuffed tensor.  One launch; the
//   class comes from the grid and its taps from a table the caller builds.
//
// conv3d_k3_wgrad_mma: replaces deepatlas_tpu/pallas/conv3d.py::
//   _conv_wgrad_kernel.  dW is a GEMM (27 Cin) x Cout = im2col(x)^T g with
//   K over the voxels (up to 5.6 M): a tiny output and a long reduction.
//   * The voxels are split into chunks across blocks, as in
//     conv3d_wgrad.cu: each block writes its partial dW to a workspace
//     (chunks, 27, Cin, Cout) and a second kernel adds the chunks in a
//     fixed order -- no atomics, so dW is the same bit for bit from run to
//     run.
//   * The (tap, ci) rows are split too: a block owns 8 or 16 input
//     channels and up to 32 output channels; each of its 9 warps owns one
//     (kz, ky) and its 3 kx taps, i.e. 3 x 16 rows (24 at 8 channels, one
//     zero group) x N, at most 48 float32 accumulators a thread.
//   * A tile of g (32x2x2 voxels, 16x2x2 at stride 2) and its x halo are
//     staged channel-last with cp.async, double-buffered across the
//     chunk's tiles.  A k-chunk is 16 consecutive voxels of a row; both
//     operands come from ldmatrix.trans (the voxels are the rows in shared
//     memory, the channels contiguous), the x rows shifted by the tap.
//   * Stride 2: the tiles cover g, and input 2o + k - 1 is read for output
//     o (the halo's x columns stored even before odd, as in the forward).
//
// Depth padding: every kernel takes pd, the padding of the depth axis (H and
// W are always padded by 1).  pd 1 is the conv above.  pd 0 is the conv of a
// depth shard whose input carries one neighbour plane on each side (a halo
// exchange's output): output plane o reads planes S o .. S o + 2, there are
// (D - 3) / S + 1 of them, and no plane is computed to be thrown away.  Its
// input gradient is the forward at pd 2 at stride 1; at stride 2 the depth
// parities trade roles (even i through taps 0 and 2, odd i through tap 1),
// which the caller's tap table and the kernel's offsets follow.  The weight
// gradient at pd 0 sums over the halo'd input.  pd only moves the depth
// origin of the halo, so pd 1 is the same arithmetic as before.
//
// All take bf16 tensors and write the output in bf16 (the conv, after a
// float32 bias) or float32 (dW).  Every entry point returns
// cudaGetLastError() of its launches.
#include "mma.cuh"

namespace {

using namespace da;

// B fragments of NT n-tiles for one k-chunk from a k-major (row = k, N
// contiguous) bf16 matrix in shared memory; `base` (bytes) is the chunk's
// first row plus the lane's offset from b_lane_offset.
template <int NT>
__device__ __forceinline__ void load_b(uint32_t (&b)[NT][2], uint32_t base) {
  if constexpr (NT == 1) {
    ldsm_x2_t(b[0][0], b[0][1], base);
  } else {
#pragma unroll
    for (int j = 0; j < NT / 2; ++j) {
      uint32_t r[4];
      ldsm_x4_t(r, base + j * 32);
      b[2 * j][0] = r[0], b[2 * j][1] = r[1];
      b[2 * j + 1][0] = r[2], b[2 * j + 1][1] = r[3];
    }
  }
}

// The lane's byte offset in a k-major B matrix for load_b: lanes 8i..8i+7
// give the rows of matrix i, whose k half is i & 1 and n tile i >> 1.
template <int NT>
__device__ __forceinline__ int b_lane_offset(int lane, int ld) {
  const int i = lane >> 3;
  const int row = (i & 1) * 8 + (lane & 7);
  const int col = NT == 1 ? 0 : (i >> 1) * 8;
  return (row * ld + col) * 2;
}

// Shared-memory slot of halo column hx: at stride 2 the even columns come
// first, then the odd ones, so that x = 2o + kx for o = 0, 1, 2, ... are
// consecutive slots.
template <int S, int HXE>
__host__ __device__ constexpr int xslot(int hx) {
  return S == 2 ? (hx & 1) * HXE + (hx >> 1) : hx;
}

// ---------------------------------------------------------------- k3 conv
enum ConvMode { kFwdS1 = 0, kFwdS2 = 1, kDxS2 = 2 };

constexpr int CV_TX = 16, CV_TY = 4, CV_TZ = 2;  // A's tile: 128 voxels
constexpr int CV_MT = 2;                         // m-tiles per warp

// Threads of a block whose tile is TZ planes deep: each warp owns CV_MT of
// the tile's CV_TY * TZ x-lines (32 voxels), so 2 TZ warps (A: 4 warps).
template <int TZ>
__host__ __device__ constexpr int cv_threads() {
  return 32 * CV_TY * TZ / CV_MT;
}

// Halo geometry of a mode and a tile TZ planes deep.  The forward's halo
// starts one voxel before the tile (the conv's padding) and spans
// S*(T-1)+3 voxels; the strided dx's spans T+1 voxels of the upstream
// gradient from the tile's origin.
template <int MODE, int TZ = CV_TZ>
struct ConvGeo {
  static constexpr int S = MODE == kFwdS2 ? 2 : 1;
  static constexpr int ORG = MODE == kDxS2 ? 0 : -1;
  static constexpr int HX = MODE == kDxS2 ? CV_TX + 1 : S * (CV_TX - 1) + 3;
  static constexpr int HY = MODE == kDxS2 ? CV_TY + 1 : S * (CV_TY - 1) + 3;
  static constexpr int HZ = MODE == kDxS2 ? TZ + 1 : S * (TZ - 1) + 3;
  static constexpr int HXE = (HX + 1) / 2;
  static constexpr int HXS = S == 2 ? 2 * HXE : HX;  // slots per halo row
  static constexpr int SLOTS = HZ * HY * HXS;        // 16-byte slots
  static constexpr int NTAP = MODE == kDxS2 ? 8 : 28;  // weight taps staged
};

// Taps of each parity class of the strided dx (class = pz*4 + py*2 + px,
// tap = kz*9 + ky*3 + kx), built by the caller.
struct TapTable {
  int n[8];
  int tap[8][8];
};

// Slot offset of tap `t` from a voxel's row offset, forward modes.
template <int MODE>
__device__ __forceinline__ int fwd_tap_offset(int t) {
  using G = ConvGeo<MODE>;
  const int kz = t / 9, ky = (t / 3) % 3, kx = t % 3;
  return (kz * G::HY + ky) * G::HXS + xslot<G::S, G::HXE>(kx);
}

// weight row stride (elements): an odd multiple of 16 bytes
template <int NT>
__host__ __device__ constexpr int cv_wld() {
  return NT == 1 ? 8 : 8 * NT + 8;
}

template <int MODE, int NT, int TZ>
__host__ __device__ constexpr int cv_stage_bytes() {
  using G = ConvGeo<MODE, TZ>;
  return G::SLOTS * 16 + G::NTAP * 8 * cv_wld<NT>() * 2;
}

template <int MODE, int NT, int TZ>
__host__ __device__ constexpr int cv_smem_bytes() {
  return 2 * cv_stage_bytes<MODE, NT, TZ>() + 16 + 16 * 4;
}

// x: the halo's source (B, SD, SH, SW, Cin) -- the conv's input, or the
//   upstream gradient for kDxS2;
// wpk: packed weights (K_pad, NP) bf16, row = tap * CP + ci (CP = Cin
//   rounded up to 8), zero past Cin and past the y channels;
// y: (B, YD, YH, YW, Cy); the tiles cover a (GD, GH, GW) grid: the output
//   for the forward modes, the upstream gradient's grid for kDxS2, where
//   grid voxel q of class p is input voxel 2q + p.
// TZ is the tile's depth in planes: 2 for A (every mode), p_blk for K
// (kFwdS1 only).
template <int MODE, int NT, int TZ>
__global__ void __launch_bounds__(cv_threads<TZ>())
conv3d_k3_mma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ wpk,
                     const float* __restrict__ bias, bf16* __restrict__ y,
                     int SD, int SH, int SW, int YD, int YH, int YW, int Cin,
                     int CP, int Cy, int NP, int tiles_x, int tiles_y,
                     int n_blocks_n, int vec, TapTable table, int pd) {
  using G = ConvGeo<MODE, TZ>;
  constexpr int THREADS = cv_threads<TZ>();
  constexpr int BN = 8 * NT, WLD = cv_wld<NT>();
  constexpr int HALO_B = G::SLOTS * 16;
  constexpr int STAGE_B = cv_stage_bytes<MODE, NT, TZ>();
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* zero = smem + 2 * STAGE_B;  // one 16-byte zero slot
  int* toff_s = reinterpret_cast<int*>(zero + 16);
  int* wrow_s = toff_s + 8;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int t = blockIdx.x;
  const int tx0 = (t % tiles_x) * CV_TX;
  t /= tiles_x;
  const int ty0 = (t % tiles_y) * CV_TY;
  const int tz0 = (t / tiles_y) * TZ;
  const int b = blockIdx.y;
  const int cls = blockIdx.z / n_blocks_n;
  const int n0 = (blockIdx.z % n_blocks_n) * BN;
  const int ntap = MODE == kDxS2 ? table.n[cls] : 27;
  // depth origin of the halo: the forward's starts pd planes before the
  // tile; the strided dx's at grid plane pd - 1 (its taps reach grid
  // offsets 0..1 at pd 1, -1..0 at pd 0)
  const int zorg = MODE == kDxS2 ? pd - 1 : -pd;

  if (tid < 4) reinterpret_cast<uint32_t*>(zero)[tid] = 0u;
  if (MODE == kDxS2 && tid < 8) {
    // the halo offset of each of the class's taps: per axis, parity p
    // meets the forward's tap k at grid offset (p + 1 - k) / 2 (in depth
    // (p + pd - k) / 2, taken from the halo's origin zorg); the weights
    // are the adjoint's (flipped), whose row of tap k is 26 - k
    int off = 0, row = 0;
    if (tid < ntap) {
      const int tap = table.tap[cls][tid];
      const int kz = tap / 9, ky = (tap / 3) % 3, kx = tap % 3;
      const int pz = cls >> 2, py = (cls >> 1) & 1, px = cls & 1;
      off = ((((pz + pd - kz) >> 1) - zorg) * G::HY + ((py + 1 - ky) >> 1)) *
                G::HXS +
            ((px + 1 - kx) >> 1);
      row = 26 - tap;
    }
    toff_s[tid] = off;
    wrow_s[tid] = row;
  }
  __syncthreads();

  const int64_t splane = (int64_t)SH * SW;
  const bf16* xb = x + (int64_t)b * SD * splane * Cin;

  // stage s: channels 8s .. 8s+7 of the halo and of every staged tap
  auto fill_stage = [&](int s, int buf) {
    const int ci0 = 8 * s;
    unsigned char* base = smem + buf * STAGE_B;
    for (int i = tid; i < G::HZ * G::HY * G::HX; i += THREADS) {
      const int hx = i % G::HX, hy = (i / G::HX) % G::HY,
                hz = i / (G::HX * G::HY);
      const int gx = G::S * tx0 + hx + G::ORG, gy = G::S * ty0 + hy + G::ORG,
                gz = G::S * tz0 + hz + zorg;
      const bool in = gx >= 0 && gx < SW && gy >= 0 && gy < SH && gz >= 0 &&
                      gz < SD;
      unsigned char* dst =
          base + ((hz * G::HY + hy) * G::HXS + xslot<G::S, G::HXE>(hx)) * 16;
      const bf16* src =
          in ? xb + (gz * splane + (int64_t)gy * SW + gx) * Cin + ci0 : x;
      if (vec)
        cp_async16(smem_u32(dst), src, in);
      else
        *reinterpret_cast<uint4*>(dst) =
            load8_scalar(src, in ? min(8, Cin - ci0) : 0);
    }
    bf16* ws = reinterpret_cast<bf16*>(base + HALO_B);
    for (int i = tid; i < G::NTAP * 8 * NT; i += THREADS) {
      const int q = i % NT, r = (i / NT) % 8, slot = i / (NT * 8);
      const int wrow = MODE == kDxS2 ? wrow_s[slot] : slot;
      const bool ok = slot < ntap && n0 + 8 * q < NP;
      const bf16* src =
          ok ? wpk + (int64_t)(wrow * CP + ci0 + r) * NP + n0 + 8 * q : wpk;
      cp_async16(smem_u32(ws + (slot * 8 + r) * WLD + 8 * q), src, ok);
    }
  };

  // the lane's A rows: voxel (lane & 15) of each of the warp's m-tiles
  int roff[CV_MT];
#pragma unroll
  for (int mt = 0; mt < CV_MT; ++mt) {
    const int line = 2 * warp + mt;  // x-line of the tile: (z, y)
    const int lz = line / CV_TY, ly = line % CV_TY, lx = lane & 15;
    roff[mt] = (G::S * lz * G::HY + G::S * ly) * G::HXS + lx;
  }
  const int khalf = lane >> 4;  // which tap of the chunk the lane's rows use
  const int b_off = b_lane_offset<NT>(lane, WLD);
  const uint32_t zaddr = smem_u32(zero);

  float acc[CV_MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < CV_MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[mt][nt][r] = 0.f;

  const int n_stages = CP / 8;
  fill_stage(0, 0);
  cp_async_commit();
  for (int s = 0; s < n_stages; ++s) {
    const int buf = s & 1;
    if (s + 1 < n_stages) {
      fill_stage(s + 1, buf ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const uint32_t hbase = smem_u32(smem + buf * STAGE_B);
    const uint32_t wbase = hbase + HALO_B + b_off;
    constexpr int MAX_CHUNKS = G::NTAP / 2;
#pragma unroll
    for (int c = 0; c < MAX_CHUNKS; ++c) {
      if (MODE == kDxS2 && 2 * c >= ntap) break;
      const int slot = 2 * c + khalf;
      const bool valid = slot < ntap;
      const int toff = MODE == kDxS2
                           ? toff_s[slot]
                           : (khalf ? fwd_tap_offset<MODE>(2 * c + 1)
                                    : fwd_tap_offset<MODE>(2 * c));
      uint32_t a[CV_MT][4];
#pragma unroll
      for (int mt = 0; mt < CV_MT; ++mt)
        ldsm_x4(a[mt], valid ? hbase + (roff[mt] + toff) * 16 : zaddr);
      if constexpr (NT == 8 && TZ >= 7) {
        // 448 or 512 threads hold a thread to 128 registers: half the B
        // fragments at a time keeps 8 fewer live, so that nothing spills
        // (each accumulator takes the same products in the same order)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          uint32_t bfr[NT / 2][2];
          load_b<NT / 2>(bfr, wbase + 16 * c * WLD * 2 + h * 64);
#pragma unroll
          for (int mt = 0; mt < CV_MT; ++mt)
#pragma unroll
            for (int nt = 0; nt < NT / 2; ++nt)
              mma_bf16(acc[mt][h * NT / 2 + nt], a[mt], bfr[nt][0],
                       bfr[nt][1]);
        }
      } else {
        uint32_t bfr[NT][2];
        load_b<NT>(bfr, wbase + 16 * c * WLD * 2);
#pragma unroll
        for (int mt = 0; mt < CV_MT; ++mt)
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
            mma_bf16(acc[mt][nt], a[mt], bfr[nt][0], bfr[nt][1]);
      }
    }
    __syncthreads();  // this buffer's readers are done before it refills
  }

  // epilogue: accumulator (mt, nt, r) is voxel row (lane >> 2) (+ 8 for
  // r >= 2) of the m-tile, channel 2 * (lane & 3) (+ 1 for odd r)
  const int pz = cls >> 2, py = (cls >> 1) & 1, px = cls & 1;
  const bool pair_ok = (Cy % 2) == 0;
#pragma unroll
  for (int mt = 0; mt < CV_MT; ++mt) {
    const int line = 2 * warp + mt;
    const int lz = line / CV_TY, ly = line % CV_TY;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int lx = (lane >> 2) + 8 * half;
      int oz = tz0 + lz, oy = ty0 + ly, ox = tx0 + lx;
      if (MODE == kDxS2) oz = 2 * oz + pz, oy = 2 * oy + py, ox = 2 * ox + px;
      if (oz >= YD || oy >= YH || ox >= YW) continue;
      bf16* yp = y + ((((int64_t)b * YD + oz) * YH + oy) * YW + ox) * Cy;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int n = n0 + nt * 8 + 2 * (lane & 3);
        float v0 = acc[mt][nt][2 * half], v1 = acc[mt][nt][2 * half + 1];
        if (bias != nullptr) {
          if (n < Cy) v0 += bias[n];
          if (n + 1 < Cy) v1 += bias[n + 1];
        }
        if (pair_ok && n + 1 < Cy) {
          *reinterpret_cast<__nv_bfloat162*>(yp + n) =
              __floats2bfloat162_rn(v0, v1);
        } else {
          if (n < Cy) yp[n] = __float2bfloat16_rn(v0);
          if (n + 1 < Cy) yp[n + 1] = __float2bfloat16_rn(v1);
        }
      }
    }
  }
}

int round8(int n) { return (n + 7) / 8 * 8; }

template <int MODE, int NT, int TZ>
int launch_conv(const void* x, const void* wpk, const void* bias, void* y,
                int B, int SD, int SH, int SW, int GD, int GH, int GW, int YD,
                int YH, int YW, int Cin, int Cy, int n_classes,
                const TapTable& table, int pd, cudaStream_t s) {
  constexpr int BN = 8 * NT;
  constexpr int smem = cv_smem_bytes<MODE, NT, TZ>();
  auto kernel = conv3d_k3_mma_kernel<MODE, NT, TZ>;
  if (smem > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (rc != cudaSuccess) return (int)rc;
  }
  const int NP = round8(Cy);
  const int tiles_x = (GW + CV_TX - 1) / CV_TX,
            tiles_y = (GH + CV_TY - 1) / CV_TY,
            tiles_z = (GD + TZ - 1) / TZ;
  const int n_blocks_n = (NP + BN - 1) / BN;
  const int vec = (Cin % 8) == 0 && (reinterpret_cast<uintptr_t>(x) % 16) == 0;
  dim3 grid(tiles_x * tiles_y * tiles_z, B, n_classes * n_blocks_n);
  kernel<<<grid, cv_threads<TZ>(), smem, s>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(wpk),
      static_cast<const float*>(bias), static_cast<bf16*>(y), SD, SH, SW, YD,
      YH, YW, Cin, round8(Cin), Cy, NP, tiles_x, tiles_y, n_blocks_n, vec,
      table, pd);
  return (int)cudaGetLastError();
}

// n-tiles of a block for Cy output channels: all of them up to 64
template <int MODE, int TZ = CV_TZ>
int dispatch_conv(const void* x, const void* wpk, const void* bias, void* y,
                  int B, int SD, int SH, int SW, int GD, int GH, int GW,
                  int YD, int YH, int YW, int Cin, int Cy, int n_classes,
                  const TapTable& table, int pd, cudaStream_t s) {
  const int np = round8(Cy);
#define DA_CONV(NT)                                                          \
  launch_conv<MODE, NT, TZ>(x, wpk, bias, y, B, SD, SH, SW, GD, GH, GW, YD, \
                            YH, YW, Cin, Cy, n_classes, table, pd, s)
  if (np <= 8) return DA_CONV(1);
  if (np <= 16) return DA_CONV(2);
  if (np <= 32) return DA_CONV(4);
  return DA_CONV(8);
#undef DA_CONV
}

int out_size(int n, int stride) { return (n + stride - 1) / stride; }
int out_depth(int d, int stride, int pd) {
  return (d + 2 * pd - 3) / stride + 1;
}

// ------------------------------------------------------- weight gradient
constexpr int WG_THREADS = 9 * 32;  // one warp per (kz, ky)
// blocks to aim for over the whole grid: eight per SM (several waves of
// the 132 SMs), fewer partial sums than the CUDA-core kernel's 2640
constexpr int WG_TARGET_BLOCKS = 1056;
// the most tiles a chunk sums: a chunk's products pass through one float32
// accumulator chain, whose rounding grows with its length (1.5e-4 of dW's
// largest entry at 1146 tiles, 168x200x168 at Cin 192 -> 64; 1.7e-5 at
// 144).  Wide channels leave few chunks of many tiles each, so their chunks
// are cut to this length, at the cost of a larger partial-sum workspace
// (465 MB there).  144 is the longest chunk of UNet_light's and
// VoxelMorph's shapes, whose tilings it leaves as they were.
constexpr int WG_MAX_TILES_PER_CHUNK = 144;

template <int S>
struct WgradGeo {
  static constexpr int TX = S == 1 ? 32 : 16, TY = 2, TZ = 2;
  static constexpr int TV = TX * TY * TZ;  // voxels of g in a tile
  static constexpr int HX = S * (TX - 1) + 3, HY = S * (TY - 1) + 3,
                       HZ = S * (TZ - 1) + 3;
  static constexpr int HXE = (HX + 1) / 2;
  static constexpr int HXS = S == 2 ? 2 * HXE : HX;
};

// halo slot stride (elements): an odd multiple of 16 bytes
template <int CI>
__host__ __device__ constexpr int wg_xld() {
  return CI == 8 ? 8 : CI + 8;
}
template <int NT>
__host__ __device__ constexpr int wg_gld() {
  return NT == 1 ? 8 : 8 * NT + 8;
}
template <int S, int CI, int NT>
__host__ __device__ constexpr int wg_stage_elems() {
  using G = WgradGeo<S>;
  return G::HZ * G::HY * G::HXS * wg_xld<CI>() + G::TV * wg_gld<NT>();
}
template <int S, int CI, int NT>
__host__ __device__ constexpr int wg_smem_bytes() {
  return 2 * wg_stage_elems<S, CI, NT>() * 2 + 16;
}

struct Tiling {
  int tiles_x, tiles_y, tiles_z;
  long long n_tiles;
  int tiles_per_chunk, chunks;
};

Tiling make_tiling(int B, int D, int H, int W, int tx, int ty, int tz,
                   int channel_blocks) {
  Tiling t;
  t.tiles_x = (W + tx - 1) / tx;
  t.tiles_y = (H + ty - 1) / ty;
  t.tiles_z = (D + tz - 1) / tz;
  t.n_tiles = (long long)B * t.tiles_x * t.tiles_y * t.tiles_z;
  long long want = (WG_TARGET_BLOCKS + channel_blocks - 1) / channel_blocks;
  if (want > t.n_tiles) want = t.n_tiles;
  if (want < 1) want = 1;
  t.tiles_per_chunk = (int)((t.n_tiles + want - 1) / want);
  if (t.tiles_per_chunk > WG_MAX_TILES_PER_CHUNK)
    t.tiles_per_chunk = WG_MAX_TILES_PER_CHUNK;
  if (t.tiles_per_chunk < 1) t.tiles_per_chunk = 1;
  t.chunks = (int)((t.n_tiles + t.tiles_per_chunk - 1) / t.tiles_per_chunk);
  if (t.chunks < 1) t.chunks = 1;
  return t;
}

// x is (B, D, H, W, Cin); g is (B, Do, Ho, Wo, Cout) with ceil(n / S)
// voxels on H and W and Do = (D + 2 pd - 3) / S + 1; the tiles cover g.
// A block: CI input channels from
// blockIdx.y * CI, 8 * NT output channels from blockIdx.z * 8 * NT, the
// tiles of chunk blockIdx.x.
template <int S, int CI, int NT>
__global__ void __launch_bounds__(WG_THREADS, 2)
conv3d_k3_wgrad_mma_kernel(const bf16* __restrict__ x,
                           const bf16* __restrict__ g,
                           float* __restrict__ partial, int D, int H, int W,
                           int Do, int Ho, int Wo, int Cin, int Cout,
                           int tiles_x, int tiles_y, int tiles_z,
                           long long n_tiles, int tiles_per_chunk, int vec_x,
                           int vec_g, int pd) {
  using G = WgradGeo<S>;
  constexpr int XLD = wg_xld<CI>(), GLD = wg_gld<NT>();
  constexpr int NC8 = CI / 8;         // 8-channel groups of the block
  constexpr int NG = 3 * NC8;         // (kx, c8) groups of a warp
  constexpr int MTW = (NG + 1) / 2;   // m-tiles of a warp
  constexpr int HALO_E = G::HZ * G::HY * G::HXS * XLD;
  constexpr int STAGE_E = wg_stage_elems<S, CI, NT>();
  constexpr int KCH = G::TV / 16;     // k-chunks of a tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  unsigned char* zero = smem_raw + 2 * STAGE_E * 2;

  const int tid = threadIdx.x, lane = tid & 31;
  const int k = tid >> 5;  // the warp's kz * 3 + ky
  const int kz = k / 3, ky = k % 3;
  const int ci0 = blockIdx.y * CI, co0 = blockIdx.z * 8 * NT;
  const int64_t plane = (int64_t)H * W, gplane = (int64_t)Ho * Wo;

  if (tid < 4) reinterpret_cast<uint32_t*>(zero)[tid] = 0u;

  auto fill_tile = [&](long long t, int buf) {
    long long r = t;
    const int x0 = (int)(r % tiles_x) * G::TX;
    r /= tiles_x;
    const int y0 = (int)(r % tiles_y) * G::TY;
    r /= tiles_y;
    const int z0 = (int)(r % tiles_z) * G::TZ;
    const long long b = r / tiles_z;
    const bf16* xb = x + b * D * plane * Cin;
    const bf16* gb = g + b * Do * gplane * Cout;
    bf16* hs = smem + buf * STAGE_E;
    bf16* gs = hs + HALO_E;
    for (int i = tid; i < G::HZ * G::HY * G::HX * NC8; i += WG_THREADS) {
      const int c8 = i % NC8, hv = i / NC8;
      const int hx = hv % G::HX, hy = (hv / G::HX) % G::HY,
                hz = hv / (G::HX * G::HY);
      const int gx = S * x0 + hx - 1, gy = S * y0 + hy - 1,
                gz = S * z0 + hz - pd;
      const int ci = ci0 + 8 * c8;
      const bool in = ci < Cin && gx >= 0 && gx < W && gy >= 0 && gy < H &&
                      gz >= 0 && gz < D;
      bf16* dst = hs + ((hz * G::HY + hy) * G::HXS +
                        xslot<S, G::HXE>(hx)) * XLD + 8 * c8;
      const bf16* src =
          in ? xb + (gz * plane + (int64_t)gy * W + gx) * Cin + ci : x;
      if (vec_x)
        cp_async16(smem_u32(dst), src, in);
      else
        *reinterpret_cast<uint4*>(dst) =
            load8_scalar(src, in ? min(8, Cin - ci) : 0);
    }
    for (int i = tid; i < G::TV * NT; i += WG_THREADS) {
      const int q = i % NT, v = i / NT;
      const int gx = x0 + v % G::TX, gy = y0 + (v / G::TX) % G::TY,
                gz = z0 + v / (G::TX * G::TY);
      const int co = co0 + 8 * q;
      const bool in = co < Cout && gx < Wo && gy < Ho && gz < Do;
      bf16* dst = gs + v * GLD + 8 * q;
      const bf16* src =
          in ? gb + (gz * gplane + (int64_t)gy * Wo + gx) * Cout + co : g;
      if (vec_g)
        cp_async16(smem_u32(dst), src, in);
      else
        *reinterpret_cast<uint4*>(dst) =
            load8_scalar(src, in ? min(8, Cout - co) : 0);
    }
  };

  // A (x4.trans): lanes 8i..8i+7 give the voxel rows of matrix i, whose
  // m half (group) is i & 1 and k half i >> 1.  The row of voxel v for
  // tap (kz, ky, kx) is halo voxel (S vz + kz, S vy + ky, S vx + kx).
  const int am = lane >> 3;
  const int avox = (am >> 1) * 8 + (lane & 7);  // voxel of a 16-voxel chunk
  int aoff[MTW];  // the group's tap and channel part, elements; -1 = zero
#pragma unroll
  for (int mt = 0; mt < MTW; ++mt) {
    const int gsl = 2 * mt + (am & 1);
    const int kx = gsl / NC8, c8 = gsl % NC8;
    aoff[mt] = gsl < NG ? ((kz * G::HY + ky) * G::HXS +
                           xslot<S, G::HXE>(kx)) * XLD + 8 * c8
                        : -1;
  }
  const int b_off = b_lane_offset<NT>(lane, GLD);
  const uint32_t zaddr = smem_u32(zero);

  float acc[MTW][NT][4];
#pragma unroll
  for (int mt = 0; mt < MTW; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[mt][nt][r] = 0.f;

  const long long t_begin = (long long)blockIdx.x * tiles_per_chunk;
  const long long t_end = min(t_begin + tiles_per_chunk, n_tiles);
  if (t_begin < t_end) fill_tile(t_begin, 0);
  cp_async_commit();
  for (long long t = t_begin; t < t_end; ++t) {
    const int buf = (int)((t - t_begin) & 1);
    if (t + 1 < t_end) {
      fill_tile(t + 1, buf ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const uint32_t hbase = smem_u32(smem + buf * STAGE_E);
    const uint32_t gbase = hbase + HALO_E * 2 + b_off;
#pragma unroll
    for (int kc = 0; kc < KCH; ++kc) {
      const int v = kc * 16 + avox;
      const int vx = v % G::TX, vy = (v / G::TX) % G::TY,
                vz = v / (G::TX * G::TY);
      const int voff = ((S * vz * G::HY + S * vy) * G::HXS + vx) * XLD;
      uint32_t a[MTW][4];
#pragma unroll
      for (int mt = 0; mt < MTW; ++mt)
        ldsm_x4_t(a[mt],
                  aoff[mt] >= 0 ? hbase + (voff + aoff[mt]) * 2 : zaddr);
      uint32_t bfr[NT][2];
      load_b<NT>(bfr, gbase + kc * 16 * GLD * 2);
#pragma unroll
      for (int mt = 0; mt < MTW; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
          mma_bf16(acc[mt][nt], a[mt], bfr[nt][0], bfr[nt][1]);
    }
    __syncthreads();  // this buffer's readers are done before it refills
  }

  // accumulator (mt, nt, r): row (lane >> 2) of group 2 mt + (r >> 1),
  // i.e. input channel ci0 + 8 c8 + (lane >> 2) at tap (kz, ky, kx);
  // output channel co0 + 8 nt + 2 (lane & 3) + (r & 1)
  float* p = partial + (int64_t)blockIdx.x * 27 * Cin * Cout;
#pragma unroll
  for (int mt = 0; mt < MTW; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int gsl = 2 * mt + half;
      if (gsl >= NG) continue;
      const int kx = gsl / NC8, c8 = gsl % NC8;
      const int ci = ci0 + 8 * c8 + (lane >> 2);
      if (ci >= Cin) continue;
      float* row = p + ((int64_t)(k * 3 + kx) * Cin + ci) * Cout;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int co = co0 + 8 * nt + 2 * (lane & 3);
        if (co < Cout) row[co] = acc[mt][nt][2 * half];
        if (co + 1 < Cout) row[co + 1] = acc[mt][nt][2 * half + 1];
      }
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

// The block's channels: 8 input channels where Cin <= 8, else 16; all
// output channels up to 32, else blocks of 32.
int wg_ci(int Cin) { return Cin <= 8 ? 8 : 16; }
int wg_nt(int Cout) {
  const int np = round8(Cout);
  return np <= 8 ? 1 : np <= 16 ? 2 : 4;
}

Tiling wgrad_tiling(int B, int D, int H, int W, int Cin, int Cout,
                    int stride, int pd) {
  const int tx = stride == 1 ? WgradGeo<1>::TX : WgradGeo<2>::TX;
  const int ci = wg_ci(Cin), bn = 8 * wg_nt(Cout);
  const int channel_blocks = ((Cin + ci - 1) / ci) * ((Cout + bn - 1) / bn);
  return make_tiling(B, out_depth(D, stride, pd), out_size(H, stride),
                     out_size(W, stride), tx, WgradGeo<1>::TY,
                     WgradGeo<1>::TZ, channel_blocks);
}

template <int S, int CI, int NT>
int launch_wgrad(const void* x, const void* g, void* partial, int B, int D,
                 int H, int W, int Cin, int Cout, int pd, cudaStream_t s) {
  constexpr int smem = wg_smem_bytes<S, CI, NT>();
  const Tiling t = wgrad_tiling(B, D, H, W, Cin, Cout, S, pd);
  auto kernel = conv3d_k3_wgrad_mma_kernel<S, CI, NT>;
  if (smem > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (rc != cudaSuccess) return (int)rc;
  }
  const int vec_x =
      (Cin % 8) == 0 && (reinterpret_cast<uintptr_t>(x) % 16) == 0;
  const int vec_g =
      (Cout % 8) == 0 && (reinterpret_cast<uintptr_t>(g) % 16) == 0;
  dim3 grid(t.chunks, (Cin + CI - 1) / CI, (Cout + 8 * NT - 1) / (8 * NT));
  kernel<<<grid, WG_THREADS, smem, s>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(g),
      static_cast<float*>(partial), D, H, W, out_depth(D, S, pd),
      out_size(H, S), out_size(W, S), Cin, Cout, t.tiles_x, t.tiles_y,
      t.tiles_z, t.n_tiles, t.tiles_per_chunk, vec_x, vec_g, pd);
  return (int)cudaGetLastError();
}

template <int S>
int dispatch_wgrad(const void* x, const void* g, void* partial, int B, int D,
                   int H, int W, int Cin, int Cout, int pd, cudaStream_t s) {
  const bool ci8 = wg_ci(Cin) == 8;
  switch (wg_nt(Cout)) {
    case 1:
      return ci8 ? launch_wgrad<S, 8, 1>(x, g, partial, B, D, H, W, Cin,
                                         Cout, pd, s)
                 : launch_wgrad<S, 16, 1>(x, g, partial, B, D, H, W, Cin,
                                          Cout, pd, s);
    case 2:
      return ci8 ? launch_wgrad<S, 8, 2>(x, g, partial, B, D, H, W, Cin,
                                         Cout, pd, s)
                 : launch_wgrad<S, 16, 2>(x, g, partial, B, D, H, W, Cin,
                                          Cout, pd, s);
    default:
      return ci8 ? launch_wgrad<S, 8, 4>(x, g, partial, B, D, H, W, Cin,
                                         Cout, pd, s)
                 : launch_wgrad<S, 16, 4>(x, g, partial, B, D, H, W, Cin,
                                          Cout, pd, s);
  }
}

}  // namespace

extern "C" {

// x is (B, D, H, W, Cin) bf16; wpk the packed (K_pad, round8(Cout)) bf16
// weights; bias (Cout,) float32 or null; y is (B, (D + 2 pd - 3) / stride +
// 1, ceil(H/stride), ceil(W/stride), Cout) bf16; stride is 1 or 2, pd (the
// depth padding) 0, 1 or 2 (2 at stride 1 only: the input gradient of a
// pd-0 conv).
int conv3d_k3_mma(const void* x, const void* wpk, const void* bias, void* y,
                  int B, int D, int H, int W, int Cin, int Cout, int stride,
                  int pd, void* stream) {
  if ((stride != 1 && stride != 2) || pd < 0 || pd > 3 - stride ||
      D + 2 * pd < 3)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const TapTable none = {};
  const int Do = out_depth(D, stride, pd), Ho = out_size(H, stride),
            Wo = out_size(W, stride);
  if (stride == 2)
    return dispatch_conv<kFwdS2>(x, wpk, bias, y, B, D, H, W, Do, Ho, Wo, Do,
                                 Ho, Wo, Cin, Cout, 1, none, pd, s);
  return dispatch_conv<kFwdS1>(x, wpk, bias, y, B, D, H, W, Do, H, W, Do, H,
                               W, Cin, Cout, 1, none, pd, s);
}

// Kernel K: the stride-1 conv without bias, p_blk (1..8) output planes a
// tile (A's kernel with a tile p_blk planes deep; p_blk 2 is A's own
// instance); x, wpk and y as for conv3d_k3_mma.
int conv3d_k3_block_mma(const void* x, const void* wpk, void* y, int B, int D,
                        int H, int W, int Cin, int Cout, int p_blk,
                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const TapTable none = {};
#define DA_BLOCK(TZ)                                                       \
  dispatch_conv<kFwdS1, TZ>(x, wpk, nullptr, y, B, D, H, W, D, H, W, D, H, \
                            W, Cin, Cout, 1, none, 1, s)
  switch (p_blk) {
    case 1: return DA_BLOCK(1);
    case 2: return DA_BLOCK(2);
    case 3: return DA_BLOCK(3);
    case 4: return DA_BLOCK(4);
    case 5: return DA_BLOCK(5);
    case 6: return DA_BLOCK(6);
    case 7: return DA_BLOCK(7);
    case 8: return DA_BLOCK(8);
    default: return (int)cudaErrorInvalidValue;
  }
#undef DA_BLOCK
}

// The input gradient of the stride-2 conv of depth padding pd (0 or 1): g
// is (B, (D + 2 pd - 3) / 2 + 1, ceil(H/2), ceil(W/2), Cg) bf16, wpk the
// packed adjoint weights (K_pad, round8(Cx)), dx is (B, D, H, W, Cx) bf16;
// table holds each parity class's tap count (8 ints) and then its taps
// (8 x 8 ints), the depth parities' taps as pd gives them.
int conv3d_k3_dx_s2_mma(const void* g, const void* wpk, void* dx, int B,
                        int D, int H, int W, int Cg, int Cx, const int* table,
                        int pd, void* stream) {
  if ((pd != 0 && pd != 1) || D + 2 * pd < 3)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  TapTable t;
  for (int c = 0; c < 8; ++c) {
    t.n[c] = table[c];
    if (t.n[c] < 1 || t.n[c] > 8) return (int)cudaErrorInvalidValue;
    for (int j = 0; j < 8; ++j) {
      t.tap[c][j] = table[8 + 8 * c + j];
      if (j < t.n[c] && (t.tap[c][j] < 0 || t.tap[c][j] > 26))
        return (int)cudaErrorInvalidValue;
    }
  }
  const int Do = out_depth(D, 2, pd), Ho = out_size(H, 2),
            Wo = out_size(W, 2);
  // the grid covers the input's classes: ceil(n / 2) voxels per axis
  return dispatch_conv<kDxS2>(g, wpk, nullptr, dx, B, Do, Ho, Wo,
                              out_size(D, 2), Ho, Wo, D, H, W, Cg, Cx, 8, t,
                              pd, s);
}

// Chunks of partial sums the launch below writes: the caller allocates a
// float32 workspace of (chunks, 27, Cin, Cout).  D, H, W are x's sizes.
int conv3d_k3_wgrad_mma_chunks(int B, int D, int H, int W, int Cin, int Cout,
                               int stride, int pd) {
  return wgrad_tiling(B, D, H, W, Cin, Cout, stride, pd).chunks;
}

// x is (B, D, H, W, Cin) bf16; g is (B, (D + 2 pd - 3) / stride + 1,
// ceil(H/stride), ceil(W/stride), Cout) bf16; dw is (3, 3, 3, Cin, Cout)
// float32; pd is 0 or 1.
int conv3d_k3_wgrad_mma(const void* x, const void* g, void* partial, void* dw,
                        int B, int D, int H, int W, int Cin, int Cout,
                        int stride, int pd, void* stream) {
  if ((stride != 1 && stride != 2) || (pd != 0 && pd != 1) ||
      D + 2 * pd < 3)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rc =
      stride == 2
          ? dispatch_wgrad<2>(x, g, partial, B, D, H, W, Cin, Cout, pd, s)
          : dispatch_wgrad<1>(x, g, partial, B, D, H, W, Cin, Cout, pd, s);
  if (rc != 0) return rc;
  const int n = 27 * Cin * Cout;
  const int chunks =
      conv3d_k3_wgrad_mma_chunks(B, D, H, W, Cin, Cout, stride, pd);
  wgrad_reduce_kernel<<<(n + 255) / 256, 256, 0, s>>>(
      static_cast<const float*>(partial), static_cast<float*>(dw), n, chunks);
  return (int)cudaGetLastError();
}

}  // extern "C"
