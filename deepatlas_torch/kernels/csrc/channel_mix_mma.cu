// The per-voxel channel mix on Hopper's tensor cores, in bfloat16, for
// sm_90a: the 1x1x1 conv (TAPS = 1) and the k2 s2 transposed conv
// (TAPS = 8) on channel-last (B, D, H, W, C) tensors,
//
//   y[out(v, t), :] = x[v, :] @ w[t]   (+ bias),   w in (TAPS, Cin, Cout),
//
// with out(v, t) = v for the 1x1x1 conv and, for the transposed conv, input
// voxel (b, d, h, w) and tap t = (a, p, q) -> output (b, 2d+a, 2h+p, 2w+q).
// The float32 path keeps the CUDA-core kernel of channel_mix.cuh.
//
// Replaces deepatlas_tpu/pallas/deconv3d.py::_deconv_kernel (deconv3d.py:55)
// and deepatlas_tpu/pallas/conv3d.py::_conv_point_kernel (conv3d.py:215),
// which compute each block as one jnp.dot on the MXU (M = voxels, K = Cin,
// N = taps x Cout; bf16 operands, float32 sums), then interleave the taps.
// The arithmetic here is the same: bf16 products, float32 sums, the float32
// bias, one rounding to bf16.
//
// Bound by bytes at every main-path shape: the transposed conv does
// 16 Cin Cout flops per input voxel against 2 (Cin + 8 Cout) bytes (28 to 57
// flops per byte at 32->32 and 64->64), the 1x1x1 conv 2 Cin Cout against
// 2 (Cin + Cout) (5 to 11), far below the card's ~295 flops per byte on the
// tensor cores.  The design moves each byte once, in wide coalesced pieces:
//   * A block owns all output channels (up to 64; wider Cout is split over
//     blockIdx.y) of all taps, so every input voxel is read from device
//     memory exactly once.  The blocks are persistent: a block stages its
//     (K_pad, TAPS x 8 NT) slice of the packed weights once, then walks
//     tiles of 128 consecutive flattened input voxels (M; 4 warps x 32
//     rows, mma.sync m16n8k16).  K is Cin padded to 16 in shared memory
//     only; Cin that is not a multiple of 8 is filled by scalar loads.
//   * The input tile arrives by 16-byte cp.async; the next tile's copy is
//     issued as soon as the last MMAs of this one are done, so it overlaps
//     the last epilogue.
//   * The transposed conv's taps are walked inside the block, one (a, p)
//     pair of taps q = 0, 1 at a time (a pass), whose float32 accumulators
//     stay in registers (at most 2 m-tiles x 2 taps x 8 n-tiles x 4).
//   * The epilogue adds the bias, rounds each tap pair to bf16 and stages it
//     in shared memory as output rows: one voxel's taps q = 0, 1 are the
//     2 Cout contiguous values at (2d+a, 2h+p, 2w..2w+1), and consecutive
//     voxels of an input row are consecutive there.  Consecutive threads
//     then write consecutive 16-byte pieces; row, depth and batch breaks
//     and the ragged last tile are handled per voxel by its output base
//     address.  The 1x1x1 conv's tile is one contiguous 128 x Cout run,
//     staged compactly where Cout is not a multiple of 8 (the serving
//     head's 5 classes) so that it too leaves in 16-byte pieces; the
//     transposed conv falls back to scalar stores there.
//   * Shared-memory tiles are unpadded, with the 16-byte chunks of each row
//     XOR-swizzled (swz) so that the 8 rows of an ldmatrix and the 8 rows
//     an accumulator store touches fall on distinct banks.
//
// Entry points take bf16 x, the bf16 weights packed by the caller
// (kernels/conv3d.py pack_mix_weights: (K_pad, TAPS x NP), row ci, column
// t * NP + co, NP = Cout rounded up to 8, zeros past Cin and Cout), a
// float32 bias or null, and write bf16 y.  They return cudaGetLastError()
// of the launch (or an error for a Cin too wide for shared memory).
#include "mma.cuh"

namespace {

using namespace da;

constexpr int MX_VOX = 128;      // voxels of a tile (M)
constexpr int MX_THREADS = 128;  // 4 warps x 32 voxel rows

// Chunk index of 16-byte chunk c of row r in a tile of P chunks per row.
// For P a power of two the chunks of a row are permuted by the row's low
// bits (swz_bits), so that 8 consecutive rows at one chunk column (8 x 16
// bytes, an ldmatrix matrix or an accumulator store) cover all 32 banks;
// other P are stored unswizzled.  The bits depend on r & 7 only.
__host__ __device__ __forceinline__ int swz_bits(int r, int P) {
  if (P & (P - 1)) return 0;
  return P >= 8 ? (r & 7) : ((r * P) >> 3) & (P - 1);
}
__host__ __device__ __forceinline__ int swz(int r, int c, int P) {
  return r * P + (c ^ swz_bits(r, P));
}

// How a pass leaves shared memory: 16-byte pieces of 8 channels (Cout a
// multiple of 8), the 1x1x1 conv's tile as one contiguous run in 16-byte
// pieces, or single values.
enum StoreMode { kStoreVec = 0, kStoreRun = 1, kStoreScalar = 2 };

// Output rule of the 1x1x1 conv: voxel v writes voxel v.
struct PointOut {
  __device__ __forceinline__ int64_t base(int64_t v) const { return v; }
  __device__ __forceinline__ int64_t tap(int) const { return 0; }
};

// Output rule of the k2 s2 transposed conv: input voxel v = (b, d, h, w)
// has its taps' base at (b, 2d, 2h, 2w) of the doubled grid, and tap
// t = (a, p, q) lands a planes, p rows and q voxels further.
struct Upsample2xOut {
  int D, H, W;
  __device__ __forceinline__ int64_t base(int64_t v) const {
    const int iw = (int)(v % W);
    v /= W;
    const int ih = (int)(v % H);
    v /= H;
    const int id = (int)(v % D);
    const int64_t ib = v / D;
    return ((ib * 2 * D + 2 * id) * 2 * H + 2 * ih) * 2 * (int64_t)W +
           2 * iw;
  }
  __device__ __forceinline__ int64_t tap(int t) const {
    const int a = t >> 2, p = (t >> 1) & 1, q = t & 1;
    return ((int64_t)a * 2 * H + p) * 2 * W + q;
  }
};

// Write the staged tap pass (nv voxels x TP taps x cpt 16-byte chunks) to
// y, consecutive threads on consecutive chunks.
template <int TP, int PS>
__device__ __forceinline__ void copy_out_vec(const unsigned char* ss,
                                             bf16* y, const int64_t* obase,
                                             const int64_t (&off)[TP],
                                             int nv, int cpt, int NT,
                                             int Cout, int co0, int tid) {
  const int cpv = TP * cpt;
  for (int i = tid; i < nv * cpv; i += MX_THREADS) {
    const int v = i / cpv, r = i - v * cpv;
    const int t = r / cpt, c = r - t * cpt;
    const uint4 val =
        *reinterpret_cast<const uint4*>(ss + swz(v, t * NT + c, PS) * 16);
    *reinterpret_cast<uint4*>(y + (obase[v] + off[t]) * Cout + co0 + 8 * c) =
        val;
  }
}

// x: (nvox, Cin) bf16; wpk: (KP, TAPS * NP) bf16; y: the output voxels x
// Cout.  Block (bx, by): output channels by * 8 NT .. + 8 NT of every tap,
// tiles bx, bx + gridDim.x, ...
template <int TAPS, int NT, typename Out>
__global__ void __launch_bounds__(MX_THREADS)
channel_mix_mma_kernel(const bf16* __restrict__ x,
                       const bf16* __restrict__ wpk,
                       const float* __restrict__ bias, bf16* __restrict__ y,
                       int64_t nvox, int Cin, int KP, int Cout, int NP,
                       int vec_x, int store, Out out) {
  constexpr int TP = TAPS == 8 ? 2 : 1;  // taps of one epilogue pass
  constexpr int CB = 8 * NT;             // output channels of the block
  constexpr int PW = TAPS * NT;          // weight chunks per k row
  constexpr int PS = TP * NT;            // staged chunks per voxel
  const int PX = KP / 8;                 // input chunks per voxel
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* ws = smem;                   // KP x TAPS CB weights
  unsigned char* xs = ws + KP * PW * 16;      // 128 x KP input tile
  unsigned char* ss = xs + MX_VOX * PX * 16;  // 128 x TP * CB staged out
  int64_t* obase = reinterpret_cast<int64_t*>(ss + MX_VOX * PS * 16);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int co0 = blockIdx.y * CB;
  const int n_co = min(CB, Cout - co0);  // channels the block writes
  const int64_t n_tiles = (nvox + MX_VOX - 1) / MX_VOX;

  // the block's weights: rows k < KP, columns (tap, co0 .. co0 + CB)
  for (int i = tid; i < KP * PW; i += MX_THREADS) {
    const int k = i / PW, cc = i % PW;
    const int t = cc / NT, n = co0 + 8 * (cc % NT);
    const bool ok = n < NP;
    const bf16* src = ok ? wpk + ((int64_t)k * TAPS + t) * NP + n : wpk;
    cp_async16(smem_u32(ws + swz(k, cc, PW) * 16), src, ok);
  }
  auto fill_x = [&](int64_t tile) {
    const int64_t v0 = tile * MX_VOX;
    for (int i = tid; i < MX_VOX * PX; i += MX_THREADS) {
      const int v = i / PX, c = i % PX;
      const bool in = v0 + v < nvox && 8 * c < Cin;
      unsigned char* dst = xs + swz(v, c, PX) * 16;
      const bf16* src = in ? x + (v0 + v) * Cin + 8 * c : x;
      if (vec_x)
        cp_async16(smem_u32(dst), src, in);
      else
        *reinterpret_cast<uint4*>(dst) =
            load8_scalar(src, in ? min(8, Cin - 8 * c) : 0);
    }
  };
  int64_t tile = blockIdx.x;
  fill_x(tile);
  cp_async_commit();

  // the bias of the lane's accumulator columns 8 nt + 2 (lane & 3) + j
  float bv[NT][2];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int co = co0 + 8 * nt + 2 * (lane & 3) + j;
      bv[nt][j] = bias != nullptr && co < Cout ? bias[co] : 0.f;
    }

  const uint32_t ws_u = smem_u32(ws), xs_u = smem_u32(xs);
  // A (x4): the lane's voxel row of an m-tile and its k half; B
  // (x4.trans): lanes 8i..8i+7 give the k rows of matrix i, whose k half
  // is i & 1 and n tile (of a pair) i >> 1.  Every row a lane reads is its
  // first plus a multiple of 8, so its swizzle bits are fixed.
  const int a_row = warp * 32 + (lane & 15), a_hi = lane >> 4;
  const int b_row = ((lane >> 3) & 1) * 8 + (lane & 7);
  const int b_hi = NT == 1 ? 0 : lane >> 4;
  const int a_sw = swz_bits(a_row, PX), b_sw = swz_bits(b_row, PW);

  for (; tile < n_tiles; tile += gridDim.x) {
    const int64_t v0 = tile * MX_VOX;
    const int nv = nvox - v0 < MX_VOX ? (int)(nvox - v0) : MX_VOX;
    cp_async_wait<0>();
    __syncthreads();  // the tile (and the weights) are in; the previous
                      // tile's copy-out no longer reads obase
    if (tid < nv) obase[tid] = out.base(v0 + tid);

#pragma unroll 1
    for (int tp = 0; tp < TAPS / TP; ++tp) {
      float acc[2][TP][NT][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int t = 0; t < TP; ++t)
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int r = 0; r < 4; ++r) acc[mt][t][nt][r] = 0.f;

      for (int kc = 0; kc < KP / 16; ++kc) {
        uint32_t a[2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
          ldsm_x4(a[mt], xs_u + ((a_row + 16 * mt) * PX +
                                 ((2 * kc + a_hi) ^ a_sw)) * 16);
        const uint32_t brow_u = ws_u + (16 * kc + b_row) * PW * 16;
#pragma unroll
        for (int t = 0; t < TP; ++t) {
          const int col = (tp * TP + t) * NT;  // the tap's first chunk
          uint32_t b[NT][2];
          if constexpr (NT == 1) {
            ldsm_x2_t(b[0][0], b[0][1], brow_u + (col ^ b_sw) * 16);
          } else {
#pragma unroll
            for (int j = 0; j < NT / 2; ++j) {
              uint32_t r[4];
              ldsm_x4_t(r, brow_u + ((col + 2 * j + b_hi) ^ b_sw) * 16);
              b[2 * j][0] = r[0], b[2 * j][1] = r[1];
              b[2 * j + 1][0] = r[2], b[2 * j + 1][1] = r[3];
            }
          }
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int nt = 0; nt < NT; ++nt)
              mma_bf16(acc[mt][t][nt], a[mt], b[nt][0], b[nt][1]);
        }
      }
      // the previous pass's copy-out is done with the staging tile; after
      // the last pass every warp is done with the input tile
      __syncthreads();
      if (tp == TAPS / TP - 1) {
        if (tile + gridDim.x < n_tiles) fill_x(tile + gridDim.x);
        cp_async_commit();
      }
      // accumulator (mt, t, nt, r): voxel row (lane >> 2) (+ 8 for r >= 2)
      // of the m-tile, channel 8 nt + 2 (lane & 3) (+ 1 for odd r)
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int v = warp * 32 + mt * 16 + (lane >> 2) + 8 * half;
#pragma unroll
          for (int t = 0; t < TP; ++t)
#pragma unroll
            for (int nt = 0; nt < NT; ++nt) {
              const float v0f = acc[mt][t][nt][2 * half] + bv[nt][0];
              const float v1f = acc[mt][t][nt][2 * half + 1] + bv[nt][1];
              if (store == kStoreRun) {  // compact: value (v, c) at v Cout + c
                bf16* row = reinterpret_cast<bf16*>(ss) + v * Cout;
                const int c = 8 * nt + 2 * (lane & 3);
                if (c < Cout) row[c] = __float2bfloat16_rn(v0f);
                if (c + 1 < Cout) row[c + 1] = __float2bfloat16_rn(v1f);
              } else {
                *reinterpret_cast<__nv_bfloat162*>(
                    ss + swz(v, t * NT + nt, PS) * 16 + 4 * (lane & 3)) =
                    __floats2bfloat162_rn(v0f, v1f);
              }
            }
        }
      __syncthreads();
      int64_t off[TP];
#pragma unroll
      for (int t = 0; t < TP; ++t) off[t] = out.tap(tp * TP + t);
      if (store == kStoreVec) {
        if (n_co == CB)  // a whole block of channels: constant divisors
          copy_out_vec<TP, PS>(ss, y, obase, off, nv, NT, NT, Cout, co0, tid);
        else
          copy_out_vec<TP, PS>(ss, y, obase, off, nv, n_co / 8, NT, Cout,
                               co0, tid);
      } else if (store == kStoreRun) {
        // the tile's nv x Cout outputs from v0 Cout on, 16-byte aligned
        // (v0 Cout is a multiple of 128), a tail of single values
        const int n_el = nv * Cout, n_vec = n_el / 8;
        bf16* yt = y + v0 * Cout;
        for (int i = tid; i < n_vec; i += MX_THREADS)
          reinterpret_cast<uint4*>(yt)[i] =
              reinterpret_cast<const uint4*>(ss)[i];
        for (int i = 8 * n_vec + tid; i < n_el; i += MX_THREADS)
          yt[i] = reinterpret_cast<const bf16*>(ss)[i];
      } else {
        const int cpv = TP * n_co;
        for (int i = tid; i < nv * cpv; i += MX_THREADS) {
          const int v = i / cpv, r = i - v * cpv;
          const int t = r / n_co, c = r - t * n_co;
          y[(obase[v] + off[t]) * Cout + co0 + c] =
              *reinterpret_cast<const bf16*>(
                  ss + swz(v, t * NT + c / 8, PS) * 16 + (c % 8) * 2);
        }
      }
    }
  }
}

int round8(int n) { return (n + 7) / 8 * 8; }
int round16(int n) { return (n + 15) / 16 * 16; }

// Dynamic shared memory of a block: weights, input tile, staged output
// pass, the tile's output base addresses.
int mix_smem_bytes(int taps, int nt, int kp) {
  const int tp = taps == 8 ? 2 : 1;
  return kp * taps * nt * 16 + MX_VOX * kp * 2 + MX_VOX * tp * nt * 16 +
         MX_VOX * 8;
}

int device_attr(cudaDeviceAttr attr) {
  int dev = 0, v = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&v, attr, dev);
  return v;
}

// n-tiles per block: all of Cout's up to 64 channels, fewer where the
// block's shared memory would not fit; 0 if even 8 channels do not fit.
int mix_nt(int taps, int Cin, int Cout) {
  static const int smem_max =
      device_attr(cudaDevAttrMaxSharedMemoryPerBlockOptin);
  const int n8 = (Cout + 7) / 8;
  int nt = n8 <= 1 ? 1 : n8 <= 2 ? 2 : n8 <= 4 ? 4 : 8;
  while (nt > 1 && mix_smem_bytes(taps, nt, round16(Cin)) > smem_max) nt /= 2;
  return mix_smem_bytes(taps, nt, round16(Cin)) <= smem_max ? nt : 0;
}

template <int TAPS, int NT, typename Out>
int launch_mix(const void* x, const void* wpk, const void* bias, void* y,
               int64_t nvox, int Cin, int Cout, Out out, cudaStream_t s) {
  static const int n_sm = device_attr(cudaDevAttrMultiProcessorCount);
  static int smem_set = 48 * 1024;
  static int per_sm_of_kp[64] = {};  // resident blocks per SM by KP / 16
  auto kernel = channel_mix_mma_kernel<TAPS, NT, Out>;
  const int KP = round16(Cin), NP = round8(Cout);
  const int n_chunks = (NP + 8 * NT - 1) / (8 * NT);
  const int64_t n_tiles = (nvox + MX_VOX - 1) / MX_VOX;
  if (n_tiles == 0) return (int)cudaSuccess;
  const int smem = mix_smem_bytes(TAPS, NT, KP);
  if (smem > smem_set) {
    const cudaError_t rc = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (rc != cudaSuccess) return (int)rc;
    smem_set = smem;
  }
  int per_sm = KP / 16 < 64 ? per_sm_of_kp[KP / 16] : 0;
  if (per_sm == 0) {
    const cudaError_t rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel, MX_THREADS, smem);
    if (rc != cudaSuccess) return (int)rc;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    if (KP / 16 < 64) per_sm_of_kp[KP / 16] = per_sm;
  }
  int64_t gx = (int64_t)per_sm * n_sm / n_chunks;
  if (gx < 1) gx = 1;
  if (gx > n_tiles) gx = n_tiles;
  const bool x_al = reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const bool y_al = reinterpret_cast<uintptr_t>(y) % 16 == 0;
  const int vec_x = (Cin % 8) == 0 && x_al;
  const int store = (Cout % 8) == 0 && y_al ? kStoreVec
                    : TAPS == 1 && n_chunks == 1 && y_al ? kStoreRun
                                                          : kStoreScalar;
  dim3 grid((unsigned)gx, (unsigned)n_chunks);
  kernel<<<grid, MX_THREADS, smem, s>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(wpk),
      static_cast<const float*>(bias), static_cast<bf16*>(y), nvox, Cin, KP,
      Cout, NP, vec_x, store, out);
  return (int)cudaGetLastError();
}

template <int TAPS, typename Out>
int dispatch_mix(const void* x, const void* wpk, const void* bias, void* y,
                 int64_t nvox, int Cin, int Cout, Out out, cudaStream_t s) {
  if (Cin < 1 || Cout < 1) return (int)cudaErrorInvalidValue;
  switch (mix_nt(TAPS, Cin, Cout)) {
    case 1:
      return launch_mix<TAPS, 1>(x, wpk, bias, y, nvox, Cin, Cout, out, s);
    case 2:
      return launch_mix<TAPS, 2>(x, wpk, bias, y, nvox, Cin, Cout, out, s);
    case 4:
      return launch_mix<TAPS, 4>(x, wpk, bias, y, nvox, Cin, Cout, out, s);
    case 8:
      return launch_mix<TAPS, 8>(x, wpk, bias, y, nvox, Cin, Cout, out, s);
    default:
      return (int)cudaErrorInvalidValue;  // Cin too wide for shared memory
  }
}

}  // namespace

extern "C" {

// x (B, D, H, W, Cin) bf16 -> y (B, 2D, 2H, 2W, Cout) bf16; wpk the packed
// (round16(Cin), 8 * round8(Cout)) bf16 weights of w (2, 2, 2, Cin, Cout).
int deconv2x_mma(const void* x, const void* wpk, const void* bias, void* y,
                 int B, int D, int H, int W, int Cin, int Cout,
                 void* stream) {
  return dispatch_mix<8>(x, wpk, bias, y, (int64_t)B * D * H * W, Cin, Cout,
                         Upsample2xOut{D, H, W},
                         static_cast<cudaStream_t>(stream));
}

// x (nvox, Cin) bf16 -> y (nvox, Cout) bf16; wpk the packed
// (round16(Cin), round8(Cout)) bf16 weights of w (Cin, Cout).
int conv3d_point_mma(const void* x, const void* wpk, const void* bias,
                     void* y, long long nvox, int Cin, int Cout,
                     void* stream) {
  return dispatch_mix<1>(x, wpk, bias, y, (int64_t)nvox, Cin, Cout,
                         PointOut{}, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
