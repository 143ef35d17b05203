// Trilinear warp (grid_sample, align_corners=True, zero padding), its
// gradient with respect to the sample coordinates, and its adjoint in the
// values (the trilinear splat), on channel-last (B, D, H, W, C) tensors.
//
// Replaces the TPU kernels deepatlas_tpu/pallas/warp.py::_fwd_kernel,
// ::_bwd_grid_kernel and deepatlas_tpu/pallas/splat.py::_splat_kernel.  The
// TPU kernels stage a slab of source planes and rebuild the gather from
// 128-lane shifts and tent weights, which bounds the displacement they can
// resolve; a thread here gathers its 8 corners directly, so there is no
// displacement limit, no depth limit and no second path.
//
// All three are bound by bytes on an H100 (a few flops per byte moved): per
// output point they read 12 bytes of coordinates and, per channel, one
// value each of the volume and / or the upstream gradient, and write one
// value (or three coordinates' gradients): the warp 12 + 2 C elem bytes a
// point.  A point's coordinates, corner offsets and weights are computed
// once (trilinear.cuh) and reused for every channel, and neighbouring
// threads work on neighbouring points, so that on a smooth field their
// corner reads fall into the same cache lines of the 50 MB L2.
//
// The warp's layout follows the width of a point's channel row (C elem
// bytes):
//
//   * one to 32 whole 16-byte chunks, a power of two of them, in aligned
//     tensors (the anatomy's 32 channels): the channels are spread over
//     lanes.  The warp gives each lane a 16-byte chunk of one point's row
//     (8 bf16 or 4 float32 channels; 4 lanes a point at 32 bf16
//     channels), so a warp reads each corner as whole consecutive rows with
//     16-byte loads and writes its output rows the same way.  The lanes of
//     one point read the same 12 bytes of coordinates (one transaction) and
//     each computes the point's corners with the same float32 arithmetic.
//     Neighbouring points along W share 4 corners; the warp takes those
//     rows from the neighbour's lanes by shuffles, which halves the
//     gather's reads from L2;
//   * any other row (the registration step's one float32 channel, odd
//     widths): one thread per point, looping over the channels.
//
// The grid gradient (12 + 2 C elem + 12 bytes a point) takes the same
// layouts by row width, with 32-bit corner offsets where a sample's volume
// allows them and the sample from the grid's y index, not a 64-bit
// division:
//
//   * rows under 16 bytes (the registration step's one float32 channel):
//     one thread a point.  The kernel is bound by its instructions there:
//     with 64-bit offsets it took 0.111 ms at 1x168x200x168, with 32-bit
//     ones 0.080 (NVIDIA H100 80GB HBM3, 700.00 W,
//     tools/bench_warp_torch.py);
//   * 16-byte chunks a lane (the anatomy's 32 channels): E's layout
//     without its corner shuffles, each lane's partial sums over its chunk
//     added across the point's lanes by xor shuffles in a fixed order, so
//     the result repeats bit for bit;
//   * other widths: one thread a point with 64-bit offsets, as before.
//
// The splat is deterministic: it adds in 64-bit integer fixed point, whose
// addition is associative, so every output element is the same sum in
// whatever order the atomics land, bit for bit from run to run.  Three
// passes: a pre-pass takes each channel's max |ct| (atomicMax on the bit
// patterns of non-negative floats, which order as integers; the splat of
// ones, whose max the caller knows, skips it and reads no cotangent: the
// same scale, so the same bits as the general path on a tensor of ones);
// that fixes a
// power-of-two scale 2^e per channel with P max|ct| 2^e <= 2^62, P the
// points of one sample (each point adds weight <= 1 at most once to a
// voxel), so no sum can overflow; the scatter adds round(fl(w_k ct) 2^e)
// (__float2ll_rn; the scaling by 2^e is exact) with 64-bit atomics in L2;
// a last pass multiplies each sum, rounded once to float32, by 2^-e.  A
// channel whose max |ct| is not finite is NaN in the output.  What bounds
// it: the int64 buffer's bytes (zeroed, updated in L2, read back: 4.3 GB
// at 1x168x200x168x32) and the atomics' throughput in L2.  Where a row is
// 16 bytes or more, the scatter spreads a point's channels over lanes too
// (under that, one thread a point): a warp takes 32 points, each
// lane computes one point's corners, and the warp walks its points with
// the corners broadcast by shuffles, lane c adding channel c, so that one
// atomic instruction covers one corner's consecutive 64-bit sums (2 cache
// lines at 32 channels).  Neighbouring points along W add their 4 shared
// corners in registers first (integer sums: the same bits), which halves
// the atomics.  A cotangent that is exactly 0 adds nothing, and a warp
// whose cotangents are mostly 0 (the f-hard branch's one-hot) takes them
// by channel, up to 32 points an atomic instruction.
#include <algorithm>

#include "trilinear.cuh"

namespace da {

constexpr unsigned kFullMask = 0xffffffffu;
// the bit pattern of +inf: a |ct| max at or above it is not finite
constexpr unsigned kInfBits = 0x7f800000u;

// A 16-byte chunk of channels: 8 bf16 or 4 float32.
template <typename T>
struct Chunk {
  static constexpr int kN = 16 / sizeof(T);
};

// The channels of a 16-byte chunk, in float32.
template <typename T>
__device__ __forceinline__ void unpack_chunk(const uint4& u, float* v);
template <>
__device__ __forceinline__ void unpack_chunk<float>(const uint4& u,
                                                   float* v) {
  v[0] = __uint_as_float(u.x);
  v[1] = __uint_as_float(u.y);
  v[2] = __uint_as_float(u.z);
  v[3] = __uint_as_float(u.w);
}
template <>
__device__ __forceinline__ void unpack_chunk<__nv_bfloat16>(const uint4& u,
                                                           float* v) {
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    // bf16 is the upper half of a float32: exact
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

template <typename T>
__device__ __forceinline__ void load_chunk(const T* p, float* v) {
  unpack_chunk<T>(__ldg(reinterpret_cast<const uint4*>(p)), v);
}

__device__ __forceinline__ void store_chunk(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store_chunk(__nv_bfloat16* p, const float* v) {
  store8(p, v);
}

// out[p, c] = sum_k w_k vol[corner_k, c]: one thread per point.
template <typename T>
__global__ void __launch_bounds__(kThreads)
warp_fwd_kernel(const T* __restrict__ vol, const float* __restrict__ grid,
                T* __restrict__ out, Dims s) {
  const long long p =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (p >= s.total) return;
  const float* g = grid + 3 * p;
  const Axis ax = axis_of(g[0], s.sx, s.w);
  const Axis ay = axis_of(g[1], s.sy, s.h);
  const Axis az = axis_of(g[2], s.sz, s.d);
  const Corners q = corners_of(az, ay, ax, s);
  const T* vb = vol + (p / s.points) * s.d * s.h * s.w * s.c;
  T* o = out + p * s.c;
  for (int ch = 0; ch < s.c; ++ch) {
    float acc = 0.0f;
#pragma unroll
    for (int k = 0; k < 8; ++k)
      if (q.inb[k]) acc += q.wgt[k] * to_float(vb[q.off[k] + ch]);
    o[ch] = from_float<T>(acc);
  }
}

// The same sums where each lane holds one 16-byte chunk of a row (C is
// lanes * V, lanes a power of two up to 32, the tensors 16-byte aligned):
// the warp holds 32 / lanes consecutive points.  Neighbouring points along
// W share corners: where a point's corner 0 lies one voxel after the
// previous point's (off0 = prev + C), the previous point's dx = 1 corners
// (k = 1, 3, 5, 7) are this point's dx = 0 corners (k = 0, 2, 4, 6) at the
// same addresses, so their chunks come from the lane `lanes` below by
// shuffles instead of from L2, which halves the gather's L2 traffic on a
// smooth field.  A chunk is taken so only where both points have that
// corner inside the volume; the sums are the same as warp_fwd_kernel's.
template <typename T>
__global__ void __launch_bounds__(kThreads)
warp_fwd_rows_kernel(const T* __restrict__ vol,
                     const float* __restrict__ grid, T* __restrict__ out,
                     Dims s, int lanes) {
  constexpr int V = Chunk<T>::kN;
  const int lane = threadIdx.x & 31;
  const int per_block = kThreads / lanes;
  const long long p =
      static_cast<long long>(blockIdx.x) * per_block + threadIdx.x / lanes;
  // whole warps only: the shuffles need every lane
  if (p - lane / lanes >= s.total) return;
  const bool valid = p < s.total;
  const int c0 = (threadIdx.x & (lanes - 1)) * V;
  Axis ax{}, ay{}, az{};
  Corners q{};
  long long base = 0;
  unsigned mask = 0;
  if (valid) {
    const float* g = grid + 3 * p;
    ax = axis_of(g[0], s.sx, s.w);
    ay = axis_of(g[1], s.sy, s.h);
    az = axis_of(g[2], s.sz, s.d);
    q = corners_of(az, ay, ax, s);
    base = (p / s.points) * s.d * s.h * s.w * s.c;
#pragma unroll
    for (int k = 0; k < 8; ++k) mask |= q.inb[k] ? (1u << k) : 0u;
  }
  const long long off0 = base + q.off[0];
  const long long prev_off0 = __shfl_up_sync(kFullMask, off0, lanes);
  const unsigned prev_mask = __shfl_up_sync(kFullMask, mask, lanes);
  const bool from_prev = lane >= lanes && prev_off0 + s.c == off0;
  const T* vb = vol + base + c0;
  uint4 raw[8];
#pragma unroll
  for (int k = 1; k < 8; k += 2)
    raw[k] = ((mask >> k) & 1u)
                 ? __ldg(reinterpret_cast<const uint4*>(vb + q.off[k]))
                 : make_uint4(0, 0, 0, 0);
#pragma unroll
  for (int k = 0; k < 8; k += 2) {
    uint4 left;
    left.x = __shfl_up_sync(kFullMask, raw[k + 1].x, lanes);
    left.y = __shfl_up_sync(kFullMask, raw[k + 1].y, lanes);
    left.z = __shfl_up_sync(kFullMask, raw[k + 1].z, lanes);
    left.w = __shfl_up_sync(kFullMask, raw[k + 1].w, lanes);
    if (!((mask >> k) & 1u))
      raw[k] = make_uint4(0, 0, 0, 0);
    else if (from_prev && ((prev_mask >> (k + 1)) & 1u))
      raw[k] = left;
    else
      raw[k] = __ldg(reinterpret_cast<const uint4*>(vb + q.off[k]));
  }
  if (!valid) return;
  float acc[V];
#pragma unroll
  for (int i = 0; i < V; ++i) acc[i] = 0.0f;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    if (!q.inb[k]) continue;
    float v[V];
    unpack_chunk<T>(raw[k], v);
#pragma unroll
    for (int i = 0; i < V; ++i) acc[i] += q.wgt[k] * v[i];
  }
  store_chunk(out + p * s.c + c0, acc);
}

// dgrid[p, a] = scale_a * sum_c ct[p, c] * d out[p, c] / d coordinate_a,
// a in (x, y, z).  The derivative of the weights at fixed corners (the
// floor rule): an out-of-bounds corner contributes nothing.
template <typename T>
__global__ void __launch_bounds__(kThreads)
warp_grid_grad_kernel(const T* __restrict__ vol,
                      const float* __restrict__ grid,
                      const T* __restrict__ ct, float* __restrict__ dgrid,
                      Dims s) {
  const long long p =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (p >= s.total) return;
  const float* g = grid + 3 * p;
  const Axis ax = axis_of(g[0], s.sx, s.w);
  const Axis ay = axis_of(g[1], s.sy, s.h);
  const Axis az = axis_of(g[2], s.sz, s.d);
  const Corners q = corners_of(az, ay, ax, s);
  const T* vb = vol + (p / s.points) * s.d * s.h * s.w * s.c;
  const T* c = ct + p * s.c;
  float gx = 0.0f, gy = 0.0f, gz = 0.0f;
  for (int ch = 0; ch < s.c; ++ch) {
    float v[8];
#pragma unroll
    for (int k = 0; k < 8; ++k)
      v[k] = q.inb[k] ? to_float(vb[q.off[k] + ch]) : 0.0f;
    float dx, dy, dz;
    corner_derivatives(az, ay, ax, v, dx, dy, dz);
    const float cv = to_float(c[ch]);
    gx += cv * dx;
    gy += cv * dy;
    gz += cv * dz;
  }
  float* o = dgrid + 3 * p;
  o[0] = gx * s.sx;
  o[1] = gy * s.sy;
  o[2] = gz * s.sz;
}

// The grid gradient's sample point in 32-bit element offsets (a sample's
// volume holds fewer than 2^31 elements: the dispatch checks): the axes,
// corner 0's offset and the in-bounds mask (bit k for corner k).  Corner k
// is corner 0 plus delta[k] (corner_deltas32).
__device__ __forceinline__ void point32(const float* __restrict__ g,
                                        const Dims& s, Axis& ax, Axis& ay,
                                        Axis& az, int& off0,
                                        unsigned& mask) {
  ax = axis_of(g[0], s.sx, s.w);
  ay = axis_of(g[1], s.sy, s.h);
  az = axis_of(g[2], s.sz, s.d);
  off0 = ((az.i0 * s.h + ay.i0) * s.w + ax.i0) * s.c;
  const unsigned mx = ax.in0 | (ax.in1 << 1), my = ay.in0 | (ay.in1 << 1),
                 mz = az.in0 | (az.in1 << 1);
  mask = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k)
    mask |= ((mx >> (k & 1)) & (my >> ((k >> 1) & 1)) & (mz >> (k >> 2)) &
             1u) << k;
}

__device__ __forceinline__ void corner_deltas32(const Dims& s, int* delta) {
  const int wc = s.w * s.c, hwc = wc * s.h;
#pragma unroll
  for (int k = 0; k < 8; ++k)
    delta[k] = (k >> 2) * hwc + ((k >> 1) & 1) * wc + (k & 1) * s.c;
}

// The grid gradient where a point's row is under 16 bytes (the
// registration step's one float32 channel): one thread a point, the sample
// from the grid's y index (no 64-bit division) and 32-bit corner offsets.
// The sums are warp_grid_grad_kernel's, in its order.  (Staging the
// 12-byte coordinate records through shared memory as 16-byte words, four
// points a thread, and taking the W neighbour's corners by shuffles were
// each slower here, 0.119-0.128 against 0.111 ms with 64-bit offsets on
// the same card and tool: the kernel is bound by its instructions, and
// the corner reads hit L1.)
template <typename T>
__global__ void __launch_bounds__(kThreads)
grid_grad_points_kernel(const T* __restrict__ vol,
                        const float* __restrict__ grid,
                        const T* __restrict__ ct, float* __restrict__ dgrid,
                        Dims s) {
  const long long i =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= s.points) return;
  const long long p = static_cast<long long>(blockIdx.y) * s.points + i;
  const T* vb = vol + static_cast<long long>(blockIdx.y) * s.d * s.h * s.w *
                          s.c;
  Axis ax, ay, az;
  int off0, delta[8];
  unsigned mask;
  point32(grid + 3 * p, s, ax, ay, az, off0, mask);
  corner_deltas32(s, delta);
  const T* cp = ct + p * s.c;
  float gx = 0.0f, gy = 0.0f, gz = 0.0f;
  for (int ch = 0; ch < s.c; ++ch) {
    float v[8];
#pragma unroll
    for (int k = 0; k < 8; ++k)
      v[k] = (mask >> k) & 1u ? to_float(vb[off0 + delta[k] + ch]) : 0.0f;
    float dx, dy, dz;
    corner_derivatives(az, ay, ax, v, dx, dy, dz);
    const float cv = to_float(cp[ch]);
    gx += cv * dx;
    gy += cv * dy;
    gz += cv * dz;
  }
  float* o = dgrid + 3 * p;
  o[0] = gx * s.sx;
  o[1] = gy * s.sy;
  o[2] = gz * s.sz;
}

// The grid gradient where a row is lanes 16-byte chunks (lanes a power of
// two up to 32, the tensors 16-byte aligned; the anatomy's 32 channels):
// E's layout.  Each lane holds one chunk of a point's row, the warp 32 /
// lanes consecutive points of one sample (blockIdx.y); the lanes of a
// point compute its corners alike and read their 8 corner chunks with
// 16-byte loads (taking the W neighbour's 4 shared chunks by shuffles, as
// E does, was slower here: 0.659 against 0.620 ms at 32 bf16 channels,
// NVIDIA H100 80GB HBM3, 700.00 W, tools/bench_warp_torch.py); each lane
// sums ct * d out / d coordinate over its chunk's
// channels in channel order, and the point's lanes add their three partial
// sums by xor shuffles, halving the distance each time: a fixed order, so
// the result repeats bit for bit, and every lane of the point ends with
// the same sums.  The point's first lane writes them.
template <typename T>
__global__ void __launch_bounds__(kThreads)
grid_grad_rows_kernel(const T* __restrict__ vol,
                      const float* __restrict__ grid,
                      const T* __restrict__ ct, float* __restrict__ dgrid,
                      Dims s, int lanes) {
  constexpr int V = Chunk<T>::kN;
  const int lane = threadIdx.x & 31;
  const int per_block = kThreads / lanes;
  const long long i =
      static_cast<long long>(blockIdx.x) * per_block + threadIdx.x / lanes;
  // whole warps only: the shuffles need every lane
  if (i - lane / lanes >= s.points) return;
  const bool valid = i < s.points;
  const long long p = static_cast<long long>(blockIdx.y) * s.points + i;
  const int c0 = (threadIdx.x & (lanes - 1)) * V;
  Axis ax{}, ay{}, az{};
  int off0 = 0, delta[8];
  unsigned mask = 0;
  if (valid) point32(grid + 3 * p, s, ax, ay, az, off0, mask);
  corner_deltas32(s, delta);
  const T* vb = vol + static_cast<long long>(blockIdx.y) * s.d * s.h * s.w *
                          s.c + off0 + c0;
  uint4 raw[8];
#pragma unroll
  for (int k = 0; k < 8; ++k)
    raw[k] = (mask >> k) & 1u
                 ? __ldg(reinterpret_cast<const uint4*>(vb + delta[k]))
                 : make_uint4(0, 0, 0, 0);
  float cv[V];
  if (valid)
    load_chunk(ct + p * s.c + c0, cv);
  else
#pragma unroll
    for (int c = 0; c < V; ++c) cv[c] = 0.0f;
  float vals[8][V];
#pragma unroll
  for (int k = 0; k < 8; ++k) unpack_chunk<T>(raw[k], vals[k]);
  float gx = 0.0f, gy = 0.0f, gz = 0.0f;
#pragma unroll
  for (int c = 0; c < V; ++c) {
    float v[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) v[k] = vals[k][c];
    float dx, dy, dz;
    corner_derivatives(az, ay, ax, v, dx, dy, dz);
    gx += cv[c] * dx;
    gy += cv[c] * dy;
    gz += cv[c] * dz;
  }
  for (int o = lanes / 2; o >= 1; o >>= 1) {
    gx += __shfl_xor_sync(kFullMask, gx, o);
    gy += __shfl_xor_sync(kFullMask, gy, o);
    gz += __shfl_xor_sync(kFullMask, gz, o);
  }
  if (valid && c0 == 0) {
    float* o = dgrid + 3 * p;
    o[0] = gx * s.sx;
    o[1] = gy * s.sy;
    o[2] = gz * s.sz;
  }
}

// ------------------------------------------------------------ the splat

// The exponent e of a channel's fixed-point scale 2^e, from the bits of its
// max |ct| (finite) and log2_points = ceil(log2 P): the max is below
// 2^ex with ex = max(biased exponent, 1) - 126, so every term is at most
// 2^(ex + e) = 2^(62 - log2_points) and a sum of P of them at most 2^62.
// Capped at 126, where 2^e and 2^-e are both normal floats.
__device__ __forceinline__ int fixed_exponent(unsigned maxbits,
                                              int log2_points) {
  const int ex = max(static_cast<int>(maxbits >> 23), 1) - 126;
  return min(62 - log2_points - ex, 126);
}

__device__ __forceinline__ float pow2f(int e) {  // -126 <= e <= 127
  return __int_as_float((e + 127) << 23);
}

// maxbits[c] = max over points of the bits of |ct[p, c]| (zero on entry).
// Thread t reads the V-element chunks t, t + T, t + 2T, ... (T threads;
// 16-byte loads where ct is aligned and n a multiple of V); T V is a
// multiple of C, so slot j of every chunk a thread reads lies in channel
// (t V + j) % C.  Lanes whose slots hold the same channels (C divides the
// distance between them times V) reduce by shuffles before the atomicMax.
template <typename T>
__global__ void __launch_bounds__(kThreads)
splat_absmax_kernel(const T* __restrict__ ct, long long n, int c, bool vec,
                    unsigned* __restrict__ maxbits) {
  constexpr int V = Chunk<T>::kN;
  const long long t =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  unsigned m[V];
#pragma unroll
  for (int j = 0; j < V; ++j) m[j] = 0;
  // four chunks a trip, their loads in flight together
  for (long long i0 = t; i0 * V < n; i0 += 4 * stride) {
    float v[4][V];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const long long i = i0 + u * stride;
      if (vec && i * V < n) {
        load_chunk(ct + i * V, v[u]);
      } else {
#pragma unroll
        for (int j = 0; j < V; ++j)
          v[u][j] = i * V + j < n ? to_float(ct[i * V + j]) : 0.0f;
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int j = 0; j < V; ++j)
        m[j] = max(m[j], __float_as_uint(fabsf(v[u][j])));
  }
  int shared = 0;  // the lane bits over which lanes hold the same channels
#pragma unroll
  for (int o = 16; o >= 1; o >>= 1)
    if ((o * V) % c == 0) {
#pragma unroll
      for (int j = 0; j < V; ++j)
        m[j] = max(m[j], __shfl_xor_sync(kFullMask, m[j], o));
      shared |= o;
    }
  if ((threadIdx.x & shared) != 0) return;
  const int ch0 = static_cast<int>((t * V) % c);
  if (V % c == 0) {  // c a power of two: slot j is channel j % c
#pragma unroll
    for (int o = V / 2; o >= 1; o >>= 1)
      if (o >= c) {
#pragma unroll
        for (int j = 0; j < o; ++j) m[j] = max(m[j], m[j + o]);
      }
  }
#pragma unroll
  for (int j = 0; j < V; ++j)
    if (m[j] != 0 && (V % c != 0 || j < c))
      atomicMax(maxbits + (ch0 + j) % c, m[j]);
}

// Offsets of corner k from corner 0, in elements of a (D, H, W, C) volume.
__device__ __forceinline__ void corner_deltas(const Dims& s, long long* delta) {
  const long long wc = static_cast<long long>(s.w) * s.c;
  const long long hwc = wc * s.h;
#pragma unroll
  for (int k = 0; k < 8; ++k)
    delta[k] = (k >> 2) * hwc + ((k >> 1) & 1) * wc + (k & 1) * s.c;
}

// The point's corner 0 offset in the batch of volumes, its in-bounds mask
// (bit k for corner k) and its weights.
__device__ __forceinline__ void point_corners(const float* __restrict__ grid,
                                              long long p, const Dims& s,
                                              long long& off0, unsigned& mask,
                                              float* wgt) {
  const float* g = grid + 3 * p;
  const Axis ax = axis_of(g[0], s.sx, s.w);
  const Axis ay = axis_of(g[1], s.sy, s.h);
  const Axis az = axis_of(g[2], s.sz, s.d);
  const Corners q = corners_of(az, ay, ax, s);
  off0 = (p / s.points) * s.d * s.h * s.w * s.c + q.off[0];
  mask = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    mask |= q.inb[k] ? (1u << k) : 0u;
    wgt[k] = q.wgt[k];
  }
}

// One point's fixed-point terms round(fl(w_k * cv) * 2^e), 0 for a corner
// outside the volume.
__device__ __forceinline__ void point_terms(unsigned mask, const float* wgt,
                                            float cv, float scale,
                                            long long* t) {
#pragma unroll
  for (int k = 0; k < 8; ++k)
    t[k] = ((mask >> k) & 1u) ? __float2ll_rn((wgt[k] * cv) * scale) : 0;
}

__device__ __forceinline__ void add_term(unsigned long long* acc,
                                         long long off, long long t) {
  if (t != 0) atomicAdd(acc + off, static_cast<unsigned long long>(t));
}

// Neighbouring points along W share corners: where a point's corner 0 lies
// one voxel after the previous point's (off0 = prev + C), the previous
// point's dx = 1 corners (k = 1, 3, 5, 7) are this point's dx = 0 corners
// (k = 0, 2, 4, 6), at the same addresses.  Their terms are then added in
// registers and reach memory in one atomic.  Integer sums do not depend on
// the grouping, so the result is the same bits as one atomic a term; the
// test is on addresses alone, so a corner outside the volume (term 0) and a
// row or batch break are handled by the same rule.

// The most nonzero cotangents of a warp's points the splat takes as sparse.
constexpr int kSparse = 2 * 32;

// A point that does not exist: its corner 0 offset matches no neighbour's.
constexpr long long kNoPoint = -(1LL << 62);


// The scatter with one thread per point (a row under 16 bytes): each lane
// takes its left neighbour's dx = 1 terms by a shuffle.  The cotangents are
// loaded first, so that their loads overlap the grid's.
template <typename T>
__global__ void __launch_bounds__(kThreads)
splat_points_kernel(const T* __restrict__ ct, const float* __restrict__ grid,
                    unsigned long long* __restrict__ acc,
                    const unsigned* __restrict__ maxbits, Dims s,
                    int log2_points) {
  const int lane = threadIdx.x & 31;
  const long long p =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (p - lane >= s.total) return;
  const bool valid = p < s.total;
  float cvs[8];
#pragma unroll
  for (int ch = 0; ch < 8; ++ch)
    cvs[ch] = valid && ch < s.c
                  ? (ct == nullptr ? 1.0f : to_float(ct[p * s.c + ch]))
                  : 0.0f;
  long long off0 = kNoPoint, delta[8];
  unsigned mask = 0;
  float wgt[8];
  if (valid) point_corners(grid, p, s, off0, mask, wgt);
  corner_deltas(s, delta);
  const long long prev_off0 = __shfl_up_sync(kFullMask, off0, 1);
  const long long next_off0 = __shfl_down_sync(kFullMask, off0, 1);
  const bool from_prev = lane > 0 && prev_off0 + s.c == off0;
  const bool to_next = valid && lane < 31 && off0 + s.c == next_off0;
#pragma unroll
  for (int ch = 0; ch < 8; ++ch) {
    if (ch >= s.c) break;
    const unsigned mb = maxbits[ch];
    const float cv = cvs[ch];
    long long t[8];
    if (cv == 0.0f || mb >= kInfBits) {
#pragma unroll
      for (int k = 0; k < 8; ++k) t[k] = 0;
    } else {
      point_terms(mask, wgt, cv, pow2f(fixed_exponent(mb, log2_points)), t);
    }
#pragma unroll
    for (int k = 0; k < 8; k += 2) {
      const long long left = __shfl_up_sync(kFullMask, t[k + 1], 1);
      if (from_prev) t[k] += left;
      if (to_next) t[k + 1] = 0;
    }
    if (valid) {
#pragma unroll
      for (int k = 0; k < 8; ++k) add_term(acc, off0 + ch + delta[k], t[k]);
    }
  }
}

// The scatter with a point's channels spread over the lanes (a row of 16
// bytes and more): each lane computes the corners of one of the warp's 32
// points; then, for each group of 32 channels, the warp walks its 32
// points, with each point's corner 0 offset, mask and weights broadcast by
// shuffles, lane l adding channel l of the group (lanes past C add
// nothing), and carries a point's dx = 1 terms in registers to the next
// point.  Each lane loads the cotangents of all the points into shared
// memory before the walk, so that their loads are in flight together.
// Where at most kSparse of the warp's cotangents are not 0 (a one-hot has
// 32), the warp takes them by channel instead, one point a lane, so that
// an atomic instruction carries a channel's nonzero terms of up to 32
// points and not one.
template <typename T>
__global__ void __launch_bounds__(kThreads)
splat_lanes_kernel(const T* __restrict__ ct, const float* __restrict__ grid,
                   unsigned long long* __restrict__ acc,
                   const unsigned* __restrict__ maxbits, Dims s,
                   int log2_points) {
  const int lane = threadIdx.x & 31;
  const long long first =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) - lane;
  if (first >= s.total) return;  // whole warps only: the shuffles need all
  long long off0 = kNoPoint, delta[8];
  unsigned mask = 0;
  float wgt[8];
  if (first + lane < s.total)
    point_corners(grid, first + lane, s, off0, mask, wgt);
  corner_deltas(s, delta);
  // each lane's cotangents of the warp's 32 points (one lane's own row, so
  // only that lane reads and writes it)
  __shared__ float s_cv[kThreads / 32][32][33];
  for (int c0 = 0; c0 < s.c; c0 += 32) {
    const int ch = c0 + lane;
    const unsigned mb = ch < s.c ? maxbits[ch] : kInfBits;
    const bool live = mb < kInfBits;
    const float scale = live ? pow2f(fixed_exponent(mb, log2_points)) : 0.0f;
    float(*rows)[33] = s_cv[threadIdx.x >> 5];
    float* cvs = rows[lane];
    unsigned nonzero = 0;  // bit step: this lane's cotangent there is not 0
#pragma unroll
    for (int step = 0; step < 32; ++step) {
      const long long pj = first + step;
      cvs[step] = live && pj < s.total ? to_float(ct[pj * s.c + ch]) : 0.0f;
      nonzero |= cvs[step] != 0.0f ? (1u << step) : 0u;
    }
    if (__reduce_add_sync(kFullMask, __popc(nonzero)) <= kSparse) {
      // sparse (a one-hot): for each source lane (channel) in turn, lane i
      // takes its i-th nonzero point, all 8 corners
      __syncwarp();
      for (int src = 0; src < 32; ++src) {
        const unsigned bits = __shfl_sync(kFullMask, nonzero, src);
        if (bits == 0) continue;
        const int step =
            lane < __popc(bits) ? static_cast<int>(__fns(bits, 0, lane + 1))
                                : -1;
        const int j = step < 0 ? lane : step;
        const long long pj_off0 = __shfl_sync(kFullMask, off0, j);
        const unsigned pj_mask = __shfl_sync(kFullMask, mask, j);
        float pj_wgt[8];
#pragma unroll
        for (int k = 0; k < 8; ++k)
          pj_wgt[k] = __shfl_sync(kFullMask, wgt[k], j);
        const int src_ch = __shfl_sync(kFullMask, ch, src);
        const float src_scale = __shfl_sync(kFullMask, scale, src);
        if (step < 0) continue;
        long long t[8];
        point_terms(pj_mask, pj_wgt, rows[src][step], src_scale, t);
#pragma unroll
        for (int k = 0; k < 8; ++k)
          add_term(acc, pj_off0 + src_ch + delta[k], t[k]);
      }
      __syncwarp();
      continue;
    }
    long long carry[4] = {0, 0, 0, 0};
    long long carry_off = kNoPoint;
    for (int step = 0; step < 32; ++step) {
      const long long pj_off0 = __shfl_sync(kFullMask, off0, step);
      const unsigned pj_mask = __shfl_sync(kFullMask, mask, step);
      float pj_wgt[8];
#pragma unroll
      for (int k = 0; k < 8; ++k)
        pj_wgt[k] = __shfl_sync(kFullMask, wgt[k], step);
      long long t[8];
      if (cvs[step] == 0.0f) {
#pragma unroll
        for (int k = 0; k < 8; ++k) t[k] = 0;
      } else {
        point_terms(pj_mask, pj_wgt, cvs[step], scale, t);
      }
      if (carry_off + s.c == pj_off0) {
#pragma unroll
        for (int k = 0; k < 4; ++k) t[2 * k] += carry[k];
      } else {
#pragma unroll
        for (int k = 0; k < 4; ++k)
          add_term(acc, carry_off + ch + delta[2 * k + 1], carry[k]);
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        add_term(acc, pj_off0 + ch + delta[2 * k], t[2 * k]);
        carry[k] = t[2 * k + 1];
      }
      carry_off = pj_off0;
    }
#pragma unroll
    for (int k = 0; k < 4; ++k)
      add_term(acc, carry_off + ch + delta[2 * k + 1], carry[k]);
  }
}

// dvol[i] = float32(acc[i]) * 2^-e of i's channel (NaN where the channel's
// max |ct| is not finite): 4 elements a thread where n is a multiple of 4.
__global__ void __launch_bounds__(kThreads)
splat_convert_kernel(const long long* __restrict__ acc,
                     const unsigned* __restrict__ maxbits,
                     float* __restrict__ dvol, long long n, int c,
                     int log2_points) {
  const long long i0 =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) * 4;
  if (i0 >= n) return;
  const bool vec = n % 4 == 0;  // then acc + i0 and dvol + i0 are aligned
  long long a[4];
  if (vec) {
    const longlong2 lo = *reinterpret_cast<const longlong2*>(acc + i0);
    const longlong2 hi = *reinterpret_cast<const longlong2*>(acc + i0 + 2);
    a[0] = lo.x;
    a[1] = lo.y;
    a[2] = hi.x;
    a[3] = hi.y;
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) a[j] = i0 + j < n ? acc[i0 + j] : 0;
  }
  int ch = static_cast<int>(i0 % c);
  float v[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const unsigned mb = maxbits[ch];
    v[j] = mb >= kInfBits ? __int_as_float(0x7fc00000)
                          : __ll2float_rn(a[j]) *
                                pow2f(-fixed_exponent(mb, log2_points));
    if (++ch == c) ch = 0;
  }
  if (vec) {
    *reinterpret_cast<float4*>(dvol + i0) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (i0 + j < n) dvol[i0 + j] = v[j];
  }
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

template <typename T>
int warp_fwd(const T* vol, const float* grid, T* out, const Dims& s,
             cudaStream_t stream) {
  constexpr int V = Chunk<T>::kN;
  const int lanes = s.c / V;
  if (s.c % V == 0 && lanes > 0 && lanes <= 32 &&
      (lanes & (lanes - 1)) == 0 && aligned16(vol) && aligned16(out)) {
    const int per_block = kThreads / lanes;
    const unsigned blocks =
        static_cast<unsigned>((s.total + per_block - 1) / per_block);
    warp_fwd_rows_kernel<T><<<blocks, kThreads, 0, stream>>>(vol, grid, out,
                                                             s, lanes);
  } else {
    warp_fwd_kernel<T><<<blocks_for(s), kThreads, 0, stream>>>(vol, grid,
                                                               out, s);
  }
  return static_cast<int>(cudaGetLastError());
}

// The grid gradient's layout by row width, as the warp's: rows under 16
// bytes one thread a point, 16-byte chunks a lane each, other widths one
// thread a point with the channels in a loop.
template <typename T>
int grid_grad(const T* vol, const float* grid, const T* ct, float* dgrid,
              const Dims& s, int b, cudaStream_t stream) {
  constexpr int V = Chunk<T>::kN;
  const int lanes = s.c / V;
  // 32-bit corner offsets: a sample's volume under 2^31 elements, with a
  // margin for the corners of points just outside it
  const bool small =
      static_cast<long long>(s.d + 2) * (s.h + 2) * (s.w + 2) * s.c <
      (1LL << 31);
  if (small && s.c * static_cast<int>(sizeof(T)) < 16) {
    const dim3 blocks(
        static_cast<unsigned>((s.points + kThreads - 1) / kThreads), b);
    grid_grad_points_kernel<T><<<blocks, kThreads, 0, stream>>>(
        vol, grid, ct, dgrid, s);
  } else if (small && s.c % V == 0 && lanes <= 32 &&
             (lanes & (lanes - 1)) == 0 && aligned16(vol) && aligned16(ct)) {
    const int per_block = kThreads / lanes;
    const dim3 blocks(
        static_cast<unsigned>((s.points + per_block - 1) / per_block), b);
    grid_grad_rows_kernel<T><<<blocks, kThreads, 0, stream>>>(
        vol, grid, ct, dgrid, s, lanes);
  } else {
    warp_grid_grad_kernel<T><<<blocks_for(s), kThreads, 0, stream>>>(
        vol, grid, ct, dgrid, s);
  }
  return static_cast<int>(cudaGetLastError());
}

inline int gcd(int a, int b) { return b == 0 ? a : gcd(b, a % b); }

template <typename T>
int splat(const T* ct, const float* grid, float* dvol,
          unsigned long long* acc, unsigned* maxbits, const Dims& s, int b,
          cudaStream_t stream) {
  int log2_points = 0;
  while ((1LL << log2_points) < s.points) ++log2_points;
  const long long n_ct = s.total * s.c;
  // ct null: one channel of ones, whose max (1.0f) the caller put in
  // maxbits; no pre-pass and no cotangent to read
  const bool ones = ct == nullptr;
  if (ones && s.c != 1) return static_cast<int>(cudaErrorInvalidValue);
  if (n_ct > 0) {
    // a thread count whose chunks of V are a multiple of C, at most 4
    // blocks an SM
    constexpr int V = Chunk<T>::kN;
    const int unit = s.c / gcd(s.c, kThreads * V);
    long long blocks = std::min(
        (n_ct + static_cast<long long>(kThreads) * V - 1) / (kThreads * V),
        528LL);
    blocks = (blocks + unit - 1) / unit * unit;
    if (!ones)
      splat_absmax_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0,
                               stream>>>(ct, n_ct, s.c,
                                         n_ct % V == 0 && aligned16(ct),
                                         maxbits);
    if (s.c * static_cast<int>(sizeof(T)) < 16) {
      splat_points_kernel<T><<<blocks_for(s), kThreads, 0, stream>>>(
          ct, grid, acc, maxbits, s, log2_points);
    } else {
      splat_lanes_kernel<T><<<blocks_for(s), kThreads, 0, stream>>>(
          ct, grid, acc, maxbits, s, log2_points);
    }
  }
  const long long n_vol =
      static_cast<long long>(b) * s.d * s.h * s.w * s.c;
  if (n_vol > 0) {
    const long long threads = (n_vol + 3) / 4;
    splat_convert_kernel<<<static_cast<unsigned>(
                               (threads + kThreads - 1) / kThreads),
                           kThreads, 0, stream>>>(
        reinterpret_cast<const long long*>(acc), maxbits, dvol, n_vol, s.c,
        log2_points);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace da

// C entry points.  Pointers are device pointers of contiguous tensors:
// vol / out / ct / dvol (B, D, H, W, C) resp. (B, Do, Ho, Wo, C), grid and
// dgrid (B, Do, Ho, Wo, 3) float32; the splat's scratch: acc (B, D, H, W,
// C) int64, zero on entry, and maxbits (C,) int32, zero on entry; a null
// ct is one channel of ones, with maxbits holding the bits of 1.0f.  Each
// returns cudaGetLastError().
extern "C" {

int warp_trilinear(int dtype, const void* vol, const float* grid, void* out,
                   int b, int d, int h, int w, int c, int od, int oh, int ow,
                   cudaStream_t stream) {
  const da::Dims s = da::make_dims(b, d, h, w, c, od, oh, ow);
  if (s.total == 0) return 0;
  if (dtype == da::kFloat32)
    return da::warp_fwd(static_cast<const float*>(vol), grid,
                        static_cast<float*>(out), s, stream);
  return da::warp_fwd(static_cast<const __nv_bfloat16*>(vol), grid,
                      static_cast<__nv_bfloat16*>(out), s, stream);
}

int warp_grid_grad(int dtype, const void* vol, const float* grid,
                   const void* ct, float* dgrid, int b, int d, int h, int w,
                   int c, int od, int oh, int ow, cudaStream_t stream) {
  const da::Dims s = da::make_dims(b, d, h, w, c, od, oh, ow);
  if (s.total == 0) return 0;
  if (dtype == da::kFloat32)
    return da::grid_grad(static_cast<const float*>(vol), grid,
                         static_cast<const float*>(ct), dgrid, s, b, stream);
  return da::grid_grad(static_cast<const __nv_bfloat16*>(vol), grid,
                       static_cast<const __nv_bfloat16*>(ct), dgrid, s, b,
                       stream);
}

int splat_trilinear(int dtype, const void* ct, const float* grid, float* dvol,
                    unsigned long long* acc, unsigned* maxbits, int b, int d,
                    int h, int w, int c, int od, int oh, int ow,
                    cudaStream_t stream) {
  const da::Dims s = da::make_dims(b, d, h, w, c, od, oh, ow);
  if (dtype == da::kFloat32)
    return da::splat(static_cast<const float*>(ct), grid, dvol, acc, maxbits,
                     s, b, stream);
  return da::splat(static_cast<const __nv_bfloat16*>(ct), grid, dvol, acc,
                   maxbits, s, b, stream);
}

}  // extern "C"
