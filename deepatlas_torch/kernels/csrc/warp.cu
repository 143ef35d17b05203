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
// output voxel they read 12 bytes of coordinates and, per channel, one
// value each of the volume and / or the upstream gradient, and write one
// value (or three coordinates' gradients).  The design keeps the traffic
// near that: one thread per output voxel, the coordinates, corner offsets
// and weights computed once per voxel and reused for every channel, and
// neighbouring threads on neighbouring voxels, so that for smooth fields
// their corner reads fall into the same cache lines.  The splat adds with
// float atomics (one per in-bounds corner and channel): the sums are right
// to rounding but their order, and so their last bits, change from run to
// run.
#include "trilinear.cuh"

namespace da {

// out[p, c] = sum_k w_k vol[corner_k, c]
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

// dvol[corner_k, c] += w_k ct[p, c]; dvol is float32 and zero on entry.
template <typename T>
__global__ void __launch_bounds__(kThreads)
splat_kernel(const T* __restrict__ ct, const float* __restrict__ grid,
             float* __restrict__ dvol, Dims s) {
  const long long p =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (p >= s.total) return;
  const float* g = grid + 3 * p;
  const Axis ax = axis_of(g[0], s.sx, s.w);
  const Axis ay = axis_of(g[1], s.sy, s.h);
  const Axis az = axis_of(g[2], s.sz, s.d);
  const Corners q = corners_of(az, ay, ax, s);
  float* vb = dvol + (p / s.points) * s.d * s.h * s.w * s.c;
  const T* c = ct + p * s.c;
  for (int ch = 0; ch < s.c; ++ch) {
    const float cv = to_float(c[ch]);
#pragma unroll
    for (int k = 0; k < 8; ++k)
      if (q.inb[k]) atomicAdd(vb + q.off[k] + ch, q.wgt[k] * cv);
  }
}

}  // namespace da

// C entry points.  Pointers are device pointers of contiguous tensors:
// vol / out / ct / dvol (B, D, H, W, C) resp. (B, Do, Ho, Wo, C), grid and
// dgrid (B, Do, Ho, Wo, 3) float32.  Each returns cudaGetLastError().
extern "C" {

int warp_trilinear(int dtype, const void* vol, const float* grid, void* out,
                   int b, int d, int h, int w, int c, int od, int oh, int ow,
                   cudaStream_t stream) {
  const da::Dims s = da::make_dims(b, d, h, w, c, od, oh, ow);
  if (s.total == 0) return 0;
  if (dtype == da::kFloat32)
    da::warp_fwd_kernel<float><<<da::blocks_for(s), da::kThreads, 0, stream>>>(
        static_cast<const float*>(vol), grid, static_cast<float*>(out), s);
  else
    da::warp_fwd_kernel<__nv_bfloat16>
        <<<da::blocks_for(s), da::kThreads, 0, stream>>>(
            static_cast<const __nv_bfloat16*>(vol), grid,
            static_cast<__nv_bfloat16*>(out), s);
  return static_cast<int>(cudaGetLastError());
}

int warp_grid_grad(int dtype, const void* vol, const float* grid,
                   const void* ct, float* dgrid, int b, int d, int h, int w,
                   int c, int od, int oh, int ow, cudaStream_t stream) {
  const da::Dims s = da::make_dims(b, d, h, w, c, od, oh, ow);
  if (s.total == 0) return 0;
  if (dtype == da::kFloat32)
    da::warp_grid_grad_kernel<float>
        <<<da::blocks_for(s), da::kThreads, 0, stream>>>(
            static_cast<const float*>(vol), grid,
            static_cast<const float*>(ct), dgrid, s);
  else
    da::warp_grid_grad_kernel<__nv_bfloat16>
        <<<da::blocks_for(s), da::kThreads, 0, stream>>>(
            static_cast<const __nv_bfloat16*>(vol), grid,
            static_cast<const __nv_bfloat16*>(ct), dgrid, s);
  return static_cast<int>(cudaGetLastError());
}

int splat_trilinear(int dtype, const void* ct, const float* grid, float* dvol,
                    int b, int d, int h, int w, int c, int od, int oh, int ow,
                    cudaStream_t stream) {
  const da::Dims s = da::make_dims(b, d, h, w, c, od, oh, ow);
  if (s.total == 0) return 0;
  if (dtype == da::kFloat32)
    da::splat_kernel<float><<<da::blocks_for(s), da::kThreads, 0, stream>>>(
        static_cast<const float*>(ct), grid, dvol, s);
  else
    da::splat_kernel<__nv_bfloat16>
        <<<da::blocks_for(s), da::kThreads, 0, stream>>>(
            static_cast<const __nv_bfloat16*>(ct), grid, dvol, s);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
