// Matched-label warp: the hard-label anatomy dice's one gather, its
// derivative planes, and its grid cotangent, on (B, D, H, W) int32 labels
// sampled at a (B, Do, Ho, Wo, 3) normalized (x, y, z) float32 grid:
//
//   m(p) = sum over the 8 corners k of p:  w_k(p) [lab_m(corner_k) == lab_f(p)]
//
// a corner outside the volume contributing nothing.  This is channel
// lab_f(p) of the trilinear warp of lab_m's one-hot, so the anatomy dice
// needs one pass over labels where the dense composition warps C one-hot
// channels.  Three entry points on one kernel template:
//
//   matched_warp       (H)  m                       replaces
//       deepatlas_tpu/pallas/anatomy.py::_matched_fwd_kernel
//   matched_warp_fused (I)  m and dm/dgrid (x, y, z planes, normalized
//       units)             ::_matched_fused_kernel
//   matched_grid_grad  (J)  ct * dm/dgrid, no m     ::_matched_bwd_kernel
//
// The TPU kernels stage z-slabs of labels and rebuild the gather from lane
// rolls and tent weights over (s, dy) offset lists, which is where their
// displacement bound, depth limit and dense fallbacks come from; a thread
// here gathers its 8 corner labels directly, so there is no limit and no
// second path.  The derivative is that of the corner weights at fixed
// corners (the floor rule, as warp_grid_grad): at an exactly integral
// coordinate it is the one-sided derivative towards the upper corner, where
// the TPU's tent form returns 0.
//
// Bound by bytes on an H100: per point 12 bytes of coordinates, 4 of
// lab_f, about 4 of lab_m (neighbouring threads' corners share cache lines
// on a smooth field) and 4 written (H); I writes 12 more, J reads 4 of ct
// and writes 12 in place of m.  One thread per point computes its corners
// once, compares integers exactly (what the TPU's |v - lf| < 0.5 on float
// labels computes) and is the only writer of its outputs, so all three are
// bit-identical from run to run.
#include "trilinear.cuh"

namespace da {

enum MatchedMode { kValue = 0, kFused = 1, kGridGrad = 2 };

template <int kMode>
__global__ void __launch_bounds__(kThreads)
matched_kernel(const int* __restrict__ lab_m, const int* __restrict__ lab_f,
               const float* __restrict__ grid, const float* __restrict__ ct,
               float* __restrict__ m_out, float* __restrict__ planes,
               Dims s) {
  const long long p =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (p >= s.total) return;
  const float* g = grid + 3 * p;
  const Axis ax = axis_of(g[0], s.sx, s.w);
  const Axis ay = axis_of(g[1], s.sy, s.h);
  const Axis az = axis_of(g[2], s.sz, s.d);
  const Corners q = corners_of(az, ay, ax, s);
  const int* lb = lab_m + (p / s.points) * s.d * s.h * s.w;
  const int lf = lab_f[p];
  float v[8];
#pragma unroll
  for (int k = 0; k < 8; ++k)
    v[k] = (q.inb[k] && lb[q.off[k]] == lf) ? 1.0f : 0.0f;
  if (kMode != kGridGrad) {
    float acc = 0.0f;
#pragma unroll
    for (int k = 0; k < 8; ++k) acc += q.wgt[k] * v[k];
    m_out[p] = acc;
  }
  if (kMode != kValue) {
    float dx, dy, dz;
    corner_derivatives(az, ay, ax, v, dx, dy, dz);
    // the fused planes are dm/dgrid; the grid cotangent is ct times the
    // same product, so J equals ct * I's planes bit for bit
    const float c = kMode == kGridGrad ? ct[p] : 1.0f;
    float* o = planes + 3 * p;
    o[0] = c * (dx * s.sx);
    o[1] = c * (dy * s.sy);
    o[2] = c * (dz * s.sz);
  }
}

template <int kMode>
int launch(const int* lab_m, const int* lab_f, const float* grid,
           const float* ct, float* m_out, float* planes, int b, int d, int h,
           int w, int od, int oh, int ow, cudaStream_t stream) {
  const Dims s = make_dims(b, d, h, w, 1, od, oh, ow);
  if (s.total == 0) return 0;
  matched_kernel<kMode><<<blocks_for(s), kThreads, 0, stream>>>(
      lab_m, lab_f, grid, ct, m_out, planes, s);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace da

// C entry points.  Pointers are device pointers of contiguous tensors:
// lab_m (B, D, H, W) int32; lab_f, ct and m (B, Do, Ho, Wo) int32 / float32;
// grid and planes / dgrid (B, Do, Ho, Wo, 3) float32.  Each returns
// cudaGetLastError().
extern "C" {

int matched_warp(const int* lab_m, const int* lab_f, const float* grid,
                 float* m, int b, int d, int h, int w, int od, int oh, int ow,
                 cudaStream_t stream) {
  return da::launch<da::kValue>(lab_m, lab_f, grid, nullptr, m, nullptr, b,
                                d, h, w, od, oh, ow, stream);
}

int matched_warp_fused(const int* lab_m, const int* lab_f, const float* grid,
                       float* m, float* planes, int b, int d, int h, int w,
                       int od, int oh, int ow, cudaStream_t stream) {
  return da::launch<da::kFused>(lab_m, lab_f, grid, nullptr, m, planes, b, d,
                                h, w, od, oh, ow, stream);
}

int matched_grid_grad(const int* lab_m, const int* lab_f, const float* grid,
                      const float* ct, float* dgrid, int b, int d, int h,
                      int w, int od, int oh, int ow, cudaStream_t stream) {
  return da::launch<da::kGridGrad>(lab_m, lab_f, grid, ct, nullptr, dgrid, b,
                                   d, h, w, od, oh, ow, stream);
}

}  // extern "C"
