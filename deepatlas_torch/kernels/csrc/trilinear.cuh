// The trilinear sample point shared by the warp kernels (warp.cu) and the
// matched-label anatomy kernels (anatomy.cu): one thread per sample point,
// its normalized (x, y, z) coordinates un-normalized in float32, the 8
// corners' weights, offsets and in-bounds flags.
#pragma once

#include "common.cuh"

namespace da {

constexpr int kThreads = 256;

// One axis of a sample point: the lower corner's index, the fraction
// towards the upper corner, and whether each corner lies in the volume.
struct Axis {
  int i0;
  float f;
  bool in0, in1;
};

// g is normalized; scale = (n - 1) / 2.  Computed as (g + 1) * scale in
// float32, the reference's order of operations.
__device__ __forceinline__ Axis axis_of(float g, float scale, int n) {
  const float v = (g + 1.0f) * scale;
  const float lo = floorf(v);
  const float hi_bound = static_cast<float>(n - 1);
  Axis a;
  a.f = v - lo;
  a.in0 = lo >= 0.0f && lo <= hi_bound;
  a.in1 = lo + 1.0f >= 0.0f && lo + 1.0f <= hi_bound;
  // convert only what is known to be small; NaN and far-away points have
  // no in-bounds corner and are never dereferenced
  a.i0 = (a.in0 || a.in1) ? static_cast<int>(lo) : 0;
  return a;
}

struct Dims {
  int d, h, w, c;          // source volume
  long long points;        // output points per batch sample
  long long total;         // output points over the batch
  float sx, sy, sz;        // (n - 1) / 2 per axis
};

// The 8 corners of one sample point: weights (float32, z * y * x as the
// reference multiplies them), element offsets of channel 0 inside the
// sample's volume, and in-bounds flags.  Corner k has dz = k >> 2,
// dy = (k >> 1) & 1, dx = k & 1.
struct Corners {
  float wgt[8];
  long long off[8];
  bool inb[8];
};

__device__ __forceinline__ Corners corners_of(const Axis& az, const Axis& ay,
                                              const Axis& ax,
                                              const Dims& s) {
  Corners q;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int dz = k >> 2, dy = (k >> 1) & 1, dx = k & 1;
    const float wz = dz ? az.f : 1.0f - az.f;
    const float wy = dy ? ay.f : 1.0f - ay.f;
    const float wx = dx ? ax.f : 1.0f - ax.f;
    q.wgt[k] = wz * wy * wx;
    q.inb[k] = (dz ? az.in1 : az.in0) && (dy ? ay.in1 : ay.in0) &&
               (dx ? ax.in1 : ax.in0);
    q.off[k] = ((static_cast<long long>(az.i0 + dz) * s.h + (ay.i0 + dy)) *
                    s.w + (ax.i0 + dx)) * s.c;
  }
  return q;
}

// The derivatives of sum_k w_k v[k] with respect to the voxel coordinates
// (x, y, z) at fixed corners (the floor rule), for corner values v (zero
// for a corner outside the volume).
__device__ __forceinline__ void corner_derivatives(const Axis& az,
                                                   const Axis& ay,
                                                   const Axis& ax,
                                                   const float* v, float& dx,
                                                   float& dy, float& dz) {
  const float wz[2] = {1.0f - az.f, az.f};
  const float wy[2] = {1.0f - ay.f, ay.f};
  const float wx[2] = {1.0f - ax.f, ax.f};
  dx = dy = dz = 0.0f;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      // (i, j) run over the two axes that are not differentiated
      dx += wz[i] * wy[j] * (v[4 * i + 2 * j + 1] - v[4 * i + 2 * j]);
      dy += wz[i] * wx[j] * (v[4 * i + 2 + j] - v[4 * i + j]);
      dz += wy[i] * wx[j] * (v[4 + 2 * i + j] - v[2 * i + j]);
    }
}

inline Dims make_dims(int b, int d, int h, int w, int c, int od, int oh,
                      int ow) {
  Dims s;
  s.d = d;
  s.h = h;
  s.w = w;
  s.c = c;
  s.points = static_cast<long long>(od) * oh * ow;
  s.total = s.points * b;
  s.sx = static_cast<float>((w - 1) / 2.0);
  s.sy = static_cast<float>((h - 1) / 2.0);
  s.sz = static_cast<float>((d - 1) / 2.0);
  return s;
}

inline unsigned blocks_for(const Dims& s) {
  return static_cast<unsigned>((s.total + kThreads - 1) / kThreads);
}

}  // namespace da
