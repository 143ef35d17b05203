// The epilogue of every conv and deconv block: bias, optional BatchNorm and
// activation on the block's channel-last (B, D, H, W, C) output y, forward
// and backward, for sm_90a.
//
// Replaces no TPU kernel: on the TPU, XLA fused this chain of elementwise
// ops and per-channel reductions into the passes around the Pallas convs.
// In eager PyTorch it was ~35 launches a block (the bias add, the float32
// copy, two means, the affine, the activation, and as many again through
// autograd), each a full pass over the tensor, and autograd kept a float32
// copy of the biased output for the square's backward.
//
// The rounding sequence is the port's (kernels/block_epilogue.py), in the
// storage type T (bfloat16 on every main path, or float32):
//
//   x = T(y + T(b)),   z = T(T(x * T(mul)) + T(add)),   out = act(z)
//
// mul = w rsqrt(var + eps), add = shift - mean mul, from the batch moments
// of x taken in float32 (var = max(E[x^2] - mean^2, 0), the biased
// variance) in train mode, from the running statistics in eval mode;
// LeakyReLU is T(z * 0.01f) below 0.  __fmul_rn / __fadd_rn keep nvcc from
// fusing a product and a sum that the chain rounds apart, so eval mode and
// the no-BatchNorm forward equal the chain bit for bit.
//
// Passes, each one read of the tensor by a grid of at most kMaxParts
// blocks (per-block partial sums, no float atomics, so two runs and a
// remat recompute are equal bit for bit):
//
//   forward, train:  moments (x's per-channel sum and sum of squares into
//                    the block's partials) -> stats (the partials summed in
//                    a fixed order in double; mean, var, mul, add; the
//                    running statistics moved) -> apply (writes out);
//   forward, eval:   stats from the running statistics -> apply;
//   no BatchNorm:    apply alone;
//   backward:        reduce (recomputes z for the activation's derivative,
//                    dz, and sums dz and dz x per channel) -> grads (the
//                    closed-form derivative of the forward above as
//                    per-channel coefficients, dx = alpha dz + beta +
//                    gamma x, and the gradients of the BatchNorm scale and
//                    shift from the same sums) -> apply (writes dx, and
//                    sums it for the bias's gradient) -> sums (the bias's
//                    gradient).  Where beta = gamma = 0 (no BatchNorm, eval
//                    mode) one pass writes dx and sums at once, unless the
//                    bias in front of a BatchNorm wants the sum of dx.
//
// The backward keeps autograd's rounding points through the chain (each
// rounding passes the gradient straight through): dz = T(act'(z) g), the
// per-channel sums T(sum dz) and T(sum T(dz x)) (the gradients of T(add)
// and T(mul)), dx = T(T(alpha dz) + T(beta + gamma x)) and the bias's
// T(sum dx), so the plain version equals the chain's autograd bit for bit
// but for the float32 order of a few per-channel products.
//
// Bound by bytes on an H100: a handful of flops per element against 2 bytes
// read (and 2 written) per pass in bf16.  Train mode moves 2 + 4 bytes an
// element forward and 4 + 6 backward; only y (T) and per-channel vectors
// are kept for the backward pass.
//
// Layout: a thread owns one chunk of VEC consecutive channels (16 bytes
// where C allows it, else one channel) and walks voxels with a grid stride,
// so its per-channel coefficients and sums stay in registers; a block's
// threads are `rows` (a power of two) voxels by C / VEC chunks, so a warp
// reads consecutive 16-byte chunks.  Block sums go through shared memory
// in a fixed tree over the rows.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxVec = 8;

enum Act { kActNone = 0, kActReLU = 1, kActLeaky = 2 };

// rows of the per-channel statistics (kStatRows, C), float32: the scale and
// shift as T rounds them, the batch (or running) mean, E[x^2] - mean^2
// before its clamp, and rsqrt(var + eps)
enum StatRow { kMul = 0, kAdd, kMean, kVarPre, kRstd, kStatRows };

template <typename T>
__device__ __forceinline__ float rnd(float v) {
  return da::to_float(da::from_float<T>(v));
}

template <typename T, int VEC>
__device__ __forceinline__ void load_vec(const T* p, float* v) {
  if constexpr (VEC * sizeof(T) == 16) {
    union {
      uint4 u;
      T e[VEC];
    } pack;
    pack.u = *reinterpret_cast<const uint4*>(p);
#pragma unroll
    for (int i = 0; i < VEC; ++i) v[i] = da::to_float(pack.e[i]);
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) v[i] = da::to_float(p[i]);
  }
}

template <typename T, int VEC>
__device__ __forceinline__ void store_vec(T* p, const float* v) {
  if constexpr (VEC * sizeof(T) == 16) {
    union {
      uint4 u;
      T e[VEC];
    } pack;
#pragma unroll
    for (int i = 0; i < VEC; ++i) pack.e[i] = da::from_float<T>(v[i]);
    *reinterpret_cast<uint4*>(p) = pack.u;
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) p[i] = da::from_float<T>(v[i]);
  }
}

template <typename T>
__device__ __forceinline__ float act_fwd(float z, int act) {
  if (act == kActLeaky) return z > 0.f ? z : rnd<T>(__fmul_rn(z, 0.01f));
  if (act == kActReLU) return (z > 0.f || z != z) ? z : 0.f;
  return z;
}

// the upstream gradient through the activation at its input z, rounded to
// T (torch's leaky_relu_backward and threshold_backward)
template <typename T>
__device__ __forceinline__ float act_bwd(float g, float z, int act) {
  if (act == kActLeaky) return z > 0.f ? g : rnd<T>(__fmul_rn(g, 0.01f));
  if (act == kActReLU) return z <= 0.f ? 0.f : g;
  return g;
}

// A thread's place: chunk q of the C / VEC chunks, voxel row of `rows`.
struct Place {
  int q, row;
  bool active;
  int64_t v0, step;
};

template <int VEC>
__device__ __forceinline__ Place place(int C, int rows) {
  const int chunks = C / VEC;
  Place p;
  p.q = threadIdx.x % chunks;
  p.row = threadIdx.x / chunks;
  p.active = p.row < rows;
  p.v0 = (int64_t)blockIdx.x * rows + p.row;
  p.step = (int64_t)gridDim.x * rows;
  return p;
}

// Sum acc[N] over the block's rows (fixed tree; row 0 ends with the sums).
// Shared memory holds one value a thread per slot, sh[j * kThreads + tid].
template <int N>
__device__ __forceinline__ void reduce_rows(float* acc, float* sh,
                                            const Place& p, int chunks,
                                            int rows) {
  const int tid = threadIdx.x;
  if (p.active) {
#pragma unroll
    for (int j = 0; j < N; ++j) sh[j * kThreads + tid] = acc[j];
  }
  __syncthreads();
  for (int h = rows >> 1; h > 0; h >>= 1) {
    if (p.active && p.row < h) {
#pragma unroll
      for (int j = 0; j < N; ++j) {
        acc[j] += sh[j * kThreads + tid + h * chunks];
        sh[j * kThreads + tid] = acc[j];
      }
    }
    __syncthreads();
  }
}

// Row 0 of the block writes its VEC channels' two sums to its partials
// (parts, 2, C).
template <int VEC>
__device__ __forceinline__ void write_partials(float* partials,
                                               const float* acc,
                                               const Place& p, int C) {
  if (!p.active || p.row != 0) return;
  float* out = partials + (int64_t)blockIdx.x * 2 * C + p.q * VEC;
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    out[i] = acc[i];
    out[C + i] = acc[VEC + i];
  }
}

template <typename T, int VEC>
__device__ __forceinline__ void load_bias(const float* bias, int c0,
                                          float* bb) {
#pragma unroll
  for (int i = 0; i < VEC; ++i) bb[i] = bias ? rnd<T>(bias[c0 + i]) : 0.f;
}

// x = T(y + T(b)) in place (no bias: x = y)
template <typename T, int VEC>
__device__ __forceinline__ void add_bias(float* v, const float* bb,
                                         bool has_bias) {
  if (!has_bias) return;
#pragma unroll
  for (int i = 0; i < VEC; ++i) v[i] = rnd<T>(__fadd_rn(v[i], bb[i]));
}

// z = T(T(x * mul) + add)
template <typename T>
__device__ __forceinline__ float affine(float x, float mul, float add) {
  return rnd<T>(__fadd_rn(rnd<T>(__fmul_rn(x, mul)), add));
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
    moments_kernel(const T* __restrict__ y, const float* __restrict__ bias,
                   float* __restrict__ partials, int64_t nvox, int C,
                   int rows) {
  __shared__ float sh[2 * kMaxVec * kThreads];
  const Place p = place<VEC>(C, rows);
  const int c0 = p.q * VEC;
  float bb[VEC], acc[2 * VEC];
  load_bias<T, VEC>(bias, c0, bb);
#pragma unroll
  for (int j = 0; j < 2 * VEC; ++j) acc[j] = 0.f;
  if (p.active) {
#pragma unroll 4
    for (int64_t v = p.v0; v < nvox; v += p.step) {
      float x[VEC];
      load_vec<T, VEC>(y + v * C + c0, x);
      add_bias<T, VEC>(x, bb, bias != nullptr);
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        acc[i] += x[i];
        acc[VEC + i] = fmaf(x[i], x[i], acc[VEC + i]);
      }
    }
  }
  reduce_rows<2 * VEC>(acc, sh, p, C / VEC, rows);
  write_partials<VEC>(partials, acc, p, C);
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
    apply_kernel(const T* __restrict__ y, const float* __restrict__ bias,
                 const float* __restrict__ stats, int act, T* __restrict__ out,
                 int64_t nvox, int C, int rows) {
  const Place p = place<VEC>(C, rows);
  if (!p.active) return;
  const int c0 = p.q * VEC;
  float bb[VEC], mul[VEC], add[VEC];
  load_bias<T, VEC>(bias, c0, bb);
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    mul[i] = stats ? stats[kMul * C + c0 + i] : 1.f;
    add[i] = stats ? stats[kAdd * C + c0 + i] : 0.f;
  }
#pragma unroll 4
  for (int64_t v = p.v0; v < nvox; v += p.step) {
    float x[VEC];
    load_vec<T, VEC>(y + v * C + c0, x);
    add_bias<T, VEC>(x, bb, bias != nullptr);
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      const float z = stats ? affine<T>(x[i], mul[i], add[i]) : x[i];
      x[i] = act_fwd<T>(z, act);
    }
    store_vec<T, VEC>(out + v * C + c0, x);
  }
}

// Without coef: REDUCE sums dz and T(dz x) into the block's partials, and
// WRITE writes dx = T(alpha dz) with alpha the rounded scale (stats) or 1
// (without a BatchNorm dx is dz).  With coef (3, C: alpha, beta, gamma):
// dx = T(T(alpha dz) + T(beta + gamma x)), which WRITE writes and REDUCE
// sums (into the partials' first row; the second stays 0).  g's voxels are
// g_vs elements apart (a channel slice of a concatenation's gradient).
template <typename T, int VEC, bool REDUCE, bool WRITE>
__global__ void __launch_bounds__(kThreads)
    backward_kernel(const T* __restrict__ g, int64_t g_vs,
                    const T* __restrict__ y, const float* __restrict__ bias,
                    const float* __restrict__ stats,
                    const float* __restrict__ coef, int act,
                    T* __restrict__ dx, float* __restrict__ partials,
                    int64_t nvox, int C, int rows) {
  __shared__ float sh[REDUCE ? 2 * kMaxVec * kThreads : 1];
  const Place p = place<VEC>(C, rows);
  const int c0 = p.q * VEC;
  float bb[VEC], mul[VEC], add[VEC], alpha[VEC], beta[VEC], gamma[VEC];
  float acc[2 * VEC];
  load_bias<T, VEC>(bias, c0, bb);
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    const int c = c0 + i;
    mul[i] = stats ? stats[kMul * C + c] : 1.f;
    add[i] = stats ? stats[kAdd * C + c] : 0.f;
    alpha[i] = coef ? coef[c] : mul[i];
    beta[i] = coef ? coef[C + c] : 0.f;
    gamma[i] = coef ? coef[2 * C + c] : 0.f;
    acc[i] = acc[VEC + i] = 0.f;
  }
  if (p.active) {
#pragma unroll 2
    for (int64_t v = p.v0; v < nvox; v += p.step) {
      float x[VEC], d[VEC];
      load_vec<T, VEC>(y + v * C + c0, x);
      load_vec<T, VEC>(g + v * g_vs + c0, d);
      add_bias<T, VEC>(x, bb, bias != nullptr);
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        const float z = stats ? affine<T>(x[i], mul[i], add[i]) : x[i];
        d[i] = act_bwd<T>(d[i], z, act);
        if (coef) {
          d[i] = rnd<T>(__fadd_rn(
              rnd<T>(__fmul_rn(alpha[i], d[i])),
              rnd<T>(__fadd_rn(beta[i], __fmul_rn(gamma[i], x[i])))));
          if constexpr (REDUCE) acc[i] += d[i];
        } else {
          if constexpr (REDUCE) {
            acc[i] += d[i];
            acc[VEC + i] += rnd<T>(__fmul_rn(d[i], x[i]));
          }
          if constexpr (WRITE) d[i] = __fmul_rn(alpha[i], d[i]);
        }
      }
      if constexpr (WRITE) store_vec<T, VEC>(dx + v * C + c0, d);
    }
  }
  if constexpr (REDUCE) {
    reduce_rows<2 * VEC>(acc, sh, p, C / VEC, rows);
    write_partials<VEC>(partials, acc, p, C);
  }
}

// ------------------------------------------------- per-channel finishing
// A block takes cb channels (consecutive threads, consecutive channels)
// and rr rows that add every rr-th partial in double, then a fixed tree
// over the rows.
struct Channel {
  int c, row, rr;
  bool active;
};

__device__ __forceinline__ Channel channel(int C) {
  const int cb = C < 32 ? C : 32;
  int rr = 1;
  while (rr * 2 * cb <= kThreads) rr *= 2;
  Channel ch;
  ch.row = threadIdx.x / cb;
  ch.c = blockIdx.x * cb + threadIdx.x % cb;
  ch.rr = rr;
  ch.active = ch.row < rr && ch.c < C;
  return ch;
}

inline int channel_blocks(int C) {
  const int cb = C < 32 ? C : 32;
  return (C + cb - 1) / cb;
}

// the two sums of channel ch.c over the partials (parts, 2, C); valid in
// row 0
__device__ __forceinline__ void sum_partials(const float* partials,
                                             int parts, int C,
                                             const Channel& ch, double* s) {
  __shared__ double sh[2][kThreads];
  s[0] = s[1] = 0.0;
  if (ch.active) {
    for (int k = ch.row; k < parts; k += ch.rr) {
      s[0] += (double)partials[(int64_t)k * 2 * C + ch.c];
      s[1] += (double)partials[(int64_t)k * 2 * C + C + ch.c];
    }
    sh[0][threadIdx.x] = s[0];
    sh[1][threadIdx.x] = s[1];
  }
  __syncthreads();
  const int cb = C < 32 ? C : 32;
  for (int h = ch.rr >> 1; h > 0; h >>= 1) {
    if (ch.active && ch.row < h) {
      s[0] += sh[0][threadIdx.x + h * cb];
      s[1] += sh[1][threadIdx.x + h * cb];
      sh[0][threadIdx.x] = s[0];
      sh[1][threadIdx.x] = s[1];
    }
    __syncthreads();
  }
}

// the two sums of every channel, rounded to T
template <typename T>
__global__ void __launch_bounds__(kThreads)
    sums_kernel(const float* __restrict__ partials, int parts, int C,
                float* __restrict__ sums) {
  const Channel ch = channel(C);
  double s[2];
  sum_partials(partials, parts, C, ch, s);
  if (!ch.active || ch.row != 0) return;
  sums[ch.c] = rnd<T>((float)s[0]);
  sums[C + ch.c] = rnd<T>((float)s[1]);
}

// train: the batch moments from the partials (or from `global`, the sums
// over every shard), the running statistics moved by keep * r + take *
// batch where `update`; eval: the running statistics.  The scale and
// shift in float32 as torch forms them (w * rsqrt(var + eps), shift -
// mean * scale), then rounded to T.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    stats_kernel(int train, const float* __restrict__ partials, int parts,
                 const float* __restrict__ global, int C,
                 const float* __restrict__ weight,
                 const float* __restrict__ shift, float* running_mean,
                 float* running_var, float eps, float keep, float take,
                 int update, double n, float* __restrict__ stats) {
  const Channel ch = channel(C);
  double s[2];
  sum_partials(partials, parts, C, ch, s);
  if (!ch.active || ch.row != 0) return;
  const int c = ch.c;
  float mean, var_pre, var;
  if (train) {
    const double s0 = global ? (double)global[c] : s[0];
    const double s1 = global ? (double)global[C + c] : s[1];
    mean = (float)(s0 / n);
    const float e2 = (float)(s1 / n);
    var_pre = __fsub_rn(e2, __fmul_rn(mean, mean));
    var = var_pre < 0.f ? 0.f : var_pre;
  } else {
    mean = running_mean[c];
    var = var_pre = running_var[c];
  }
  const float rstd = rsqrtf(__fadd_rn(var, eps));
  const float scale = __fmul_rn(weight[c], rstd);
  const float add = __fsub_rn(shift[c], __fmul_rn(mean, scale));
  stats[kMul * C + c] = rnd<T>(scale);
  stats[kAdd * C + c] = rnd<T>(add);
  stats[kMean * C + c] = mean;
  stats[kVarPre * C + c] = var_pre;
  stats[kRstd * C + c] = rstd;
  if (train && update) {
    running_mean[c] = __fadd_rn(__fmul_rn(running_mean[c], keep),
                                __fmul_rn(mean, take));
    running_var[c] = __fadd_rn(__fmul_rn(running_var[c], keep),
                               __fmul_rn(var, take));
  }
}

// The backward's per-channel coefficients and parameter gradients from
// this shard's sums Sg = T(sum dz), Sgx = T(sum T(dz x)) (and `global`, the
// sums over every shard, in train mode), in double.  mode 0: no BatchNorm,
// the bias's gradient Sg; 1: eval (mean, var constants); 2: train, the
// derivative of mul and add through mean and the clamped biased variance,
// each rounding passing the gradient straight through: x meets the rounded
// scale alpha = T(mul) in x mul, and mean the unrounded one, mul = w rstd,
// in add = shift - mean mul:
//   dmul = Sgx - mean Sg, dw = dmul rstd, dshift = Sg,
//   dvar = -dmul w rstd^3 / 2 where E[x^2] - mean^2 >= 0, else 0,
//   dmean = -mul Sg - 2 mean dvar,
//   beta = dmean / n, gamma = 2 dvar / n.
// In front of a BatchNorm the bias's gradient is the sum of dx (the apply
// pass and sums_kernel).
template <typename T>
__global__ void __launch_bounds__(kThreads)
    grads_kernel(int mode, const float* __restrict__ partials, int parts,
                 const float* __restrict__ global, int C,
                 const float* __restrict__ stats,
                 const float* __restrict__ weight, double n_total,
                 float* __restrict__ coef, float* __restrict__ dbias,
                 float* __restrict__ dweight, float* __restrict__ dshift) {
  const Channel ch = channel(C);
  double s[2];
  sum_partials(partials, parts, C, ch, s);
  if (!ch.active || ch.row != 0) return;
  const int c = ch.c;
  const double s0 = rnd<T>((float)s[0]), s1 = rnd<T>((float)s[1]);
  if (dbias) dbias[c] = (float)s0;
  if (mode == 0) return;
  const double mean = stats[kMean * C + c], rstd = stats[kRstd * C + c];
  double beta = 0.0, gamma = 0.0;
  if (dweight) dweight[c] = (float)((s1 - mean * s0) * rstd);
  if (dshift) dshift[c] = (float)s0;
  if (mode == 2) {
    const double g0 = global ? (double)global[c] : s0;
    const double g1 = global ? (double)global[C + c] : s1;
    const double dmul = g1 - mean * g0;
    const double dvar = stats[kVarPre * C + c] >= 0.f
                            ? -0.5 * dmul * weight[c] * rstd * rstd * rstd
                            : 0.0;
    const double mul = (double)weight[c] * rstd;
    const double dmean = -mul * g0 - 2.0 * mean * dvar;
    beta = dmean / n_total;
    gamma = 2.0 * dvar / n_total;
  }
  if (coef) {
    coef[c] = stats[kMul * C + c];
    coef[C + c] = (float)beta;
    coef[2 * C + c] = (float)gamma;
  }
}

template <typename T, int VEC>
int launch_backward(int reduce, int write, const void* g, int64_t g_vs,
                    const void* y, const float* bias, const float* stats,
                    const float* coef, int act, void* dx, float* partials,
                    int64_t nvox, int C, int rows, int parts,
                    cudaStream_t s) {
  const T* gp = static_cast<const T*>(g);
  const T* yp = static_cast<const T*>(y);
  T* dp = static_cast<T*>(dx);
  if (reduce && write)
    backward_kernel<T, VEC, true, true><<<parts, kThreads, 0, s>>>(
        gp, g_vs, yp, bias, stats, coef, act, dp, partials, nvox, C, rows);
  else if (reduce)
    backward_kernel<T, VEC, true, false><<<parts, kThreads, 0, s>>>(
        gp, g_vs, yp, bias, stats, coef, act, dp, partials, nvox, C, rows);
  else
    backward_kernel<T, VEC, false, true><<<parts, kThreads, 0, s>>>(
        gp, g_vs, yp, bias, stats, coef, act, dp, partials, nvox, C, rows);
  return (int)cudaGetLastError();
}

}  // namespace

// vec is the chunk width in elements: 16 bytes (8 bf16, 4 float32) where C
// and the pointers allow it, else 1; rows and parts give the grid (see
// kernels/block_epilogue.py::layout).  Each entry returns
// cudaGetLastError().
extern "C" int epilogue_moments(int dtype, int vec, const void* y,
                                const float* bias, float* partials,
                                long long nvox, int C, int rows, int parts,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == da::kBFloat16) {
    const auto* yp = static_cast<const __nv_bfloat16*>(y);
    if (vec == 8)
      moments_kernel<__nv_bfloat16, 8><<<parts, kThreads, 0, s>>>(
          yp, bias, partials, nvox, C, rows);
    else
      moments_kernel<__nv_bfloat16, 1><<<parts, kThreads, 0, s>>>(
          yp, bias, partials, nvox, C, rows);
  } else {
    const auto* yp = static_cast<const float*>(y);
    if (vec == 4)
      moments_kernel<float, 4><<<parts, kThreads, 0, s>>>(yp, bias, partials,
                                                         nvox, C, rows);
    else
      moments_kernel<float, 1><<<parts, kThreads, 0, s>>>(yp, bias, partials,
                                                         nvox, C, rows);
  }
  return (int)cudaGetLastError();
}

// dtype: the type the sums are rounded to (-1: float32, no rounding)
extern "C" int epilogue_sums(int dtype, const float* partials, int parts,
                             int C, float* sums, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == da::kBFloat16)
    sums_kernel<__nv_bfloat16><<<channel_blocks(C), kThreads, 0, s>>>(
        partials, parts, C, sums);
  else
    sums_kernel<float><<<channel_blocks(C), kThreads, 0, s>>>(partials,
                                                               parts, C, sums);
  return (int)cudaGetLastError();
}

extern "C" int epilogue_stats(int dtype, int train, const float* partials,
                              int parts, const float* global, int C,
                              const float* weight, const float* shift,
                              float* running_mean, float* running_var,
                              float eps, float keep, float take, int update,
                              double n, float* stats, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == da::kBFloat16)
    stats_kernel<__nv_bfloat16><<<channel_blocks(C), kThreads, 0, s>>>(
        train, partials, parts, global, C, weight, shift, running_mean,
        running_var, eps, keep, take, update, n, stats);
  else
    stats_kernel<float><<<channel_blocks(C), kThreads, 0, s>>>(
        train, partials, parts, global, C, weight, shift, running_mean,
        running_var, eps, keep, take, update, n, stats);
  return (int)cudaGetLastError();
}

extern "C" int epilogue_apply(int dtype, int vec, int act, const void* y,
                              const float* bias, const float* stats,
                              void* out, long long nvox, int C, int rows,
                              int parts, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == da::kBFloat16) {
    const auto* yp = static_cast<const __nv_bfloat16*>(y);
    auto* op = static_cast<__nv_bfloat16*>(out);
    if (vec == 8)
      apply_kernel<__nv_bfloat16, 8><<<parts, kThreads, 0, s>>>(
          yp, bias, stats, act, op, nvox, C, rows);
    else
      apply_kernel<__nv_bfloat16, 1><<<parts, kThreads, 0, s>>>(
          yp, bias, stats, act, op, nvox, C, rows);
  } else {
    const auto* yp = static_cast<const float*>(y);
    auto* op = static_cast<float*>(out);
    if (vec == 4)
      apply_kernel<float, 4><<<parts, kThreads, 0, s>>>(yp, bias, stats, act,
                                                       op, nvox, C, rows);
    else
      apply_kernel<float, 1><<<parts, kThreads, 0, s>>>(yp, bias, stats, act,
                                                       op, nvox, C, rows);
  }
  return (int)cudaGetLastError();
}

extern "C" int epilogue_backward(int dtype, int vec, int act, int reduce,
                                 int write, const void* g, long long g_vs,
                                 const void* y, const float* bias,
                                 const float* stats, const float* coef,
                                 void* dx, float* partials, long long nvox,
                                 int C, int rows, int parts, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == da::kBFloat16)
    return vec == 8
               ? launch_backward<__nv_bfloat16, 8>(
                     reduce, write, g, g_vs, y, bias, stats, coef, act, dx,
                     partials, nvox, C, rows, parts, s)
               : launch_backward<__nv_bfloat16, 1>(
                     reduce, write, g, g_vs, y, bias, stats, coef, act, dx,
                     partials, nvox, C, rows, parts, s);
  return vec == 4 ? launch_backward<float, 4>(reduce, write, g, g_vs, y, bias,
                                              stats, coef, act, dx, partials,
                                              nvox, C, rows, parts, s)
                  : launch_backward<float, 1>(reduce, write, g, g_vs, y, bias,
                                              stats, coef, act, dx, partials,
                                              nvox, C, rows, parts, s);
}

extern "C" int epilogue_grads(int dtype, int mode, const float* partials,
                              int parts, const float* global, int C,
                              const float* stats, const float* weight,
                              double n_total, float* coef, float* dbias,
                              float* dweight, float* dshift, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == da::kBFloat16)
    grads_kernel<__nv_bfloat16><<<channel_blocks(C), kThreads, 0, s>>>(
        mode, partials, parts, global, C, stats, weight, n_total, coef, dbias,
        dweight, dshift);
  else
    grads_kernel<float><<<channel_blocks(C), kThreads, 0, s>>>(
        mode, partials, parts, global, C, stats, weight, n_total, coef, dbias,
        dweight, dshift);
  return (int)cudaGetLastError();
}
