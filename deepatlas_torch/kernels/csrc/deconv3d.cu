// ConvTranspose3d kernel 2, stride 2 on channel-last (B, D, H, W, C), for
// sm_90a.
//
// Replaces the TPU kernel deepatlas_tpu/pallas/deconv3d.py::_deconv_kernel
// (whose four-way block bank and row interleave exist only for the packed
// (D, H, W*C) lane layout).  Kernel == stride means no output overlap:
//
//   y[b, 2d+a, 2h+p, 2w+q, :] = x[b, d, h, w, :] @ w[a, p, q]   (+ bias)
//
// with w in (2, 2, 2, Cin, Cout) layout, i.e. the 8-tap channel mix of
// channel_mix.cuh with an output index that interleaves the taps into the
// doubled grid.  2*8*Cin*Cout flops per input voxel against
// 2*(Cin + 8*Cout) bytes: at the U-Net's widths the kernel is bound by the
// bytes it writes.
//
// x in float32 or bfloat16, weights and bias in float32, float32
// accumulation, output in x's type.  Returns cudaGetLastError().
#include "channel_mix.cuh"

namespace {

// Tap t = (a, p, q) of input voxel v lands at (2d+a, 2h+p, 2w+q).
struct Upsample2x {
  int D, H, W;
  __device__ __forceinline__ int64_t operator()(int64_t v, int t) const {
    const int iw = (int)(v % W);
    v /= W;
    const int ih = (int)(v % H);
    v /= H;
    const int id = (int)(v % D);
    const int64_t ib = v / D;
    const int a = t >> 2, p = (t >> 1) & 1, q = t & 1;
    return ((ib * 2 * D + 2 * id + a) * 2 * H + 2 * ih + p) * 2 * W +
           2 * iw + q;
  }
};

}  // namespace

extern "C" int deconv2x(int dtype, const void* x, const void* w,
                        const void* bias, void* y, int B, int D, int H, int W,
                        int Cin, int Cout, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t nvox = (int64_t)B * D * H * W;
  const Upsample2x out{D, H, W};
  if (dtype == da::kBFloat16)
    da::launch_channel_mix<__nv_bfloat16, 8>(x, w, bias, y, nvox, Cin, Cout,
                                             out, s);
  else
    da::launch_channel_mix<float, 8>(x, w, bias, y, nvox, Cin, Cout, out, s);
  return (int)cudaGetLastError();
}
