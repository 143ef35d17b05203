"""Operations and bytes a kernel call needs, and its least time on the card.

A frozen copy of the port's proof script's ``work`` / ``bound_ms`` and
``warp_bytes``: each input read once, each output written once, weights as
the float32 the kernels read, against the published peaks of ``peaks``.  A
later change to the program leaves these numbers alone; only the measured
time moves.
"""
from __future__ import annotations

from .peaks import HBM_BYTES_PER_S, PEAK_FLOPS


def work(kernel, n, cin, cout, dtype_name, n_out=None, role=""):
    """(flops, bytes) on ``n`` input voxels (and, for a strided k3 conv,
    ``n_out`` output voxels).  Role ``dx_s2``, a strided conv's input
    gradient: ``n`` voxels of ``cout`` channels are written from ``n_out``
    voxels of ``cin`` channels of upstream gradient."""
    s = 2 if dtype_name == "bfloat16" else 4
    if role == "dx_s2":
        return 2 * 27 * cin * cout * n_out, n_out * cin * s \
            + 27 * cin * cout * 4 + n * cout * s
    if kernel in ("conv3d_k3", "conv3d_k3_wgrad"):
        n_out = n if n_out is None else n_out
        return 2 * 27 * cin * cout * n_out, n * cin * s \
            + 27 * cin * cout * 4 + n_out * cout * s
    if kernel == "conv3d_point":
        return 2 * cin * cout * n, n * cin * s + cin * cout * 4 + n * cout * s
    # deconv2x: k2 s2, n input voxels, 8 n outputs
    return 2 * 8 * cin * cout * n, n * cin * s + 8 * cin * cout * 4 \
        + 8 * n * cout * s


def warp_bytes(kernel, n, c, elem):
    """Bytes on ``n`` sample points: 12 of coordinates per point; the warp
    reads one value of the volume and writes one per point and channel; the
    grid gradient reads the volume and the upstream gradient and writes 12;
    the splat reads the upstream gradient and writes its float32 volume
    once; the splat of ones reads the coordinates and writes one float32
    count."""
    if kernel == "warp_trilinear":
        return n * (12 + 2 * elem * c)
    if kernel == "warp_grid_grad":
        return n * (12 + 2 * elem * c + 12)
    if kernel == "splat_ones":
        return n * (12 + 4)
    return n * (12 + elem * c + 4 * c)


def bound_s(flops, nbytes, dtype_name="bfloat16"):
    """The least seconds: the larger of operations over the peak rate and
    bytes over the peak bandwidth."""
    return max(flops / PEAK_FLOPS[dtype_name], nbytes / HBM_BYTES_PER_S)
