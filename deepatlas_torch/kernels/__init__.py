"""Hand-written CUDA kernels for Hopper (``sm_90a``), one module per TPU
kernel family, each with its plain PyTorch version and a launch counter.

Sources live in ``csrc/`` and are built at first use (``build.py``);
importing this package builds nothing and works without ``nvcc``.
"""
from __future__ import annotations

from typing import Dict

from .anatomy import (binned_sum, hard_anatomy_dice, matched_grid_grad,
                      matched_grid_grad_plain, matched_warp,
                      matched_warp_fused, matched_warp_fused_plain,
                      matched_warp_plain)
from .block_epilogue import block_epilogue, block_epilogue_plain
from .conv3d import (conv3d_k3, conv3d_k3_block, conv3d_k3_block_plain,
                     conv3d_k3_input_grad, conv3d_k3_input_grad_plain,
                     conv3d_k3_plain, conv3d_k3_wgrad, conv3d_k3_wgrad_plain,
                     conv3d_point, conv3d_point_plain, pack_k3_weights,
                     pack_mix_weights, parity_tap_table)
from .deconv3d import deconv2x, deconv2x_plain, nearest_up2x
from .warp import (grid_sample, splat_ones, splat_trilinear,
                   splat_trilinear_plain, warp_grid_grad,
                   warp_grid_grad_plain, warp_trilinear, warp_trilinear_plain)
from .warp_lncc import warp_lncc_loss

# wrapper -> its plain version, in the order a training step of the U-Net,
# one of VoxelMorph and then the joint training first launch them
# (matched_grid_grad is the backward of matched_warp, which the joint
# training never differentiates; conv3d_k3_block, the multi-plane k3
# forward, runs in the block-conv microbench, on no model path), then the
# block epilogue, which follows every conv and deconv block and came from
# no TPU kernel
KERNELS = {
    "conv3d_k3": (conv3d_k3, conv3d_k3_plain),
    "deconv2x": (deconv2x, deconv2x_plain),
    "conv3d_point": (conv3d_point, conv3d_point_plain),
    "conv3d_k3_wgrad": (conv3d_k3_wgrad, conv3d_k3_wgrad_plain),
    "warp_trilinear": (warp_trilinear, warp_trilinear_plain),
    "warp_grid_grad": (warp_grid_grad, warp_grid_grad_plain),
    "splat_trilinear": (splat_trilinear, splat_trilinear_plain),
    "matched_warp_fused": (matched_warp_fused, matched_warp_fused_plain),
    "matched_warp": (matched_warp, matched_warp_plain),
    "matched_grid_grad": (matched_grid_grad, matched_grid_grad_plain),
    "conv3d_k3_block": (conv3d_k3_block, conv3d_k3_block_plain),
    "block_epilogue": (block_epilogue, block_epilogue_plain),
}


def launch_counts() -> Dict[str, int]:
    """Kernel launches per wrapper since the last reset."""
    return {name: fn.launches for name, (fn, _) in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn, _ in KERNELS.values():
        fn.launches = 0


__all__ = ["KERNELS", "binned_sum", "block_epilogue", "block_epilogue_plain",
           "conv3d_k3", "conv3d_k3_block", "conv3d_k3_block_plain",
           "conv3d_k3_input_grad", "conv3d_k3_input_grad_plain",
           "conv3d_k3_plain",
           "conv3d_k3_wgrad", "conv3d_k3_wgrad_plain", "conv3d_point",
           "conv3d_point_plain", "deconv2x", "deconv2x_plain", "grid_sample",
           "hard_anatomy_dice", "launch_counts", "matched_grid_grad",
           "matched_grid_grad_plain", "matched_warp", "matched_warp_fused",
           "matched_warp_fused_plain", "matched_warp_plain", "nearest_up2x",
           "pack_k3_weights", "pack_mix_weights", "parity_tap_table",
           "reset_launch_counts", "splat_ones", "splat_trilinear",
           "splat_trilinear_plain",
           "warp_grid_grad", "warp_grid_grad_plain", "warp_lncc_loss",
           "warp_trilinear", "warp_trilinear_plain"]
