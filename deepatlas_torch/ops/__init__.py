"""Tensor ops shared by the models, the losses and the metrics."""
from .grid import identity_grid, identity_grid_batch, normalize_displacement
from .onehot import one_hot
from .resize import nearest_resize, trilinear_resize
from .warp import (clamp_displacement, displacement_overflow, grid_sample,
                   warp, warp_labels, warp_values_adjoint)
from .window import window_sum

__all__ = ["clamp_displacement", "displacement_overflow", "grid_sample",
           "identity_grid", "identity_grid_batch", "nearest_resize",
           "normalize_displacement", "one_hot", "trilinear_resize", "warp",
           "warp_labels", "warp_values_adjoint", "window_sum"]
