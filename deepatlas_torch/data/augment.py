"""Random augmentation of a batch on its device: B-spline, rigid and blur.

Counterpart of ``deepatlas_tpu/data/augment.py``:

  * ``random_bspline_warp`` -- random control-point displacements of a
    cardinal B-spline (orders 1-3; ITK's ``BSplineTransform`` layout,
    default order 2) evaluated as three separable basis products, the image
    warped trilinearly and the labels by nearest neighbour.
  * ``random_rigid_warp``   -- random Euler rotation about the volume's
    centre plus a random translation, as an affine sampling grid.  The
    rotation acts on normalized coordinates, so on a non-cubic volume it is
    anisotropic in voxels, as in the JAX package.
  * ``gaussian_blur``       -- separable Gaussian, edge padding.

Every random function is a *draw* (a few numbers from an explicit CPU
``torch.Generator``) and a deterministic function of the draw that runs on
the batch's device: ``draw_bspline`` / ``bspline_field_from_ctrl``,
``draw_rigid`` / ``rigid_grid``, ``draw_blur`` / ``gaussian_blur``.
Angles are degrees, translations voxels; the normal draws have standard
deviation ``value / 2``.

Keys mirror the JAX package's: a key is a tuple of ints, ``fold_in(key,
i)`` appends ``i``, and ``key_generator(key)`` seeds a CPU generator from
it.  ``make_augmenter(config)(key, images, segs)`` draws element ``i`` of
the batch from ``fold_in(key, i)``.

The image warps run on the trilinear warp kernel (``kernels.grid_sample``,
unclamped), one launch over the whole batch per warp; the label warps are
``ops.warp_labels`` (nearest, round half to even).  A draw that is not
applied still warps, with the identity grid, and the blur is always
computed and then selected, as in the JAX package; the kernel's launch count
per batch is therefore fixed (one per enabled warp whose image is kept).
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops import identity_grid, normalize_displacement, warp_labels

Key = Tuple[int, ...]


def fold_in(key: Key, data: int) -> Key:
    """The key of ``data`` under ``key`` (``jax.random.fold_in``'s role)."""
    return tuple(key) + (int(data),)


def key_generator(key: Key) -> torch.Generator:
    """A CPU generator seeded from every int of ``key``."""
    state = np.random.SeedSequence([int(k) for k in key]).generate_state(
        2, dtype=np.uint32)
    gen = torch.Generator()
    gen.manual_seed(int(state[0]) | (int(state[1]) << 32))
    return gen


# ------------------------------------------------------------- B-spline

def _bspline_basis(t: torch.Tensor, order: int) -> torch.Tensor:
    """Cardinal (uniform) B-spline basis of degree ``order`` (support
    width order+1): B_1 the tent, B_2 the C^1 quadratic, B_3 the C^2
    cubic."""
    at = t.abs()
    zero = torch.zeros_like(at)
    if order == 1:
        return torch.clamp(1.0 - at, min=0.0)
    if order == 2:
        return torch.where(at <= 0.5, 0.75 - at ** 2,
                           torch.where(at <= 1.5, 0.5 * (at - 1.5) ** 2,
                                       zero))
    if order == 3:
        return torch.where(
            at <= 1.0, 2.0 / 3.0 - at ** 2 + at ** 3 / 2.0,
            torch.where(at <= 2.0, (2.0 - at) ** 3 / 6.0, zero))
    raise ValueError(f"bspline order must be 1, 2 or 3, got {order}")


def _bspline_axis_weights(size: int, cells: int, order: int,
                          device=None) -> torch.Tensor:
    """``(size, cells + order)`` float32 evaluation matrix of the basis:
    ``cells`` mesh cells span the axis, control point ``j`` sits at cell
    coordinate ``j - (order - 1) / 2`` (ITK's layout: every voxel lies in
    the full support of ``order + 1`` basis functions)."""
    u = torch.arange(size, dtype=torch.float32, device=device) \
        / max(size - 1, 1) * cells
    pos = torch.arange(cells + order, dtype=torch.float32, device=device) \
        - (order - 1) / 2.0
    return _bspline_basis(u[:, None] - pos[None, :], order)


def draw_bspline(gen: torch.Generator,
                 mesh_size: Sequence[int] = (3, 3, 3),
                 deform_scale: float = 1.0, ratio: float = 0.5,
                 freeze_axes: Sequence[int] = (), order: int = 2,
                 random_mode: str = "Normal"):
    """``(ctrl, apply)`` on the CPU: control-point displacements
    ``(mz + order, my + order, mx + order, 3)`` in voxels, last axis
    ``(x, y, z)``, from ``N(0, (deform_scale / 2)^2)`` (``"Normal"``) or
    ``U[0, deform_scale)`` (``"Uniform"``), the ``freeze_axes`` components
    zeroed; ``apply`` a bool, true with probability ``ratio``."""
    cpts = tuple(int(m) + order for m in mesh_size) + (3,)
    if random_mode == "Normal":
        ctrl = torch.randn(cpts, generator=gen) * (deform_scale / 2.0)
    elif random_mode == "Uniform":
        ctrl = torch.rand(cpts, generator=gen) * deform_scale
    else:
        raise ValueError(f"random_mode must be 'Normal' or 'Uniform', got "
                         f"{random_mode!r}")
    for axis in freeze_axes:
        ctrl[..., axis] = 0.0
    apply = torch.rand((), generator=gen) < ratio
    return ctrl, apply


def bspline_field_from_ctrl(ctrl: torch.Tensor,
                            vol_shape: Sequence[int],
                            mesh_size: Sequence[int] = (3, 3, 3),
                            order: int = 2) -> torch.Tensor:
    """Dense normalized displacement ``(..., D, H, W, 3)`` of the control
    grid ``ctrl`` ``(..., mz + order, my + order, mx + order, 3)`` (voxels),
    evaluated in float32 on ``ctrl``'s device as three separable products
    (``einsum("zi,yj,xk,ijkc->zyxc")``)."""
    wz, wy, wx = (_bspline_axis_weights(int(s), int(m), order, ctrl.device)
                  for s, m in zip(vol_shape, mesh_size))
    ctrl = ctrl.float()
    dense = torch.einsum("xk,...ijkc->...ijxc", wx, ctrl)
    dense = torch.einsum("yj,...ijxc->...iyxc", wy, dense)
    dense = torch.einsum("zi,...iyxc->...zyxc", wz, dense)
    return normalize_displacement(dense)


def random_bspline_field(gen: torch.Generator, vol_shape: Sequence[int],
                         mesh_size: Sequence[int] = (3, 3, 3),
                         deform_scale: float = 1.0,
                         freeze_axes: Sequence[int] = (), order: int = 2,
                         random_mode: str = "Normal",
                         device=None) -> torch.Tensor:
    """``(D, H, W, 3)`` normalized displacement of a random control grid
    (``draw_bspline``'s control points, ``bspline_field_from_ctrl``)."""
    ctrl, _ = draw_bspline(gen, mesh_size, deform_scale, 1.0, freeze_axes,
                           order, random_mode)
    return bspline_field_from_ctrl(ctrl.to(device), vol_shape, mesh_size,
                                   order)


def bspline_deform(ctrl: torch.Tensor, apply: torch.Tensor,
                   vol_shape: Sequence[int], mesh_size: Sequence[int],
                   order: int) -> torch.Tensor:
    """``(B, D, H, W, 3)`` sampling grids: the identity plus each
    element's field where ``apply`` ``(B,)`` holds, the identity alone
    where it does not."""
    disp = bspline_field_from_ctrl(ctrl, vol_shape, mesh_size, order)
    disp = torch.where(apply.view(-1, 1, 1, 1, 1), disp,
                       torch.zeros_like(disp))
    return disp + identity_grid(vol_shape, device=disp.device)


def _warp_pair(images: torch.Tensor, segs: Optional[torch.Tensor],
               deform: torch.Tensor, warp_image: bool = True):
    """Warp ``images`` ``(B, D, H, W, C)`` trilinearly on the warp kernel
    (one launch) and ``segs`` ``(B, D, H, W)`` by nearest neighbour at the
    grids ``deform`` ``(B, D, H, W, 3)``; ``segs`` None stays None, and
    ``warp_image`` False returns the images as they are."""
    from ..kernels import grid_sample

    warped_img = grid_sample(images.contiguous(), deform.contiguous(),
                             max_disp=None) if warp_image else images
    warped_seg = None if segs is None else warp_labels(segs, deform)
    return warped_img, warped_seg


def random_bspline_warp(gens: Sequence[torch.Generator],
                        images: torch.Tensor,
                        segs: Optional[torch.Tensor] = None,
                        mesh_size: Sequence[int] = (3, 3, 3),
                        deform_scale: float = 1.0, ratio: float = 0.5,
                        freeze_axes: Sequence[int] = (), order: int = 2,
                        random_mode: str = "Normal"):
    """Warp each element of ``images`` ``(B, D, H, W, C)`` (trilinear) and
    of ``segs`` ``(B, D, H, W)`` or None (nearest) by a random B-spline
    field with probability ``ratio``, element ``i`` drawn from
    ``gens[i]``."""
    draws = [draw_bspline(g, mesh_size, deform_scale, ratio, freeze_axes,
                          order, random_mode) for g in gens]
    ctrl = torch.stack([c for c, _ in draws]).to(images.device)
    apply = torch.stack([a for _, a in draws]).to(images.device)
    deform = bspline_deform(ctrl, apply, images.shape[1:4], mesh_size, order)
    return _warp_pair(images, segs, deform)


# ---------------------------------------------------------------- rigid

def _euler_matrix(rx: torch.Tensor, ry: torch.Tensor,
                  rz: torch.Tensor) -> torch.Tensor:
    """Rotation matrix ``Rz @ Ry @ Rx`` acting on ``(x, y, z)``
    coordinates; the angles are batched alike, ``(...,)`` to
    ``(..., 3, 3)``."""
    cx, sx = torch.cos(rx), torch.sin(rx)
    cy, sy = torch.cos(ry), torch.sin(ry)
    cz, sz = torch.cos(rz), torch.sin(rz)
    one, zero = torch.ones_like(rx), torch.zeros_like(rx)

    def mat(rows):
        return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)

    r_x = mat([[one, zero, zero], [zero, cx, -sx], [zero, sx, cx]])
    r_y = mat([[cy, zero, sy], [zero, one, zero], [-sy, zero, cy]])
    r_z = mat([[cz, -sz, zero], [sz, cz, zero], [zero, zero, one]])
    return r_z @ r_y @ r_x


def draw_rigid(gen: torch.Generator,
               rotation_angles: Sequence[float] = (0.0, 0.0, 0.0),
               translation: Sequence[float] = (0.0, 0.0, 0.0),
               ratio: float = 1.0):
    """``(angles_rad, trans_vox, apply)`` on the CPU: per-axis angles from
    ``N(0, (a / 2)^2)`` degrees in radians, translations from
    ``N(0, (t / 2)^2)`` voxels, both ``(3,)`` float32 ordered ``(x, y,
    z)``; ``apply`` a bool, true with probability ``ratio``."""
    angles = torch.randn(3, generator=gen) \
        * (torch.tensor(rotation_angles, dtype=torch.float32) / 2.0) \
        * (math.pi / 180.0)
    trans = torch.randn(3, generator=gen) \
        * (torch.tensor(translation, dtype=torch.float32) / 2.0)
    apply = torch.rand((), generator=gen) < ratio
    return angles, trans, apply


def rigid_grid(angles_rad: torch.Tensor, trans_vox: torch.Tensor,
               shape: Sequence[int]) -> torch.Tensor:
    """``(..., D, H, W, 3)`` sampling grid of a rotation about the volume's
    centre in normalized coordinates (``Rz @ Ry @ Rx`` of ``angles_rad``
    ``(..., 3)``) followed by the translation ``trans_vox`` ``(..., 3)`` in
    voxels, on the angles' device."""
    d, h, w = (int(n) for n in shape)
    grid = identity_grid((d, h, w), device=angles_rad.device)
    half = torch.tensor([(w - 1) / 2.0, (h - 1) / 2.0, (d - 1) / 2.0],
                        dtype=torch.float32, device=angles_rad.device)
    rot = _euler_matrix(angles_rad[..., 0], angles_rad[..., 1],
                        angles_rad[..., 2])
    rotated = torch.einsum("dhwc,...rc->...dhwr", grid, rot)
    shift = (trans_vox.float() / half)[..., None, None, None, :]
    return rotated + shift


def rigid_deform(angles_rad: torch.Tensor, trans_vox: torch.Tensor,
                 apply: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """``(B, D, H, W, 3)``: each element's rigid grid where ``apply``
    ``(B,)`` holds, the identity where it does not."""
    grid = rigid_grid(angles_rad, trans_vox, shape)
    return torch.where(apply.view(-1, 1, 1, 1, 1), grid,
                       identity_grid(shape, device=grid.device))


def _rigid_pair(images: torch.Tensor, segs: Optional[torch.Tensor],
                deform: torch.Tensor, mode: str):
    """``_warp_pair`` under a rigid ``mode``: ``"both"`` warps images and
    labels, ``"img"`` keeps the labels, ``"seg"`` keeps the images."""
    if mode not in ("both", "img", "seg"):
        raise ValueError(f"Wrong rigid transformation mode :{mode}!")
    warped_img, warped_seg = _warp_pair(
        images, segs if mode != "img" else None, deform,
        warp_image=mode != "seg")
    return warped_img, warped_seg if mode != "img" else segs


def random_rigid_warp(gens: Sequence[torch.Generator], images: torch.Tensor,
                      segs: Optional[torch.Tensor] = None,
                      rotation_angles: Sequence[float] = (0.0, 0.0, 0.0),
                      translation: Sequence[float] = (0.0, 0.0, 0.0),
                      ratio: float = 1.0, mode: str = "both"):
    """Random rigid resampling of each element with probability ``ratio``
    (element ``i`` drawn from ``gens[i]``) under ``mode`` (``_rigid_pair``).
    """
    draws = [draw_rigid(g, rotation_angles, translation, ratio)
             for g in gens]
    angles, trans, apply = (torch.stack(t).to(images.device)
                            for t in zip(*draws))
    deform = rigid_deform(angles, trans, apply, images.shape[1:4])
    return _rigid_pair(images, segs, deform, mode)


# ----------------------------------------------------------------- blur

def gaussian_blur(images: torch.Tensor, sigma: float = 0.7,
                  truncate: float = 2.0) -> torch.Tensor:
    """Separable Gaussian blur of ``(B, D, H, W, C)`` volumes over D, H and
    W: radius ``max(1, int(truncate * sigma + 0.5))``, edge padding, three
    1-D passes of float32 products added tap by tap."""
    radius = max(1, int(truncate * sigma + 0.5))
    offs = torch.arange(-radius, radius + 1, dtype=torch.float32)
    kern = torch.exp(-0.5 * (offs / sigma) ** 2)
    kern = (kern / kern.sum()).tolist()
    out = images
    for axis in (1, 2, 3):
        n = out.shape[axis]
        padded = torch.cat(
            [out.narrow(axis, 0, 1).repeat_interleave(radius, dim=axis), out,
             out.narrow(axis, n - 1, 1).repeat_interleave(radius, dim=axis)],
            dim=axis)
        acc = None
        for k, wk in enumerate(kern):
            term = padded.narrow(axis, k, n) * wk
            acc = term if acc is None else acc + term
        out = acc
    return out


def draw_blur(gen: torch.Generator, ratio: float = 1.0) -> torch.Tensor:
    """Whether to blur: a bool, true with probability ``ratio``."""
    return torch.rand((), generator=gen) < ratio


# ------------------------------------------------------------ augmenter

class Augmenter:
    """The config's augmentations over a batch, element ``i`` drawn from
    ``fold_in(key, i)`` (its B-spline from sub-key 0, rigid from 1, blur
    from 2).  ``draw`` and ``apply`` split a call into the CPU draws and
    the device work."""

    def __init__(self, config: dict):
        self.bspline = config.get("bspline")
        self.rigid = config.get("rigid")
        self.blur = config.get("blur")
        if self.bspline:
            b = self.bspline
            self.bspline_args = dict(
                mesh_size=tuple(b.get("mesh_size", (3, 3, 3))),
                deform_scale=b.get("deform_scale", 1.0),
                ratio=b.get("ratio", 0.5),
                freeze_axes=tuple(b.get("freeze_axes", ())),
                order=b.get("order", b.get("bspline_order", 2)),
                random_mode=b.get("random_mode", "Normal"))
        if self.rigid:
            r = self.rigid
            self.rigid_args = dict(
                rotation_angles=tuple(r.get("rotation_angles",
                                            (0.0, 0.0, 0.0))),
                translation=tuple(r.get("translation", (0.0, 0.0, 0.0))),
                ratio=r.get("ratio", 1.0))
            self.rigid_mode = r.get("mode", "both")
        if self.blur:
            self.sigma = self.blur.get("sigma", 0.7)
            self.blur_ratio = self.blur.get("ratio", 1.0)

    def draw(self, key: Key, batch: int) -> Dict[str, Tuple[torch.Tensor,
                                                             ...]]:
        """The batch's draws, stacked on the CPU."""
        out = {}
        keys = [fold_in(key, i) for i in range(batch)]
        if self.bspline:
            draws = [draw_bspline(key_generator(fold_in(k, 0)),
                                  **self.bspline_args) for k in keys]
            out["bspline"] = tuple(torch.stack(t) for t in zip(*draws))
        if self.rigid:
            draws = [draw_rigid(key_generator(fold_in(k, 1)),
                                **self.rigid_args) for k in keys]
            out["rigid"] = tuple(torch.stack(t) for t in zip(*draws))
        if self.blur:
            out["blur"] = (torch.stack(
                [draw_blur(key_generator(fold_in(k, 2)), self.blur_ratio)
                 for k in keys]),)
        return out

    def apply(self, draws, images: torch.Tensor,
              segs: Optional[torch.Tensor] = None):
        """The augmentations of ``draws`` on the batch's device, without
        autograd."""
        dev = images.device
        shape = images.shape[1:4]
        with torch.no_grad():
            if self.bspline:
                ctrl, apply = (t.to(dev) for t in draws["bspline"])
                deform = bspline_deform(ctrl, apply, shape,
                                        self.bspline_args["mesh_size"],
                                        self.bspline_args["order"])
                images, segs = _warp_pair(images, segs, deform)
            if self.rigid:
                angles, trans, apply = (t.to(dev) for t in draws["rigid"])
                deform = rigid_deform(angles, trans, apply, shape)
                images, segs = _rigid_pair(images, segs, deform,
                                           self.rigid_mode)
            if self.blur:
                (apply,) = (t.to(dev) for t in draws["blur"])
                blurred = gaussian_blur(images, sigma=self.sigma)
                images = torch.where(apply.view(-1, 1, 1, 1, 1), blurred,
                                     images)
        return images, segs

    def __call__(self, key: Key, images: torch.Tensor,
                 segs: Optional[torch.Tensor] = None):
        return self.apply(self.draw(key, images.shape[0]), images, segs)


def make_augmenter(config: Optional[dict]) -> Optional[Augmenter]:
    """Config-driven batch augmenter for the experiments, e.g.::

        {"bspline": {"mesh_size": [3, 3, 3], "deform_scale": 2.0,
                     "ratio": 0.5},
         "rigid":   {"rotation_angles": [5, 5, 5],
                     "translation": [2, 2, 2], "ratio": 0.5,
                     "mode": "both"},
         "blur":    {"sigma": 0.7, "ratio": 0.3}}

    Returns ``augment(key, images (B,D,H,W,C), segs (B,D,H,W) | None) ->
    (images, segs)`` (an ``Augmenter``), or ``None`` when the config is
    empty or falsy.  ``bspline`` takes ``order`` (or ``bspline_order``,
    default 2), ``freeze_axes`` and ``random_mode`` too."""
    if not config:
        return None
    return Augmenter(config)


__all__ = ["Augmenter", "bspline_deform", "bspline_field_from_ctrl",
           "draw_blur", "draw_bspline", "draw_rigid", "fold_in",
           "gaussian_blur", "key_generator", "make_augmenter",
           "random_bspline_field", "random_bspline_warp",
           "random_rigid_warp", "rigid_deform", "rigid_grid"]
