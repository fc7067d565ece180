"""Periodic, optionally xy-tilted (sheared) simulation box.

PyTorch counterpart of ``pse_tpu/box.py``: a centered orthorhombic box with
an ``xy`` tilt factor (linear shear, gradient along y, flow along x),
fractional coordinates, minimum image and image-tracked wrapping.

``Box`` holds host scalars, rounded to float32 once, so that every tensor
expression below computes in float32 exactly as the JAX package does with
its float32 box arrays.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


def _f32(x) -> float:
    return float(np.float32(x))


class Box(NamedTuple):
    """Centered triclinic box with xy tilt only.

    L: (Lx, Ly, Lz) edge lengths; tilt_xy: x shift per unit y (HOOMD
    convention: shift = tilt_xy * Ly over the full box height).  Both are
    float32-representable Python floats."""

    L: tuple
    tilt_xy: float

    @property
    def lo(self) -> tuple:
        return tuple(-x / 2.0 for x in self.L)


def make_box(L, tilt_xy=0.0) -> Box:
    """Create a Box. ``L`` may be a scalar (cubic) or length-3 sequence."""
    if np.isscalar(L):
        L = (L, L, L)
    return Box(tuple(_f32(x) for x in L), _f32(tilt_xy))


def make_fraction(box: Box, pos: torch.Tensor) -> torch.Tensor:
    """Fractional coordinates (HOOMD BoxDim::makeFraction, xy tilt):
    f_x = (x - lo_x - xy*y)/Lx, f_y = (y - lo_y)/Ly, f_z = (z - lo_z)/Lz."""
    L, lo = box.L, box.lo
    fx = (pos[..., 0] - lo[0] - box.tilt_xy * pos[..., 1]) / L[0]
    fy = (pos[..., 1] - lo[1]) / L[1]
    fz = (pos[..., 2] - lo[2]) / L[2]
    return torch.stack([fx, fy, fz], dim=-1)


def min_image_components(box: Box, dx, dy, dz):
    """Component-wise minimum image: wrap z, then y (adjusting x by the
    tilt), then x (HOOMD BoxDim::minImage with xz = yz = 0)."""
    L = box.L
    dz = dz - L[2] * torch.round(dz / L[2])
    img_y = torch.round(dy / L[1])
    dy = dy - L[1] * img_y
    dx = dx - box.tilt_xy * L[1] * img_y
    dx = dx - L[0] * torch.round(dx / L[0])
    return dx, dy, dz


def min_image(box: Box, dr: torch.Tensor) -> torch.Tensor:
    """Minimum-image displacement vector(s) for an xy-tilted box."""
    return torch.stack(
        min_image_components(box, dr[..., 0], dr[..., 1], dr[..., 2]), dim=-1
    )


def wrap(box: Box, pos: torch.Tensor, images: torch.Tensor):
    """Wrap positions into the box, tracking image flags; handles any
    excursion via floor().  Returns (wrapped_pos, updated_images)."""
    L, lo = box.L, box.lo
    x, y, z = pos[..., 0], pos[..., 1], pos[..., 2]

    sz = torch.floor((z - lo[2]) / L[2]).to(torch.int32)
    z = z - L[2] * sz.to(pos.dtype)

    sy = torch.floor((y - lo[1]) / L[1]).to(torch.int32)
    y = y - L[1] * sy.to(pos.dtype)
    x = x - box.tilt_xy * L[1] * sy.to(pos.dtype)

    sx = torch.floor((x - lo[0] - box.tilt_xy * y) / L[0]).to(torch.int32)
    x = x - L[0] * sx.to(pos.dtype)

    new_pos = torch.stack([x, y, z], dim=-1)
    new_images = images + torch.stack([sx, sy, sz], dim=-1)
    return new_pos, new_images


def unwrap(box: Box, pos: torch.Tensor, images: torch.Tensor) -> torch.Tensor:
    """Unwrapped coordinates from wrapped positions and image flags."""
    L = box.L
    img = images.to(pos.dtype)
    x = pos[..., 0] + L[0] * img[..., 0] + box.tilt_xy * L[1] * img[..., 1]
    y = pos[..., 1] + L[1] * img[..., 1]
    z = pos[..., 2] + L[2] * img[..., 2]
    return torch.stack([x, y, z], dim=-1)
