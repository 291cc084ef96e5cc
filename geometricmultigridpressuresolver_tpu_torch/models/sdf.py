"""Synthetic signed-distance fields and cut-cell face weights (torch).

Port of ``models/sdf.py``: scene generators that build their fields
directly on `device` (the 256^3 scene is made on the card).  Conventions:

  * liquid SDF `phi`: cell-centered, <= 0 inside the liquid;
  * solid SDF: >= 0 inside the solid;
  * cut-cell weight: fraction of a face open to fluid, in [0, 1]; weights
    below `clamp` become 0 and domain-boundary faces are closed.
"""

from __future__ import annotations

import math

import torch

from geometricmultigridpressuresolver_tpu_torch.grids import face_shape


def cell_centers(shape, dx: float | None = None, device=None, dtype=torch.float64):
    """Cell-center coordinates in [0,1]^3 (dx = 1/max(shape) by default)."""
    if dx is None:
        dx = 1.0 / max(shape)
    axes = [(torch.arange(s, dtype=dtype, device=device) + 0.5) * dx for s in shape]
    return torch.meshgrid(*axes, indexing="ij"), dx


def sphere_sdf(points, center, radius):
    x, y, z = points
    return torch.sqrt(
        (x - center[0]) ** 2 + (y - center[1]) ** 2 + (z - center[2]) ** 2
    ) - radius


def pool_sdf(points, height):
    """Liquid pool filling the domain below `height` (phi <= 0 in liquid)."""
    return points[1] - height


def splash_scene(
    shape,
    pool_height=0.35,
    drop_center=(0.5, 0.7, 0.5),
    drop_radius=0.15,
    device=None,
    dtype=torch.float64,
):
    """A pool plus a falling liquid drop.  Returns (liquid_phi, velocity):
    the drop moves down with a jump at its surface, and the x-component is
    compressive, so the velocity has nonzero divergence in the liquid."""
    points, dx = cell_centers(shape, device=device, dtype=dtype)
    liquid_phi = torch.minimum(
        pool_sdf(points, pool_height), sphere_sdf(points, drop_center, drop_radius)
    )
    velocity = []
    for axis in range(3):
        coords = []
        for a in range(3):
            n = shape[a] + (1 if a == axis else 0)
            offset = 0.0 if a == axis else 0.5
            coords.append((torch.arange(n, dtype=dtype, device=device) + offset) * dx)
        gx, gy, gz = torch.meshgrid(*coords, indexing="ij")
        if axis == 0:
            v = 0.3 * torch.sin(2.0 * math.pi * gx)
        elif axis == 1:
            inside = sphere_sdf((gx, gy, gz), drop_center, drop_radius) <= 0
            v = torch.where(inside, -1.0, 0.0).to(dtype)
        else:
            v = torch.zeros(face_shape(shape, axis), dtype=dtype, device=device)
        velocity.append(v)
    return liquid_phi, velocity


def face_weights_from_solid(
    solid_fn, shape, dx: float | None = None, clamp: float = 0.01,
    samples: int = 4, device=None, dtype=torch.float64,
):
    """Cut-cell face weights: fraction of `samples x samples` points on each
    face with solid_fn < 0; below `clamp` -> 0; domain-boundary faces 0."""
    if dx is None:
        dx = 1.0 / max(shape)
    offsets = [(o + 0.5) / samples for o in range(samples)]
    weights = []
    for axis in range(3):
        fshape = face_shape(shape, axis)
        coords = [torch.arange(fshape[a], dtype=dtype, device=device) * dx for a in range(3)]
        w = torch.zeros(fshape, dtype=dtype, device=device)
        tangent = [a for a in range(3) if a != axis]
        for o1 in offsets:
            for o2 in offsets:
                shift = [0.0, 0.0, 0.0]
                shift[tangent[0]] = o1 * dx
                shift[tangent[1]] = o2 * dx
                grid = torch.meshgrid(
                    coords[0] + shift[0], coords[1] + shift[1], coords[2] + shift[2],
                    indexing="ij",
                )
                w = w + (solid_fn(grid) < 0).to(dtype)
        w = w / (samples * samples)
        w = torch.where(w < clamp, 0.0, w)
        edge = [slice(None)] * 3
        edge[axis] = 0
        w[tuple(edge)] = 0.0
        edge[axis] = -1
        w[tuple(edge)] = 0.0
        weights.append(w)
    return weights


def open_box_weights(shape, device=None, dtype=torch.float64):
    """Unit weights everywhere except closed domain-boundary faces."""
    return face_weights_from_solid(
        lambda pts: torch.full_like(pts[0], -1.0), shape, samples=1,
        device=device, dtype=dtype,
    )
