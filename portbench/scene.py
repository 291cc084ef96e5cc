"""The inputs of a cell, made on the device from the seed.

The flipSplash pool and drop of a configuration file (the scene of the
port's `models/sdf.py`, written here again so that the inputs are the
benchmark's and not the program's): the liquid SDF, the MAC velocity (the
drop falls at 1, the x component is 0.3 sin(2 pi x)) and the open box's
cut-cell weights.  The seed moves the drop's centre by whole cells along x
and z, so every seed has the same sizes; the projection traffic adds
smooth divergent fields with seeded phases to the velocity.
"""

from __future__ import annotations

import math
import random
from typing import NamedTuple

import torch


class Scene(NamedTuple):
    phi: torch.Tensor
    velocity: tuple
    weights: tuple


def _centers(n: int, shift: float, dx: float, device, dtype):
    return (torch.arange(n, dtype=dtype, device=device) + shift) * dx


def drop_center(scene: dict, grid, seed: int) -> tuple:
    """The drop's centre for `seed`: the file's centre moved by whole cells
    along x and z, at most `drop_shift_cells` each way."""
    rng = random.Random(seed)
    dx = 1.0 / max(grid)
    shift = int(scene["drop_shift_cells"])
    cx, cy, cz = scene["drop_center"]
    return (cx + rng.randint(-shift, shift) * dx, cy, cz + rng.randint(-shift, shift) * dx)


def make(config: dict, seed: int, device, dtype=torch.float32, grid=None) -> Scene:
    """The configuration's scene at `grid` (default: the file's) for `seed`."""
    grid = tuple(grid or config["grid"])
    scene = config["scene"]
    dx = 1.0 / max(grid)
    center = drop_center(scene, grid, seed)
    radius, height = scene["drop_radius"], scene["pool_height"]
    x, y, z = (_centers(n, 0.5, dx, device, dtype) for n in grid)
    sphere = torch.sqrt((x[:, None, None] - center[0]) ** 2 + (y[None, :, None] - center[1]) ** 2
                        + (z[None, None, :] - center[2]) ** 2) - radius
    phi = torch.minimum(y[None, :, None] - height, sphere)
    velocity, weights = [], []
    for axis in range(3):
        coords = [_centers(grid[a] + (a == axis), 0.0 if a == axis else 0.5, dx, device, dtype)
                  for a in range(3)]
        shape = tuple(c.numel() for c in coords)
        if axis == 0:
            v = (0.3 * torch.sin(2.0 * math.pi * coords[0]))[:, None, None].expand(shape).contiguous()
        elif axis == 1:
            gx, gy, gz = coords
            inside = ((gx[:, None, None] - center[0]) ** 2 + (gy[None, :, None] - center[1]) ** 2
                      + (gz[None, None, :] - center[2]) ** 2).sqrt() - radius <= 0
            v = torch.where(inside, -1.0, 0.0).to(dtype)
        else:
            v = torch.zeros(shape, dtype=dtype, device=device)
        velocity.append(v)
        w = torch.ones(shape, dtype=dtype, device=device)
        index = [slice(None)] * 3
        for edge in (0, -1):
            index[axis] = edge
            w[tuple(index)] = 0.0
        weights.append(w)
    return Scene(phi, tuple(velocity), tuple(weights))


def perturbed(velocity, count: int, amplitude: float, max_frequency: int, seed: int) -> list:
    """`count` velocity fields: `velocity` plus, per component, a product
    of three sines whose phases are drawn on the device from `seed`.
    Field k's component c takes the (3k + c)-th triple of integer
    frequencies 1..`max_frequency` in order: the same set for every seed."""
    device = velocity[0].device
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    out = []
    for k in range(count):
        fields = []
        for c, v in enumerate(velocity):
            code = (3 * k + c) % max_frequency ** 3
            freq = [1 + (code // max_frequency ** a) % max_frequency for a in range(3)]
            phase = torch.rand(3, generator=gen, device=device, dtype=v.dtype) * (2 * math.pi)
            factors = []
            for a, n in enumerate(v.shape):
                t = torch.arange(n, dtype=v.dtype, device=device) / n
                factors.append(torch.sin(2 * math.pi * freq[a] * t + phase[a]))
            fields.append(v + amplitude * factors[0][:, None, None] * factors[1][None, :, None]
                          * factors[2][None, None, :])
        out.append(tuple(fields))
    return out
