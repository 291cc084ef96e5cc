"""The one-card block mesh (port of ``parallel/mesh.py``).

The JAX package decomposes a level over a `jax.sharding.Mesh` of devices.
The port's counterpart is a `BlockMesh`: the same (mx, my, mz) block
decomposition, over ONE device.  Tensors stay global on that device;
only the two block-mesh kernels (`parallel.fused_sharded`) cut a level
into haloed blocks.  So a block mesh on one card is what the JAX tests'
virtual 8-device CPU mesh is: the sharded schedule, with its halo
redundancy, on one device -- not a speed-up.  A mesh over several cards
(torch.distributed with NCCL) is not ported yet: `make_mesh` refuses
devices on more than one card.

`constrain_grid` (a GSPMD sharding constraint) has no counterpart on one
card: there is nothing to constrain, every tensor is whole on the device.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from geometricmultigridpressuresolver_tpu_torch import device as device_mod


@dataclasses.dataclass(frozen=True)
class BlockMesh:
    """An (mx, my, mz) block decomposition over one device."""

    shape: tuple[int, int, int]
    device: torch.device

    @property
    def size(self) -> int:
        return math.prod(self.shape)


def factor_mesh(n: int) -> tuple[int, int, int]:
    """Factor a block count into a near-cubic 3-D mesh shape.

    Greedy: repeatedly assign the largest prime factor to the currently
    smallest mesh axis.  8 -> (2, 2, 2), 4 -> (2, 2, 1), 6 -> (3, 2, 1).
    """
    factors = []
    m = n
    d = 2
    while d * d <= m:
        while m % d == 0:
            factors.append(d)
            m //= d
        d += 1
    if m > 1:
        factors.append(m)
    shape = [1, 1, 1]
    for f in sorted(factors, reverse=True):
        shape[shape.index(min(shape))] *= f
    return tuple(sorted(shape, reverse=True))


def make_mesh(n_blocks: int, device=None) -> BlockMesh:
    """A `factor_mesh(n_blocks)` block mesh on `device` (default: the card).

    `device` may be one device or a sequence of them; devices on more than
    one card raise NotImplementedError (the multi-card mesh is not ported).
    """
    if isinstance(device, (list, tuple)):
        devices = {torch.device(d) for d in device}
        if len(devices) > 1:
            raise NotImplementedError(
                "a block mesh over several devices is not ported yet: "
                "the port's BlockMesh holds one device"
            )
        device = next(iter(devices)) if devices else None
    return BlockMesh(factor_mesh(n_blocks), device_mod.resolve(device))


def grid_split(mesh: BlockMesh, shape, min_per_device: int = 8) -> tuple[bool, bool, bool]:
    """Which axes of a cell grid the mesh splits (``grid_pspec``'s rule):
    an axis is split over its mesh axis unless it does not divide or its
    blocks would drop below `min_per_device` cells (coarse levels are
    cheaper whole than cut)."""
    return tuple(
        m > 1 and n % m == 0 and n // m >= min_per_device
        for n, m in zip(shape, mesh.shape)
    )
