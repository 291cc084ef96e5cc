"""Meshes of the decomposed solve (port of ``parallel/mesh.py``).

The JAX package decomposes a level over a `jax.sharding.Mesh` of devices.
The port has two counterparts, both the same (mx, my, mz) block
decomposition in JAX's row-major device order:

  * `BlockMesh`: over ONE device.  Tensors stay global on that device;
    only the two block-mesh kernels (`parallel.fused_sharded`) cut a level
    into haloed blocks.  So a block mesh on one card is what the JAX tests'
    virtual 8-device CPU mesh is: the sharded schedule, with its halo
    redundancy, on one device -- not a speed-up.  `make_mesh` builds one
    and refuses devices on more than one card.
  * `DistMesh`: over PROCESSES (torch.distributed), one rank per device.
    Each rank holds only its blocks of the levels the mesh splits and
    exchanges halos and dot partials with the other ranks
    (`parallel.distributed`, built by `distributed.initialize` /
    `global_mesh`).

`constrain_grid` (a GSPMD sharding constraint inside a traced setup
program) has no counterpart: the port has no partitioner to steer.  On a
`BlockMesh` every tensor is whole on its device; on a `DistMesh` the
partitioned build (`parallel.sharding.partitioned_setup`) computes each
level on the rank's block grown by the halo the next step reads and cuts
the core, so no rank ever holds a whole split grid.

Boxes.  A box is a tuple of three ``(lo, hi)`` pairs in a grid's global
index space: a rank's block (`block_box`), the block grown by a halo and
clipped at the grid's edges (`grow_box`), their intersections
(`intersect`).  The multigrid window maps onto the base grid as JAX's
``_window_static`` does: window cell j is base cell ``start - pad_lo + j``
(`window_offset`, `shift_box`), cells outside the base taking a fill
value.  All of them are pure, so every rank's boxes can be checked
without starting a world.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Sequence

import numpy as np
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


@dataclasses.dataclass
class CommStats:
    """What a rank's collectives cost since the last `reset`: halo
    exchanges (calls of `halo.exchange_halos`) and their seconds, the
    seconds spent packing the slabs (the strided y slabs' copies), the
    bytes copied between the card and pinned host buffers for gloo, the
    box moves (`distributed.redistribute`) with their seconds, and the
    ordered collectives (`distributed.ordered_sum`, `gather_blocks`, ...)
    with their seconds.  Each timer is a host clock between two device
    syncs, so it holds its own work and none of the kernels queued before
    it (the syncs cost a host stall per call under NCCL; under gloo the
    staging copies wait for the card anyway)."""

    exchanges: int = 0
    exchange_s: float = 0.0
    pack_s: float = 0.0
    bytes_staged: int = 0
    redistributes: int = 0
    redistribute_s: float = 0.0
    collectives: int = 0
    collective_s: float = 0.0

    def reset(self) -> None:
        for f in dataclasses.fields(self):
            setattr(self, f.name, f.default)


@dataclasses.dataclass(frozen=True)
class DistMesh:
    """An (mx, my, mz) mesh of torch.distributed ranks, this process being
    `rank` (coordinates `coords`, JAX's row-major device order) on
    `device`.  `backend` is the process group's ("nccl" or "gloo"); under
    gloo, CUDA tensors are staged through pinned host buffers.  `stats`
    counts this rank's communication."""

    shape: tuple[int, int, int]
    rank: int
    device: torch.device
    backend: str
    group: Any = dataclasses.field(default=None, compare=False)
    stats: CommStats = dataclasses.field(default_factory=CommStats, compare=False)

    @property
    def size(self) -> int:
        return math.prod(self.shape)

    @property
    def coords(self) -> tuple[int, int, int]:
        return tuple(int(c) for c in np.unravel_index(self.rank, self.shape))

    def rank_at(self, coords) -> int:
        """The rank at mesh coordinates `coords`."""
        return int(np.ravel_multi_index(tuple(coords), self.shape))

    def owns(self, split) -> bool:
        """Whether this rank owns its block of a grid split on the axes
        `split`: ranks whose blocks are equal (they differ only along mesh
        axes the grid does not split) elect the lowest rank, the one at
        coordinate 0 on every unsplit axis (JAX
        `distributed.host_local_dofs`' owner election).  A whole grid is
        owned by rank 0."""
        return owner(self.shape, self.rank, split)


def owner(mesh_shape, rank: int, split) -> bool:
    """`DistMesh.owns` for any rank of a mesh of `mesh_shape`."""
    coords = np.unravel_index(rank, tuple(mesh_shape))
    return all(s or int(c) == 0 for c, s in zip(coords, split))


def make_mesh(n_blocks: int, device=None) -> BlockMesh:
    """A `factor_mesh(n_blocks)` block mesh on `device` (default: the card).

    `device` may be one device or a sequence of them; devices on more than
    one card raise NotImplementedError: a process drives one device, and a
    mesh over several is a `DistMesh` of processes
    (`parallel.distributed.initialize`, then `distributed.global_mesh()`).
    """
    if isinstance(device, (list, tuple)):
        devices = {torch.device(d) for d in device}
        if len(devices) > 1:
            raise NotImplementedError(
                "a block mesh over several devices is not supported: the "
                "BlockMesh holds one device; run one process per device and "
                "use distributed.global_mesh() for a mesh of ranks"
            )
        device = next(iter(devices)) if devices else None
    return BlockMesh(factor_mesh(n_blocks), device_mod.resolve(device))


def split_axes(mesh_shape, shape, min_per_device: int = 8) -> tuple[bool, bool, bool]:
    """Which axes of a cell grid of `shape` a mesh of `mesh_shape` splits
    (``grid_pspec``'s rule): an axis is split over its mesh axis unless it
    does not divide or its blocks would drop below `min_per_device` cells
    (coarse levels are cheaper whole than cut)."""
    return tuple(
        m > 1 and n % m == 0 and n // m >= min_per_device
        for n, m in zip(shape, mesh_shape)
    )


def grid_split(mesh, shape, min_per_device: int = 8) -> tuple[bool, bool, bool]:
    """`split_axes` of a `BlockMesh` or a `DistMesh` (the counterpart of
    ``grid_pspec``)."""
    return split_axes(mesh.shape, shape, min_per_device)


def local_slices(mesh_shape, global_shape, rank: int, split=None) -> tuple[slice, slice, slice]:
    """The global-index slices of rank `rank`'s block of a grid of
    `global_shape` on a mesh of `mesh_shape`, split on the axes `split`
    (default: `split_axes`' rule); a whole axis is sliced whole.  Pure, so
    every rank's slices can be checked without starting a world."""
    if split is None:
        split = split_axes(mesh_shape, global_shape)
    coords = np.unravel_index(rank, tuple(mesh_shape))
    out = []
    for n, m, c, s in zip(global_shape, mesh_shape, coords, split):
        b = n // m
        out.append(slice(int(c) * b, (int(c) + 1) * b) if s else slice(0, int(n)))
    return tuple(out)


def face_split(mesh_shape, cell_shape, axis: int, min_per_device: int = 8) -> tuple[bool, bool, bool]:
    """The axes a MAC face array of `axis` over a cell grid of `cell_shape`
    is cut on: the cell grid's (`split_axes`), its own n+1 axis whole.  Where
    n divides, n+1 does not, so this is `split_axes` of the face shape; for
    an odd n whose n+1 would divide it keeps the face array's blocks over
    the cells' (the faces of a cell block are then local on every other
    axis)."""
    split = list(split_axes(mesh_shape, cell_shape, min_per_device))
    split[axis] = False
    return tuple(split)


Box = tuple[tuple[int, int], ...]


def block_box(mesh_shape, global_shape, rank: int, split) -> Box:
    """Rank `rank`'s block of a grid of `global_shape` split on `split`, as
    a box (`local_slices`)."""
    return tuple((s.start, s.stop) for s in local_slices(mesh_shape, global_shape, rank, split))


def grow_box(box: Box, depth: int, global_shape, axes=(True, True, True)) -> Box:
    """`box` grown by `depth` cells on each side of the axes `axes`, clipped
    at the grid's edges (so a computation on the grown box sees the grid's
    own boundary where the box reaches it)."""
    return tuple(
        (max(lo - depth, 0), min(hi + depth, int(n))) if a else (lo, hi)
        for (lo, hi), n, a in zip(box, global_shape, axes)
    )


def face_box(cell_box: Box, axis: int) -> Box:
    """The faces along `axis` of the cells of `cell_box` (one more on its
    upper side)."""
    return tuple((lo, hi + 1) if a == axis else (lo, hi) for a, (lo, hi) in enumerate(cell_box))


def intersect(a: Box, b: Box) -> Box | None:
    """The common cells of two boxes, or None."""
    out = tuple((max(al, bl), min(ah, bh)) for (al, ah), (bl, bh) in zip(a, b))
    return out if all(lo < hi for lo, hi in out) else None


def contains(outer: Box, inner: Box) -> bool:
    return all(ol <= il and ih <= oh for (ol, oh), (il, ih) in zip(outer, inner))


def box_shape(box: Box) -> tuple[int, ...]:
    return tuple(hi - lo for lo, hi in box)


def box_slices(box: Box, origin: Box | None = None) -> tuple[slice, ...]:
    """Slices of `box` in a tensor that holds the box `origin` (default: the
    grid itself, origin 0)."""
    off = (0,) * len(box) if origin is None else tuple(lo for lo, _ in origin)
    return tuple(slice(lo - o, hi - o) for (lo, hi), o in zip(box, off))


def shift_box(box: Box, offset: Sequence[int]) -> Box:
    return tuple((lo + o, hi + o) for (lo, hi), o in zip(box, offset))


def window_offset(window_start, base_pads) -> tuple[int, int, int]:
    """Window cell j lies on base cell ``j + window_offset`` (JAX
    ``_window_static``: ``start - pad_lo``)."""
    return tuple(int(s) - int(plo) for s, (plo, _) in zip(window_start, base_pads))
