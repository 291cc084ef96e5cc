"""Halos: a one-card block mesh's CUDA kernels (csrc/halo.cu) with their
plain versions, and the rank-to-rank exchange of a `DistMesh`.

Replaces ``parallel/halo.py::exchange_halos`` of the JAX package (ppermute
of H-deep slabs along each sharded mesh axis, zeros at the mesh edges,
corners filled transitively by exchanging y after x) together with the
core slicing of ``parallel/pallas_sharded.py``.  On one card the blocks
are windows of one global grid, so the exchange is an indexed copy.

Stacked layout.  The haloed blocks of a level lie one after another along
x in one tensor of shape ``(mx*my*(bx+2hx), by+2hy, nz)``: block
b = ix*my + iy holds the global window ``[ix*bx - hx, (ix+1)*bx + hx) x
[iy*by - hy, (iy+1)*by + hy)``, zero outside the grid; hx, hy are H on a
split axis and 0 on a whole one, and z is never split.  Every pass of the
smoother is then ONE launch over the stacked grid.  A pass reads across
from one block into the next only in the halo rings, and a ring's wrong
values reach one ring further per pass, so within H passes they never
reach a core -- the ring budget of ``ops/pallas_smoother.py:652-659``.
The red/black colour of a stacked cell is its global colour because every
core extent and H are even (`geometry` refuses an odd split).

`halo_gather` (global -> stacked) and `core_scatter` (stacked cores ->
global) run the kernel on CUDA tensors and count in `HALO_LAUNCHES`; on
CPU tensors they run the plain versions, which copy block by block with
slicing.

Across ranks (`parallel.mesh.DistMesh`) a rank holds one block, and
`exchange_halos` grows it by the halo of the level's `BlockGeometry` with
its neighbours' slabs (`distributed.exchange`): x first, then y over the
x-grown block, so the corners arrive transitively, and zeros at the mesh
edges -- the one haloed block is the stacked layout with one block, and
it equals that block of `halo_gather` on the global grid.  An x slab is
contiguous; a y slab is strided and packed with a torch copy first (its
seconds in `CommStats.pack_s`).  `core_of` cuts the core back out.
"""

from __future__ import annotations

from typing import NamedTuple

import time

import torch

from geometricmultigridpressuresolver_tpu_torch.ops import _cuda
from geometricmultigridpressuresolver_tpu_torch.ops.fused_cg import CoreWindow
from geometricmultigridpressuresolver_tpu_torch.parallel import distributed
from geometricmultigridpressuresolver_tpu_torch.parallel.mesh import DistMesh, grid_split

HALO_LAUNCHES = _cuda.LaunchCounter("halo")

# Halo depth: the JAX package's kernel halo H (ops/pallas_smoother.py).  A
# block is smoothed by at most H passes between two gathers.
H = 8

# Element sizes of the kernel's typed copies: the int8 band, bf16 edge
# weights, fp32 and fp64 fields.
_ITEMSIZES = {torch.int8: 1, torch.bfloat16: 2, torch.float32: 4, torch.float64: 8}


class BlockGeometry(NamedTuple):
    """How a global (nx, ny, nz) grid cuts into the stacked haloed blocks."""

    shape: tuple[int, int, int]   # the global grid
    blocks: tuple[int, int]       # (mx, my): blocks along x and y (1: whole)
    halo: tuple[int, int]         # (hx, hy): H on a split axis, else 0

    @property
    def core(self) -> tuple[int, int]:
        return self.shape[0] // self.blocks[0], self.shape[1] // self.blocks[1]

    @property
    def num_blocks(self) -> int:
        return self.blocks[0] * self.blocks[1]

    @property
    def stacked_shape(self) -> tuple[int, int, int]:
        (bx, by), (hx, hy) = self.core, self.halo
        return (self.num_blocks * (bx + 2 * hx), by + 2 * hy, self.shape[2])

    @property
    def block_shape(self) -> tuple[int, int, int]:
        """One haloed block (a rank's, across ranks)."""
        (bx, by), (hx, hy) = self.core, self.halo
        return (bx + 2 * hx, by + 2 * hy, self.shape[2])

    @property
    def window(self) -> CoreWindow:
        (bx, by), (hx, hy) = self.core, self.halo
        return CoreWindow(bx + 2 * hx, hx, hx + bx, hy, hy + by)


def geometry(mesh, shape, depth: int = H) -> BlockGeometry:
    """The block geometry of a level of `shape` on `mesh` (a `BlockMesh` or
    a `DistMesh`; `grid_split`'s axes) with `depth`-cell halos.  Raises on
    a split z axis (blocks are whole in z) and on an odd core extent (the
    stacked red/black colour would flip; across ranks, a rank's core offset
    is a multiple of the core, so it stays even)."""
    shape = tuple(int(n) for n in shape)
    split = grid_split(mesh, shape)
    if split[2]:
        raise ValueError(f"the block mesh {mesh.shape} splits the z axis of {shape}; use (mx, my, 1)")
    blocks = tuple(m if s else 1 for m, s in zip(mesh.shape[:2], split[:2]))
    halo = tuple(depth if s else 0 for s in split[:2])
    geom = BlockGeometry(shape, blocks, halo)
    for n, s in zip(geom.core, split[:2]):
        if s and n % 2:
            raise ValueError(
                f"odd core extent {n} of {shape} on {mesh.shape}: the stacked blocks "
                "would flip the red/black colour"
            )
    return geom


def _check(what: str, t: torch.Tensor, shape) -> None:
    if t.dtype not in _ITEMSIZES:
        raise TypeError(f"{what}: unsupported dtype {t.dtype}")
    _cuda.check_cuda_operands(what, shape, t=t)


def halo_gather_torch(t: torch.Tensor, geom: BlockGeometry) -> torch.Tensor:
    """Plain version: each block's window of the global grid, zero outside."""
    (mx, my), (bx, by), (hx, hy) = geom.blocks, geom.core, geom.halo
    nx, ny, _ = geom.shape
    out = t.new_zeros(geom.stacked_shape)
    bxh = bx + 2 * hx
    for ix in range(mx):
        for iy in range(my):
            x0, y0 = ix * bx - hx, iy * by - hy
            gx = slice(max(x0, 0), min(x0 + bxh, nx))
            gy = slice(max(y0, 0), min(y0 + by + 2 * hy, ny))
            row = (ix * my + iy) * bxh
            out[row + gx.start - x0:row + gx.stop - x0, gy.start - y0:gy.stop - y0] = t[gx, gy]
    return out


def core_scatter_torch(t: torch.Tensor, geom: BlockGeometry, out=None) -> torch.Tensor:
    """Plain version: the global grid of the blocks' cores (into `out`
    when given)."""
    (mx, my), (bx, by), (hx, hy) = geom.blocks, geom.core, geom.halo
    blocks = t.reshape(mx, my, bx + 2 * hx, by + 2 * hy, geom.shape[2])
    cores = blocks[:, :, hx:hx + bx, hy:hy + by].permute(0, 2, 1, 3, 4)
    if out is None:
        return cores.reshape(geom.shape)
    out.view(mx, bx, my, by, geom.shape[2]).copy_(cores)
    return out


def _launch(name: str, t: torch.Tensor, out: torch.Tensor, geom: BlockGeometry) -> None:
    (mx, my), (bx, by), (hx, hy) = geom.blocks, geom.core, geom.halo
    nx, ny, nz = geom.shape
    _cuda.check(
        getattr(_cuda.library(), name)(
            _ITEMSIZES[t.dtype], _cuda.ptr(t), _cuda.ptr(out),
            nx, ny, nz, mx, my, bx, by, hx, hy, HALO_LAUNCHES.slot(t), _cuda.stream_of(t),
        ),
        name,
    )


def halo_gather(t: torch.Tensor, geom: BlockGeometry, mode: str = "auto") -> torch.Tensor:
    """Global grid -> stacked haloed blocks (zeros past the grid's edge)."""
    if not _cuda.use_kernel(mode, t):
        return halo_gather_torch(t, geom)
    _check("halo_gather", t, geom.shape)
    out = torch.empty(geom.stacked_shape, dtype=t.dtype, device=t.device)
    _launch("gmg_halo_gather", t, out, geom)
    return out


def core_scatter(t: torch.Tensor, geom: BlockGeometry, mode: str = "auto", out=None) -> torch.Tensor:
    """Stacked haloed blocks -> the global grid of their cores, written
    into `out` (a contiguous grid of t's dtype) when given."""
    if not _cuda.use_kernel(mode, t):
        return core_scatter_torch(t, geom, out)
    _check("core_scatter", t, geom.stacked_shape)
    if out is None:
        out = torch.empty(geom.shape, dtype=t.dtype, device=t.device)
    else:
        _check("core_scatter", out, geom.shape)
        if out.dtype != t.dtype:
            raise TypeError(f"core_scatter: out is {out.dtype}, not {t.dtype}")
    _launch("gmg_core_scatter", t, out, geom)
    return out


def exchange_halo_axis(blk: torch.Tensor, h: int, axis: int, mesh: DistMesh) -> torch.Tensor:
    """Grow this rank's `blk` by `h` cells of its neighbours' data on each
    side along `axis` (mesh axis `axis`); a block at the mesh edge gets
    zeros there.  Every rank of the mesh calls this together."""
    n = blk.shape[axis]
    if h > n:
        raise ValueError(f"halo of {h} cells on a block of {n} along axis {axis}")
    coords = list(mesh.coords)
    c, m = coords[axis], mesh.shape[axis]
    distributed.device_sync(blk.device)
    t0 = time.perf_counter()
    lo_slab = blk.narrow(axis, 0, h).contiguous()
    hi_slab = blk.narrow(axis, n - h, h).contiguous()
    distributed.device_sync(blk.device)
    mesh.stats.pack_s += time.perf_counter() - t0
    sends, recvs, received = [], [], {}
    for side, step, slab in (("lo", -1, lo_slab), ("hi", 1, hi_slab)):
        if 0 <= c + step < m:
            peer = mesh.rank_at(coords[:axis] + [c + step] + coords[axis + 1:])
            sends.append((slab, peer, axis))
            recvs.append((slab, peer, axis))
            received[side] = len(recvs) - 1
    got = distributed.exchange(mesh, sends, recvs)
    lo = got[received["lo"]] if "lo" in received else torch.zeros_like(lo_slab)
    hi = got[received["hi"]] if "hi" in received else torch.zeros_like(hi_slab)
    return torch.cat((lo, blk, hi), dim=axis)


def exchange_halos(blk: torch.Tensor, geom: BlockGeometry, mesh: DistMesh) -> torch.Tensor:
    """This rank's block grown to `geom.block_shape` (its halo on every
    split axis, x before y so the corners fill transitively)."""
    core = tuple(geom.core) + (geom.shape[2],)
    if tuple(blk.shape) != core:
        raise ValueError(f"a block of {tuple(blk.shape)}, the geometry's core is {core}")
    distributed.device_sync(blk.device)
    t0 = time.perf_counter()
    for axis, h in enumerate(geom.halo):
        if h:
            blk = exchange_halo_axis(blk, h, axis, mesh)
    distributed.device_sync(blk.device)
    mesh.stats.exchanges += 1
    mesh.stats.exchange_s += time.perf_counter() - t0
    return blk


def core_of(t: torch.Tensor, geom: BlockGeometry) -> torch.Tensor:
    """The core of one haloed block (`geom.block_shape`)."""
    (bx, by), (hx, hy) = geom.core, geom.halo
    return t[hx:hx + bx, hy:hy + by].contiguous()
