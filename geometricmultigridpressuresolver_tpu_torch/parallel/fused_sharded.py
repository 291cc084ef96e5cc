"""The block-mesh smoother and CG step (port of ``parallel/pallas_sharded.py``).

The JAX package runs its single-device Pallas kernels per device block
under `jax.shard_map`: each block gains an H-cell halo of neighbour data
along every sharded mesh axis, the kernel runs on the haloed block, the
core is sliced back out, and the dots are psummed over the mesh.  On one
card (`parallel.mesh.BlockMesh`) the port gathers ALL haloed blocks of a
level into one stacked tensor (`parallel.halo`), runs the single-device
chunk kernel over the stacked grid (so the launch count per chunk is that
of the single-device path), and scatters the cores back.
The dots count core cells only (`ops.fused_cg.CoreWindow`) and are summed
from per-CUDA-block partials in a fixed order.

Because a block's halo cells are private copies, this is the sharded
schedule -- at most H passes per gather, the ring budget of
``ops/pallas_smoother.py:652-659`` -- and equals the single-device block
cell for cell (the per-cell arithmetic is the same; only the dot's order
differs).  The chunk kernel's halo is its own, inside the stacked grid;
its active tiles are those whose core holds a cell with inv_diag != 0 or
band != 0 (`stacked_blocks`).  Sharded levels keep the mg dtype (no narrow
fields), and their plain version runs full-grid `b` passes, as the JAX
package's sharded path calls `fused_smooth` without a band strip.  On CPU
tensors the same functions run the plain versions over the same stacked
layout.

On one card the sharded path is slower than the single-device one by
construction: it pays the halo redundancy (1.25x the cells of the 256^3
fine level on a (2, 2, 1) mesh) that a multi-card run pays.

Across ranks (`parallel.mesh.DistMesh`, the rank-side counterparts of JAX
`pallas_sharded.py`) the same functions take a rank's blocks: the block
is grown by its neighbours' H-cell slabs (`halo.exchange_halos`), the
same chunk kernel or CG-step kernel runs on that one haloed block -- the
stacked layout with one block, the same `CoreWindow` -- the core is cut
back out (`halo.core_of`), and the dot is the ranks' partials added in
rank order (`distributed.ordered_sum`).  Such tensors carry no global
shape, so the callers pass the level's (`shape`).  `prehalo_coeffs` and
`prehalo_cg_coeffs` exchange the constant coefficients once per solve.
Every rank runs the same exchanges whatever its data: the chunk plan and
the exchange count come from the global shape and the configuration.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from geometricmultigridpressuresolver_tpu_torch.ops import fused_cg, fused_smoother
from geometricmultigridpressuresolver_tpu_torch.ops.stencil import LevelCoeffs
from geometricmultigridpressuresolver_tpu_torch.parallel import distributed, halo
from geometricmultigridpressuresolver_tpu_torch.parallel.halo import H
from geometricmultigridpressuresolver_tpu_torch.parallel.mesh import BlockMesh, DistMesh, grid_split

def sharded_eligible(shape, split, mesh, level: int, num_levels: int) -> bool:
    """Geometry preconditions of the sharded path (`grid_split`'s `split`).

    Split axes need cores of at least the halo depth H that are multiples
    of 8 (which also keeps every core even, so the stacked red/black colour
    is the global one); whole axes keep the single-device rule that the
    outer H shells are non-solvable; z must stay whole.  The JAX package
    also asks nz % 128 == 0, a Mosaic lane-tiling rule for its slabs; the
    CUDA kernels index any nz, so the port drops it.
    """
    nx, ny, _ = shape
    if split[2]:
        return False
    for axis, n in ((0, nx), (1, ny)):
        if not split[axis]:
            if 2 ** (num_levels - 1 - level) < H:
                return False
            r = n - 2 * H
        else:
            if n % mesh.shape[axis]:
                return False
            r = n // mesh.shape[axis]
            if r < H:
                return False
        if r < 8 or r % 8:
            return False
    return True


def _geometry(mesh, t: torch.Tensor, shape) -> halo.BlockGeometry:
    """The level's block geometry: of `shape`, or of `t`'s own shape (the
    global one on a `BlockMesh`)."""
    return halo.geometry(mesh, t.shape if shape is None else shape)


def _haloed(t: torch.Tensor, geom: halo.BlockGeometry, mesh, mode: str) -> torch.Tensor:
    """The stacked haloed blocks of a global grid on a `BlockMesh`, or this
    rank's haloed block across ranks."""
    if isinstance(mesh, DistMesh):
        return halo.exchange_halos(t, geom, mesh)
    return halo.halo_gather(t, geom, mode)


def _core(t: torch.Tensor, geom: halo.BlockGeometry, mesh, mode: str, out=None) -> torch.Tensor:
    """The inverse of `_haloed`: the global grid, or this rank's block
    (written into `out` when given)."""
    if isinstance(mesh, DistMesh):
        core = halo.core_of(t, geom)
        return core if out is None else out.copy_(core)
    return halo.core_scatter(t, geom, mode, out)


def _total(dot: torch.Tensor, geom: halo.BlockGeometry, mesh) -> torch.Tensor:
    """A core-window dot over the whole level: as it is on a `BlockMesh`,
    the ranks' partials in rank order across ranks."""
    if isinstance(mesh, DistMesh):
        return distributed.ordered_sum(mesh, dot, mesh.owns(grid_split(mesh, geom.shape)))
    return dot


def prehalo_coeffs(c: LevelCoeffs, mesh, mode: str = "auto", shape=None) -> LevelCoeffs:
    """The smoother's constant coefficients as stacked haloed blocks (on a
    `DistMesh`, this rank's haloed block of a level of global `shape`),
    built once per solve: inv_diag, ew0..2, the int8 band, and diag (the
    fused residual's).  `solvable` is not carried (no pass reads it)."""
    geom = _geometry(mesh, c.diag, shape)
    return LevelCoeffs(
        solvable=None,
        band=_haloed(c.band, geom, mesh, mode),
        diag=_haloed(c.diag, geom, mesh, mode),
        inv_diag=_haloed(c.inv_diag, geom, mesh, mode),
        ew0=_haloed(c.ew0, geom, mesh, mode),
        ew1=_haloed(c.ew1, geom, mesh, mode),
        ew2=_haloed(c.ew2, geom, mesh, mode),
    )


class ShardedBlocks(NamedTuple):
    """A sharded level's solve-invariant data: its coefficients as stacked
    haloed blocks (`prehalo_coeffs`), their `stacked_blocks`, and the tiles
    of the residual kernel of an unfused downstroke (`tiles`): on a
    `BlockMesh` the active tiles of the level's own grid, as `LevelBlocks.
    tiles` are a single-device level's; across ranks those of the rank's
    haloed block (`residual_sharded`)."""

    prehaloed: LevelCoeffs
    blocks: fused_smoother.LevelBlocks
    tiles: fused_smoother.Tiles


def sharded_blocks(c: LevelCoeffs, mesh, mode: str = "auto", shape=None) -> ShardedBlocks:
    """`ShardedBlocks` of level `c` (global `shape` across ranks) on `mesh`,
    built once per solve."""
    hc = prehalo_coeffs(c, mesh, mode, shape)
    blocks = stacked_blocks(hc)
    if isinstance(mesh, DistMesh):
        return ShardedBlocks(hc, blocks, blocks.tiles)
    tiles = fused_smoother.level_tiles(c.solvable, fused_smoother.band_cells(c.band))
    return ShardedBlocks(hc, blocks, tiles)


def stacked_blocks(hc: LevelCoeffs) -> fused_smoother.LevelBlocks:
    """The smoother's `LevelBlocks` of a stacked grid (`prehalo_coeffs`),
    built once per solve: full-grid plain passes (no band-cell list) and the
    tiles whose core holds a cell any pass can change, inv_diag != 0 or
    band != 0 (the stacked coefficients carry no `solvable`)."""
    cells = (hc.inv_diag != 0) | (hc.band != 0)
    tiles = fused_smoother.level_tiles(cells, fused_smoother.band_cells(hc.band))
    return fused_smoother.LevelBlocks(None, None, tiles)


def prehalo_cg_coeffs(c: LevelCoeffs, mesh, mode: str = "auto", shape=None) -> tuple:
    """The CG operator's constant arrays (diag, ew0..2) as stacked haloed
    blocks (across ranks, this rank's haloed block), built once per solve."""
    geom = _geometry(mesh, c.diag, shape)
    return tuple(_haloed(a, geom, mesh, mode) for a in (c.diag, c.ew0, c.ew1, c.ew2))


def stacked_cg_tiles(prehaloed_cg: tuple) -> fused_smoother.Tiles:
    """The CG step's tiles of a stacked grid (`prehalo_cg_coeffs`), built
    once per solve: those whose core holds a cell with diag != 0 (the
    stacked coefficients carry no `solvable`); no band cells."""
    diag = prehaloed_cg[0]
    return fused_smoother.level_tiles(diag != 0)


def cg_step_sharded(z, p, beta, c: LevelCoeffs, config, mesh, prehaloed_cg=None, tiles=None, shape=None,
                    p_out=None):
    """Block-mesh CG step: (p' = z + beta p, A p', <p', A p'>).

    Gathers z and p into the stacked layout (across ranks: exchanges this
    rank's halos), runs one CG-step launch over it with the core window,
    scatters p' and A p' back (cuts this rank's core), and sums the dot
    over the cores in a fixed order (across ranks, then over the ranks in
    rank order).  `prehaloed_cg` is `prehalo_cg_coeffs(c, mesh)` and
    `tiles` `stacked_cg_tiles(prehaloed_cg)` (built here when None);
    `shape` is the level's global shape (needed across ranks); p' is
    scattered into `p_out` when given.
    """
    mode = config.kernel_mode
    geom = _geometry(mesh, z, shape)
    if prehaloed_cg is None:
        prehaloed_cg = prehalo_cg_coeffs(c, mesh, mode, shape)
    pn, ap, dot = fused_cg.search_matvec_dot(
        _haloed(z, geom, mesh, mode), _haloed(p, geom, mesh, mode), beta,
        *prehaloed_cg, mode=mode, window=geom.window, tiles=tiles,
    )
    return _core(pn, geom, mesh, mode, p_out), _core(ap, geom, mesh, mode), _total(dot, geom, mesh)


def residual_sharded(x, b, prehaloed_cg: tuple, tiles, mesh, shape=None, mode: str = "auto"):
    """r = b - A x on a sharded level (the residual kernel on the stacked
    haloed blocks, or on this rank's haloed block), with the operator's
    stacked coefficients `prehaloed_cg` (diag, ew0..2: `prehalo_cg_coeffs`,
    or the smoother's `prehalo_coeffs` fields) and their `tiles`."""
    geom = _geometry(mesh, x, shape)
    r = fused_cg.residual(
        _haloed(x, geom, mesh, mode), _haloed(b, geom, mesh, mode), *prehaloed_cg, mode=mode, tiles=tiles
    )
    return _core(r, geom, mesh, mode)


def smooth_level_sharded(
    x, b, c: LevelCoeffs, config, forward: bool, mesh, prehaloed=None,
    emit_dot: bool = False, x_is_zero: bool = False, emit_residual: bool = False,
    blocks: fused_smoother.LevelBlocks | None = None, shape=None,
):
    """The block-mesh smoothing block of one level; a drop-in for
    `ops.fused_smoother.smooth_level` on a level the mesh splits.

    b is gathered once per call; x is gathered before each chunk of at
    most H passes (with `x_is_zero` the first chunk gathers nothing and
    reads no x).  `emit_residual` rides the last chunk (the residual kernel
    on the stacked grid, then scattered) and needs a spare halo ring: a
    zero start on a one-chunk schedule, or a last chunk of at most H - 1
    passes.  `emit_dot` sums <x', b> over the cores (across ranks, then
    over the ranks).  `prehaloed` is `prehalo_coeffs(c, mesh)` and `blocks`
    `stacked_blocks(prehaloed)` (built here when None); `shape` is the
    level's global shape (needed across ranks, where x and b are this
    rank's blocks).  Returns what `smooth_level` returns.
    """
    mode = config.kernel_mode
    geom = _geometry(mesh, b, shape)
    schedule = fused_smoother.schedule_for(config, forward)
    if emit_residual and not fused_smoother.residual_fits(len(schedule), H, x_is_zero):
        raise ValueError(
            "emit_residual needs one spare halo ring: requires x_is_zero on a "
            f"one-chunk schedule or a last chunk of <= {H - 1} passes (got {len(schedule)})"
        )
    if prehaloed is None:
        prehaloed = prehalo_coeffs(c, mesh, mode, shape)
    if blocks is None:
        blocks = stacked_blocks(prehaloed)
    bh = _haloed(b, geom, mesh, mode)
    out = None
    for ch in fused_smoother.chunk_plan(len(schedule), H, x_is_zero, emit_residual):
        last = ch.stop == len(schedule)
        xh = None if ch.zero else _haloed(x, geom, mesh, mode)
        out = fused_smoother.smooth_level(
            xh, bh, prehaloed, config, forward,
            emit_dot=emit_dot and last, x_is_zero=ch.zero, emit_residual=ch.residual,
            blocks=blocks, schedule=schedule[ch.start:ch.stop], window=geom.window,
        )
        out = out if isinstance(out, tuple) else (out,)
        x = _core(out[0], geom, mesh, mode)
    result = (x,)
    if emit_residual:
        result = result + (_core(out[1], geom, mesh, mode),)
    if emit_dot:
        result = result + (_total(out[-1], geom, mesh),)
    return result if len(result) > 1 else x


def check_device(mesh, t: torch.Tensor) -> None:
    """Raise unless `t` lies on the mesh's (this rank's) device."""
    if t.device.type != mesh.device.type or (
        mesh.device.index is not None and t.device.index != mesh.device.index
    ):
        where = "this rank" if isinstance(mesh, DistMesh) else "the block mesh"
        raise ValueError(f"tensor on {t.device}, {where} is on {mesh.device}")
