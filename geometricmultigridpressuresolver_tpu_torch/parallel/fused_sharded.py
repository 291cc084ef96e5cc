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
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from geometricmultigridpressuresolver_tpu_torch.ops import fused_cg, fused_smoother
from geometricmultigridpressuresolver_tpu_torch.ops.stencil import LevelCoeffs
from geometricmultigridpressuresolver_tpu_torch.parallel import halo
from geometricmultigridpressuresolver_tpu_torch.parallel.halo import H
from geometricmultigridpressuresolver_tpu_torch.parallel.mesh import BlockMesh

def sharded_eligible(shape, split, mesh: BlockMesh, level: int, num_levels: int) -> bool:
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


def prehalo_coeffs(c: LevelCoeffs, mesh: BlockMesh, mode: str = "auto") -> LevelCoeffs:
    """The smoother's constant coefficients as stacked haloed blocks, built
    once per solve: inv_diag, ew0..2, the int8 band, and diag (the fused
    residual's).  `solvable` is not carried (no pass reads it)."""
    geom = halo.geometry(mesh, c.shape)
    return LevelCoeffs(
        solvable=None,
        band=halo.halo_gather(c.band, geom, mode),
        diag=halo.halo_gather(c.diag, geom, mode),
        inv_diag=halo.halo_gather(c.inv_diag, geom, mode),
        ew0=halo.halo_gather(c.ew0, geom, mode),
        ew1=halo.halo_gather(c.ew1, geom, mode),
        ew2=halo.halo_gather(c.ew2, geom, mode),
    )


class ShardedBlocks(NamedTuple):
    """A sharded level's solve-invariant data: its coefficients as stacked
    haloed blocks (`prehalo_coeffs`), their `stacked_blocks`, and the active
    tiles of the level's own grid (`tiles`, for the residual kernel of an
    unfused downstroke), as `LevelBlocks.tiles` are a single-device level's."""

    prehaloed: LevelCoeffs
    blocks: fused_smoother.LevelBlocks
    tiles: fused_smoother.Tiles


def sharded_blocks(c: LevelCoeffs, mesh: BlockMesh, mode: str = "auto") -> ShardedBlocks:
    """`ShardedBlocks` of level `c` on `mesh`, built once per solve."""
    hc = prehalo_coeffs(c, mesh, mode)
    tiles = fused_smoother.level_tiles(c.solvable, fused_smoother.band_cells(c.band))
    return ShardedBlocks(hc, stacked_blocks(hc), tiles)


def stacked_blocks(hc: LevelCoeffs) -> fused_smoother.LevelBlocks:
    """The smoother's `LevelBlocks` of a stacked grid (`prehalo_coeffs`),
    built once per solve: full-grid plain passes (no band-cell list) and the
    tiles whose core holds a cell any pass can change, inv_diag != 0 or
    band != 0 (the stacked coefficients carry no `solvable`)."""
    cells = (hc.inv_diag != 0) | (hc.band != 0)
    tiles = fused_smoother.level_tiles(cells, fused_smoother.band_cells(hc.band))
    return fused_smoother.LevelBlocks(None, None, tiles)


def prehalo_cg_coeffs(c: LevelCoeffs, mesh: BlockMesh, mode: str = "auto") -> tuple:
    """The CG operator's constant arrays (diag, ew0..2) as stacked haloed
    blocks, built once per solve."""
    geom = halo.geometry(mesh, c.shape)
    return tuple(halo.halo_gather(a, geom, mode) for a in (c.diag, c.ew0, c.ew1, c.ew2))


def stacked_cg_tiles(prehaloed_cg: tuple) -> fused_smoother.Tiles:
    """The CG step's tiles of a stacked grid (`prehalo_cg_coeffs`), built
    once per solve: those whose core holds a cell with diag != 0 (the
    stacked coefficients carry no `solvable`); no band cells."""
    diag = prehaloed_cg[0]
    return fused_smoother.level_tiles(diag != 0, torch.zeros(0, dtype=torch.int32, device=diag.device))


def cg_step_sharded(z, p, beta, c: LevelCoeffs, config, mesh: BlockMesh, prehaloed_cg=None, tiles=None):
    """Block-mesh CG step: (p' = z + beta p, A p', <p', A p'>).

    Gathers z and p into the stacked layout, runs one CG-step launch over
    it with the core window, scatters p' and A p' back, and sums the dot
    over the cores in a fixed order.  `prehaloed_cg` is
    `prehalo_cg_coeffs(c, mesh)` and `tiles` `stacked_cg_tiles(prehaloed_cg)`
    (built here when None).
    """
    mode = config.kernel_mode
    geom = halo.geometry(mesh, z.shape)
    if prehaloed_cg is None:
        prehaloed_cg = prehalo_cg_coeffs(c, mesh, mode)
    pn, ap, dot = fused_cg.search_matvec_dot(
        halo.halo_gather(z, geom, mode), halo.halo_gather(p, geom, mode), beta,
        *prehaloed_cg, mode=mode, window=geom.window, tiles=tiles,
    )
    return halo.core_scatter(pn, geom, mode), halo.core_scatter(ap, geom, mode), dot


def smooth_level_sharded(
    x, b, c: LevelCoeffs, config, forward: bool, mesh: BlockMesh, prehaloed=None,
    emit_dot: bool = False, x_is_zero: bool = False, emit_residual: bool = False,
    blocks: fused_smoother.LevelBlocks | None = None,
):
    """The block-mesh smoothing block of one level; a drop-in for
    `ops.fused_smoother.smooth_level` on a level the mesh splits.

    b is gathered once per call; x is gathered before each chunk of at
    most H passes (with `x_is_zero` the first chunk gathers nothing and
    reads no x).  `emit_residual` rides the last chunk (the residual kernel
    on the stacked grid, then scattered) and needs a spare halo ring: a
    zero start on a one-chunk schedule, or a last chunk of at most H - 1
    passes.  `emit_dot` sums <x', b> over the cores.  `prehaloed` is
    `prehalo_coeffs(c, mesh)` and `blocks` `stacked_blocks(prehaloed)`
    (built here when None).  Returns what `smooth_level` returns.
    """
    mode = config.kernel_mode
    geom = halo.geometry(mesh, b.shape)
    schedule = fused_smoother.schedule_for(config, forward)
    if emit_residual and not fused_smoother.residual_fits(len(schedule), H, x_is_zero):
        raise ValueError(
            "emit_residual needs one spare halo ring: requires x_is_zero on a "
            f"one-chunk schedule or a last chunk of <= {H - 1} passes (got {len(schedule)})"
        )
    if prehaloed is None:
        prehaloed = prehalo_coeffs(c, mesh, mode)
    if blocks is None:
        blocks = stacked_blocks(prehaloed)
    bh = halo.halo_gather(b, geom, mode)
    out = None
    for ch in fused_smoother.chunk_plan(len(schedule), H, x_is_zero, emit_residual):
        last = ch.stop == len(schedule)
        xh = None if ch.zero else halo.halo_gather(x, geom, mode)
        out = fused_smoother.smooth_level(
            xh, bh, prehaloed, config, forward,
            emit_dot=emit_dot and last, x_is_zero=ch.zero, emit_residual=ch.residual,
            blocks=blocks, schedule=schedule[ch.start:ch.stop], window=geom.window,
        )
        out = out if isinstance(out, tuple) else (out,)
        x = halo.core_scatter(out[0], geom, mode)
    result = (x,)
    if emit_residual:
        result = result + (halo.core_scatter(out[1], geom, mode),)
    if emit_dot:
        result = result + (out[-1],)
    return result if len(result) > 1 else x


def check_device(mesh: BlockMesh, t: torch.Tensor) -> None:
    """Raise unless `t` lies on the mesh's device."""
    if t.device.type != mesh.device.type or (
        mesh.device.index is not None and t.device.index != mesh.device.index
    ):
        raise ValueError(f"tensor on {t.device}, the block mesh is on {mesh.device}")
