"""Fused CG step and residual: CUDA kernels (csrc/cg.cu) and plain versions.

`search_matvec_dot` replaces ops/pallas_cg.py::fused_search_matvec_dot of
the JAX package: p' = z + beta*p, Ap' = diag*p' - S(p') and <p', Ap'> in one
pass.  `residual` replaces ops/pallas_cg.py::fused_residual:
r = b - (diag*x - S(x)).  Both kernels are bound by device memory.  As the
Pallas kernels walk their active-slab lists, they do stencil work only on
the active tiles of the level's `Tiles` (ops/fused_smoother.py: tiles of
(8, 8, 32) cells holding a solvable cell, built once per solve) and store
zeros on the dead ones, reading nothing there.  A CUDA block stages its
tile's stencil input with a one-cell halo in shared memory -- p' formed
once per cell as it loads, or x -- and the CG step's dot is summed in a
fixed order in the same launch (its last block adds the per-tile partials
in index order), with no float atomics and no second launch.

Precondition, as `fused_smoother.smooth_level` states it: the fields are
zero off the cells the tiles were built from (the solvable set), as every
field of the solver is, and edge weights join only those cells.  Then the
kernels equal the plain versions on every cell.  Otherwise the two agree on
the active tiles, while the kernels' outputs are zero on the other tiles
and the dot leaves them out.

Each wrapper runs the kernel for a CUDA tensor and its plain version
(`*_torch`) for a CPU tensor under ``mode="auto"``; ``mode="torch"`` always
runs the plain version, ``mode="cuda"`` raises on a CPU tensor.  There is no
fallback from a failed kernel to the plain version.

A `CoreWindow` restricts a dot to the core cells of a stacked grid of
haloed blocks (the one-card block mesh, parallel/halo.py): the kernels skip
the other cells' products, the plain versions mask them.  A CG step over
such a grid counts in `SHARDED_STEP_LAUNCHES`, apart from the single-device
`STEP_LAUNCHES`.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from geometricmultigridpressuresolver_tpu_torch.ops import _cuda
from geometricmultigridpressuresolver_tpu_torch.ops.stencil import neighbor_sum_ew

STEP_LAUNCHES = _cuda.LaunchCounter("cg_step")
SHARDED_STEP_LAUNCHES = _cuda.LaunchCounter("cg_step_sharded")
RESIDUAL_LAUNCHES = _cuda.LaunchCounter("residual")


class CoreWindow(NamedTuple):
    """The core cells of a stacked block grid: haloed blocks lie one after
    another along x, `period` rows each; a cell is core when its row within
    its block is in [lo_x, hi_x) and its y index in [lo_y, hi_y)."""

    period: int
    lo_x: int
    hi_x: int
    lo_y: int
    hi_y: int


def window_args(window: CoreWindow | None, shape) -> tuple[int, ...]:
    """The kernels' five window ints; None is the full grid."""
    if window is None:
        return (int(shape[0]), 0, int(shape[0]), 0, int(shape[1]))
    return tuple(int(v) for v in window)


def window_mask(shape, window: CoreWindow, device=None) -> torch.Tensor:
    """Boolean (nx, ny, 1) mask of the core cells (broadcasts over z)."""
    rows = torch.arange(shape[0], device=device) % window.period
    cols = torch.arange(shape[1], device=device)
    in_x = (rows >= window.lo_x) & (rows < window.hi_x)
    in_y = (cols >= window.lo_y) & (cols < window.hi_y)
    return (in_x[:, None] & in_y[None, :])[:, :, None]


def masked_sum(v: torch.Tensor, window: CoreWindow | None) -> torch.Tensor:
    """sum(v) over the core cells (all cells without a window)."""
    if window is None:
        return torch.sum(v)
    return torch.sum(torch.where(window_mask(v.shape, window, v.device), v, torch.zeros_like(v)))


def sum_partials(partials: torch.Tensor) -> torch.Tensor:
    """Fixed-order sum of per-block dot partials into a 0-d tensor (a helper
    launch of the kernel that wrote the partials; not counted separately)."""
    out = torch.empty((), dtype=partials.dtype, device=partials.device)
    lib = _cuda.library()
    _cuda.check(
        lib.gmg_sum_partials(
            _cuda.dtype_code(partials, "sum_partials"),
            _cuda.ptr(partials),
            partials.numel(),
            _cuda.ptr(out),
            _cuda.stream_of(partials),
        ),
        "gmg_sum_partials",
    )
    return out


def kernel_tiles(what: str, tiles, diag: torch.Tensor):
    """The `Tiles` a kernel of this module runs over on the grid of `diag`:
    `tiles`, checked against the grid, or (None) the tiles of the cells with
    diag != 0, built here (on the device, no host read).  Raises on tiles of
    another grid or tile, or on tile lists the kernels cannot take."""
    # Imported here: ops/fused_smoother.py imports this module.
    from geometricmultigridpressuresolver_tpu_torch.ops import fused_smoother

    if tiles is None:
        return fused_smoother.level_tiles(diag != 0)
    if tuple(tiles.shape) != tuple(diag.shape):
        raise ValueError(f"{what}: tiles built for {tuple(tiles.shape)}, not {tuple(diag.shape)}")
    if tuple(tiles.core) != fused_smoother.CHUNK_TILE:
        raise ValueError(f"{what}: tiles of {tuple(tiles.core)}, the kernels take {fused_smoother.CHUNK_TILE}")
    fused_smoother.check_lists(what, tiles)
    return tiles


def tile_args(tiles) -> tuple:
    """The kernels' tile arguments: active, dead, counts, and the tile
    count (the lists' capacity and the launch's grid)."""
    return (_cuda.ptr(tiles.active), _cuda.ptr(tiles.dead), _cuda.ptr(tiles.counts), tiles.active.numel())


def search_matvec_dot_torch(z, p, beta, diag, ew0, ew1, ew2, window: CoreWindow | None = None, p_out=None):
    """Plain version: (p', A p', <p', A p'>), the dot over the window's cores;
    p' written into `p_out` when given."""
    pn = z + beta * p if p_out is None else torch.add(z, beta * p, out=p_out)
    ap = diag * pn - neighbor_sum_ew(pn, ew0, ew1, ew2)
    return pn, ap, masked_sum(pn * ap, window)


def search_matvec_dot(
    z, p, beta, diag, ew0, ew1, ew2, mode: str = "auto", window: CoreWindow | None = None, tiles=None,
    p_out=None,
):
    """Returns (p', A p', <p', A p'>) with p' = z + beta*p.

    `beta` is a 0-d tensor on z's device (the kernel reads it by pointer, so
    the CG loop launches the step without a host read).  Fields share one
    float dtype; the edge weights may be narrower.  With `window` the grids
    are a stacked block grid and the dot runs over its core cells.  `tiles`
    are the grid's `fused_smoother.Tiles`, built once per solve from the
    solvable set (on a stacked grid, the cells with diag != 0); None builds
    them here from diag != 0 on every call.  See the module
    docstring for the precondition under which kernel and plain version
    agree on every cell.  `p_out` (a tensor like z, neither z nor p)
    receives p', so a captured CUDA graph can write it to a fixed buffer;
    None allocates it.
    """
    if not _cuda.use_kernel(mode, z):
        return search_matvec_dot_torch(z, p, beta, diag, ew0, ew1, ew2, window, p_out)
    what = "search_matvec_dot"
    beta = torch.as_tensor(beta, dtype=z.dtype, device=z.device).reshape(())
    _cuda.check_cuda_operands(what, z.shape, z=z, p=p, diag=diag, ew0=ew0, ew1=ew1, ew2=ew2, p_out=p_out)
    _cuda.check_cuda_operands(what, (), beta=beta)
    _cuda.check_dtypes(what, z, p, diag, beta, *(() if p_out is None else (p_out,)), ews=(ew0, ew1, ew2))
    tiles = kernel_tiles(what, tiles, diag)
    if p_out is None:
        p_out = torch.empty_like(z)
    elif p_out.data_ptr() in (z.data_ptr(), p.data_ptr()):
        raise ValueError(f"{what}: p_out must not be z or p (the step reads their neighbours)")
    ap_out = torch.empty_like(z)
    # The dot, then one partial per tile (the active ones are written).
    scratch = torch.empty(1 + tiles.active.numel(), dtype=z.dtype, device=z.device)
    nx, ny, nz = z.shape
    lib = _cuda.library()
    _cuda.check(
        lib.gmg_cg_step(
            _cuda.dtype_code(z, what), _cuda.dtype_code(ew0, what),
            _cuda.ptr(z), _cuda.ptr(p), _cuda.ptr(beta), _cuda.ptr(diag),
            _cuda.ptr(ew0), _cuda.ptr(ew1), _cuda.ptr(ew2),
            _cuda.ptr(p_out), _cuda.ptr(ap_out), _cuda.ptr(scratch[1:]), _cuda.ptr(scratch),
            _cuda.ptr(tiles.ticket), *tile_args(tiles), nx, ny, nz, *tiles.core,
            *window_args(window, z.shape), (STEP_LAUNCHES if window is None else SHARDED_STEP_LAUNCHES).slot(z),
            _cuda.stream_of(z),
        ),
        "gmg_cg_step",
    )
    return p_out, ap_out, scratch[0]


def residual_torch(x, b, diag, ew0, ew1, ew2):
    """Plain version: r = b - (diag*x - S(x)), computed in x's dtype and
    stored in b's."""
    return (b - (diag * x - neighbor_sum_ew(x, ew0, ew1, ew2))).to(b.dtype)


def residual(x, b, diag, ew0, ew1, ew2, mode: str = "auto", tiles=None):
    """r = b - A x.  Zero on non-solvable cells when x and b are (zero diag
    and edge weights there).

    x and diag share the compute dtype; b and the result share the storage
    dtype, which is the compute dtype or, for a float32 x, bfloat16 (the
    narrow V-cycle fields: r is formed from the unrounded x, then narrowed).
    `tiles` as for `search_matvec_dot` (None: built here from diag != 0),
    under the same precondition.
    """
    if not _cuda.use_kernel(mode, x):
        return residual_torch(x, b, diag, ew0, ew1, ew2)
    what = "residual"
    _cuda.check_cuda_operands(what, x.shape, x=x, b=b, diag=diag, ew0=ew0, ew1=ew1, ew2=ew2)
    _cuda.check_dtypes(what, x, diag, ews=(ew0, ew1, ew2))
    _cuda.check_storage(what, x.dtype, b)
    tiles = kernel_tiles(what, tiles, diag)
    r = torch.empty_like(b)
    nx, ny, nz = x.shape
    lib = _cuda.library()
    _cuda.check(
        lib.gmg_residual(
            _cuda.dtype_code(x, what), _cuda.dtype_code(b, what),
            _cuda.dtype_code(ew0, what),
            _cuda.ptr(x), _cuda.ptr(b), _cuda.ptr(diag),
            _cuda.ptr(ew0), _cuda.ptr(ew1), _cuda.ptr(ew2), _cuda.ptr(r),
            *tile_args(tiles), nx, ny, nz, *tiles.core, RESIDUAL_LAUNCHES.slot(x), _cuda.stream_of(x),
        ),
        "gmg_residual",
    )
    return r
