"""One level's smoothing block: the chunk kernel (csrc/smoother.cu) and plain version.

Replaces ops/pallas_smoother.py::fused_smooth (driver smooth_level_pallas)
of the JAX package, with its band-strip variant and its bfloat16 field
storage.  The block is a pass list (`schedule_for`): ``b^k, r, k, b^k`` on
the downstroke and ``b^k, k, r, b^k`` on the upstroke (k =
boundary_iterations, 8 passes by default), or ``b^k, j, b^k`` with the
Jacobi interior smoother.  With S the off-diagonal neighbour sum:

  * ``b``: a*x + wb*(b+S), a = 1 - w*band, wb = w*band*inv_diag (damped
    Jacobi on the boundary band, the identity elsewhere);
  * ``r``/``k``: where(colour, inv_diag*(b+S), x), colour (i+j+k)%2 red = 0
    / black = 1 -- an undamped Gauss-Seidel half-sweep;
  * ``j``: (1-w)*x + w*inv_diag*(b+S).

The GS update is inv_diag*(b+S) (the Pallas kernel's form), which equals
``ops.stencil.rb_gauss_seidel_color``'s x + inv_diag*(b - A x) on solvable
cells up to rounding, because inv_diag*diag = 1 there.

Variants: `x_is_zero` (the downstroke's zero start: x is not read),
`emit_residual` (also return r = b - A x'), `emit_dot` (also return <x', b>
reduced in a fixed order in the compute dtype; the CG rho on the fine
upstroke).  The block-mesh smoother (parallel/fused_sharded.py) runs the
same passes over a stacked grid of haloed blocks: it names the pass list
(`schedule`, a chunk of at most H passes) and the core window of the dot
(`window`), and those launches count in `SHARDED_LAUNCHES`.

The kernel (csrc/smoother.cu).  One cooperative launch runs a chunk of
`Tiles.depth` consecutive passes (`chunk_plan`; the default 8-pass block
is one launch), with a grid-wide barrier between passes; the last chunk
also forms the residual, the narrow output and the dot.  Each pass touches
what it changes: a `b` pass the band-cell list, a GS pass the cells of its
colour in the active tiles, a Jacobi pass every cell of the active tiles.
Tiles without a cell any pass can change (`level_tiles`, built once per
solve in `level_blocks`, like the JAX package's active-slab lists) are
never visited: the work buffers are allocated zeroed, which is the pass
sequence's output there for fields that are zero off the solvable set
(`smooth_level`'s precondition).  The lists keep one shape per level
(padded to the tile and cell counts) and their lengths on the device
(`Tiles.counts`), which the kernel reads: building them reads nothing on
the host, so a whole frame can be captured as one CUDA graph.  `config.pallas_band_strip` does not
change the card's launches.  The tile and depth are fixed in code (`CHUNK_TILE`,
`CHUNK_DEPTH`); there is no halo, so the residual always rides the last
chunk (`Chunk.ring` matters only to the block mesh's H-cell halo).

The plain version runs pass by pass.  With `pallas_band_strip` it writes
the `b` passes that can be band-only into a compacted int32 list of the
band cells (`band_cells`): `pass_plan` tracks which of two ping-pong
buffers agree with the current x off the band, a full `b` pass leaves its
source and target in agreement, a band-only pass keeps every agreement, a
GS or Jacobi pass breaks them all.  So in ``b b b r k b b b`` the passes 3,
7 and 8 run band-only; a pass that writes the narrow output or the dot
stays full.  The numbers equal the full passes'.

bfloat16 field storage (config.mg_field_dtype).  x, b and inv_diag are
stored bf16 and the block computes in float32: the first chunk reads the
stored x, the chunks between keep x in float32 buffers, and the last chunk
narrows once (the Pallas kernel keeps the whole chunk in fp32 on its slab
and narrows once, ops/pallas_smoother.py:590).  Rounding after every pass
would compute something else.  The residual is formed from the unrounded
float32 x with diag = 1/inv_diag of the narrowed inv_diag (the Pallas
kernel's :582-588) and stored bf16; the dot is a float32 sum of products
of the unrounded x.  Chunks over bf16 fields count in `NARROW_LAUNCHES`,
the others in `PASS_LAUNCHES`.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from geometricmultigridpressuresolver_tpu_torch.ops import _cuda, fused_cg
from geometricmultigridpressuresolver_tpu_torch.ops.stencil import (
    LevelCoeffs,
    color_mask,
    neighbor_sum,
)

PASS_LAUNCHES = _cuda.LaunchCounter("smoother")
NARROW_LAUNCHES = _cuda.LaunchCounter("smoother_bf16")
SHARDED_LAUNCHES = _cuda.LaunchCounter("smoother_sharded")

NARROW_DTYPE = torch.bfloat16
# Halo depth H of the Pallas kernel: its pass stack runs in chunks of at
# most H passes.  Ported for the residual_fusable gate and the block mesh.
PALLAS_HALO = 8
# Passes per chunk-kernel launch: the default block (8 passes) is one launch.
CHUNK_DEPTH = 8
# The tile (x planes, y rows, z columns; powers of two, z at least 2: the
# kernel indexes a tile's cells with shifts, and a colour takes every other
# z) over which the chunk kernel's active-tile list is built: tiles without
# a cell any pass can change are skipped.  Of the tiles measured at the
# 256^3 fine level the times spread 6% (PERF.md section 6); this one is kept.
CHUNK_TILE = (8, 8, 32)

_KIND_CODES = {"b": 0, "r": 1, "k": 2, "j": 3}


def schedule_for(config, forward: bool) -> tuple[str, ...]:
    """The reference smoothing block as a pass list."""
    bnd = ("b",) * config.boundary_iterations
    if config.use_gauss_seidel:
        interior = ("r", "k") if forward else ("k", "r")
    else:
        interior = ("j",)
    return bnd + interior + bnd


class Chunk(NamedTuple):
    """One launch of the chunk kernel: passes [start, stop) of the schedule,
    whether it starts from x == 0 and forms the residual, and its halo
    width (the stages that read neighbours)."""

    start: int
    stop: int
    zero: bool
    residual: bool
    ring: int


def chunk_plan(length: int, depth: int, x_is_zero: bool = False, emit_residual: bool = False):
    """The launches of a `length`-pass schedule at `depth` passes each (the
    JAX package's chunking at depth H, ops/pallas_smoother.py:836-855): a
    zero start applies to the first chunk, the residual to the last."""
    chunks = []
    for start in range(0, length, depth):
        stop = min(start + depth, length)
        zero = x_is_zero and start == 0
        residual = emit_residual and stop == length
        chunks.append(Chunk(start, stop, zero, residual, stop - start + residual - zero))
    return tuple(chunks)


def residual_fits(length: int, depth: int, x_is_zero: bool) -> bool:
    """The JAX package's spare-ring rule (ops/pallas_smoother.py:670-674):
    the residual rides the last chunk within a `depth`-cell halo -- a zero
    start on a one-chunk schedule, or a last chunk of at most depth - 1
    passes."""
    return chunk_plan(length, depth, x_is_zero, True)[-1].ring <= depth


def residual_fusable(config, forward: bool = True) -> bool:
    """The JAX package's gate for narrow field storage
    (ops/pallas_smoother.py::residual_fusable): can the residual ride the
    last H-pass chunk of a zero-start downstroke?"""
    return residual_fits(len(schedule_for(config, forward)), PALLAS_HALO, True)


class PassStep(NamedTuple):
    """One pass of the plain version: its kind, the buffers it reads and
    writes ("x": the block's input, 0 and 1: the two work buffers), and
    whether it writes only the band cells."""

    kind: str
    src: object
    dst: object
    band_only: bool


def pass_plan(schedule, band: bool, final_full: bool) -> tuple[PassStep, ...]:
    """The buffers of each pass, and which `b` passes may be band-only.

    A band-only pass writes just the band cells of its target, so the
    target must already equal the source off the band.  `synced` holds the
    buffers that equal the current x off the band.  `final_full` keeps the
    last pass full (it writes the narrow output or the dot).
    """
    steps = []
    cur, synced = "x", set()
    for n, kind in enumerate(schedule):
        in_place = kind in "rk" and cur != "x"
        dst = cur if in_place else (1 if cur == 0 else 0)
        band_only = (
            band and kind == "b" and dst in synced
            and not (final_full and n == len(schedule) - 1)
        )
        steps.append(PassStep(kind, cur, dst, band_only))
        if kind == "b":
            if not band_only:
                synced = synced | {cur, dst}
        else:
            synced = {dst}
        cur = dst
    return tuple(steps)


def tile_grid(shape, core) -> tuple[int, int, int]:
    """Tiles along x, y and z (the last ones ragged)."""
    return tuple(-(-int(n) // int(t)) for n, t in zip(shape, core))


def tile_occupancy(cells: torch.Tensor, core) -> torch.Tensor:
    """(gx, gy, gz) bool: the tiles whose core holds a True cell."""
    g = tile_grid(cells.shape, core)
    padded = cells.new_zeros(tuple(n * t for n, t in zip(g, core)))
    padded[: cells.shape[0], : cells.shape[1], : cells.shape[2]] = cells
    lx, ty, tz = core
    return padded.reshape(g[0], lx, g[1], ty, g[2], tz).any(5).any(3).any(1)


class Tiles(NamedTuple):
    """The kernels' work lists of one level of `shape`, built once per solve
    with no host read (the JAX package's `_compact_blocks`, ops/
    pallas_smoother.py:94-103, which pads its active-slab list to the block
    count and keeps the count on the device): passes per chunk-kernel
    launch, the tile, the active tiles and the dead ones (x-major indices,
    ascending, each list padded to the level's tile count), the band cells
    (flat indices, ascending, padded to the level's cell count; every `b`
    pass of the chunk kernel runs over them alone), the CG step's ticket
    (ops/fused_cg.py: one int32, zero between launches; the launches that
    use it go to one stream at a time) and `counts`, the lists' lengths
    (n_active, n_dead, n_band) as an int32 device tensor, which the kernels
    read.  Pad entries hold the list's capacity, an index past the last
    tile or cell (`compact`)."""

    shape: tuple[int, int, int]
    depth: int
    core: tuple[int, int, int]
    active: torch.Tensor  # int32, (tiles,)
    band: torch.Tensor    # int32, (cells,)
    dead: torch.Tensor    # int32, (tiles,)
    ticket: torch.Tensor  # int32, (1,)
    counts: torch.Tensor  # int32, (3,): n_active, n_dead, n_band


def compact(mask: torch.Tensor) -> torch.Tensor:
    """The flat indices of the True entries of bool `mask`, ascending, int32
    (``flatnonzero``), padded to ``mask.numel()`` entries with the sentinel
    ``mask.numel()``: no host sync, one shape whatever the mask holds."""
    flat = mask.reshape(-1)
    n = flat.numel()
    slot = torch.where(flat, torch.cumsum(flat, 0, dtype=torch.int32) - 1, n).long()
    out = torch.full((n + 1,), n, dtype=torch.int32, device=flat.device)
    out.scatter_(0, slot, torch.arange(n, dtype=torch.int32, device=flat.device))
    return out[:n]  # the spare last slot took every False entry


def list_count(entries: torch.Tensor, capacity: int) -> torch.Tensor:
    """The length of a padded list (`compact`) whose pad entries are
    `capacity` or more, as a 0-d int32 device tensor."""
    return (entries < capacity).sum(dtype=torch.int32)


def trimmed(tiles: Tiles) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(active, dead, band) cut to their lengths, for reports and tests:
    one host read of `counts`."""
    n_active, n_dead, n_band = tiles.counts.tolist()
    return tiles.active[:n_active], tiles.dead[:n_dead], tiles.band[:n_band]


def level_tiles(cells: torch.Tensor, band: torch.Tensor | None = None, depth: int | None = None) -> Tiles:
    """`Tiles` of a level whose cells a kernel can change are `cells` (bool)
    and whose band cells are the padded list `band` (`band_cells`; None:
    none), over `CHUNK_TILE`.  `depth` overrides `CHUNK_DEPTH`.  No host
    sync."""
    depth = CHUNK_DEPTH if depth is None else int(depth)
    occ = tile_occupancy(cells, CHUNK_TILE).reshape(-1)
    n_cells = cells.numel()
    if band is None:
        band = torch.full((n_cells,), n_cells, dtype=torch.int32, device=occ.device)
    n_active = occ.sum(dtype=torch.int32)
    counts = torch.stack((n_active, occ.numel() - n_active, list_count(band, n_cells)))
    ticket = torch.zeros(1, dtype=torch.int32, device=occ.device)
    return Tiles(tuple(cells.shape), depth, CHUNK_TILE, compact(occ), band, compact(~occ), ticket, counts)


class LevelBlocks(NamedTuple):
    """Solve-invariant smoother data of one level (built once per solve,
    like the JAX package's active-slab lists): the band-cell list for the
    plain version's band-restricted passes, the narrowed coefficients for
    bf16 fields, and the chunk kernel's tiles.  Kept apart from
    LevelCoeffs, which `interop` maps field for field."""

    band_cells: torch.Tensor | None  # int32 flat indices, ascending, padded; None: full passes
    narrow: LevelCoeffs | None       # bf16 inv_diag, diag = 1/inv_diag (float32)
    tiles: Tiles


def band_cells(band: torch.Tensor) -> torch.Tensor:
    """Flat indices of the band cells, int32, ascending (``flatnonzero``),
    padded to the level's cell count (`compact`): no host sync."""
    return compact(band != 0)


def narrow_coeffs(c: LevelCoeffs) -> LevelCoeffs:
    """The coefficients a bf16-field block reads: inv_diag stored bf16, and
    the residual's diag recovered from it in float32 (as the Pallas kernel
    recovers it, ops/pallas_smoother.py:586)."""
    inv = c.inv_diag.to(NARROW_DTYPE)
    invf = inv.float()
    diag = torch.where(invf != 0, 1.0 / invf, torch.zeros_like(invf))
    return c._replace(inv_diag=inv, diag=diag)


def level_blocks(c: LevelCoeffs, config, field_dtype=None, depth: int | None = None) -> LevelBlocks:
    """`LevelBlocks` of one level for fields stored as `field_dtype`; the
    active tiles are those whose core holds a solvable cell.  `depth`
    overrides `CHUNK_DEPTH`.  No host sync."""
    band = band_cells(c.band)
    cells = band if config.pallas_band_strip and "b" in schedule_for(config, True) else None
    narrow = narrow_coeffs(c) if field_dtype == NARROW_DTYPE else None
    return LevelBlocks(cells, narrow, level_tiles(c.solvable, band, depth))


def _results(x, r, dot, emit_residual: bool, emit_dot: bool):
    out = (x,)
    if emit_residual:
        out = out + (r,)
    if emit_dot:
        out = out + (dot,)
    return out if len(out) > 1 else x


def band_pass_torch(x, out, b, c: LevelCoeffs, cells, damping: float):
    """A band-restricted `b` pass: out[cells] = the `b` update of x there,
    in the full plain pass's arithmetic and association order (so the two
    give equal numbers); other cells of `out` are not touched.  `cells` may
    be padded (`band_cells`): a pad entry reads a cell in the grid and
    writes a spare slot past it, which is dropped, so no host read is
    needed."""
    nx, ny, nz = x.shape
    n = x.numel()
    idx = cells.long().clamp(max=n)
    q = idx.clamp(max=max(n - 1, 0))  # where a pad entry reads
    flat = x.reshape(-1)
    k = q % nz
    j = (q // nz) % ny
    i = q // (ny * nz)
    s = torch.zeros(q.shape, dtype=x.dtype, device=x.device)
    for coord, size, stride, ew in ((i, nx, ny * nz, c.ew0), (j, ny, nz, c.ew1), (k, nz, 1, c.ew2)):
        e = ew.reshape(-1)
        has_up, has_lo = coord + 1 < size, coord > 0
        up = torch.where(has_up, q + stride, q)
        lo = torch.where(has_lo, q - stride, q)
        s = s + torch.where(has_up, e[q] * flat[up], 0.0)
        s = s + torch.where(has_lo, e[lo] * flat[lo], 0.0)
    w = torch.full((), damping, dtype=x.dtype, device=x.device)  # a fill: capturable
    a = 1.0 - w
    wb = w * c.inv_diag.reshape(-1)[q].to(x.dtype)
    bb = b.reshape(-1)[q].to(x.dtype)
    hit = torch.zeros(n + 1, dtype=torch.bool, device=x.device).index_fill_(0, idx, True)
    new = torch.empty(n + 1, dtype=x.dtype, device=x.device)
    new[idx] = a * flat[q] + wb * (bb + s)
    out.copy_(torch.where(hit[:n].view(x.shape), new[:n].view(x.shape), out))
    return out


def _prepare(b, c: LevelCoeffs, config, blocks):
    """(coefficients, blocks, compute dtype) of a block over fields stored
    like b."""
    narrow = b.dtype == NARROW_DTYPE
    if blocks is None:
        blocks = level_blocks(c, config, b.dtype)
    if narrow:
        if blocks.narrow is None:
            raise ValueError("bf16 fields need LevelBlocks built for them (level_blocks)")
        c = blocks.narrow
    return c, blocks, (torch.float32 if narrow else b.dtype)


def smooth_level_torch(
    x, b, c: LevelCoeffs, config, forward: bool, emit_dot: bool = False,
    x_is_zero: bool = False, emit_residual: bool = False, blocks: LevelBlocks | None = None,
    schedule=None, window: fused_cg.CoreWindow | None = None,
):
    """Plain version of the pass stack, with the kernel's arithmetic and its
    buffer plan (band-only passes write only the band of their target)."""
    c, blocks, cdt = _prepare(b, c, config, blocks)
    narrow = cdt != b.dtype
    if schedule is None:
        schedule = schedule_for(config, forward)
    w = config.jacobi_damping
    bc = b.to(cdt)
    invd = c.inv_diag.to(cdt)
    if "b" in schedule:
        band_f = c.band.to(cdt)
        wb = w * band_f * invd
        a = 1.0 - w * band_f
    if "r" in schedule or "k" in schedule:
        red = color_mask(b.shape, 0, b.device)
    plan = pass_plan(schedule, blocks.band_cells is not None, emit_dot or narrow)
    bufs = {"x": torch.zeros_like(bc) if x_is_zero else x.to(cdt)}
    for step in plan:
        cur = bufs[step.src]
        if step.band_only:
            band_pass_torch(cur, bufs[step.dst], b, c, blocks.band_cells, w)
            continue
        s = neighbor_sum(cur, c)
        if step.kind == "b":
            new = a * cur + wb * (bc + s)
        elif step.kind == "j":
            new = (1.0 - w) * cur + (w * invd) * (bc + s)
        else:
            upd = invd * (bc + s)
            new = torch.where(red if step.kind == "r" else ~red, upd, cur)
        bufs[step.dst] = new
    xf = bufs[plan[-1].dst]
    r = dot = None
    if emit_residual:
        r = fused_cg.residual_torch(xf, b, c.diag, c.ew0, c.ew1, c.ew2)
    if emit_dot:
        dot = fused_cg.masked_sum(xf * bc, window)
    return _results(xf.to(b.dtype), r, dot, emit_residual, emit_dot)


def smooth_level(
    x, b, c: LevelCoeffs, config, forward: bool, emit_dot: bool = False,
    x_is_zero: bool = False, emit_residual: bool = False, blocks: LevelBlocks | None = None,
    schedule=None, window: fused_cg.CoreWindow | None = None,
):
    """The smoothing block of one level; see the module docstring.

    Returns x', or a tuple (x', [r], [dot]) with the requested extras; x'
    and r are stored like b.  With `x_is_zero` the argument `x` is ignored
    (it may be None).  The input x is never modified.  `blocks` are the
    level's `LevelBlocks` (built here when None).  `schedule` overrides the
    pass list of `config` and `forward`; `window` marks a stacked block grid
    and restricts the dot to its cores.

    Precondition: x and b are zero on every cell that no pass can change
    (off `c.solvable`; on a stacked grid, where inv_diag and band are both
    zero), as every field of the solver is (ops/stencil.py).  Then the
    kernel equals `smooth_level_torch` on every cell.  Otherwise the two
    agree on the active tiles (`Tiles.active`; edge weights join only cells
    a pass can change), while on the other tiles the kernel's x' and r are
    zero and its dot leaves them out, where the plain version carries x and
    b through.
    """
    if not _cuda.use_kernel(config.kernel_mode, b):
        return smooth_level_torch(
            x, b, c, config, forward, emit_dot, x_is_zero, emit_residual, blocks,
            schedule, window,
        )
    what = "smooth_level"
    c, blocks, cdt = _prepare(b, c, config, blocks)
    narrow = cdt != b.dtype
    x_in = None if x_is_zero else x
    _cuda.check_cuda_operands(
        what, b.shape, x=x_in, b=b, inv_diag=c.inv_diag, diag=c.diag, ew0=c.ew0,
        ew1=c.ew1, ew2=c.ew2, band=c.band,
    )
    _cuda.check_dtypes(what, b, c.inv_diag, *(() if x_in is None else (x_in,)), ews=(c.ew0, c.ew1, c.ew2))
    _cuda.check_storage(what, cdt, b)
    if c.diag.dtype != cdt:
        raise TypeError(f"{what}: diag must be {cdt}, got {c.diag.dtype}")
    if c.band.dtype != torch.int8:
        raise TypeError(f"{what}: band must be int8, got {c.band.dtype}")
    tiles = blocks.tiles
    if tiles.shape != tuple(b.shape):
        raise ValueError(f"{what}: tiles built for {tiles.shape}, not {tuple(b.shape)}")
    check_lists(what, tiles)
    if schedule is None:
        schedule = schedule_for(config, forward)
    counter = SHARDED_LAUNCHES if window is not None else NARROW_LAUNCHES if narrow else PASS_LAUNCHES
    lib = _cuda.library()
    fdt, sdt = _cuda.DTYPE_CODES[cdt], _cuda.dtype_code(b, what)
    edt = _cuda.dtype_code(c.ew0, what)
    nx, ny, nz = b.shape
    stream = _cuda.stream_of(b)
    src = x_in
    x_store = r = dot = None
    for ch in chunk_plan(len(schedule), tiles.depth, x_is_zero, emit_residual):
        last = ch.stop == len(schedule)
        xdt = sdt if src is None else _cuda.dtype_code(src, what)
        grid = chunk_grid(fdt, sdt, xdt, edt)
        # Zeroed work buffers (zero is the output on dead tiles); the first
        # holds the chunk's x.  The last chunk of a narrow block also writes
        # the bf16 output.
        buf_a = torch.zeros(b.shape, dtype=cdt, device=b.device)
        buf_b = torch.zeros_like(buf_a)
        if narrow and last:
            x_store = torch.zeros_like(b)
        if ch.residual:
            r = torch.zeros_like(b)
        partials = torch.empty(grid, dtype=cdt, device=b.device) if emit_dot and last else None
        barrier = torch.zeros(2, dtype=torch.int32, device=b.device)
        kinds = sum(_KIND_CODES[k] << (2 * n) for n, k in enumerate(schedule[ch.start:ch.stop]))
        _cuda.check(
            lib.gmg_smooth_chunk(
                fdt, sdt, xdt, edt, ch.stop - ch.start, kinds, float(config.jacobi_damping),
                _cuda.ptr(src), _cuda.ptr(buf_a), _cuda.ptr(buf_b), _cuda.ptr(x_store if last else None),
                _cuda.ptr(r), _cuda.ptr(b), _cuda.ptr(c.inv_diag), _cuda.ptr(c.diag), _cuda.ptr(c.ew0),
                _cuda.ptr(c.ew1), _cuda.ptr(c.ew2), _cuda.ptr(tiles.band), _cuda.ptr(tiles.active),
                _cuda.ptr(tiles.counts), nx, ny, nz, *tiles.core,
                _cuda.ptr(partials), grid, _cuda.ptr(barrier),
                *fused_cg.window_args(window, b.shape), counter.slot(b), stream,
            ),
            "gmg_smooth_chunk",
        )
        src = buf_a
        if partials is not None:
            dot = fused_cg.sum_partials(partials)
    return _results(x_store if narrow else src, r, dot, emit_residual, emit_dot)


def check_lists(what: str, tiles: Tiles) -> None:
    """Raise unless the work lists are int32 CUDA tensors padded to their
    capacities (the level's tile count for the two tile lists, its cell
    count for the band) with a (3,) `counts` and a (1,) ticket: the
    kernels read the lengths from `counts`, so the shapes are all a host
    check can hold."""
    n_tiles = 1
    for g in tile_grid(tiles.shape, tiles.core):
        n_tiles *= g
    n_cells = tiles.shape[0] * tiles.shape[1] * tiles.shape[2]
    lists = (("active tiles", tiles.active, n_tiles), ("dead tiles", tiles.dead, n_tiles),
             ("band cells", tiles.band, n_cells), ("counts", tiles.counts, 3), ("ticket", tiles.ticket, 1))
    for name, t, size in lists:
        if t.dtype != torch.int32:
            raise TypeError(f"{what}: {name} must be int32, got {t.dtype}")
        if t.numel() != size:
            raise ValueError(f"{what}: {name} of {t.numel()} entries do not cover the {size} of {tuple(tiles.shape)}")
        _cuda.check_cuda_operands(what, (size,), **{name.replace(" ", "_"): t})


_GRIDS: dict = {}
# The (compute, storage, x, edge-weight) dtype codes the chunk kernel is
# built for (csrc/smoother.cu GMG_CHUNK_TYPES).
_INSTANCES = (
    (0, 0, 0, 0), (0, 0, 0, 2), (1, 1, 1, 1), (1, 1, 1, 0), (1, 1, 1, 2),
    (0, 2, 2, 0), (0, 2, 2, 2), (0, 2, 0, 0), (0, 2, 0, 2),
)


def prepare_grids() -> None:
    """Look up every instance's grid on the current device (`chunk_grid`),
    so that a CUDA graph capture finds them made."""
    for codes in _INSTANCES:
        chunk_grid(*codes)


def chunk_grid(fdt: int, sdt: int, xdt: int, edt: int) -> int:
    """CUDA blocks of a chunk-kernel launch for these dtype codes: as many
    as the card holds at once (the launch is cooperative)."""
    key = (torch.cuda.current_device(), fdt, sdt, xdt, edt)
    if key not in _GRIDS:
        grid = int(_cuda.library().gmg_smooth_chunk_grid(fdt, sdt, xdt, edt))
        if grid <= 0:
            raise RuntimeError(f"gmg_smooth_chunk_grid{key[1:]}: no launchable grid")
        _GRIDS[key] = grid
    return _GRIDS[key]
