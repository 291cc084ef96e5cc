"""One level's smoothing block: CUDA kernels (csrc/smoother.cu) and plain version.

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
`emit_residual` (also return r = b - A x' from a residual launch on x'),
`emit_dot` (also return <x', b> reduced in a fixed order in the compute
dtype; the CG rho on the fine upstroke).  The block-mesh smoother
(parallel/fused_sharded.py) runs the same passes over a stacked grid of
haloed blocks: it names the pass list (`schedule`, a chunk of at most H
passes) and the core window of the dot (`window`), and those passes count
in `SHARDED_LAUNCHES`.

The kernel is one launch per pass, one thread per cell, z fastest.  It is
bound by device memory: about 23 B/cell per pass with bf16 edge weights, so
an 8-pass block moves ~8x what the Pallas kernel's VMEM-resident pass stack
moves.  `b` and `j` passes are simultaneous updates and ping-pong between
two buffers; `r`/`k` passes run in place, since a colour reads only the
other colour.  Every full pass touches every cell, so there is no
eligibility gate: each smoothed level of any shape runs the kernel.

Band-restricted boundary passes (config.pallas_band_strip > 0).  A `b`
pass is the identity off the band, so it need only write the band cells --
if the buffer it writes already holds the input's values off the band.
The band of a level is fixed for a whole solve: `level_blocks` compacts it
once into an ascending int32 list (the JAX package builds its active-slab
lists once per solve the same way).  Of the two sound designs -- gather the
band's new values into a compact buffer and scatter them back in place
(two launches per pass), or keep the ping-pong and write only the band
when the target buffer is known to agree off the band -- the port takes
the second: it keeps one launch per pass.  `pass_plan` tracks which of the
two buffers agree with the current x off the band.  A full `b` pass leaves
its source and target in agreement, and a band-only pass keeps every
agreement; a GS or Jacobi pass breaks them all.  So in ``b b b r k b b b``
the passes 3, 7 and 8 run band-only: the first `b` pass of a run writes a
fresh or stale buffer and stays full.  A pass that writes the narrow
output or the dot also stays full, since both need every cell.

bfloat16 field storage (config.mg_field_dtype).  x, b and inv_diag are
stored bf16 and the block computes in float32: the first pass reads the
stored x, the passes between keep x in float32 buffers, and the last pass
narrows once (the Pallas kernel keeps the whole chunk in fp32 on its slab
and narrows once, ops/pallas_smoother.py:590).  Rounding after every pass
would compute something else.  The residual is formed from the unrounded
float32 x with diag = 1/inv_diag of the narrowed inv_diag (the Pallas
kernel's :582-588) and stored bf16; the dot is a float32 sum of products
of the unrounded x.  Full passes over bf16 fields count in
`NARROW_LAUNCHES`, band passes in `BAND_LAUNCHES`, the rest in
`PASS_LAUNCHES`.
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
BAND_LAUNCHES = _cuda.LaunchCounter("band_pass")
SHARDED_LAUNCHES = _cuda.LaunchCounter("smoother_sharded")

NARROW_DTYPE = torch.bfloat16
# Halo depth H of the Pallas kernel: its pass stack runs in chunks of at
# most H passes.  Ported only for the residual_fusable gate.
PALLAS_HALO = 8

_KIND_CODES = {"b": (0, 0), "r": (1, 0), "k": (1, 1), "j": (2, 0)}


def schedule_for(config, forward: bool) -> tuple[str, ...]:
    """The reference smoothing block as a pass list."""
    bnd = ("b",) * config.boundary_iterations
    if config.use_gauss_seidel:
        interior = ("r", "k") if forward else ("k", "r")
    else:
        interior = ("j",)
    return bnd + interior + bnd


def residual_fusable(config, forward: bool = True) -> bool:
    """The JAX package's gate for narrow field storage
    (ops/pallas_smoother.py::residual_fusable): can the residual ride the
    last H-pass chunk of a zero-start downstroke?"""
    n = len(schedule_for(config, forward))
    last = n % PALLAS_HALO or PALLAS_HALO
    return last <= PALLAS_HALO - 1 or n <= PALLAS_HALO


class PassStep(NamedTuple):
    """One pass of a block: its kind, the buffers it reads and writes ("x":
    the block's input, 0 and 1: the two work buffers), and whether it
    writes only the band cells."""

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


class LevelBlocks(NamedTuple):
    """Solve-invariant smoother data of one level (built once per solve,
    like the JAX package's active-slab lists): the band-cell list for
    band-restricted passes, and the narrowed coefficients for bf16 fields.
    Kept apart from LevelCoeffs, which `interop` maps field for field."""

    band_cells: torch.Tensor | None  # int32 flat indices, ascending; None: full passes
    narrow: LevelCoeffs | None       # bf16 inv_diag, diag = 1/inv_diag (float32)


def band_cells(band: torch.Tensor) -> torch.Tensor:
    """The plain band-list builder: flat indices of the band cells, int32,
    ascending (``flatnonzero``)."""
    return torch.nonzero(band.reshape(-1)).reshape(-1).to(torch.int32)


def narrow_coeffs(c: LevelCoeffs) -> LevelCoeffs:
    """The coefficients a bf16-field block reads: inv_diag stored bf16, and
    the residual's diag recovered from it in float32 (as the Pallas kernel
    recovers it, ops/pallas_smoother.py:586)."""
    inv = c.inv_diag.to(NARROW_DTYPE)
    invf = inv.float()
    diag = torch.where(invf != 0, 1.0 / invf, torch.zeros_like(invf))
    return c._replace(inv_diag=inv, diag=diag)


def level_blocks(c: LevelCoeffs, config, field_dtype=None) -> LevelBlocks:
    """`LevelBlocks` of one level for fields stored as `field_dtype`."""
    cells = None
    if config.pallas_band_strip and "b" in schedule_for(config, True):
        cells = band_cells(c.band)
        if cells.numel() == 0:
            cells = None
    narrow = narrow_coeffs(c) if field_dtype == NARROW_DTYPE else None
    return LevelBlocks(cells, narrow)


def _results(x, r, dot, emit_residual: bool, emit_dot: bool):
    out = (x,)
    if emit_residual:
        out = out + (r,)
    if emit_dot:
        out = out + (dot,)
    return out if len(out) > 1 else x


def band_pass_torch(x, out, b, c: LevelCoeffs, cells, damping: float):
    """Plain version of `band_pass`: out[cells] = the `b` update of x there,
    in the full plain pass's arithmetic and association order (so the two
    give equal numbers); other cells of `out` are not touched."""
    idx = cells.long()
    nx, ny, nz = x.shape
    flat = x.reshape(-1)
    k = idx % nz
    j = (idx // nz) % ny
    i = idx // (ny * nz)
    s = torch.zeros(idx.shape, dtype=x.dtype, device=x.device)
    for coord, n, stride, ew in ((i, nx, ny * nz, c.ew0), (j, ny, nz, c.ew1), (k, nz, 1, c.ew2)):
        e = ew.reshape(-1)
        has_up, has_lo = coord + 1 < n, coord > 0
        up = torch.where(has_up, idx + stride, idx)
        lo = torch.where(has_lo, idx - stride, idx)
        s = s + torch.where(has_up, e[idx] * flat[up], 0.0)
        s = s + torch.where(has_lo, e[lo] * flat[lo], 0.0)
    w = torch.tensor(damping, dtype=x.dtype, device=x.device)
    a = 1.0 - w
    wb = w * c.inv_diag.reshape(-1)[idx].to(x.dtype)
    bb = b.reshape(-1)[idx].to(x.dtype)
    out.reshape(-1)[idx] = a * flat[idx] + wb * (bb + s)
    return out


def band_pass(x, out, b, c: LevelCoeffs, cells, damping: float, mode: str = "auto"):
    """Band-restricted `b` pass: writes the update of x at the listed cells
    into `out` (in place) and leaves out's other cells as they are.

    x and out are compute-dtype buffers; b and c.inv_diag are stored in the
    compute dtype or, for float32 x, in bfloat16.
    """
    if not _cuda.use_kernel(mode, x):
        return band_pass_torch(x, out, b, c, cells, damping)
    what = "band_pass"
    _cuda.check_cuda_operands(
        what, x.shape, x=x, out=out, b=b, inv_diag=c.inv_diag, ew0=c.ew0, ew1=c.ew1, ew2=c.ew2
    )
    _cuda.check_cuda_operands(what, (cells.numel(),), cells=cells)
    _cuda.check_dtypes(what, x, out, ews=(c.ew0, c.ew1, c.ew2))
    _cuda.check_storage(what, x.dtype, b, c.inv_diag)
    if cells.dtype != torch.int32:
        raise TypeError(f"{what}: cells must be int32, got {cells.dtype}")
    if out.data_ptr() == x.data_ptr():
        raise ValueError(f"{what}: a simultaneous update cannot run in place")
    _launch_band(x, out, b, c, cells, damping)
    return out


def _launch_band(x, out, b, c: LevelCoeffs, cells, damping: float) -> None:
    """The band-pass launch on checked operands."""
    nx, ny, nz = x.shape
    _cuda.check(
        _cuda.library().gmg_band_pass(
            _cuda.DTYPE_CODES[x.dtype], _cuda.DTYPE_CODES[b.dtype],
            _cuda.DTYPE_CODES[c.ew0.dtype], float(damping),
            _cuda.ptr(x), _cuda.ptr(out), _cuda.ptr(b), _cuda.ptr(c.inv_diag),
            _cuda.ptr(c.ew0), _cuda.ptr(c.ew1), _cuda.ptr(c.ew2), _cuda.ptr(cells),
            cells.numel(), nx, ny, nz, _cuda.stream_of(x),
        ),
        "gmg_band_pass",
    )
    if cells.numel():
        BAND_LAUNCHES.count += 1


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
    if c.band.dtype != torch.int8:
        raise TypeError(f"{what}: band must be int8, got {c.band.dtype}")
    lib = _cuda.library()
    fdt, sdt = _cuda.DTYPE_CODES[cdt], _cuda.dtype_code(b, what)
    edt = _cuda.dtype_code(c.ew0, what)
    nx, ny, nz = b.shape
    stream = _cuda.stream_of(b)
    cells = blocks.band_cells
    if cells is not None:
        _cuda.check_cuda_operands(what, (cells.numel(),), band_cells=cells)
        if cells.dtype != torch.int32:
            raise TypeError(f"{what}: band cells must be int32, got {cells.dtype}")
    if schedule is None:
        schedule = schedule_for(config, forward)
    plan = pass_plan(schedule, cells is not None, emit_dot or narrow)
    counter = SHARDED_LAUNCHES if window is not None else NARROW_LAUNCHES if narrow else PASS_LAUNCHES
    partials = (
        torch.empty(fused_cg.num_partials(b.shape), dtype=cdt, device=b.device)
        if emit_dot else None
    )
    bufs = {"x": x_in}
    x_store = None
    for n, step in enumerate(plan):
        src = bufs[step.src]
        if step.band_only:
            _launch_band(src, bufs[step.dst], b, c, cells, config.jacobi_damping)
            continue
        last = n == len(plan) - 1
        x_out = None  # the last pass of a narrow block without a residual writes only x_store
        if not (narrow and last and not emit_residual):
            if step.dst not in bufs:
                bufs[step.dst] = torch.empty(b.shape, dtype=cdt, device=b.device)
            x_out = bufs[step.dst]
        if narrow and last:
            x_store = torch.empty_like(b)
        code, color = _KIND_CODES[step.kind]
        _cuda.check(
            lib.gmg_smooth_pass(
                fdt, sdt, sdt if src is None else _cuda.dtype_code(src, what), edt,
                code, color, float(config.jacobi_damping),
                _cuda.ptr(src), _cuda.ptr(x_out), _cuda.ptr(x_store), _cuda.ptr(b),
                _cuda.ptr(c.inv_diag), _cuda.ptr(c.ew0), _cuda.ptr(c.ew1), _cuda.ptr(c.ew2),
                _cuda.ptr(c.band), nx, ny, nz, _cuda.ptr(partials if last else None),
                *fused_cg.window_args(window, b.shape), stream,
            ),
            f"gmg_smooth_pass({step.kind})",
        )
        counter.count += 1
    xf = bufs.get(plan[-1].dst)
    r = dot = None
    if emit_residual:
        r = fused_cg.residual(xf, b, c.diag, c.ew0, c.ew1, c.ew2, mode="cuda")
    if emit_dot:
        dot = fused_cg.sum_partials(partials)
    return _results(x_store if narrow else xf, r, dot, emit_residual, emit_dot)
