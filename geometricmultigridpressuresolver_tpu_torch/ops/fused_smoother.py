"""One level's smoothing block: CUDA kernel (csrc/smoother.cu) and plain version.

Replaces ops/pallas_smoother.py::fused_smooth (driver smooth_level_pallas)
of the JAX package.  The block is a pass list (`schedule_for`):
``b^k, r, k, b^k`` on the downstroke and ``b^k, k, r, b^k`` on the
upstroke (k = boundary_iterations, 8 passes by default), or ``b^k, j, b^k``
with the Jacobi interior smoother.  With S the off-diagonal neighbour sum:

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
`emit_dot` (also return <x', b> reduced in a fixed order in the field dtype;
the CG rho on the fine upstroke).

The kernel is one launch per pass, one thread per cell, z fastest.  It is
bound by device memory: about 23 B/cell per pass with bf16 edge weights, so
an 8-pass block moves ~8x what the Pallas kernel's VMEM-resident pass stack
moves.  Simple first; keeping the pass stack in shared memory with a halo
(temporal blocking) is the planned follow-up.  `b` and `j` passes are
simultaneous updates and ping-pong between two buffers; `r`/`k` passes run
in place, since a colour reads only the other colour.  Every pass touches
every cell, so there is no eligibility gate: each smoothed level of any
shape runs the kernel.
"""

from __future__ import annotations

import torch

from geometricmultigridpressuresolver_tpu_torch.ops import _cuda, fused_cg
from geometricmultigridpressuresolver_tpu_torch.ops.stencil import (
    LevelCoeffs,
    color_mask,
    neighbor_sum,
)

PASS_LAUNCHES = _cuda.LaunchCounter("smoother")

_KIND_CODES = {"b": (0, 0), "r": (1, 0), "k": (1, 1), "j": (2, 0)}


def schedule_for(config, forward: bool) -> tuple[str, ...]:
    """The reference smoothing block as a pass list."""
    bnd = ("b",) * config.boundary_iterations
    if config.use_gauss_seidel:
        interior = ("r", "k") if forward else ("k", "r")
    else:
        interior = ("j",)
    return bnd + interior + bnd


def _results(x, r, dot, emit_residual: bool, emit_dot: bool):
    out = (x,)
    if emit_residual:
        out = out + (r,)
    if emit_dot:
        out = out + (dot,)
    return out if len(out) > 1 else x


def smooth_level_torch(
    x, b, c: LevelCoeffs, config, forward: bool, emit_dot: bool = False,
    x_is_zero: bool = False, emit_residual: bool = False,
):
    """Plain version of the pass stack, with the kernel's arithmetic."""
    schedule = schedule_for(config, forward)
    w = config.jacobi_damping
    if x_is_zero:
        x = torch.zeros_like(b)
    invd = c.inv_diag
    if "b" in schedule:
        band_f = c.band.to(b.dtype)
        wb = w * band_f * invd
        a = 1.0 - w * band_f
    if "r" in schedule or "k" in schedule:
        red = color_mask(b.shape, 0, b.device)
    for kind in schedule:
        s = neighbor_sum(x, c)
        if kind == "b":
            x = a * x + wb * (b + s)
        elif kind == "j":
            x = (1.0 - w) * x + (w * invd) * (b + s)
        else:
            upd = invd * (b + s)
            x = torch.where(red if kind == "r" else ~red, upd, x)
    r = dot = None
    if emit_residual:
        r = fused_cg.residual_torch(x, b, c.diag, c.ew0, c.ew1, c.ew2)
    if emit_dot:
        dot = torch.sum(x * b)
    return _results(x, r, dot, emit_residual, emit_dot)


def smooth_level(
    x, b, c: LevelCoeffs, config, forward: bool, emit_dot: bool = False,
    x_is_zero: bool = False, emit_residual: bool = False,
):
    """The smoothing block of one level; see the module docstring.

    Returns x', or a tuple (x', [r], [dot]) with the requested extras.
    With `x_is_zero` the argument `x` is ignored (it may be None).  The
    input x is never modified.
    """
    if not _cuda.use_kernel(config.kernel_mode, b):
        return smooth_level_torch(x, b, c, config, forward, emit_dot, x_is_zero, emit_residual)
    what = "smooth_level"
    x_in = None if x_is_zero else x
    _cuda.check_cuda_operands(
        what, b.shape, x=x_in, b=b, inv_diag=c.inv_diag, ew0=c.ew0, ew1=c.ew1,
        ew2=c.ew2, band=c.band,
    )
    _cuda.check_dtypes(
        what, b, c.inv_diag, *(() if x_in is None else (x_in,)), ews=(c.ew0, c.ew1, c.ew2)
    )
    if c.band.dtype != torch.int8:
        raise TypeError(f"{what}: band must be int8, got {c.band.dtype}")
    lib = _cuda.library()
    fdt = _cuda.dtype_code(b, what)
    edt = _cuda.dtype_code(c.ew0, what)
    nx, ny, nz = b.shape
    stream = _cuda.stream_of(b)
    schedule = schedule_for(config, forward)
    partials = (
        torch.empty(fused_cg.num_partials(b.shape), dtype=b.dtype, device=b.device)
        if emit_dot else None
    )
    buffers: list[torch.Tensor] = []
    cur = x_in
    for n, kind in enumerate(schedule):
        code, color = _KIND_CODES[kind]
        if code == 1 and cur is not None and cur is not x_in:
            out = cur  # a colour reads only the other colour: in place
        else:
            free = [t for t in buffers if t is not cur]
            if not free:
                buffers.append(torch.empty_like(b))
                free = buffers[-1:]
            out = free[0]
        last = n == len(schedule) - 1
        _cuda.check(
            lib.gmg_smooth_pass(
                fdt, edt, code, color, float(config.jacobi_damping),
                _cuda.ptr(cur), _cuda.ptr(out), _cuda.ptr(b), _cuda.ptr(c.inv_diag),
                _cuda.ptr(c.ew0), _cuda.ptr(c.ew1), _cuda.ptr(c.ew2), _cuda.ptr(c.band),
                nx, ny, nz, _cuda.ptr(partials if last else None), stream,
            ),
            f"gmg_smooth_pass({kind})",
        )
        PASS_LAUNCHES.count += 1
        cur = out
    r = dot = None
    if emit_residual:
        r = fused_cg.residual(cur, b, c.diag, c.ew0, c.ew1, c.ew2, mode="cuda")
    if emit_dot:
        dot = fused_cg.sum_partials(partials)
    return _results(cur, r, dot, emit_residual, emit_dot)
