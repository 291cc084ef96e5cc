"""Poisson stencil operators on torch tensors (the plain reference forms).

Label-masked 7-point operators with per-level precomputed coefficients
(see `ops.domain.build_level_coefficients`), mirroring
``geometricmultigridpressuresolver_tpu.ops.stencil``:

  * apply_poisson  -- y = A x over the solvable set
  * residual       -- r = b - A x, masked
  * jacobi_smooth  -- x += w * inv_diag * (b - A x)
  * boundary_jacobi-- the same, restricted to the boundary band
  * rb_gauss_seidel-- red/black half-sweeps, red->black on the downstroke
                      and black->red on the upstroke (adjoint ordering)

These are the textbook forms the symmetry suite runs.  The V-cycle's
smoothing block goes through `ops.fused_smoother`, whose kernel and plain
version use the equivalent update inv_diag * (b + S) (equal to these on
solvable cells up to rounding).

Fields are kept identically zero outside the solvable set.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class LevelCoeffs(NamedTuple):
    """Static per-level stencil coefficients.

    ew0/ew1/ew2 are per-axis off-diagonal edge weights stored CELL-shaped:
    entry i along the axis is the weight of the face between cell i and cell
    i+1, nonzero only when both cells are solvable.  diag/inv_diag are zero
    on non-solvable cells.  Every tensor has the cell grid's shape.
    """

    solvable: torch.Tensor  # bool
    band: torch.Tensor      # int8 (0/1), the kernels read it as bytes
    diag: torch.Tensor      # float
    inv_diag: torch.Tensor  # float
    ew0: torch.Tensor       # float or bfloat16
    ew1: torch.Tensor
    ew2: torch.Tensor

    @property
    def shape(self):
        return tuple(self.diag.shape)


def _shift_m(x: torch.Tensor, axis: int) -> torch.Tensor:
    """out[i] = x[i-1] along `axis`, zero at i = 0."""
    out = torch.zeros_like(x)
    dst = [slice(None)] * x.ndim
    src = [slice(None)] * x.ndim
    dst[axis], src[axis] = slice(1, None), slice(0, -1)
    out[tuple(dst)] = x[tuple(src)]
    return out


def _shift_p(x: torch.Tensor, axis: int) -> torch.Tensor:
    """out[i] = x[i+1] along `axis`, zero at i = n-1."""
    out = torch.zeros_like(x)
    dst = [slice(None)] * x.ndim
    src = [slice(None)] * x.ndim
    dst[axis], src[axis] = slice(0, -1), slice(1, None)
    out[tuple(dst)] = x[tuple(src)]
    return out


def neighbor_sum_ew(x: torch.Tensor, ew0, ew1, ew2) -> torch.Tensor:
    """Off-diagonal sum S[i] = e[i] * x[i+1] + e[i-1] * x[i-1] per axis,
    accumulated axis by axis, upper term first."""
    out = torch.zeros_like(x)
    for axis, ew in enumerate((ew0, ew1, ew2)):
        out = out + ew * _shift_p(x, axis)
        out = out + _shift_m(ew * x, axis)
    return out


def neighbor_sum(x: torch.Tensor, c: LevelCoeffs) -> torch.Tensor:
    return neighbor_sum_ew(x, c.ew0, c.ew1, c.ew2)


def apply_poisson(x: torch.Tensor, c: LevelCoeffs) -> torch.Tensor:
    """y = A x over the solvable set (zero elsewhere)."""
    return c.diag * x - neighbor_sum(x, c)


def residual(x: torch.Tensor, b: torch.Tensor, c: LevelCoeffs) -> torch.Tensor:
    """r = b - A x, masked to the solvable set."""
    r = b - apply_poisson(x, c)
    return torch.where(c.solvable, r, torch.zeros_like(r))


def jacobi_smooth(x, b, c: LevelCoeffs, damping: float = 2.0 / 3.0) -> torch.Tensor:
    """One damped Jacobi pass: x += damping * (b - A x) / diag."""
    return x + damping * c.inv_diag * (b - apply_poisson(x, c))


def boundary_jacobi(x, b, c: LevelCoeffs, damping: float = 2.0 / 3.0) -> torch.Tensor:
    """One damped Jacobi pass restricted to the boundary band (all band cells
    read pre-update values)."""
    update = x + damping * c.inv_diag * (b - apply_poisson(x, c))
    return torch.where(c.band.bool(), update, x)


def color_mask(shape, color: int, device=None) -> torch.Tensor:
    """Checkerboard mask: cells with (i + j + k) % 2 == color."""
    i, j, k = (torch.arange(s, dtype=torch.int32, device=device) for s in shape)
    parity = (i[:, None, None] + j[None, :, None] + k[None, None, :]) % 2
    return parity == color


def rb_gauss_seidel_color(x, b, c: LevelCoeffs, color: int) -> torch.Tensor:
    """One undamped Gauss-Seidel half-sweep over cells of one colour."""
    update = x + c.inv_diag * (b - apply_poisson(x, c))
    return torch.where(color_mask(x.shape, color, x.device), update, x)


def rb_gauss_seidel(x, b, c: LevelCoeffs, forward: bool) -> torch.Tensor:
    """Full red/black sweep: red then black forward, black then red backward."""
    for color in ((0, 1) if forward else (1, 0)):
        x = rb_gauss_seidel_color(x, b, c, color)
    return x
