"""Inter-level transfers: full-weighting restriction and 4x trilinear
prolongation, in the JAX package's two forms
(``geometricmultigridpressuresolver_tpu.ops.transfer``): shifted slices
(`restrict`, `prolong_add`) and per-axis matrix products (`restrict_mm`,
`prolong_add_mm`; `solver.mg.use_mm_transfers` picks one).

Per axis, restriction is y[c] = sum_k w[k] x[2c-1+k] with w = (1/8, 3/8,
3/8, 1/8), and prolongation is twice its transpose, so the pair stays
adjoint to rounding (the matrix form exactly: it uses the transposed
matrix).  A coarse level may carry trailing EXTERIOR lane padding
(`ops.domain.coarse_lane_pad`): restriction zero-pads its natural
half-resolution result to the coarse shape and prolongation reads only the
natural region -- the exact transpose of each other (in the matrix form,
the padding's columns of the matrix are zero).

Both assume fields are zero outside the solvable set and mask their output
to the destination level's solvable set.

Across ranks (a `parallel.mesh.DistMesh`) a rank holds a block of a split
level, and both transfers read one neighbour cell on each side of it
(restriction x[2c-1] and x[2c+2], prolongation x[c-1] and x[c+1]; JAX
transfer.py:90-110, :132-157).  The caller hands them the block grown by
a one-cell `margin` on those axes (a one-cell halo exchange, or a slice
of a replicated coarse grid with zeros past its edge); an axis with a
margin is not zero-padded, and the result covers the block's own cells.
In the slice form every output cell is formed from the same inputs in the
same order as on one device, so a rank's block is bit-equal to that block
of the whole transfer.  In the matrix form the local matrix along a
margin axis is the whole axis's cut in global coordinates (it is shift
invariant: R[i, c] = w[i - 2c] for restriction, P[f, k] = 2 w[f - 2k + 3]
for prolongation), so a rank's block equals the whole transfer's to the
rounding of the products.

The matrix form contracts each axis where it lies, so every product's
output is contiguous and no axis is moved: axis 0 as (n_out x n_in) @
x.view(n_in, Y*Z), axis 1 as a broadcast batched product over x, axis 2
as x.view(X*Y, n_in) @ (n_in x n_out), in the JAX package's axis order
(0, 1, 2).  The products are IEEE (`blas.ieee_products`), as the JAX
package's ``precision=HIGHEST``; the matrices take the field's dtype and
are cached per shape, device and dtype.
"""

from __future__ import annotations

import functools
from typing import Callable, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from geometricmultigridpressuresolver_tpu_torch.ops import blas

_R_WEIGHTS = (1.0 / 8.0, 3.0 / 8.0, 3.0 / 8.0, 1.0 / 8.0)


def _pad_axis(x: torch.Tensor, axis: int, lo: int, hi: int) -> torch.Tensor:
    widths = [0, 0] * x.ndim
    # F.pad lists (before, after) pairs from the LAST axis backwards.
    k = 2 * (x.ndim - 1 - axis)
    widths[k], widths[k + 1] = lo, hi
    return F.pad(x, widths)


def _sl(x: torch.Tensor, axis: int, sl: slice) -> torch.Tensor:
    idx = [slice(None)] * x.ndim
    idx[axis] = sl
    return x[tuple(idx)]


def _restrict_axis(x: torch.Tensor, axis: int, margin: int = 0) -> torch.Tensor:
    """1-D full weighting along `axis`: y[c] = sum_k w[k] * x[2c - 1 + k]
    (x zero past both ends, or carrying a one-cell `margin` there)."""
    n = x.shape[axis] - 2 * margin
    xp = x if margin else _pad_axis(x, axis, 1, 1)
    w = _R_WEIGHTS
    parts = [_sl(xp, axis, slice(s, s + n - 1, 2)) for s in range(4)]
    return w[0] * parts[0] + w[1] * parts[1] + w[2] * parts[2] + w[3] * parts[3]


def restrict_natural(fine: torch.Tensor, margin=(0, 0, 0)) -> torch.Tensor:
    """The unmasked half-resolution restriction (no lane padding); `fine`
    carries a one-cell margin on the axes where `margin` is 1."""
    out = fine
    for axis in range(3):
        out = _restrict_axis(out, axis, int(margin[axis]))
    return out


def fit_coarse(out: torch.Tensor, coarse_solvable: torch.Tensor) -> torch.Tensor:
    """A natural restriction zero-padded to the coarse shape (its lane
    padding) and masked to the coarse solvable set."""
    if tuple(out.shape) != tuple(coarse_solvable.shape):
        widths = []
        for os_, cs in reversed(list(zip(out.shape, coarse_solvable.shape))):
            widths += [0, cs - os_]
        out = F.pad(out, widths)
    return torch.where(coarse_solvable, out, torch.zeros_like(out))


def restrict(fine: torch.Tensor, coarse_solvable: torch.Tensor) -> torch.Tensor:
    """Full-weighting restriction, masked to the coarse solvable set."""
    return fit_coarse(restrict_natural(fine), coarse_solvable)


def _prolong_axis(x: torch.Tensor, axis: int, margin: int = 0) -> torch.Tensor:
    """1-D linear upsampling along `axis` (2x the restriction transpose):
    out[2c] = 0.25 x[c-1] + 0.75 x[c],  out[2c+1] = 0.75 x[c] + 0.25 x[c+1]
    (x zero past both ends, or carrying a one-cell `margin` there)."""
    c = x.shape[axis] - 2 * margin
    xp = x if margin else _pad_axis(x, axis, 1, 1)
    lo, mid, hi = (_sl(xp, axis, slice(s, s + c)) for s in range(3))
    even = 0.25 * lo + 0.75 * mid
    odd = 0.75 * mid + 0.25 * hi
    stacked = torch.stack((even, odd), dim=axis + 1)
    shape = list(x.shape)
    shape[axis] = 2 * c
    return stacked.reshape(shape)


def prolong(coarse: torch.Tensor, margin=(0, 0, 0)) -> torch.Tensor:
    """Trilinear interpolation of a coarse field onto the fine grid, scaled
    4x; `coarse` carries a one-cell margin on the axes where `margin` is 1."""
    out = coarse
    for axis in range(3):
        out = _prolong_axis(out, axis, int(margin[axis]))
    return 4.0 * out


def prolong_add(
    fine_x: torch.Tensor, coarse_x: torch.Tensor, fine_solvable: torch.Tensor, margin=(0, 0, 0)
) -> torch.Tensor:
    """fine_x += 4 * trilerp(coarse_x), masked to the fine solvable set;
    `coarse_x` carries a one-cell margin on the axes where `margin` is 1
    (and its lane padding, cut here, on the others)."""
    natural = tuple(s // 2 + 2 * int(m) for s, m in zip(fine_x.shape, margin))
    if tuple(coarse_x.shape) != natural:
        coarse_x = coarse_x[tuple(slice(0, s) for s in natural)]
    up = prolong(coarse_x, margin)
    return torch.where(fine_solvable, fine_x + up, fine_x)


@functools.lru_cache(maxsize=None)
def _band(rows: int, cols: int, shift: int, live: int) -> np.ndarray:
    """(rows, cols) float64 matrix M[r, c] = w[r - 2c + shift] for the
    columns c < live, zero elsewhere."""
    m = np.zeros((rows, cols), dtype=np.float64)
    for c in range(live):
        for k, w in enumerate(_R_WEIGHTS):
            r = 2 * c - shift + k
            if 0 <= r < rows:
                m[r, c] = w
    return m


def restrict_matrix(n_fine: int, n_coarse: int) -> np.ndarray:
    """(n_fine, n_coarse) separable restriction matrix R (JAX
    `_restrict_matrix_np`): R[2c-1+k, c] = w[k]; the columns past the
    natural half (the coarse lane padding) stay zero.  Prolongation along
    the axis is 2 R^T."""
    return _band(n_fine, n_coarse, 1, n_fine // 2)


@functools.lru_cache(maxsize=256)
def _matrix(rows: int, cols: int, shift: int, live: int, scale: float, device, dtype) -> torch.Tensor:
    """`scale` * `_band(...)` as a tensor, made once per device and dtype:
    never during a CUDA graph capture, which would take it from the
    graph's memory pool and copy it from the host (`prepare`)."""
    if torch.device(device).type == "cuda" and torch.cuda.is_current_stream_capturing():
        raise RuntimeError("the transfer matrices must exist before a CUDA graph capture (transfer.prepare)")
    return torch.as_tensor(scale * _band(rows, cols, shift, live), dtype=dtype, device=device)


def prepare(shapes, device, dtypes) -> None:
    """Make the matrix form's matrices (cached) for levels of `shapes`, in
    each of `dtypes`: one restriction and one prolong-add per pair of
    levels on zero fields."""
    for dtype in dtypes:
        for fine, coarse in zip(shapes, shapes[1:]):
            f = torch.zeros(fine, dtype=dtype, device=device)
            c = torch.zeros(coarse, dtype=dtype, device=device)
            restrict_mm(f, torch.ones(coarse, dtype=torch.bool, device=device))
            prolong_add_mm(f, c, torch.ones(fine, dtype=torch.bool, device=device))


def restrict_axis_matrix(x: torch.Tensor, axis: int, n_out: int, margin: int) -> torch.Tensor:
    """(n_out, n_in) restriction matrix R^T of `x`'s `axis`, which carries
    a `margin`-cell margin on both sides (a transposed view)."""
    n_in = x.shape[axis]
    return _matrix(n_in, n_out, 1 - margin, (n_in - 2 * margin) // 2, 1.0, x.device, x.dtype).t()


def prolong_axis_matrix(n_fine: int, x: torch.Tensor, axis: int, margin: int) -> torch.Tensor:
    """(n_fine, n_in) prolongation matrix 2 R^T of `x`'s (coarse) `axis`,
    which carries a `margin`-cell margin on both sides."""
    return _matrix(n_fine, x.shape[axis], 1 + 2 * margin, n_fine // 2 + 2 * margin, 2.0, x.device, x.dtype)


def axis_product(x: torch.Tensor, a: torch.Tensor, axis: int) -> torch.Tensor:
    """x with its `axis` (length n_in) replaced by a @ that axis, for a
    (n_out, n_in) matrix `a`; the result is contiguous."""
    shape = list(x.shape)
    n_in, shape[axis] = shape[axis], a.shape[0]
    if axis == 0:
        return torch.matmul(a, x.reshape(n_in, -1)).view(shape)
    if axis == 1:
        return torch.matmul(a, x)
    return torch.matmul(x.reshape(-1, n_in), a.t()).view(shape)


def _restrict_products(fine: torch.Tensor, out_shape, margin) -> torch.Tensor:
    out = fine
    with blas.ieee_products():
        for axis in range(3):
            r = restrict_axis_matrix(out, axis, int(out_shape[axis]), int(margin[axis]))
            out = axis_product(out, r, axis)
    return out


def restrict_mm(fine: torch.Tensor, coarse_solvable: torch.Tensor) -> torch.Tensor:
    """Full-weighting restriction as three per-axis matrix products, masked
    to the coarse solvable set (the coarse lane padding comes from the
    matrix's zero columns)."""
    out = _restrict_products(fine, coarse_solvable.shape, (0, 0, 0))
    return torch.where(coarse_solvable, out, 0.0)


def restrict_natural_mm(fine: torch.Tensor, margin=(0, 0, 0)) -> torch.Tensor:
    """`restrict_natural` as matrix products: the unmasked half-resolution
    restriction of `fine`, which carries a one-cell margin on the axes
    where `margin` is 1."""
    out_shape = tuple((n - 2 * int(m)) // 2 for n, m in zip(fine.shape, margin))
    return _restrict_products(fine, out_shape, margin)


def prolong_add_mm(
    fine_x: torch.Tensor, coarse_x: torch.Tensor, fine_solvable: torch.Tensor, margin=(0, 0, 0)
) -> torch.Tensor:
    """fine_x += 4 * trilerp(coarse_x) through the transposed restriction
    matrices (2 R^T per axis), masked to the fine solvable set: exactly
    adjoint to `restrict_mm`.  `coarse_x` carries a one-cell margin on the
    axes where `margin` is 1 (and may carry its lane padding on the
    others).  The x4 and the add ride the last product (exact x4, one
    rounding of fine_x + 4 up, as the JAX package rounds it)."""
    up = coarse_x
    nf = fine_x.shape
    with blas.ieee_products():
        for axis in (0, 1):
            up = axis_product(up, prolong_axis_matrix(nf[axis], up, axis, int(margin[axis])), axis)
        p = prolong_axis_matrix(nf[2], up, 2, int(margin[2]))
        out = torch.addmm(fine_x.reshape(-1, nf[2]), up.reshape(-1, up.shape[2]), p.t(), alpha=4).view(nf)
    return torch.where(fine_solvable, out, fine_x)


class Form(NamedTuple):
    """One form of the transfers: whole-level restriction (masked, lane
    padded), the natural restriction of a block with its margin, and the
    prolong-add."""

    restrict: Callable
    restrict_natural: Callable
    prolong_add: Callable


def form(mm: bool) -> Form:
    """The matrix-product form of the transfers, or the slice form."""
    if mm:
        return Form(restrict_mm, restrict_natural_mm, prolong_add_mm)
    return Form(restrict, restrict_natural, prolong_add)
