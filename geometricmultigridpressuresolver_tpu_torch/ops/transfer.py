"""Inter-level transfers: full-weighting restriction and 4x trilinear
prolongation (the slice form of
``geometricmultigridpressuresolver_tpu.ops.transfer``).

Per axis, restriction is y[c] = sum_k w[k] x[2c-1+k] with w = (1/8, 3/8,
3/8, 1/8), and prolongation is twice its transpose, so the pair stays
adjoint to rounding.  A coarse level may carry trailing EXTERIOR lane
padding (`ops.domain.coarse_lane_pad`): restriction zero-pads its natural
half-resolution result to the coarse shape and prolongation reads only the
natural region -- the exact transpose of each other.

Both assume fields are zero outside the solvable set and mask their output
to the destination level's solvable set.

Across ranks (a `parallel.mesh.DistMesh`) a rank holds a block of a split
level, and both transfers read one neighbour cell on each side of it
(restriction x[2c-1] and x[2c+2], prolongation x[c-1] and x[c+1]; JAX
transfer.py:90-110, :132-157).  The caller hands them the block grown by
a one-cell `margin` on those axes (a one-cell halo exchange, or a slice
of a replicated coarse grid with zeros past its edge); an axis with a
margin is not zero-padded, and the result covers the block's own cells.
Every output cell is formed from the same inputs in the same order as on
one device, so a rank's block is bit-equal to that block of the whole
transfer.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

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
