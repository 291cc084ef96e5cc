"""Masked grid BLAS on torch tensors.

Dots and norms over the solvable set.  torch's reductions use a fixed
reduction tree for a given size and device (no atomics), so they are
reproducible from run to run, as the reference's per-tile partial sums are.

Across ranks, `ranks` (a `parallel.distributed.Ranks`) turns a rank's
partial over its block into the total: the partials are gathered and
added in rank order (the max likewise), so every rank gets the same bits.
"""

from __future__ import annotations

import torch


def dot(x: torch.Tensor, y: torch.Tensor, solvable: torch.Tensor, ranks=None) -> torch.Tensor:
    xy = x * y
    s = torch.sum(torch.where(solvable, xy, torch.zeros_like(xy)))
    return s if ranks is None else ranks.sum(s)


def squared_l2_norm(x: torch.Tensor, solvable: torch.Tensor, ranks=None) -> torch.Tensor:
    return dot(x, x, solvable, ranks)


def l2_norm(x: torch.Tensor, solvable: torch.Tensor, ranks=None) -> torch.Tensor:
    return torch.sqrt(squared_l2_norm(x, solvable, ranks))


def inf_norm(x: torch.Tensor, solvable: torch.Tensor, ranks=None) -> torch.Tensor:
    ax = torch.abs(x)
    m = torch.max(torch.where(solvable, ax, torch.zeros_like(ax)))
    return m if ranks is None else ranks.max(m)


def scale(x: torch.Tensor, s) -> torch.Tensor:
    """s * x (the reference's scaleVector)."""
    return s * x


def axpy(y: torch.Tensor, scale, x: torch.Tensor) -> torch.Tensor:
    """y + scale * x (the reference's addToVector)."""
    return y + scale * x


def xpay(x: torch.Tensor, scale, y: torch.Tensor) -> torch.Tensor:
    """x + scale * y (the reference's addVectors with a scaled second term)."""
    return x + scale * y


def masked_mean(x: torch.Tensor, solvable: torch.Tensor, ranks=None) -> torch.Tensor:
    """Mean over solvable cells (null-space projection for all-Neumann)."""
    count = torch.sum(solvable.to(x.dtype))
    if ranks is not None:
        count = ranks.sum(count)
    return dot(x, torch.ones_like(x), solvable, ranks) / torch.clamp(count, min=1)


def project_null_space(x: torch.Tensor, solvable: torch.Tensor, ranks=None) -> torch.Tensor:
    """Subtract the solvable-set mean."""
    return torch.where(solvable, x - masked_mean(x, solvable, ranks), x)
