"""Masked grid BLAS on torch tensors.

Dots and norms over the solvable set.  torch's reductions use a fixed
reduction tree for a given size and device (no atomics), so they are
reproducible from run to run, as the reference's per-tile partial sums are.
"""

from __future__ import annotations

import torch


def dot(x: torch.Tensor, y: torch.Tensor, solvable: torch.Tensor) -> torch.Tensor:
    xy = x * y
    return torch.sum(torch.where(solvable, xy, torch.zeros_like(xy)))


def squared_l2_norm(x: torch.Tensor, solvable: torch.Tensor) -> torch.Tensor:
    return dot(x, x, solvable)


def l2_norm(x: torch.Tensor, solvable: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(squared_l2_norm(x, solvable))


def inf_norm(x: torch.Tensor, solvable: torch.Tensor) -> torch.Tensor:
    ax = torch.abs(x)
    return torch.max(torch.where(solvable, ax, torch.zeros_like(ax)))


def masked_mean(x: torch.Tensor, solvable: torch.Tensor) -> torch.Tensor:
    """Mean over solvable cells (null-space projection for all-Neumann)."""
    count = torch.sum(solvable.to(x.dtype))
    return dot(x, torch.ones_like(x), solvable) / torch.clamp(count, min=1)


def project_null_space(x: torch.Tensor, solvable: torch.Tensor) -> torch.Tensor:
    """Subtract the solvable-set mean."""
    return torch.where(solvable, x - masked_mean(x, solvable), x)
