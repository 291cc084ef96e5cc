"""Masked grid BLAS on torch tensors.

Dots and norms over the solvable set.  torch's reductions use a fixed
reduction tree for a given size and device (no atomics), so they are
reproducible from run to run, as the reference's per-tile partial sums are.

Across ranks, `ranks` (a `parallel.distributed.Ranks`) turns a rank's
partial over its block into the total: the partials are gathered and
added in rank order (the max likewise), so every rank gets the same bits.

`ieee_products` scopes the card's matrix products to IEEE arithmetic: the
JAX package asks for ``precision=HIGHEST`` on each product, torch has only
process-wide settings.
"""

from __future__ import annotations

import contextlib

import torch


def _bf16_reduction():
    m = torch.backends.cuda.matmul
    try:
        return (m.allow_bf16_reduced_precision_reduction, m.allow_bf16_reduced_precision_reduction_split_k)
    except AttributeError:  # torch without the split-K setting
        return m.allow_bf16_reduced_precision_reduction


@contextlib.contextmanager
def ieee_products():
    """Matrix products inside the block run in IEEE fp32 (no TF32) and bf16
    products reduce in fp32 (no reduced-precision split-K), whatever the
    caller set with ``torch.backends.cuda.matmul.allow_tf32``,
    ``fp32_precision`` or ``torch.set_float32_matmul_precision``; the
    caller's settings are back unchanged after it.  Only the per-backend
    setting is touched (the legacy getters raise while the two APIs
    disagree, and cuBLAS reads the per-backend one)."""
    m = torch.backends.cuda.matmul
    new_api = hasattr(m, "fp32_precision")
    tf32 = m.fp32_precision if new_api else m.allow_tf32
    bf16 = _bf16_reduction()
    if new_api:
        m.fp32_precision = "ieee"
    else:
        m.allow_tf32 = False
    m.allow_bf16_reduced_precision_reduction = False
    try:
        yield
    finally:
        if new_api:
            m.fp32_precision = tf32
        else:
            m.allow_tf32 = tf32
        m.allow_bf16_reduced_precision_reduction = bf16


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
