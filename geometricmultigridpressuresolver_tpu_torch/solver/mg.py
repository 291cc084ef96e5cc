"""Geometric multigrid V-cycle engine (PyTorch port of ``solver/mg.py``).

  * build_hierarchy: label coarsening with the JAX package's lane alignment,
    per-level coefficients, capping at the first coarse level without DOFs,
    and the coarsest level's direct solver (dense inverse, or a Cholesky
    factor above COARSE_INVERSE_MAX_PAD DOFs), factored on the host in
    float64 with numpy and moved to the device.
  * v_cycle: a V(1,1) cycle whose smoothing blocks are
    `ops.fused_smoother.smooth_level` (the CUDA kernel on CUDA tensors),
    adjoint GS ordering on the upstroke, 4x trilinear prolongation, and a
    smoothing-only cycle when the hierarchy has one level.

Every smoothed level runs the smoother kernel on the card: the kernel takes
any shape, so there is no per-level eligibility gate.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from geometricmultigridpressuresolver_tpu_torch.config import SolverConfig
from geometricmultigridpressuresolver_tpu_torch.grids import is_solvable
from geometricmultigridpressuresolver_tpu_torch.models import assembled
from geometricmultigridpressuresolver_tpu_torch.ops import domain as domain_ops
from geometricmultigridpressuresolver_tpu_torch.ops import fused_cg, fused_smoother, stencil, transfer

# Largest bucketed coarse system solved through an explicit dense inverse
# (one matmul per cycle); bigger systems use a Cholesky factor.
COARSE_INVERSE_MAX_PAD = 4096


class MGHierarchy(NamedTuple):
    """Static multigrid hierarchy.

    The coarsest direct solver is a dense inverse (small systems) or a lower
    Cholesky factor (large ones); the unused one is a (0, 0) tensor.
    `coarse_dofs` maps bucket slots to flat cell indices of the coarsest
    level; pad slots hold the out-of-range index ncell.
    """

    levels: tuple[stencil.LevelCoeffs, ...]
    coarse_dofs: torch.Tensor  # int64 (nd_pad,)
    coarse_minv: torch.Tensor  # (nd_pad, nd_pad) or (0, 0)
    coarse_chol: torch.Tensor  # (nd_pad, nd_pad) or (0, 0)

    @property
    def num_levels(self) -> int:
        return len(self.levels)


def _level_coeffs(labels, face_weights, boundary_width: int, dtype, ew_dtype) -> stencil.LevelCoeffs:
    """One level's LevelCoeffs; `ew_dtype` optionally narrows the edge-weight
    storage (diag/inv_diag stay in `dtype`, an exact reciprocal pair)."""
    c = domain_ops.build_level_coefficients(labels, face_weights, boundary_width, dtype)
    ew = c["ew"]
    if ew_dtype is not None:
        ew = [w.to(ew_dtype) for w in ew]
    return stencil.LevelCoeffs(
        solvable=c["solvable"],
        band=c["band"].to(torch.int8),
        diag=c["diag"],
        inv_diag=c["inv_diag"],
        ew0=ew[0],
        ew1=ew[1],
        ew2=ew[2],
    )


def _build_levels(
    labels,
    face_weights,
    target_levels: int,
    boundary_width: int,
    dtype,
    ew_dtype=None,
    fine_dtype=None,
    fine_full: bool = False,
):
    """Every level's coefficients plus the capping flags.

    `fine_dtype` additionally builds the finest-level CG operator in the
    solve dtype: the full LevelCoeffs when `fine_full`, else only its three
    edge-weight grids (shared solvable/band/diag/inv_diag).  Returns
    (levels, flags, label_levels, fine); flags[i] says whether level i+1
    has any DOF.
    """
    cur = labels
    label_levels = [cur]
    levels, flags = [], []
    for i in range(target_levels):
        fw_i = face_weights if i == 0 else None
        # Never coarsen past an odd extent (or the cap).
        can_coarsen = i + 1 < target_levels and all(s % 2 == 0 for s in cur.shape)
        levels.append(_level_coeffs(cur, fw_i, boundary_width, dtype, ew_dtype))
        if not can_coarsen:
            break
        coarse = domain_ops.coarsen_labels(cur, lane_align=True)
        flags.append(is_solvable(coarse).any())
        cur = coarse
        label_levels.append(cur)

    fine = None
    if fine_dtype is not None:
        fc = _level_coeffs(labels, face_weights, boundary_width, fine_dtype, None)
        fine = fc if fine_full else (fc.ew0, fc.ew1, fc.ew2)
    return tuple(levels), tuple(flags), tuple(label_levels), fine


def build_hierarchy(
    labels,
    face_weights: Sequence | None,
    mg_levels: int,
    config: SolverConfig | None = None,
    validate: bool = False,
    device=None,
) -> MGHierarchy:
    """Hierarchy from expanded and relabeled finest labels (+ finest weights),
    built on `device` (default: the labels' device, CPU for numpy input)."""
    if config is None:
        config = SolverConfig()
    dtype = config.mg_dtype_resolved
    target_levels = mg_levels
    if config.max_mg_levels is not None:
        target_levels = min(target_levels, config.max_mg_levels)
    dev = _device_of(labels, device)
    cur = torch.as_tensor(labels, device=dev).to(torch.int8)
    fw = None if face_weights is None else tuple(
        torch.as_tensor(w, dtype=dtype, device=dev) for w in face_weights
    )
    levels, flags, label_levels, _ = _build_levels(
        cur, fw, target_levels, config.boundary_width, dtype, config.mg_ew_dtype
    )
    return _finish_hierarchy(levels, flags, label_levels, config, validate=validate, host_fw=fw)


def _device_of(arr, device) -> torch.device:
    if device is not None:
        return torch.device(device)
    if isinstance(arr, torch.Tensor):
        return arr.device
    return torch.device("cpu")


def _finish_hierarchy(
    levels, flags, label_levels, config: SolverConfig, validate: bool = False, host_fw=None
) -> MGHierarchy:
    """Level capping and the coarsest direct solver (host side)."""
    dtype = config.mg_dtype_resolved
    levels = list(levels)
    label_levels = list(label_levels)
    for i, ok in enumerate(flags):
        if not bool(ok):
            levels = levels[: i + 1]
            label_levels = label_levels[: i + 1]
            break

    if validate:
        label_host = [lv.cpu() for lv in label_levels]
        fw_host = None if host_fw is None else [w.cpu() for w in host_fw]
        assert domain_ops.check_exterior_shell(label_host[0])
        assert domain_ops.check_boundary_cells(label_host[0], fw_host)
        for fine, coarse_lv in zip(label_host, label_host[1:]):
            assert domain_ops.check_coarsening(fine, coarse_lv)
            assert domain_ops.check_boundary_cells(coarse_lv, None)

    device = levels[0].diag.device
    coarsest = label_levels[-1].cpu().numpy()
    a, idx = assembled.assemble_poisson(coarsest, None)
    ndof = a.shape[0]
    if ndof > 16384:
        raise ValueError(
            f"coarsest level has {ndof} DOFs; increase mg levels "
            "(dense coarse solve would be too large)"
        )
    # Bucketed DOF count: pad slots get an identity block, so
    # block_diag(A, I)^-1 = block_diag(A^-1, I).
    nd_pad = max(256, -(-ndof // 256) * 256) if ndof else 0
    empty = torch.zeros((0, 0), dtype=dtype, device=device)
    minv = chol = empty
    if ndof:
        a_pad = np.eye(nd_pad)
        a_pad[:ndof, :ndof] = a.toarray()
        if nd_pad > COARSE_INVERSE_MAX_PAD:
            chol = torch.as_tensor(np.linalg.cholesky(a_pad), dtype=dtype, device=device)
        else:
            minv = torch.as_tensor(np.linalg.inv(a_pad), dtype=dtype, device=device)
            minv = 0.5 * (minv + minv.T)  # exactly symmetric preconditioner
    dofs = np.flatnonzero(np.asarray(idx).ravel() >= 0)
    dofs = np.pad(dofs, (0, nd_pad - ndof), constant_values=idx.size)
    return MGHierarchy(
        levels=tuple(levels),
        coarse_dofs=torch.as_tensor(dofs, dtype=torch.int64, device=device),
        coarse_minv=minv,
        coarse_chol=chol,
    )


def coarse_solve(hier: MGHierarchy, b: torch.Tensor) -> torch.Tensor:
    """Direct solve on the coarsest level: gather DOFs, apply the inverse
    (one matmul) or the Cholesky factor, scatter back.

    Pad slots carry the index ncell: the gather clamps it (the identity pad
    block keeps real rows clean), and the scatter sends pad slots to a spare
    element past the grid that is then dropped.
    """
    ncell = b.numel()
    dofs = hier.coarse_dofs
    bv = b.reshape(-1)[dofs.clamp(max=max(ncell - 1, 0))]
    if hier.coarse_chol.shape[0] > 0:
        xv = torch.cholesky_solve(bv[:, None], hier.coarse_chol).squeeze(1)
    else:
        xv = torch.matmul(hier.coarse_minv, bv)
    flat = b.new_zeros(ncell + 1)
    flat.index_copy_(0, dofs, xv)
    return flat[:ncell].reshape(b.shape)


def v_cycle(
    hier: MGHierarchy,
    x,
    b: torch.Tensor,
    config: SolverConfig | None = None,
    use_initial_guess: bool = False,
    emit_fine_dot: bool = False,
):
    """One V(1,1) multigrid cycle; returns the updated solution grid, or
    (x, <x, b>) with `emit_fine_dot` (the CG rho when b is the CG residual).

    Without `use_initial_guess` the cycle starts from x = 0 and `x` may be
    None.
    """
    if config is None:
        config = SolverConfig()
    dtype = hier.levels[0].diag.dtype
    b = b.to(dtype)
    if use_initial_guess:
        x = x.to(dtype)
    nlev = hier.num_levels

    if nlev == 1:
        # Single-level cycle is smoothing-only.
        return fused_smoother.smooth_level(
            x, b, hier.levels[0], config, forward=True, emit_dot=emit_fine_dot,
            x_is_zero=not use_initial_guess,
        )

    # Downstroke.  Every level but a warm-started finest one enters with
    # x == 0: the smoother then skips reading x and emits the residual.
    rhs = [b] + [None] * (nlev - 1)
    sols = [None] * nlev
    for level in range(nlev - 1):
        c = hier.levels[level]
        if level > 0 or not use_initial_guess:
            xl, r = fused_smoother.smooth_level(
                None, rhs[level], c, config, forward=True, x_is_zero=True,
                emit_residual=True,
            )
        else:
            xl = fused_smoother.smooth_level(x, rhs[level], c, config, forward=True)
            r = fused_cg.residual(
                xl, rhs[level], c.diag, c.ew0, c.ew1, c.ew2, mode=config.kernel_mode
            )
        sols[level] = xl
        rhs[level + 1] = transfer.restrict(r, hier.levels[level + 1].solvable)

    sols[nlev - 1] = coarse_solve(hier, rhs[nlev - 1])

    # Upstroke with adjoint smoother ordering.
    for level in range(nlev - 2, -1, -1):
        c = hier.levels[level]
        xl = transfer.prolong_add(sols[level], sols[level + 1], c.solvable)
        sols[level] = fused_smoother.smooth_level(
            xl, rhs[level], c, config, forward=False,
            emit_dot=emit_fine_dot and level == 0,
        )
    return sols[0]
