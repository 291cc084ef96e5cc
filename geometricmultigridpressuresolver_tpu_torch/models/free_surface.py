"""Free-surface pressure projection pipeline (PyTorch port).

Port of ``models/free_surface.py``: SDF / velocity tensors in, pressure and
projected velocity out.

  1. material labels from the liquid (and optional solid) SDF and cut-cell
     weights; 2. valid faces; 3. MG labels (LIQUID->INTERIOR,
     AIR->DIRICHLET, SOLID->EXTERIOR) and boundary weights = cut-cell weight
     / clamped ghost-fluid theta on liquid-air faces; 4. far-field Dirichlet
     trimming and the compact, lane-aligned multigrid window; hierarchy;
  5. RHS = negative cut-cell divergence; 6. optional warm start;
  7. MGPCG solve; 8. pressure writeback and velocity -= grad p on valid
     faces; 9. post-projection divergence audit.

`build_setup` runs steps 1-4 on `device`; `project` runs steps 5-9 on the
device that holds the setup.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from geometricmultigridpressuresolver_tpu_torch.config import SolverConfig
from geometricmultigridpressuresolver_tpu_torch.grids import CellLabel, MaterialLabel, face_shape
from geometricmultigridpressuresolver_tpu_torch.ops import domain as domain_ops
from geometricmultigridpressuresolver_tpu_torch.solver import cg as cg_mod
from geometricmultigridpressuresolver_tpu_torch.solver import mg as mg_mod
from geometricmultigridpressuresolver_tpu_torch.solver import mgpcg

SOLID = int(MaterialLabel.SOLID)
LIQUID = int(MaterialLabel.LIQUID)
AIR = int(MaterialLabel.AIR)


def _sl(axis: int, sl: slice) -> tuple:
    out = [slice(None)] * 3
    out[axis] = sl
    return tuple(out)


def _lo_hi(arr, axis):
    return arr[_sl(axis, slice(0, -1))], arr[_sl(axis, slice(1, None))]


def _pad_axis(arr, axis, before, after, fill):
    pads = [(0, 0)] * 3
    pads[axis] = (before, after)
    return domain_ops.pad(arr, pads, fill)


def ghost_fluid_theta(phi0, phi1):
    """Fraction of the face segment inside the liquid."""
    denom01 = phi0 - phi1
    denom10 = phi1 - phi0
    safe01 = torch.where(denom01 == 0, 1.0, denom01)
    safe10 = torch.where(denom10 == 0, 1.0, denom10)
    return torch.where(
        phi0 < 0,
        torch.where(phi1 < 0, 1.0, phi0 / safe01),
        torch.where(phi1 < 0, phi1 / safe10, 0.0),
    )


def build_material_labels(liquid_phi, cut_cell_weights: Sequence, solid_phi=None):
    """SOLID unless an incident face is open; then LIQUID if the cell is
    liquid (or a solid cell with an open face to a liquid neighbour), else
    AIR."""
    has_open = torch.zeros(liquid_phi.shape, dtype=torch.bool, device=liquid_phi.device)
    for axis in range(3):
        lo, hi = _lo_hi(cut_cell_weights[axis], axis)
        has_open = has_open | (lo > 0) | (hi > 0)
    liquid = liquid_phi <= 0.0
    if solid_phi is not None:
        in_solid = solid_phi >= 0.0
        extra = torch.zeros_like(has_open)
        for axis in range(3):
            open_face = cut_cell_weights[axis][_sl(axis, slice(1, -1))] > 0
            phi_lo, phi_hi = _lo_hi(liquid_phi, axis)
            extra = extra | _pad_axis(open_face & (phi_hi <= 0), axis, 0, 1, False)
            extra = extra | _pad_axis(open_face & (phi_lo <= 0), axis, 1, 0, False)
        liquid = liquid | (in_solid & extra)
    return torch.where(has_open, torch.where(liquid, LIQUID, AIR), SOLID).to(torch.int8)


def classify_valid_faces(material, cut_cell_weights: Sequence) -> list:
    """A face is valid iff its weight > 0, both cells are in bounds, and at
    least one adjacent cell is LIQUID."""
    valid = []
    for axis in range(3):
        lo_lbl, hi_lbl = _lo_hi(material, axis)
        inner = cut_cell_weights[axis][_sl(axis, slice(1, -1))] > 0
        v_int = inner & ((lo_lbl == LIQUID) | (hi_lbl == LIQUID))
        valid.append(_pad_axis(v_int, axis, 1, 1, False))
    return valid


class ProjectionSetup(NamedTuple):
    """Per-frame solver data.

    The multigrid domain is a window into the exterior-padded base grid:
    ``expanded[j] = padded_base[window_start + j]``.  Only the primary fields
    persist (material labels, cut-cell weights, liquid SDF); valid faces and
    gradient scales are recomputed in `project`.
    """

    problem: mgpcg.PoissonProblem
    material: torch.Tensor                # int8, base shape
    weights: tuple[torch.Tensor, ...]     # cut-cell weights, solve dtype
    liquid_phi: torch.Tensor              # liquid SDF, solve dtype
    window_start: tuple[int, int, int]    # window origin, padded-base coords
    expanded_shape: tuple[int, int, int]
    base_pads: tuple[tuple[int, int], ...]
    padding: int                          # multigrid exterior padding
    mg_levels: int

    @property
    def liquid_mask(self) -> torch.Tensor:
        return self.material == LIQUID


def _face_inv_theta(material, liquid_phi, axis: int, theta_clamp: float, dtype):
    """Face-shaped 1/theta on liquid-air faces (1 elsewhere), clamped."""
    lbl_lo, lbl_hi = _lo_hi(material, axis)
    phi_lo, phi_hi = _lo_hi(liquid_phi, axis)
    liquid_air = ((lbl_lo == LIQUID) & (lbl_hi == AIR)) | ((lbl_lo == AIR) & (lbl_hi == LIQUID))
    theta = torch.clamp(ghost_fluid_theta(phi_lo, phi_hi), theta_clamp, 1.0).to(dtype)
    return _pad_axis(
        torch.where(liquid_air, 1.0 / theta, torch.ones_like(theta)), axis, 1, 1, 1.0
    )


def face_projection_fields(material, liquid_phi, cut_cell_weights, theta_clamp: float, dtype):
    """(valid_faces, grad_scale): grad_scale is 1/theta on valid liquid-air
    faces, 1 elsewhere."""
    valid = classify_valid_faces(material, cut_cell_weights)
    grad_scale = []
    for axis in range(3):
        inv_theta = _face_inv_theta(material, liquid_phi, axis, theta_clamp, dtype)
        grad_scale.append(torch.where(valid[axis], inv_theta, torch.ones_like(inv_theta)))
    return valid, grad_scale


def _setup_base_fields(liquid_phi, cut_cell_weights, solid_phi, theta_clamp: float, dtype,
                       dirichlet_band: int):
    """Steps 1-3 on the base grid.  Returns (material, mg_labels, trimmed,
    mg_weights, (proj_x, proj_y, proj_z) numpy, non-EXTERIOR count)."""
    material = build_material_labels(liquid_phi, cut_cell_weights, solid_phi)
    valid = classify_valid_faces(material, cut_cell_weights)
    mg_labels = torch.where(
        material == LIQUID,
        int(CellLabel.INTERIOR),
        torch.where(material == AIR, int(CellLabel.DIRICHLET), int(CellLabel.EXTERIOR)),
    ).to(torch.int8)
    mg_weights = []
    for axis in range(3):
        w = cut_cell_weights[axis].to(dtype)
        inv_theta = _face_inv_theta(material, liquid_phi, axis, theta_clamp, dtype)
        mg_weights.append(torch.where(valid[axis], w * inv_theta, torch.zeros_like(w)))
    trimmed = domain_ops.trim_far_dirichlet(mg_labels, dirichlet_band)
    non_ext = trimmed != int(CellLabel.EXTERIOR)
    projections = tuple(
        non_ext.any(dim=dims).cpu().numpy() for dims in ((1, 2), (0, 2), (0, 1))
    )
    return material, mg_labels, trimmed, mg_weights, projections, int(non_ext.sum())


def _window(arr, start, base_pads, out_shape, fill):
    """out[j] = padded_base[start + j], padded with `fill`."""
    padded = domain_ops.pad(arr, base_pads, fill)
    return padded[tuple(slice(s, s + n) for s, n in zip(start, out_shape))].contiguous()


def _expand_window_fields(mg_labels, mg_weights, start, base_pads, expanded_shape):
    """Step 4: slice the multigrid window out of the exterior-padded base and
    relabel INTERIOR -> BOUNDARY where needed."""
    base = torch.where(
        mg_labels == int(CellLabel.BOUNDARY), int(CellLabel.INTERIOR), mg_labels
    ).to(torch.int8)
    labels = _window(base, start, base_pads, expanded_shape, int(CellLabel.EXTERIOR))
    exp_weights = [
        _window(mg_weights[axis], start, base_pads, face_shape(expanded_shape, axis), 0.0)
        for axis in range(3)
    ]
    return domain_ops.set_boundary_labels(labels, exp_weights), exp_weights


def _shape(a) -> tuple:
    return tuple(a.shape) if hasattr(a, "shape") else np.shape(a)


def validate_fields(liquid_phi, cut_cell_weights, velocity=None, solid_phi=None) -> None:
    """Shape validation with the reference node's error semantics."""
    shape = _shape(liquid_phi)
    if len(shape) != 3:
        raise ValueError(f"surface field must be a 3-D cell grid, got {shape}")
    if len(cut_cell_weights) != 3:
        raise ValueError("cut-cell weights must have one array per axis")
    for axis in range(3):
        want = face_shape(shape, axis)
        got = _shape(cut_cell_weights[axis])
        if got != want:
            raise ValueError(
                "cut-cell weights must align with the velocity field: axis "
                f"{axis} expected {want}, got {got}"
            )
    if velocity is not None:
        for axis in range(3):
            want = face_shape(shape, axis)
            got = _shape(velocity[axis])
            if got != want:
                raise ValueError(
                    f"velocity must be face sampled: axis {axis} expected {want}, got {got}"
                )
    if solid_phi is not None and _shape(solid_phi) != shape:
        raise ValueError(
            "collision surface must align with the liquid surface: expected "
            f"{shape}, got {_shape(solid_phi)}"
        )


def validate_density(density) -> float | None:
    """Constant-density validation: None, a scalar, or a constant array."""
    if density is None:
        return None
    arr = np.asarray(density.cpu() if isinstance(density, torch.Tensor) else density)
    if arr.size > 1 and not np.all(arr == arr.flat[0]):
        raise ValueError("Variable density is not currently supported")
    return float(arr.flat[0])


def build_setup(
    liquid_phi,
    cut_cell_weights: Sequence,
    solid_phi=None,
    config: SolverConfig | None = None,
    validate: bool = False,
    density=None,
    device=None,
) -> ProjectionSetup:
    """Steps 1-4 on `device` (default: liquid_phi's device, CPU for numpy):
    labels, valid faces, MG domain and weights, the compact window and the
    hierarchy."""
    if config is None:
        config = SolverConfig()
    validate_density(density)
    validate_fields(liquid_phi, cut_cell_weights, solid_phi=solid_phi)
    sd = config.solve_dtype
    dev = mg_mod._device_of(liquid_phi, device)
    liquid_phi = torch.as_tensor(liquid_phi, dtype=sd, device=dev)
    cut_cell_weights = tuple(torch.as_tensor(w, dtype=sd, device=dev) for w in cut_cell_weights)
    if solid_phi is not None:
        solid_phi = torch.as_tensor(solid_phi, dtype=sd, device=dev)

    material, mg_labels, trimmed, mg_weights, projections, non_ext_count = _setup_base_fields(
        liquid_phi, cut_cell_weights, solid_phi, config.theta_clamp, sd, config.dirichlet_band
    )
    base_shape = tuple(liquid_phi.shape)
    if config.compact_domain:
        window_labels = trimmed
        if non_ext_count == 0:
            # No liquid: a tiny all-EXTERIOR window keeps everything
            # well-formed, and the zero-RHS early-out makes the solve free.
            mg_levels, padding = 2, 2
            bbox = tuple((s // 2, s // 2 + 1) for s in base_shape)
            expanded_shape = (8, 8, 8)
        else:
            mg_levels, padding, bbox, expanded_shape = domain_ops.compact_expansion_params(
                projections, non_ext_count=non_ext_count,
                coarse_dof_target=config.coarse_dof_target,
            )
    else:
        mg_levels, padding, expanded_shape = domain_ops.expansion_params(base_shape)
        bbox = tuple((0, n) for n in base_shape)
        window_labels = mg_labels

    # Base padding of at least `padding`, enough that the window fits; the
    # window keeps a leading exterior margin of at least `padding`.
    base_pads = tuple(
        (padding, max(padding, e - b - padding)) for e, b in zip(expanded_shape, base_shape)
    )
    start = tuple(
        min(lo, b + plo + phi - e)
        for (lo, _), b, (plo, phi), e in zip(bbox, base_shape, base_pads, expanded_shape)
    )
    labels, exp_weights = _expand_window_fields(
        window_labels, mg_weights, start, base_pads, tuple(expanded_shape)
    )
    if validate:
        assert domain_ops.check_boundary_cells(labels, exp_weights)
        assert domain_ops.check_exterior_shell(labels)

    mg_dtype, fine_dtype, fine_full = mgpcg.fine_plan(config)
    target_levels = mg_levels
    if config.max_mg_levels is not None:
        target_levels = min(target_levels, config.max_mg_levels)
    levels, flags, label_levels, fine = mg_mod._build_levels(
        labels, exp_weights, target_levels, config.boundary_width, mg_dtype,
        config.mg_ew_dtype, fine_dtype, fine_full,
    )
    hier = mg_mod._finish_hierarchy(
        levels, flags, label_levels, config, validate=validate, host_fw=exp_weights
    )
    return ProjectionSetup(
        problem=mgpcg._finish_problem(hier, fine, fine_full),
        material=material,
        weights=cut_cell_weights,
        liquid_phi=liquid_phi,
        window_start=start,
        expanded_shape=tuple(labels.shape),
        base_pads=base_pads,
        padding=padding,
        mg_levels=mg_levels,
    )


def embed_window(base, window_start, base_pads, expanded_shape) -> torch.Tensor:
    """Window a base-grid cell field into the expanded multigrid domain."""
    return _window(base, window_start, base_pads, expanded_shape, 0)


def extract_window(expanded, window_start, base_pads, base_shape) -> torch.Tensor:
    """Scatter an expanded-domain field back onto the base grid."""
    padded_shape = tuple(b + plo + phi for b, (plo, phi) in zip(base_shape, base_pads))
    buf = expanded.new_zeros(padded_shape)
    buf[tuple(slice(s, s + n) for s, n in zip(window_start, expanded.shape))] = expanded
    return buf[tuple(slice(plo, plo + b) for b, (plo, _) in zip(base_shape, base_pads))]


def negative_divergence(liquid_mask, velocity, weights, solid_velocity=None) -> torch.Tensor:
    """RHS on the base grid: per liquid cell, sum over faces of
    sign * (w u + (1 - w) u_solid), sign +1 on lower faces."""
    div = torch.zeros(liquid_mask.shape, dtype=velocity[0].dtype, device=velocity[0].device)
    for axis in range(3):
        w = weights[axis]
        flux = w * velocity[axis]
        if solid_velocity is not None:
            flux = flux + (1.0 - w) * solid_velocity[axis]
        lo, hi = _lo_hi(flux, axis)
        div = div + lo - hi
    return torch.where(liquid_mask, div, torch.zeros_like(div))


def apply_pressure_gradient(velocity, pressure, valid_faces, grad_scale) -> tuple:
    """v -= grad(p) on valid faces, with the ghost-fluid 1/theta scale."""
    out = []
    for axis in range(3):
        u = velocity[axis]
        inner = _sl(axis, slice(1, -1))
        p_lo, p_hi = _lo_hi(pressure, axis)
        grad = torch.zeros_like(u)
        grad[inner] = (p_hi - p_lo) * grad_scale[axis][inner]
        out.append(torch.where(valid_faces[axis], u - grad, u))
    return tuple(out)


def divergence_stats(liquid_mask, velocity, weights, solid_velocity=None):
    """(max, accumulated, average) divergence over liquid cells (the true
    divergence, + on upper faces)."""
    div = -negative_divergence(liquid_mask, velocity, weights, solid_velocity)
    count = torch.clamp(torch.sum(liquid_mask), min=1)
    total = torch.sum(div)
    return torch.max(torch.abs(div)), total, total / count


class ProjectionResult(NamedTuple):
    pressure: torch.Tensor
    velocity: tuple[torch.Tensor, ...]
    cg: cg_mod.CGResult
    max_divergence: torch.Tensor          # post-projection audit
    avg_divergence: torch.Tensor
    residual_rel_l2: torch.Tensor         # recomputed ||b - A x|| / ||b||
    residual_linf: torch.Tensor
    accumulated_divergence: torch.Tensor


def project(
    setup: ProjectionSetup,
    velocity: Sequence,
    solid_velocity: Sequence | None = None,
    old_pressure=None,
    config: SolverConfig | None = None,
) -> ProjectionResult:
    """Steps 5-9: RHS, warm start, MGPCG solve, writeback, audit, on the
    device that holds `setup` (inputs are moved there)."""
    if config is None:
        config = SolverConfig()
    validate_fields(setup.material, setup.weights, velocity=velocity)
    sd = config.solve_dtype
    dev = setup.liquid_phi.device
    velocity = tuple(torch.as_tensor(v, dtype=sd, device=dev) for v in velocity)
    if solid_velocity is not None:
        solid_velocity = tuple(torch.as_tensor(v, dtype=sd, device=dev) for v in solid_velocity)

    liquid_mask = setup.liquid_mask
    valid_faces, grad_scale = face_projection_fields(
        setup.material, setup.liquid_phi, setup.weights, config.theta_clamp, sd
    )
    rhs_base = negative_divergence(liquid_mask, velocity, setup.weights, solid_velocity)
    rhs = embed_window(rhs_base, setup.window_start, setup.base_pads, setup.expanded_shape)

    x0 = None
    if config.use_old_pressure and old_pressure is not None:
        old = torch.as_tensor(old_pressure, dtype=sd, device=dev)
        warm = torch.where(liquid_mask, old, torch.zeros_like(old))
        x0 = embed_window(warm, setup.window_start, setup.base_pads, setup.expanded_shape)

    cg_result = mgpcg.solve(setup.problem, rhs, x0, config)

    pressure = extract_window(cg_result.x, setup.window_start, setup.base_pads, rhs_base.shape)
    pressure = torch.where(liquid_mask, pressure, torch.zeros_like(pressure))
    rel_l2, linf = cg_mod.recomputed_residual_norms(
        mgpcg.fine_residual(setup.problem, config), cg_result.x, rhs,
        setup.problem.fine.solvable,
    )
    new_velocity = apply_pressure_gradient(velocity, pressure, valid_faces, grad_scale)
    max_div, total_div, avg_div = divergence_stats(
        liquid_mask, new_velocity, setup.weights, solid_velocity
    )
    return ProjectionResult(
        pressure, new_velocity, cg_result, max_div, avg_div, rel_l2, linf, total_div
    )
