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
device that holds the setup.  In a frame loop, `build_setup(reuse_from=
previous_setup)` keeps the window shape sticky while the liquid fits.
On the card step 4 with the hierarchy (`_expand_build_device`, at the
granularity `config.setup_fusion` sets) and the whole of steps 5-9 are
programs captured once per key and replayed after that
(`solver.graph.PROGRAMS`): a kept window replays them whatever its
origin, which the programs read from the device.  Their results are
copies the caller owns.

Across ranks (`mesh=` a `parallel.mesh.DistMesh`) both run partitioned
(`parallel.sharding.partitioned_setup` / `partitioned_project`, the
counterpart of the JAX package's SPMD setup and projection): each rank
computes steps 1-3 on its base block grown by a halo, the window and
every level the mesh splits on its block of them, and steps 5-9 on its
blocks, so no rank holds a whole split grid.  The window origin is a
static tuple, as `window_start_static` is in the JAX package's sharded
setup.  The inputs may be whole grids or the rank's blocks
(`distributed.make_global_grid`, with the base grid's global shape); the
outputs are the rank's blocks (`distributed.gather_blocks` assembles a
grid).
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from geometricmultigridpressuresolver_tpu_torch import device as device_mod
from geometricmultigridpressuresolver_tpu_torch.config import SolverConfig
from geometricmultigridpressuresolver_tpu_torch.grids import CellLabel, MaterialLabel, face_shape
from geometricmultigridpressuresolver_tpu_torch.ops import domain as domain_ops
from geometricmultigridpressuresolver_tpu_torch.parallel import sharding
from geometricmultigridpressuresolver_tpu_torch.parallel.mesh import DistMesh
from geometricmultigridpressuresolver_tpu_torch.solver import cg as cg_mod
from geometricmultigridpressuresolver_tpu_torch.solver import graph
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


def valid_faces_axis(material, weights, axis: int):
    """`classify_valid_faces` along one axis (`weights` that axis's face
    array over the cells of `material`)."""
    lo_lbl, hi_lbl = _lo_hi(material, axis)
    inner = weights[_sl(axis, slice(1, -1))] > 0
    v_int = inner & ((lo_lbl == LIQUID) | (hi_lbl == LIQUID))
    return _pad_axis(v_int, axis, 1, 1, False)


def classify_valid_faces(material, cut_cell_weights: Sequence) -> list:
    """A face is valid iff its weight > 0, both cells are in bounds, and at
    least one adjacent cell is LIQUID."""
    return [valid_faces_axis(material, cut_cell_weights[axis], axis) for axis in range(3)]


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
    # The base grid's global shape when the fields hold a rank's blocks
    # (`parallel.sharding.partitioned_setup` / `shard_setup`), else None.
    base_shape: tuple[int, int, int] | None = None

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


def face_fields_axis(material, liquid_phi, weights, axis: int, theta_clamp: float, dtype):
    """(valid, grad_scale) of the faces along one axis."""
    valid = valid_faces_axis(material, weights, axis)
    inv_theta = _face_inv_theta(material, liquid_phi, axis, theta_clamp, dtype)
    return valid, torch.where(valid, inv_theta, torch.ones_like(inv_theta))


def face_projection_fields(material, liquid_phi, cut_cell_weights, theta_clamp: float, dtype):
    """(valid_faces, grad_scale): grad_scale is 1/theta on valid liquid-air
    faces, 1 elsewhere."""
    fields = [face_fields_axis(material, liquid_phi, cut_cell_weights[axis], axis, theta_clamp, dtype)
              for axis in range(3)]
    return [v for v, _ in fields], [g for _, g in fields]


def _setup_base_fields(liquid_phi, cut_cell_weights, solid_phi, theta_clamp: float, dtype,
                       dirichlet_band: int, host: bool = True):
    """Steps 1-3 on the base grid.  Returns (material, mg_labels, trimmed,
    mg_weights, (proj_x, proj_y, proj_z), non-EXTERIOR count): the
    occupancy projections and the count on the host (numpy, int) for
    `build_setup`'s window decisions, or with `host=False` as device
    tensors, read by nothing on the host (the frozen frame of
    `models.simulate.run_fused`, as the JAX package keeps them)."""
    fields = base_label_fields(liquid_phi, cut_cell_weights, solid_phi, theta_clamp, dtype, dirichlet_band)
    return fields + occupancy(fields[2], host)


def occupancy(trimmed, host: bool = True):
    """(per-axis projections of the non-EXTERIOR cells, their count), on
    the host (numpy, int) or, with `host=False`, as device tensors."""
    non_ext = trimmed != int(CellLabel.EXTERIOR)
    projections = tuple(non_ext.any(dim=dims) for dims in ((1, 2), (0, 2), (0, 1)))
    count = non_ext.sum()
    if host:
        projections, count = tuple(p.cpu().numpy() for p in projections), int(count)
    return projections, count


def base_label_fields(liquid_phi, cut_cell_weights, solid_phi, theta_clamp: float, dtype,
                      dirichlet_band: int):
    """Steps 1-3 without the occupancy: (material, mg_labels, trimmed,
    mg_weights).  Each cell reads the fields within `dirichlet_band` + 2
    cells of it (the trimming's rings, the labels' and theta's one-cell
    neighbourhoods), which is the halo the partitioned setup grows a base
    block by."""
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
    return material, mg_labels, trimmed, mg_weights


def _window(arr, start, base_pads, out_shape, fill):
    """out[j] = padded_base[start + j], padded with `fill`.  `start` is
    host integers (slices), or the origin as an int32 tensor of three on
    the device (a gather at start + arange: a captured program reads the
    origin from memory, as the JAX package traces its window_start)."""
    padded = domain_ops.pad(arr, base_pads, fill)
    if not isinstance(start, torch.Tensor):
        return padded[tuple(slice(s, s + n) for s, n in zip(start, out_shape))].contiguous()
    i, j, k = (start[a].long() + torch.arange(n, device=padded.device) for a, n in enumerate(out_shape))
    return padded[i[:, None, None], j[None, :, None], k[None, None, :]]


def device_origin(start, device) -> torch.Tensor:
    """The window origin `start` (host integers) as an int32 tensor on
    `device`, written by fills (no host copy, no sync)."""
    origin = torch.empty(3, dtype=torch.int32, device=device)
    for a, s in enumerate(start):
        origin[a].fill_(int(s))
    return origin


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
    reuse_from: ProjectionSetup | None = None,
    mesh=None,
    base_shape=None,
) -> ProjectionSetup:
    """Steps 1-4 on `device` (default: the mesh's device, else liquid_phi's
    device if it is a tensor, else the card):
    labels, valid faces, MG domain and weights, the compact window and the
    hierarchy.  With a `DistMesh` every rank of the mesh calls this
    together and builds only its blocks (`sharding.partitioned_setup`):
    the inputs are whole grids, or, with `base_shape` (the base grid's
    global cell shape), the rank's blocks of them as
    `distributed.make_global_grid` cuts them (a face array's own n+1 axis
    whole, `mesh.face_split`).

    `reuse_from` (the previous frame's setup) keeps its window shape when
    the new liquid still fits it with the same padding and depth, so every
    frame of a loop works on one shape; when it no longer fits, the new
    window gets `config.window_slack` padding quanta of headroom on the
    first two axes.  Without it the window is the exact minimal one.
    """
    if config is None:
        config = SolverConfig()
    validate_density(density)
    if mesh is not None and device is None:
        device = mesh.device
    if isinstance(mesh, DistMesh):
        return sharding.partitioned_setup(
            liquid_phi, cut_cell_weights, solid_phi, config, mesh, base_shape=base_shape,
            validate=validate, reuse_from=reuse_from,
        )
    validate_fields(liquid_phi, cut_cell_weights, solid_phi=solid_phi)
    sd = config.solve_dtype
    dev = device_mod.of(liquid_phi, device)
    liquid_phi = torch.as_tensor(liquid_phi, dtype=sd, device=dev)
    cut_cell_weights = tuple(torch.as_tensor(w, dtype=sd, device=dev) for w in cut_cell_weights)
    if solid_phi is not None:
        solid_phi = torch.as_tensor(solid_phi, dtype=sd, device=dev)

    material, mg_labels, trimmed, mg_weights, projections, non_ext_count = _setup_base_fields(
        liquid_phi, cut_cell_weights, solid_phi, config.theta_clamp, sd, config.dirichlet_band
    )
    base_shape = tuple(liquid_phi.shape)
    geom = window_geometry(projections, non_ext_count, base_shape, config, reuse_from)
    labels, exp_weights, levels, flags, label_levels, fine = _expand_build_device(
        trimmed if config.compact_domain else mg_labels, mg_weights, geom.start,
        geom.base_pads, geom.expanded_shape, geom.target_levels(config), config,
    )
    if validate:
        assert domain_ops.check_boundary_cells(labels, exp_weights)
        assert domain_ops.check_exterior_shell(labels)

    fine_full = mgpcg.fine_plan(config)[2]
    hier = mg_mod._finish_hierarchy(
        levels, flags, label_levels, config, validate=validate, host_fw=exp_weights
    )
    return ProjectionSetup(
        problem=mgpcg._finish_problem(hier, fine, fine_full),
        material=material,
        weights=cut_cell_weights,
        liquid_phi=liquid_phi,
        window_start=geom.start,
        expanded_shape=tuple(labels.shape),
        base_pads=geom.base_pads,
        padding=geom.padding,
        mg_levels=geom.mg_levels,
    )


def _expand_build_device(window_labels, mg_weights, window_start, base_pads, expanded_shape,
                         target_levels: int, config: SolverConfig):
    """Step 4 and the hierarchy below it: the window at the origin
    `window_start` (host integers) cut out of the padded base labels and
    weights and relabeled (`_expand_window_fields`), every level and the
    fine CG operator (`mg.hierarchy_levels`): (labels, exp_weights,
    levels, flags, label_levels, fine), the JAX package's
    `_expand_build_device`.

    On the card all of it is ONE program (`graph.call`), captured once per
    shape, dtypes, depth and granularity and replayed after that, so a
    liquid that moves inside a kept window replays it: the origin is an
    input, an int32 tensor on the card (`device_origin`, JAX's traced
    window_start), not part of the key.  At ``setup_fusion="fused"`` the program
    is one graph; at "per-level" the expansion is one graph and each
    level another (`mg.device_hierarchy`).  The caller gets copies of the
    outputs.  On the CPU it runs eagerly, both granularities with the
    same bits."""
    _, fine_dtype, fine_full = mgpcg.fine_plan(config)
    base_pads, expanded_shape = tuple(base_pads), tuple(expanded_shape)
    per_level = config.setup_fusion_resolved(expanded_shape) == "per-level"

    def build(lab, w, start, split):
        labels, exp_weights = _expand_window_fields(lab, w, start, base_pads, expanded_shape)
        if per_level:
            split()
        return (labels, exp_weights) + mg_mod.hierarchy_levels(
            labels, tuple(exp_weights), target_levels, config, fine_dtype, fine_full, per_level, split,
        )

    dev = window_labels.device

    def eager():
        return build(window_labels, tuple(mg_weights), window_start, graph.no_split)

    if not graph.programs_on(dev):
        return eager()
    key = (base_pads, expanded_shape, target_levels, config.mg_dtype_resolved, config.boundary_width,
           config.mg_ew_dtype, fine_dtype, fine_full, per_level)
    inputs = (window_labels, tuple(mg_weights), device_origin(window_start, dev))
    cells = expanded_shape[0] * expanded_shape[1] * expanded_shape[2]  # the program grows with the window
    return graph.call("setup", key, build, inputs, dev, uncached=eager, size=cells)


class WindowGeometry(NamedTuple):
    """The multigrid window of a base grid: depth, padding, shape, the base
    grid's exterior padding and the window's origin in padded-base
    coordinates (host integers, the same on every rank)."""

    mg_levels: int
    padding: int
    expanded_shape: tuple[int, int, int]
    base_pads: tuple[tuple[int, int], ...]
    start: tuple[int, int, int]

    def target_levels(self, config: SolverConfig) -> int:
        if config.max_mg_levels is not None:
            return min(self.mg_levels, config.max_mg_levels)
        return self.mg_levels


def window_geometry(projections, non_ext_count: int, base_shape, config: SolverConfig,
                    reuse_from: ProjectionSetup | None = None) -> WindowGeometry:
    """Step 4's decisions from the occupancy of the trimmed labels (host
    projections and count): the compact window, or the reference's
    full-grid expansion without `config.compact_domain`, kept sticky by
    `reuse_from`."""
    base_shape = tuple(int(n) for n in base_shape)
    if config.compact_domain:
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

    # Sticky window shape (free_surface.py:605-635 of the JAX package): the
    # fit test uses the minimal requirement; a regrown window adds
    # `window_slack` padding quanta on the first two axes (the last axis
    # already has headroom from its 128-multiple rounding).
    if (
        reuse_from is not None
        and reuse_from.padding == padding
        and reuse_from.mg_levels == mg_levels
        and all(pe >= ne for pe, ne in zip(reuse_from.expanded_shape, expanded_shape))
    ):
        expanded_shape = reuse_from.expanded_shape
    elif reuse_from is not None and config.window_slack:
        expanded_shape = (
            expanded_shape[0] + config.window_slack * padding,
            expanded_shape[1] + config.window_slack * padding,
            expanded_shape[2],
        )
        if config.compact_domain:
            expanded_shape = domain_ops.align_tile_extents(expanded_shape, padding)

    # Base padding of at least `padding`, enough that the window fits; the
    # window keeps a leading exterior margin of at least `padding`.
    base_pads = tuple(
        (padding, max(padding, e - b - padding)) for e, b in zip(expanded_shape, base_shape)
    )
    start = tuple(
        min(lo, b + plo + phi - e)
        for (lo, _), b, (plo, phi), e in zip(bbox, base_shape, base_pads, expanded_shape)
    )
    return WindowGeometry(mg_levels, padding, tuple(expanded_shape), base_pads, start)


def embed_window(base, window_start, base_pads, expanded_shape) -> torch.Tensor:
    """Window a base-grid cell field into the expanded multigrid domain."""
    return _window(base, window_start, base_pads, expanded_shape, 0)


def extract_window(expanded, window_start, base_pads, base_shape) -> torch.Tensor:
    """Scatter an expanded-domain field back onto the base grid (zeros
    where the window does not reach).  `window_start` as in `_window`."""
    if isinstance(window_start, torch.Tensor):
        idx, inside = [], []
        for a, (b, (plo, _)) in enumerate(zip(base_shape, base_pads)):
            at = torch.arange(b, device=expanded.device) + plo - window_start[a].long()
            inside.append((at >= 0) & (at < expanded.shape[a]))
            idx.append(at.clamp(0, expanded.shape[a] - 1))
        vals = expanded[idx[0][:, None, None], idx[1][None, :, None], idx[2][None, None, :]]
        mask = inside[0][:, None, None] & inside[1][None, :, None] & inside[2][None, None, :]
        return torch.where(mask, vals, torch.zeros_like(vals))
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


def pressure_gradient_axis(u, pressure, valid, grad_scale, axis: int):
    """`apply_pressure_gradient` on the face array `u` along one axis (the
    faces of `pressure`'s cells)."""
    inner = _sl(axis, slice(1, -1))
    p_lo, p_hi = _lo_hi(pressure, axis)
    grad = torch.zeros_like(u)
    grad[inner] = (p_hi - p_lo) * grad_scale[inner]
    return torch.where(valid, u - grad, u)


def apply_pressure_gradient(velocity, pressure, valid_faces, grad_scale) -> tuple:
    """v -= grad(p) on valid faces, with the ghost-fluid 1/theta scale."""
    return tuple(
        pressure_gradient_axis(velocity[axis], pressure, valid_faces[axis], grad_scale[axis], axis)
        for axis in range(3)
    )


def divergence_stats(liquid_mask, velocity, weights, solid_velocity=None):
    """(max, accumulated, average) divergence over liquid cells (the true
    divergence, + on upper faces)."""
    div = -negative_divergence(liquid_mask, velocity, weights, solid_velocity)
    count = torch.clamp(torch.sum(liquid_mask), min=1)
    total = torch.sum(div)
    return torch.max(torch.abs(div)), total, total / count


def solve_and_check(problem, rhs, x0, config: SolverConfig, mesh=None, device_loop=None):
    """Step 7 and the recomputed residual norms: (CG result, ||b - A x|| /
    ||b||, max |b - A x|).  The solve's operators also recompute its
    residual, so a sharded fine level's coefficients are exchanged once
    per projection.  `device_loop`: the CG loop with no host read
    (`mgpcg.run_stages`)."""
    rhs, x0 = mgpcg.solve_inputs(problem, rhs, x0, config, mesh)
    stages = mgpcg.solve_stages(problem, config, mesh)
    cg_result = mgpcg.run_stages(stages, problem, rhs, x0, config, device_loop=device_loop)
    rel_l2, linf = cg_mod.recomputed_residual_norms(
        stages.residual, cg_result.x, rhs, problem.fine.solvable, stages.ranks,
    )
    return cg_result, rel_l2, linf


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
    mesh=None,
    device_loop=None,
) -> ProjectionResult:
    """Steps 5-9: RHS, warm start, MGPCG solve, writeback, audit, on the
    device that holds `setup` (inputs are moved there).  `mesh` (a one-card
    `parallel.mesh.BlockMesh`) runs the solve's sharded levels block by
    block (`mgpcg.solve(..., mesh=)`).  With `device_loop` (the CG loop of
    a captured frame, `solver.graph.FrameGraph`) nothing here reads the
    host: the result's CG scalars are device tensors.

    With a `DistMesh` every rank calls this together with its share of the
    setup (`build_setup(mesh=)`) and runs steps 5-9 on its blocks
    (`sharding.partitioned_project`): `velocity`, `solid_velocity` and
    `old_pressure` are whole grids or the rank's blocks of them; the
    result's `pressure` and `velocity` are the rank's blocks of the base
    grid, `cg.x` its block of the window, and the audit scalars and the
    recomputed residual norms are over all ranks.

    On the card in one process (`graph.programs_on`; `mesh` None or a
    block mesh) the whole projection is one program, the JAX package's
    `_project_impl` on `_PROJECT_STATICS`: captured once per key -- the
    configuration, the mesh, the window's shape and base padding, and the
    shapes and dtypes of the setup and the fields (the coarse bucket
    among them) -- and replayed by every later call, whatever the
    setup's values and window origin.  The setup and the fields are
    copied into the program's buffers and the result out of its own, so
    the caller holds the result as it would any other; its CG scalars
    come to the host in one read."""
    if config is None:
        config = SolverConfig()
    if isinstance(mesh, DistMesh):
        if device_loop is not None:
            raise ValueError("the device-only CG loop runs in one process")
        return sharding.partitioned_project(setup, velocity, solid_velocity, old_pressure, config, mesh)
    validate_fields(setup.material, setup.weights, velocity=velocity)
    sd = config.solve_dtype
    dev = setup.liquid_phi.device
    velocity = tuple(torch.as_tensor(v, dtype=sd, device=dev) for v in velocity)
    if solid_velocity is not None:
        solid_velocity = tuple(torch.as_tensor(v, dtype=sd, device=dev) for v in solid_velocity)
    old = None
    if config.use_old_pressure and old_pressure is not None:
        old = torch.as_tensor(old_pressure, dtype=sd, device=dev)
    if device_loop is None and graph.programs_on(dev):
        return _project_program(setup, velocity, solid_velocity, old, config, mesh)
    return _project_impl(setup, velocity, solid_velocity, old, config, mesh, device_loop)


def _project_program(setup: ProjectionSetup, velocity, solid_velocity, old, config: SolverConfig, mesh):
    """`project` as the cached program of its key (see `project`)."""
    dev = setup.liquid_phi.device
    fields = (setup.problem, setup.material, setup.weights, setup.liquid_phi,
              device_origin(setup.window_start, dev), velocity, solid_velocity, old)

    def fn(problem, material, weights, liquid_phi, origin, velocity, solid_velocity, old, device_loop):
        held = setup._replace(problem=problem, material=material, weights=weights, liquid_phi=liquid_phi,
                              window_start=origin)
        return _project_impl(held, velocity, solid_velocity, old, config, mesh, device_loop)

    key = (config, mesh, setup.base_pads, setup.expanded_shape, setup.base_shape)
    result = graph.call("project", key, fn, fields, dev, prepare=mgpcg.capture_prepare(setup.problem, config),
                        loop=True,
                        uncached=lambda: _project_impl(setup, velocity, solid_velocity, old, config, mesh))
    return result._replace(cg=mgpcg.host_result(result.cg))


def _project_impl(setup: ProjectionSetup, velocity, solid_velocity, old, config: SolverConfig, mesh=None,
                  device_loop=None) -> ProjectionResult:
    """Steps 5-9 of `project` on fields already on the setup's device
    (`old`: the warm start, or None)."""
    sd = config.solve_dtype
    liquid_mask = setup.liquid_mask
    valid_faces, grad_scale = face_projection_fields(
        setup.material, setup.liquid_phi, setup.weights, config.theta_clamp, sd
    )
    rhs_base = negative_divergence(liquid_mask, velocity, setup.weights, solid_velocity)
    rhs = embed_window(rhs_base, setup.window_start, setup.base_pads, setup.expanded_shape)

    x0 = None
    if old is not None:
        warm = torch.where(liquid_mask, old, torch.zeros_like(old))
        x0 = embed_window(warm, setup.window_start, setup.base_pads, setup.expanded_shape)

    cg_result, rel_l2, linf = solve_and_check(setup.problem, rhs, x0, config, mesh, device_loop)
    pressure = extract_window(cg_result.x, setup.window_start, setup.base_pads, rhs_base.shape)
    pressure = torch.where(liquid_mask, pressure, torch.zeros_like(pressure))
    new_velocity = apply_pressure_gradient(velocity, pressure, valid_faces, grad_scale)
    max_div, total_div, avg_div = divergence_stats(
        liquid_mask, new_velocity, setup.weights, solid_velocity
    )
    return ProjectionResult(
        pressure, new_velocity, cg_result, max_div, avg_div, rel_l2, linf, total_div
    )
