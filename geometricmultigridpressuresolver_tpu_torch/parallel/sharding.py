"""A rank's share of the solver's data (port of ``parallel/sharding.py``).

The JAX package places every grid of a problem or setup on the mesh with
a `NamedSharding` and lets XLA's partitioner move data; its sharded setup
(``build_setup(mesh=)``) runs SPMD so that no device holds a whole fine
grid.  Across ranks (`parallel.mesh.DistMesh`) a rank holds:

  * its block of every level the solve runs sharded (`solver.mg.
    level_flags` says "sharded": the mesh splits the level and the block
    kernels take its geometry), cut by `mesh.local_slices` on the split
    axes;
  * its block of the base fields (material, cut-cell weights, liquid SDF;
    `grid_split`'s rule, a MAC face array's own n+1 axis whole,
    `mesh.face_split`), with `ProjectionSetup.base_shape` the base grid's
    global shape;
  * everything else whole: the other levels (JAX leaves a split but
    ineligible level sharded under jnp and lets XLA add the halos; the
    port holds such a level whole on every rank, the same arithmetic per
    cell), the coarse direct solve's `coarse_dofs` / `coarse_minv` /
    `coarse_chol` and the window origin (a static tuple).

Two ways lead there.  `shard_setup` / `shard_problem` cut a whole setup or
problem (built by either package) to a rank's share.  The partitioned
build makes the share directly (`partitioned_setup`, behind
`free_surface.build_setup(mesh=)`, and `partitioned_problem`, behind
`mgpcg.build_problem(mesh=)`): every step runs on the rank's block grown
by the halo its stencils read, fetched with `distributed.redistribute`,
and the core is cut out, so each cell comes out of the same elementwise
operations as in the whole build, bit for bit.  The halos:

  * the base fields, `dirichlet_band` + 2 cells (the far-Dirichlet
    trimming dilates `dirichlet_band` rings; the labels, valid faces and
    ghost-fluid theta read one-cell neighbourhoods);
  * the window's labels and weights, `boundary_width` + 2 cells (the
    boundary relabeling reads one cell, the boundary band grows
    `boundary_width` - 1 rings, the stencil coefficients read one cell);
  * a coarse level's voted labels, one cell for the boundary pass, and
    `boundary_width` + 1 for its coefficients.

A level coarsens block by block while the mesh splits it and the next one
alike (block edges are even, so a coarse block is the vote of its fine
block); otherwise its labels are gathered (`distributed.gather_blocks`)
and the rest runs whole on every rank, `coarsen_labels(lane_align=True)`'s
z padding included.  The "any DOF" tests that cap the hierarchy are
`ordered_max` over the ranks, so every rank keeps the same levels, and
the coarsest level's direct solver is built from its whole labels.

`partitioned_project` runs the projection on the same blocks: the
right-hand side from the rank's base block (its cells' faces are local
under the face rule), carried into its window block by `redistribute`
(the warm start likewise), the solve, the pressure carried into the cells
of each of its face arrays, the writeback on its face blocks and the
divergence audit on its cells, the scalars summed over the ranks in rank
order.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from geometricmultigridpressuresolver_tpu_torch.grids import CellLabel, MaterialLabel, face_shape, is_solvable
from geometricmultigridpressuresolver_tpu_torch.ops import domain as domain_ops
from geometricmultigridpressuresolver_tpu_torch.ops import stencil
from geometricmultigridpressuresolver_tpu_torch.parallel import distributed
from geometricmultigridpressuresolver_tpu_torch.parallel.mesh import (
    DistMesh,
    box_shape,
    box_slices,
    face_box,
    face_split,
    grid_split,
    grow_box,
    local_slices,
    shift_box,
    window_offset,
)

EXT = int(CellLabel.EXTERIOR)
LIQUID = int(MaterialLabel.LIQUID)


def block_of(arr: torch.Tensor, mesh: DistMesh, split) -> torch.Tensor:
    """This rank's block of a full grid split on the axes `split`, on the
    mesh's device."""
    idx = local_slices(mesh.shape, arr.shape, mesh.rank, split)
    return arr[idx].to(mesh.device).contiguous()


def shard_grid(arr, mesh: DistMesh, min_per_device: int = 8) -> torch.Tensor:
    """This rank's block of one cell-shaped grid, by `grid_split`'s rule
    (an indivisible or too-short axis stays whole)."""
    arr = torch.as_tensor(arr)
    return block_of(arr, mesh, grid_split(mesh, arr.shape, min_per_device))


def shard_velocity(velocity, mesh: DistMesh, min_per_device: int = 8) -> tuple:
    """This rank's blocks of a MAC velocity (`mesh.face_split`: the cells'
    split, each array's own n+1 axis whole)."""
    velocity = tuple(torch.as_tensor(v) for v in velocity)
    cells = tuple(n - (a == 0) for a, n in enumerate(velocity[0].shape))
    return tuple(block_of(v, mesh, face_split(mesh.shape, cells, a, min_per_device)) for a, v in enumerate(velocity))


def level_split(mesh: DistMesh, shape, sharded: bool) -> tuple[bool, bool, bool]:
    """The axes a level's blocks are cut on: `grid_split`'s on a level the
    solve runs sharded, none on a whole one."""
    return grid_split(mesh, shape) if sharded else (False, False, False)


def _level(c: stencil.LevelCoeffs, mesh: DistMesh, sharded: bool) -> stencil.LevelCoeffs:
    split = level_split(mesh, c.shape, sharded)
    return stencil.LevelCoeffs(*(block_of(a, mesh, split) for a in c))


def shard_problem(problem, mesh: DistMesh, config=None):
    """This rank's share of a whole `mgpcg.PoissonProblem`: its blocks of the
    levels `mg.level_flags` calls "sharded" (and of the fine CG operator
    when the finest level is one), everything else whole, on the mesh's
    device; the hierarchy records the global shapes."""
    from geometricmultigridpressuresolver_tpu_torch.config import SolverConfig
    from geometricmultigridpressuresolver_tpu_torch.solver import mg, mgpcg

    if config is None:
        config = SolverConfig()
    hier = problem.hier
    if hier.shapes is not None:
        raise ValueError("the problem already holds a rank's blocks")
    flags = mg.level_flags(hier, config, mesh)
    sharded = [f == "sharded" for f in flags]
    levels = tuple(_level(c, mesh, s) for c, s in zip(hier.levels, sharded))
    whole = dict(device=mesh.device)
    shards = mg.MGHierarchy(
        levels=levels,
        coarse_dofs=hier.coarse_dofs.to(**whole),
        coarse_minv=hier.coarse_minv.to(**whole),
        coarse_chol=hier.coarse_chol.to(**whole),
        shapes=tuple(tuple(c.shape) for c in hier.levels),
    )
    return mgpcg.PoissonProblem(fine=_level(problem.fine, mesh, sharded[0]), hier=shards)


def shard_setup(setup, mesh: DistMesh, config=None):
    """This rank's share of a whole `free_surface.ProjectionSetup`: the
    problem by `shard_problem`, the base fields cut to the rank's blocks
    (the face arrays by `mesh.face_split`), on the mesh's device."""
    base = tuple(setup.material.shape)
    split = grid_split(mesh, base)
    return setup._replace(
        problem=shard_problem(setup.problem, mesh, config),
        material=block_of(setup.material, mesh, split),
        weights=tuple(block_of(w, mesh, face_split(mesh.shape, base, a)) for a, w in enumerate(setup.weights)),
        liquid_phi=block_of(setup.liquid_phi, mesh, split),
        base_shape=base,
    )


# ---- the partitioned build ------------------------------------------------------------


def _as_block(t, layout: distributed.Layout, mesh: DistMesh, dtype=None) -> torch.Tensor:
    """`t` as this rank's block of the grid of `layout` on the mesh's
    device: a whole grid is cut, a block of the rank's shape passes."""
    shape = tuple(t.shape) if hasattr(t, "shape") else np.shape(t)
    box = layout.held[mesh.rank]
    if shape == layout.shape:
        t = t[box_slices(box)]
    elif shape != box_shape(box):
        raise ValueError(
            f"a field of shape {shape}: neither the grid {layout.shape} nor this rank's block "
            f"{box_shape(box)} of it"
        )
    return torch.as_tensor(t).to(device=mesh.device, dtype=dtype).contiguous()


def _grown(layout: distributed.Layout, depth: int, split) -> list:
    """Every rank's block of `layout` grown by `depth` on the axes `split`."""
    return [grow_box(b, depth, layout.shape, split) for b in layout.held]


def _cut(t: torch.Tensor, core, box) -> torch.Tensor:
    return t[box_slices(core, box)].contiguous()


def _any(mesh: DistMesh, flag: torch.Tensor) -> bool:
    """Whether any rank's 0-d bool `flag` holds (the same on every rank)."""
    return bool(distributed.ordered_max(mesh, flag.to(torch.int32)))


def _check(mesh: DistMesh, ok: bool, what: str) -> None:
    """Raise on every rank if `ok` fails on any (so no rank waits for one
    that raised)."""
    if _any(mesh, torch.tensor(not ok, device=mesh.device)):
        raise AssertionError(f"partitioned setup: {what} failed on a rank")


def _edges(core, shape) -> tuple:
    return tuple((lo == 0, hi == n) for (lo, hi), n in zip(core, shape))


def _coarse_labels(mesh: DistMesh, fine, fine_shape, fine_split, coarse_shape):
    """The next level's labels from this rank's block `fine` of a level
    split on `fine_split`: (its block, the coarse level's split).  The
    block votes on its own where its extents are even; the boundary pass
    reads a one-cell halo; a split that changes between the levels (or a
    z padding on a split z axis) goes through the gathered grid."""
    coarse_split = grid_split(mesh, coarse_shape)
    if any(s and (n // m) % 2 for n, m, s in zip(fine_shape, mesh.shape, fine_split)):
        fine = distributed.gather_blocks(fine, mesh, fine_shape, fine_split)
        fine_split = (False, False, False)
    natural = tuple(n // 2 for n in fine_shape)
    extra = coarse_shape[2] - natural[2]
    voted = domain_ops.vote_labels(fine)
    if coarse_split != fine_split or (extra and fine_split[2]):
        whole = distributed.gather_blocks(voted, mesh, natural, fine_split)
        whole = domain_ops.pad(whole, [(0, 0), (0, 0), (0, extra)], EXT)
        return block_of(domain_ops.set_boundary_labels(whole, None), mesh, coarse_split), coarse_split
    voted = domain_ops.pad(voted, [(0, 0), (0, 0), (0, extra)], EXT)
    layout = distributed.block_layout(mesh, coarse_shape, coarse_split)
    boxes = _grown(layout, 1, coarse_split)
    haloed = distributed.redistribute(mesh, voted, layout, boxes, EXT)
    labels = domain_ops.set_boundary_labels(haloed, None)
    return _cut(labels, layout.held[mesh.rank], boxes[mesh.rank]), coarse_split


def partitioned_problem(fetch: Callable, shape, target_levels: int, config, mesh: DistMesh,
                        relabel: bool, validate: bool = False):
    """This rank's share of the `mgpcg.PoissonProblem` on a window of global
    `shape`, built from blocks: the counterpart of `mg._build_levels`,
    `_finish_hierarchy` and `mgpcg._finish_problem` followed by
    `shard_problem`, bit for bit.

    `fetch(boxes)` returns the window's labels on this rank's box
    `boxes[mesh.rank]` (every rank's box given, in window coordinates,
    clipped to the window) and the face weights of its cells (a tuple of
    three, or None for unit weights); every rank calls it together.  With
    `relabel` the labels get the boundary pass (`set_boundary_labels`)
    first, as the window of `free_surface.build_setup` does.  `validate`
    runs `domain.check_block` on each level's blocks (the boundary cells,
    and the exterior shell where a block reaches the grid's edge) and
    `check_coarsening` between the levels held whole."""
    from geometricmultigridpressuresolver_tpu_torch.solver import mg, mgpcg

    dtype, fine_dtype, fine_full = mgpcg.fine_plan(config)
    bw = config.boundary_width
    rank = mesh.rank
    shapes = mg.candidate_shapes(shape, target_levels)

    # The finest labels and weights on this rank's block grown by bw + 2.
    splits = [grid_split(mesh, shapes[0])]
    layout0 = distributed.block_layout(mesh, shapes[0], splits[0])
    boxes0 = _grown(layout0, bw + 2, splits[0])
    core0, box0 = layout0.held[rank], boxes0[rank]
    labels0, weights0 = fetch(boxes0)
    if relabel:
        labels0 = domain_ops.set_boundary_labels(labels0, weights0)
    if validate:
        _check(mesh, domain_ops.check_block(labels0, weights0, box_slices(core0, box0), _edges(core0, shapes[0])),
               "the finest level's boundary cells or exterior shell")

    # Every level's label block; the hierarchy ends before the first
    # coarse level without a DOF on any rank.
    blocks = [_cut(labels0, core0, box0)]
    for coarse_shape in shapes[1:]:
        blk, split = _coarse_labels(mesh, blocks[-1], shapes[len(blocks) - 1], splits[-1], coarse_shape)
        if not _any(mesh, is_solvable(blk).any()):
            break
        blocks.append(blk)
        splits.append(split)
    shapes = shapes[:len(blocks)]
    sharded = [f == "sharded" for f in mg.shape_flags(shapes, config, mesh)]

    def coefficients(level, dt, ew_dtype):
        """Level `level`'s coefficients in `dt`, the rank's block of a
        sharded level (built on the block grown by bw + 1 or more and cut)
        or the whole level."""
        if level == 0 and sharded[0]:
            c = mg._level_coeffs(labels0, weights0, bw, dt, ew_dtype)
            return stencil.LevelCoeffs(*(_cut(a, core0, box0) for a in c))
        if level == 0:
            whole = ((0, n) for n in shapes[0])
            labels, weights = fetch([tuple(whole)] * mesh.size)
            if relabel:
                labels = domain_ops.set_boundary_labels(labels, weights)
            return mg._level_coeffs(labels, weights, bw, dt, ew_dtype)
        if sharded[level]:
            layout = distributed.block_layout(mesh, shapes[level], splits[level])
            boxes = _grown(layout, bw + 1, splits[level])
            labels = distributed.redistribute(mesh, blocks[level], layout, boxes, EXT)
            c = mg._level_coeffs(labels, None, bw, dt, ew_dtype)
            return stencil.LevelCoeffs(*(_cut(a, layout.held[rank], boxes[rank]) for a in c))
        labels = distributed.gather_blocks(blocks[level], mesh, shapes[level], splits[level])
        return mg._level_coeffs(labels, None, bw, dt, ew_dtype)

    levels = tuple(coefficients(lv, dtype, config.mg_ew_dtype) for lv in range(len(shapes)))
    fine = None
    if fine_dtype is not None:
        fc = coefficients(0, fine_dtype, None)
        fine = fc if fine_full else (fc.ew0, fc.ew1, fc.ew2)

    if validate:
        for lv in range(1, len(shapes)):
            layout = distributed.block_layout(mesh, shapes[lv], splits[lv])
            boxes = _grown(layout, 1, splits[lv])
            haloed = distributed.redistribute(mesh, blocks[lv], layout, boxes, EXT)
            core = layout.held[rank]
            _check(mesh, domain_ops.check_block(haloed, None, box_slices(core, boxes[rank]), _edges(core, shapes[lv])),
                   f"level {lv}'s boundary cells")
            if not any(splits[lv - 1]) and not any(splits[lv]):
                _check(mesh, domain_ops.check_coarsening(blocks[lv - 1], blocks[lv]), f"the coarsening to level {lv}")

    # The coarsest level is whole on every rank, and each rank factors it
    # on its own device by `mg.coarse_direct`'s rule, with no collective.
    coarsest = distributed.gather_blocks(blocks[-1], mesh, shapes[-1], splits[-1])
    whole = levels[-1] if len(shapes) > 1 and not sharded[-1] else None
    dofs, minv, chol = mg.coarse_direct(coarsest, None, whole, config, mesh.device)
    hier = mg.MGHierarchy(levels, dofs, minv, chol, shapes=tuple(shapes))
    return mgpcg._finish_problem(hier, fine, fine_full)


def grid_fetch(labels, face_weights, mesh: DistMesh, config) -> tuple[Callable, tuple]:
    """(`partitioned_problem`'s fetch, the window shape) for expanded labels
    and face weights given whole: this rank keeps its blocks of them and
    fetches its boxes from the ranks' blocks."""
    shape = tuple(labels.shape) if hasattr(labels, "shape") else np.shape(labels)
    split = grid_split(mesh, shape)
    cells = distributed.block_layout(mesh, shape, split)
    lab = _as_block(labels, cells, mesh).to(torch.int8)
    faces = [distributed.block_layout(mesh, face_shape(shape, a), face_split(mesh.shape, shape, a)) for a in range(3)]
    fw = None if face_weights is None else tuple(
        _as_block(w, faces[a], mesh, config.solve_dtype) for a, w in enumerate(face_weights)
    )

    def fetch(boxes):
        labels_box = distributed.redistribute(mesh, lab, cells, boxes, EXT)
        if fw is None:
            return labels_box, None
        return labels_box, tuple(
            distributed.redistribute(mesh, w, faces[a], [face_box(b, a) for b in boxes], 0.0)
            for a, w in enumerate(fw)
        )

    return fetch, shape


def _base_blocks(phi, weights, solid, cells, faces, config, mesh: DistMesh):
    """Steps 1-3 on this rank's base block: computed on the block grown by
    `dirichlet_band` + 2 cells and cut to it.  Returns (material, window
    source labels, the faces of the block's cells of the boundary weights,
    the trimmed labels)."""
    from geometricmultigridpressuresolver_tpu_torch.models import free_surface

    split = grid_split(mesh, cells.shape)
    boxes = _grown(cells, config.dirichlet_band + 2, split)
    core, box = cells.held[mesh.rank], boxes[mesh.rank]

    def grown(t, layout, axis=None):
        dest = boxes if axis is None else [face_box(b, axis) for b in boxes]
        return distributed.redistribute(mesh, t, layout, dest, 0)

    material, mg_labels, trimmed, mg_weights = free_surface.base_label_fields(
        grown(phi, cells), tuple(grown(w, faces[a], a) for a, w in enumerate(weights)),
        None if solid is None else grown(solid, cells), config.theta_clamp, config.solve_dtype,
        config.dirichlet_band,
    )
    source = trimmed if config.compact_domain else mg_labels
    source = torch.where(source == int(CellLabel.BOUNDARY), int(CellLabel.INTERIOR), source).to(torch.int8)
    return (
        _cut(material, core, box),
        _cut(source, core, box),
        tuple(_cut(w, face_box(core, a), face_box(box, a)) for a, w in enumerate(mg_weights)),
        _cut(trimmed, core, box),
    )


def partitioned_setup(liquid_phi, cut_cell_weights, solid_phi, config, mesh: DistMesh,
                      base_shape=None, validate: bool = False, reuse_from=None):
    """`free_surface.build_setup` on a mesh of ranks, this rank building only
    its blocks (module docstring): the base inputs whole, or with
    `base_shape` the rank's blocks of them.  Returns the rank's share of
    the setup, equal bit for bit to `shard_setup` of the whole build."""
    from geometricmultigridpressuresolver_tpu_torch.models import free_surface

    if len(cut_cell_weights) != 3:
        raise ValueError("cut-cell weights must have one array per axis")
    if base_shape is None:
        free_surface.validate_fields(liquid_phi, cut_cell_weights, solid_phi=solid_phi)
        base_shape = free_surface._shape(liquid_phi)
    base_shape = tuple(int(n) for n in base_shape)
    sd = config.solve_dtype
    split = grid_split(mesh, base_shape)
    cells = distributed.block_layout(mesh, base_shape, split)
    faces = [distributed.block_layout(mesh, face_shape(base_shape, a), face_split(mesh.shape, base_shape, a))
             for a in range(3)]
    phi = _as_block(liquid_phi, cells, mesh, sd)
    weights = tuple(_as_block(w, faces[a], mesh, sd) for a, w in enumerate(cut_cell_weights))
    solid = None if solid_phi is None else _as_block(solid_phi, cells, mesh, sd)

    material, source, mg_weights, trimmed = _base_blocks(phi, weights, solid, cells, faces, config, mesh)

    # The occupancy over the ranks: every rank takes the same window.
    core = cells.held[mesh.rank]
    (px, py, pz), count = free_surface.occupancy(trimmed, host=False)
    proj = torch.zeros(sum(base_shape), dtype=torch.int32, device=mesh.device)
    at = 0
    for p, (lo, hi), n in zip((px, py, pz), core, base_shape):
        proj[at + lo:at + hi] = p.to(torch.int32)
        at += n
    owned = mesh.owns(split)
    proj = distributed.ordered_max(mesh, proj, owned).cpu().numpy() > 0
    count = int(distributed.ordered_sum(mesh, count, owned))
    cuts = np.cumsum(base_shape)[:-1]
    geom = free_surface.window_geometry(np.split(proj, cuts), count, base_shape, config, reuse_from)

    off = window_offset(geom.start, geom.base_pads)
    mg_faces = [distributed.faces_layout(mesh, base_shape, split, a) for a in range(3)]

    def fetch(boxes):
        base_boxes = [shift_box(b, off) for b in boxes]
        labels = distributed.redistribute(mesh, source, cells, base_boxes, EXT)
        return labels, tuple(
            distributed.redistribute(mesh, w, mg_faces[a], [face_box(b, a) for b in base_boxes], 0.0)
            for a, w in enumerate(mg_weights)
        )

    problem = partitioned_problem(fetch, geom.expanded_shape, geom.target_levels(config), config, mesh,
                                  relabel=True, validate=validate)
    return free_surface.ProjectionSetup(
        problem=problem,
        material=material,
        weights=weights,
        liquid_phi=phi,
        window_start=geom.start,
        expanded_shape=geom.expanded_shape,
        base_pads=geom.base_pads,
        padding=geom.padding,
        mg_levels=geom.mg_levels,
        base_shape=base_shape,
    )


def _cell_faces(arrays, cells: distributed.Layout, faces, mesh: DistMesh):
    """The faces of this rank's cells from its blocks of the face arrays
    `arrays` (local under the face rule), or None."""
    if arrays is None:
        return None
    return tuple(
        distributed.redistribute(mesh, f, faces[a], [face_box(b, a) for b in cells.held], 0.0)
        for a, f in enumerate(arrays)
    )


def _window_boxes(setup, config, mesh: DistMesh):
    """(the layout of the window's finest level, every rank's block of it
    in base coordinates)."""
    from geometricmultigridpressuresolver_tpu_torch.solver import mgpcg

    fine = mgpcg.fine_layout(setup.problem, config, mesh)
    window = distributed.block_layout(mesh, fine.shape, fine.split)
    off = window_offset(setup.window_start, setup.base_pads)
    return window, [shift_box(b, off) for b in window.held]


def window_rhs(setup, velocity, solid_velocity, config, mesh: DistMesh) -> torch.Tensor:
    """This rank's block of the solve's right-hand side from its blocks of
    `velocity` and `solid_velocity` (or None): `partitioned_project`'s step
    5, also for a caller that solves the same system again
    (`mgpcg.solve(mesh=)`)."""
    from geometricmultigridpressuresolver_tpu_torch.models import free_surface

    cells, faces = _base_layouts(setup.base_shape, mesh)
    rhs_base = free_surface.negative_divergence(
        setup.liquid_mask, _cell_faces(velocity, cells, faces, mesh), _cell_faces(setup.weights, cells, faces, mesh),
        _cell_faces(solid_velocity, cells, faces, mesh),
    )
    _, into_window = _window_boxes(setup, config, mesh)
    return distributed.redistribute(mesh, rhs_base, cells, into_window, 0.0)


def _base_layouts(base, mesh: DistMesh):
    """(the base cells' layout, the three face arrays' layouts)."""
    cells = distributed.block_layout(mesh, base, grid_split(mesh, base))
    return cells, [distributed.block_layout(mesh, face_shape(base, a), face_split(mesh.shape, base, a))
                   for a in range(3)]


def partitioned_project(setup, velocity, solid_velocity, old_pressure, config, mesh: DistMesh):
    """`free_surface.project` on a mesh of ranks with a setup holding the
    rank's blocks (module docstring).  Returns the rank's blocks of the
    pressure and the velocity, `cg.x` its block of the window, and the
    audit scalars and residual norms over all ranks."""
    from geometricmultigridpressuresolver_tpu_torch.models import free_surface

    if setup.base_shape is None:
        raise ValueError("the setup holds whole grids: build it with build_setup(mesh=) or cut it with shard_setup")
    if len(velocity) != 3 or (solid_velocity is not None and len(solid_velocity) != 3):
        raise ValueError("velocity must have one face array per axis")
    sd = config.solve_dtype
    base = setup.base_shape
    cells, faces = _base_layouts(base, mesh)
    velocity = tuple(_as_block(v, faces[a], mesh, sd) for a, v in enumerate(velocity))
    if solid_velocity is not None:
        solid_velocity = tuple(_as_block(v, faces[a], mesh, sd) for a, v in enumerate(solid_velocity))
    liquid = setup.liquid_mask

    # Steps 5-6: the right-hand side and the warm start on the base block,
    # carried into this rank's block of the window.
    rhs = window_rhs(setup, velocity, solid_velocity, config, mesh)
    problem = setup.problem
    window, into_window = _window_boxes(setup, config, mesh)
    x0 = None
    if config.use_old_pressure and old_pressure is not None:
        old = _as_block(old_pressure, cells, mesh, sd)
        warm = torch.where(liquid, old, torch.zeros_like(old))
        x0 = distributed.redistribute(mesh, warm, cells, into_window, 0.0)

    cg_result, rel_l2, linf = free_surface.solve_and_check(problem, rhs, x0, config, mesh)

    # Step 8: per axis, the pressure on the cells of this rank's face block
    # (whole along the axis), then the writeback on the face block.
    back = tuple(-o for o in window_offset(setup.window_start, setup.base_pads))
    new_velocity = []
    for a in range(3):
        face_cells = distributed.block_layout(mesh, base, face_split(mesh.shape, base, a))
        p = distributed.redistribute(mesh, cg_result.x, window, [shift_box(b, back) for b in face_cells.held], 0.0)
        material = distributed.redistribute(mesh, setup.material, cells, face_cells.held, 0)
        phi = distributed.redistribute(mesh, setup.liquid_phi, cells, face_cells.held, 0.0)
        p = torch.where(material == LIQUID, p, torch.zeros_like(p))
        valid, scale = free_surface.face_fields_axis(material, phi, setup.weights[a], a, config.theta_clamp, sd)
        new_velocity.append(free_surface.pressure_gradient_axis(velocity[a], p, valid, scale, a))
    pressure = distributed.redistribute(mesh, p, face_cells, cells.held, 0.0)

    # Step 9: the audit on this rank's cells, over all ranks in rank order.
    owned = mesh.owns(grid_split(mesh, base))
    div = -free_surface.negative_divergence(
        liquid, *(_cell_faces(f, cells, faces, mesh) for f in (new_velocity, setup.weights, solid_velocity))
    )
    max_div = distributed.ordered_max(mesh, torch.max(torch.abs(div)), owned)
    total = distributed.ordered_sum(mesh, torch.sum(div), owned)
    count = torch.clamp(distributed.ordered_sum(mesh, torch.sum(liquid), owned), min=1)
    return free_surface.ProjectionResult(
        pressure, tuple(new_velocity), cg_result, max_div, total / count, rel_l2, linf, total
    )
