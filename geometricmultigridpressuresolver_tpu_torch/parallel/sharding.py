"""A rank's share of the solver's data (port of ``parallel/sharding.py``).

The JAX package places every grid of a problem or setup on the mesh with
a `NamedSharding` and lets XLA's partitioner move data.  Across ranks
(`parallel.mesh.DistMesh`) each rank starts from the full tensors (every
rank ran the same deterministic build) and keeps:

  * its block of every level the solve runs sharded (`solver.mg.
    level_flags` says "sharded": the mesh splits the level and the block
    kernels take its geometry), cut by `mesh.local_slices` on the split
    axes;
  * everything else whole: the other levels (JAX leaves a split but
    ineligible level sharded under jnp and lets XLA add the halos; the
    port holds such a level whole on every rank, the same arithmetic per
    cell), the coarse direct solve's `coarse_dofs` / `coarse_minv` /
    `coarse_chol`, the +1 axis of a MAC face array (`shard_grid` leaves an
    indivisible axis whole) and the window origin (a static tuple).

The hierarchy records its levels' global shapes (`MGHierarchy.shapes`),
from which every rank derives the same flags, geometries and chunk plans.
`shard_setup` keeps the setup's base fields (material, weights, liquid
SDF) whole: `free_surface.project(mesh=)` forms the right-hand side, the
writeback and the audit on the full base grid on every rank, and only the
solve is distributed.
"""

from __future__ import annotations

import torch

from geometricmultigridpressuresolver_tpu_torch.ops import stencil
from geometricmultigridpressuresolver_tpu_torch.parallel.mesh import DistMesh, grid_split, local_slices


def block_of(arr: torch.Tensor, mesh: DistMesh, split) -> torch.Tensor:
    """This rank's block of a full grid split on the axes `split`, on the
    mesh's device."""
    idx = local_slices(mesh.shape, arr.shape, mesh.rank, split)
    return arr[idx].to(mesh.device).contiguous()


def shard_grid(arr, mesh: DistMesh, min_per_device: int = 8) -> torch.Tensor:
    """This rank's block of one cell- (or face-) shaped grid, by
    `grid_split`'s rule (an indivisible or too-short axis stays whole)."""
    arr = torch.as_tensor(arr)
    return block_of(arr, mesh, grid_split(mesh, arr.shape, min_per_device))


def shard_velocity(velocity, mesh: DistMesh, min_per_device: int = 8) -> tuple:
    return tuple(shard_grid(v, mesh, min_per_device) for v in velocity)


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
    problem by `shard_problem`; the base fields whole (see the module
    docstring), on the mesh's device."""
    return setup._replace(
        problem=shard_problem(setup.problem, mesh, config),
        material=setup.material.to(mesh.device),
        weights=tuple(w.to(mesh.device) for w in setup.weights),
        liquid_phi=setup.liquid_phi.to(mesh.device),
    )
