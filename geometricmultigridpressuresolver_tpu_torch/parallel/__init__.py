"""The decomposed solve (port of ``parallel/``).

`mesh` (BlockMesh, DistMesh, factor_mesh, make_mesh, grid_split,
local_slices), `halo` (the stacked haloed-block layout's gather and
scatter kernels; the rank-to-rank exchange), `fused_sharded` (the
block-mesh smoother and CG step, on one card or a rank's block),
`distributed` (the process group, the mesh of ranks, the ordered
collectives), `sharding` (a rank's share of a problem or setup), `dryrun`
(a world of ranks launched on one machine).  Entries:
``free_surface.project(..., mesh=make_mesh(4))`` on one card, and
``mesh = distributed.initialize()`` then ``build_setup(..., mesh=mesh)`` /
``project(..., mesh=mesh)`` in every rank.
"""

from geometricmultigridpressuresolver_tpu_torch.parallel.mesh import (
    BlockMesh,
    DistMesh,
    factor_mesh,
    grid_split,
    local_slices,
    make_mesh,
)

__all__ = ["BlockMesh", "DistMesh", "factor_mesh", "grid_split", "local_slices", "make_mesh"]
