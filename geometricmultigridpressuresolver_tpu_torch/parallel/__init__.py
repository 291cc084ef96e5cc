"""Block decomposition of the solve on one card (port of ``parallel/``).

`mesh` (BlockMesh, factor_mesh, make_mesh, grid_split), `halo` (the stacked
haloed-block layout: gather and scatter kernels), `fused_sharded` (the
block-mesh smoother and CG step).  Entry: ``free_surface.project(...,
mesh=make_mesh(4))``.
"""

from geometricmultigridpressuresolver_tpu_torch.parallel.mesh import (
    BlockMesh,
    factor_mesh,
    grid_split,
    make_mesh,
)

__all__ = ["BlockMesh", "factor_mesh", "grid_split", "make_mesh"]
