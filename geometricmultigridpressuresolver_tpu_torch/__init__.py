"""PyTorch / CUDA port of the geometric multigrid pressure solver.

A second package beside ``geometricmultigridpressuresolver_tpu`` (the JAX
reference, which it never imports): the same free-surface MGPCG pressure
projection on torch tensors, with the JAX package's three Pallas TPU
kernels rewritten as hand-written CUDA C++ kernels for Hopper (sm_90a,
``csrc/``).  CUDA tensors go through the kernels; CPU tensors through each
kernel's plain PyTorch version.  The kernels are compiled with nvcc at
first use, never at import.

Layers:
  grids.py, config.py   -- labels, conventions, configuration
  ops/                  -- domain construction, stencils, transfers, BLAS,
                           and the kernel wrappers (fused_smoother, fused_cg)
  solver/               -- V-cycle engine, PCG driver, MGPCG
  models/               -- scenes, the free-surface projection, the frame
                           loop, and the assembled-matrix baseline
  diagnostics.py        -- the reference's test node: fixtures, four test
                           blocks and the gmg-torch-diagnostics CLI
  utils/                -- stage timings, the instrumented solve, the
                           per-level V-cycle split and a profiler trace
  interop.py            -- build the port's containers from numpy arrays
"""

from geometricmultigridpressuresolver_tpu_torch.config import SolverConfig
from geometricmultigridpressuresolver_tpu_torch.grids import CellLabel, MaterialLabel

__version__ = "0.1.0"

__all__ = ["CellLabel", "MaterialLabel", "SolverConfig", "__version__"]
