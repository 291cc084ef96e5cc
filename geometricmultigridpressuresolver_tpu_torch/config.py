"""Solver configuration of the PyTorch port.

The knobs of ``geometricmultigridpressuresolver_tpu.config.SolverConfig``
that mean something on the port's path, with the same names and defaults,
plus `kernel_mode`.  Knobs that exist only for the TPU (Pallas interpret
mode and tiling, padded kernel views, band strips, MXU transfers, setup
program granularity, bf16 field storage) are absent on purpose: passing
one raises ``TypeError``.

One default differs: `solve_dtype` is float64, the reference's all-double
solve.  The JAX package resolves its default from ``jax_enable_x64``; torch
has no such switch.
"""

from __future__ import annotations

import dataclasses

import torch

_FLOATS = (torch.float32, torch.float64)
_EW_DTYPES = (None, torch.bfloat16, torch.float32, torch.float64)
KERNEL_MODES = ("auto", "torch", "cuda")


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """Configuration for the MGPCG pressure solver.

    Attributes:
      solve_dtype: dtype of the outer CG iteration.
      mg_dtype: dtype of the V-cycle preconditioner (None: solve_dtype).
      mg_ew_dtype: storage dtype of the V-cycle's off-diagonal edge weights
        (None keeps mg_dtype).  bfloat16 halves their traffic; quantizing
        the off-diagonal symmetrically keeps the V-cycle symmetric.  The
        outer CG operator always stays in solve_dtype.
      use_gauss_seidel: red/black Gauss-Seidel interior smoother when True,
        damped Jacobi otherwise.
      jacobi_damping: damped-Jacobi weight (reference 2/3).
      boundary_width: BFS band width for extra boundary smoothing.
      boundary_iterations: damped-Jacobi passes over the band before and
        after each interior smooth.
      tolerance: relative residual tolerance (||r|| <= tol * ||b||).
      max_iterations: CG iteration cap.
      theta_clamp: lower clamp of the ghost-fluid theta.
      project_null_space: subtract the mean from the residual each iteration
        (all-Neumann case).
      use_old_pressure: warm-start CG from the previous pressure.
      use_mg_preconditioner: V-cycle preconditioner when True, inverse
        diagonal otherwise.
      max_mg_levels: optional cap on the hierarchy depth.
      compact_domain: crop the multigrid domain to the aligned active
        bounding box after trimming far-field Dirichlet cells.
      dirichlet_band: Dirichlet rings kept around the liquid when trimming.
      coarse_dof_target: DOF budget of the coarsest level's direct solve,
        which sets the hierarchy depth of a compact domain.
      kernel_mode: "auto" launches the CUDA kernels for CUDA tensors and
        runs their plain PyTorch versions for CPU tensors; "torch" runs the
        plain versions everywhere (the reference the kernels are held
        against); "cuda" launches the kernels and raises on CPU tensors.
      record_residuals: record the relative residual of every CG iteration
        into CGResult.residual_history.
    """

    solve_dtype: torch.dtype = torch.float64
    mg_dtype: torch.dtype | None = None
    mg_ew_dtype: torch.dtype | None = None
    use_gauss_seidel: bool = True
    jacobi_damping: float = 2.0 / 3.0
    boundary_width: int = 3
    boundary_iterations: int = 3
    tolerance: float = 1e-5
    max_iterations: int = 2500
    theta_clamp: float = 0.01
    project_null_space: bool = False
    use_old_pressure: bool = True
    use_mg_preconditioner: bool = True
    max_mg_levels: int | None = None
    compact_domain: bool = True
    dirichlet_band: int = 4
    coarse_dof_target: int = 3000
    kernel_mode: str = "auto"
    record_residuals: bool = False

    def __post_init__(self):
        if self.kernel_mode not in KERNEL_MODES:
            raise ValueError(
                f"config.kernel_mode={self.kernel_mode!r}; expected one of {KERNEL_MODES}"
            )
        if self.solve_dtype not in _FLOATS:
            raise ValueError(f"config.solve_dtype={self.solve_dtype}; expected {_FLOATS}")
        if self.mg_dtype not in (None,) + _FLOATS:
            raise ValueError(f"config.mg_dtype={self.mg_dtype}; expected None or {_FLOATS}")
        if self.mg_ew_dtype not in _EW_DTYPES:
            raise ValueError(f"config.mg_ew_dtype={self.mg_ew_dtype}; expected {_EW_DTYPES}")

    @property
    def mg_dtype_resolved(self) -> torch.dtype:
        return self.solve_dtype if self.mg_dtype is None else self.mg_dtype
