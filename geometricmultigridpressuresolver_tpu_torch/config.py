"""Solver configuration of the PyTorch port.

The knobs of ``geometricmultigridpressuresolver_tpu.config.SolverConfig``
that mean something on the port's path, with the same names and defaults,
plus `kernel_mode`.  The JAX package's other knobs have no meaning on the
card and are absent on purpose (passing one raises ``TypeError``):

  * `pallas_interpret`: the Pallas interpreter; `kernel_mode="torch"` is
    the port's plain path.
  * `pallas_block_t`, `pallas_block_y`: the TPU's (8, 128) slab tiling;
    the CUDA kernels tile by `ops.fused_smoother.CHUNK_TILE`.
  * `pallas_pad_coarse`, `pallas_pad_min_cells`, `pallas_pad_max_ratio`:
    padded views that meet the TPU kernel's slab shapes; the chunk kernel
    takes any shape.

`setup_fusion` keeps the JAX package's values and threshold: how many
device programs the setup is (one CUDA graph for the expansion, every
level and the fine operator, or one per level).  On the card the graphs
of one setup share one memory pool (`solver.graph.Program`), so the two
forms hold about the same workspace, where on the TPU "per-level" holds
less.  On the CPU the setup runs eagerly whatever its value.

One default differs: `solve_dtype` is float64, the reference's all-double
solve.  The JAX package resolves its default from ``jax_enable_x64``; torch
has no such switch.
"""

from __future__ import annotations

import dataclasses

import torch

_FLOATS = (torch.float32, torch.float64)
_EW_DTYPES = (None, torch.bfloat16, torch.float32, torch.float64)
_FIELD_DTYPES = (None, torch.bfloat16)
KERNEL_MODES = ("auto", "torch", "cuda")
ADVECTION_SCHEMES = ("semi_lagrangian", "upwind")
TRANSFER_MODES = ("auto", "mm", "slice")
INTERIOR_SMOOTHERS = (None, "chebyshev")
SETUP_FUSIONS = ("auto", "fused", "per-level")


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
      interior_smoother: None derives the interior smoother from
        use_gauss_seidel; "chebyshev" runs the polynomial smoother
        (`ops.stencil.chebyshev_smooth`) of `chebyshev_degree` on every
        level, in plain PyTorch as the JAX package runs it on its jnp path
        (`solver/mg.py`: no level goes to the chunk kernel).
      chebyshev_degree: degree of the Chebyshev polynomial.
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
      pallas_band_strip: 0 runs every boundary ('b') pass of the plain
        smoother over the whole grid; any value > 0 restricts the passes
        that can be restricted to a compacted list of the level's band
        cells, at every level and every nz.  The JAX package's name and
        default (128) are kept; on the TPU the value is a lane-strip width.
        The numbers are the same as the full pass (off the band a 'b' pass
        is the exact identity).  On the card it does not change the launch
        plan: the chunk kernel (csrc/smoother.cu) skips the neighbour sum of
        every non-band cell of a 'b' pass whatever the value.
      mg_field_dtype: storage dtype of the V-cycle's x / rhs / residual
        fields on the smoothed levels (None keeps the mg dtype).  bfloat16
        stores x, b and inv_diag narrow while each smoothing block computes
        in float32 and narrows once at its end.  Applies to a float32 V-cycle
        whose downstroke can emit its residual (`residual_fusable`); other
        configurations keep the mg dtype, as in the JAX package.
      window_slack: extra window headroom, in units of the exterior
        padding, added when a frame's liquid outgrows the previous frame's
        window (`build_setup(reuse_from=...)`).
      advection: "semi_lagrangian" (trilinear backtrace) or "upwind"
        (first-order stencil) for the frame loop (`models/simulate.py`).
      advect_substeps: sub-Euler steps of the upwind scheme.
      transfer_mode: the V-cycle's restriction and prolongation.  "mm" runs
        each as three per-axis matrix products (`ops.transfer.restrict_mm`,
        `prolong_add_mm`: IEEE products, exactly adjoint by construction),
        "slice" as shifted slices (`restrict`, `prolong_add`); "auto" takes
        the products on a CUDA device and the slices on the CPU, as the JAX
        package takes them on the TPU and not elsewhere
        (`solver.mg.use_mm_transfers`).
      setup_fusion: the setup's program granularity on the card.  "fused"
        captures the window expansion, every hierarchy level and the fine
        CG operator as ONE CUDA graph (`models.free_surface.
        _expand_build_device`, `solver.mg.device_hierarchy`); "per-level"
        captures the expansion and each level as graphs of their own (JAX
        `_device_level`), replayed in order from one memory pool, so a
        level's workspace is free for the next as it is inside the fused
        graph; "auto" takes per-level above SETUP_FUSION_AUTO_CELLS cells
        per device, fused below (the JAX package's threshold, so both
        packages pick the same granularity for the same window; on the
        card the two hold about the same memory).  The setup is captured
        once per shape and replayed after that (`solver.graph.PROGRAMS`);
        on the CPU it runs eagerly.
    """

    solve_dtype: torch.dtype = torch.float64
    mg_dtype: torch.dtype | None = None
    mg_ew_dtype: torch.dtype | None = None
    use_gauss_seidel: bool = True
    interior_smoother: str | None = None
    chebyshev_degree: int = 2
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
    pallas_band_strip: int = 128
    mg_field_dtype: torch.dtype | None = None
    window_slack: int = 1
    advection: str = "semi_lagrangian"
    advect_substeps: int = 4
    transfer_mode: str = "auto"
    setup_fusion: str = "auto"

    # The JAX package's bracket (config.py there): the fused setup program
    # fit at a 95.4M-cell window and ran out of memory at 125.8M, so "auto"
    # switches just above the side that fit.
    SETUP_FUSION_AUTO_CELLS = 96_000_000

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
        if self.mg_field_dtype not in _FIELD_DTYPES:
            raise ValueError(
                f"config.mg_field_dtype={self.mg_field_dtype}; expected {_FIELD_DTYPES}"
            )
        strip = self.pallas_band_strip
        if isinstance(strip, bool) or not isinstance(strip, int) or strip < 0:
            raise ValueError(f"config.pallas_band_strip={strip!r}; expected an int >= 0")
        if self.interior_smoother not in INTERIOR_SMOOTHERS:
            raise ValueError(
                f"config.interior_smoother={self.interior_smoother!r}; expected one of "
                f"{INTERIOR_SMOOTHERS}"
            )
        if self.transfer_mode not in TRANSFER_MODES:
            raise ValueError(
                f"config.transfer_mode={self.transfer_mode!r}; expected one of {TRANSFER_MODES}"
            )
        if self.advection not in ADVECTION_SCHEMES:
            raise ValueError(
                f"config.advection={self.advection!r}; expected one of {ADVECTION_SCHEMES}"
            )
        if self.setup_fusion not in SETUP_FUSIONS:
            raise ValueError(
                f"config.setup_fusion={self.setup_fusion!r}; expected one of {SETUP_FUSIONS}"
            )

    def setup_fusion_resolved(self, expanded_shape, n_devices: int = 1) -> str:
        """The setup granularity for a window of `expanded_shape`: the
        knob, or under "auto" "per-level" when the window's cells per
        device exceed SETUP_FUSION_AUTO_CELLS, else "fused" (the JAX
        package's rule, with `n_devices` the mesh's size)."""
        if self.setup_fusion != "auto":
            return self.setup_fusion
        cells = 1
        for s in expanded_shape:
            cells *= int(s)
        per_device = cells // max(1, n_devices)
        return "per-level" if per_device > self.SETUP_FUSION_AUTO_CELLS else "fused"

    @property
    def mg_dtype_resolved(self) -> torch.dtype:
        return self.solve_dtype if self.mg_dtype is None else self.mg_dtype
