"""MGPCG Poisson solver: V-cycle-preconditioned conjugate gradient.

Port of ``solver/mgpcg.py``.  The outer CG runs in `config.solve_dtype`,
the V-cycle in `config.mg_dtype` (a fixed lower-precision preconditioner is
still a fixed symmetric operator).  `solve` always uses the fused CG
driver: every iteration is one `ops.fused_cg.search_matvec_dot` step plus
one V-cycle whose fine upstroke emits rho.  On CUDA tensors these are the
hand-written kernels; on CPU tensors their plain versions.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from geometricmultigridpressuresolver_tpu_torch.config import SolverConfig
from geometricmultigridpressuresolver_tpu_torch.ops import fused_cg, stencil
from geometricmultigridpressuresolver_tpu_torch.solver import cg as cg_mod
from geometricmultigridpressuresolver_tpu_torch.solver import mg as mg_mod


class PoissonProblem(NamedTuple):
    """Static device data for one label/weight set."""

    fine: stencil.LevelCoeffs   # finest-level CG operator in solve dtype
    hier: mg_mod.MGHierarchy    # V-cycle hierarchy in mg dtype


def fine_plan(config: SolverConfig):
    """(mg_dtype, fine_dtype, fine_full): which extra finest-level CG operator
    pieces the setup must build.  fine_dtype None shares the hierarchy's
    finest level; fine_full=False builds only solve-dtype edge weights (the
    edge-weight storage narrows); fine_full builds a full coefficient set
    (distinct MG precision)."""
    dtype = config.mg_dtype_resolved
    same = dtype == config.solve_dtype
    fine_dtype = None if (same and config.mg_ew_dtype is None) else config.solve_dtype
    return dtype, fine_dtype, not same


def build_problem(
    labels,
    face_weights: Sequence | None,
    mg_levels: int,
    config: SolverConfig | None = None,
    validate: bool = False,
    device=None,
) -> PoissonProblem:
    """Problem from expanded and relabeled labels (+ finest weights), built
    on `device` (default: the labels' device, CPU for numpy input)."""
    if config is None:
        config = SolverConfig()
    dtype, fine_dtype, fine_full = fine_plan(config)
    target_levels = mg_levels
    if config.max_mg_levels is not None:
        target_levels = min(target_levels, config.max_mg_levels)
    dev = mg_mod._device_of(labels, device)
    lab = torch.as_tensor(labels, device=dev).to(torch.int8)
    fw = None if face_weights is None else tuple(
        torch.as_tensor(w, dtype=config.solve_dtype, device=dev) for w in face_weights
    )
    levels, flags, label_levels, fine = mg_mod._build_levels(
        lab, fw, target_levels, config.boundary_width, dtype, config.mg_ew_dtype,
        fine_dtype, fine_full,
    )
    hier = mg_mod._finish_hierarchy(levels, flags, label_levels, config, validate=validate, host_fw=fw)
    return _finish_problem(hier, fine, fine_full)


def _finish_problem(hier: mg_mod.MGHierarchy, fine, fine_full: bool) -> PoissonProblem:
    """Attach the finest-level CG operator to the hierarchy."""
    if fine is None:
        fine_coeffs = hier.levels[0]
    elif fine_full:
        fine_coeffs = fine
    else:
        fine_coeffs = hier.levels[0]._replace(ew0=fine[0], ew1=fine[1], ew2=fine[2])
    return PoissonProblem(fine=fine_coeffs, hier=hier)


def fine_residual(problem: PoissonProblem, config: SolverConfig):
    """`residual(x, b)`: the masked b - A x of the finest CG operator, through
    the residual kernel on CUDA tensors."""
    fine = problem.fine

    def residual(x, b):
        r = fused_cg.residual(
            x, b, fine.diag, fine.ew0, fine.ew1, fine.ew2, mode=config.kernel_mode
        )
        return torch.where(fine.solvable, r, torch.zeros_like(r))

    return residual


def solve(
    problem: PoissonProblem,
    rhs: torch.Tensor,
    x0: torch.Tensor | None = None,
    config: SolverConfig | None = None,
) -> cg_mod.CGResult:
    """MGPCG solve of the dimensionless Poisson system over solvable cells,
    on the device that holds `problem` and `rhs`."""
    if config is None:
        config = SolverConfig()
    fine = problem.fine
    sd = config.solve_dtype
    mg_dtype = config.mg_dtype_resolved

    def step_p(z, p, beta):
        return fused_cg.search_matvec_dot(
            z, p, beta, fine.diag, fine.ew0, fine.ew1, fine.ew2, mode=config.kernel_mode
        )

    preconditioner_dot = None
    if config.use_mg_preconditioner:
        def preconditioner(r):
            return mg_mod.v_cycle(problem.hier, None, r.to(mg_dtype), config).to(sd)

        def preconditioner_dot(r):
            z, rho = mg_mod.v_cycle(
                problem.hier, None, r.to(mg_dtype), config, emit_fine_dot=True
            )
            return z.to(sd), rho
    else:
        def preconditioner(r):
            return fine.inv_diag * r

    return cg_mod.solve_pcg_fused(
        step_p,
        fine_residual(problem, config),
        preconditioner,
        rhs.to(sd),
        fine.solvable,
        x0=x0,
        tolerance=config.tolerance,
        max_iterations=config.max_iterations,
        project_null_space=config.project_null_space,
        preconditioner_dot=preconditioner_dot,
        record_residuals=config.record_residuals,
    )
