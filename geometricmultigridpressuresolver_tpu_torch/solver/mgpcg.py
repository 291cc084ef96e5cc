"""MGPCG Poisson solver: V-cycle-preconditioned conjugate gradient.

Port of ``solver/mgpcg.py``.  The outer CG runs in `config.solve_dtype`,
the V-cycle in `config.mg_dtype` (a fixed lower-precision preconditioner is
still a fixed symmetric operator).  `solve` always uses the fused CG
driver: every iteration is one `ops.fused_cg.search_matvec_dot` step plus
one V-cycle whose fine upstroke emits rho.  On CUDA tensors these are the
hand-written kernels; on CPU tensors their plain versions.  With a block
mesh (`solve(..., mesh=)`, `parallel.mesh.BlockMesh`) the V-cycle runs the
block-mesh smoother on the levels it flags "sharded", and when the fine
level is one of them the CG step is `parallel.fused_sharded.cg_step_sharded`
(JAX mgpcg.py:173-193).  `solve(..., interrupt_check=)` passes a host
callback to the CG loop (`solver.cg`), checked once per iteration.  On
a CUDA device in one process the loop runs as a captured CUDA graph with
its exit test on the device (`solver.graph`, the JAX package's
`lax.while_loop`); across ranks it runs eagerly (`run_stages`).
`solve_stages` builds the loop's operators once per solve; the stage
profiler (`utils.profiling.instrumented_solve`) runs the same ones.

Across ranks (`mesh=` a `parallel.mesh.DistMesh`, JAX mgpcg.py:94-113's
sharded build) `build_problem` builds only the rank's blocks of the levels
the solve runs sharded (`parallel.sharding.partitioned_problem`, the
partitioned build `free_surface.build_setup(mesh=)` runs); `solve` takes
the right-hand side and the start as the whole fine grid or as the rank's
block of it and returns the rank's block of x.  The CG step and the
recomputed residual then run on the rank's haloed fine block, and every
dot and norm is summed over the ranks in rank order (`solver.cg`).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Sequence

import torch

from geometricmultigridpressuresolver_tpu_torch import device as device_mod
from geometricmultigridpressuresolver_tpu_torch.config import SolverConfig
from geometricmultigridpressuresolver_tpu_torch.ops import fused_cg, fused_smoother, stencil, transfer
from geometricmultigridpressuresolver_tpu_torch.parallel import distributed, fused_sharded, sharding
from geometricmultigridpressuresolver_tpu_torch.parallel.mesh import DistMesh
from geometricmultigridpressuresolver_tpu_torch.solver import cg as cg_mod
from geometricmultigridpressuresolver_tpu_torch.solver import graph
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
    mesh=None,
) -> PoissonProblem:
    """Problem from expanded and relabeled labels (+ finest weights), built
    on `device` (default: the mesh's device, else the labels' device if
    they are a tensor, else the card).  With a `DistMesh`, every rank
    calls this together with the whole labels and weights and builds only
    its blocks (`sharding.partitioned_problem`: equal bit for bit to
    `shard_problem` of the whole build)."""
    if config is None:
        config = SolverConfig()
    _, fine_dtype, fine_full = fine_plan(config)
    target_levels = mg_levels
    if config.max_mg_levels is not None:
        target_levels = min(target_levels, config.max_mg_levels)
    if isinstance(mesh, DistMesh):
        fetch, shape = sharding.grid_fetch(labels, face_weights, mesh, config)
        return sharding.partitioned_problem(fetch, shape, target_levels, config, mesh, relabel=False,
                                            validate=validate)
    if mesh is not None and device is None:
        device = mesh.device
    dev = device_mod.of(labels, device)
    lab = torch.as_tensor(labels, device=dev).to(torch.int8)
    fw = None if face_weights is None else tuple(
        torch.as_tensor(w, dtype=config.solve_dtype, device=dev) for w in face_weights
    )
    levels, flags, label_levels, fine = mg_mod.device_hierarchy(
        lab, fw, target_levels, config, fine_dtype, fine_full, mesh=mesh,
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


def fine_tiles(problem: PoissonProblem, block_lists=None) -> fused_smoother.Tiles:
    """The active tiles of the finest CG operator's grid, for the CG-step
    and residual kernels: those of the V-cycle's `block_lists`
    (`mg.hierarchy_block_lists`) when given and the fine level has them,
    else built here (on the device)."""
    if block_lists is not None and block_lists[0] is not None:
        return block_lists[0].tiles
    fine = problem.fine
    return fused_smoother.level_tiles(fine.solvable, fused_smoother.band_cells(fine.band))


class FineLayout(NamedTuple):
    """How the finest level lies across the ranks of a `DistMesh`: its
    global shape, whether the solve runs it sharded, the axes its blocks
    are cut on, and the reductions over it (`distributed.Ranks`)."""

    shape: tuple[int, int, int]
    sharded: bool
    split: tuple[bool, bool, bool]
    ranks: distributed.Ranks


def fine_layout(problem: PoissonProblem, config: SolverConfig, mesh: DistMesh) -> FineLayout:
    """The `FineLayout` of a problem holding a rank's blocks."""
    if problem.hier.shapes is None:
        raise ValueError("the problem holds no rank's blocks: shard it first (sharding.shard_problem)")
    shape = problem.hier.shapes[0]
    sharded = mg_mod.level_flags(problem.hier, config, mesh)[0] == "sharded"
    split = sharding.level_split(mesh, shape, sharded)
    return FineLayout(shape, sharded, split, distributed.Ranks(mesh, mesh.owns(split)))


def fine_block(t: torch.Tensor, problem: PoissonProblem, layout: FineLayout) -> torch.Tensor:
    """`t` as this rank's block of the finest level: a whole fine grid is
    cut, a block of the right shape passes."""
    mesh = layout.ranks.mesh
    if tuple(t.shape) == tuple(layout.shape):
        return sharding.block_of(t, mesh, layout.split)
    if tuple(t.shape) == tuple(problem.fine.shape):
        return t
    raise ValueError(
        f"a field of shape {tuple(t.shape)}: neither the fine grid {layout.shape} nor this "
        f"rank's block {problem.fine.shape} of it"
    )


def fine_residual(problem: PoissonProblem, config: SolverConfig, tiles=None, mesh=None, prehaloed=None):
    """`residual(x, b)`: the masked b - A x of the finest CG operator, through
    the residual kernel on CUDA tensors over `tiles` (`fine_tiles`, built
    here when None).  Across ranks, on a sharded fine level, x and b are
    the rank's blocks and the kernel runs on its haloed block: `prehaloed`
    is the operator's (`prehalo_cg_coeffs`, `stacked_cg_tiles`) pair, its
    halos exchanged here when None."""
    fine = problem.fine
    if isinstance(mesh, DistMesh) and fine_layout(problem, config, mesh).sharded:
        shape = problem.hier.shapes[0]
        if prehaloed is None:
            fine_halo = fused_sharded.prehalo_cg_coeffs(fine, mesh, config.kernel_mode, shape)
            prehaloed = (fine_halo, fused_sharded.stacked_cg_tiles(fine_halo))
        fine_halo, halo_tiles = prehaloed

        def residual(x, b):
            r = fused_sharded.residual_sharded(x, b, fine_halo, halo_tiles, mesh, shape, config.kernel_mode)
            return torch.where(fine.solvable, r, torch.zeros_like(r))

        return residual
    if tiles is None:
        tiles = fine_tiles(problem)

    def residual(x, b):
        r = fused_cg.residual(
            x, b, fine.diag, fine.ew0, fine.ew1, fine.ew2, mode=config.kernel_mode, tiles=tiles
        )
        return torch.where(fine.solvable, r, torch.zeros_like(r))

    return residual


class SolveStages(NamedTuple):
    """The per-solve operators of `solve`'s CG loop (`solve_stages`)."""

    step_p: Callable            # (z, p, beta, p_out=None) -> (p', A p', <p', A p'>)
    residual: Callable          # (x, b) -> masked b - A x
    preconditioner: Callable    # r -> z
    preconditioner_dot: Callable | None  # r -> (z, <r, z>); None without a V-cycle
    ranks: distributed.Ranks | None = None  # the CG loop's reductions across ranks


def solve_stages(problem: PoissonProblem, config: SolverConfig, mesh=None) -> SolveStages:
    """The operators one solve runs, with their solve-invariant data built
    once: the fused CG step, the warm start's residual, and the V-cycle (or
    inverse-diagonal) preconditioner, with and without the fine rho dot.
    `solve` and `utils.profiling.instrumented_solve` both run these, so the
    two launch the same kernels in the same order.  Across ranks their
    dots are totals over the ranks, and `ranks` sums the loop's own."""
    fine = problem.fine
    sd = config.solve_dtype
    mg_dtype = config.mg_dtype_resolved
    layout = fine_layout(problem, config, mesh) if isinstance(mesh, DistMesh) else None
    shape0 = mg_mod.level_shapes(problem.hier)[0]

    # Band-cell lists, narrowed coefficients, active tiles and sharded
    # levels' stacked coefficients: once per solve.
    blocks = None
    if config.use_mg_preconditioner:
        blocks = mg_mod.hierarchy_block_lists(problem.hier, config, mesh)
    tiles = fine_tiles(problem, blocks)

    prehaloed = None
    if mg_mod.level_flags(problem.hier, config, mesh)[0] == "sharded":
        # The operator's stacked haloed blocks and their tiles: once per solve.
        fine_halo = fused_sharded.prehalo_cg_coeffs(fine, mesh, config.kernel_mode, shape0)
        halo_tiles = fused_sharded.stacked_cg_tiles(fine_halo)
        prehaloed = (fine_halo, halo_tiles)

        def step_p(z, p, beta, p_out=None):
            return fused_sharded.cg_step_sharded(
                z, p, beta, fine, config, mesh, prehaloed_cg=fine_halo, tiles=halo_tiles, shape=shape0,
                p_out=p_out,
            )
    else:
        def step_p(z, p, beta, p_out=None):
            pn, ap, dot = fused_cg.search_matvec_dot(
                z, p, beta, fine.diag, fine.ew0, fine.ew1, fine.ew2, mode=config.kernel_mode,
                tiles=tiles, p_out=p_out,
            )
            # A whole fine level across ranks: rank 0's dot on every rank.
            return pn, ap, dot if layout is None else layout.ranks.sum(dot)

    preconditioner_dot = None
    if config.use_mg_preconditioner:
        def preconditioner(r):
            return mg_mod.v_cycle(
                problem.hier, None, r.to(mg_dtype), config, block_lists=blocks, mesh=mesh
            ).to(sd)

        def preconditioner_dot(r):
            z, rho = mg_mod.v_cycle(
                problem.hier, None, r.to(mg_dtype), config, emit_fine_dot=True,
                block_lists=blocks, mesh=mesh,
            )
            return z.to(sd), rho
    else:
        def preconditioner(r):
            return fine.inv_diag * r

    residual = fine_residual(problem, config, tiles, mesh, prehaloed)
    return SolveStages(
        step_p, residual, preconditioner, preconditioner_dot, None if layout is None else layout.ranks
    )


def solve(
    problem: PoissonProblem,
    rhs: torch.Tensor,
    x0: torch.Tensor | None = None,
    config: SolverConfig | None = None,
    mesh=None,
    interrupt_check=None,
) -> cg_mod.CGResult:
    """MGPCG solve of the dimensionless Poisson system over solvable cells,
    on the device that holds `problem` and `rhs`; `mesh` (a one-card
    `BlockMesh` on that device) runs the sharded levels block by block.
    `interrupt_check(iteration) -> bool`, evaluated on the host after each
    CG iteration, stops the solve early when it returns True (JAX
    mgpcg.solve's cooperative interruption).

    With a `DistMesh` every rank of the mesh calls this together with its
    share of the problem (`build_problem(mesh=)`); `rhs` and `x0` are the
    whole fine grid or this rank's block of it; the result's x is the
    rank's block (`distributed.gather_blocks` assembles the grid).  Every
    rank passes an `interrupt_check` or none does; rank 0's answer counts.

    On the card in one process without an `interrupt_check`
    (`graph.programs_on`) the whole solve is one program, the JAX
    package's `_solve` on `_SOLVE_STATICS`: its operators, the first
    iteration, the loop as a WHILE node on the device's exit test and the
    result, captured once per configuration, mesh and the shapes and
    dtypes of the problem and the fields, and replayed by every later
    solve with that key, of this problem or another.  The problem, `rhs`
    and `x0` are copied into the program's buffers and the result out of
    them; the scalars come to the host in one read.  With an
    `interrupt_check` the loop is captured per solve and launched once
    per iteration (`graph.run`), as the JAX package compiles per
    callback."""
    if config is None:
        config = SolverConfig()
    rhs, x0 = solve_inputs(problem, rhs, x0, config, mesh)
    if interrupt_check is None and not isinstance(mesh, DistMesh) and graph.programs_on(rhs.device):
        return _solve_program(problem, rhs, x0, config, mesh)
    return run_stages(solve_stages(problem, config, mesh), problem, rhs, x0, config, interrupt_check)


def _solve_program(problem: PoissonProblem, rhs, x0, config: SolverConfig, mesh) -> cg_mod.CGResult:
    """`solve` as the cached program of its key (see `solve`)."""
    def fn(problem, rhs, x0, device_loop):
        return run_stages(solve_stages(problem, config, mesh), problem, rhs, x0, config, device_loop=device_loop)

    result = graph.call("solve", (config, mesh), fn, (problem, rhs, x0), rhs.device,
                        prepare=capture_prepare(problem, config), loop=True)
    return host_result(result)


def capture_prepare(problem: PoissonProblem, config: SolverConfig):
    """What a captured solve of `problem` must find made (`graph.Program`'s
    `prepare`): the matrix-form transfers' matrices for its levels'
    shapes and field dtypes (`transfer.prepare`; `transfer._matrix`
    refuses under a capture)."""
    hier = problem.hier
    dev = problem.fine.diag.device
    shapes = mg_mod.level_shapes(hier)
    dtypes = {hier.levels[0].diag.dtype, mg_mod.field_dtype(hier, config)}

    def prepare():
        if mg_mod.use_mm_transfers(config, dev):
            transfer.prepare(shapes, dev, dtypes)

    return prepare


def host_result(result: cg_mod.CGResult) -> cg_mod.CGResult:
    """A device-only solve's result (`cg.solve_pcg_fused(device_loop=)`)
    with its iteration count, relative residual and convergence read to
    the host in one transfer, as `solve` returns them (as it is where
    they are on the host already)."""
    if not isinstance(result.iterations, torch.Tensor):
        return result
    it, rel, converged = cg_mod.host(result.iterations, result.relative_residual, result.converged)
    return result._replace(iterations=int(it), relative_residual=rel, converged=bool(converged))


def solve_inputs(problem: PoissonProblem, rhs: torch.Tensor, x0, config: SolverConfig, mesh=None):
    """`solve`'s (rhs, x0), checked against the mesh's device and, across
    ranks, cut to this rank's block of the fine grid."""
    if mesh is not None:
        fused_sharded.check_device(mesh, rhs)
    if isinstance(mesh, DistMesh):
        layout = fine_layout(problem, config, mesh)
        rhs = fine_block(rhs, problem, layout)
        x0 = None if x0 is None else fine_block(x0, problem, layout)
    return rhs, x0


def run_stages(
    stages: SolveStages,
    problem: PoissonProblem,
    rhs: torch.Tensor,
    x0: torch.Tensor | None,
    config: SolverConfig,
    interrupt_check=None,
    device_loop=None,
) -> cg_mod.CGResult:
    """The CG loop of `solve` on operators built by `solve_stages`, for
    inputs from `solve_inputs` (a caller that reuses the operators, as
    `free_surface.project` does for its recomputed residual), driven as
    `loop_runner` says, or with no host read by `device_loop`
    (`cg.solve_pcg_fused`; a captured frame, `graph.FrameGraph`)."""
    return cg_mod.solve_pcg_fused(
        stages.step_p,
        stages.residual,
        stages.preconditioner,
        rhs.to(config.solve_dtype),
        problem.fine.solvable,
        x0=x0,
        tolerance=config.tolerance,
        max_iterations=config.max_iterations,
        project_null_space=config.project_null_space,
        preconditioner_dot=stages.preconditioner_dot,
        record_residuals=config.record_residuals,
        interrupt_check=interrupt_check,
        ranks=stages.ranks,
        run_loop=None if device_loop is not None else loop_runner(stages, rhs),
        device_loop=device_loop,
    )


def loop_runner(stages: SolveStages, rhs: torch.Tensor):
    """The rule for the CG loop: on a CUDA device in one process (a
    one-card `BlockMesh` and ``kernel_mode="torch"`` included) it runs as a
    captured CUDA graph with its exit test on the device (`graph.run`);
    across ranks (`stages.ranks`, a `DistMesh`) and on the CPU it runs
    eagerly, the test on the host (None: `cg.run_eager`).  gloo's
    collectives cannot be captured, and NCCL's capture cannot be tested on
    one card."""
    return graph.run if rhs.is_cuda and stages.ranks is None else None
