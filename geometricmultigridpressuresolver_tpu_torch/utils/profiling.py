"""Stage timings, an instrumented solve and a profiler trace.

Port of ``utils/profiling.py``.  The reference times every V-cycle stage
and CG sub-step with `UT_StopWatch` behind its `doPrintStats` flag; the
same stage taxonomy here:

  * `StageTimer` -- named wall-clock stages that end on a device sync;
  * `instrumented_solve` -- `solver.mgpcg.solve`'s CG loop run stage by
    stage on the operators of `mgpcg.solve_stages`, each stage timed, with
    per-iteration residual prints;
  * `vcycle_stage_times` -- per-level smooth / residual+restrict /
    coarse solve / prolong times of one V-cycle, replayed;
  * `trace` -- a `torch.profiler` trace (CPU and CUDA activities) written
    as a Chrome trace.

Every stage ends with `torch.cuda.synchronize` when its output is on the
card: without it the host clock measures only the launches' enqueue.  Each
sync also drains the queue the production solve keeps full, so the sum of
the stages is the solve's time plus the idle gaps the syncs open.
"""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass, field
from typing import Callable

import torch

from geometricmultigridpressuresolver_tpu_torch.config import SolverConfig
from geometricmultigridpressuresolver_tpu_torch.ops import blas, fused_cg, fused_smoother, stencil, transfer
from geometricmultigridpressuresolver_tpu_torch.solver import cg as cg_mod
from geometricmultigridpressuresolver_tpu_torch.solver import mg as mg_mod
from geometricmultigridpressuresolver_tpu_torch.solver import mgpcg


@dataclass
class StageTimes:
    """Accumulated wall-clock seconds and call counts per named stage."""

    seconds: dict = field(default_factory=dict)
    calls: dict = field(default_factory=dict)

    def add(self, name: str, dt: float) -> None:
        self.seconds[name] = self.seconds.get(name, 0.0) + dt
        self.calls[name] = self.calls.get(name, 0) + 1

    def report(self) -> str:
        total = sum(self.seconds.values())
        lines = [f"{'stage':<40}{'calls':>7}{'total s':>12}{'avg ms':>12}"]
        for name, s in sorted(self.seconds.items(), key=lambda kv: -kv[1]):
            n = self.calls[name]
            lines.append(f"{name:<40}{n:>7}{s:>12.4f}{1e3 * s / n:>12.3f}")
        lines.append(f"{'TOTAL':<40}{'':>7}{total:>12.4f}")
        return "\n".join(lines)


class StageTimer:
    """Wall-clock stage timing that ends on a device sync.

    Usage::

        timer = StageTimer()
        with timer.stage("matvec"):
            out = timer.sync(apply_a(x))   # the card is synced on exit
        print(timer.times.report())
    """

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self.times = StageTimes()
        self._devices = set()

    @contextlib.contextmanager
    def stage(self, name: str):
        if not self.enabled:
            yield self
            return
        t0 = time.perf_counter()
        yield self
        for dev in self._devices:
            torch.cuda.synchronize(dev)
        self._devices.clear()
        self.times.add(name, time.perf_counter() - t0)

    def sync(self, out):
        """Register `out` (a tensor or a tuple of them): a CUDA tensor's card
        is synchronized when the stage exits; a CPU tensor needs nothing."""
        for t in out if isinstance(out, tuple) else (out,):
            if isinstance(t, torch.Tensor) and t.is_cuda:
                self._devices.add(t.device)
        return out


@contextlib.contextmanager
def trace(log_dir: str):
    """`torch.profiler` over the block, CPU activities and, with a card,
    CUDA ones; writes a Chrome trace (chrome://tracing, Perfetto) to
    `log_dir/trace.json` on exit.  Yields the profiler, whose
    `key_averages()` the caller reads after the block."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def instrumented_solve(
    problem: mgpcg.PoissonProblem,
    rhs: torch.Tensor,
    x0: torch.Tensor | None = None,
    config: SolverConfig | None = None,
    print_stats: bool = True,
    printer: Callable[[str], None] = print,
) -> tuple[torch.Tensor, StageTimes]:
    """`mgpcg.solve` (single device) stage by stage, each stage timed, with
    the relative residual printed every iteration (the reference CG
    solver's doPrintStats path).

    The loop is `solver.cg.solve_pcg_fused` on the operators of
    `mgpcg.solve_stages`, in its order and with its device-scalar
    arithmetic, so x equals `mgpcg.solve`'s bit for bit on the same
    device, config and inputs.  The stage keys are the JAX package's:

      * "matvec": the fused CG step, one launch that forms p = z + beta p,
        A p and <p, A p> (one call per iteration);
      * "preconditioner": the V-cycle, which emits rho = <r, z> from its
        fine upstroke (or the inverse diagonal);
      * "dot": what is computed apart: alpha and beta, and rho where the
        preconditioner does not emit it (null-space projection, no V-cycle);
      * "axpy": the tail, x += alpha p and r -= alpha A p;
      * "norm(b)", "initial residual", "norm(r)".

    Returns (solution, stage_times).
    """
    if config is None:
        config = SolverConfig()
    dtype = config.solve_dtype
    solvable = problem.fine.solvable
    stages = mgpcg.solve_stages(problem, config)
    timer = StageTimer()
    sync = timer.sync

    def project(v):
        return blas.project_null_space(v, solvable) if config.project_null_space else v

    fused_rho = stages.preconditioner_dot is not None and not config.project_null_space

    def precondition(r):
        """(z, rho), as the fused loop forms them: rho = <r, z> before z's
        projection, timed under "dot" where computed apart."""
        with timer.stage("preconditioner"):
            if fused_rho:
                z, rho = sync(stages.preconditioner_dot(r))
            else:
                z = sync(stages.preconditioner(r))
        if not fused_rho:
            with timer.stage("dot"):
                rho = blas.dot(r, z, solvable)
                z = sync(project(z))
        return z, rho.reshape(()).to(dtype)

    with timer.stage("norm(b)"):
        b = project(rhs.to(dtype))
        loop = cg_mod._Loop(b, solvable, config.tolerance, config.max_iterations, False)
        loop.fetch()
    if loop.zero_rhs:
        if print_stats:
            printer("zero RHS: returning zero solution")
        return torch.zeros_like(b), timer.times

    with timer.stage("initial residual"):
        if x0 is None:
            x = torch.zeros_like(b)
            r = sync(project(torch.where(solvable, b, torch.zeros_like(b))))
        else:
            x = x0.to(dtype).clone()
            r = sync(project(stages.residual(x, b)))
    z, rho = precondition(r)
    with timer.stage("norm(r)"):
        rr_h = blas.squared_l2_norm(r, solvable).item()
    p, beta = z, torch.zeros_like(rho)

    iteration = 0
    while loop.running(rr_h, iteration):
        with timer.stage("matvec"):
            p, ap, pap = sync(stages.step_p(z, p, beta))
        with timer.stage("dot"):
            pap = pap.reshape(()).to(dtype)
            alpha = sync(rho / torch.where(pap == 0, torch.ones_like(pap), pap))
        with timer.stage("axpy"):
            x = x + alpha * p
            r = sync(project(torch.where(solvable, r - alpha * ap, r)))
        with timer.stage("norm(r)"):
            rr_h = blas.squared_l2_norm(r, solvable).item()
        z, rho_new = precondition(r)
        with timer.stage("dot"):
            beta = sync(rho_new / torch.where(rho == 0, torch.ones_like(rho), rho))
        rho = rho_new
        iteration += 1
        if print_stats:
            printer(f"iteration: {iteration}, residual: {(rr_h / loop.b_norm2_h) ** 0.5:.10f}")

    if print_stats:
        printer(
            f"iterations: {iteration}, relative residual: "
            f"{(rr_h / loop.b_norm2_h) ** 0.5:.10e}"
        )
        printer(timer.times.report())
    return x, timer.times


def vcycle_stage_times(
    hier: mg_mod.MGHierarchy,
    b: torch.Tensor,
    config: SolverConfig | None = None,
    warmup: int = 1,
    reps: int = 3,
) -> StageTimes:
    """Per-stage times of one V-cycle, per level: the data flow of
    `mg.v_cycle` from x = 0 replayed `warmup + reps` times, the last `reps`
    kept, each stage ending on a device sync.

    The smoothing blocks are `fused_smoother.smooth_level` with the level's
    `mg.hierarchy_block_lists` entry (the chunk kernel on the card), or the
    plain Chebyshev block where `mg.level_flags` says "plain".  The
    downstroke's residual is formed apart -- `fused_cg.residual` over the
    level's tiles, then the restriction -- where production fuses it
    into the downstroke's last chunk, so "smooth (down)" and "residual+
    restrict" can be read apart.  The transfers are the form the cycle
    runs (`mg.use_mm_transfers`), where the JAX package's profiler times
    the slice form whatever its cycle runs; the stage names are JAX's.
    """
    if config is None:
        config = SolverConfig()
    nlev = hier.num_levels
    dtype = hier.levels[0].diag.dtype
    flags = mg_mod.level_flags(hier, config)
    vdt = mg_mod.level_field_dtypes(hier, config, flags)
    blocks = mg_mod.hierarchy_block_lists(hier, config)
    transfers = transfer.form(mg_mod.use_mm_transfers(config, b.device))

    def smooth(level, x, rhs, forward):
        c = hier.levels[level]
        if flags[level] == "plain":
            return mg_mod.chebyshev_block(x, rhs, c, config, x_is_zero=x is None)
        return fused_smoother.smooth_level(
            x, rhs, c, config, forward, x_is_zero=x is None, blocks=blocks[level]
        )

    def residual(level, x, rhs):
        c = hier.levels[level]
        if flags[level] == "plain":
            return stencil.residual(x, rhs, c)
        return fused_cg.residual(
            x.to(dtype), rhs.to(dtype), c.diag, c.ew0, c.ew1, c.ew2,
            mode=config.kernel_mode, tiles=blocks[level].tiles,
        )

    times = StageTimes()
    for rep in range(warmup + reps):
        timer = StageTimer()
        sync = timer.sync
        rhs = [b.to(vdt[0])] + [None] * (nlev - 1)
        sols = [None] * nlev
        for level in range(nlev - 1):
            with timer.stage(f"L{level} smooth (down)"):
                sols[level] = sync(smooth(level, None, rhs[level], True))
            with timer.stage(f"L{level} residual+restrict"):
                r = residual(level, sols[level], rhs[level])
                rhs[level + 1] = sync(
                    transfers.restrict(r, hier.levels[level + 1].solvable).to(vdt[level + 1])
                )
        with timer.stage(f"L{nlev - 1} coarse direct solve"):
            sols[nlev - 1] = sync(mg_mod.coarse_solve(hier, rhs[nlev - 1]))
        for level in range(nlev - 2, -1, -1):
            c = hier.levels[level]
            with timer.stage(f"L{level} prolong"):
                x = sync(transfers.prolong_add(sols[level], sols[level + 1].to(vdt[level]), c.solvable))
            with timer.stage(f"L{level} smooth (up)"):
                sols[level] = sync(smooth(level, x, rhs[level], False))
        if rep >= warmup:
            for name, s in timer.times.seconds.items():
                times.add(name, s)
    return times
