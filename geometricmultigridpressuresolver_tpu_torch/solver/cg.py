"""Matrix-free preconditioned conjugate gradient on torch tensors.

Port of ``solver/cg.py``: textbook PCG over grid "vectors" with injected
operators, convergence test ||r||^2 <= tol^2 ||b||^2, zero-RHS early-out
and optional null-space projection.

`solve_pcg_fused` keeps its loop state on the device, as the JAX package's
`_FState` under `lax.while_loop` (solver/cg.py:238-276 there): x, r, z, p,
rho, beta, rr, the iteration count (a 0-d int32), the interrupt flag, the
residual history (written at the device index it, as JAX's
``.at[it + 1].set(rr)``) and JAX's `cond` as a device predicate,
``running = (rr > threshold) & (it < max_iterations) & ~interrupted``.
One iteration is `FusedCG.head` (the CG step, x, r, ||r||^2, the count,
the history and `running`) then `FusedCG.tail` (the V-cycle: z, rho,
beta).  The loop runs the first head, then tail + head while `running`,
then the last tail, whose z nothing reads: the same launches in the same
order as one body per iteration, with z made and consumed inside one
tail + head, so no grid but the iterates outlives it.  x and r are updated
in place and p' goes to a buffer the caller names, so a captured tail +
head reads and writes fixed addresses.

How the loop is driven is the caller's choice (`run_loop`).  `run_eager`
runs the body eagerly and reads `running` on the host after each
iteration (one sync per iteration): the CPU, and the ranks of a
`parallel.distributed.Ranks`.  `solver.graph.run` replays tail + head as
a captured CUDA graph whose exit test runs on the device, with one host
read per K iterations.  An optional `interrupt_check(iteration) -> bool`
(the reference's UT_Interrupt, JAX's ordered `io_callback`) runs on the
host after every iteration; True stops the solve after that iteration
with the current iterate and `converged` False (unless that iteration
converged).  Every scalar (alpha, beta, rho) stays a 0-d device tensor;
the fused CG step reads beta by pointer.

A captured frame (`solver.graph.FrameGraph`, the fused frame loop of
`models.simulate.run_fused`) takes a third path, `solve_pcg_fused(
device_loop=)`, which reads nothing on the host: the zero-RHS and
"converged at iteration 0" early returns become device predicates
(`running` dropped before the loop, the result picked with `torch.where`),
and `CGResult`'s scalars stay 0-d device tensors -- the JAX package's
whole solve under `while_loop`.

Across ranks (`solve_pcg_fused(ranks=)`) the vectors are a rank's blocks
and every dot and norm is summed over the ranks in rank order, so
||r||^2 -- and with it the exit test -- is the same bits on every rank,
and `interrupt_check` runs on rank 0 and its answer is broadcast: every
rank leaves the loop after the same iteration, as the next collective
requires.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import torch

from geometricmultigridpressuresolver_tpu_torch.ops import blas


class CGResult(NamedTuple):
    """A solve's result.  On the device-only path (`solve_pcg_fused(
    device_loop=)`) `iterations`, `relative_residual` and `converged` are
    0-d device tensors (int32, the solve dtype, bool), read by nothing."""

    x: torch.Tensor
    iterations: int
    relative_residual: float     # ||r|| / ||b|| at exit (recurrence residual)
    converged: bool
    # Opt-in (record_residuals): (max_iterations + 1,) relative residual of
    # every iteration, NaN past the exit iteration; None otherwise.
    residual_history: torch.Tensor | None = None


def host(*tensors: torch.Tensor) -> list[float]:
    """The values of 0-d tensors on one device, read in one transfer (a
    single host sync on the card)."""
    return torch.stack([t.reshape(()).to(torch.float64) for t in tensors]).tolist()


class _Loop:
    """Threshold, history and exit bookkeeping shared by the solvers.

    `fetch(*scalars)` reads ||b||^2 and the threshold with the caller's
    own scalars in one host read; `zero_rhs`, `running` and `result` need
    it first."""

    def __init__(self, b, solvable, tolerance, max_iterations, record, ranks=None):
        dtype, device = b.dtype, b.device
        self.ranks = ranks
        self.b_norm2 = blas.squared_l2_norm(b, solvable, ranks)
        # A fill, not a copy from the host (which would sync).
        self.threshold = torch.full((), tolerance, dtype=dtype, device=device) ** 2 * self.b_norm2
        self.max_iterations = max_iterations
        self.b_norm2_h = self.threshold_h = None
        self.history = None
        if record:
            self.history = torch.full(
                (max_iterations + 1,), float("nan"), dtype=dtype, device=device
            )

    def fetch(self, *scalars: torch.Tensor) -> list[float]:
        self.b_norm2_h, self.threshold_h, *out = host(self.b_norm2, self.threshold, *scalars)
        return out

    @property
    def zero_rhs(self) -> bool:
        return self.b_norm2_h == 0

    def relative(self, rr: torch.Tensor) -> torch.Tensor:
        """||r|| / ||b|| on the device (1 stands in for a zero ||b||^2)."""
        safe = torch.where(self.b_norm2 == 0, torch.ones_like(self.b_norm2), self.b_norm2)
        return torch.sqrt(rr / safe)

    def record(self, iteration: int, rr: torch.Tensor) -> None:
        if self.history is not None:
            self.history[iteration] = rr

    def check_interrupt(self, interrupt_check, iteration: int) -> bool:
        """Whether `interrupt_check` stops the loop after `iteration`.
        Across ranks every rank passes a check or none does; rank 0's
        answer is every rank's."""
        if interrupt_check is None:
            return False
        if self.ranks is None:
            return bool(interrupt_check(iteration))
        mine = self.ranks.mesh.rank == 0 and bool(interrupt_check(iteration))
        return self.ranks.broadcast(mine)

    def running(self, rr_h: float, iteration: int) -> bool:
        return rr_h > self.threshold_h and iteration < self.max_iterations

    def device_result(self, x, zero_rhs, it, rr) -> CGResult:
        """`result` with no host read: `zero_rhs`, the iteration count `it`
        and the exit's ||r||^2 `rr` are device tensors, and so are the
        result's scalars."""
        x = torch.where(zero_rhs, torch.zeros_like(x), x)
        rel = torch.where(zero_rhs, torch.zeros_like(rr), self.relative(rr))
        converged = zero_rhs | (rr <= self.threshold)
        hist = None
        if self.history is not None:
            safe = torch.where(self.b_norm2 == 0, torch.ones_like(self.b_norm2), self.b_norm2)
            hist = torch.sqrt(self.history / safe)
            steps = torch.arange(hist.numel(), device=hist.device)
            hist = torch.where(steps <= it, hist, float("nan"))  # nothing past the exit
            hist = torch.where((steps == 0) & zero_rhs, 0.0, hist)
        return CGResult(x, it, rel, converged, hist)

    def result(self, x, iteration: int, rr_h: float, rel_h: float) -> CGResult:
        hist = None
        if self.history is not None:
            safe = self.b_norm2 if self.b_norm2_h != 0 else torch.ones_like(self.b_norm2)
            hist = torch.sqrt(self.history / safe)
        if self.zero_rhs:
            if hist is not None:
                hist[0] = 0.0
            return CGResult(torch.zeros_like(x), 0, 0.0, True, hist)
        return CGResult(x, iteration, rel_h, rr_h <= self.threshold_h, hist)


def solve_pcg(
    apply_a: Callable[[torch.Tensor], torch.Tensor],
    apply_preconditioner: Callable[[torch.Tensor], torch.Tensor],
    b: torch.Tensor,
    solvable: torch.Tensor,
    x0: torch.Tensor | None = None,
    tolerance: float = 1e-5,
    max_iterations: int = 2500,
    project_null_space: bool = False,
    record_residuals: bool = False,
    interrupt_check: Callable[[int], bool] | None = None,
) -> CGResult:
    """Textbook PCG solve of A x = b over the solvable set (a host loop,
    one sync per iteration)."""

    def project(v):
        return blas.project_null_space(v, solvable) if project_null_space else v

    b = project(b)
    loop = _Loop(b, solvable, tolerance, max_iterations, record_residuals)
    loop.fetch()
    x = torch.zeros_like(b) if x0 is None else x0.to(b.dtype).clone()
    if loop.zero_rhs:
        return loop.result(x, 0, 0.0, 0.0)
    r = project(torch.where(solvable, b - apply_a(x), torch.zeros_like(b)))
    z = project(apply_preconditioner(r))
    rho = blas.dot(r, z, solvable)
    rr = blas.squared_l2_norm(r, solvable)
    p = z
    loop.record(0, rr)
    it, rr_h = 0, rr.item()
    interrupted = False
    while loop.running(rr_h, it) and not interrupted:
        ap = apply_a(p)
        denom = blas.dot(p, ap, solvable)
        alpha = rho / torch.where(denom == 0, torch.ones_like(denom), denom)
        x = x + alpha * p
        r = project(r - alpha * ap)
        z = project(apply_preconditioner(r))
        rho_new = blas.dot(r, z, solvable)
        beta = rho_new / torch.where(rho == 0, torch.ones_like(rho), rho)
        p = z + beta * p
        rho = rho_new
        rr = blas.squared_l2_norm(r, solvable)
        it += 1
        loop.record(it, rr)
        rr_h = rr.item()
        interrupted = loop.check_interrupt(interrupt_check, it)
    return loop.result(x, it, rr_h, loop.relative(rr).item())


@dataclasses.dataclass
class FusedState:
    """The loop state of `solve_pcg_fused` (JAX's `_FState`).  x, r, p and
    the scalars are the loop's own tensors, updated in place (p by the
    step's `p_out`); z is rebound by every tail.  `it` is a 0-d int32,
    `interrupted` and `running` 0-d bools, `history` the (max_iterations
    + 1,) squared norms or None."""

    x: torch.Tensor
    r: torch.Tensor
    z: torch.Tensor | None
    p: torch.Tensor
    rho: torch.Tensor
    beta: torch.Tensor
    rr: torch.Tensor
    it: torch.Tensor
    interrupted: torch.Tensor
    running: torch.Tensor
    history: torch.Tensor | None


class FusedCG:
    """The body of `solve_pcg_fused`: `head` and `tail` of one iteration
    over a `FusedState` (see the module docstring)."""

    def __init__(self, step_p, preconditioner_dot, solvable, project_null_space, loop: _Loop, dtype):
        self.step_p = step_p
        self.preconditioner_dot = preconditioner_dot
        self.solvable = solvable
        self.project_null_space = project_null_space
        self.loop = loop
        self.dtype = dtype

    def project(self, v):
        if not self.project_null_space:
            return v
        return blas.project_null_space(v, self.solvable, self.loop.ranks)

    def head(self, s: FusedState, p_out: torch.Tensor | None = None) -> None:
        """The CG step into `p_out` (a new tensor when None), x and r in
        place, ||r||^2, the count, the history and `running`."""
        solvable, ranks = self.solvable, self.loop.ranks
        p, ap, pap = self.step_p(s.z, s.p, s.beta, p_out)
        pap = pap.reshape(()).to(self.dtype)
        alpha = s.rho / torch.where(pap == 0, torch.ones_like(pap), pap)
        s.x.add_(alpha * p)
        torch.where(solvable, s.r - alpha * ap, s.r, out=s.r)
        if self.project_null_space:
            torch.where(solvable, s.r - blas.masked_mean(s.r, solvable, ranks), s.r, out=s.r)
        s.p = p
        s.rr.copy_(blas.squared_l2_norm(s.r, solvable, ranks))
        s.it.add_(1)
        if s.history is not None:
            s.history.index_copy_(0, s.it.reshape(1).long(), s.rr.reshape(1))
        torch.logical_and(s.rr > self.loop.threshold, s.it < self.loop.max_iterations, out=s.running)
        s.running.logical_and_(~s.interrupted)

    def tail(self, s: FusedState) -> None:
        """The preconditioner on r: z, rho and beta."""
        z, rho_new = self.preconditioner_dot(s.r)
        s.z = self.project(z)
        rho_new = rho_new.reshape(()).to(self.dtype)
        s.beta.copy_(rho_new / torch.where(s.rho == 0, torch.ones_like(s.rho), s.rho))
        s.rho.copy_(rho_new)

    def status(self, s: FusedState) -> tuple[int, bool, float, float]:
        """(iterations, running, ||r||^2, ||r|| / ||b||) in one host read."""
        it, running, rr, rel = host(s.it, s.running, s.rr, self.loop.relative(s.rr))
        return int(it), bool(running), rr, rel

    def interrupted(self, s: FusedState, interrupt_check, iteration: int) -> bool:
        """Run `interrupt_check` after `iteration`; on True, raise the
        device flag (and drop `running`) and return True."""
        if not self.loop.check_interrupt(interrupt_check, iteration):
            return False
        s.interrupted.fill_(True)
        s.running.fill_(False)
        return True


def run_eager(cg: FusedCG, s: FusedState, interrupt_check=None) -> tuple[int, float, float]:
    """The loop after the first head, eagerly, `running` read on the host
    after each iteration; returns (iterations, ||r||^2, ||r|| / ||b||)."""
    while True:
        it, running, rr, rel = cg.status(s)
        if cg.interrupted(s, interrupt_check, it) or not running:
            return it, rr, rel
        cg.tail(s)
        cg.head(s)


def solve_pcg_fused(
    step_p: Callable,
    residual: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    apply_preconditioner: Callable[[torch.Tensor], torch.Tensor],
    b: torch.Tensor,
    solvable: torch.Tensor,
    x0: torch.Tensor | None = None,
    tolerance: float = 1e-5,
    max_iterations: int = 2500,
    project_null_space: bool = False,
    preconditioner_dot: Callable[[torch.Tensor], tuple] | None = None,
    record_residuals: bool = False,
    interrupt_check: Callable[[int], bool] | None = None,
    ranks=None,
    run_loop: Callable | None = None,
    device_loop: Callable | None = None,
) -> CGResult:
    """PCG with a fused search-direction / mat-vec / dot step.

    `step_p(z, p, beta, p_out) -> (p_new, A p_new, <p_new, A p_new>)`
    replaces the three separate passes of the textbook body, writing p_new
    into `p_out` (a new tensor when None); the carry is rotated so the
    search-direction update opens the body, which leaves the iterates
    algebraically identical to `solve_pcg`.  `residual(x, b)` returns the
    masked b - A x (used for a warm start only).  `preconditioner_dot(r) ->
    (z, <r, z>)` optionally fuses the rho reduction into the preconditioner
    (ignored under null-space projection, which projects z first).  With
    `ranks` the vectors are a rank's blocks, and `step_p` and
    `preconditioner_dot` return dots already summed over the ranks.
    `run_loop(cg, state, interrupt_check) -> (iterations, rr, rel)` drives
    the loop after its first iteration (`run_eager` when None, or
    `solver.graph.run`).

    Host reads: one for ||b||^2, the threshold and the first ||r||^2, then
    what `run_loop` makes (one per iteration eagerly).

    `device_loop(cg, state)` instead takes the path that reads nothing on
    the host (the JAX package's whole solve under `while_loop`, the CG
    loop of a captured frame, `solver.graph.FrameGraph`): the first
    iteration runs whatever the state, `running` is dropped where the loop
    would not have started (a zero right-hand side, or the tolerance met
    at iteration 0), `device_loop` runs the loop while `running` holds,
    and the result is picked on the device (`_Loop.device_result`).  No
    `interrupt_check` on this path.
    """
    if project_null_space:
        preconditioner_dot = None
    if preconditioner_dot is None:
        def preconditioner_dot(r):
            z = apply_preconditioner(r)
            return z, blas.dot(r, z, solvable, ranks)
    dtype = b.dtype

    def project(v):
        return blas.project_null_space(v, solvable, ranks) if project_null_space else v

    b = project(b)
    loop = _Loop(b, solvable, tolerance, max_iterations, record_residuals, ranks)
    if x0 is None:
        x = torch.zeros_like(b)
        r = project(torch.where(solvable, b, torch.zeros_like(b)))  # b - A 0
    else:
        x = x0.to(dtype).clone()
        r = project(residual(x, b))
    rr = blas.squared_l2_norm(r, solvable, ranks)
    if device_loop is not None:
        if interrupt_check is not None:
            raise ValueError("the device-only loop takes no interrupt_check")
        cg = FusedCG(step_p, preconditioner_dot, solvable, project_null_space, loop, dtype)
        return _solve_on_device(cg, x, r, rr, device_loop)
    rr_h, rel_h = loop.fetch(rr, loop.relative(rr))
    if loop.zero_rhs:
        return loop.result(x, 0, 0.0, 0.0)
    cg = FusedCG(step_p, preconditioner_dot, solvable, project_null_space, loop, dtype)
    z, rho = preconditioner_dot(r)
    z = cg.project(z)
    rho = rho.reshape(()).to(dtype).clone()
    loop.record(0, rr)
    it0 = torch.zeros((), dtype=torch.int32, device=b.device)
    stop = torch.zeros((), dtype=torch.bool, device=b.device)
    s = FusedState(x, r, z, z, rho, torch.zeros_like(rho), rr, it0, stop, stop.clone(), loop.history)
    if not loop.running(rr_h, 0):
        return loop.result(x, 0, rr_h, rel_h)
    cg.head(s)
    it, rr_h, rel_h = (run_loop or run_eager)(cg, s, interrupt_check)
    cg.tail(s)  # the last iteration's preconditioner, as each iteration runs one
    return loop.result(s.x, it, rr_h, rel_h)


def _solve_on_device(cg: FusedCG, x, r, rr, device_loop) -> CGResult:
    """`solve_pcg_fused` from its initial residual on, with no host read
    (see its docstring)."""
    loop, dev = cg.loop, x.device
    zero_rhs = loop.b_norm2 == 0
    started = (rr > loop.threshold) & ~zero_rhs
    if loop.max_iterations <= 0:
        started = started & False
    x_start, rr_start = x.clone(), rr.clone()
    z, rho = cg.preconditioner_dot(r)
    z = cg.project(z)
    rho = rho.reshape(()).to(cg.dtype).clone()
    loop.record(0, rr)
    it0 = torch.zeros((), dtype=torch.int32, device=dev)
    stop = torch.zeros((), dtype=torch.bool, device=dev)
    s = FusedState(x, r, z, z, rho, torch.zeros_like(rho), rr, it0, stop, stop.clone(), loop.history)
    cg.head(s)
    s.running.logical_and_(started)
    device_loop(cg, s)
    cg.tail(s)  # the last iteration's preconditioner, as each iteration runs one
    it = torch.where(started, s.it, torch.zeros_like(s.it))
    return loop.device_result(
        torch.where(started, s.x, x_start), zero_rhs, it, torch.where(started, s.rr, rr_start)
    )


def recomputed_residual_norms(residual, x, b, solvable, ranks=None):
    """Recomputed (not recurrence-drifted) ||b - A x|| diagnostics:
    (relative l2, l-infinity) as 0-d tensors.  `residual(x, b)` returns
    the masked b - A x; with `ranks`, of a rank's blocks, over all ranks."""
    r = residual(x, b)
    b_norm = blas.l2_norm(b, solvable, ranks)
    safe = torch.where(b_norm == 0, torch.ones_like(b_norm), b_norm)
    return blas.l2_norm(r, solvable, ranks) / safe, blas.inf_norm(r, solvable, ranks)
