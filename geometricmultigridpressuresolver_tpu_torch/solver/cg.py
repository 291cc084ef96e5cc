"""Matrix-free preconditioned conjugate gradient on torch tensors.

Port of ``solver/cg.py``: textbook PCG over grid "vectors" with injected
operators, convergence test ||r||^2 <= tol^2 ||b||^2, zero-RHS early-out
and optional null-space projection.

The loop runs on the host and tests convergence once per iteration with a
single `.item()` on ||r||^2 -- one device sync per iteration, which keeps
iteration counts exactly comparable with the reference.  An optional
`interrupt_check(iteration) -> bool` (the reference's UT_Interrupt) runs on
the host right after that sync, so it costs no extra one: True stops the
solve after that iteration with the current iterate and `converged` False
(unless that iteration converged).  Every other scalar
(alpha, beta, rho) stays a 0-d device tensor; the fused CG step reads beta
by pointer.  Capturing the loop in a CUDA graph would remove the sync and
the launch gaps; that is later work.

Across ranks (`solve_pcg_fused(ranks=)`, a `parallel.distributed.Ranks`)
the vectors are a rank's blocks and every dot and norm is summed over the
ranks in rank order, so ||r||^2 -- and with it the exit test -- is the
same bits on every rank, and `interrupt_check` runs on rank 0 and its
answer is broadcast: every rank leaves the loop after the same iteration,
as the next collective requires.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from geometricmultigridpressuresolver_tpu_torch.ops import blas


class CGResult(NamedTuple):
    x: torch.Tensor
    iterations: int
    relative_residual: float     # ||r|| / ||b|| at exit (recurrence residual)
    converged: bool
    # Opt-in (record_residuals): (max_iterations + 1,) relative residual of
    # every iteration, NaN past the exit iteration; None otherwise.
    residual_history: torch.Tensor | None = None


class _Loop:
    """Threshold, history and exit bookkeeping shared by both solvers."""

    def __init__(self, b, solvable, tolerance, max_iterations, record, ranks=None):
        dtype, device = b.dtype, b.device
        self.ranks = ranks
        self.b_norm2 = blas.squared_l2_norm(b, solvable, ranks)
        threshold = torch.tensor(tolerance, dtype=dtype, device=device) ** 2 * self.b_norm2
        self.b_norm2_h, self.threshold_h = torch.stack((self.b_norm2, threshold)).tolist()
        self.max_iterations = max_iterations
        self.interrupted = False
        self.history = None
        if record:
            self.history = torch.full(
                (max_iterations + 1,), float("nan"), dtype=dtype, device=device
            )

    @property
    def zero_rhs(self) -> bool:
        return self.b_norm2_h == 0

    def record(self, iteration: int, rr: torch.Tensor) -> None:
        if self.history is not None:
            self.history[iteration] = rr

    def check_interrupt(self, interrupt_check, iteration: int) -> None:
        """Across ranks every rank passes a check or none does; rank 0's
        answer is every rank's."""
        if interrupt_check is None:
            return
        if self.ranks is None:
            self.interrupted = bool(interrupt_check(iteration))
        else:
            mine = self.ranks.mesh.rank == 0 and bool(interrupt_check(iteration))
            self.interrupted = self.ranks.broadcast(mine)

    def running(self, rr_h: float, iteration: int) -> bool:
        return rr_h > self.threshold_h and iteration < self.max_iterations

    def result(self, x, rr, rr_h: float, iteration: int) -> CGResult:
        hist = None
        if self.history is not None:
            safe = self.b_norm2 if self.b_norm2_h != 0 else torch.ones_like(self.b_norm2)
            hist = torch.sqrt(self.history / safe)
        if self.zero_rhs:
            if hist is not None:
                hist[0] = 0.0
            return CGResult(torch.zeros_like(x), 0, 0.0, True, hist)
        rel = float(torch.sqrt(rr / self.b_norm2).item())
        return CGResult(x, iteration, rel, rr_h <= self.threshold_h, hist)


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
    """Textbook PCG solve of A x = b over the solvable set."""

    def project(v):
        return blas.project_null_space(v, solvable) if project_null_space else v

    b = project(b)
    loop = _Loop(b, solvable, tolerance, max_iterations, record_residuals)
    x = torch.zeros_like(b) if x0 is None else x0.to(b.dtype).clone()
    if loop.zero_rhs:
        return loop.result(x, None, 0.0, 0)
    r = project(torch.where(solvable, b - apply_a(x), torch.zeros_like(b)))
    z = project(apply_preconditioner(r))
    rho = blas.dot(r, z, solvable)
    rr = blas.squared_l2_norm(r, solvable)
    p = z
    loop.record(0, rr)
    it, rr_h = 0, rr.item()
    while loop.running(rr_h, it) and not loop.interrupted:
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
        loop.check_interrupt(interrupt_check, it)
    return loop.result(x, rr, rr_h, it)


def solve_pcg_fused(
    step_p: Callable[[torch.Tensor, torch.Tensor, torch.Tensor], tuple],
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
) -> CGResult:
    """PCG with a fused search-direction / mat-vec / dot step.

    `step_p(z, p, beta) -> (p_new, A p_new, <p_new, A p_new>)` replaces the
    three separate passes of the textbook body; the carry is rotated so the
    search-direction update opens the body, which leaves the iterates
    algebraically identical to `solve_pcg`.  `residual(x, b)` returns the
    masked b - A x (used for a warm start only).  `preconditioner_dot(r) ->
    (z, <r, z>)` optionally fuses the rho reduction into the preconditioner
    (ignored under null-space projection, which projects z first).  With
    `ranks` the vectors are a rank's blocks, and `step_p` and
    `preconditioner_dot` return dots already summed over the ranks.
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
    if loop.zero_rhs:
        return loop.result(x, None, 0.0, 0)
    z, rho = preconditioner_dot(r)
    z = project(z)
    rho = rho.reshape(()).to(dtype)
    rr = blas.squared_l2_norm(r, solvable, ranks)
    p, beta = z, torch.zeros_like(rho)
    loop.record(0, rr)
    it, rr_h = 0, rr.item()
    while loop.running(rr_h, it) and not loop.interrupted:
        p, ap, pap = step_p(z, p, beta)
        pap = pap.reshape(()).to(dtype)
        alpha = rho / torch.where(pap == 0, torch.ones_like(pap), pap)
        x = x + alpha * p
        r = project(torch.where(solvable, r - alpha * ap, r))
        rr = blas.squared_l2_norm(r, solvable, ranks)
        z, rho_new = preconditioner_dot(r)
        z = project(z)
        rho_new = rho_new.reshape(()).to(dtype)
        beta = rho_new / torch.where(rho == 0, torch.ones_like(rho), rho)
        rho = rho_new
        it += 1
        loop.record(it, rr)
        rr_h = rr.item()
        loop.check_interrupt(interrupt_check, it)
    return loop.result(x, rr, rr_h, it)


def recomputed_residual_norms(residual, x, b, solvable, ranks=None):
    """Recomputed (not recurrence-drifted) ||b - A x|| diagnostics:
    (relative l2, l-infinity) as 0-d tensors.  `residual(x, b)` returns
    the masked b - A x; with `ranks`, of a rank's blocks, over all ranks."""
    r = residual(x, b)
    b_norm = blas.l2_norm(b, solvable, ranks)
    safe = torch.where(b_norm == 0, torch.ones_like(b_norm), b_norm)
    return blas.l2_norm(r, solvable, ranks) / safe, blas.inf_norm(r, solvable, ranks)
