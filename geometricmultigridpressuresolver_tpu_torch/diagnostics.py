"""Diagnostic suite: the reference's test node as a library and a CLI.

Port of ``diagnostics.py``, the counterpart of the reference's
`HDK_TestGeometricMultigrid`: two synthetic domain generators, a
delta-spike right-hand side and four test blocks selected by toggles.  The
fixtures are numpy (bit-equal to the JAX package's); the blocks run on
`device` (default: the card, raising without one) and return the same
dicts as the JAX package's.  Every timing ends on a device sync.

On the card the blocks run the port's kernels where production does: the
chunk kernel in every smoothing block, the CG step and the residual kernel
in the solve (`kernel_mode="torch"` runs their plain versions instead).
The smoother block times its boundary and interior phases on the plain
stencil ops, as the JAX package does, so the phases can be read apart.

Run: ``gmg-torch-diagnostics --help`` (``python -m
geometricmultigridpressuresolver_tpu_torch.diagnostics``); ``--device cpu``
runs on the CPU.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from geometricmultigridpressuresolver_tpu_torch import device as device_mod
from geometricmultigridpressuresolver_tpu_torch.config import SolverConfig
from geometricmultigridpressuresolver_tpu_torch.grids import CellLabel, face_shape
from geometricmultigridpressuresolver_tpu_torch.models import assembled
from geometricmultigridpressuresolver_tpu_torch.ops import blas, domain, fused_smoother, stencil, transfer
from geometricmultigridpressuresolver_tpu_torch.solver import cg as cg_mod
from geometricmultigridpressuresolver_tpu_torch.solver import mg as mg_mod
from geometricmultigridpressuresolver_tpu_torch.solver import mgpcg

EXT, DIR, INT = int(CellLabel.EXTERIOR), int(CellLabel.DIRICHLET), int(CellLabel.INTERIOR)


# ---------------------------------------------------------------------------
# Domain fixtures (numpy, as in the JAX package)
# ---------------------------------------------------------------------------


def build_simple_domain(grid_size: int, dirichlet_band: int = 1) -> np.ndarray:
    """Cube of INTERIOR wrapped in a `dirichlet_band`-cell Dirichlet shell
    (the reference's buildSimpleDomain)."""
    labels = np.full((grid_size,) * 3, DIR, dtype=np.int8)
    b = dirichlet_band
    labels[b:-b, b:-b, b:-b] = INT
    return labels


def build_complex_domain(
    grid_size: int,
    use_solid_sphere: bool = False,
    sphere_radius: float = 0.125,
    theta_clamp: float = 0.01,
    weight_clamp: float = 0.01,
    samples: int = 3,
) -> tuple[np.ndarray, list[np.ndarray]]:
    """The reference's buildComplexDomain: cells with
    ``phi(x,y,z) = x - .5 + .25*sin(2*pi*y + 4*pi*z) <= 0`` are fluid
    (INTERIOR), the rest Dirichlet; an optional solid sphere (center .5^3,
    radius .125) whose cut-cell face weights are supersampled, small
    weights clamped to 0; domain-edge faces zeroed; INTERIOR-DIRICHLET
    face weights divided by the clamped ghost-fluid theta of the surface.

    Returns (labels, face_weights) on the base grid.
    """
    n = grid_size
    shape = (n, n, n)
    dx = 1.0 / n

    def surface_phi(x, y, z):
        return x - 0.5 + 0.25 * np.sin(2.0 * np.pi * y + 4.0 * np.pi * z)

    centers = [(np.arange(n) + 0.5) * dx] * 3
    cx, cy, cz = np.meshgrid(*centers, indexing="ij")
    phi = surface_phi(cx, cy, cz)

    def solid_phi(x, y, z):
        # Negative inside the sphere: a face's weight is the fraction of it
        # outside the solid.
        return np.sqrt((x - 0.5) ** 2 + (y - 0.5) ** 2 + (z - 0.5) ** 2) - sphere_radius

    labels = np.where(phi <= 0, INT, DIR).astype(np.int8)
    if use_solid_sphere:
        # Cells fully inside the solid are EXTERIOR (no DOF, no Dirichlet).
        inside = solid_phi(cx, cy, cz) <= 0
        labels = np.where(inside & (labels == INT), EXT, labels).astype(np.int8)

    weights = []
    offs = (np.arange(samples) + 0.5) / samples
    for axis in range(3):
        fshape = face_shape(shape, axis)
        w = np.ones(fshape, dtype=np.float64)
        if use_solid_sphere:
            w = np.zeros(fshape, dtype=np.float64)
            tangent = [a for a in range(3) if a != axis]
            base = [np.arange(fshape[a]) * dx for a in range(3)]
            for o1 in offs:
                for o2 in offs:
                    shift = [0.0, 0.0, 0.0]
                    # Faces sit at integer coordinates along `axis` and are
                    # sampled across their tangent plane.
                    shift[tangent[0]] = float(o1) * dx
                    shift[tangent[1]] = float(o2) * dx
                    gx, gy, gz = np.meshgrid(
                        base[0] + shift[0], base[1] + shift[1], base[2] + shift[2], indexing="ij"
                    )
                    w += (solid_phi(gx, gy, gz) > 0).astype(np.float64)
            w /= samples * samples
            w[w < weight_clamp] = 0.0

        # Domain-edge faces are closed.
        edge = [slice(None)] * 3
        edge[axis] = 0
        w[tuple(edge)] = 0.0
        edge[axis] = -1
        w[tuple(edge)] = 0.0

        # Ghost-fluid theta division on INTERIOR-DIRICHLET faces: theta from
        # the surface values at the two cell centers, clamped below.
        lo = [slice(None)] * 3
        hi = [slice(None)] * 3
        lo[axis] = slice(0, -1)
        hi[axis] = slice(1, None)
        la, lb = labels[tuple(lo)], labels[tuple(hi)]
        pa, pb = phi[tuple(lo)], phi[tuple(hi)]
        mixed = ((la == INT) & (lb == DIR)) | ((la == DIR) & (lb == INT))
        inside = np.minimum(pa, pb)
        outside = np.maximum(pa, pb)
        denom = np.where(outside > inside, outside - inside, 1.0)
        theta = np.clip(np.where(mixed, -inside / denom, 1.0), theta_clamp, 1.0)
        interior = [slice(None)] * 3
        interior[axis] = slice(1, -1)
        w[tuple(interior)] = np.where(mixed, w[tuple(interior)] / theta, w[tuple(interior)])
        weights.append(w)

    # A cell every incident face of which is closed cannot carry a DOF.
    open_face = np.zeros(shape, dtype=bool)
    for axis in range(3):
        lo = [slice(None)] * 3
        hi = [slice(None)] * 3
        lo[axis] = slice(0, -1)
        hi[axis] = slice(1, None)
        open_face |= (weights[axis][tuple(lo)] > 0) | (weights[axis][tuple(hi)] > 0)
    labels = np.where((labels == INT) & ~open_face, EXT, labels).astype(np.int8)
    # Zero any face touching an EXTERIOR cell.
    for axis in range(3):
        lo = [slice(None)] * 3
        hi = [slice(None)] * 3
        lo[axis] = slice(0, -1)
        hi[axis] = slice(1, None)
        interior = [slice(None)] * 3
        interior[axis] = slice(1, -1)
        ext_adj = (labels[tuple(lo)] == EXT) | (labels[tuple(hi)] == EXT)
        w = weights[axis]
        w[tuple(interior)] = np.where(ext_adj, 0.0, w[tuple(interior)])
    return labels, weights


def expand(labels, weights=None):
    """The expanded power-of-two domain with BOUNDARY relabeling (and the
    expanded weights), the shared setup step of every test block: (labels,
    weights or None, offset, mg_levels), numpy in and out (computed with
    the port's domain ops on host tensors)."""
    expanded, offset, mg_levels = domain.expand_domain(torch.as_tensor(np.asarray(labels)))
    exp_weights = None
    if weights is not None:
        exp_weights = domain.expand_face_weights(
            [torch.as_tensor(np.asarray(w)) for w in weights], tuple(expanded.shape), offset
        )
    relabeled = domain.set_boundary_labels(expanded, exp_weights)
    if exp_weights is not None:
        exp_weights = [w.numpy() for w in exp_weights]
    return relabeled.numpy(), exp_weights, offset, mg_levels


def delta_spike_rhs(
    shape,
    amplitude: float = 1000.0,
    solvable=None,
    offset=(0, 0, 0),
    base_shape=None,
) -> np.ndarray:
    """3^3 delta spike of `amplitude` at 10% of the BASE grid (the
    reference's RHS fixture); `offset` shifts it into the expanded domain,
    where 10% of the expanded grid could land in the exterior padding."""
    base_shape = base_shape or shape
    rhs = np.zeros(shape, dtype=np.float64)
    c = [max(1, b // 10) + o for b, o in zip(base_shape, offset)]
    rhs[c[0] : c[0] + 3, c[1] : c[1] + 3, c[2] : c[2] + 3] = amplitude
    if solvable is not None:
        rhs[~np.asarray(solvable)] = 0.0
        if not rhs.any():
            raise ValueError("delta spike fell entirely outside the solvable set")
    return rhs


def random_initial_guess(labels, seed: int = 0) -> np.ndarray:
    """Uniform-random initial guess over solvable cells."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1.0, 1.0, size=labels.shape)
    x[np.asarray(labels) < INT] = 0.0
    return x


# ---------------------------------------------------------------------------
# Test blocks
# ---------------------------------------------------------------------------


def _domain(grid_size: int, use_complex_domain: bool, use_solid_sphere: bool):
    if use_complex_domain:
        return build_complex_domain(grid_size, use_solid_sphere)
    return build_simple_domain(grid_size), None


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run_conjugate_gradient_test(
    grid_size: int = 64,
    use_complex_domain: bool = True,
    use_solid_sphere: bool = True,
    use_mg_preconditioner: bool = True,
    use_random_guess: bool = False,
    tolerance: float = 1e-5,
    max_iterations: int = 1000,
    solve_dtype=None,
    dx: float | None = None,
    kernel_mode: str = "auto",
    device=None,
) -> dict:
    """MGPCG (or diagonal PCG) on `device` against the assembled-matrix CG
    oracle on the host, on the same labels (the reference's
    testConjugateGradient, scipy in place of Eigen).

    `dx` exercises the dimensionless-operator convention: the physical RHS
    goes in scaled by dx^2 and the L-inf residual comes out scaled by
    1/dx^2; the relative residual and the agreement do not change.  None
    solves the dimensionless system (dx = 1).

    Returns the iterations, the recomputed relative-L2 and L-inf residuals,
    both solves' seconds, the largest difference from the oracle relative
    to its max, and the DOF count.
    """
    dev = device_mod.resolve(device)
    base, weights = _domain(grid_size, use_complex_domain, use_solid_sphere)
    labels, exp_weights, offset, mg_levels = expand(base, weights)

    config = SolverConfig(
        tolerance=tolerance,
        max_iterations=max_iterations,
        use_mg_preconditioner=use_mg_preconditioner,
        kernel_mode=kernel_mode,
        **({"solve_dtype": solve_dtype} if solve_dtype is not None else {}),
    )
    problem = mgpcg.build_problem(labels, exp_weights, mg_levels, config, device=dev)
    solvable = problem.fine.solvable.cpu().numpy()

    rhs_physical = delta_spike_rhs(labels.shape, solvable=solvable, offset=offset, base_shape=base.shape)
    dx2 = 1.0 if dx is None else float(dx) ** 2
    rhs = rhs_physical * dx2
    x0 = random_initial_guess(labels, seed=3) if use_random_guess else None
    rhs_t = torch.as_tensor(rhs, device=dev)

    _sync(dev)
    t0 = time.perf_counter()
    result = mgpcg.solve(
        problem, rhs_t, x0=None if x0 is None else torch.as_tensor(x0, device=dev), config=config
    )
    _sync(dev)
    grid_time = time.perf_counter() - t0

    rel, linf = (
        float(v)
        for v in cg_mod.recomputed_residual_norms(
            mgpcg.fine_residual(problem, config), result.x, rhs_t.to(result.x.dtype),
            problem.fine.solvable,
        )
    )
    linf /= dx2  # back to physical units; the relative norm cancels the scaling
    grid_x = result.x.double().cpu().numpy()

    t0 = time.perf_counter()
    oracle_x = assembled.solve_assembled(labels, rhs, exp_weights, tol=tolerance, x0_grid=x0)
    oracle_time = time.perf_counter() - t0

    denom = max(float(np.abs(oracle_x[solvable]).max()), 1e-300)
    agreement = float(np.abs((grid_x - oracle_x)[solvable]).max()) / denom
    return {
        "iterations": int(result.iterations),
        "relative_l2": rel,
        "l_infinity": linf,
        "grid_seconds": grid_time,
        "oracle_seconds": oracle_time,
        "max_relative_difference_vs_oracle": agreement,
        "dofs": int(solvable.sum()),
    }


def run_symmetry_test(
    grid_size: int = 32,
    use_complex_domain: bool = True,
    use_solid_sphere: bool = True,
    seed: int = 0,
    kernel_mode: str = "auto",
    device=None,
) -> dict:
    """<M a, b> against <M b, a> for the six operators of the reference's
    testSymmetry, on `device`.  The smoother block is
    `fused_smoother.smooth_level` (the chunk kernel on the card); the GS
    schedule, the transfers and the coarse solve are the plain ops.

    Returns the relative asymmetry per operator (each must be < 1e-10).
    """
    dev = device_mod.resolve(device)
    base, weights = _domain(grid_size, use_complex_domain, use_solid_sphere)
    labels, exp_weights, _, mg_levels = expand(base, weights)

    config_gs = SolverConfig(use_gauss_seidel=True, kernel_mode=kernel_mode)
    config_j = SolverConfig(use_gauss_seidel=False, kernel_mode=kernel_mode)
    hier = mg_mod.build_hierarchy(labels, exp_weights, mg_levels, config_gs, device=dev)
    c0 = hier.levels[0]
    solvable = c0.solvable

    rng = np.random.default_rng(seed)
    zero = torch.zeros((), dtype=torch.float64, device=dev)
    a = torch.where(solvable, torch.as_tensor(rng.standard_normal(labels.shape), device=dev), zero)
    b = torch.where(solvable, torch.as_tensor(rng.standard_normal(labels.shape), device=dev), zero)

    def smoother_block(rhs):
        return fused_smoother.smooth_level(None, rhs, c0, config_j, True, x_is_zero=True)

    def gs_schedule(rhs):
        x = torch.zeros_like(rhs)
        for _ in range(2):
            x = stencil.rb_gauss_seidel(x, rhs, c0, forward=True)
            x = stencil.rb_gauss_seidel(x, rhs, c0, forward=False)
        return x

    def restrict_prolong(rhs):
        down = transfer.restrict(rhs, hier.levels[1].solvable)
        return transfer.prolong_add(torch.zeros_like(rhs), down, solvable)

    def vcycles(config):
        def op(rhs):
            x = mg_mod.v_cycle(hier, None, rhs, config)
            for _ in range(3):
                x = mg_mod.v_cycle(hier, x, rhs, config, use_initial_guess=True)
            return x

        return op

    def coarse_direct(rhs):
        down = rhs
        for level in range(1, hier.num_levels):
            down = transfer.restrict(down, hier.levels[level].solvable)
        up = mg_mod.coarse_solve(hier, down)
        for level in range(hier.num_levels - 2, -1, -1):
            up = transfer.prolong_add(
                torch.zeros(hier.levels[level].shape, dtype=up.dtype, device=dev),
                up,
                hier.levels[level].solvable,
            )
        return up

    ops = {
        "boundary+jacobi+boundary smoother": smoother_block,
        "symmetric GS schedule x4": gs_schedule,
        "restriction o prolongation": restrict_prolong,
        "coarse direct solve (via transfers)": coarse_direct,
        "full V-cycle x4 (Gauss-Seidel)": vcycles(config_gs),
        "full V-cycle x4 (Jacobi)": vcycles(config_j),
    }
    out = {}
    for name, op in ops.items():
        dot_a = float(blas.dot(op(a), b, solvable))
        dot_b = float(blas.dot(op(b), a, solvable))
        out[name] = abs(dot_a - dot_b) / max(abs(dot_a), abs(dot_b), 1e-300)
    return out


def run_one_level_vcycle_test(
    grid_size: int = 64,
    num_cycles: int = 50,
    use_gauss_seidel: bool = True,
    kernel_mode: str = "auto",
    device=None,
) -> dict:
    """Sinusoidal initial error, zero RHS: the error's decay over warm-started
    V-cycles on `device` (the reference's testOneLevelVCycle).  Every cycle
    forms its fine downstroke's residual apart (the residual kernel on the
    card), since its x is not zero.

    Returns the L-inf and L2 error per cycle and the mean per-cycle
    convergence factor.
    """
    dev = device_mod.resolve(device)
    base = build_simple_domain(grid_size)
    labels, _, _, mg_levels = expand(base)
    config = SolverConfig(use_gauss_seidel=use_gauss_seidel, kernel_mode=kernel_mode)
    hier = mg_mod.build_hierarchy(labels, None, mg_levels, config, device=dev)
    solvable = hier.levels[0].solvable
    blocks = mg_mod.hierarchy_block_lists(hier, config)

    n = grid_size
    x, y, z = np.meshgrid(*[(np.arange(s) + 0.5) / n for s in labels.shape], indexing="ij")
    err = (
        np.sin(2 * np.pi * x) * np.sin(2 * np.pi * y) * np.sin(2 * np.pi * z)
        + np.sin(4 * np.pi * x) * np.sin(4 * np.pi * y) * np.sin(4 * np.pi * z)
    )
    xk = torch.where(solvable, torch.as_tensor(err, device=dev), torch.zeros((), dtype=torch.float64, device=dev))
    rhs = torch.zeros_like(xk)

    linf, l2 = [], []
    for _ in range(num_cycles):
        xk = mg_mod.v_cycle(hier, xk, rhs, config, use_initial_guess=True, block_lists=blocks)
        linf.append(float(blas.inf_norm(xk, solvable)))
        l2.append(float(blas.l2_norm(xk, solvable)))
    factors = [l2[i + 1] / l2[i] for i in range(len(l2) - 1) if l2[i] > 0]
    return {
        "l_infinity": linf,
        "l2": l2,
        "mean_convergence_factor": float(np.mean(factors)) if factors else 0.0,
    }


def run_smoother_test(
    grid_size: int = 64,
    max_smoother_iterations: int = 20,
    use_complex_domain: bool = True,
    use_solid_sphere: bool = False,
    use_gauss_seidel: bool = True,
    kernel_mode: str = "auto",
    device=None,
) -> dict:
    """Iterate the smoothing block (3x boundary, interior, 3x boundary) on
    the fine level from x = 0 and record the residual norms and per-phase
    average times (the reference's testSmoother).

    The block is `fused_smoother.smooth_level` (the chunk kernel on the
    card, entered with the current x); the boundary and interior phases are
    timed apart on the plain stencil ops.  Only the fine level is built:
    a one-level hierarchy would also factor a direct solve of the whole
    fine level, which the block never uses.
    """
    dev = device_mod.resolve(device)
    base, weights = _domain(grid_size, use_complex_domain, use_solid_sphere)
    labels, exp_weights, offset, _ = expand(base, weights)
    config = SolverConfig(use_gauss_seidel=use_gauss_seidel, kernel_mode=kernel_mode)
    dtype = config.mg_dtype_resolved
    fw = None if exp_weights is None else tuple(torch.as_tensor(w, dtype=dtype, device=dev) for w in exp_weights)
    c = mg_mod._level_coeffs(
        torch.as_tensor(labels, device=dev), fw, config.boundary_width, dtype, config.mg_ew_dtype
    )
    blocks = fused_smoother.level_blocks(c, config)

    rhs = torch.as_tensor(
        delta_spike_rhs(
            labels.shape, solvable=c.solvable.cpu().numpy(), offset=offset, base_shape=base.shape
        ),
        device=dev,
    )

    def smooth(x):
        return fused_smoother.smooth_level(x, rhs, c, config, True, blocks=blocks)

    def res_norm(x):
        return float(blas.l2_norm(stencil.residual(x, rhs, c), c.solvable))

    def boundary_phase(x):
        for _ in range(config.boundary_iterations):
            x = stencil.boundary_jacobi(x, rhs, c, config.jacobi_damping)
        return x

    def interior_phase(x):
        if config.use_gauss_seidel:
            return stencil.rb_gauss_seidel(x, rhs, c, forward=True)
        return stencil.jacobi_smooth(x, rhs, c, config.jacobi_damping)

    def timed(fn, x):
        _sync(dev)
        t0 = time.perf_counter()
        out = fn(x)
        _sync(dev)
        return out, time.perf_counter() - t0

    x = torch.zeros_like(rhs)
    norms = [res_norm(x)]
    times, boundary_times, interior_times = [], [], []
    for _ in range(max_smoother_iterations):
        xb, tb1 = timed(boundary_phase, x)
        xi, ti = timed(interior_phase, xb)
        _, tb2 = timed(boundary_phase, xi)
        boundary_times.append(tb1 + tb2)
        interior_times.append(ti)
        x, t = timed(smooth, x)
        times.append(t)
        norms.append(res_norm(x))

    def _avg(ts):
        return float(np.mean(ts[1:])) if len(ts) > 1 else ts[0]

    return {
        "residual_l2": norms,
        "avg_smooth_seconds": _avg(times),
        "avg_boundary_phase_seconds": _avg(boundary_times),
        "avg_interior_phase_seconds": _avg(interior_times),
    }


# ---------------------------------------------------------------------------
# CLI (the node's parameter sheet)
# ---------------------------------------------------------------------------


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--grid-size", type=int, default=64)
    p.add_argument("--test-conjugate-gradient", action="store_true")
    p.add_argument("--test-symmetry", action="store_true")
    p.add_argument("--test-one-level-v-cycle", action="store_true")
    p.add_argument("--test-smoother", action="store_true")
    p.add_argument("--use-complex-domain", action="store_true", default=True)
    p.add_argument("--use-simple-domain", dest="use_complex_domain", action="store_false")
    p.add_argument("--use-solid-sphere", action="store_true")
    p.add_argument("--use-random-initial-guess", action="store_true")
    p.add_argument("--solve-with-multigrid", action="store_true", default=True)
    p.add_argument("--solve-with-diagonal", dest="solve_with_multigrid", action="store_false")
    p.add_argument("--tolerance", type=float, default=1e-5)
    p.add_argument("--max-iterations", type=int, default=1000)
    p.add_argument(
        "--dx", type=float, default=None,
        help="grid spacing for the dx^2 RHS-scaling round trip",
    )
    p.add_argument("--num-cycles", type=int, default=50)
    p.add_argument("--max-smoother-iterations", type=int, default=20)
    p.add_argument("--device", default="cuda", help="cuda (the default; needs a card) or cpu")
    args = p.parse_args(argv)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        p.error("no CUDA device is available; pass --device cpu to run on the CPU")
    dev = torch.device(args.device)

    np.set_printoptions(precision=10)
    any_ran = False

    if args.test_conjugate_gradient:
        any_ran = True
        r = run_conjugate_gradient_test(
            args.grid_size,
            use_complex_domain=args.use_complex_domain,
            use_solid_sphere=args.use_solid_sphere,
            use_mg_preconditioner=args.solve_with_multigrid,
            use_random_guess=args.use_random_initial_guess,
            tolerance=args.tolerance,
            max_iterations=args.max_iterations,
            dx=args.dx,
            device=dev,
        )
        print("== testConjugateGradient ==")
        for k, v in r.items():
            print(f"  {k}: {v:.10g}" if isinstance(v, float) else f"  {k}: {v}")

    if args.test_symmetry:
        any_ran = True
        r = run_symmetry_test(
            min(args.grid_size, 32),
            use_complex_domain=args.use_complex_domain,
            use_solid_sphere=args.use_solid_sphere,
            device=dev,
        )
        print("== testSymmetry (relative asymmetry; must be < 1e-10) ==")
        for k, v in r.items():
            status = "OK" if v < 1e-10 else "FAIL"
            print(f"  {k}: {v:.3e}  [{status}]")

    if args.test_one_level_v_cycle:
        any_ran = True
        r = run_one_level_vcycle_test(args.grid_size, num_cycles=args.num_cycles, device=dev)
        print("== testOneLevelVCycle ==")
        for i, (li, l2) in enumerate(zip(r["l_infinity"], r["l2"])):
            print(f"  cycle {i + 1}: L-inf {li:.10e}  L2 {l2:.10e}")
        print(f"  mean convergence factor: {r['mean_convergence_factor']:.4f}")

    if args.test_smoother:
        any_ran = True
        r = run_smoother_test(
            args.grid_size,
            max_smoother_iterations=args.max_smoother_iterations,
            use_complex_domain=args.use_complex_domain,
            use_solid_sphere=args.use_solid_sphere,
            device=dev,
        )
        print("== testSmoother ==")
        for i, v in enumerate(r["residual_l2"]):
            print(f"  iteration {i}: residual L2 {v:.10e}")
        print(f"  avg smoother block: {r['avg_smooth_seconds'] * 1e3:.3f} ms")
        print(
            f"  avg boundary phase: {r['avg_boundary_phase_seconds'] * 1e3:.3f} ms"
            f"  avg interior phase: {r['avg_interior_phase_seconds'] * 1e3:.3f} ms"
        )

    if not any_ran:
        print("no test toggles given; see --help (mirrors the reference node's toggles)")
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
