"""The whole slice: splash_scene -> build_setup -> project, port vs JAX.

Same numpy inputs through both packages.  In fp64 the CG iteration count is
equal and the pressure agrees to 1e-10 relative (to its max magnitude); in
the bench's dtype mix (fp32 solve, fp32 V-cycle, bf16 edge weights) the
iteration count is within 1 and the pressure agrees to 1e-4 relative.
Each comparison runs once from the port's own setup and once from the JAX
setup carried over with `interop` (bit-identical hierarchies).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geometricmultigridpressuresolver_tpu.config import SolverConfig as JaxConfig
from geometricmultigridpressuresolver_tpu.models import free_surface as jax_fs
from geometricmultigridpressuresolver_tpu.models import sdf as jax_sdf
from geometricmultigridpressuresolver_tpu.solver import mgpcg as jax_mgpcg
from geometricmultigridpressuresolver_tpu_torch import interop
from geometricmultigridpressuresolver_tpu_torch.config import SolverConfig
from geometricmultigridpressuresolver_tpu_torch.models import free_surface, sdf
from geometricmultigridpressuresolver_tpu_torch.ops import blas, domain, stencil
from geometricmultigridpressuresolver_tpu_torch.solver import cg, mg, mgpcg
from tests import helpers

torch.set_num_threads(1)

N = 24
BENCH_JAX = dict(solve_dtype=jnp.float32, mg_dtype=jnp.float32, mg_ew_dtype=jnp.bfloat16,
                 tolerance=1e-5, max_iterations=200)
BENCH_PORT = dict(solve_dtype=torch.float32, mg_dtype=torch.float32, mg_ew_dtype=torch.bfloat16,
                  tolerance=1e-5, max_iterations=200)


def _tree(o):
    if hasattr(o, "_asdict"):
        return {k: _tree(v) for k, v in o._asdict().items()}
    if isinstance(o, (tuple, list)):
        return [_tree(v) for v in o]
    if isinstance(o, int) or o is None:
        return o
    return np.asarray(o)


def _rel(got, want) -> float:
    want = np.asarray(want)
    return float(np.abs(np.asarray(got) - want).max() / max(np.abs(want).max(), 1e-300))


@pytest.fixture(scope="module")
def scene():
    phi, velocity = jax_sdf.splash_scene((N, N, N))
    return phi, velocity, jax_sdf.open_box_weights((N, N, N))


@pytest.fixture(scope="module")
def fp64_runs(scene):
    phi, velocity, weights = scene
    jcfg, tcfg = JaxConfig(tolerance=1e-7), SolverConfig(tolerance=1e-7)
    js = jax_fs.build_setup(phi, weights, config=jcfg)
    jr = jax_fs.project(js, velocity, config=jcfg)
    return js, jr, tcfg


@pytest.mark.parametrize("source", ["port_setup", "interop"])
def test_slice_fp64_matches_jax(scene, fp64_runs, source):
    phi, velocity, weights = scene
    js, jr, tcfg = fp64_runs
    if source == "port_setup":
        ts = free_surface.build_setup(phi, weights, config=tcfg)
    else:
        ts = interop.setup_from_arrays(_tree(js))
    tr = free_surface.project(ts, velocity, config=tcfg)
    assert tr.cg.converged and tr.cg.iterations == int(jr.cg.iterations)
    assert _rel(tr.pressure.numpy(), jr.pressure) < 1e-10
    for a in range(3):
        np.testing.assert_allclose(tr.velocity[a].numpy(), np.asarray(jr.velocity[a]), rtol=0, atol=1e-10)
    # Divergence audit: removed to the tolerance, pressure only in liquid.
    pre_max, _, _ = free_surface.divergence_stats(
        ts.liquid_mask, tuple(torch.from_numpy(v) for v in velocity), ts.weights
    )
    assert float(tr.max_divergence) < 1e-6
    assert float(tr.max_divergence) < 1e-4 * float(pre_max)
    assert (tr.pressure[~ts.liquid_mask] == 0).all()
    np.testing.assert_allclose(float(tr.residual_rel_l2), float(jr.residual_rel_l2), rtol=1e-3)


@pytest.mark.parametrize("source", ["port_setup", "interop"])
def test_slice_bench_dtypes_match_jax(scene, source):
    phi, velocity, weights = scene
    jcfg, tcfg = JaxConfig(**BENCH_JAX), SolverConfig(**BENCH_PORT)
    js = jax_fs.build_setup(phi, weights, config=jcfg)
    jr = jax_fs.project(js, velocity, config=jcfg)
    ts = (
        free_surface.build_setup(phi, weights, config=tcfg)
        if source == "port_setup" else interop.setup_from_arrays(_tree(js))
    )
    assert ts.problem.hier.levels[0].ew0.dtype == torch.bfloat16
    tr = free_surface.project(ts, velocity, config=tcfg)
    assert tr.cg.converged and tr.cg.relative_residual <= 1e-5
    assert abs(tr.cg.iterations - int(jr.cg.iterations)) <= 1
    assert _rel(tr.pressure.numpy(), jr.pressure) < 1e-4
    assert tr.pressure.dtype == torch.float32


def test_warm_start_matches_jax(scene, fp64_runs):
    phi, velocity, weights = scene
    js, jr, tcfg = fp64_runs
    ts = free_surface.build_setup(phi, weights, config=tcfg)
    first = free_surface.project(ts, velocity, config=tcfg)
    warm = free_surface.project(ts, velocity, old_pressure=first.pressure, config=tcfg)
    jwarm = jax_fs.project(js, velocity, old_pressure=jr.pressure, config=JaxConfig(tolerance=1e-7))
    assert warm.cg.iterations == int(jwarm.cg.iterations) < first.cg.iterations
    assert _rel(warm.pressure.numpy(), jwarm.pressure) < 1e-10


def test_solid_sphere_projection_matches_jax():
    n = 20
    phi, velocity = jax_sdf.splash_scene((n, n, n), pool_height=0.6)

    def solid_fn(pts):
        return -jax_sdf.sphere_sdf(pts, (0.5, 0.3, 0.5), 0.15)

    weights = jax_sdf.face_weights_from_solid(solid_fn, (n, n, n))
    solid_phi = solid_fn(jax_sdf.cell_centers((n, n, n))[0])
    solid_velocity = [np.zeros_like(v) for v in velocity]
    solid_velocity[1][:] = 0.5
    jcfg, tcfg = JaxConfig(tolerance=1e-7), SolverConfig(tolerance=1e-7)
    js = jax_fs.build_setup(phi, weights, solid_phi=solid_phi, config=jcfg)
    jr = jax_fs.project(js, velocity, solid_velocity=solid_velocity, config=jcfg)
    ts = free_surface.build_setup(phi, weights, solid_phi=solid_phi, config=tcfg)
    tr = free_surface.project(ts, velocity, solid_velocity=solid_velocity, config=tcfg)
    assert tr.cg.iterations == int(jr.cg.iterations)
    assert _rel(tr.pressure.numpy(), jr.pressure) < 1e-10
    assert float(tr.max_divergence) < 1e-6


def test_solvers_match_jax_on_fixture16():
    """mgpcg.build_problem + solve on the 16^3 fixture: the fused driver and
    the textbook solve_pcg both reproduce the JAX iteration count."""
    labels, weights, mg_levels = helpers.expanded_domain(
        helpers.sine_dirichlet_domain, 16, fractional=True
    )
    rhs = helpers.random_solvable_field(labels, seed=4)
    jcfg, tcfg = JaxConfig(tolerance=1e-8), SolverConfig(tolerance=1e-8, record_residuals=True)
    jp = jax_mgpcg.build_problem(labels, weights, mg_levels, jcfg)
    jres = jax_mgpcg.solve(jp, jnp.asarray(rhs), config=jcfg)
    tp = mgpcg.build_problem(labels, weights, mg_levels, tcfg, validate=True)
    fused = mgpcg.solve(tp, torch.from_numpy(rhs), config=tcfg)
    assert fused.iterations == int(jres.iterations)
    assert _rel(fused.x.numpy(), jres.x) < 1e-10
    hist = fused.residual_history.numpy()
    assert hist[fused.iterations] == pytest.approx(fused.relative_residual, rel=1e-12)
    assert np.isnan(hist[fused.iterations + 1:]).all()

    fine = tp.fine
    textbook = cg.solve_pcg(
        lambda v: stencil.apply_poisson(v, fine),
        lambda r: mg.v_cycle(tp.hier, None, r, tcfg),
        torch.from_numpy(rhs), fine.solvable, tolerance=1e-8,
    )
    assert textbook.iterations == int(jres.iterations)
    assert _rel(textbook.x.numpy(), jres.x) < 1e-10


def test_all_neumann_null_space_projection():
    """Closed box, no air: null-space projection with the diagonal
    preconditioner converges to a mean-free solution."""
    n = 16
    labels = np.full((n, n, n), 2, dtype=np.int8)
    expanded, _, _ = domain.expand_domain(torch.from_numpy(labels))
    weights = helpers.unit_weights(expanded.numpy())
    expanded = domain.set_boundary_labels(expanded, [torch.from_numpy(w) for w in weights])
    config = SolverConfig(
        tolerance=1e-8, max_iterations=400, project_null_space=True,
        use_mg_preconditioner=False, max_mg_levels=1,
    )
    problem = mgpcg.build_problem(expanded, weights, 1, config)
    solvable = problem.fine.solvable
    rng = np.random.default_rng(2)
    rhs = torch.where(solvable, torch.from_numpy(rng.standard_normal(tuple(expanded.shape))), 0.0)
    rhs = blas.project_null_space(rhs, solvable)
    result = mgpcg.solve(problem, rhs, config=config)
    assert result.converged
    assert abs(float(blas.masked_mean(result.x, solvable))) < 1e-10
    r = torch.where(solvable, rhs - stencil.apply_poisson(result.x, problem.fine), 0.0)
    assert float(blas.l2_norm(r, solvable) / blas.l2_norm(rhs, solvable)) < 1e-7


def test_empty_liquid_degrades_gracefully():
    n = 16
    phi = np.full((n, n, n), 1.0)
    weights = sdf.open_box_weights((n, n, n))
    rng = np.random.default_rng(2)
    velocity = tuple(
        rng.standard_normal(tuple(n + (1 if a == ax else 0) for a in range(3))) for ax in range(3)
    )
    setup = free_surface.build_setup(phi, weights, config=SolverConfig())
    assert int(setup.problem.fine.solvable.sum()) == 0
    result = free_surface.project(setup, velocity, config=SolverConfig())
    assert result.cg.iterations == 0 and result.cg.converged
    assert float(result.pressure.abs().max()) == 0.0
    for a in range(3):
        np.testing.assert_array_equal(result.velocity[a].numpy(), velocity[a])


def test_compact_window_matches_classic_expansion():
    """The compact, lane-aligned window is the same linear system as the
    reference's full-grid power-of-two expansion (compact_domain=False)."""
    n = 20
    phi, velocity = sdf.splash_scene((n, n, n))
    weights = sdf.open_box_weights((n, n, n))
    results = {}
    for compact in (True, False):
        cfg = SolverConfig(tolerance=1e-9, compact_domain=compact)
        setup = free_surface.build_setup(phi, weights, config=cfg, validate=True)
        results[compact] = (setup, free_surface.project(setup, velocity, config=cfg))
    (s_c, r_c), (s_f, r_f) = results[True], results[False]
    assert np.prod(s_c.expanded_shape) < np.prod(s_f.expanded_shape)
    assert r_c.cg.converged and r_f.cg.converged
    np.testing.assert_allclose(r_c.pressure.numpy(), r_f.pressure.numpy(), rtol=0, atol=1e-7)
