"""The assembled-matrix baseline (models/assembled.py), port vs JAX.

`solve_assembled` is numpy/scipy in both packages: equal within 1e-12 on
the same arrays.  `project_assembled` sets up and audits its fields on the
device (here the CPU) and solves on the host: against the JAX package's
at the 20^3 splash, pressure and velocity within 1e-9 (both solve to
1e-9 relative) and `max_div` both < 1e-6; against the port's own MGPCG
projection as the JAX package's tests/test_free_surface.py holds its own.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geometricmultigridpressuresolver_tpu import diagnostics as jax_diag
from geometricmultigridpressuresolver_tpu.models import assembled as jax_assembled
from geometricmultigridpressuresolver_tpu.models import sdf as jax_sdf
from geometricmultigridpressuresolver_tpu_torch import grids
from geometricmultigridpressuresolver_tpu_torch.config import SolverConfig
from geometricmultigridpressuresolver_tpu_torch.models import assembled, free_surface
from geometricmultigridpressuresolver_tpu_torch.ops import blas

torch.set_num_threads(1)

N = 20


def test_grid_vec_round_trip():
    labels, _ = jax_diag.build_complex_domain(12, use_solid_sphere=True)
    idx, ndof = assembled.dof_indices(labels)
    rng = np.random.default_rng(1)
    v = rng.standard_normal(ndof)
    grid = assembled.vec_to_grid(v, idx, labels.shape)
    assert np.array_equal(assembled.grid_to_vec(grid, idx), v)
    assert not grid[idx < 0].any()
    assert np.array_equal(grid, jax_assembled.vec_to_grid(v, idx, labels.shape))


@pytest.mark.parametrize("warm", [False, True])
def test_solve_assembled_matches_jax(warm):
    base, weights = jax_diag.build_complex_domain(16, use_solid_sphere=True)
    labels, exp_weights, offset, _ = jax_diag.expand(base, weights)
    labels, exp_weights = np.asarray(labels), [np.asarray(w) for w in exp_weights]
    rhs = jax_diag.delta_spike_rhs(labels.shape, solvable=labels >= 2, offset=offset, base_shape=base.shape)
    x0 = jax_diag.random_initial_guess(labels, 3) if warm else None
    got = assembled.solve_assembled(labels, rhs, exp_weights, tol=1e-10, x0_grid=x0)
    want = jax_assembled.solve_assembled(labels, rhs, exp_weights, tol=1e-10, x0_grid=x0)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12 * np.abs(want).max())


def test_solve_assembled_raises_when_not_converged():
    labels = np.full((8, 8, 8), 2, np.int8)
    labels[0], labels[-1] = 1, 1
    rhs = np.where(labels >= 2, 1.0, 0.0)
    with pytest.raises(RuntimeError, match="did not converge"):
        assembled.solve_assembled(labels, rhs, tol=1e-14, max_iterations=1)


@pytest.fixture(scope="module")
def scene():
    phi, velocity = jax_sdf.splash_scene((N,) * 3)
    weights = jax_sdf.open_box_weights((N,) * 3)
    return np.asarray(phi), [np.asarray(v) for v in velocity], [np.asarray(w) for w in weights]


def test_project_assembled_matches_jax(scene):
    phi, velocity, weights = scene
    rng = np.random.default_rng(4)
    old = rng.standard_normal(phi.shape)
    for kw in ({}, {"old_pressure": old}):
        want = jax_assembled.project_assembled(phi, weights, velocity, tolerance=1e-9, max_iterations=2000, **kw)
        got = assembled.project_assembled(
            phi, weights, velocity, tolerance=1e-9, max_iterations=2000, device="cpu", **kw
        )
        np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-9 * np.abs(want[0]).max())
        for g, w in zip(got[1], want[1]):
            assert g.shape == w.shape
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-9)
        assert isinstance(got[2], float) and got[2] < 1e-6 and want[2] < 1e-6


def test_project_assembled_matches_port_mgpcg(scene):
    """The baseline node against the geometric MGPCG pipeline end to end."""
    phi = torch.from_numpy(scene[0])
    velocity = tuple(torch.from_numpy(v) for v in scene[1])
    weights = tuple(torch.from_numpy(w) for w in scene[2])
    config = SolverConfig(tolerance=1e-9, max_iterations=500)
    setup = free_surface.build_setup(phi, weights, config=config)
    mg = free_surface.project(setup, velocity, config=config)
    p_base, v_base, max_div = assembled.project_assembled(
        phi, weights, velocity, tolerance=1e-9, max_iterations=2000
    )
    assert max_div < 1e-6
    scale = max(float(mg.pressure.abs().max()), 1e-300)
    assert float(np.abs(mg.pressure.numpy() - p_base).max()) / scale < 1e-5
    for a in range(3):
        np.testing.assert_allclose(mg.velocity[a].numpy(), v_base[a], atol=1e-6)


def test_small_helpers_match_jax():
    from geometricmultigridpressuresolver_tpu import grids as jax_grids
    from geometricmultigridpressuresolver_tpu.ops import blas as jax_blas
    from geometricmultigridpressuresolver_tpu.ops import domain as jax_domain
    from geometricmultigridpressuresolver_tpu_torch.ops import domain

    labels = np.asarray(jax_diag.expand(jax_diag.build_simple_domain(12))[0])
    assert np.array_equal(grids.is_dirichlet(torch.from_numpy(labels)).numpy(), jax_grids.is_dirichlet(labels))
    assert grids.cell_count((3, 5, 7)) == jax_grids.cell_count((3, 5, 7)) == 105
    rng = np.random.default_rng(0)
    x, y = rng.standard_normal((2, 4, 5, 6))
    np.testing.assert_array_equal(blas.scale(torch.from_numpy(x), 0.3).numpy(),
                                  np.asarray(jax_blas.scale(jnp.asarray(x), 0.3)))
    for name in ("axpy", "xpay"):
        np.testing.assert_array_equal(
            getattr(blas, name)(torch.from_numpy(x), 0.3, torch.from_numpy(y)).numpy(),
            np.asarray(getattr(jax_blas, name)(jnp.asarray(x), 0.3, jnp.asarray(y))),
        )
    for max_levels in (None, 2):
        got = domain.build_label_hierarchy(torch.from_numpy(labels), 4, max_levels)
        want = jax_domain.build_label_hierarchy(labels, 4, max_levels)
        assert len(got) == len(want) and all(np.array_equal(g.numpy(), np.asarray(w)) for g, w in zip(got, want))
