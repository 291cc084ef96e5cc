"""Port's setup (scene, domain construction, hierarchy) against the JAX package.

In fp64 the setup must be BIT-equal to the JAX package's on the same
inputs: labels, window start, expanded shape, level shapes, bands and every
coefficient grid (same operations in the same order).  The scenes the port
generates with torch agree with the JAX package's numpy scenes to a few
ulps (transcendentals may round differently).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geometricmultigridpressuresolver_tpu.config import SolverConfig as JaxConfig
from geometricmultigridpressuresolver_tpu.models import free_surface as jax_fs
from geometricmultigridpressuresolver_tpu.models import sdf as jax_sdf
from geometricmultigridpressuresolver_tpu.ops import domain as jax_domain
from geometricmultigridpressuresolver_tpu.solver import mg as jax_mg
from geometricmultigridpressuresolver_tpu_torch.config import SolverConfig
from geometricmultigridpressuresolver_tpu_torch.models import free_surface, sdf
from geometricmultigridpressuresolver_tpu_torch.ops import domain
from geometricmultigridpressuresolver_tpu_torch.solver import mg
from tests import helpers

torch.set_num_threads(1)


def _assert_levels_equal(jax_levels, port_levels):
    assert [tuple(c.shape) for c in jax_levels] == [c.shape for c in port_levels]
    for cj, ct in zip(jax_levels, port_levels):
        for field in cj._fields:
            want = np.asarray(getattr(cj, field))
            got = getattr(ct, field)
            assert got.dtype == {
                np.dtype(bool): torch.bool, np.dtype(np.int8): torch.int8,
                np.dtype(np.float64): torch.float64,
            }[want.dtype], field
            assert np.array_equal(got.numpy(), want), field


def _assert_hierarchy_equal(jh, th):
    _assert_levels_equal(jh.levels, th.levels)
    assert np.array_equal(th.coarse_dofs.numpy(), np.asarray(jh.coarse_dofs))
    assert np.array_equal(th.coarse_minv.numpy(), np.asarray(jh.coarse_minv))
    assert th.coarse_chol.shape == tuple(jh.coarse_chol.shape)


@pytest.fixture(scope="module")
def splash24():
    n = 24
    phi, velocity = jax_sdf.splash_scene((n, n, n))
    weights = jax_sdf.open_box_weights((n, n, n))
    js = jax_fs.build_setup(phi, weights, config=JaxConfig(), validate=True)
    ts = free_surface.build_setup(phi, weights, config=SolverConfig(), validate=True)
    return js, ts


def test_splash_setup_window_bit_equal(splash24):
    js, ts = splash24
    assert ts.expanded_shape == tuple(js.expanded_shape)
    assert ts.window_start == tuple(int(s) for s in np.asarray(js.window_start))
    assert ts.base_pads == tuple(tuple(p) for p in js.base_pads)
    assert (ts.padding, ts.mg_levels) == (js.padding, js.mg_levels)
    assert np.array_equal(ts.material.numpy(), np.asarray(js.material))
    for w_t, w_j in zip(ts.weights, js.weights):
        assert np.array_equal(w_t.numpy(), np.asarray(w_j))


def test_splash_setup_hierarchy_bit_equal(splash24):
    js, ts = splash24
    _assert_hierarchy_equal(js.problem.hier, ts.problem.hier)
    _assert_levels_equal([js.problem.fine], [ts.problem.fine])


def test_solid_sphere_setup_bit_equal():
    """Fractional cut-cell weights and a solid SDF (BOUNDARY relabeling
    from non-unit weights, ghost-fluid theta on liquid-air faces)."""
    n = 20
    phi, _ = jax_sdf.splash_scene((n, n, n), pool_height=0.6)

    def solid_fn(pts):
        return -jax_sdf.sphere_sdf(pts, (0.5, 0.3, 0.5), 0.15)

    weights = jax_sdf.face_weights_from_solid(solid_fn, (n, n, n))
    solid_phi = solid_fn(jax_sdf.cell_centers((n, n, n))[0])
    js = jax_fs.build_setup(phi, weights, solid_phi=solid_phi, config=JaxConfig())
    ts = free_surface.build_setup(phi, weights, solid_phi=solid_phi, config=SolverConfig())
    assert ts.window_start == tuple(int(s) for s in np.asarray(js.window_start))
    assert np.array_equal(ts.material.numpy(), np.asarray(js.material))
    _assert_hierarchy_equal(js.problem.hier, ts.problem.hier)


def test_bench_dtype_setup_shapes_and_dtypes():
    """Bench configuration: fp32 levels with bf16 edge weights, and the fine
    CG operator's edge weights in fp32 sharing the level-0 masks."""
    n = 20
    phi, _ = jax_sdf.splash_scene((n, n, n))
    weights = jax_sdf.open_box_weights((n, n, n))
    jc = JaxConfig(solve_dtype=jnp.float32, mg_dtype=jnp.float32, mg_ew_dtype=jnp.bfloat16)
    tc = SolverConfig(solve_dtype=torch.float32, mg_dtype=torch.float32, mg_ew_dtype=torch.bfloat16)
    js = jax_fs.build_setup(phi, weights, config=jc)
    ts = free_surface.build_setup(phi, weights, config=tc)
    assert ts.expanded_shape == tuple(js.expanded_shape)
    for c in ts.problem.hier.levels:
        assert c.ew0.dtype == torch.bfloat16 and c.diag.dtype == torch.float32
    fine = ts.problem.fine
    assert fine.ew0.dtype == torch.float32
    assert fine.solvable is ts.problem.hier.levels[0].solvable
    for cj, ct in zip(js.problem.hier.levels, ts.problem.hier.levels):
        assert np.array_equal(ct.solvable.numpy(), np.asarray(cj.solvable))
        assert np.array_equal(ct.band.numpy(), np.asarray(cj.band))


@pytest.fixture(scope="module")
def fixture32():
    return helpers.expanded_domain(helpers.sine_dirichlet_domain, 32, fractional=True)


def test_fixture32_hierarchy_bit_equal(fixture32):
    labels, weights, mg_levels = fixture32
    jh = jax_mg.build_hierarchy(labels, weights, mg_levels, JaxConfig())
    th = mg.build_hierarchy(labels, weights, mg_levels, SolverConfig(), validate=True)
    _assert_hierarchy_equal(jh, th)


@pytest.mark.parametrize("lane_align", [False, True])
def test_coarsen_and_band_match_jax(lane_align):
    """coarsen_labels (with the lane pad: fine nz 384 -> coarse 256) and the
    boundary band, on a random label grid."""
    rng = np.random.default_rng(1)
    fine = rng.choice(np.array([0, 1, 2, 3], np.int8), size=(8, 6, 384), p=[0.2, 0.2, 0.5, 0.1])
    fine[[0, -1]] = 0
    want = jax_domain.coarsen_labels(fine, lane_align=lane_align)
    got = domain.coarsen_labels(torch.from_numpy(fine), lane_align=lane_align)
    assert np.array_equal(got.numpy(), want)
    assert got.shape[2] == (256 if lane_align else 192)
    assert domain.check_coarsening(fine, got) == jax_domain.check_coarsening(fine, want)
    for width in (1, 3):
        assert np.array_equal(
            domain.boundary_band(got, width).numpy(), jax_domain.boundary_band(want, width)
        )


def test_geometry_helpers_match_jax():
    for nz in (64, 128, 256, 384, 512):
        assert domain.coarse_lane_pad(nz) == jax_domain.coarse_lane_pad(nz)
    for shape in ((24, 24, 24), (64, 40, 100)):
        assert domain.expansion_params(shape) == jax_domain.expansion_params(shape)
    rng = np.random.default_rng(2)
    for _ in range(5):
        proj = [rng.random(n) < 0.6 for n in (40, 70, 300)]
        count = int(rng.integers(1, 10**7))
        assert domain.compact_expansion_params(proj, count) == (
            jax_domain.compact_expansion_params(proj, count)
        )
    with pytest.raises(ValueError, match="padding"):
        domain.align_tile_extents((512, 512, 512), 256)


def test_trim_and_boundary_labels_match_jax(fixture32):
    labels, weights, _ = fixture32
    want = jax_domain.trim_far_dirichlet(labels, 2)
    got = domain.trim_far_dirichlet(torch.from_numpy(labels), 2)
    assert np.array_equal(got.numpy(), want)
    base = np.where(labels == 3, 2, labels).astype(np.int8)
    want_b = jax_domain.set_boundary_labels(base, weights)
    got_b = domain.set_boundary_labels(
        torch.from_numpy(base), [torch.from_numpy(w) for w in weights]
    )
    assert np.array_equal(got_b.numpy(), want_b)


def test_invariant_checks_reject_bad_labels(fixture32):
    labels, weights, _ = fixture32
    tw = [torch.from_numpy(w) for w in weights]
    assert domain.check_exterior_shell(labels)
    assert domain.check_boundary_cells(labels, tw)
    bad = labels.copy()
    bad[0, 5, 5] = 2  # a solvable cell on the outer shell
    assert not domain.check_exterior_shell(bad)
    interior = np.argwhere(labels == 3)[0]
    bad = labels.copy()
    bad[tuple(interior)] = 2  # an irregular cell labelled INTERIOR
    assert not domain.check_boundary_cells(bad, tw)
    coarse = domain.coarsen_labels(torch.from_numpy(labels))
    assert domain.check_coarsening(labels, coarse)
    broken = coarse.clone()
    broken[broken == 2] = 0
    assert not domain.check_coarsening(labels, broken)


@pytest.mark.parametrize("name", ["splash", "open_box", "solid_weights"])
def test_scenes_match_jax(name):
    shape = (12, 10, 14)
    if name == "splash":
        phi_j, vel_j = jax_sdf.splash_scene(shape)
        phi_t, vel_t = sdf.splash_scene(shape)
        pairs = [(phi_t, phi_j)] + list(zip(vel_t, vel_j))
    elif name == "open_box":
        pairs = list(zip(sdf.open_box_weights(shape), jax_sdf.open_box_weights(shape)))
    else:
        def solid_j(pts):
            return -jax_sdf.sphere_sdf(pts, (0.5, 0.3, 0.5), 0.2)

        def solid_t(pts):
            return -sdf.sphere_sdf(pts, (0.5, 0.3, 0.5), 0.2)

        pairs = list(zip(
            sdf.face_weights_from_solid(solid_t, shape),
            jax_sdf.face_weights_from_solid(solid_j, shape),
        ))
    for got, want in pairs:
        assert got.dtype == torch.float64 and tuple(got.shape) == np.shape(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-15)
