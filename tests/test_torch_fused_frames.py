"""The fused frame loop (models/simulate.run_fused), port vs JAX.

Same numpy inputs through both packages, fp64 on the CPU.  `run_fused`
against the JAX package's `run` and the port's `run`, frame by frame as the
JAX package's own tests hold its `run_fused` (tests/test_simulate.py): CG
iteration counts equal, the liquid SDF within 1e-12, velocity and pressure
within 1e-9 (rounding carried through several projections).  The scenes:
the splash in chunks of 2, the JAX package's falling-drop scene, a lone
drop whose chunks break the frozen window and are re-run frame by frame,
and the splash with upwind advection.

`mg.coarse_system_device` (the coarse direct solve built on the level's
device) against the JAX package's `_coarse_system_traced` on the same
coefficients and against the port's host `_finish_hierarchy`: the slot map
equal, the inverse within 1e-10 of its largest entry (two LAPACK inverses
of the same matrix).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geometricmultigridpressuresolver_tpu.config import SolverConfig as JaxConfig
from geometricmultigridpressuresolver_tpu.models import sdf as jax_sdf
from geometricmultigridpressuresolver_tpu.models import simulate as jax_sim
from geometricmultigridpressuresolver_tpu.ops import stencil as jax_stencil
from geometricmultigridpressuresolver_tpu.solver import mg as jax_mg
from geometricmultigridpressuresolver_tpu_torch.config import SolverConfig
from geometricmultigridpressuresolver_tpu_torch.models import free_surface, simulate
from geometricmultigridpressuresolver_tpu_torch.solver import mg
from tests import helpers

torch.set_num_threads(1)

PHI_TOL, FIELD_TOL, MINV_TOL = 1e-12, 1e-9, 1e-10


def _splash(n):
    phi, velocity = jax_sdf.splash_scene((n, n, n))
    return phi, velocity, jax_sdf.open_box_weights((n, n, n))


def _falling_drop(n):
    """A small drop high above a shallow pool, falling fast: the JAX
    package's re-run scene (tests/test_simulate.py::
    test_run_fused_geometry_fallback).  At n = 20 the pool spans the grid,
    so the frozen window is the whole padded grid and the chunk runs fused
    in both packages."""
    points, _ = jax_sdf.cell_centers((n, n, n))
    phi = np.minimum(jax_sdf.pool_sdf(points, 0.15), jax_sdf.sphere_sdf(points, (0.5, 0.8, 0.5), 0.12))
    velocity = []
    for ax in range(3):
        v = np.zeros(tuple(n + (1 if a == ax else 0) for a in range(3)))
        if ax == 1:
            v -= 2.0
        velocity.append(v)
    return phi, velocity, jax_sdf.open_box_weights((n, n, n))


def _lone_drop(n):
    """A lone drop falling fast through a stretching flow: its active box
    leaves the frozen window within each chunk of 2 frames, so both chunks
    are re-run frame by frame (the second from geometry frozen again)."""
    points, dx = jax_sdf.cell_centers((n, n, n))
    phi = jax_sdf.sphere_sdf(points, (0.5, 0.7, 0.5), 0.12)
    velocity = []
    for ax in range(3):
        shape = tuple(n + (1 if a == ax else 0) for a in range(3))
        face = np.arange(shape[ax]) * dx  # face i of axis ax sits at i*dx
        along = np.broadcast_to(face.reshape([-1 if a == ax else 1 for a in range(3)]), shape)
        velocity.append({0: 2.0 * (along - 0.5), 1: -2.0 * (along - 0.5) - 3.0}.get(ax, np.zeros(shape)))
    return phi, velocity, jax_sdf.open_box_weights((n, n, n))


SCENES = {
    # name: (scene, n, frames, chunk, dt, config kwargs, chunks that run fused)
    "splash_chunk2": (_splash, 24, 4, 2, 1.0 / 60.0, dict(tolerance=1e-8), [2, 4]),
    "falling_drop": (_falling_drop, 20, 6, 6, 1.0 / 30.0, dict(tolerance=1e-7), [6]),
    "lone_drop_rerun": (_lone_drop, 24, 4, 2, 1.0 / 30.0, dict(tolerance=1e-8), []),
    "splash_upwind": (_splash, 24, 3, 3, 1.0 / 60.0, dict(tolerance=1e-8, advection="upwind"), [3]),
}


@pytest.fixture(scope="module")
def jax_runs():
    """The JAX package's `run` of each scene, built once."""
    cache = {}

    def get(name):
        if name not in cache:
            scene, n, frames, _, dt, kwargs, _ = SCENES[name]
            phi, velocity, weights = scene(n)
            cache[name] = jax_sim.run(
                jnp.asarray(phi), tuple(map(jnp.asarray, velocity)), weights, num_frames=frames,
                dt=dt, config=JaxConfig(max_iterations=300, **kwargs),
            )
        return cache[name]

    return get


def _close(got, want, tol):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=tol)


@pytest.mark.parametrize("name", list(SCENES))
def test_run_fused_matches_run(jax_runs, name):
    scene, n, frames, chunk, dt, kwargs, fused_chunks = SCENES[name]
    phi, velocity, weights = scene(n)
    config = SolverConfig(max_iterations=300, **kwargs)
    done = []
    f_phi, f_vel, f_pressure, stats = simulate.run_fused(
        phi, velocity, weights, num_frames=frames, dt=dt, config=config, chunk=chunk,
        on_chunk=lambda k, s: done.append((k, len(s))), device="cpu",
    )
    # on_chunk runs only for the chunks that ran fused; the lone drop's
    # chunks broke the frozen window and were re-run frame by frame.
    assert [k for k, _ in done] == fused_chunks and all(m == chunk for _, m in done)
    jframes = jax_runs(name)
    tframes = simulate.run(phi, velocity, weights, num_frames=frames, dt=dt, config=config, device="cpu")
    assert list(stats["iterations"]) == [jf.iterations for jf in jframes] == [tf.iterations for tf in tframes]
    assert all(stats["relative_residual"] <= kwargs["tolerance"] * 1.01)
    assert all(stats["max_divergence"] < 1e-5)
    assert f_pressure.dtype == f_phi.dtype == torch.float64
    for want in (jframes[-1], tframes[-1]):
        _close(f_phi, want.liquid_phi, PHI_TOL)
        _close(f_pressure, want.pressure, FIELD_TOL)
        for a in range(3):
            _close(f_vel[a], want.velocity[a], FIELD_TOL)


def test_run_fused_tail_goes_through_run():
    """3 frames in chunks of 2: one fused chunk, then a 1-frame tail through
    `run()` warm-started from the chunk's pressure."""
    phi, velocity, weights = _splash(16)
    config = SolverConfig(tolerance=1e-8)
    done = []
    f_phi, _, f_pressure, stats = simulate.run_fused(
        phi, velocity, weights, num_frames=3, dt=1.0 / 60.0, config=config, chunk=2,
        on_chunk=lambda k, s: done.append(k), device="cpu",
    )
    assert done == [2] and len(stats["iterations"]) == 3
    tframes = simulate.run(phi, velocity, weights, num_frames=3, dt=1.0 / 60.0, config=config, device="cpu")
    assert list(stats["iterations"]) == [tf.iterations for tf in tframes]
    _close(f_phi, tframes[-1].liquid_phi.numpy(), PHI_TOL)
    _close(f_pressure, tframes[-1].pressure.numpy(), FIELD_TOL)


def test_setup_base_fields_device_form_matches_host_form():
    phi, _, weights = _splash(16)
    phi = torch.from_numpy(phi)
    weights = tuple(torch.from_numpy(w) for w in weights)
    args = (phi, weights, None, 0.01, torch.float64, 4)
    host = free_surface._setup_base_fields(*args)
    dev = free_surface._setup_base_fields(*args, host=False)
    for h, d in zip(host[:3], dev[:3]):
        assert torch.equal(h, d)
    for h, d in zip(host[4], dev[4]):
        assert isinstance(d, torch.Tensor) and np.array_equal(h, d.numpy())
    assert isinstance(dev[5], torch.Tensor) and int(dev[5]) == host[5] > 0


def _jax_level(c):
    return jax_stencil.LevelCoeffs(*(jnp.asarray(t.numpy()) for t in c))


@pytest.fixture(scope="module")
def coarse_levels():
    """name -> (port level, host-built hierarchy or None): the splash
    setup's coarsest level (unit weights) beside its hierarchy, and the
    finest level of the 16^3 sine-Dirichlet fixture with fractional
    weights."""
    phi, _, weights = _splash(24)
    setup = free_surface.build_setup(phi, weights, config=SolverConfig(), device="cpu")
    labels, fw, mg_levels = helpers.expanded_domain(helpers.sine_dirichlet_domain, 16, fractional=True)
    fine = mg.build_hierarchy(labels, fw, mg_levels, SolverConfig(), device="cpu").levels[0]
    return {"splash_coarsest": (setup.problem.hier.levels[-1], setup.problem.hier),
            "sine_fine_fractional": (fine, None)}


@pytest.mark.parametrize("name", ["splash_coarsest", "sine_fine_fractional"])
def test_coarse_system_device_matches_jax_and_host(coarse_levels, name):
    c, hier = coarse_levels[name]
    ndof = int(c.solvable.sum())
    nd_pad = max(256, -(-ndof // 256) * 256)
    dofs, minv, nd = mg.coarse_system_device(c, nd_pad)
    jdofs, jminv, jnd = jax_mg._coarse_system_traced(_jax_level(c), nd_pad)
    assert int(nd) == int(jnd) == ndof and dofs.dtype == torch.int64
    assert np.array_equal(dofs.numpy(), np.asarray(jdofs))
    scale = float(np.abs(np.asarray(jminv)).max())
    assert float(np.abs(minv.numpy() - np.asarray(jminv)).max()) <= MINV_TOL * scale
    assert torch.equal(minv, minv.T)
    if hier is not None:
        assert hier.coarse_minv.shape == minv.shape
        assert torch.equal(dofs, hier.coarse_dofs)
        assert float((minv - hier.coarse_minv).abs().max()) <= MINV_TOL * scale


def test_coarse_system_device_bucket_overflow(coarse_levels):
    """A bucket smaller than the DOF count: no error, the count is still
    reported, and the kept part matches the JAX package's dropped
    scatters."""
    c, _ = coarse_levels["sine_fine_fractional"]
    ndof = int(c.solvable.sum())
    nd_pad = 64
    assert ndof > nd_pad
    dofs, minv, nd = mg.coarse_system_device(c, nd_pad)
    jdofs, jminv, _ = jax_mg._coarse_system_traced(_jax_level(c), nd_pad)
    assert int(nd) == ndof > nd_pad
    assert dofs.shape == (nd_pad,) and minv.shape == (nd_pad, nd_pad)
    assert bool(torch.isfinite(minv).all()) and torch.equal(minv, minv.T)
    assert np.array_equal(dofs.numpy(), np.asarray(jdofs))
    scale = float(np.abs(np.asarray(jminv)).max())
    assert float(np.abs(minv.numpy() - np.asarray(jminv)).max()) <= MINV_TOL * scale
