"""The frame loop (models/simulate.py) and sticky windows, port vs JAX.

Same numpy inputs through both packages, fp64.  Advection (semi-Lagrangian
and upwind, scalar and velocity) agrees to 1e-12; `run` agrees frame by
frame: equal CG iteration counts and equal window shapes, and the liquid
SDF, velocity and pressure within 1e-9 (rounding carried through three
projections), also with its setup and projection as cached programs
(`setup_fusion` "fused" and "per-level").
"""

import functools
import io
from contextlib import redirect_stdout

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geometricmultigridpressuresolver_tpu.config import SolverConfig as JaxConfig
from geometricmultigridpressuresolver_tpu.models import free_surface as jax_fs
from geometricmultigridpressuresolver_tpu.models import sdf as jax_sdf
from geometricmultigridpressuresolver_tpu.models import simulate as jax_sim
from geometricmultigridpressuresolver_tpu_torch.config import SolverConfig
from geometricmultigridpressuresolver_tpu_torch.models import free_surface, sdf, simulate
from geometricmultigridpressuresolver_tpu_torch.solver import graph
from tests import torch_programs

torch.set_num_threads(1)


def _face_fields(shape, rng, lo=-2.0, hi=2.0):
    return [
        rng.uniform(lo, hi, size=tuple(s + (1 if a == ax else 0) for a, s in enumerate(shape)))
        for ax in range(3)
    ]


@pytest.mark.parametrize("scheme", ["semi_lagrangian", "upwind"])
@pytest.mark.parametrize("what", ["scalar", "velocity"])
def test_advection_matches_jax(scheme, what):
    """Non-cubic grid, CFL up to ~2 so backtraces cross cells and clamp at
    the edges."""
    rng = np.random.default_rng(3)
    shape = (12, 14, 13)
    field = rng.standard_normal(shape)
    vel = _face_fields(shape, rng)
    dt, dx = 1.0 / 20.0, 1.0 / 12.0
    suffix = "" if scheme == "semi_lagrangian" else "_upwind"
    jvel, tvel = tuple(map(jnp.asarray, vel)), tuple(map(torch.from_numpy, vel))
    if what == "scalar":
        want = [getattr(jax_sim, "advect_scalar" + suffix)(jnp.asarray(field), jvel, dt, dx)]
        got = [getattr(simulate, "advect_scalar" + suffix)(torch.from_numpy(field), tvel, dt, dx)]
    else:
        want = getattr(jax_sim, "advect_velocity" + suffix)(jvel, dt, dx)
        got = getattr(simulate, "advect_velocity" + suffix)(tvel, dt, dx)
    for g, w in zip(got, want):
        assert g.dtype == torch.float64
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-12)


def test_advection_dt0_is_identity():
    rng = np.random.default_rng(8)
    n = 10
    field = torch.from_numpy(rng.standard_normal((n, n, n)))
    vel = tuple(torch.from_numpy(v) for v in _face_fields((n, n, n), rng))
    assert torch.allclose(simulate.advect_scalar(field, vel, 0.0, 1.0 / n), field, rtol=0, atol=1e-12)
    for got, want in zip(simulate.advect_velocity(vel, 0.0, 1.0 / n), vel):
        assert torch.allclose(got, want, rtol=0, atol=1e-12)


def _splash(n):
    phi, velocity = jax_sdf.splash_scene((n, n, n))
    return phi, velocity, jax_sdf.open_box_weights((n, n, n))


def _stretching_drop(n):
    """A lone drop in a divergence-free stretching flow (out along x, in
    along y): its active box outgrows the first frame's window, so the
    second frame regrows it with window_slack headroom."""
    points, dx = jax_sdf.cell_centers((n, n, n))
    phi = jax_sdf.sphere_sdf(points, (0.5, 0.5, 0.5), 0.15)
    velocity = []
    for ax in range(3):
        shape = tuple(n + (1 if a == ax else 0) for a in range(3))
        face = np.arange(shape[ax]) * dx  # face i of axis ax sits at i*dx
        along = np.broadcast_to(face.reshape([-1 if a == ax else 1 for a in range(3)]), shape)
        velocity.append({0: 4.0 * (along - 0.5), 1: -4.0 * (along - 0.5)}.get(ax, np.zeros(shape)))
    return phi, velocity, jax_sdf.open_box_weights((n, n, n))


RUNS = {
    # name: (scene, n, frames, dt, config kwargs)
    "splash_semi_lagrangian": (_splash, 24, 3, 1.0 / 60.0, {}),
    "splash_upwind": (_splash, 24, 3, 1.0 / 60.0, {"advection": "upwind"}),
    "stretching_drop_regrows": (_stretching_drop, 24, 4, 1.0 / 30.0, {}),
}


@functools.lru_cache(maxsize=None)
def _jax_run(name):
    """JAX's `run` of a RUNS entry: (frames, window shape per frame),
    computed once per module (its compiles dominate the file's time)."""
    scene, n, frames, dt, kwargs = RUNS[name]
    phi, velocity, weights = scene(n)
    shapes = []
    jframes = jax_sim.run(
        jnp.asarray(phi), tuple(map(jnp.asarray, velocity)), weights, num_frames=frames,
        dt=dt, config=JaxConfig(tolerance=1e-6, max_iterations=300, **kwargs),
        on_frame=lambda k, fr: shapes.append(tuple(fr.setup.expanded_shape)),
    )
    return jframes, shapes


@pytest.mark.parametrize("name", list(RUNS))
def test_run_matches_jax_frame_by_frame(name):
    scene, n, frames, dt, kwargs = RUNS[name]
    phi, velocity, weights = scene(n)
    common = dict(tolerance=1e-6, max_iterations=300, **kwargs)
    shapes = {"jax": None, "port": []}
    jframes, shapes["jax"] = _jax_run(name)
    tframes = simulate.run(
        phi, velocity, weights, num_frames=frames, dt=dt, config=SolverConfig(**common),
        on_frame=lambda k, fr: shapes["port"].append(fr.setup.expanded_shape), device="cpu",
    )
    assert len(tframes) == frames
    assert shapes["port"] == shapes["jax"]
    for jf, tf in zip(jframes, tframes):
        assert tf.setup is None  # run keeps only the latest setup
        assert tf.iterations == jf.iterations > 0
        assert tf.relative_residual <= 1e-6 * 1.01 and tf.max_divergence < 1e-4
        np.testing.assert_allclose(tf.liquid_phi.numpy(), np.asarray(jf.liquid_phi), rtol=0, atol=1e-9)
        np.testing.assert_allclose(tf.pressure.numpy(), np.asarray(jf.pressure), rtol=0, atol=1e-9)
        for a in range(3):
            np.testing.assert_allclose(
                tf.velocity[a].numpy(), np.asarray(jf.velocity[a]), rtol=0, atol=1e-9
            )
    reused = [tf.window_reused for tf in tframes]
    assert not reused[0]
    if name == "stretching_drop_regrows":
        assert reused == [False, False, True, True]
        assert shapes["port"][1] != shapes["port"][0]
    else:
        assert all(reused[1:])


@pytest.mark.parametrize("fusion", ["fused", "per-level"])
def test_run_through_programs_matches_jax(fusion, monkeypatch):
    """run() with its setup and projection as cached programs (emulated
    on the CPU, `tests.torch_programs.EmulatedProgram`) at either `setup_fusion`
    granularity, on the drop whose window regrows at frame 2 and is kept
    after: JAX's window shapes, iterations and pressure within 1e-9; the
    setup captured once per window shape and the projection once per
    (window, coarse bucket, warm start), every other frame a replay; the
    eager run's bits."""
    torch_programs.emulate(monkeypatch)
    name = "stretching_drop_regrows"
    scene, n, frames, dt, kwargs = RUNS[name]
    phi, velocity, weights = scene(n)
    jframes, jshapes = _jax_run(name)
    keys = []

    def on_frame(k, fr):
        hier = fr.setup.problem.hier
        keys.append((fr.setup.expanded_shape, hier.coarse_minv.shape[0], k > 0))

    common = dict(tolerance=1e-6, max_iterations=300, **kwargs)
    tframes = simulate.run(phi, velocity, weights, num_frames=frames, dt=dt,
                           config=SolverConfig(setup_fusion=fusion, **common), on_frame=on_frame, device="cpu")
    assert [k[0] for k in keys] == jshapes and len({k[0] for k in keys}) == 2
    for jf, tf in zip(jframes, tframes):
        assert tf.iterations == jf.iterations > 0
        np.testing.assert_allclose(tf.pressure.numpy(), np.asarray(jf.pressure), rtol=0, atol=1e-9)
    captures, hits = graph.STATS.program_captures, graph.STATS.program_hits
    assert (captures["setup"], hits["setup"]) == (2, frames - 2)
    assert (captures["project"], hits["project"]) == (len(set(keys)), frames - len(set(keys)))
    with graph.programs_off():
        eager = simulate.run(phi, velocity, weights, num_frames=frames, dt=dt, config=SolverConfig(**common),
                             device="cpu")
    for a, b in zip(tframes, eager):
        assert a.iterations == b.iterations and torch.equal(a.pressure, b.pressure)
        assert all(torch.equal(u, v) for u, v in zip(a.velocity, b.velocity))


def test_build_setup_reuse_from_matches_jax():
    """The sticky window directly: a setup reused by a slightly moved liquid
    keeps its shape; one that no longer fits regrows with window_slack
    headroom.  Window shapes and origins equal the JAX package's."""
    n = 24
    phi, _, weights = _stretching_drop(n)
    moved = phi + 0.02   # shrinks the drop: fits the old window
    grown = phi - 0.08   # grows it past the old window
    jcfg, tcfg = JaxConfig(), SolverConfig()
    j0 = jax_fs.build_setup(phi, weights, config=jcfg)
    t0 = free_surface.build_setup(phi, weights, config=tcfg, device="cpu")
    for new in (moved, grown):
        js = jax_fs.build_setup(new, weights, config=jcfg, reuse_from=j0)
        ts = free_surface.build_setup(new, weights, config=tcfg, reuse_from=t0, device="cpu")
        assert ts.expanded_shape == tuple(js.expanded_shape)
        assert ts.window_start == tuple(int(s) for s in np.asarray(js.window_start))
        assert ts.base_pads == tuple(js.base_pads)
    assert free_surface.build_setup(moved, weights, config=tcfg, reuse_from=t0, device="cpu").expanded_shape == t0.expanded_shape
    regrown = free_surface.build_setup(grown, weights, config=tcfg, reuse_from=t0, device="cpu")
    fresh = free_surface.build_setup(grown, weights, config=tcfg, device="cpu")
    assert regrown.expanded_shape[0] == fresh.expanded_shape[0] + tcfg.window_slack * fresh.padding
    no_slack = free_surface.build_setup(
        grown, weights, config=SolverConfig(window_slack=0), reuse_from=t0, device="cpu"
    )
    assert no_slack.expanded_shape == fresh.expanded_shape


def test_step_reports_stages_and_reuse():
    n = 16
    phi, velocity = sdf.splash_scene((n, n, n), device="cpu")
    weights = sdf.open_box_weights((n, n, n), device="cpu")
    cfg = SolverConfig(tolerance=1e-6)
    first = simulate.step(phi, velocity, weights, 1.0 / 60.0, config=cfg)
    second = simulate.step(
        first.liquid_phi, first.velocity, weights, 1.0 / 60.0, old_pressure=first.pressure,
        config=cfg, reuse_setup=first.setup,
    )
    assert not first.window_reused and second.window_reused
    assert set(first.seconds) == {"advect", "setup", "project"}
    assert all(v >= 0 for v in second.seconds.values())
    assert second.pressure.shape == (n, n, n) and second.liquid_phi.dtype == torch.float64


def test_cli_runs_frames_on_cpu():
    out = io.StringIO()
    with redirect_stdout(out):
        rc = simulate.main(["--n", "12", "--frames", "2", "--fp32", "--device", "cpu"])
    lines = out.getvalue().splitlines()
    assert rc == 0
    assert lines[0].startswith("frame 1: iters=") and lines[1].startswith("frame 2: iters=")
    assert "(kept)" in lines[1]
    assert lines[-1].startswith("2 frames in") and lines[-1].endswith("on cpu")
