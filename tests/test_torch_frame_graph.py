"""The fused frame chunk with no host read inside a frame, on the CPU.

On the card `simulate.run_fused` captures one frozen frame as one CUDA
graph (`solver/graph.py::FrameGraph`, the JAX package's `lax.scan` over
`_frame_traced`) and launches it once per frame; its CG loop is a WHILE
node.  For that the kernels' work lists keep their lengths on the device
(`fused_smoother.Tiles.counts`, the JAX package's `_compact_blocks`) and
the frame's solve takes its device-only path (`cg.solve_pcg_fused(
device_loop=)`).  The card runs the graph (tests/test_torch_cuda.py);
here, fp64 with numpy-made inputs:

  * the padded lists with device counts against host-sized lists on the
    levels of a 24^3 splash hierarchy, a level without band cells and one
    without active tiles: the plain chunk block, CG step and residual give
    the same bits;
  * `run_fused` with its frames run by `graph.EmulatedFrame` (the same
    frame, the WHILE condition read on the host) against the JAX
    package's `run_fused`: the 24^3 splash in chunks of 2, and the lone
    drop whose chunks break the frozen window (each refreeze builds the
    frame again), with tests/test_torch_fused_frames.py's tolerances
    (iterations equal, phi 1e-12, velocity and pressure 1e-9);
  * one frame with `torch.Tensor.item`, `tolist`, `__bool__`, `__int__`,
    `__float__`, `__index__`, `cpu` and `numpy` made to raise, its CG loop
    run as the capture records it (one of each parity): nothing in a frame
    reads the host.

The JAX package's `run_fused` jits its chunk once and closes over the
frozen geometry, so after a refreeze it keeps the first geometry's trace
(checked on the CPU; ROADMAP Queue 3).  The lone drop holds regardless:
there every chunk breaks the window and both packages re-run it through
`run()`.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geometricmultigridpressuresolver_tpu.config import SolverConfig as JaxConfig
from geometricmultigridpressuresolver_tpu.models import simulate as jax_sim
from geometricmultigridpressuresolver_tpu_torch.config import SolverConfig
from geometricmultigridpressuresolver_tpu_torch.models import free_surface, simulate
from geometricmultigridpressuresolver_tpu_torch.ops import fused_cg, fused_smoother
from geometricmultigridpressuresolver_tpu_torch.solver import graph
from tests.test_torch_fused_frames import FIELD_TOL, PHI_TOL, _lone_drop, _splash

torch.set_num_threads(1)

# name: (scene, n, frames, chunk, dt, the chunks that run fused)
SCENES = {
    "splash_chunk2": (_splash, 24, 4, 2, 1.0 / 60.0, [2, 4]),
    "lone_drop_rerun": (_lone_drop, 24, 4, 2, 1.0 / 30.0, []),
}
CONFIG = dict(max_iterations=300, tolerance=1e-8)


@pytest.fixture(scope="module")
def splash_levels():
    phi, _, weights = _splash(24)
    setup = free_surface.build_setup(phi, weights, config=SolverConfig(), device="cpu")
    return setup.problem.hier.levels


def _host_sized(tiles):
    """The lists cut to their lengths on the host (the form the kernels took
    before their lengths moved to the device)."""
    active, dead, band = fused_smoother.trimmed(tiles)
    return tiles._replace(active=active.clone(), dead=dead.clone(), band=band.clone())


def _level_cases(levels):
    c0 = levels[0]
    return {
        "L0": c0,
        "L1": levels[1],
        "no_band": c0._replace(band=torch.zeros_like(c0.band)),
        "no_active": c0._replace(solvable=torch.zeros_like(c0.solvable)),
    }


@pytest.mark.parametrize("case", ["L0", "L1", "no_band", "no_active"])
def test_device_count_lists_match_host_sized_lists(splash_levels, case):
    c = _level_cases(splash_levels)[case]
    config = SolverConfig()
    blocks = fused_smoother.level_blocks(c, config)
    tiles = blocks.tiles
    n_active, n_dead, n_band = tiles.counts.tolist()
    if case == "no_band":
        assert n_band == 0 and (tiles.band == c.band.numel()).all()
    if case == "no_active":
        assert n_active == 0 and n_dead == tiles.active.numel()
    assert tiles.active.numel() == tiles.dead.numel() == n_active + n_dead
    assert tiles.band.numel() == c.band.numel()
    host = _host_sized(tiles)
    host_blocks = blocks._replace(band_cells=host.band, tiles=host)
    rng = np.random.default_rng(3)
    solv = c.solvable.numpy()
    x = torch.from_numpy(np.where(solv, rng.standard_normal(c.shape), 0.0))
    b = torch.from_numpy(np.where(solv, rng.standard_normal(c.shape), 0.0))
    for kw in (dict(forward=True, x_is_zero=True, emit_residual=True), dict(forward=False, emit_dot=True)):
        got = fused_smoother.smooth_level(None if kw.get("x_is_zero") else x, b, c, config, blocks=blocks, **kw)
        want = fused_smoother.smooth_level(None if kw.get("x_is_zero") else x, b, c, config, blocks=host_blocks,
                                           **kw)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    beta = torch.tensor(0.37, dtype=torch.float64)
    ops = (c.diag, c.ew0, c.ew1, c.ew2)
    step = fused_cg.search_matvec_dot(x, b, beta, *ops, tiles=tiles)
    assert all(torch.equal(g, w) for g, w in zip(step, fused_cg.search_matvec_dot(x, b, beta, *ops, tiles=host)))
    assert torch.equal(fused_cg.residual(x, b, *ops, tiles=tiles), fused_cg.residual(x, b, *ops, tiles=host))
    # A lone band pass over the padded list writes the band cells only.
    out = torch.full_like(x, 7.0)
    fused_smoother.band_pass_torch(x, out, b, c, tiles.band, config.jacobi_damping)
    want = fused_smoother.band_pass_torch(x, torch.full_like(x, 7.0), b, c, host.band, config.jacobi_damping)
    assert torch.equal(out, want) and bool((out[c.band == 0] == 7.0).all())


@pytest.fixture(scope="module")
def jax_fused():
    """The JAX package's `run_fused` of each scene, run once."""
    cache = {}

    def get(name):
        if name not in cache:
            scene, n, frames, chunk, dt, _ = SCENES[name]
            phi, velocity, weights = scene(n)
            cache[name] = jax_sim.run_fused(
                jnp.asarray(phi), tuple(map(jnp.asarray, velocity)), weights, num_frames=frames, dt=dt,
                chunk=chunk, config=JaxConfig(**CONFIG),
            )
        return cache[name]

    return get


def _close(got, want, tol):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=tol)


@pytest.mark.parametrize("name", list(SCENES))
def test_emulated_frames_match_jax_run_fused(jax_fused, name, monkeypatch):
    scene, n, frames, chunk, dt, fused_chunks = SCENES[name]
    phi, velocity, weights = scene(n)
    built = []

    class Counted(graph.EmulatedFrame):
        def __init__(self, *args, **kw):
            built.append(1)
            super().__init__(*args, **kw)

    assert simulate.frame_runner("cpu") is graph.EmulatedFrame
    monkeypatch.setattr(simulate, "frame_runner", lambda device: Counted)
    done = []
    f_phi, f_vel, f_pressure, stats = simulate.run_fused(
        phi, velocity, weights, num_frames=frames, dt=dt, config=SolverConfig(**CONFIG), chunk=chunk,
        on_chunk=lambda k, s: done.append(k), device="cpu",
    )
    assert done == fused_chunks
    # One frame per frozen geometry: the splash keeps its geometry; each of
    # the lone drop's chunks breaks it, and the next chunk freezes anew.
    assert len(built) == (1 if fused_chunks else frames // chunk)
    j_phi, j_vel, j_pressure, j_stats = jax_fused(name)
    assert list(stats["iterations"]) == [int(i) for i in j_stats["iterations"]]
    _close(f_phi, j_phi, PHI_TOL)
    _close(f_pressure, j_pressure, FIELD_TOL)
    for a in range(3):
        _close(f_vel[a], j_vel[a], FIELD_TOL)
    assert all(stats["max_divergence"] < 1e-5)


class _Recorded:
    """A frame runner whose loop does what a capture records (one
    iteration of each parity, whatever `running` says) and whose launch
    runs the frame with every host read of a tensor made to raise."""

    READS = ("item", "tolist", "__bool__", "__int__", "__float__", "__index__", "cpu", "numpy")

    def __init__(self, frame, device, prepare=None):
        self.frame = frame
        if prepare is not None:
            prepare()

    @staticmethod
    def loop(cg, s):
        pair = (s.p, torch.empty_like(s.p))
        for parity in (0, 1):
            s.p = pair[parity]
            cg.tail(s)
            cg.head(s, pair[1 - parity])

    def launch(self):
        saved = {name: getattr(torch.Tensor, name) for name in self.READS}

        def refuse(name):
            def read(*args, **kw):
                raise AssertionError(f"a host read inside the frame: Tensor.{name}")
            return read

        try:
            for name in self.READS:
                setattr(torch.Tensor, name, refuse(name))
            self.frame(self.loop)
        finally:
            for name, fn in saved.items():
                setattr(torch.Tensor, name, fn)

    def close(self):
        pass


def test_a_frame_reads_nothing_on_the_host(monkeypatch):
    phi, velocity, weights = _splash(16)
    monkeypatch.setattr(simulate, "frame_runner", lambda device: _Recorded)
    _, _, pressure, stats = simulate.run_fused(
        phi, velocity, weights, num_frames=2, dt=1.0 / 60.0, config=SolverConfig(), chunk=2, device="cpu",
    )
    # Each frame ran its first iteration and one of each parity.
    assert list(stats["iterations"]) == [3, 3] and bool(torch.isfinite(pressure).all())
