"""The chunk kernel's tiles and chunk plan (ops/fused_smoother.py), on the CPU.

The CUDA chunk kernel (csrc/smoother.cu) runs a chunk of passes per launch
on the tiles that `level_tiles` lists as active and leaves the others at
the zeros its buffers start from; it runs only on the card
(tests/test_torch_cuda.py).  Here:

  * the active- and dead-tile lists and the band cells against a
    brute-force occupancy, on a 40^3 splash, on a stacked block-mesh grid
    and on shapes the tiles do not divide: padded to their capacities,
    their lengths in `Tiles.counts`;
  * the chunk plan against the JAX package's chunking (the chunks
    `smooth_level_pallas` hands to `fused_smooth`) and its spare-ring rule
    (`residual_fusable` and the ValueError of `fused_smooth`), with the same
    refusals;
  * the plain version's output is zero on every cell outside the active
    tiles, next to JAX's `smooth_level_pallas` in interpret mode (atol 2e-6,
    the JAX package's own fp32 tolerance, tests/test_pallas_smoother.py).
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geometricmultigridpressuresolver_tpu.config import SolverConfig as JaxConfig
from geometricmultigridpressuresolver_tpu.ops import pallas_smoother
from geometricmultigridpressuresolver_tpu.solver import mg as jax_mg
from geometricmultigridpressuresolver_tpu_torch import interop
from geometricmultigridpressuresolver_tpu_torch.config import SolverConfig
from geometricmultigridpressuresolver_tpu_torch.models import free_surface, sdf
from geometricmultigridpressuresolver_tpu_torch.ops import fused_smoother
from geometricmultigridpressuresolver_tpu_torch.parallel import fused_sharded, halo, make_mesh
from tests import helpers

torch.set_num_threads(1)
H = pallas_smoother.H


def _brute_force(cells: torch.Tensor, core):
    """(active, dead) tile indices, x-major, by looking at every tile."""
    grid = [-(-n // t) for n, t in zip(cells.shape, core)]
    active, dead = [], []
    for n, (i, j, k) in enumerate(itertools.product(*(range(g) for g in grid))):
        box = cells[i * core[0]:(i + 1) * core[0], j * core[1]:(j + 1) * core[1], k * core[2]:(k + 1) * core[2]]
        (active if bool(box.any()) else dead).append(n)
    return active, dead


def _assert_tiles(tiles, cells):
    """The lists against the brute force: their lengths in `counts`, and
    each padded to its capacity with the capacity as the sentinel."""
    active, dead = _brute_force(cells, tiles.core)
    assert tiles.active.dtype == tiles.dead.dtype == tiles.counts.dtype == torch.int32
    got_active, got_dead, got_band = fused_smoother.trimmed(tiles)
    assert got_active.tolist() == active and got_dead.tolist() == dead
    n_tiles, n_cells = len(active) + len(dead), cells.numel()
    assert tiles.active.numel() == tiles.dead.numel() == n_tiles and tiles.band.numel() == n_cells
    assert tiles.counts.tolist() == [len(active), len(dead), got_band.numel()]
    for t, n, cap in ((tiles.active, len(active), n_tiles), (tiles.dead, len(dead), n_tiles),
                      (tiles.band, got_band.numel(), n_cells)):
        assert (t[n:] == cap).all() and (t[:n] < cap).all()
    assert tiles.shape == tuple(cells.shape)


@pytest.fixture(scope="module")
def splash40():
    n = 40
    phi, _ = sdf.splash_scene((n, n, n), device="cpu")
    setup = free_surface.build_setup(phi, sdf.open_box_weights((n, n, n), device="cpu"), config=SolverConfig())
    return setup.problem.hier


@pytest.mark.parametrize("level", [0, 1])
def test_active_tiles_of_a_splash_match_brute_force(splash40, level):
    c = splash40.levels[level]
    blocks = fused_smoother.level_blocks(c, SolverConfig())
    tiles = blocks.tiles
    assert (tiles.depth, tiles.core) == (fused_smoother.CHUNK_DEPTH, fused_smoother.CHUNK_TILE)
    assert 0 < int(tiles.counts[0])
    _assert_tiles(tiles, c.solvable)
    assert torch.equal(tiles.band, blocks.band_cells)


def test_active_tiles_of_a_stacked_grid_match_brute_force(splash40):
    """The stacked haloed blocks of a (2, 2, 1) block mesh: active where a
    cell has inv_diag != 0 or band != 0 (no `solvable` is stacked)."""
    c = splash40.levels[0]
    hc = fused_sharded.prehalo_coeffs(c, make_mesh(4, device="cpu"))
    assert hc.solvable is None
    blocks = fused_sharded.stacked_blocks(hc)
    assert blocks.band_cells is None and blocks.narrow is None
    cells = (hc.inv_diag != 0) | (hc.band != 0)
    _assert_tiles(blocks.tiles, cells)
    np.testing.assert_array_equal(fused_smoother.trimmed(blocks.tiles)[2].numpy(), np.flatnonzero(hc.band.numpy()))
    # Every solvable global cell lies in some active stacked tile.
    geom = halo.geometry(make_mesh(4, device="cpu"), c.shape)
    occupied = torch.zeros(hc.inv_diag.shape, dtype=torch.bool)
    lx, ty, tz = blocks.tiles.core
    gy, gz = (-(-n // t) for n, t in zip(hc.inv_diag.shape[1:], (ty, tz)))
    for t in fused_smoother.trimmed(blocks.tiles)[0].tolist():
        i, j, k = t // (gy * gz), t // gz % gy, t % gz
        occupied[i * lx:(i + 1) * lx, j * ty:(j + 1) * ty, k * tz:(k + 1) * tz] = True
    assert torch.equal(halo.core_scatter(occupied.to(torch.int8), geom).bool() | ~c.solvable, torch.ones_like(c.solvable))


@pytest.mark.parametrize("shape", [(37, 29, 45), (17, 9, 33), (5, 70, 130), (1, 1, 1)])
def test_active_tiles_on_ragged_shapes_match_brute_force(shape):
    rng = np.random.default_rng(sum(shape))
    cells = torch.from_numpy(rng.random(shape) < 0.02)
    band = torch.from_numpy(rng.random(shape) < 0.01).to(torch.int8)
    tiles = fused_smoother.level_tiles(cells, fused_smoother.band_cells(band))
    assert tiles.core == fused_smoother.CHUNK_TILE
    _assert_tiles(tiles, cells)
    np.testing.assert_array_equal(fused_smoother.trimmed(tiles)[2].numpy(), np.flatnonzero(band.numpy()))


def _kernel_cells(tiles, color):
    """The flat cells the chunk kernel's `for_active_cells` (csrc/smoother.cu)
    visits over the active tiles, with `color` -1 (all) or 0/1, by its shift
    arithmetic."""
    lxs, tys, tzs = (int(t).bit_length() - 1 for t in tiles.core)
    nx, ny, nz = tiles.shape
    _, gy, gz = fused_smoother.tile_grid(tiles.shape, tiles.core)
    zs = tzs - 1 if color >= 0 else tzs
    n = np.arange((1 << (lxs + tys + tzs)) >> int(color >= 0))
    out = []
    for tile in fused_smoother.trimmed(tiles)[0].tolist():
        x0, y0, z0 = tile // (gy * gz) << lxs, tile // gz % gy << tys, tile % gz << tzs
        i = x0 + (n >> (tys + zs))
        j = y0 + ((n >> zs) & ((1 << tys) - 1))
        k = z0 + (n & ((1 << zs) - 1))
        if color >= 0:
            k = z0 + 2 * (k - z0) + ((color + i + j + z0) & 1)
        keep = (i < nx) & (j < ny) & (k < nz)
        out.append(((i * ny + j) * nz + k)[keep])
    return np.concatenate(out)


@pytest.mark.parametrize("depth", range(1, 9))
@pytest.mark.parametrize("shape", [(9, 10, 11), (16, 8, 64), (3, 17, 70)])
def test_tiles_take_any_depth_and_power_of_two_tiles(depth, shape):
    """The chunk kernel indexes a tile's cells with shifts: CHUNK_TILE's
    extents are powers of two, z at least 2 (a colour takes every other z),
    and the shifts visit each cell of the grid (of a colour) once; any
    depth up to H runs in one launch per chunk of the plan."""
    core = fused_smoother.CHUNK_TILE
    assert all(t >= 1 and not t & (t - 1) for t in core) and core[2] >= 2
    cells = torch.ones(shape, dtype=torch.bool)
    tiles = fused_smoother.level_tiles(cells, torch.zeros(0, dtype=torch.int32), depth)
    assert tiles.depth == depth and tiles.core == core
    grid = fused_smoother.tile_grid(cells.shape, core)
    assert tiles.active.tolist() == list(range(grid[0] * grid[1] * grid[2]))
    assert sum(ch.stop - ch.start for ch in fused_smoother.chunk_plan(8, depth)) == 8
    i, j, k = np.indices(shape)
    flat = np.arange(cells.numel())
    np.testing.assert_array_equal(np.sort(_kernel_cells(tiles, -1)), flat)
    for color in (0, 1):
        want = flat[((i + j + k) % 2 == color).ravel()]
        np.testing.assert_array_equal(np.sort(_kernel_cells(tiles, color)), want)


def _jax_chunks(monkeypatch, config, x_is_zero, emit_residual, emit_dot):
    """The (schedule, zero_x, emit_residual, emit_dot) of every fused_smooth
    launch that smooth_level_pallas makes (the launches are recorded, not run)."""
    calls = []

    def record(x, b, inv_diag, ew0, ew1, ew2, band, schedule, *args, zero_x=False, emit_residual=False,
               emit_dot=False, **kw):
        calls.append((tuple(schedule), zero_x, emit_residual, emit_dot))
        extra = (x,) * emit_residual + (jnp.zeros(()),) * emit_dot
        return (x,) + extra if extra else x

    monkeypatch.setattr(pallas_smoother, "fused_smooth", record)
    coeffs = type("C", (), {"band": jnp.zeros((2, 2, 2)), "inv_diag": jnp.zeros((2, 2, 2)),
                            "ew0": None, "ew1": None, "ew2": None, "solvable": None, "shape": (2, 2, 2)})()
    pallas_smoother.smooth_level_pallas(
        jnp.zeros((2, 2, 2)), jnp.zeros((2, 2, 2)), coeffs, config, True, emit_dot=emit_dot,
        blocks=(None, None, None), x_is_zero=x_is_zero, emit_residual=emit_residual,
    )
    return calls


@pytest.mark.parametrize("boundary_iterations, gs", [(0, True), (3, True), (3, False), (4, True), (7, True), (8, False)])
@pytest.mark.parametrize("x_is_zero, emit_residual", [(False, False), (True, False), (True, True), (False, True)])
def test_chunk_plan_matches_jax_chunking(monkeypatch, boundary_iterations, gs, x_is_zero, emit_residual):
    """At depth H the port's plan is the JAX chunking, with the zero start on
    the first chunk, the residual on the last; where the JAX spare-ring
    rule refuses the residual, `residual_fits` says so."""
    jcfg = JaxConfig(boundary_iterations=boundary_iterations, use_gauss_seidel=gs, pallas_band_strip=0)
    tcfg = SolverConfig(boundary_iterations=boundary_iterations, use_gauss_seidel=gs)
    schedule = fused_smoother.schedule_for(tcfg, True)
    assert schedule == pallas_smoother.schedule_for(jcfg, True)
    fits = fused_smoother.residual_fits(len(schedule), H, x_is_zero)
    if emit_residual and not fits:
        # The JAX kernel refuses this chunk: no spare ring for the residual.
        last = fused_smoother.chunk_plan(len(schedule), H, x_is_zero, True)[-1]
        x = jnp.zeros((32, 32, 128))
        with pytest.raises(ValueError, match="spare halo ring"):
            pallas_smoother.fused_smooth(
                x, x, x, x, x, x, x.astype(jnp.int8), schedule[last.start:last.stop],
                zero_x=last.zero, emit_residual=True,
            )
        assert last.ring == H + 1
        return
    want = _jax_chunks(monkeypatch, jcfg, x_is_zero, emit_residual, True)
    got = fused_smoother.chunk_plan(len(schedule), H, x_is_zero, emit_residual)
    assert [(schedule[ch.start:ch.stop], ch.zero, ch.residual) for ch in got] == [w[:3] for w in want]
    assert [w[3] for w in want] == [ch.stop == len(schedule) for ch in got]  # the dot rides the last chunk
    assert all(ch.ring <= H for ch in got)
    if x_is_zero:
        assert fits == fused_smoother.residual_fusable(tcfg) == pallas_smoother.residual_fusable(jcfg)


def test_chunk_plan_extra_ring_at_the_port_depth():
    """Below H the plan still puts the residual on the last chunk and counts
    the rings it would need (the chunk kernel has no halo, so it never
    refuses): 8 passes at depth 4 from a streamed x end in a 4-pass chunk
    with the residual, 5 rings, more than a depth-4 halo holds."""
    plan = fused_smoother.chunk_plan(8, 4, False, True)
    assert [(ch.start, ch.stop, ch.zero, ch.residual, ch.ring) for ch in plan] == [
        (0, 4, False, False, 4), (4, 8, False, True, 5)
    ]
    plan = fused_smoother.chunk_plan(8, 4, True, True)
    assert [ch.ring for ch in plan] == [3, 5]
    assert [ch.ring for ch in fused_smoother.chunk_plan(8, 8, True, True)] == [8]
    assert not fused_smoother.residual_fits(8, 4, True) and fused_smoother.residual_fits(7, 4, True)


@pytest.fixture(scope="module")
def sine32():
    labels, weights, mg_levels = helpers.expanded_domain(helpers.sine_dirichlet_domain, 32, fractional=True)
    hier = jax_mg.build_hierarchy(labels, weights, mg_levels, JaxConfig(solve_dtype=jnp.float32))
    cj = hier.levels[0]
    ct = interop.level_from_arrays({f: np.asarray(getattr(cj, f)) for f in cj._fields}, device="cpu")
    rng = np.random.default_rng(3)
    solv = np.asarray(cj.solvable)
    x = np.where(solv, rng.standard_normal(cj.shape), 0.0).astype(np.float32)
    b = np.where(solv, rng.standard_normal(cj.shape), 0.0).astype(np.float32)
    return cj, ct, x, b


@pytest.mark.parametrize("variant", ["down", "up_dot"])
def test_plain_output_is_zero_outside_the_active_tiles(sine32, variant):
    """What a dead tile stores (zeros) is the pass sequence's output there:
    the plain version, next to the Pallas kernel in interpret mode."""
    cj, ct, x, b = sine32
    kw = {"down": dict(forward=True, x_is_zero=True, emit_residual=True),
          "up_dot": dict(forward=False, emit_dot=True)}[variant]
    tcfg = SolverConfig(solve_dtype=torch.float32)
    tiles = fused_smoother.level_tiles(ct.solvable, fused_smoother.band_cells(ct.band))
    grid = fused_smoother.tile_grid(ct.shape, tiles.core)
    n_active = int(tiles.counts[0])
    assert 0 < n_active < grid[0] * grid[1] * grid[2]
    xt = None if kw.get("x_is_zero") else torch.from_numpy(x)
    got = fused_smoother.smooth_level_torch(xt, torch.from_numpy(b), ct, tcfg, **kw)
    ref = pallas_smoother.smooth_level_pallas(
        jnp.zeros_like(jnp.asarray(x)) if xt is None else jnp.asarray(x), jnp.asarray(b), cj,
        JaxConfig(solve_dtype=jnp.float32), interpret=True, **kw,
    )
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), atol=2e-6)
    # The cells of the dead tiles.
    lx, ty, tz = tiles.core
    gy, gz = grid[1:]
    dead = torch.ones(ct.shape, dtype=torch.bool)
    for t in tiles.active[:n_active].tolist():
        i, j, k = t // (gy * gz), t // gz % gy, t % gz
        dead[i * lx:(i + 1) * lx, j * ty:(j + 1) * ty, k * tz:(k + 1) * tz] = False
    assert dead.any()
    assert (got[0][dead] == 0).all() and (np.asarray(ref[0])[dead.numpy()] == 0).all()
    if kw.get("emit_residual"):
        assert (got[1][dead] == 0).all()
