"""The tiles of the CG-step and residual kernels (ops/fused_cg.py), on the CPU.

The CUDA kernels (csrc/cg.cu) do stencil work only on the active tiles of a
level's `Tiles` and store zeros on the dead ones; they run only on the card
(tests/test_torch_cuda.py).  Here:

  * on the JAX-built 32^3 fixture of tests/test_torch_cg_kernels.py, the
    plain CG step and residual are zero on every cell outside the active
    tiles (as the Pallas kernels' outputs are, in interpret mode), and the
    dot over the active tiles is the full dot (1e-12 in fp64);
  * the dead-tile lists (padded, their lengths in `Tiles.counts`) and the
    ticket of `level_tiles`, and the stacked CG tiles of a block mesh
    (`diag != 0` on `prehalo_cg_coeffs`), against a brute-force occupancy;
  * the wrappers with `tiles=` on CPU tensors are the plain versions and
    count no launch; tiles of another grid or tile are refused;
  * the solve hands the fine level's tiles to both kernels: those of the
    V-cycle's block lists (a sharded level keeps the tiles of its own grid).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geometricmultigridpressuresolver_tpu.ops import pallas_cg
from geometricmultigridpressuresolver_tpu_torch.config import SolverConfig
from geometricmultigridpressuresolver_tpu_torch.models import free_surface, sdf
from geometricmultigridpressuresolver_tpu_torch.ops import fused_cg, fused_smoother
from geometricmultigridpressuresolver_tpu_torch.parallel import fused_sharded, make_mesh
from geometricmultigridpressuresolver_tpu_torch.solver import mg, mgpcg
from tests.test_torch_cg_kernels import _fixture
from tests.test_torch_tiles import _brute_force

torch.set_num_threads(1)

COUNTERS = (fused_cg.STEP_LAUNCHES, fused_cg.SHARDED_STEP_LAUNCHES, fused_cg.RESIDUAL_LAUNCHES)


def _tiles(c):
    return fused_smoother.level_tiles(c.solvable, fused_smoother.band_cells(c.band))


def _dead_cells(tiles) -> torch.Tensor:
    """(nx, ny, nz) bool: the cells outside the active tiles."""
    lx, ty, tz = tiles.core
    _, gy, gz = fused_smoother.tile_grid(tiles.shape, tiles.core)
    dead = torch.ones(tiles.shape, dtype=torch.bool)
    for t in fused_smoother.trimmed(tiles)[0].tolist():
        i, j, k = t // (gy * gz), t // gz % gy, t % gz
        dead[i * lx:(i + 1) * lx, j * ty:(j + 1) * ty, k * tz:(k + 1) * tz] = False
    return dead


@pytest.fixture(scope="module")
def fixtures():
    return {np.float32: _fixture(np.float32), np.float64: _fixture(np.float64)}


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_plain_cg_step_and_residual_are_zero_outside_the_tiles(fixtures, dtype):
    """What a dead tile stores (zeros) is the plain functions' output there;
    the dot over the active tiles is the dot over every cell."""
    cj, ct, z, p = fixtures[dtype]
    tiles = _tiles(ct)
    dead = _dead_cells(tiles)
    assert dead.any() and 0 < int(tiles.counts[0])
    beta = torch.tensor(0.7371, dtype=torch.from_numpy(z).dtype)
    ops = (ct.diag, ct.ew0, ct.ew1, ct.ew2)
    pn, ap, dot = fused_cg.search_matvec_dot_torch(torch.from_numpy(z), torch.from_numpy(p), beta, *ops)
    r = fused_cg.residual_torch(torch.from_numpy(z), torch.from_numpy(p), *ops)
    for g in (pn, ap, r):
        assert (g[dead] == 0).all()
    active_dot = torch.sum((pn * ap)[~dead])
    if dtype == np.float64:
        np.testing.assert_allclose(float(active_dot), float(dot), rtol=1e-12)
    else:
        np.testing.assert_allclose(float(active_dot), float(dot), rtol=1e-5)
        # The Pallas kernels, in interpret mode, leave the same cells zero.
        jops = (cj.diag, cj.ew0, cj.ew1, cj.ew2)
        pn_j, ap_j, _ = pallas_cg.fused_search_matvec_dot(
            jnp.asarray(z), jnp.asarray(p), np.float32(0.7371), *jops, interpret=True
        )
        r_j = pallas_cg.fused_residual(jnp.asarray(z), jnp.asarray(p), *jops, interpret=True)
        for g in (pn_j, ap_j, r_j):
            assert (np.asarray(g)[dead.numpy()] == 0).all()


@pytest.mark.parametrize("shape", [(37, 29, 45), (17, 9, 33), (5, 70, 130), (1, 1, 1)])
def test_level_tiles_list_the_dead_tiles_and_a_zero_ticket(shape):
    rng = np.random.default_rng(sum(shape) + 2)
    cells = torch.from_numpy(rng.random(shape) < 0.02)
    tiles = fused_smoother.level_tiles(cells, torch.zeros(0, dtype=torch.int32))
    active, dead = _brute_force(cells, tiles.core)
    got_active, got_dead, got_band = fused_smoother.trimmed(tiles)
    assert got_active.tolist() == active and got_dead.tolist() == dead and got_band.numel() == 0
    assert tiles.dead.dtype == torch.int32 and tiles.dead.numel() == len(active) + len(dead)
    assert tiles.counts.tolist() == [len(active), len(dead), 0]
    assert tiles.ticket.dtype == torch.int32 and tiles.ticket.tolist() == [0]


def test_stacked_cg_tiles_match_brute_force(fixtures):
    """The CG step's tiles of the stacked haloed blocks of a (2, 2, 1) block
    mesh: active where a cell has diag != 0 (no `solvable` is stacked)."""
    _, ct, _, _ = fixtures[np.float64]
    hcg = fused_sharded.prehalo_cg_coeffs(ct, make_mesh(4, device="cpu"))
    tiles = fused_sharded.stacked_cg_tiles(hcg)
    cells = hcg[0] != 0
    active, dead = _brute_force(cells, tiles.core)
    assert tiles.shape == tuple(hcg[0].shape) and tiles.core == fused_smoother.CHUNK_TILE
    got_active, got_dead, got_band = fused_smoother.trimmed(tiles)
    assert got_active.tolist() == active and got_dead.tolist() == dead
    assert 0 < len(active) and 0 < len(dead) and got_band.numel() == 0


@pytest.mark.parametrize("which", ["cg_step", "cg_step_window", "residual"])
def test_wrappers_with_tiles_on_cpu(fixtures, which):
    """CPU tensors with `tiles=` run the plain version exactly, under "auto"
    and "torch", and count no launch."""
    _, ct, z, p = fixtures[np.float64]
    zt, pt = torch.from_numpy(z), torch.from_numpy(p)
    ops = (ct.diag, ct.ew0, ct.ew1, ct.ew2)
    tiles = _tiles(ct)
    beta = torch.tensor(0.5, dtype=torch.float64)
    window = fused_cg.CoreWindow(16, 2, 14, 3, 30) if which == "cg_step_window" else None
    before = [c.count for c in COUNTERS]
    for mode in ("auto", "torch"):
        if which == "residual":
            assert torch.equal(fused_cg.residual(zt, pt, *ops, mode=mode, tiles=tiles),
                               fused_cg.residual_torch(zt, pt, *ops))
        else:
            got = fused_cg.search_matvec_dot(zt, pt, beta, *ops, mode=mode, window=window, tiles=tiles)
            want = fused_cg.search_matvec_dot_torch(zt, pt, beta, *ops, window=window)
            assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert [c.count for c in COUNTERS] == before


def test_kernel_tiles_refuses_tiles_of_another_grid(fixtures):
    """The grid and tile checks run before any device check; None builds
    the tiles of the cells with diag != 0."""
    _, ct, _, _ = fixtures[np.float64]
    tiles = _tiles(ct)
    other = _tiles(ct._replace(solvable=ct.solvable[:31]))
    with pytest.raises(ValueError, match="tiles built for"):
        fused_cg.kernel_tiles("cg", other, ct.diag)
    with pytest.raises(ValueError, match="the kernels take"):
        fused_cg.kernel_tiles("cg", tiles._replace(core=(8, 8, 16)), ct.diag)
    built = fused_cg.kernel_tiles("cg", None, ct.diag)
    assert torch.equal(built.active, fused_smoother.level_tiles(ct.diag != 0, tiles.band).active)
    assert built.shape == tiles.shape and built.core == tiles.core


@pytest.fixture(scope="module")
def splash40():
    n = 40
    phi, _ = sdf.splash_scene((n, n, n), device="cpu")
    return free_surface.build_setup(phi, sdf.open_box_weights((n, n, n), device="cpu"), config=SolverConfig())


def test_solve_hands_the_fine_tiles_to_the_kernels(splash40):
    """`mgpcg.fine_tiles`: the V-cycle's level-0 tiles, or built from the
    solvable set; a sharded level's block lists keep the tiles of its own
    grid beside the stacked ones."""
    problem, cfg = splash40.problem, SolverConfig()
    fine = problem.fine
    own = mgpcg.fine_tiles(problem)
    active, dead = _brute_force(fine.solvable, own.core)
    got_active, got_dead, _ = fused_smoother.trimmed(own)
    assert got_active.tolist() == active and got_dead.tolist() == dead
    blocks = mg.hierarchy_block_lists(problem.hier, cfg)
    assert mgpcg.fine_tiles(problem, blocks) is blocks[0].tiles
    assert torch.equal(blocks[0].tiles.active, own.active)
    mesh = make_mesh(4, device="cpu")
    flags = mg.level_flags(problem.hier, cfg, mesh)
    assert flags[0] == "sharded"
    sharded = mg.hierarchy_block_lists(problem.hier, cfg, mesh)
    assert isinstance(sharded[0], fused_sharded.ShardedBlocks)
    assert sharded[0].tiles.shape == fine.shape and torch.equal(sharded[0].tiles.active, own.active)
    assert sharded[0].blocks.tiles.shape == tuple(sharded[0].prehaloed.diag.shape)
