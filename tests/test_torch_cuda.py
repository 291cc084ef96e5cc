"""The CUDA kernels against their plain versions, on the card.

Marked `cuda`: these need an NVIDIA GPU with nvcc and skip elsewhere (a
CUDA kernel has no interpret mode).  On a GPU machine:

    python -m pytest tests/test_torch_cuda.py -q --noconftest

(--noconftest: tests/conftest.py configures JAX, which a GPU machine
without JAX cannot import; this file needs only the port.)

Tolerances: fp32 kernels differ from the plain versions by FMA contraction
and summation order -- 1e-5 relative (to the field's max) on grids, 1e-4 on
dots; fp64 kernels 1e-12.  bf16-field blocks compute in fp32 and round
once, so kernel and plain differ by at most one bf16 ulp at the output's
scale (plus the fp32 term).
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

from geometricmultigridpressuresolver_tpu_torch import parallel
from geometricmultigridpressuresolver_tpu_torch.config import SolverConfig
from geometricmultigridpressuresolver_tpu_torch.models import free_surface, sdf, simulate
from geometricmultigridpressuresolver_tpu_torch.grids import face_shape
from geometricmultigridpressuresolver_tpu_torch.ops import domain, fused_cg, fused_smoother, stencil
from geometricmultigridpressuresolver_tpu_torch.parallel import fused_sharded, halo
from geometricmultigridpressuresolver_tpu_torch.solver import mg, mgpcg

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU or interpret mode")
    return torch.device("cuda", 0)


def _rel(got, want) -> float:
    diff = float((got.double() - want.double()).abs().max())
    return diff / max(float(want.double().abs().max()), 1e-300)


def _sine_domain(n=32, seed=0):
    """The sine-Dirichlet fixture of tests/helpers.py (expanded, with 20% of
    the faces given fractional weights), built with the port alone."""
    x, y, z = np.meshgrid(*[(np.arange(n) + 0.5) / n] * 3, indexing="ij")
    phi = x - 0.5 + 0.25 * np.sin(2 * np.pi * y + 4 * np.pi * z)
    base = torch.from_numpy(np.where(phi <= 0, 2, 1).astype(np.int8))
    expanded, _, mg_levels = domain.expand_domain(base)
    lab = expanded.numpy()
    rng = np.random.default_rng(seed)
    weights = []
    for axis in range(3):
        w = np.zeros(face_shape(lab.shape, axis))
        lo = [slice(None)] * 3
        hi = [slice(None)] * 3
        inner = [slice(None)] * 3
        lo[axis], hi[axis], inner[axis] = slice(0, -1), slice(1, None), slice(1, -1)
        w[tuple(inner)] = ((lab[tuple(lo)] != 0) & (lab[tuple(hi)] != 0)).astype(float)
        mask = (w == 1.0) & (rng.random(w.shape) < 0.2)
        w[mask] = 0.25 + 0.75 * rng.random(w.shape)[mask]
        weights.append(torch.from_numpy(w))
    return domain.set_boundary_labels(expanded, weights), weights, mg_levels


def _level(device, dtype, ew_dtype):
    labels, weights, mg_levels = _sine_domain()
    cfg = SolverConfig(solve_dtype=dtype, mg_ew_dtype=ew_dtype)
    hier = mg.build_hierarchy(labels, weights, mg_levels, cfg, device=device)
    gen = torch.Generator(device=device).manual_seed(1)
    c = hier.levels[0]
    x = torch.where(c.solvable, torch.randn(c.shape, generator=gen, device=device, dtype=dtype), 0)
    b = torch.where(c.solvable, torch.randn(c.shape, generator=gen, device=device, dtype=dtype), 0)
    return c, x, b, cfg


CASES = [(torch.float32, torch.bfloat16, 1e-5, 1e-4), (torch.float32, None, 1e-5, 1e-4),
         (torch.float64, None, 1e-12, 1e-12)]


@pytest.mark.parametrize("dtype, ew_dtype, grid_tol, dot_tol", CASES)
@pytest.mark.parametrize("variant", ["down", "up_dot", "warm", "jacobi"])
def test_smoother_kernel_matches_plain(device, dtype, ew_dtype, grid_tol, dot_tol, variant):
    c, x, b, cfg = _level(device, dtype, ew_dtype)
    kw = {
        "down": dict(forward=True, x_is_zero=True, emit_residual=True),
        "up_dot": dict(forward=False, emit_dot=True),
        "warm": dict(forward=True),
        "jacobi": dict(forward=True, emit_dot=True),
    }[variant]
    if variant == "jacobi":
        cfg = SolverConfig(solve_dtype=dtype, mg_ew_dtype=ew_dtype, use_gauss_seidel=False)
    xin = None if kw.get("x_is_zero") else x
    before = fused_smoother.PASS_LAUNCHES.count
    got = fused_smoother.smooth_level(xin, b, c, cfg, **kw)
    torch.cuda.synchronize()
    chunks = fused_smoother.chunk_plan(
        len(fused_smoother.schedule_for(cfg, kw["forward"])), fused_smoother.CHUNK_DEPTH
    )
    assert fused_smoother.PASS_LAUNCHES.count - before == len(chunks)
    want = fused_smoother.smooth_level_torch(xin, b, c, cfg, **kw)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert _rel(got[0], want[0]) <= grid_tol
    if kw.get("emit_residual"):
        assert _rel(got[1], want[1]) <= grid_tol
    if kw.get("emit_dot"):
        assert _rel(got[-1], want[-1]) <= dot_tol
    assert (got[0][~c.solvable] == 0).all()


@pytest.mark.parametrize("dtype, ew_dtype, grid_tol, dot_tol", CASES)
def test_cg_step_and_residual_kernels_match_plain(device, dtype, ew_dtype, grid_tol, dot_tol):
    """With the tiles a solve passes, and without tiles (built in the call
    from diag != 0: the same tiles here, so the same bits)."""
    c, z, p, _ = _level(device, dtype, ew_dtype)
    beta = torch.tensor(0.37, dtype=dtype, device=device)
    tiles = _cg_tiles(c)
    grid = fused_smoother.tile_grid(c.shape, tiles.core)
    assert 0 < int(tiles.counts[0]) < grid[0] * grid[1] * grid[2]
    assert torch.equal(tiles.active, fused_smoother.level_tiles(c.diag != 0, tiles.band).active)
    with_tiles = _check_cg_kernels(c, z, p, beta, tiles, grid_tol, dot_tol)
    without = _check_cg_kernels(c, z, p, beta, None, grid_tol, dot_tol)
    for g, w in zip(with_tiles[0] + (with_tiles[1],), without[0] + (without[1],)):
        assert torch.equal(g, w)


def test_wrappers_refuse_bad_operands(device):
    c, x, b, cfg = _level(device, torch.float32, None)
    with pytest.raises(ValueError, match="not contiguous"):
        fused_cg.residual(x.transpose(0, 1), b, c.diag, c.ew0, c.ew1, c.ew2, mode="cuda")
    with pytest.raises(TypeError, match="mixed field dtypes"):
        fused_cg.residual(x.double(), b, c.diag, c.ew0, c.ew1, c.ew2, mode="cuda")
    with pytest.raises(ValueError, match="shape"):
        fused_cg.residual(x[:-1].contiguous(), b, c.diag, c.ew0, c.ew1, c.ew2, mode="cuda")


def test_projection_kernels_match_plain_fp64(device):
    n = 24
    phi, velocity = sdf.splash_scene((n, n, n), device=device)
    weights = sdf.open_box_weights((n, n, n), device=device)
    cfg = SolverConfig(tolerance=1e-9)
    setup = free_surface.build_setup(phi, weights, config=cfg)
    fused_cg.STEP_LAUNCHES.reset()
    got = free_surface.project(setup, velocity, config=cfg)
    assert fused_cg.STEP_LAUNCHES.count == got.cg.iterations > 0
    want = free_surface.project(setup, velocity, config=SolverConfig(tolerance=1e-9, kernel_mode="torch"))
    assert got.cg.iterations == want.cg.iterations
    assert _rel(got.pressure, want.pressure) <= 1e-10
    np.testing.assert_array_less(float(got.max_divergence), 1e-6)


def _bf16_bound(want) -> float:
    scale = float(want.double().abs().max())
    return 2.0 ** (math.floor(math.log2(scale)) - 7) + 1e-5 * scale


@pytest.mark.parametrize("dtype, ew_dtype, grid_tol, dot_tol", CASES)
def test_band_pass_kernel_matches_plain(device, dtype, ew_dtype, grid_tol, dot_tol):
    """A lone `b` pass in the chunk kernel is the band-restricted pass: the
    update on the band cells, x itself everywhere else."""
    c, x, b, cfg = _level(device, dtype, ew_dtype)
    cells = fused_smoother.band_cells(c.band)
    before = fused_smoother.PASS_LAUNCHES.count
    got = fused_smoother.smooth_level(x, b, c, cfg, True, schedule=("b",))
    torch.cuda.synchronize()
    assert fused_smoother.PASS_LAUNCHES.count - before == 1
    want = fused_smoother.band_pass_torch(x, x.clone(), b, c, cells, cfg.jacobi_damping)
    assert _rel(got, want) <= grid_tol
    assert torch.equal(got[~c.band.bool()], x[~c.band.bool()])


@pytest.mark.parametrize("dtype, ew_dtype, grid_tol, dot_tol", CASES)
@pytest.mark.parametrize("variant", ["down", "up_dot", "warm"])
def test_band_restricted_block_matches_full_kernel(device, dtype, ew_dtype, grid_tol, dot_tol, variant):
    c, x, b, cfg = _level(device, dtype, ew_dtype)
    kw = {
        "down": dict(forward=True, x_is_zero=True, emit_residual=True),
        "up_dot": dict(forward=False, emit_dot=True),
        "warm": dict(forward=True),
    }[variant]
    xin = None if kw.get("x_is_zero") else x
    full_cfg = SolverConfig(solve_dtype=dtype, mg_ew_dtype=ew_dtype, pallas_band_strip=0)
    got = fused_smoother.smooth_level(xin, b, c, cfg, **kw)
    full = fused_smoother.smooth_level(xin, b, c, full_cfg, **kw)
    torch.cuda.synchronize()
    got = got if isinstance(got, tuple) else (got,)
    full = full if isinstance(full, tuple) else (full,)
    for g, f in zip(got, full):
        assert _rel(g, f) <= (grid_tol if g.dim() else dot_tol)


@pytest.mark.parametrize("ew_dtype", [torch.bfloat16, None])
@pytest.mark.parametrize("variant", ["down", "up_dot", "warm", "gs_only"])
def test_bf16_field_kernel_matches_plain(device, ew_dtype, variant):
    c, x, b, cfg = _level(device, torch.float32, ew_dtype)
    kw = {
        "down": dict(forward=True, x_is_zero=True, emit_residual=True),
        "up_dot": dict(forward=False, emit_dot=True),
        "warm": dict(forward=True),
        "gs_only": dict(forward=True),  # the last pass runs in place and narrows
    }[variant]
    if variant == "gs_only":
        cfg = SolverConfig(solve_dtype=torch.float32, mg_ew_dtype=ew_dtype, boundary_iterations=0)
    xin = None if kw.get("x_is_zero") else x.to(torch.bfloat16)
    bh = b.to(torch.bfloat16)
    blocks = fused_smoother.level_blocks(c, cfg, torch.bfloat16)
    before = fused_smoother.NARROW_LAUNCHES.count
    got = fused_smoother.smooth_level(xin, bh, c, cfg, blocks=blocks, **kw)
    torch.cuda.synchronize()
    chunks = fused_smoother.chunk_plan(len(fused_smoother.schedule_for(cfg, kw["forward"])), blocks.tiles.depth)
    assert fused_smoother.NARROW_LAUNCHES.count - before == len(chunks)
    want = fused_smoother.smooth_level_torch(xin, bh, c, cfg, blocks=blocks, **kw)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert got[0].dtype == torch.bfloat16
    for g, w in zip(got, want):
        if g.dim():
            assert g.dtype == torch.bfloat16
            assert float((g.double() - w.double()).abs().max()) <= _bf16_bound(w)
        else:
            assert g.dtype == torch.float32 and _rel(g, w) <= 1e-4
    assert (got[0][~c.solvable] == 0).all()


def test_bf16_residual_kernel_matches_plain(device):
    c, x, b, _ = _level(device, torch.float32, torch.bfloat16)
    bh = b.to(torch.bfloat16)
    got = fused_cg.residual(x, bh, c.diag, c.ew0, c.ew1, c.ew2, mode="cuda")
    torch.cuda.synchronize()
    want = fused_cg.residual_torch(x, bh, c.diag, c.ew0, c.ew1, c.ew2)
    assert got.dtype == want.dtype == torch.bfloat16
    assert float((got.double() - want.double()).abs().max()) <= _bf16_bound(want)


def _sharded_level(device, dtype, ew_dtype):
    """Level 0 of the 32^3 sine fixture (64, 64, 64) on a (2, 2, 1) block
    mesh of the card: 32 x 32 cores."""
    c, x, b, cfg = _level(device, dtype, ew_dtype)
    mesh = parallel.make_mesh(4, device=device)
    return c, x, b, cfg, mesh, halo.geometry(mesh, c.shape)


@pytest.mark.parametrize("mesh_shape", [(2, 2, 1), (4, 2, 1), (1, 4, 1)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64, torch.bfloat16, torch.int8])
def test_halo_kernels_match_plain(device, mesh_shape, dtype):
    gen = torch.Generator(device=device).manual_seed(4)
    t = torch.randint(-100, 100, (64, 48, 40), generator=gen, device=device).to(dtype)
    geom = halo.geometry(parallel.BlockMesh(mesh_shape, device), t.shape)
    before = halo.HALO_LAUNCHES.count
    got = halo.halo_gather(t, geom)
    back = halo.core_scatter(got, geom)
    torch.cuda.synchronize()
    assert halo.HALO_LAUNCHES.count - before == 2
    assert got.dtype == dtype and tuple(got.shape) == geom.stacked_shape
    assert torch.equal(got, halo.halo_gather_torch(t, geom))
    assert torch.equal(back, t)
    assert torch.equal(halo.core_scatter(got, geom), halo.core_scatter_torch(got, geom))


@pytest.mark.parametrize("dtype, ew_dtype, grid_tol, dot_tol", CASES)
def test_core_window_kernels_match_plain(device, dtype, ew_dtype, grid_tol, dot_tol):
    """The smoother and CG step over a stacked grid with the core window:
    kernel vs plain, and the windowed dot is the cores' dot."""
    c, x, b, cfg, mesh, geom = _sharded_level(device, dtype, ew_dtype)
    hc = fused_sharded.prehalo_coeffs(c, mesh)
    xh, bh = halo.halo_gather(x, geom), halo.halo_gather(b, geom)
    full = fused_sharded.stacked_blocks(hc)
    before = fused_smoother.SHARDED_LAUNCHES.count
    got = fused_smoother.smooth_level(xh, bh, hc, cfg, False, emit_dot=True, blocks=full, window=geom.window)
    torch.cuda.synchronize()
    schedule = fused_smoother.schedule_for(cfg, False)
    assert fused_smoother.SHARDED_LAUNCHES.count - before == len(fused_smoother.chunk_plan(len(schedule), full.tiles.depth))
    want = fused_smoother.smooth_level_torch(xh, bh, hc, cfg, False, emit_dot=True, blocks=full, window=geom.window)
    assert _rel(got[0], want[0]) <= grid_tol and _rel(got[1], want[1]) <= dot_tol
    cores = halo.core_scatter(got[0], geom)
    assert _rel(got[1], torch.sum(cores * b)) <= dot_tol
    beta = torch.tensor(0.37, dtype=dtype, device=device)
    hcg = fused_sharded.prehalo_cg_coeffs(c, mesh)
    before = fused_cg.SHARDED_STEP_LAUNCHES.count, fused_cg.STEP_LAUNCHES.count
    got = fused_cg.search_matvec_dot(xh, bh, beta, *hcg, mode="cuda", window=geom.window)
    torch.cuda.synchronize()
    assert fused_cg.SHARDED_STEP_LAUNCHES.count - before[0] == 1
    assert fused_cg.STEP_LAUNCHES.count == before[1]
    want = fused_cg.search_matvec_dot_torch(xh, bh, beta, *hcg, window=geom.window)
    assert _rel(got[0], want[0]) <= grid_tol and _rel(got[1], want[1]) <= grid_tol
    assert _rel(got[2], want[2]) <= dot_tol


@pytest.mark.parametrize("dtype, ew_dtype, grid_tol, dot_tol", CASES)
@pytest.mark.parametrize("variant", ["down", "up_dot", "warm"])
def test_sharded_block_matches_single_device_kernel(device, dtype, ew_dtype, grid_tol, dot_tol, variant):
    c, x, b, cfg, mesh, _ = _sharded_level(device, dtype, ew_dtype)
    kw = {
        "down": dict(forward=True, x_is_zero=True, emit_residual=True),
        "up_dot": dict(forward=False, emit_dot=True),
        "warm": dict(forward=True),
    }[variant]
    xin = None if kw.get("x_is_zero") else x
    got = fused_sharded.smooth_level_sharded(xin, b, c, cfg, mesh=mesh, **kw)
    single = fused_smoother.smooth_level(xin, b, c, cfg, **kw)
    plain = fused_sharded.smooth_level_sharded(
        xin, b, c, SolverConfig(solve_dtype=dtype, mg_ew_dtype=ew_dtype, kernel_mode="torch"),
        mesh=mesh, **kw,
    )
    torch.cuda.synchronize()
    got, single, plain = (v if isinstance(v, tuple) else (v,) for v in (got, single, plain))
    for g, s, p in zip(got, single, plain):
        tol = grid_tol if g.dim() else dot_tol
        assert _rel(g, s) <= tol and _rel(g, p) <= tol
    beta = torch.tensor(0.61, dtype=dtype, device=device)
    got = fused_sharded.cg_step_sharded(x, b, beta, c, cfg, mesh)
    want = fused_cg.search_matvec_dot(x, b, beta, c.diag, c.ew0, c.ew1, c.ew2, mode="cuda")
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert _rel(g, w) <= (grid_tol if g.dim() else dot_tol)


def test_sharded_wrappers_refuse_bad_operands(device):
    c, x, b, cfg, mesh, geom = _sharded_level(device, torch.float32, None)
    with pytest.raises(TypeError, match="unsupported dtype"):
        halo.halo_gather(x.to(torch.int32), geom)
    with pytest.raises(ValueError, match="not contiguous"):
        halo.halo_gather(x.transpose(0, 1), geom)
    with pytest.raises(ValueError, match="shape"):
        halo.core_scatter(x, geom)
    with pytest.raises(ValueError, match="odd core extent"):
        halo.geometry(mesh, (66, 64, 64))
    xh = halo.halo_gather(x, geom)
    bad = fused_cg.CoreWindow(0, 0, 1, 0, 1)
    with pytest.raises(RuntimeError, match="CUDA error"):
        fused_cg.search_matvec_dot(xh, xh, 0.5, *fused_sharded.prehalo_cg_coeffs(c, mesh), mode="cuda", window=bad)
    with pytest.raises(ValueError, match="block mesh is on"):
        mgpcg.solve(mgpcg.build_problem(*_sine_domain(), cfg, device=device), b.cpu(), config=cfg, mesh=mesh)


def test_sharded_projection_matches_single_device_fp64(device):
    """The 40^3 splash (window (48, 48, 48)): L0 runs on the block mesh."""
    n = 40
    phi, velocity = sdf.splash_scene((n, n, n), device=device)
    cfg = SolverConfig(tolerance=1e-9)
    setup = free_surface.build_setup(phi, sdf.open_box_weights((n, n, n), device=device), config=cfg)
    mesh = parallel.make_mesh(4, device=device)
    assert mg.level_flags(setup.problem.hier, cfg, mesh)[0] == "sharded"
    for counter in (fused_smoother.SHARDED_LAUNCHES, fused_cg.SHARDED_STEP_LAUNCHES, halo.HALO_LAUNCHES):
        counter.reset()
    got = free_surface.project(setup, velocity, config=cfg, mesh=mesh)
    assert fused_cg.SHARDED_STEP_LAUNCHES.count == got.cg.iterations > 0
    assert fused_smoother.SHARDED_LAUNCHES.count > 0 and halo.HALO_LAUNCHES.count > 0
    want = free_surface.project(setup, velocity, config=cfg)
    assert got.cg.iterations == want.cg.iterations
    assert _rel(got.pressure, want.pressure) <= 1e-10


def test_frame_loop_kernels_match_plain_fp64(device):
    n = 32
    phi, velocity = sdf.splash_scene((n, n, n), device=device)
    weights = sdf.open_box_weights((n, n, n), device=device)
    cfg = SolverConfig(tolerance=1e-9, max_iterations=300)
    fused_smoother.PASS_LAUNCHES.reset()
    got = simulate.run(phi, velocity, weights, num_frames=3, dt=1.0 / 60.0, config=cfg)
    assert fused_smoother.PASS_LAUNCHES.count > 0
    want = simulate.run(phi, velocity, weights, num_frames=3, dt=1.0 / 60.0,
                        config=SolverConfig(tolerance=1e-9, max_iterations=300, kernel_mode="torch"))
    for g, w in zip(got, want):
        assert g.iterations == w.iterations
        assert _rel(g.pressure, w.pressure) <= 1e-10
    assert got[1].window_reused and got[2].window_reused


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_coarse_system_device_on_the_card(device, dtype):
    """The coarse system built on the card: two builds bit-equal (every kept
    entry written once, no float accumulation), the slot map equal to the
    CPU build's, the inverse within the dtype's rounding of it (fp32: 1e-4
    of the largest entry, two LU factorizations; fp64: 1e-10)."""
    labels, weights, mg_levels = _sine_domain(32)
    cfg = SolverConfig(mg_dtype=dtype)
    c = mg.build_hierarchy(labels, weights, mg_levels, cfg, device=device).levels[-1]
    ndof = int(c.solvable.sum())
    for nd_pad in (max(256, -(-ndof // 256) * 256), 64):
        first = mg.coarse_system_device(c, nd_pad)
        again = mg.coarse_system_device(c, nd_pad)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(first, again))
        cpu = mg.coarse_system_device(stencil.LevelCoeffs(*(t.cpu() for t in c)), nd_pad)
        assert torch.equal(first[0].cpu(), cpu[0]) and int(first[2]) == int(cpu[2]) == ndof
        assert _rel(first[1].cpu(), cpu[1]) <= (1e-4 if dtype == torch.float32 else 1e-10)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_finish_hierarchy_coarse_rule_on_the_card(device, dtype, monkeypatch):
    """fp32 on the card factors the coarsest level on the card: the host
    path never runs, `_finish_hierarchy` syncs the host once (the flags and
    DOF counts), the slot map equals the host path's and the inverse is
    within fp32 rounding of the host fp64 one (1e-4 of its largest entry,
    an fp32 LU against an fp64 LU rounded).  fp64 keeps the host path, bit
    for bit the CPU's."""
    import warnings

    labels, weights, mg_levels = _sine_domain(32)
    cfg = SolverConfig(mg_dtype=dtype)
    fw = tuple(w.to(device, dtype) for w in weights)
    levels, flags, label_levels, _ = mg._build_levels(labels.to(device), fw, mg_levels, cfg.boundary_width, dtype)
    host = mg.coarse_system(label_levels[-1], dtype, device)
    calls = []
    real = mg.coarse_system
    monkeypatch.setattr(mg, "coarse_system", lambda *a: calls.append(a) or real(*a))
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            hier = mg._finish_hierarchy(levels, flags, label_levels, cfg)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = [w for w in caught if "called a synchronizing" in str(w.message)]
    assert torch.equal(hier.coarse_dofs, host[0]) and hier.coarse_chol.numel() == 0
    if dtype == torch.float32:
        assert not calls
        assert len(syncs) == 1, [str(w.message) for w in syncs]
        assert torch.equal(hier.coarse_minv, hier.coarse_minv.T)
        assert _rel(hier.coarse_minv, host[1]) <= 1e-4
    else:
        assert len(calls) == 1 and torch.equal(hier.coarse_minv, host[1])
        cpu = mg.coarse_system(label_levels[-1].cpu(), dtype, "cpu")
        assert torch.equal(hier.coarse_minv.cpu(), cpu[1])


def test_capped_hierarchy_takes_the_cholesky_branch_on_the_card(device):
    """A 64^3 Dirichlet box capped at two levels: level 1 holds 4352 DOFs, a
    bucket above COARSE_INVERSE_MAX_PAD, so fp32 on the card takes a lower
    Cholesky factor, finite, within 1e-4 of the host's fp64 factor, and
    `coarse_solve` with it within 1e-4 of the host factor's solve."""
    labels = torch.full((64, 64, 64), 1, dtype=torch.int8)  # DIRICHLET
    labels[16:48, 16:48, 14:48] = 2  # INTERIOR
    labels = domain.set_boundary_labels(labels, None)
    cfg = SolverConfig(mg_dtype=torch.float32, max_mg_levels=2)
    hier = mg.build_hierarchy(labels, None, 4, cfg, device=device)
    assert hier.num_levels == 2 and hier.coarse_minv.numel() == 0
    assert tuple(hier.coarse_chol.shape) == (4352, 4352) and mg.COARSE_INVERSE_MAX_PAD < 4352
    assert bool(torch.isfinite(hier.coarse_chol).all()) and torch.equal(hier.coarse_chol, hier.coarse_chol.tril())
    _, _, label_levels, _ = mg._build_levels(labels, None, 2, cfg.boundary_width, torch.float64)
    dofs, _, chol = mg.coarse_system(label_levels[-1], torch.float64, device)
    assert torch.equal(hier.coarse_dofs, dofs) and _rel(hier.coarse_chol, chol) <= 1e-4
    c = hier.levels[-1]
    gen = torch.Generator(device=device).manual_seed(4)
    r = torch.where(c.solvable, torch.randn(c.shape, generator=gen, device=device), 0.0)
    want = mg.coarse_solve(hier._replace(coarse_chol=chol.float()), r)
    assert _rel(mg.coarse_solve(hier, r), want) <= 1e-4


def test_run_fused_on_the_card_matches_run(device):
    """Two fused frames on the card against run(): the kernels launched in
    the chunk, iterations equal, fields within 1e-10 (fp64)."""
    n = 32
    phi, velocity = sdf.splash_scene((n, n, n), device=device)
    weights = sdf.open_box_weights((n, n, n), device=device)
    cfg = SolverConfig(tolerance=1e-9, max_iterations=300)
    done = []
    fused_smoother.PASS_LAUNCHES.reset()
    fused_cg.STEP_LAUNCHES.reset()
    f_phi, f_vel, f_p, stats = simulate.run_fused(phi, velocity, weights, num_frames=2, dt=1.0 / 60.0,
                                                  config=cfg, chunk=2, on_chunk=lambda k, s: done.append(k))
    assert done == [2] and f_p.is_cuda
    assert fused_cg.STEP_LAUNCHES.count == sum(stats["iterations"]) > 0 and fused_smoother.PASS_LAUNCHES.count > 0
    want = simulate.run(phi, velocity, weights, num_frames=2, dt=1.0 / 60.0, config=cfg)
    assert list(stats["iterations"]) == [w.iterations for w in want]
    assert _rel(f_p, want[-1].pressure) <= 1e-10 and _rel(f_phi, want[-1].liquid_phi) <= 1e-12
    assert all(_rel(f, w) <= 1e-10 for f, w in zip(f_vel, want[-1].velocity))


def test_chebyshev_projection_on_the_card(device):
    """The Chebyshev smoother runs its plain block (no chunk-kernel launch)
    while the CG step launches its kernel once per iteration."""
    n = 24
    phi, velocity = sdf.splash_scene((n, n, n), device=device)
    cfg = SolverConfig(tolerance=1e-10, max_iterations=200, interior_smoother="chebyshev", chebyshev_degree=3)
    setup = free_surface.build_setup(phi, sdf.open_box_weights((n, n, n), device=device), config=cfg)
    for counter in (fused_smoother.PASS_LAUNCHES, fused_cg.STEP_LAUNCHES):
        counter.reset()
    got = free_surface.project(setup, velocity, config=cfg)
    assert got.cg.converged and fused_smoother.PASS_LAUNCHES.count == 0
    assert fused_cg.STEP_LAUNCHES.count == got.cg.iterations > 0
    want = free_surface.project(setup, velocity, config=SolverConfig(
        tolerance=1e-10, max_iterations=200, interior_smoother="chebyshev", chebyshev_degree=3,
        kernel_mode="torch"))
    assert got.cg.iterations == want.cg.iterations and _rel(got.pressure, want.pressure) <= 1e-10


def _random_level(device, shape, dtype, ew_dtype, seed=0, dead=True):
    """A level of random coefficients with the stencil's invariants (edge
    weights only between solvable cells, fields zero off them), 85% of the
    cells solvable and, with `dead`, a corner block without any."""
    rng = np.random.default_rng(seed)
    solv = rng.random(shape) < 0.85
    if dead:
        solv[: shape[0] // 2, : shape[1] // 2, :] = False
    ews = []
    for axis in range(3):
        up = np.roll(solv, -1, axis)
        edge = [slice(None)] * 3
        edge[axis] = -1
        up[tuple(edge)] = False
        ews.append(np.where(solv & up, 0.5 + rng.random(shape), 0.0))
    diag = np.where(solv, 4.0 + rng.random(shape), 0.0)
    band = solv & (rng.random(shape) < 0.4)
    t = lambda a, dt=dtype: torch.from_numpy(a).to(device=device, dtype=dt)  # noqa: E731
    c = stencil.LevelCoeffs(
        t(solv, torch.bool), t(band, torch.int8), t(diag), t(np.where(solv, 1.0 / np.maximum(diag, 1.0), 0.0)),
        *(t(e, ew_dtype or dtype) for e in ews),
    )
    x = t(np.where(solv, rng.standard_normal(shape), 0.0))
    b = t(np.where(solv, rng.standard_normal(shape), 0.0))
    return c, x, b


VARIANTS = {
    "down": dict(forward=True, x_is_zero=True, emit_residual=True),
    "up_dot": dict(forward=False, emit_dot=True),
    "warm_residual": dict(forward=True, emit_residual=True),
    "warm": dict(forward=True),
}


def _check_chunks(device, c, x, b, cfg, blocks, kw, grid_tol, dot_tol):
    xin = None if kw.get("x_is_zero") else x
    got = fused_smoother.smooth_level(xin, b, c, cfg, blocks=blocks, **kw)
    torch.cuda.synchronize()
    want = fused_smoother.smooth_level_torch(xin, b, c, cfg, blocks=blocks, **kw)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for g, w in zip(got, want):
        assert _rel(g, w) <= (grid_tol if g.dim() else dot_tol)
    assert (got[0][~c.solvable] == 0).all()
    return got


@pytest.mark.parametrize("depth", range(1, 9))
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_chunk_depths_match_plain(device, depth, variant):
    """Every chunk depth 1..8, each variant; the fused residual after a
    zero start and after a streamed x (no spare halo ring is needed)."""
    c, x, b = _random_level(device, (40, 36, 72), torch.float32, torch.bfloat16, seed=depth)
    cfg = SolverConfig(solve_dtype=torch.float32, mg_ew_dtype=torch.bfloat16)
    blocks = fused_smoother.level_blocks(c, cfg, depth=depth)
    grid = fused_smoother.tile_grid(c.shape, blocks.tiles.core)
    assert blocks.tiles.depth == depth and 0 < int(blocks.tiles.counts[0]) < grid[0] * grid[1] * grid[2]
    kw = VARIANTS[variant]
    before = fused_smoother.PASS_LAUNCHES.count
    _check_chunks(device, c, x, b, cfg, blocks, kw, 1e-5, 1e-4)
    chunks = fused_smoother.chunk_plan(8, depth, kw.get("x_is_zero", False), kw.get("emit_residual", False))
    assert fused_smoother.PASS_LAUNCHES.count - before == len(chunks)


@pytest.mark.parametrize("shape", [(37, 29, 45), (20, 18, 20), (9, 70, 130), (1, 1, 1)])
@pytest.mark.parametrize("dtype, ew_dtype, grid_tol, dot_tol", CASES)
def test_chunk_kernel_on_ragged_shapes(device, shape, dtype, ew_dtype, grid_tol, dot_tol):
    """Shapes that the tiles do not divide, nz below the tile's z extent."""
    c, x, b = _random_level(device, shape, dtype, ew_dtype, seed=sum(shape))
    cfg = SolverConfig(solve_dtype=dtype, mg_ew_dtype=ew_dtype)
    blocks = fused_smoother.level_blocks(c, cfg)
    for kw in VARIANTS.values():
        _check_chunks(device, c, x, b, cfg, blocks, kw, grid_tol, dot_tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_chunk_kernel_dead_tiles_only(device, dtype):
    """No solvable cell: no active tile, every output zero, the dot 0."""
    c, x, b = _random_level(device, (33, 20, 70), dtype, None)
    c = c._replace(solvable=torch.zeros_like(c.solvable))
    cfg = SolverConfig(solve_dtype=dtype)
    blocks = fused_smoother.level_blocks(c, cfg)
    assert int(blocks.tiles.counts[0]) == 0
    x, b = torch.zeros_like(x), torch.zeros_like(b)
    junk = torch.full_like(x, float("nan"))
    for kw in VARIANTS.values():
        got = fused_smoother.smooth_level(junk if kw.get("x_is_zero") else x, b, c, cfg, blocks=blocks, **kw)
        torch.cuda.synchronize()
        for g in got if isinstance(got, tuple) else (got,):
            assert torch.equal(g, torch.zeros_like(g))


def _active_cells(tiles, device):
    """(nx, ny, nz) bool: the cells of the active tiles."""
    lx, ty, tz = tiles.core
    gx, gy, gz = fused_smoother.tile_grid(tiles.shape, tiles.core)
    occ = torch.zeros(gx * gy * gz, dtype=torch.bool, device=device)
    occ[fused_smoother.trimmed(tiles)[0].long()] = True
    full = occ.reshape(gx, 1, gy, 1, gz, 1).expand(gx, lx, gy, ty, gz, tz).reshape(gx * lx, gy * ty, gz * tz)
    nx, ny, nz = tiles.shape
    return full[:nx, :ny, :nz]


@pytest.mark.parametrize("variant", ["down", "warm_residual", "jacobi_residual"])
def test_chunk_kernel_with_fields_off_the_solvable_set(device, variant):
    """smooth_level's precondition: x and b zero off the solvable set.  With
    both nonzero there, the kernel still equals the plain version on the
    active tiles, and its x' and r are zero on the other tiles, where the
    plain version carries x and b through."""
    c, _, _ = _random_level(device, (40, 36, 72), torch.float32, None, seed=5)
    gen = torch.Generator(device=device).manual_seed(6)
    x = torch.randn(c.shape, generator=gen, device=device)
    b = torch.randn(c.shape, generator=gen, device=device)
    cfg = SolverConfig(solve_dtype=torch.float32, use_gauss_seidel=not variant.startswith("jacobi"))
    kw = dict(VARIANTS.get(variant, dict(forward=True, emit_residual=True)))
    blocks = fused_smoother.level_blocks(c, cfg)
    active = _active_cells(blocks.tiles, device)
    assert (active & ~c.solvable).any() and (~active).any()
    xin = None if kw.get("x_is_zero") else x
    got = fused_smoother.smooth_level(xin, b, c, cfg, blocks=blocks, **kw)
    torch.cuda.synchronize()
    want = fused_smoother.smooth_level_torch(xin, b, c, cfg, blocks=blocks, **kw)
    for g, w in zip(got, want):
        assert _rel(g[active], w[active]) <= 1e-5
        assert (g[~active] == 0).all()
    assert any((w[~active] != 0).any() for w in want)


def test_chunk_kernel_refuses_wrong_tiles(device):
    c, x, b, cfg = _level(device, torch.float32, None)
    other = fused_smoother.level_blocks(c._replace(solvable=c.solvable[:31].contiguous()), cfg)
    with pytest.raises(ValueError, match="tiles built for"):
        fused_smoother.smooth_level(x, b, c, cfg, True, blocks=fused_smoother.level_blocks(c, cfg)._replace(tiles=other.tiles))


def _cg_tiles(c):
    return fused_smoother.level_tiles(c.solvable, fused_smoother.band_cells(c.band))


def _check_cg_kernels(c, z, p, beta, tiles, grid_tol, dot_tol):
    """The CG step and the residual with `tiles` against their plain versions."""
    ops = (c.diag, c.ew0, c.ew1, c.ew2)
    before = fused_cg.STEP_LAUNCHES.count, fused_cg.RESIDUAL_LAUNCHES.count
    got = fused_cg.search_matvec_dot(z, p, beta, *ops, mode="cuda", tiles=tiles)
    r = fused_cg.residual(z, p, *ops, mode="cuda", tiles=tiles)
    torch.cuda.synchronize()
    assert (fused_cg.STEP_LAUNCHES.count - before[0], fused_cg.RESIDUAL_LAUNCHES.count - before[1]) == (1, 1)
    want = fused_cg.search_matvec_dot_torch(z, p, beta, *ops)
    assert _rel(got[0], want[0]) <= grid_tol and _rel(got[1], want[1]) <= grid_tol
    assert _rel(got[2], want[2]) <= dot_tol
    assert _rel(r, fused_cg.residual_torch(z, p, *ops)) <= grid_tol
    return got, r


@pytest.mark.parametrize("shape", [(37, 29, 45), (20, 18, 20), (9, 70, 130), (1, 1, 1)])
@pytest.mark.parametrize("dtype, ew_dtype, grid_tol, dot_tol", CASES)
def test_cg_kernels_on_ragged_shapes(device, shape, dtype, ew_dtype, grid_tol, dot_tol):
    """The tiled CG step and residual on shapes the (8, 8, 32) tiles do not
    divide, nz below the tile's z extent, a corner of dead tiles."""
    c, z, p = _random_level(device, shape, dtype, ew_dtype, seed=sum(shape) + 1)
    beta = torch.tensor(0.37, dtype=dtype, device=device)
    got, r = _check_cg_kernels(c, z, p, beta, _cg_tiles(c), grid_tol, dot_tol)
    for g in (got[0], got[1], r):
        assert (g[~c.solvable] == 0).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cg_kernels_dead_tiles_only(device, dtype):
    """No active tile: every output zero and the dot exactly 0, with inputs
    that are never read (NaN)."""
    c, _, _ = _random_level(device, (33, 20, 70), dtype, None)
    tiles = fused_smoother.level_tiles(torch.zeros_like(c.solvable), fused_smoother.band_cells(c.band))
    assert int(tiles.counts[0]) == 0
    junk = torch.full(c.shape, float("nan"), dtype=dtype, device=device)
    beta = torch.tensor(0.5, dtype=dtype, device=device)
    pn, ap, dot = fused_cg.search_matvec_dot(junk, junk, beta, c.diag, c.ew0, c.ew1, c.ew2, mode="cuda", tiles=tiles)
    r = fused_cg.residual(junk, junk, c.diag, c.ew0, c.ew1, c.ew2, mode="cuda", tiles=tiles)
    torch.cuda.synchronize()
    for g in (pn, ap, r):
        assert torch.equal(g, torch.zeros_like(g))
    assert float(dot) == 0.0


def test_cg_kernels_with_fields_off_the_solvable_set(device):
    """The wrappers' precondition: fields zero off the solvable set.  With
    fields nonzero there, the kernels still equal the plain versions on the
    active tiles, store zeros on the others, and the dot is the plain dot
    over the active tiles."""
    c, _, _ = _random_level(device, (40, 36, 72), torch.float32, None, seed=5)
    gen = torch.Generator(device=device).manual_seed(7)
    z = torch.randn(c.shape, generator=gen, device=device)
    p = torch.randn(c.shape, generator=gen, device=device)
    beta = torch.tensor(0.37, device=device)
    tiles = _cg_tiles(c)
    active = _active_cells(tiles, device)
    assert (active & ~c.solvable).any() and (~active).any()
    ops = (c.diag, c.ew0, c.ew1, c.ew2)
    got = fused_cg.search_matvec_dot(z, p, beta, *ops, mode="cuda", tiles=tiles)
    r = fused_cg.residual(z, p, *ops, mode="cuda", tiles=tiles)
    torch.cuda.synchronize()
    want = fused_cg.search_matvec_dot_torch(z, p, beta, *ops)
    r_want = fused_cg.residual_torch(z, p, *ops)
    for g, w in ((got[0], want[0]), (got[1], want[1]), (r, r_want)):
        assert _rel(g[active], w[active]) <= 1e-5
        assert (g[~active] == 0).all()
    # The plain p' and r carry z + beta p and b there (A p' is zero off the
    # solvable set whatever p' is: zero diag, no edge weights).
    assert (want[0][~active] != 0).any() and (r_want[~active] != 0).any()
    assert _rel(got[2], torch.sum((want[0] * want[1])[active])) <= 1e-4


@pytest.mark.parametrize("dtype, ew_dtype, grid_tol, dot_tol", CASES)
def test_cg_step_core_window_with_stacked_tiles(device, dtype, ew_dtype, grid_tol, dot_tol):
    """The CG step over a stacked block grid with its stacked tiles and the
    core window, against the plain masked dot and the cores' dot."""
    c, x, b, cfg, mesh, geom = _sharded_level(device, dtype, ew_dtype)
    hcg = fused_sharded.prehalo_cg_coeffs(c, mesh)
    tiles = fused_sharded.stacked_cg_tiles(hcg)
    xh, bh = halo.halo_gather(x, geom), halo.halo_gather(b, geom)
    beta = torch.tensor(0.37, dtype=dtype, device=device)
    got = fused_cg.search_matvec_dot(xh, bh, beta, *hcg, mode="cuda", window=geom.window, tiles=tiles)
    torch.cuda.synchronize()
    want = fused_cg.search_matvec_dot_torch(xh, bh, beta, *hcg, window=geom.window)
    assert _rel(got[2], want[2]) <= dot_tol
    cores = [halo.core_scatter(g, geom) for g in got[:2]]
    for g, w in zip(cores, want[:2]):
        assert _rel(g, halo.core_scatter(w, geom)) <= grid_tol
    assert _rel(got[2], torch.sum(cores[0] * cores[1])) <= dot_tol
    single = fused_sharded.cg_step_sharded(x, b, beta, c, cfg, mesh, prehaloed_cg=hcg, tiles=tiles)
    torch.cuda.synchronize()
    for g, s in zip(single, (cores[0], cores[1], got[2])):
        assert torch.equal(g, s)


@pytest.mark.parametrize("ew_dtype", [torch.bfloat16, None])
def test_bf16_residual_kernel_with_tiles_matches_plain(device, ew_dtype):
    """bf16 storage of b and r over float32 x, with tiles, on a ragged grid."""
    c, x, b = _random_level(device, (37, 29, 45), torch.float32, ew_dtype, seed=9)
    bh = b.to(torch.bfloat16)
    got = fused_cg.residual(x, bh, c.diag, c.ew0, c.ew1, c.ew2, mode="cuda", tiles=_cg_tiles(c))
    torch.cuda.synchronize()
    want = fused_cg.residual_torch(x, bh, c.diag, c.ew0, c.ew1, c.ew2)
    assert got.dtype == want.dtype == torch.bfloat16
    assert float((got.double() - want.double()).abs().max()) <= _bf16_bound(want)
    assert (got[~c.solvable] == 0).all()


def test_cg_kernels_refuse_wrong_tiles(device):
    c, z, p, _ = _level(device, torch.float32, None)
    ops = (c.diag, c.ew0, c.ew1, c.ew2)
    beta = torch.tensor(0.5, device=device)
    tiles = _cg_tiles(c)
    other = _cg_tiles(c._replace(solvable=c.solvable[:31].contiguous()))
    bad = {
        "tiles built for": (ValueError, other),
        "tiles of": (ValueError, tiles._replace(core=(8, 8, 16))),
        "must be int32": (TypeError, tiles._replace(active=tiles.active.long())),
        "do not cover": (ValueError, tiles._replace(active=tiles.active[1:])),
        "is on cpu": (ValueError, tiles._replace(dead=tiles.dead.cpu())),
    }
    for match, (err, t) in bad.items():
        with pytest.raises(err, match=match):
            fused_cg.search_matvec_dot(z, p, beta, *ops, mode="cuda", tiles=t)
        with pytest.raises(err, match=match):
            fused_cg.residual(z, p, *ops, mode="cuda", tiles=t)


def test_cg_kernels_are_deterministic(device):
    """Two launches on the same inputs give the same bits (the dot is summed
    in index order by the last block, no float atomics), and two fp32 solves
    give the same residual history."""
    c, z, p = _random_level(device, (96, 80, 160), torch.float32, None, seed=11)
    beta = torch.tensor(0.37, device=device)
    tiles = _cg_tiles(c)
    ops = (c.diag, c.ew0, c.ew1, c.ew2)
    first = fused_cg.search_matvec_dot(z, p, beta, *ops, mode="cuda", tiles=tiles)
    first_r = fused_cg.residual(z, p, *ops, mode="cuda", tiles=tiles)
    for _ in range(3):
        again = fused_cg.search_matvec_dot(z, p, beta, *ops, mode="cuda", tiles=tiles)
        again_r = fused_cg.residual(z, p, *ops, mode="cuda", tiles=tiles)
        for g, w in zip(first + (first_r,), again + (again_r,)):
            assert torch.equal(g, w)
    assert int(tiles.ticket) == 0
    cfg = SolverConfig(solve_dtype=torch.float32, record_residuals=True)
    labels, weights, mg_levels = _sine_domain()
    problem = mgpcg.build_problem(labels, weights, mg_levels, cfg, device=device)
    gen = torch.Generator(device=device).manual_seed(3)
    rhs = torch.where(problem.fine.solvable, torch.randn(problem.fine.shape, generator=gen, device=device), 0)
    a = mgpcg.solve(problem, rhs, config=cfg)
    b = mgpcg.solve(problem, rhs, config=cfg)
    assert a.converged and a.iterations == b.iterations > 0
    history = [r.residual_history[: r.iterations + 1] for r in (a, b)]
    assert torch.equal(*history) and torch.equal(a.x, b.x)


def test_diagnostics_blocks_kernel_vs_plain_fp64(device):
    """The test node's four blocks at 32^3 in fp64, the kernels against
    kernel_mode="torch" on the card: the CG block's iterations equal and
    its relative residual within 1e-6 relative; the V-cycle's per-cycle L2
    within 1e-9 relative while above 1e-10 of the first (below that the
    error is rounding); the smoother's residual norms within 1e-10
    relative; every symmetry < 1e-10."""
    from geometricmultigridpressuresolver_tpu_torch import diagnostics

    cg_kw = dict(grid_size=32, use_solid_sphere=True, tolerance=1e-9, max_iterations=500, device=device)
    got = diagnostics.run_conjugate_gradient_test(**cg_kw)
    want = diagnostics.run_conjugate_gradient_test(**cg_kw, kernel_mode="torch")
    assert got["iterations"] == want["iterations"] > 0
    assert abs(got["relative_l2"] - want["relative_l2"]) <= 1e-6 * want["relative_l2"]
    assert got["max_relative_difference_vs_oracle"] < 1e-6
    got = diagnostics.run_one_level_vcycle_test(grid_size=32, num_cycles=8, device=device)
    want = diagnostics.run_one_level_vcycle_test(grid_size=32, num_cycles=8, kernel_mode="torch", device=device)
    for g, w in zip(got["l2"], want["l2"]):
        if w > 1e-10 * want["l2"][0]:
            assert abs(g - w) <= 1e-9 * w
    assert got["mean_convergence_factor"] < 0.5
    got = diagnostics.run_smoother_test(grid_size=32, max_smoother_iterations=6, device=device)
    want = diagnostics.run_smoother_test(grid_size=32, max_smoother_iterations=6, kernel_mode="torch",
                                         device=device)
    np.testing.assert_allclose(got["residual_l2"], want["residual_l2"], rtol=1e-10, atol=0)
    for mode in ("auto", "torch"):
        for name, v in diagnostics.run_symmetry_test(32, kernel_mode=mode, device=device).items():
            assert v < 1e-10, (mode, name, v)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_instrumented_solve_bit_equal_on_the_card(device, dtype):
    from geometricmultigridpressuresolver_tpu_torch.utils import profiling

    n = 48
    cfg = SolverConfig(solve_dtype=dtype, mg_ew_dtype=torch.bfloat16 if dtype == torch.float32 else None)
    phi, velocity = sdf.splash_scene((n,) * 3, device=device, dtype=dtype)
    setup = free_surface.build_setup(phi, sdf.open_box_weights((n,) * 3, device=device, dtype=dtype), config=cfg)
    rhs = free_surface.embed_window(
        free_surface.negative_divergence(setup.liquid_mask, velocity, setup.weights),
        setup.window_start, setup.base_pads, setup.expanded_shape,
    )
    x, times = profiling.instrumented_solve(setup.problem, rhs, config=cfg, print_stats=False)
    result = mgpcg.solve(setup.problem, rhs, config=cfg)
    assert torch.equal(x, result.x)
    assert times.calls["matvec"] == result.iterations > 0
    stages = profiling.vcycle_stage_times(setup.problem.hier, rhs, cfg, warmup=1, reps=2)
    assert f"L{setup.problem.hier.num_levels - 1} coarse direct solve" in stages.seconds


def test_two_ranks_on_the_card_kernel_vs_plain(device):
    """Two ranks ((2, 1, 1), gloo with host staging, both on this card) solve
    the 32^3 sine fixture in fp64 with L0 sharded: the rank-side block functions
    launch the kernels, and x and the iterations equal the same world's
    plain run (kernel_mode="torch") to 1e-12."""
    from geometricmultigridpressuresolver_tpu_torch.parallel import dryrun

    labels, weights, mg_levels = _sine_domain()
    labels, weights = labels.numpy(), [w.numpy() for w in weights]
    rhs = np.random.default_rng(21).standard_normal(labels.shape)
    rhs[labels < 2] = 0.0
    job = "geometricmultigridpressuresolver_tpu_torch.parallel.dryrun:solve_job"
    runs = {
        mode: dryrun.launch(job, 2, "gloo", "cuda", dict(
            labels=labels, weights=weights, mg_levels=mg_levels, rhs=rhs,
            config_kwargs=dict(tolerance=1e-8, kernel_mode=mode)), timeout=300)
        for mode in ("auto", "torch")
    }
    for kernel, plain in zip(runs["auto"], runs["torch"]):
        assert kernel["flags"][0] == "sharded" and kernel["converged"]
        assert kernel["launches"]["smoother_sharded"] > 0 and kernel["launches"]["cg_step_sharded"] > 0
        assert sum(plain["launches"].values()) == 0
        assert kernel["iterations"] == plain["iterations"]
        np.testing.assert_allclose(kernel["x"], plain["x"], rtol=0, atol=1e-12)


def test_two_ranks_on_the_card_partitioned_projection(device):
    """Two ranks ((2, 1, 1), gloo, both on this card) build the 96^3 splash
    from their base blocks (`build_setup(mesh=, base_shape=)`) and project
    it in fp64 (L0 sharded): each rank's blocks of the problem equal those
    of the same world's plain run (kernel_mode="torch") bit for bit, and
    the iterations, pressure and velocity match it to 1e-12.  96^3 has 4
    levels: on a mesh that does not split y, L0 may run sharded only from
    4 levels on (the JAX package's rule, `fused_sharded.sharded_eligible`),
    so the 40^3 splash (3 levels) keeps L0 whole."""
    from geometricmultigridpressuresolver_tpu_torch.config import SolverConfig
    from geometricmultigridpressuresolver_tpu_torch.parallel import dryrun

    job = "geometricmultigridpressuresolver_tpu_torch.parallel.dryrun:project_job"
    runs = {
        mode: dryrun.launch(job, 2, "gloo", "cuda", dict(
            n=96, fields=True, print_line=False, config=SolverConfig(tolerance=1e-8, kernel_mode=mode)), timeout=300)
        for mode in ("auto", "torch")
    }
    for kernel, plain in zip(runs["auto"], runs["torch"]):
        assert kernel["flags"][0] == "sharded" and kernel["converged"]
        for got, want in zip(kernel["levels"], plain["levels"]):
            for f in got:
                np.testing.assert_array_equal(got[f], want[f])
        assert kernel["iterations"] == plain["iterations"]
        np.testing.assert_allclose(kernel["pressure"], plain["pressure"], rtol=0, atol=1e-12)
        for a in range(3):
            np.testing.assert_allclose(kernel["velocity"][a], plain["velocity"][a], rtol=0, atol=1e-12)


def test_mm_transfers_ieee_with_tf32_on(device):
    """With TF32 switched on by the caller, the fp32 matrix-form transfers
    stay within 1e-6 (relative to the largest value) of the slice form --
    TF32's ~1e-3 would fail -- and the caller's setting is back after each
    call.  Shapes of the 256^3 bench's L0 -> L1 (lane-padded coarse z)."""
    from geometricmultigridpressuresolver_tpu_torch.ops import transfer

    gen = torch.Generator(device=device).manual_seed(7)
    fine_shape, coarse_shape = (288, 256, 384), (144, 128, 256)
    fine_solv = torch.rand(fine_shape, generator=gen, device=device) < 0.7
    coarse_solv = torch.rand(coarse_shape, generator=gen, device=device) < 0.7
    coarse_solv[:, :, 192:] = False
    fine = torch.where(fine_solv, torch.randn(fine_shape, generator=gen, device=device), 0.0)
    coarse = torch.where(coarse_solv, torch.randn(coarse_shape, generator=gen, device=device), 0.0)
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        r_mm = transfer.restrict_mm(fine, coarse_solv)
        p_mm = transfer.prolong_add_mm(fine, coarse, fine_solv)
        assert torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    assert _rel(r_mm, transfer.restrict(fine, coarse_solv)) <= 1e-6
    assert _rel(p_mm, transfer.prolong_add(fine, coarse, fine_solv)) <= 1e-6


def _graph_case(device, variant):
    """(setup, rhs, config, mesh) of a graph-loop case: the 64^3 splash
    (the block mesh: 40^3, whose L0 the mesh splits), residual histories on."""
    dtype = torch.float64 if variant == "fp64" else torch.float32
    kw = dict(solve_dtype=dtype, tolerance=1e-5 if dtype == torch.float32 else 1e-9, record_residuals=True,
              mg_ew_dtype=torch.bfloat16 if dtype == torch.float32 else None)
    kw.update({"bf16_fields": dict(mg_field_dtype=torch.bfloat16), "chebyshev": dict(interior_smoother="chebyshev"),
               "torch_mode": dict(kernel_mode="torch")}.get(variant, {}))
    n = 40 if variant == "block_mesh" else 64
    cfg = SolverConfig(**kw)
    phi, velocity = sdf.splash_scene((n,) * 3, device=device, dtype=dtype)
    setup = free_surface.build_setup(phi, sdf.open_box_weights((n,) * 3, device=device, dtype=dtype), config=cfg)
    rhs = free_surface.embed_window(
        free_surface.negative_divergence(setup.liquid_mask, velocity, setup.weights),
        setup.window_start, setup.base_pads, setup.expanded_shape,
    )
    mesh = parallel.make_mesh(4, device=device) if variant == "block_mesh" else None
    if mesh is not None:
        assert mg.level_flags(setup.problem.hier, cfg, mesh)[0] == "sharded"
    return setup, rhs, cfg, mesh


def _counted_solve(setup, rhs, cfg, mesh, **kw):
    """One solve with the program cache off (its CG loop captured per
    solve, `graph.run`, or eager): the result, launch counts and stats."""
    from geometricmultigridpressuresolver_tpu_torch.ops import _cuda
    from geometricmultigridpressuresolver_tpu_torch.solver import graph

    for c in _cuda.COUNTERS:
        c.reset()
    graph.STATS.reset()
    with graph.programs_off():
        result = mgpcg.solve(setup.problem, rhs, config=cfg, mesh=mesh, **kw)
    torch.cuda.synchronize()
    return result, {c.name: c.count for c in _cuda.COUNTERS}, dict(vars(graph.STATS))


def _same_bits(a, b) -> bool:
    return torch.equal(torch.nan_to_num(a, nan=-7.0), torch.nan_to_num(b, nan=-7.0)) and bool(
        (a.isnan() == b.isnan()).all())


@pytest.mark.parametrize("variant", ["fp32", "fp64", "bf16_fields", "block_mesh", "chebyshev", "torch_mode"])
def test_graph_loop_bit_equal_to_eager(device, variant, monkeypatch):
    """The solve through the captured graph (one capture, ceil((n - 1) / K)
    host reads) gives the eager loop's iterations, x and residual history
    bit for bit, with the same kernel launch counts."""
    from geometricmultigridpressuresolver_tpu_torch.solver import graph

    setup, rhs, cfg, mesh = _graph_case(device, variant)
    assert mgpcg.loop_runner(mgpcg.solve_stages(setup.problem, cfg, mesh), rhs) is graph.run
    got, launches, stats = _counted_solve(setup, rhs, cfg, mesh)
    with monkeypatch.context() as m:
        m.setattr(mgpcg, "loop_runner", lambda stages, rhs: None)
        want, want_launches, want_stats = _counted_solve(setup, rhs, cfg, mesh)
    assert want_stats["captures"] == 0 and stats["captures"] == 1
    assert stats["reads"] == max(1, math.ceil((got.iterations - 1) / graph.REPLAYS))
    assert stats["launches"] == graph.REPLAYS * stats["reads"]
    assert got.iterations == want.iterations > 1 and got.converged and want.converged
    assert torch.equal(got.x, want.x)
    assert got.relative_residual == want.relative_residual
    assert _same_bits(got.residual_history, want.residual_history)
    assert launches == want_launches
    if variant == "torch_mode":
        assert sum(launches.values()) == 0
    else:
        assert launches["cg_step" if mesh is None else "cg_step_sharded"] == got.iterations


def test_graph_loop_interrupt_matches_eager(device, monkeypatch):
    """An interrupt_check stops the graph loop (one launch per host read)
    at the iteration it stops the eager loop, with the same iterate."""
    setup, rhs, cfg, mesh = _graph_case(device, "fp32")
    runs = []
    for eager in (False, True):
        seen = []

        def stop_at_3(it, seen=seen):
            seen.append(it)
            return it >= 3

        with monkeypatch.context() as m:
            if eager:
                m.setattr(mgpcg, "loop_runner", lambda stages, rhs: None)
            result, launches, stats = _counted_solve(setup, rhs, cfg, mesh, interrupt_check=stop_at_3)
        runs.append((result, launches, stats, seen))
    (got, launches, stats, seen), (want, want_launches, _, want_seen) = runs
    assert got.iterations == want.iterations == 3 and not got.converged
    assert seen == want_seen == [1, 2, 3]
    assert stats["reads"] == 3 and stats["launches"] == 2
    assert torch.equal(got.x, want.x) and launches == want_launches


def _private_pools() -> set:
    """The ids of the private (CUDA graph) memory pools that hold a segment."""
    segments = torch.cuda.memory_snapshot()
    assert all("segment_pool_id" in seg for seg in segments)
    return {tuple(seg["segment_pool_id"]) for seg in segments} - {(0, 0)}


def test_graph_pool_released_after_solve(device):
    """A solve's capture pool goes back to the caching allocator when the
    solve ends: after `empty_cache` no segment is left in a private pool the
    solve made, so later allocations can use that memory."""
    from geometricmultigridpressuresolver_tpu_torch.solver import graph

    setup, rhs, cfg, mesh = _graph_case(device, "fp32")
    graph.PROGRAMS.clear()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    before = _private_pools()
    graph.STATS.reset()
    with graph.programs_off():
        assert mgpcg.solve(setup.problem, rhs, config=cfg).converged
    assert graph.STATS.captures == 1
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    assert _private_pools() <= before


def test_graph_capture_raises(device, monkeypatch):
    """A failed capture raises (here: a host read inside the iteration);
    the loop does not fall back to eager launches."""
    from geometricmultigridpressuresolver_tpu_torch.solver import cg, graph

    setup, rhs, cfg, mesh = _graph_case(device, "fp32")
    tail = cg.FusedCG.tail

    def reading_tail(self, s):
        tail(self, s)
        float(s.rho)  # a sync: illegal while capturing

    monkeypatch.setattr(cg.FusedCG, "tail", reading_tail)
    with graph.programs_off(), pytest.raises(RuntimeError):
        mgpcg.solve(setup.problem, rhs, config=cfg)
    monkeypatch.undo()
    with graph.programs_off():
        assert mgpcg.solve(setup.problem, rhs, config=cfg).converged  # the card is usable again


def test_device_counts_match_host_built_lists(device):
    """The work lists built on the card (padded, lengths in `Tiles.counts`)
    are the host-built lists, and the kernels reading their lengths from
    the device give the bits of a launch over host-built lists padded with
    other entries in place of the sentinel: nothing is read past a count."""
    c, x, b, cfg = _level(device, torch.float32, torch.bfloat16)
    blocks = fused_smoother.level_blocks(c, cfg)
    tiles = blocks.tiles
    occ = fused_smoother.tile_occupancy(c.solvable, tiles.core).reshape(-1).cpu()
    host = (torch.nonzero(occ).reshape(-1), torch.nonzero(~occ).reshape(-1),
            torch.nonzero(c.band.reshape(-1).cpu()).reshape(-1))
    for got, want in zip(fused_smoother.trimmed(tiles), host):
        assert torch.equal(got.cpu().long(), want)

    def padded(lst, cap):
        fill = lst[torch.arange(cap - lst.numel()) % max(lst.numel(), 1)] if lst.numel() else torch.zeros(cap)
        return torch.cat([lst, fill.to(lst.dtype)]).to(torch.int32).to(device)

    n_tiles = tiles.active.numel()
    other = tiles._replace(active=padded(host[0], n_tiles), dead=padded(host[1], n_tiles),
                           band=padded(host[2], c.band.numel()),
                           counts=torch.tensor([h.numel() for h in host], dtype=torch.int32, device=device))
    beta = torch.tensor(0.37, device=device)
    ops = (c.diag, c.ew0, c.ew1, c.ew2)
    for kw in VARIANTS.values():
        xx = None if kw.get("x_is_zero") else x
        got = fused_smoother.smooth_level(xx, b, c, cfg, blocks=blocks, **kw)
        want = fused_smoother.smooth_level(xx, b, c, cfg, blocks=blocks._replace(tiles=other), **kw)
        got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    step = fused_cg.search_matvec_dot(x, b, beta, *ops, mode="cuda", tiles=tiles)
    assert all(torch.equal(g, w) for g, w in zip(
        step, fused_cg.search_matvec_dot(x, b, beta, *ops, mode="cuda", tiles=other)))
    assert torch.equal(fused_cg.residual(x, b, *ops, mode="cuda", tiles=tiles),
                       fused_cg.residual(x, b, *ops, mode="cuda", tiles=other))


def _frames(device, n=64, frames=4, chunk=2, eager=False, **kw):
    """run_fused on the n^3 splash (fp32, the bench configuration) with its
    frames as one graph each, or eagerly (`graph.EmulatedFrame`); the
    device launch counts and `graph.STATS` of the call.  The program cache
    is off (the geometry's setup eager), so the frame graph is the call's
    only capture."""
    from geometricmultigridpressuresolver_tpu_torch.ops import _cuda
    from geometricmultigridpressuresolver_tpu_torch.solver import graph

    cfg = SolverConfig(solve_dtype=torch.float32, mg_ew_dtype=torch.bfloat16, tolerance=1e-5)
    phi, velocity = sdf.splash_scene((n,) * 3, device=device, dtype=torch.float32)
    weights = sdf.open_box_weights((n,) * 3, device=device, dtype=torch.float32)
    for c in _cuda.COUNTERS:
        c.reset()
    graph.STATS.reset()
    runner = simulate.frame_runner
    if eager:
        simulate.frame_runner = lambda dev: graph.EmulatedFrame
    try:
        with graph.programs_off():
            out = simulate.run_fused(phi, velocity, weights, num_frames=frames, chunk=chunk, config=cfg, **kw)
    finally:
        simulate.frame_runner = runner
    torch.cuda.synchronize()
    return out, {c.name: c.count for c in _cuda.COUNTERS}, dict(vars(graph.STATS))


def test_frame_graph_bit_equal_to_eager_frames(device):
    """Four 64^3 frames in chunks of 2, each one launch of the captured
    frame: the eager frames' iterations, fields and launch counts bit for
    bit, one capture, one launch per frame, one stats read per chunk."""
    done = []
    (g_phi, g_vel, g_p, g_stats), launches, stats = _frames(device, on_chunk=lambda k, s: done.append(k))
    (e_phi, e_vel, e_p, e_stats), e_launches, e_graph = _frames(device, eager=True)
    assert done == [2, 4]
    assert list(g_stats["iterations"]) == list(e_stats["iterations"]) and min(g_stats["iterations"]) > 1
    assert torch.equal(g_phi, e_phi) and torch.equal(g_p, e_p)
    assert all(torch.equal(a, b) for a, b in zip(g_vel, e_vel))
    assert launches == e_launches and launches["cg_step"] == sum(g_stats["iterations"])
    assert (stats["frame_captures"], stats["frame_launches"], stats["frame_reads"], stats["captures"]) == (1, 4, 2, 0)
    assert (e_graph["frame_captures"], e_graph["frame_launches"], e_graph["frame_reads"]) == (0, 0, 2)


def test_frame_graph_frames_read_nothing_on_the_host(device, monkeypatch):
    """Every frame launch under set_sync_debug_mode("error"): a host sync
    inside a frame would raise; the chunk's one read comes after them."""
    from geometricmultigridpressuresolver_tpu_torch.solver import graph

    launch = graph.FrameGraph.launch

    def strict(self):
        torch.cuda.set_sync_debug_mode("error")
        try:
            launch(self)
        finally:
            torch.cuda.set_sync_debug_mode("default")

    monkeypatch.setattr(graph.FrameGraph, "launch", strict)
    (_, _, _, stats), _, counted = _frames(device, frames=4, chunk=4)
    assert counted["frame_launches"] == 4 and counted["frame_reads"] == 1
    assert all(r <= 1e-5 for r in stats["relative_residual"])


def test_frame_capture_raises_and_the_next_capture_works(device, monkeypatch):
    """A failed frame capture (here: a host read inside the CG iteration)
    raises, runs nothing eagerly in its place, and leaves no capture open:
    the next run_fused captures and runs; its frame pool is released when
    it returns."""
    from geometricmultigridpressuresolver_tpu_torch.solver import cg, graph

    tail = cg.FusedCG.tail

    def reading_tail(self, s):
        tail(self, s)
        float(s.rho)  # a sync: illegal while capturing

    monkeypatch.setattr(cg.FusedCG, "tail", reading_tail)
    with pytest.raises(RuntimeError):
        _frames(device, frames=2, chunk=2)
    assert graph.STATS.frame_launches == 0
    monkeypatch.undo()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    before = _private_pools()
    (_, _, _, stats), _, counted = _frames(device, frames=2, chunk=2)
    assert counted["frame_captures"] == 1 and counted["frame_launches"] == 2 and len(stats["iterations"]) == 2
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    assert _private_pools() <= before


def _program_case(device, n=64, shift=0):
    """The bench configuration and a free drop at n^3 (moved `shift`
    cells along x) with the splash's velocity."""
    cfg = SolverConfig(solve_dtype=torch.float32, mg_ew_dtype=torch.bfloat16, tolerance=1e-5)
    points, _ = sdf.cell_centers((n,) * 3, device=device, dtype=torch.float32)
    phi = torch.roll(sdf.sphere_sdf(points, (0.35, 0.45, 0.5), 0.2), shift, dims=0)  # air rolls in
    _, velocity = sdf.splash_scene((n,) * 3, device=device, dtype=torch.float32)
    return cfg, phi, velocity, sdf.open_box_weights((n,) * 3, device=device, dtype=torch.float32)


def _tree_equal(a, b) -> bool:
    from geometricmultigridpressuresolver_tpu_torch.solver import graph

    ta, tb = graph.tensors(a), graph.tensors(b)
    return len(ta) == len(tb) and all(x.shape == y.shape and torch.equal(x, y) for x, y in zip(ta, tb))


@pytest.mark.parametrize("fusion", ["fused", "per-level"])
def test_program_hit_bit_equal_to_fresh_capture(device, fusion):
    """Setup, projection and solve replayed from the program cache give
    the bits of a fresh capture and of the cache off; the second call
    captures nothing."""
    from geometricmultigridpressuresolver_tpu_torch.solver import graph

    cfg, phi, velocity, weights = _program_case(device)
    cfg = dataclasses.replace(cfg, setup_fusion=fusion)

    def once():
        setup = free_surface.build_setup(phi, weights, config=cfg)
        result = free_surface.project(setup, velocity, config=cfg)
        rhs = free_surface.embed_window(free_surface.negative_divergence(setup.liquid_mask, velocity, setup.weights),
                                        setup.window_start, setup.base_pads, setup.expanded_shape)
        return setup, result, mgpcg.solve(setup.problem, rhs, config=cfg)

    graph.PROGRAMS.clear()
    graph.STATS.reset()
    fresh = once()
    captures = sum(graph.STATS.program_captures.values())
    hit = once()
    assert sum(graph.STATS.program_captures.values()) == captures  # the second problem replays the solve
    assert graph.STATS.program_hits["project"] == graph.STATS.program_hits["solve"] == 1
    assert graph.STATS.captures == 0
    with graph.programs_off():
        off = once()
    for a, b, c in zip(fresh, hit, off):
        assert _tree_equal(a, b) and _tree_equal(a, c)
    assert fresh[1].cg.iterations == hit[1].cg.iterations == off[1].cg.iterations > 1


def test_held_setup_and_result_are_never_overwritten(device):
    """A replay writes the program's own buffers: a setup and a result the
    caller holds keep their values when the same programs run for a moved
    drop in the kept window."""
    from geometricmultigridpressuresolver_tpu_torch.solver import graph

    cfg, phi, velocity, weights = _program_case(device)
    _, moved, _, _ = _program_case(device, shift=3)
    graph.PROGRAMS.clear()
    graph.STATS.reset()
    s1 = free_surface.build_setup(phi, weights, config=cfg)
    r1 = free_surface.project(s1, velocity, config=cfg, old_pressure=torch.zeros_like(phi))
    kept = ([t.clone() for t in graph.tensors(s1)], [t.clone() for t in graph.tensors(r1)])
    s2 = free_surface.build_setup(moved, weights, config=cfg, reuse_from=s1)
    r2 = free_surface.project(s2, velocity, config=cfg, old_pressure=r1.pressure)
    assert s2.expanded_shape == s1.expanded_shape and s2.window_start != s1.window_start
    assert graph.STATS.program_hits["setup"] == 1
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(kept[0], graph.tensors(s1)))
    assert all(torch.equal(a, b) for a, b in zip(kept[1], graph.tensors(r1)))
    assert not torch.equal(r1.pressure, r2.pressure)


def test_program_eviction_releases_pools(device, monkeypatch):
    """Each program's pool goes with it: past the cache's capacity the
    least recently used programs go, and after `clear` and `empty_cache`
    no private pool the programs made holds memory."""
    from geometricmultigridpressuresolver_tpu_torch.solver import graph

    cfg, phi, velocity, weights = _program_case(device)
    graph.PROGRAMS.clear()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    before = _private_pools()
    setup = free_surface.build_setup(phi, weights, config=cfg)
    free_surface.project(setup, velocity, config=cfg)
    assert len(graph.PROGRAMS) == 2 and _private_pools() > before
    graph.STATS.reset()
    monkeypatch.setattr(graph.PROGRAMS, "capacity", 1)  # a new program evicts both older ones
    free_surface.project(setup, velocity, config=cfg, old_pressure=torch.zeros_like(phi))
    assert len(graph.PROGRAMS) == 1 and sum(graph.STATS.program_evictions.values()) == 2
    graph.PROGRAMS.clear()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    assert _private_pools() <= before


def test_program_over_budget_runs_uncached(device, monkeypatch):
    """A projection whose program would take more than half the cache's
    budget (as the last one captured says) is not captured as a program:
    it runs as with the cache off (the CG loop captured for the solve),
    bit-equal to it, and is counted as declined; the cached programs
    stay."""
    from geometricmultigridpressuresolver_tpu_torch.solver import graph

    cfg, phi, velocity, weights = _program_case(device)
    graph.PROGRAMS.clear()
    setup = free_surface.build_setup(phi, weights, config=cfg)
    free_surface.project(setup, velocity, config=cfg)  # a projection program's size on record
    project_bytes = sum(p.pool_bytes for k, p in graph.PROGRAMS.entries.items() if k[0] == "project")
    total = torch.cuda.get_device_properties(torch.device(device)).total_memory
    monkeypatch.setattr(graph.PROGRAMS, "budget", project_bytes / total)  # half of it is the limit
    graph.STATS.reset()
    old = torch.zeros_like(phi)  # a warm start: another key
    got = [free_surface.project(setup, velocity, config=cfg, old_pressure=old) for _ in range(3)]
    assert graph.STATS.program_captures["project"] == 0 and graph.STATS.program_hits["project"] == 0
    assert graph.STATS.program_declined["project"] == 3 and graph.STATS.captures == 3
    assert len(graph.PROGRAMS) == 2 and sum(graph.STATS.program_evictions.values()) == 0
    with graph.programs_off():
        want = free_surface.project(setup, velocity, config=cfg, old_pressure=old)
    for g in got:
        assert g.cg.iterations == want.cg.iterations and torch.equal(g.pressure, want.pressure)
    graph.PROGRAMS.clear()


def test_program_capture_raises(device, monkeypatch):
    """A failed program capture (a host read inside the CG iteration)
    raises, caches nothing and runs nothing eagerly in its place; the next
    call captures and runs."""
    from geometricmultigridpressuresolver_tpu_torch.solver import cg, graph

    setup, rhs, cfg, mesh = _graph_case(device, "fp32")
    graph.PROGRAMS.clear()
    tail = cg.FusedCG.tail

    def reading_tail(self, s):
        tail(self, s)
        float(s.rho)  # a sync: illegal while capturing

    monkeypatch.setattr(cg.FusedCG, "tail", reading_tail)
    with pytest.raises(RuntimeError):
        mgpcg.solve(setup.problem, rhs, config=cfg)
    assert len(graph.PROGRAMS) == 0
    monkeypatch.undo()
    assert mgpcg.solve(setup.problem, rhs, config=cfg).converged and len(graph.PROGRAMS) == 1
