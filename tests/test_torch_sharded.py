"""The port's block-mesh path against the JAX package's sharded path.

`parallel/fused_sharded.py` (the block-mesh smoother and CG step over a
stacked grid of haloed blocks) is held against
``parallel/pallas_sharded.py`` run in interpret mode on the conftest's
virtual CPU devices, at the JAX tests' sizes and tolerances (x 2e-6,
r 2e-5, dots rtol 1e-5 in fp32).  In fp64 the sharded block's cores equal
the port's single-device block to 1e-12 (same per-cell arithmetic, only
the dot's order differs), and whole sharded solves and projections equal
the JAX package's single-device ones to 1e-11 with equal iterations (the
tolerance of tests/test_sharded.py).  Inputs are made with numpy from a
seed; hierarchies are carried across with `interop` on the CPU.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geometricmultigridpressuresolver_tpu.config import SolverConfig as JaxConfig
from geometricmultigridpressuresolver_tpu.models import free_surface as jax_fs
from geometricmultigridpressuresolver_tpu.models import sdf as jax_sdf
from geometricmultigridpressuresolver_tpu.parallel import mesh as jax_mesh
from geometricmultigridpressuresolver_tpu.parallel import pallas_sharded
from geometricmultigridpressuresolver_tpu.solver import mg as jax_mg
from geometricmultigridpressuresolver_tpu.solver import mgpcg as jax_mgpcg
from geometricmultigridpressuresolver_tpu_torch import interop
from geometricmultigridpressuresolver_tpu_torch.config import SolverConfig
from geometricmultigridpressuresolver_tpu_torch.models import free_surface
from geometricmultigridpressuresolver_tpu_torch.ops import fused_cg, fused_smoother
from geometricmultigridpressuresolver_tpu_torch.parallel import fused_sharded, halo
from geometricmultigridpressuresolver_tpu_torch.parallel.mesh import (
    BlockMesh,
    factor_mesh,
    grid_split,
    make_mesh,
)
from geometricmultigridpressuresolver_tpu_torch.solver import mg, mgpcg
from tests import helpers

torch.set_num_threads(1)
CPU = torch.device("cpu")
MESH_421 = BlockMesh((4, 2, 1), CPU)

SMOOTH_CASES = {
    "forward": dict(forward=True),
    "backward": dict(forward=False),
    "zero_x_emit_residual": dict(forward=True, x_is_zero=True, emit_residual=True),
    "emit_dot": dict(forward=False, emit_dot=True),
    "warm_emit_dot": dict(forward=True, emit_dot=True),
}


def _jax_mesh(shape):
    n = int(np.prod(shape))
    return jax.sharding.Mesh(np.array(jax.devices()[:n]).reshape(shape), ("x", "y", "z"))


def _level_arrays(c):
    return {f: np.asarray(getattr(c, f)) for f in c._fields}


@pytest.fixture(scope="module")
def sine32_f32():
    """The 32^3 sine-Dirichlet fractional fixture (window (64, 64, 64)), its
    fp32 JAX level 0 carried into the port, and seeded fields."""
    labels, weights, mg_levels = helpers.expanded_domain(
        helpers.sine_dirichlet_domain, 32, fractional=True
    )
    jc = JaxConfig(solve_dtype=jnp.float32)
    c = jax_mg.build_hierarchy(labels, weights, mg_levels, jc).levels[0]
    ct = interop.level_from_arrays(_level_arrays(c), device="cpu")
    rng = np.random.default_rng(29)
    solv = np.asarray(c.solvable)
    x, b = (np.where(solv, rng.standard_normal(c.shape), 0.0).astype(np.float32) for _ in range(2))
    return jc, c, ct, x, b


def _as_tuple(v):
    return v if isinstance(v, tuple) else (v,)


@pytest.mark.parametrize("case", list(SMOOTH_CASES))
def test_smooth_level_sharded_matches_jax(sine32_f32, case):
    jc, c, ct, x, b = sine32_f32
    kw = SMOOTH_CASES[case]
    jmesh = _jax_mesh((4, 2, 1))
    want = _as_tuple(pallas_sharded.smooth_level_sharded(
        jnp.zeros_like(jnp.asarray(x)) if kw.get("x_is_zero") else jnp.asarray(x),
        jnp.asarray(b), c, jc, mesh=jmesh, interpret=True, **kw,
    ))
    tc = SolverConfig(solve_dtype=torch.float32)
    xin = None if kw.get("x_is_zero") else torch.from_numpy(x)
    got = _as_tuple(fused_sharded.smooth_level_sharded(
        xin, torch.from_numpy(b), ct, tc, mesh=MESH_421, **kw
    ))
    assert len(got) == len(want)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=0, atol=2e-6)
    if kw.get("emit_residual"):
        np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=0, atol=2e-5)
    if kw.get("emit_dot"):
        np.testing.assert_allclose(float(got[-1]), float(want[-1]), rtol=1e-5)


def test_cg_step_sharded_matches_jax(sine32_f32):
    jc, c, ct, z, p = sine32_f32
    beta = 0.4113
    pn_j, ap_j, pap_j = pallas_sharded.cg_step_sharded(
        jnp.asarray(z), jnp.asarray(p), jnp.float32(beta), c, jc, _jax_mesh((4, 2, 1)), interpret=True
    )
    pn, ap, pap = fused_sharded.cg_step_sharded(
        torch.from_numpy(z), torch.from_numpy(p), torch.tensor(beta, dtype=torch.float32), ct,
        SolverConfig(solve_dtype=torch.float32), MESH_421,
    )
    np.testing.assert_allclose(pn.numpy(), np.asarray(pn_j), rtol=0, atol=2e-6)
    np.testing.assert_allclose(ap.numpy(), np.asarray(ap_j), rtol=0, atol=2e-5)
    np.testing.assert_allclose(float(pap), float(pap_j), rtol=1e-5)


def test_stacked_halos_match_jax_prehalo(sine32_f32):
    """The stacked layout holds exactly JAX's haloed per-device blocks
    (prehalo_cg_coeffs: ppermute exchange, x then y, zeros at the edges)."""
    _, c, ct, _, _ = sine32_f32
    want = pallas_sharded.prehalo_cg_coeffs(c, _jax_mesh((4, 2, 1)))
    got = fused_sharded.prehalo_cg_coeffs(ct, MESH_421)
    geom = halo.geometry(MESH_421, ct.shape)
    (mx, my), (bx, by), (hx, hy) = geom.blocks, geom.core, geom.halo
    for g, w in zip(got, want):
        w = np.asarray(w).reshape(mx, bx + 2 * hx, my, by + 2 * hy, -1).transpose(0, 2, 1, 3, 4)
        np.testing.assert_array_equal(g.numpy().reshape(w.shape), w)


@pytest.fixture(scope="module")
def sine32_f64():
    labels, weights, mg_levels = helpers.expanded_domain(
        helpers.sine_dirichlet_domain, 32, fractional=True
    )
    cfg = SolverConfig()
    hier = mg.build_hierarchy(labels, weights, mg_levels, cfg, device="cpu")
    rng = np.random.default_rng(31)
    c = hier.levels[0]
    x, b = (torch.where(c.solvable, torch.from_numpy(rng.standard_normal(c.shape)), 0.0) for _ in range(2))
    return cfg, c, x, b


@pytest.mark.parametrize("case", list(SMOOTH_CASES))
def test_sharded_block_equals_single_device_fp64(sine32_f64, case):
    cfg, c, x, b = sine32_f64
    kw = SMOOTH_CASES[case]
    xin = None if kw.get("x_is_zero") else x
    got = _as_tuple(fused_sharded.smooth_level_sharded(xin, b, c, cfg, mesh=make_mesh(4, device="cpu"), **kw))
    want = _as_tuple(fused_smoother.smooth_level(xin, b, c, cfg, **kw))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if g.dim():
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0, atol=1e-12)
        else:
            np.testing.assert_allclose(float(g), float(w), rtol=1e-12)


def test_sharded_cg_step_equals_single_device_fp64(sine32_f64):
    cfg, c, z, p = sine32_f64
    beta = torch.tensor(0.37, dtype=torch.float64)
    got = fused_sharded.cg_step_sharded(z, p, beta, c, cfg, make_mesh(4, device="cpu"))
    want = fused_cg.search_matvec_dot(z, p, beta, c.diag, c.ew0, c.ew1, c.ew2)
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0, atol=1e-12)
    np.testing.assert_allclose(float(got[2]), float(want[2]), rtol=1e-12)


@pytest.mark.parametrize(
    "domain, n, fractional",
    [(helpers.simple_domain, 16, False), (helpers.sine_dirichlet_domain, 32, True)],
    ids=["simple16", "sine32"],
)
def test_sharded_solve_matches_jax_single_device(domain, n, fractional):
    labels, weights, mg_levels = helpers.expanded_domain(domain, n, fractional=fractional)
    rhs = helpers.random_solvable_field(labels, seed=21)
    jcfg, tcfg = JaxConfig(tolerance=1e-8), SolverConfig(tolerance=1e-8)
    want = jax_mgpcg.solve(jax_mgpcg.build_problem(labels, weights, mg_levels, jcfg), jnp.asarray(rhs), config=jcfg)
    problem = mgpcg.build_problem(labels, weights, mg_levels, tcfg, device="cpu")
    mesh = make_mesh(4, device="cpu")
    flags = mg.level_flags(problem.hier, tcfg, mesh)
    assert flags[0] == "sharded", flags
    got = mgpcg.solve(problem, torch.from_numpy(rhs), config=tcfg, mesh=mesh)
    assert got.iterations == int(want.iterations)
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), rtol=0, atol=1e-11)


def test_sharded_projection_matches_jax_single_device():
    """The 40^3 splash: window (48, 48, 48), L0 split into 24x24 cores."""
    n = 40
    phi, velocity = jax_sdf.splash_scene((n, n, n))
    weights = jax_sdf.open_box_weights((n, n, n))
    jcfg, tcfg = JaxConfig(tolerance=1e-7), SolverConfig(tolerance=1e-7)
    jr = jax_fs.project(jax_fs.build_setup(phi, weights, config=jcfg), velocity, config=jcfg)
    setup = free_surface.build_setup(phi, weights, config=tcfg, device="cpu")
    mesh = make_mesh(4, device="cpu")
    assert setup.expanded_shape == (48, 48, 48)
    assert mg.level_flags(setup.problem.hier, tcfg, mesh)[0] == "sharded"
    tr = free_surface.project(setup, velocity, config=tcfg, mesh=mesh)
    assert tr.cg.iterations == int(jr.cg.iterations)
    np.testing.assert_allclose(tr.pressure.numpy(), np.asarray(jr.pressure), rtol=0, atol=1e-11)
    for a in range(3):
        np.testing.assert_allclose(tr.velocity[a].numpy(), np.asarray(jr.velocity[a]), rtol=0, atol=1e-11)
    assert float(tr.max_divergence) < 1e-6


def test_small_splash_windows_split_no_level():
    """The 32^3 and 64^3 splash windows (36, 36, 36) and (72, 68, 72): their
    cores (18, 36, 34) fail r % 8, so no level runs sharded."""
    mesh = make_mesh(4, device="cpu")
    for n, window in ((32, (36, 36, 36)), (64, (72, 68, 72))):
        phi, _ = jax_sdf.splash_scene((n, n, n))
        setup = free_surface.build_setup(phi, jax_sdf.open_box_weights((n, n, n)), device="cpu")
        assert setup.expanded_shape == window
        assert set(mg.level_flags(setup.problem.hier, SolverConfig(), mesh)) == {"single"}


def test_bench_window_flags():
    """The 256^3 bench hierarchy's shapes: L0 and L1 split into 2x2 blocks,
    L2 and L3 fail r % 8 (cores 36 and 18), L4 is too small to split."""
    shapes = [(288, 256, 384), (144, 128, 256), (72, 64, 128), (36, 32, 64), (18, 16, 32)]
    hier = types.SimpleNamespace(
        levels=[types.SimpleNamespace(shape=s) for s in shapes], num_levels=len(shapes)
    )
    flags = mg.level_flags(hier, SolverConfig(), make_mesh(4, device="cpu"))
    assert flags == ("sharded", "sharded", "single", "single", "single")


@pytest.mark.parametrize("n", [1, 2, 4, 6, 8, 12, 16])
def test_factor_mesh_matches_jax(n):
    assert factor_mesh(n) == jax_mesh.factor_mesh(n)


SHAPES = [
    (288, 256, 384), (144, 128, 256), (72, 64, 128), (36, 32, 64), (18, 16, 32),
    (64, 64, 64), (48, 48, 48), (96, 96, 128), (40, 16, 128), (16, 8, 256), (32, 48, 100),
]


@pytest.mark.parametrize("mesh_shape", [(2, 2, 1), (4, 2, 1), (2, 2, 2)])
def test_grid_split_and_eligibility_match_jax(mesh_shape):
    """grid_split equals grid_pspec; sharded_eligible equals JAX's where
    nz % 128 == 0.  Elsewhere JAX refuses for the Mosaic lane rule alone,
    and the port -- which drops that rule -- answers what JAX answers for
    the same shape with a lane-aligned nz."""
    jmesh = _jax_mesh(mesh_shape)
    tmesh = BlockMesh(mesh_shape, CPU)
    for shape in SHAPES:
        spec = jax_mesh.grid_pspec(jmesh, shape)
        split = grid_split(tmesh, shape)
        assert split == tuple(s is not None for s in spec), shape
        for level, nlev in ((0, 5), (2, 5)):
            got = fused_sharded.sharded_eligible(shape, split, tmesh, level, nlev)
            if shape[2] % 128 == 0:
                assert got == pallas_sharded.sharded_eligible(shape, spec, jmesh, level, nlev), shape
            else:
                assert not pallas_sharded.sharded_eligible(shape, spec, jmesh, level, nlev)
                aligned = shape[:2] + (128,)
                assert got == pallas_sharded.sharded_eligible(aligned, spec, jmesh, level, nlev), shape


def _transitive_exchange(t: np.ndarray, blocks, h: int) -> list:
    """Per block, the JAX exchange written out: grow by h along x from the
    x-neighbours (zeros at the mesh edge), then along y from the
    y-neighbours' x-haloed blocks."""
    mx, my = blocks
    bx, by = t.shape[0] // mx, t.shape[1] // my
    cores = [[t[i * bx:(i + 1) * bx, j * by:(j + 1) * by] for j in range(my)] for i in range(mx)]
    zx = np.zeros((h, by, t.shape[2]), t.dtype)
    xh = [[np.concatenate([
        cores[i - 1][j][-h:] if i > 0 else zx, cores[i][j], cores[i + 1][j][:h] if i + 1 < mx else zx,
    ], axis=0) for j in range(my)] for i in range(mx)]
    zy = np.zeros((bx + 2 * h, h, t.shape[2]), t.dtype)
    return [np.concatenate([
        xh[i][j - 1][:, -h:] if j > 0 else zy, xh[i][j], xh[i][j + 1][:, :h] if j + 1 < my else zy,
    ], axis=1) for i in range(mx) for j in range(my)]


@pytest.mark.parametrize("mesh_shape", [(2, 2, 1), (4, 2, 1), (3, 2, 1)])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32, torch.bfloat16, torch.int8])
def test_halo_plain_is_the_transitive_exchange(mesh_shape, dtype):
    """Zeros at the mesh edges, corners from the diagonal neighbour, for
    every dtype the kernel copies; the scatter returns the global grid."""
    shape = (48, 32, 12)
    rng = np.random.default_rng(3)
    t = torch.from_numpy(rng.integers(1, 100, shape).astype(np.float64)).to(dtype)
    geom = halo.geometry(BlockMesh(mesh_shape, CPU), shape)
    got = halo.halo_gather(t, geom)
    assert tuple(got.shape) == geom.stacked_shape
    want = _transitive_exchange(t.double().numpy(), mesh_shape[:2], halo.H)
    bxh = geom.stacked_shape[0] // geom.num_blocks
    for b, w in enumerate(want):
        np.testing.assert_array_equal(got[b * bxh:(b + 1) * bxh].double().numpy(), w)
    assert torch.equal(halo.core_scatter(got, geom), t)
    # The library expression the chip run times beside the kernel.
    padded = torch.nn.functional.pad(t.double(), (0, 0, halo.H, halo.H, halo.H, halo.H))
    (bx, by), (mx, my) = geom.core, geom.blocks
    lib = padded.unfold(0, bx + 2 * halo.H, bx).unfold(1, by + 2 * halo.H, by)
    lib = lib.permute(0, 1, 3, 4, 2).reshape(geom.stacked_shape)
    assert torch.equal(lib, got.double())


def test_odd_parity_split_is_refused():
    mesh = BlockMesh((2, 2, 1), CPU)
    with pytest.raises(ValueError, match="odd core extent"):
        halo.geometry(mesh, (42, 32, 32))
    c = types.SimpleNamespace(shape=(42, 32, 32))
    b = torch.zeros((42, 32, 32), dtype=torch.float64)
    with pytest.raises(ValueError, match="odd core extent"):
        fused_sharded.smooth_level_sharded(None, b, c, SolverConfig(), True, mesh, x_is_zero=True)


def test_emit_residual_needs_a_spare_ring(sine32_f64):
    """An 8-pass chunk from a streamed x has no spare ring for the fused
    residual (ops/pallas_smoother.py:670-674)."""
    cfg, c, x, b = sine32_f64
    with pytest.raises(ValueError, match="spare halo ring"):
        fused_sharded.smooth_level_sharded(x, b, c, cfg, True, make_mesh(4, device="cpu"), emit_residual=True)
    deep = SolverConfig(boundary_iterations=7)  # 16 passes: a full last chunk
    with pytest.raises(ValueError, match="spare halo ring"):
        fused_sharded.smooth_level_sharded(
            None, b, c, deep, True, make_mesh(4, device="cpu"), x_is_zero=True, emit_residual=True
        )


def test_deep_schedule_chunks_and_vcycle_matches_single_device(sine32_f64):
    """A 16-pass schedule runs in two chunks with a re-gather between them;
    the V-cycle then forms the sharded level's residual outside the
    smoother (JAX mg.py:853-887).  Equal to the single-device cycle."""
    cfg, c, x, b = sine32_f64
    deep = SolverConfig(boundary_iterations=7)
    mesh = make_mesh(4, device="cpu")
    got = fused_sharded.smooth_level_sharded(x, b, c, deep, False, mesh, emit_dot=True)
    want = fused_smoother.smooth_level(x, b, c, deep, False, emit_dot=True)
    np.testing.assert_allclose(got[0].numpy(), want[0].numpy(), rtol=0, atol=1e-12)
    np.testing.assert_allclose(float(got[1]), float(want[1]), rtol=1e-12)
    labels, weights, mg_levels = helpers.expanded_domain(helpers.sine_dirichlet_domain, 32, fractional=True)
    hier = mg.build_hierarchy(labels, weights, mg_levels, deep, device="cpu")
    r = torch.where(hier.levels[0].solvable, b, 0.0)
    np.testing.assert_allclose(
        mg.v_cycle(hier, None, r, deep, mesh=mesh).numpy(), mg.v_cycle(hier, None, r, deep).numpy(),
        rtol=0, atol=1e-12,
    )


def test_make_mesh_devices():
    assert make_mesh(4, device="cpu") == BlockMesh((2, 2, 1), CPU)
    assert make_mesh(8, device=["cpu", "cpu"]).shape == (2, 2, 2)
    with pytest.raises(NotImplementedError, match="several devices"):
        make_mesh(4, device=["cuda:0", "cuda:1"])


def test_make_mesh_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_mesh(4)
