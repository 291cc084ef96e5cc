"""Band-restricted boundary passes and bf16 field storage, port vs JAX.

The port's smoother restricts `b` passes to a compacted band-cell list
(config.pallas_band_strip > 0) and can store the V-cycle's fields in
bfloat16 (config.mg_field_dtype).  On the CPU the plain versions run;
their kernels are held against them on the card (tests/test_torch_cuda.py,
chip_smoke.py).  Fixture: the 32^3 sine-Dirichlet domain of
tests/test_pallas_smoother.py (expanded to 64^3), coefficients carried
over from the JAX hierarchy bit for bit with `interop`.

Tolerances: the band-restricted plain pass and blocks equal the full ones
exactly (off the band a `b` pass is the identity).  bf16 outputs agree with
the Pallas kernel run in interpret mode within one bf16 ulp at the output's
scale (both compute in fp32 and round once; the sums differ in order);
dots within 1e-5 relative.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geometricmultigridpressuresolver_tpu.config import SolverConfig as JaxConfig
from geometricmultigridpressuresolver_tpu.ops import pallas_smoother
from geometricmultigridpressuresolver_tpu.solver import mg as jax_mg
from geometricmultigridpressuresolver_tpu.solver import mgpcg as jax_mgpcg
from geometricmultigridpressuresolver_tpu_torch import interop
from geometricmultigridpressuresolver_tpu_torch.config import SolverConfig
from geometricmultigridpressuresolver_tpu_torch.ops import fused_smoother, stencil
from geometricmultigridpressuresolver_tpu_torch.solver import mg, mgpcg
from tests import helpers

torch.set_num_threads(1)

DEFAULT_DOWN = ("b", "b", "b", "r", "k", "b", "b", "b")


def _arrays(o):
    return {f: np.asarray(getattr(o, f)) for f in o._fields}


def _bf16_ulp(scale: float) -> float:
    return 2.0 ** (math.floor(math.log2(scale)) - 7)


@pytest.fixture(scope="module")
def domain32():
    return helpers.expanded_domain(helpers.sine_dirichlet_domain, 32, fractional=True)


@pytest.fixture(scope="module")
def hier32(domain32):
    labels, weights, mg_levels = domain32
    jh = jax_mg.build_hierarchy(labels, weights, mg_levels, JaxConfig(solve_dtype=jnp.float32))
    th = interop.hierarchy_from_arrays({
        "levels": [_arrays(c) for c in jh.levels],
        "coarse_dofs": np.asarray(jh.coarse_dofs),
        "coarse_minv": np.asarray(jh.coarse_minv),
        "coarse_chol": np.asarray(jh.coarse_chol),
    }, device="cpu")
    c = jh.levels[0]
    rng = np.random.default_rng(7)
    solv = np.asarray(c.solvable)
    x = np.where(solv, rng.standard_normal(c.shape), 0.0).astype(np.float32)
    b = np.where(solv, rng.standard_normal(c.shape), 0.0).astype(np.float32)
    return jh, th, x, b


@pytest.mark.parametrize("level", [0, 1, 2])
def test_band_list_equals_flatnonzero(hier32, level):
    jh, th, _, _ = hier32
    band = th.levels[level].band
    cells = fused_smoother.band_cells(band)
    assert cells.dtype == torch.int32 and cells.numel() == band.numel()
    want = np.flatnonzero(np.asarray(jh.levels[level].band))
    assert want.size > 0
    # Padded to the level's cell count with the sentinel cell count.
    assert int(fused_smoother.list_count(cells, band.numel())) == want.size
    np.testing.assert_array_equal(cells[:want.size].numpy(), want)
    assert (cells[want.size:] == band.numel()).all()


def test_pass_plan_band_only_passes():
    plan = fused_smoother.pass_plan(DEFAULT_DOWN, band=True, final_full=False)
    assert [s.band_only for s in plan] == [False, False, True, False, False, False, True, True]
    assert [(s.src, s.dst) for s in plan] == [
        ("x", 0), (0, 1), (1, 0), (0, 0), (0, 0), (0, 1), (1, 0), (0, 1)
    ]
    # The dot and the narrow output need every cell: the last pass is full.
    final = fused_smoother.pass_plan(DEFAULT_DOWN, band=True, final_full=True)
    assert [s.band_only for s in final] == [False, False, True, False, False, False, True, False]
    assert not any(s.band_only for s in fused_smoother.pass_plan(DEFAULT_DOWN, False, False))
    # Jacobi interior pass: out of place, breaks the agreement off the band.
    jac = fused_smoother.pass_plan(("b", "b", "j", "b", "b"), band=True, final_full=False)
    assert [s.band_only for s in jac] == [False, False, False, False, True]


@pytest.mark.parametrize("dtype, ew_dtype", [(torch.float64, None), (torch.float32, torch.bfloat16)])
def test_band_plain_pass_equals_full_plain_pass(hier32, dtype, ew_dtype):
    """One band-restricted pass writes exactly the full pass's numbers on the
    band and leaves every other cell of its target alone."""
    _, th, x, b = hier32
    c = th.levels[0]
    if ew_dtype is not None:
        c = c._replace(ew0=c.ew0.to(ew_dtype), ew1=c.ew1.to(ew_dtype), ew2=c.ew2.to(ew_dtype))
    c = c._replace(diag=c.diag.to(dtype), inv_diag=c.inv_diag.to(dtype))
    xt, bt = torch.from_numpy(x).to(dtype), torch.from_numpy(b).to(dtype)
    cfg = SolverConfig(solve_dtype=dtype, boundary_iterations=1, use_gauss_seidel=False,
                       pallas_band_strip=0)
    # The full plain pass: the first pass of a (b, j, b) block, by itself.
    band_f = c.band.to(dtype)
    w = cfg.jacobi_damping
    full = (1.0 - w * band_f) * xt + (w * band_f * c.inv_diag) * (
        bt + stencil.neighbor_sum(xt, c)
    )
    sentinel = torch.full_like(xt, 7.0)
    got = fused_smoother.band_pass_torch(xt, sentinel.clone(), bt, c, fused_smoother.band_cells(c.band), w)
    on_band = c.band.bool()
    assert torch.equal(got[on_band], full[on_band])
    assert (got[~on_band] == 7.0).all()
    assert torch.equal(torch.where(on_band, got, xt), full)


@pytest.mark.parametrize("variant", ["down", "up_dot", "warm", "jacobi"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_band_restricted_block_equals_full_block(hier32, variant, dtype):
    """Whole blocks through the buffer plan (band-only passes write into
    buffers that agree off the band) equal the all-full blocks bit for
    bit, at every smoothed level."""
    _, th, _, _ = hier32
    rng = np.random.default_rng(11)
    kw = {
        "down": dict(forward=True, x_is_zero=True, emit_residual=True),
        "up_dot": dict(forward=False, emit_dot=True),
        "warm": dict(forward=True),
        "jacobi": dict(forward=True, emit_dot=True),
    }[variant]
    extra = {"use_gauss_seidel": False} if variant == "jacobi" else {}
    band = SolverConfig(solve_dtype=dtype, **extra)
    full = SolverConfig(solve_dtype=dtype, pallas_band_strip=0, **extra)
    for c in th.levels[:-1]:
        c = c._replace(diag=c.diag.to(dtype), inv_diag=c.inv_diag.to(dtype))
        solv = c.solvable.numpy()
        x = torch.from_numpy(np.where(solv, rng.standard_normal(c.shape), 0.0)).to(dtype)
        b = torch.from_numpy(np.where(solv, rng.standard_normal(c.shape), 0.0)).to(dtype)
        blocks = fused_smoother.level_blocks(c, band)
        assert blocks.band_cells is not None
        assert fused_smoother.level_blocks(c, full).band_cells is None
        got = fused_smoother.smooth_level(x, b, c, band, blocks=blocks, **kw)
        want = fused_smoother.smooth_level(x, b, c, full, **kw)
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        for g, w in zip(got, want):
            assert torch.equal(g, w)


def test_band_strip_vcycle_matches_jax_jnp(domain32):
    """A default-config V-cycle (band-restricted passes at every level)
    matches the JAX package's jnp cycle in fp64 to 1e-12."""
    rng = np.random.default_rng(5)
    jh64 = jax_mg.build_hierarchy(*domain32, JaxConfig())
    th64 = interop.hierarchy_from_arrays({
        "levels": [_arrays(c) for c in jh64.levels],
        "coarse_dofs": np.asarray(jh64.coarse_dofs),
        "coarse_minv": np.asarray(jh64.coarse_minv),
        "coarse_chol": np.asarray(jh64.coarse_chol),
    }, device="cpu")
    solv = np.asarray(jh64.levels[0].solvable)
    rhs = np.where(solv, rng.standard_normal(solv.shape), 0.0)
    ref = jax_mg.v_cycle(jh64, jnp.zeros_like(jnp.asarray(rhs)), jnp.asarray(rhs), JaxConfig())
    got = mg.v_cycle(th64, None, torch.from_numpy(rhs), SolverConfig())
    assert SolverConfig().pallas_band_strip == 128
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-12)


@pytest.mark.parametrize("variant", ["down_residual_dot", "up_dot", "warm"])
def test_bf16_plain_smoother_matches_pallas(hier32, variant):
    """bf16 x/b through the plain version against the Pallas kernel in
    interpret mode (the fixture of tests/test_pallas_smoother.py:431-451):
    within one bf16 ulp at the output's scale."""
    jh, th, x, b = hier32
    c = jh.levels[0]
    kw = {
        "down_residual_dot": dict(forward=True, x_is_zero=True, emit_residual=True, emit_dot=True),
        "up_dot": dict(forward=False, emit_dot=True),
        "warm": dict(forward=True),
    }[variant]
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    jb = jnp.asarray(b).astype(jnp.bfloat16)
    if kw.get("x_is_zero"):
        jx = jnp.zeros_like(jx)
    ref = pallas_smoother.smooth_level_pallas(
        jx, jb, c, JaxConfig(solve_dtype=jnp.float32), interpret=True, **kw
    )
    xt = None if kw.get("x_is_zero") else torch.from_numpy(x).to(torch.bfloat16)
    bt = torch.from_numpy(b).to(torch.bfloat16)
    got = fused_smoother.smooth_level_torch(
        xt, bt, th.levels[0], SolverConfig(solve_dtype=torch.float32), **kw
    )
    ref = ref if isinstance(ref, tuple) else (ref,)
    got = got if isinstance(got, tuple) else (got,)
    assert got[0].dtype == torch.bfloat16
    grids = 2 if kw.get("emit_residual") else 1
    for r, g in zip(ref[:grids], got[:grids]):
        want = np.asarray(r.astype(jnp.float32))
        assert g.dtype == torch.bfloat16
        diff = np.abs(g.float().numpy() - want).max()
        assert diff <= _bf16_ulp(np.abs(want).max()), diff
    if kw.get("emit_dot"):
        assert got[-1].dtype == torch.float32
        np.testing.assert_allclose(float(got[-1]), float(ref[-1]), rtol=1e-5)
    assert (got[0].float()[~th.levels[0].solvable] == 0).all()


def test_bf16_vcycle_matches_jax(hier32):
    """A V-cycle with mg_field_dtype=bfloat16 returns the mg dtype and stays
    within the JAX test's bound (tests/test_pallas_smoother.py:454-476:
    0.05 of the output's max) of the JAX cycle; measured 1.5e-2 on this
    fixture.  The JAX package narrows only levels eligible for its Pallas
    kernel, none at this size, so its cycle here is the fp32 one."""
    jh, th, _, b = hier32
    cfg = JaxConfig(
        solve_dtype=jnp.float32, kernel_mode="pallas", pallas_interpret=True,
        mg_field_dtype=jnp.bfloat16,
    )
    jb = jnp.asarray(b)
    ref, rho_ref = jax_mg.v_cycle(jh, jnp.zeros_like(jb), jb, cfg, emit_fine_dot=True)
    tcfg = SolverConfig(solve_dtype=torch.float32, mg_field_dtype=torch.bfloat16)
    assert mg.field_dtype(th, tcfg) == torch.bfloat16
    got, rho = mg.v_cycle(th, None, torch.from_numpy(b), tcfg, emit_fine_dot=True)
    assert got.dtype == torch.float32 and rho.dtype == torch.float32
    ref = np.asarray(ref)
    diff = np.abs(got.numpy() - ref).max() / np.abs(ref).max()
    assert diff < 0.05, diff
    np.testing.assert_allclose(float(rho), float(rho_ref), rtol=0.05)


def test_field_dtype_gates():
    """Narrow storage: float32 V-cycles only, and only when the downstroke
    can emit its residual (the JAX package's residual_fusable gate)."""
    labels, weights, mg_levels = helpers.expanded_domain(helpers.sine_dirichlet_domain, 16)
    bf = torch.bfloat16
    h32 = mg.build_hierarchy(labels, weights, mg_levels, SolverConfig(solve_dtype=torch.float32), device="cpu")
    h64 = mg.build_hierarchy(labels, weights, mg_levels, SolverConfig(), device="cpu")
    assert mg.field_dtype(h32, SolverConfig(mg_field_dtype=bf)) == bf
    assert mg.field_dtype(h64, SolverConfig(mg_field_dtype=bf)) == torch.float64
    assert mg.field_dtype(h32, SolverConfig()) == torch.float32
    deep = SolverConfig(mg_field_dtype=bf, boundary_iterations=7)  # 16 passes
    assert not fused_smoother.residual_fusable(deep)
    assert pallas_smoother.residual_fusable(JaxConfig(boundary_iterations=7)) is False
    assert mg.field_dtype(h32, deep) == torch.float32
    blocks = mg.hierarchy_block_lists(h32, SolverConfig(mg_field_dtype=bf))
    assert blocks[-1] is None
    for blk in blocks[:-1]:
        assert blk.narrow.inv_diag.dtype == bf and blk.narrow.diag.dtype == torch.float32
        assert blk.band_cells is not None


def test_bf16_field_solve_matches_jax_iterations(domain32):
    """A 32^3 fp32 MGPCG solve with bf16 fields converges and matches the
    JAX package's iteration count within 1 (measured: 7 and 7)."""
    labels, weights, mg_levels = domain32
    rhs = helpers.random_solvable_field(labels, seed=4).astype(np.float32)
    jcfg = JaxConfig(
        solve_dtype=jnp.float32, kernel_mode="pallas", pallas_interpret=True,
        mg_field_dtype=jnp.bfloat16,
    )
    jres = jax_mgpcg.solve(
        jax_mgpcg.build_problem(labels, weights, mg_levels, jcfg), jnp.asarray(rhs), config=jcfg
    )
    tcfg = SolverConfig(solve_dtype=torch.float32, mg_field_dtype=torch.bfloat16)
    tres = mgpcg.solve(
        mgpcg.build_problem(labels, weights, mg_levels, tcfg, device="cpu"), torch.from_numpy(rhs), config=tcfg
    )
    assert tres.converged and tres.relative_residual <= 1e-5
    assert abs(tres.iterations - int(jres.iterations)) <= 1
    assert tres.x.dtype == torch.float32
