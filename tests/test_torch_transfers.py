"""The matrix-product transfers (ops/transfer.py `restrict_mm`,
`prolong_add_mm`, `restrict_natural_mm`; `SolverConfig.transfer_mode`;
`solver/mg.py::use_mm_transfers`) against the JAX package.

The JAX side runs with ``transfer_mode="mm"`` set explicitly: its "auto"
is the slice form off the TPU, as the port's is off the card.  Tolerances
(relative to the largest magnitude): fp64 1e-13 for one transfer, 1e-10
for a V-cycle, an MGPCG solve and a frame; fp32 1e-6; bf16 storage one
bf16 ulp at the output's scale (both packages round each product once).
The pair is adjoint, <R f, c> = <f, P c> / 32, to 1e-12, and the matrix
form equals the port's slice form to 1e-12.  A rank's block of a (2, 2,
1) split, contracted with its one-cell margin, equals the whole transfer
cut to that block to 1e-13.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geometricmultigridpressuresolver_tpu.config import SolverConfig as JaxConfig
from geometricmultigridpressuresolver_tpu.models import sdf as jax_sdf
from geometricmultigridpressuresolver_tpu.models import simulate as jax_sim
from geometricmultigridpressuresolver_tpu.ops import transfer as jax_transfer
from geometricmultigridpressuresolver_tpu.solver import mg as jax_mg
from geometricmultigridpressuresolver_tpu.solver import mgpcg as jax_mgpcg
from geometricmultigridpressuresolver_tpu_torch import interop
from geometricmultigridpressuresolver_tpu_torch.config import SolverConfig
from geometricmultigridpressuresolver_tpu_torch.models import simulate
from geometricmultigridpressuresolver_tpu_torch.ops import transfer
from geometricmultigridpressuresolver_tpu_torch.parallel.mesh import local_slices
from geometricmultigridpressuresolver_tpu_torch.solver import mg, mgpcg
from tests import helpers

torch.set_num_threads(1)

MM = dict(transfer_mode="mm")
TOL = {torch.float64: 1e-13, torch.float32: 1e-6}
JAX_DTYPE = {torch.float64: jnp.float64, torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _rel(got, want) -> float:
    got, want = np.asarray(got, dtype=np.float64), np.asarray(want, dtype=np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-300))


def _bf16_ulp(want) -> float:
    """One bf16 ulp at the largest magnitude of `want` (8 significant bits)."""
    return 2.0 ** (np.floor(np.log2(np.abs(np.asarray(want, dtype=np.float64)).max())) - 7)


def _fields(fine_shape, coarse_shape, masked: bool, seed: int):
    """Seeded fine and coarse fields, zero outside their solvable sets (all
    true, or ~70% of the cells with the coarse lane padding exterior)."""
    rng = np.random.default_rng(seed)
    fine_solv = np.ones(fine_shape, bool)
    coarse_solv = np.ones(coarse_shape, bool)
    if masked:
        fine_solv = rng.random(fine_shape) < 0.7
        coarse_solv = rng.random(coarse_shape) < 0.7
        coarse_solv[:, :, fine_shape[2] // 2:] = False
    fine = np.where(fine_solv, rng.standard_normal(fine_shape), 0.0)
    coarse = np.where(coarse_solv, rng.standard_normal(coarse_shape), 0.0)
    return fine, coarse, fine_solv, coarse_solv


# JAX's own fixture (tests/test_operators.py::test_mm_transfers_match_slice_path):
# fine (16, 24, 384), lane-padded coarse (8, 12, 256).
JAX_FIXTURE = ((16, 24, 384), (8, 12, 256))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("masked", [False, True], ids=["all_solvable", "masked"])
def test_mm_transfers_match_jax(dtype, masked):
    fine, coarse, fine_solv, coarse_solv = _fields(*JAX_FIXTURE, masked, seed=9)
    jdt = JAX_DTYPE[dtype]
    jf, jc = jnp.asarray(fine).astype(jdt), jnp.asarray(coarse).astype(jdt)
    tf, tc = torch.from_numpy(fine).to(dtype), torch.from_numpy(coarse).to(dtype)
    want_r = np.asarray(jax_transfer.restrict_mm(jf, jnp.asarray(coarse_solv)).astype(jnp.float64))
    want_p = np.asarray(jax_transfer.prolong_add_mm(jf, jc, jnp.asarray(fine_solv)).astype(jnp.float64))
    got_r = transfer.restrict_mm(tf, torch.from_numpy(coarse_solv))
    got_p = transfer.prolong_add_mm(tf, tc, torch.from_numpy(fine_solv))
    assert got_r.dtype == got_p.dtype == dtype
    assert tuple(got_r.shape) == JAX_FIXTURE[1] and tuple(got_p.shape) == JAX_FIXTURE[0]
    assert float(got_r[:, :, 192:].abs().max()) == 0.0
    for got, want in ((got_r, want_r), (got_p, want_p)):
        got = got.double().numpy()
        if dtype == torch.bfloat16:
            assert np.abs(got - want).max() <= _bf16_ulp(want)
        else:
            assert _rel(got, want) <= TOL[dtype]


def test_restrict_matrix_is_jax():
    for n_fine, n_coarse in ((16, 8), (384, 256), (24, 12)):
        np.testing.assert_array_equal(
            transfer.restrict_matrix(n_fine, n_coarse), jax_transfer._restrict_matrix_np(n_fine, n_coarse)
        )


@pytest.mark.parametrize("masked", [False, True], ids=["all_solvable", "masked"])
def test_mm_transfers_adjoint_and_equal_to_slice_form(masked):
    fine, coarse, fine_solv, coarse_solv = _fields(*JAX_FIXTURE, masked, seed=3)
    tf, tc = torch.from_numpy(fine), torch.from_numpy(coarse)
    fs, cs = torch.from_numpy(fine_solv), torch.from_numpy(coarse_solv)
    r_mm = transfer.restrict_mm(tf, cs)
    p_mm = transfer.prolong_add_mm(torch.zeros_like(tf), tc, fs)
    np.testing.assert_allclose(r_mm.numpy(), transfer.restrict(tf, cs).numpy(), rtol=0, atol=1e-12)
    np.testing.assert_allclose(
        p_mm.numpy(), transfer.prolong_add(torch.zeros_like(tf), tc, fs).numpy(), rtol=0, atol=1e-12
    )
    np.testing.assert_allclose(
        transfer.restrict_natural_mm(tf).numpy(), transfer.restrict_natural(tf).numpy(), rtol=0, atol=1e-12
    )
    lhs = float(torch.sum(r_mm * tc))
    rhs = float(torch.sum(tf * p_mm)) / 32.0
    np.testing.assert_allclose(lhs, rhs, rtol=1e-12)


@pytest.mark.parametrize("fine_shape, coarse_nz", [((16, 24, 32), 16), ((16, 24, 384), 256)])
def test_margin_form_equals_whole_transfer_cut(fine_shape, coarse_nz):
    """Every rank's block of a (2, 2, 1) split: restriction of the block
    grown by a one-cell halo (zeros past the grid) with margin (1, 1, 0),
    and prolongation from the coarse cells under the block with their
    one-cell margin (the coarse z axis whole, lane padding included),
    against the whole matrix-form transfers cut to the block."""
    coarse_shape = (fine_shape[0] // 2, fine_shape[1] // 2, coarse_nz)
    fine, coarse, fine_solv, _ = _fields(fine_shape, coarse_shape, True, seed=11)
    tf, tc, fs = torch.from_numpy(fine), torch.from_numpy(coarse), torch.from_numpy(fine_solv)
    natural = (fine_shape[0] // 2, fine_shape[1] // 2, fine_shape[2] // 2)
    whole_r = transfer.restrict_natural_mm(tf)
    assert tuple(whole_r.shape) == natural
    whole_p = transfer.prolong_add_mm(tf, tc, fs)
    margin = (1, 1, 0)
    grown_f = torch.nn.functional.pad(tf, (0, 0, 1, 1, 1, 1))
    grown_c = torch.nn.functional.pad(tc, (0, 0, 1, 1, 1, 1))
    split = (True, True, False)
    for rank in range(4):
        own = local_slices((2, 2, 1), fine_shape, rank, split)
        block_f = grown_f[own[0].start:own[0].stop + 2, own[1].start:own[1].stop + 2]
        got_r = transfer.restrict_natural_mm(block_f, margin)
        want_r = whole_r[tuple(slice(s.start // 2, s.stop // 2) for s in own)]
        assert _rel(got_r.numpy(), want_r.numpy()) <= 1e-13
        block_c = grown_c[own[0].start // 2:own[0].stop // 2 + 2, own[1].start // 2:own[1].stop // 2 + 2]
        got_p = transfer.prolong_add_mm(tf[own], block_c, fs[own], margin)
        assert _rel(got_p.numpy(), whole_p[own].numpy()) <= 1e-13
        # The slice form on the same margins: the same block to rounding.
        np.testing.assert_allclose(
            got_p.numpy(), transfer.prolong_add(tf[own], block_c, fs[own], margin).numpy(), rtol=0, atol=1e-12
        )


def _tree(o):
    if hasattr(o, "_asdict"):
        return {k: _tree(v) for k, v in o._asdict().items()}
    if isinstance(o, (tuple, list)):
        return [_tree(v) for v in o]
    return np.asarray(o)


@pytest.fixture(scope="module")
def sine16():
    """tests/test_torch_operators.py's 16^3 sine-Dirichlet fixture with
    fractional weights: the JAX hierarchy (three levels, the coarse z lane
    aligned) and the same hierarchy carried into the port."""
    labels, weights, mg_levels = helpers.expanded_domain(helpers.sine_dirichlet_domain, 16, fractional=True)
    jh = jax_mg.build_hierarchy(labels, weights, mg_levels, JaxConfig(**MM))
    th = interop.hierarchy_from_arrays(_tree(jh), device="cpu")
    return labels, weights, mg_levels, jh, th


def test_v_cycle_mm_matches_jax(sine16):
    labels, _, _, jh, th = sine16
    assert th.num_levels >= 3
    b = helpers.random_solvable_field(labels, seed=5)
    jcfg, tcfg = JaxConfig(**MM), SolverConfig(**MM)
    want = np.asarray(jax_mg.v_cycle(jh, jnp.zeros_like(jnp.asarray(b)), jnp.asarray(b), jcfg))
    z, rho = mg.v_cycle(th, None, torch.from_numpy(b), tcfg, emit_fine_dot=True)
    assert _rel(z.numpy(), want) <= 1e-10
    np.testing.assert_allclose(float(rho), float(np.sum(want * b)), rtol=1e-10)
    # The slice form of the same cycle: the same operator to rounding.
    assert _rel(mg.v_cycle(th, None, torch.from_numpy(b), SolverConfig()).numpy(), want) <= 1e-10


def test_mgpcg_mm_iterations_match_jax(sine16):
    """tests/test_torch_slice.py::test_solvers_match_jax_on_fixture16's
    solve with the matrix-form transfers in both packages."""
    labels, weights, mg_levels, _, _ = sine16
    rhs = helpers.random_solvable_field(labels, seed=4)
    jcfg, tcfg = JaxConfig(tolerance=1e-8, **MM), SolverConfig(tolerance=1e-8, **MM)
    want = jax_mgpcg.solve(jax_mgpcg.build_problem(labels, weights, mg_levels, jcfg), jnp.asarray(rhs), config=jcfg)
    got = mgpcg.solve(mgpcg.build_problem(labels, weights, mg_levels, tcfg, device="cpu"),
                      torch.from_numpy(rhs), config=tcfg)
    assert got.converged and got.iterations == int(want.iterations)
    assert _rel(got.x.numpy(), want.x) <= 1e-10


def test_run_fused_frame_mm_matches_jax():
    """One `run_fused` frame of the 16^3 splash with the matrix-form
    transfers against the JAX package's `run_fused`, fp64."""
    n, dt = 16, 1.0 / 60.0
    phi, velocity = jax_sdf.splash_scene((n, n, n))
    weights = jax_sdf.open_box_weights((n, n, n))
    jcfg, tcfg = JaxConfig(tolerance=1e-8, **MM), SolverConfig(tolerance=1e-8, **MM)
    j_phi, j_vel, j_p, j_stats = jax_sim.run_fused(
        jnp.asarray(phi), tuple(map(jnp.asarray, velocity)), weights, num_frames=1, dt=dt, config=jcfg, chunk=1
    )
    t_phi, t_vel, t_p, t_stats = simulate.run_fused(
        phi, velocity, weights, num_frames=1, dt=dt, config=tcfg, chunk=1, device="cpu"
    )
    assert list(t_stats["iterations"]) == [int(i) for i in np.asarray(j_stats["iterations"])]
    assert _rel(t_phi.numpy(), j_phi) <= 1e-12
    assert _rel(t_p.numpy(), j_p) <= 1e-10
    for a in range(3):
        assert _rel(t_vel[a].numpy(), j_vel[a]) <= 1e-10
