"""Port's stencil, transfer, BLAS, coarse-solve and V-cycle operators.

Each is compared with the JAX package in fp64 on the same inputs (bit-equal
coefficients carried over with `interop`), to rounding: 1e-12 absolute on
O(1) fields, 1e-12 relative on reductions.  The six-operator symmetry suite
of tests/test_symmetry.py runs on the port itself at the reference's 1e-10.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geometricmultigridpressuresolver_tpu.config import SolverConfig as JaxConfig
from geometricmultigridpressuresolver_tpu.ops import blas as jax_blas
from geometricmultigridpressuresolver_tpu.ops import stencil as jax_stencil
from geometricmultigridpressuresolver_tpu.ops import transfer as jax_transfer
from geometricmultigridpressuresolver_tpu.solver import mg as jax_mg
from geometricmultigridpressuresolver_tpu_torch import interop
from geometricmultigridpressuresolver_tpu_torch.config import SolverConfig
from geometricmultigridpressuresolver_tpu_torch.ops import blas, domain, fused_smoother, stencil, transfer
from geometricmultigridpressuresolver_tpu_torch.solver import mg
from tests import helpers

torch.set_num_threads(1)

ATOL = 1e-12
SYM_TOL = 1e-10


def _tree(o):
    if hasattr(o, "_asdict"):
        return {k: _tree(v) for k, v in o._asdict().items()}
    if isinstance(o, (tuple, list)):
        return [_tree(v) for v in o]
    return np.asarray(o)


@pytest.fixture(scope="module")
def hier16():
    """16^3 sine-Dirichlet fixture with fractional weights: the JAX
    hierarchy and the same hierarchy carried into the port."""
    labels, weights, mg_levels = helpers.expanded_domain(
        helpers.sine_dirichlet_domain, 16, fractional=True
    )
    jh = jax_mg.build_hierarchy(labels, weights, mg_levels, JaxConfig())
    th = interop.hierarchy_from_arrays(_tree(jh), device="cpu")
    rng = np.random.default_rng(5)
    solv = np.asarray(jh.levels[0].solvable)
    x = np.where(solv, rng.standard_normal(solv.shape), 0.0)
    b = np.where(solv, rng.standard_normal(solv.shape), 0.0)
    return labels, weights, mg_levels, jh, th, x, b


_STENCIL_OPS = {
    "neighbor_sum": lambda m, x, b, c: m.neighbor_sum(x, c),
    "apply_poisson": lambda m, x, b, c: m.apply_poisson(x, c),
    "residual": lambda m, x, b, c: m.residual(x, b, c),
    "jacobi_smooth": lambda m, x, b, c: m.jacobi_smooth(x, b, c),
    "boundary_jacobi": lambda m, x, b, c: m.boundary_jacobi(x, b, c),
    "rb_gauss_seidel_fwd": lambda m, x, b, c: m.rb_gauss_seidel(x, b, c, True),
    "rb_gauss_seidel_bwd": lambda m, x, b, c: m.rb_gauss_seidel(x, b, c, False),
    "chebyshev_smooth": lambda m, x, b, c: m.chebyshev_smooth(x, b, c),
    "chebyshev_smooth_deg3": lambda m, x, b, c: m.chebyshev_smooth(x, b, c, 3),
}


@pytest.mark.parametrize("name", sorted(_STENCIL_OPS))
def test_stencil_matches_jax(hier16, name):
    _, _, _, jh, th, x, b = hier16
    op = _STENCIL_OPS[name]
    want = np.asarray(op(jax_stencil, jnp.asarray(x), jnp.asarray(b), jh.levels[0]))
    got = op(stencil, torch.from_numpy(x), torch.from_numpy(b), th.levels[0]).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_color_mask_matches_jax():
    for color in (0, 1):
        want = np.asarray(jax_stencil.color_mask((5, 6, 7), color))
        assert np.array_equal(stencil.color_mask((5, 6, 7), color).numpy(), want)


@pytest.mark.parametrize("nz", [32, 384])
def test_transfers_match_jax(nz):
    """restrict / prolong_add, including a coarse level with trailing lane
    padding (fine nz 384 -> coarse 192 padded to 256)."""
    rng = np.random.default_rng(nz)
    fine_shape = (6, 8, nz)
    pad = domain.coarse_lane_pad(nz)
    coarse_shape = (3, 4, nz // 2 + pad)
    assert (pad > 0) == (nz == 384)
    fine_solv = rng.random(fine_shape) < 0.7
    coarse_solv = rng.random(coarse_shape) < 0.7
    coarse_solv[:, :, nz // 2:] = False
    fine = np.where(fine_solv, rng.standard_normal(fine_shape), 0.0)
    coarse = np.where(coarse_solv, rng.standard_normal(coarse_shape), 0.0)
    want_r = np.asarray(jax_transfer.restrict(jnp.asarray(fine), jnp.asarray(coarse_solv)))
    got_r = transfer.restrict(torch.from_numpy(fine), torch.from_numpy(coarse_solv)).numpy()
    np.testing.assert_allclose(got_r, want_r, rtol=0, atol=ATOL)
    want_p = np.asarray(
        jax_transfer.prolong_add(jnp.asarray(fine), jnp.asarray(coarse), jnp.asarray(fine_solv))
    )
    got_p = transfer.prolong_add(
        torch.from_numpy(fine), torch.from_numpy(coarse), torch.from_numpy(fine_solv)
    ).numpy()
    np.testing.assert_allclose(got_p, want_p, rtol=0, atol=ATOL)


_BLAS_OPS = ("dot", "squared_l2_norm", "l2_norm", "inf_norm", "masked_mean", "project_null_space")


@pytest.mark.parametrize("name", _BLAS_OPS)
def test_blas_matches_jax(hier16, name):
    _, _, _, jh, th, x, b = hier16
    solv_j, solv_t = jh.levels[0].solvable, th.levels[0].solvable
    if name == "dot":
        want = jax_blas.dot(jnp.asarray(x), jnp.asarray(b), solv_j)
        got = blas.dot(torch.from_numpy(x), torch.from_numpy(b), solv_t)
    else:
        want = getattr(jax_blas, name)(jnp.asarray(x), solv_j)
        got = getattr(blas, name)(torch.from_numpy(x), solv_t)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12, atol=ATOL)


def test_coarse_solve_matches_jax(hier16):
    _, _, _, jh, th, _, _ = hier16
    coarse = jh.levels[-1]
    rng = np.random.default_rng(11)
    r = np.where(np.asarray(coarse.solvable), rng.standard_normal(coarse.shape), 0.0)
    want = np.asarray(jax_mg.coarse_solve(jh, jnp.asarray(r)))
    got = mg.coarse_solve(th, torch.from_numpy(r)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    # Pad slots never reach the grid: nothing outside the solvable set.
    assert (got[~np.asarray(coarse.solvable)] == 0).all()


@pytest.mark.parametrize("use_gs", [True, False])
def test_v_cycle_matches_jax(hier16, use_gs):
    """The port's V-cycle (smoother in the kernel's update form, residual
    emitted by the smoother) against the JAX jnp V-cycle, fp64."""
    _, _, _, jh, th, _, b = hier16
    jcfg = JaxConfig(use_gauss_seidel=use_gs)
    tcfg = SolverConfig(use_gauss_seidel=use_gs)
    want = np.asarray(jax_mg.v_cycle(jh, jnp.zeros_like(jnp.asarray(b)), jnp.asarray(b), jcfg))
    z, rho = mg.v_cycle(th, None, torch.from_numpy(b), tcfg, emit_fine_dot=True)
    np.testing.assert_allclose(z.numpy(), want, rtol=0, atol=ATOL)
    np.testing.assert_allclose(float(rho), float(np.sum(want * b)), rtol=1e-12)


CHEBYSHEV = dict(interior_smoother="chebyshev", chebyshev_degree=3)


def test_chebyshev_v_cycle_matches_jax(hier16):
    """The Chebyshev smoother's V-cycle (tests/test_vcycle.py's option
    test): plain PyTorch on every level, as the JAX package's jnp path."""
    _, _, _, jh, th, x, b = hier16
    jcfg, tcfg = JaxConfig(**CHEBYSHEV), SolverConfig(**CHEBYSHEV)
    assert mg.level_flags(th, tcfg) == ("plain",) * th.num_levels
    assert mg.hierarchy_block_lists(th, tcfg) == (None,) * th.num_levels
    want = jax_mg.v_cycle(jh, jnp.zeros_like(jnp.asarray(b)), jnp.asarray(b), jcfg)
    z, rho = mg.v_cycle(th, None, torch.from_numpy(b), tcfg, emit_fine_dot=True)
    np.testing.assert_allclose(z.numpy(), np.asarray(want), rtol=0, atol=ATOL)
    np.testing.assert_allclose(float(rho), float(np.sum(np.asarray(want) * b)), rtol=1e-12)
    warm = np.asarray(jax_mg.v_cycle(jh, want, jnp.asarray(b), jcfg, use_initial_guess=True))
    got = mg.v_cycle(th, z, torch.from_numpy(b), tcfg, use_initial_guess=True)
    np.testing.assert_allclose(got.numpy(), warm, rtol=0, atol=ATOL)


def test_chebyshev_mgpcg_matches_jax(hier16):
    """MGPCG with the Chebyshev smoother (degree 3) against the JAX package
    on tests/test_vcycle.py's fixture: iterations equal, the solution within
    1e-10 of its largest entry."""
    from geometricmultigridpressuresolver_tpu.solver import mgpcg as jax_mgpcg
    from geometricmultigridpressuresolver_tpu_torch.solver import mgpcg

    labels, weights, mg_levels, jh, _, _, _ = hier16
    rng = np.random.default_rng(4)
    solv = np.asarray(jh.levels[0].solvable)
    rhs = np.where(solv, rng.standard_normal(labels.shape), 0.0)
    jcfg = JaxConfig(tolerance=1e-8, max_iterations=200, **CHEBYSHEV)
    tcfg = SolverConfig(tolerance=1e-8, max_iterations=200, **CHEBYSHEV)
    want = jax_mgpcg.solve(jax_mgpcg.build_problem(labels, weights, mg_levels, jcfg), jnp.asarray(rhs), config=jcfg)
    got = mgpcg.solve(mgpcg.build_problem(labels, weights, mg_levels, tcfg, device="cpu"),
                      torch.from_numpy(rhs), config=tcfg)
    assert got.converged and got.iterations == int(want.iterations) < 60
    scale = float(np.abs(np.asarray(want.x)).max())
    assert float(np.abs(got.x.numpy() - np.asarray(want.x)).max()) <= 1e-10 * scale


def test_interrupt_check_matches_jax():
    """tests/test_vcycle.py::test_cooperative_interruption on the port: a
    host callback after each CG iteration stops the solve with the current
    iterate; never interrupting changes nothing.  The interrupted iterate
    equals the JAX package's."""
    from geometricmultigridpressuresolver_tpu.solver import mgpcg as jax_mgpcg
    from geometricmultigridpressuresolver_tpu_torch.solver import mgpcg

    labels, weights, mg_levels = helpers.expanded_domain(helpers.simple_domain, 16)
    config = SolverConfig(tolerance=1e-12, max_iterations=100)
    problem = mgpcg.build_problem(labels, weights, mg_levels, config, device="cpu")
    rhs = helpers.random_solvable_field(labels, seed=31)
    seen = []

    def interrupt_after_3(iteration):
        seen.append(iteration)
        return iteration >= 3

    result = mgpcg.solve(problem, torch.from_numpy(rhs), config=config, interrupt_check=interrupt_after_3)
    assert result.iterations == 3 and not result.converged
    assert seen == [1, 2, 3]
    assert bool(torch.isfinite(result.x).all()) and float(blas.l2_norm(result.x, problem.fine.solvable)) > 0
    jcfg = JaxConfig(tolerance=1e-12, max_iterations=100)
    want = jax_mgpcg.solve(
        jax_mgpcg.build_problem(labels, weights, mg_levels, jcfg), jnp.asarray(rhs), config=jcfg,
        interrupt_check=lambda it: it >= 3,
    )
    assert int(want.iterations) == 3
    np.testing.assert_allclose(result.x.numpy(), np.asarray(want.x), rtol=0, atol=1e-10)

    base = mgpcg.solve(problem, torch.from_numpy(rhs), config=SolverConfig(tolerance=1e-8))
    never = mgpcg.solve(problem, torch.from_numpy(rhs), config=SolverConfig(tolerance=1e-8),
                        interrupt_check=lambda it: False)
    assert base.iterations == never.iterations and never.converged
    assert torch.equal(base.x, never.x)


# ---------------------------------------------------------------------------
# Symmetry suite (tests/test_symmetry.py) on the port
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def port_hier16(hier16):
    labels, weights, mg_levels, _, _, _, _ = hier16
    return labels, mg.build_hierarchy(labels, weights, mg_levels, SolverConfig(), validate=True, device="cpu")


def _sym_check(op, solvable, seed=0):
    rng = np.random.default_rng(seed)
    shape = tuple(solvable.shape)
    a = torch.where(solvable, torch.from_numpy(rng.standard_normal(shape)), 0.0)
    b = torch.where(solvable, torch.from_numpy(rng.standard_normal(shape)), 0.0)
    dot_a = float(blas.dot(op(a), b, solvable))
    dot_b = float(blas.dot(op(b), a, solvable))
    denom = max(abs(dot_a), abs(dot_b), 1e-300)
    assert abs(dot_a - dot_b) / denom < SYM_TOL, (dot_a, dot_b)


def _two_level(use_gs):
    labels, weights, mg_levels = helpers.expanded_domain(
        helpers.sine_dirichlet_domain, 16, fractional=True
    )
    config = SolverConfig(use_gauss_seidel=use_gs, max_mg_levels=2)
    h = mg.build_hierarchy(labels, weights, mg_levels, config, device="cpu")
    assert h.num_levels == 2
    return h, config


def _sym_case(name, labels, hier):
    """(operator, solvable mask) of each symmetry case."""
    c = hier.levels[0]
    if name == "boundary_jacobi_block":
        cfg = SolverConfig(use_gauss_seidel=False)
        return (lambda r: fused_smoother.smooth_level(None, r, c, cfg, True, x_is_zero=True)), c.solvable
    if name == "gauss_seidel_schedule":
        def op(r):
            x = torch.zeros_like(r)
            for _ in range(2):
                x = stencil.rb_gauss_seidel(x, r, c, forward=True)
                x = stencil.rb_gauss_seidel(x, r, c, forward=False)
            return x
        return op, c.solvable
    if name == "coarse_direct_solve":
        return (lambda r: mg.coarse_solve(hier, r)), hier.levels[-1].solvable
    if name == "restriction_prolongation":
        coarse = hier.levels[1]
        return (
            lambda r: transfer.prolong_add(
                torch.zeros_like(r), transfer.restrict(r, coarse.solvable), c.solvable
            )
        ), c.solvable
    if name.startswith("two_level_vcycle"):
        h, cfg = _two_level(name.endswith("gs"))
        return (lambda r: mg.v_cycle(h, None, r, cfg)), h.levels[0].solvable
    if name.startswith("full_vcycle"):
        cfg = SolverConfig(use_gauss_seidel=name.endswith("gs"))
        assert hier.num_levels >= 3

        def op(r):
            x = mg.v_cycle(hier, None, r, cfg)
            for _ in range(3):
                x = mg.v_cycle(hier, x, r, cfg, use_initial_guess=True)
            return x
        return op, c.solvable
    if name == "chebyshev_vcycle":
        cfg = SolverConfig(**CHEBYSHEV)

        def op(r):
            x = mg.v_cycle(hier, None, r, cfg)
            return mg.v_cycle(hier, x, r, cfg, use_initial_guess=True)
        return op, c.solvable
    if name == "single_level_cycle":
        cfg = SolverConfig(max_mg_levels=1, use_gauss_seidel=False)
        h1 = mg.build_hierarchy(labels, None, 5, cfg, device="cpu")
        assert h1.num_levels == 1
        return (lambda r: mg.v_cycle(h1, None, r, cfg)), h1.levels[0].solvable
    raise KeyError(name)


@pytest.mark.parametrize(
    "name",
    [
        "boundary_jacobi_block", "gauss_seidel_schedule", "coarse_direct_solve",
        "restriction_prolongation", "two_level_vcycle_gs", "two_level_vcycle_jacobi",
        "full_vcycle_gs", "full_vcycle_jacobi", "single_level_cycle", "chebyshev_vcycle",
    ],
)
def test_port_symmetry(port_hier16, name):
    labels, hier = port_hier16
    op, solvable = _sym_case(name, labels, hier)
    _sym_check(op, solvable)
