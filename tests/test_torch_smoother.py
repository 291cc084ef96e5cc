"""Port's smoothing block (ops/fused_smoother.py) against the JAX package.

The plain PyTorch version `smooth_level_torch` (what the CUDA kernel is
held against on the card) must match the Pallas kernel run in interpret
mode, pass for pass, on the 32^3 sine-Dirichlet fixture (the same inputs,
bit-identical coefficients carried over with `interop`).  Tolerances are the
JAX package's own (tests/test_pallas_smoother.py): fp32 grids atol 2e-6,
residuals atol 2e-4, dots rtol 1e-5.  In fp64 the block must equal
`mg._smooth_level` (the reference stencil forms) to 1e-12.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geometricmultigridpressuresolver_tpu.config import SolverConfig as JaxConfig
from geometricmultigridpressuresolver_tpu.ops import pallas_smoother
from geometricmultigridpressuresolver_tpu.solver import mg as jax_mg
from geometricmultigridpressuresolver_tpu_torch import interop
from geometricmultigridpressuresolver_tpu_torch.config import SolverConfig
from geometricmultigridpressuresolver_tpu_torch.ops import fused_smoother
from tests import helpers

torch.set_num_threads(1)


def _level_arrays(c):
    return {f: np.asarray(getattr(c, f)) for f in c._fields}


def _fixture(dtype_jax, seed=7):
    labels, weights, mg_levels = helpers.expanded_domain(
        helpers.sine_dirichlet_domain, 32, fractional=True
    )
    config = JaxConfig(solve_dtype=dtype_jax)
    hier = jax_mg.build_hierarchy(labels, weights, mg_levels, config)
    c = hier.levels[0]
    rng = np.random.default_rng(seed)
    solv = np.asarray(c.solvable)
    x = np.where(solv, rng.standard_normal(c.shape), 0.0).astype(dtype_jax)
    b = np.where(solv, rng.standard_normal(c.shape), 0.0).astype(dtype_jax)
    return c, interop.level_from_arrays(_level_arrays(c), device="cpu"), x, b


@pytest.fixture(scope="module")
def fixture32():
    return _fixture(np.float32)


@pytest.fixture(scope="module")
def fixture64():
    return _fixture(np.float64)


@pytest.mark.parametrize("forward", [True, False])
@pytest.mark.parametrize("use_gs", [True, False])
def test_smoother_matches_pallas(fixture32, forward, use_gs):
    cj, ct, x, b = fixture32
    jcfg = JaxConfig(solve_dtype=jnp.float32, use_gauss_seidel=use_gs)
    tcfg = SolverConfig(solve_dtype=torch.float32, use_gauss_seidel=use_gs)
    ref = pallas_smoother.smooth_level_pallas(
        jnp.asarray(x), jnp.asarray(b), cj, jcfg, forward=forward, interpret=True
    )
    got = fused_smoother.smooth_level_torch(
        torch.from_numpy(x), torch.from_numpy(b), ct, tcfg, forward=forward
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-6)


def test_smoother_zero_x_emit_residual_and_dot_match_pallas(fixture32):
    """The V-cycle downstroke variant (x == 0, residual emitted) and the
    fine-upstroke variant (rho = <x', b> emitted)."""
    cj, ct, _, b = fixture32
    jcfg = JaxConfig(solve_dtype=jnp.float32)
    tcfg = SolverConfig(solve_dtype=torch.float32)
    zero = jnp.zeros_like(jnp.asarray(b))
    x_ref, r_ref, dot_ref = pallas_smoother.smooth_level_pallas(
        zero, jnp.asarray(b), cj, jcfg, forward=True, interpret=True,
        x_is_zero=True, emit_residual=True, emit_dot=True,
    )
    x_got, r_got, dot_got = fused_smoother.smooth_level_torch(
        None, torch.from_numpy(b), ct, tcfg, forward=True,
        x_is_zero=True, emit_residual=True, emit_dot=True,
    )
    np.testing.assert_allclose(x_got.numpy(), np.asarray(x_ref), atol=2e-6)
    np.testing.assert_allclose(r_got.numpy(), np.asarray(r_ref), atol=2e-4)
    np.testing.assert_allclose(float(dot_got), float(dot_ref), rtol=1e-5)
    assert dot_got.dtype == torch.float32 and dot_got.shape == ()


def test_smoother_emit_dot_upstroke_matches_pallas(fixture32):
    cj, ct, x, b = fixture32
    jcfg = JaxConfig(solve_dtype=jnp.float32)
    tcfg = SolverConfig(solve_dtype=torch.float32)
    x_ref, dot_ref = pallas_smoother.smooth_level_pallas(
        jnp.asarray(x), jnp.asarray(b), cj, jcfg, forward=False, interpret=True,
        emit_dot=True,
    )
    x_got, dot_got = fused_smoother.smooth_level_torch(
        torch.from_numpy(x), torch.from_numpy(b), ct, tcfg, forward=False, emit_dot=True
    )
    np.testing.assert_allclose(x_got.numpy(), np.asarray(x_ref), atol=2e-6)
    np.testing.assert_allclose(float(dot_got), float(dot_ref), rtol=1e-5)


@pytest.mark.parametrize("forward", [True, False])
@pytest.mark.parametrize("use_gs", [True, False])
def test_smoother_fp64_matches_reference_stencils(fixture64, forward, use_gs):
    """The kernel's update form equals the textbook stencil form to
    rounding on solvable cells (1e-12 in fp64)."""
    cj, ct, x, b = fixture64
    jcfg = JaxConfig(use_gauss_seidel=use_gs)
    tcfg = SolverConfig(use_gauss_seidel=use_gs)
    ref = jax_mg._smooth_level(jnp.asarray(x), jnp.asarray(b), cj, jcfg, forward=forward)
    got = fused_smoother.smooth_level_torch(
        torch.from_numpy(x), torch.from_numpy(b), ct, tcfg, forward=forward
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-12)


def test_zero_outside_solvable_preserved(fixture64):
    _, ct, x, b = fixture64
    got = fused_smoother.smooth_level_torch(
        torch.from_numpy(x), torch.from_numpy(b), ct, SolverConfig(), forward=True
    )
    assert (got[~ct.solvable] == 0).all()


def test_wrapper_on_cpu_runs_the_plain_version(fixture64):
    """`smooth_level` on CPU tensors is the plain version (kernel_mode
    "auto" and "torch"), and raises under kernel_mode "cuda"."""
    _, ct, x, b = fixture64
    xt, bt = torch.from_numpy(x), torch.from_numpy(b)
    want = fused_smoother.smooth_level_torch(xt, bt, ct, SolverConfig(), forward=False, emit_dot=True)
    for mode in ("auto", "torch"):
        got = fused_smoother.smooth_level(
            xt, bt, ct, SolverConfig(kernel_mode=mode), forward=False, emit_dot=True
        )
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    before = fused_smoother.PASS_LAUNCHES.count
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        fused_smoother.smooth_level(xt, bt, ct, SolverConfig(kernel_mode="cuda"), forward=True)
    assert fused_smoother.PASS_LAUNCHES.count == before


def test_schedule_matches_jax():
    for kwargs in ({}, {"use_gauss_seidel": False}, {"boundary_iterations": 1}):
        for forward in (True, False):
            assert fused_smoother.schedule_for(SolverConfig(**kwargs), forward) == (
                pallas_smoother.schedule_for(JaxConfig(**kwargs), forward)
            )
