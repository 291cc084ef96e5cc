"""Port's CG step and residual (ops/fused_cg.py) against the JAX package.

The plain versions (what the CUDA kernels are held against on the card)
must match ops/pallas_cg.py's kernels run in interpret mode on the 32^3
fixture, with the JAX package's tolerances (tests/test_pallas_smoother.py):
p' atol 2e-6, A p' and residual atol 2e-5, dot rtol 1e-5 in fp32; and the
reference stencils to 1e-12 in fp64.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geometricmultigridpressuresolver_tpu.config import SolverConfig as JaxConfig
from geometricmultigridpressuresolver_tpu.ops import blas as jax_blas
from geometricmultigridpressuresolver_tpu.ops import pallas_cg
from geometricmultigridpressuresolver_tpu.ops import stencil as jax_stencil
from geometricmultigridpressuresolver_tpu.solver import mg as jax_mg
from geometricmultigridpressuresolver_tpu_torch import interop
from geometricmultigridpressuresolver_tpu_torch.ops import fused_cg
from tests import helpers

torch.set_num_threads(1)


def _fixture(dtype, bf16_ew=False):
    labels, weights, mg_levels = helpers.expanded_domain(
        helpers.sine_dirichlet_domain, 32, fractional=True
    )
    config = JaxConfig(
        solve_dtype=dtype, mg_ew_dtype=jnp.bfloat16 if bf16_ew else None
    )
    c = jax_mg.build_hierarchy(labels, weights, mg_levels, config).levels[0]
    rng = np.random.default_rng(3)
    solv = np.asarray(c.solvable)
    z = np.where(solv, rng.standard_normal(c.shape), 0.0).astype(dtype)
    p = np.where(solv, rng.standard_normal(c.shape), 0.0).astype(dtype)
    ct = interop.level_from_arrays({f: np.asarray(getattr(c, f)) for f in c._fields}, device="cpu")
    return c, ct, z, p


@pytest.fixture(scope="module")
def fixture32():
    return _fixture(np.float32)


@pytest.fixture(scope="module")
def fixture64():
    return _fixture(np.float64)


def _ew(c):
    return c.diag, c.ew0, c.ew1, c.ew2


def test_cg_step_matches_pallas(fixture32):
    cj, ct, z, p = fixture32
    beta = np.float32(0.7371)
    pn_ref, ap_ref, pap_ref = pallas_cg.fused_search_matvec_dot(
        jnp.asarray(z), jnp.asarray(p), beta, *_ew(cj), interpret=True
    )
    pn, ap, pap = fused_cg.search_matvec_dot_torch(
        torch.from_numpy(z), torch.from_numpy(p), torch.tensor(beta), *_ew(ct)
    )
    np.testing.assert_allclose(pn.numpy(), np.asarray(pn_ref), atol=2e-6)
    np.testing.assert_allclose(ap.numpy(), np.asarray(ap_ref), atol=2e-5)
    np.testing.assert_allclose(float(pap), float(pap_ref[0, 0]), rtol=1e-5)


def test_residual_matches_pallas(fixture32):
    cj, ct, x, b = fixture32
    ref = pallas_cg.fused_residual(jnp.asarray(x), jnp.asarray(b), *_ew(cj), interpret=True)
    got = fused_cg.residual_torch(torch.from_numpy(x), torch.from_numpy(b), *_ew(ct))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-5)


def test_residual_bf16_edge_weights_matches_pallas():
    """The V-cycle levels carry bf16 edge weights in the bench
    configuration; bf16 * fp32 promotes to fp32 in both frameworks."""
    cj, ct, x, b = _fixture(np.float32, bf16_ew=True)
    assert ct.ew0.dtype == torch.bfloat16
    ref = pallas_cg.fused_residual(jnp.asarray(x), jnp.asarray(b), *_ew(cj), interpret=True)
    got = fused_cg.residual_torch(torch.from_numpy(x), torch.from_numpy(b), *_ew(ct))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-5)


def test_cg_step_fp64_matches_reference_stencils(fixture64):
    cj, ct, z, p = fixture64
    beta = 0.31
    p_ref = jnp.asarray(z) + beta * jnp.asarray(p)
    ap_ref = jax_stencil.apply_poisson(p_ref, cj)
    pap_ref = float(jax_blas.dot(p_ref, ap_ref, cj.solvable))
    pn, ap, pap = fused_cg.search_matvec_dot_torch(
        torch.from_numpy(z), torch.from_numpy(p), torch.tensor(beta, dtype=torch.float64), *_ew(ct)
    )
    np.testing.assert_allclose(pn.numpy(), np.asarray(p_ref), rtol=0, atol=1e-12)
    np.testing.assert_allclose(ap.numpy(), np.asarray(ap_ref), rtol=0, atol=1e-12)
    np.testing.assert_allclose(float(pap), pap_ref, rtol=1e-12)


def test_residual_fp64_matches_reference_stencils(fixture64):
    cj, ct, x, b = fixture64
    ref = jax_stencil.residual(jnp.asarray(x), jnp.asarray(b), cj)
    got = fused_cg.residual_torch(torch.from_numpy(x), torch.from_numpy(b), *_ew(ct))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-12)


@pytest.mark.parametrize("which", ["cg_step", "residual"])
def test_wrappers_on_cpu(fixture64, which):
    """CPU tensors run the plain version under "auto"/"torch" and raise under
    "cuda"; no launch is counted."""
    _, ct, x, b = fixture64
    xt, bt = torch.from_numpy(x), torch.from_numpy(b)
    beta = torch.tensor(0.5, dtype=torch.float64)
    if which == "cg_step":
        counter = fused_cg.STEP_LAUNCHES

        def call(mode):
            return fused_cg.search_matvec_dot(xt, bt, beta, *_ew(ct), mode=mode)

        want = fused_cg.search_matvec_dot_torch(xt, bt, beta, *_ew(ct))
    else:
        counter = fused_cg.RESIDUAL_LAUNCHES

        def call(mode):
            return (fused_cg.residual(xt, bt, *_ew(ct), mode=mode),)

        want = (fused_cg.residual_torch(xt, bt, *_ew(ct)),)
    before = counter.count
    for mode in ("auto", "torch"):
        for g, w in zip(call(mode), want):
            assert torch.equal(g, w)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        call("cuda")
    with pytest.raises(ValueError, match="unknown kernel mode"):
        call("pallas")
    assert counter.count == before
