"""The CUDA kernels against their plain versions, on the card.

Marked `cuda`: these need an NVIDIA GPU with nvcc and skip elsewhere (a
CUDA kernel has no interpret mode).  On a GPU machine:

    python -m pytest tests/test_torch_cuda.py -q --noconftest

(--noconftest: tests/conftest.py configures JAX, which a GPU machine
without JAX cannot import; this file needs only the port.)

Tolerances: fp32 kernels differ from the plain versions by FMA contraction
and summation order -- 1e-5 relative (to the field's max) on grids, 1e-4 on
dots; fp64 kernels 1e-12.
"""

import numpy as np
import pytest
import torch

from geometricmultigridpressuresolver_tpu_torch.config import SolverConfig
from geometricmultigridpressuresolver_tpu_torch.models import free_surface, sdf
from geometricmultigridpressuresolver_tpu_torch.grids import face_shape
from geometricmultigridpressuresolver_tpu_torch.ops import domain, fused_cg, fused_smoother
from geometricmultigridpressuresolver_tpu_torch.solver import mg

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
    assert fused_smoother.PASS_LAUNCHES.count - before == len(
        fused_smoother.schedule_for(cfg, kw["forward"])
    )
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
    c, z, p, _ = _level(device, dtype, ew_dtype)
    beta = torch.tensor(0.37, dtype=dtype, device=device)
    ops = (c.diag, c.ew0, c.ew1, c.ew2)
    got = fused_cg.search_matvec_dot(z, p, beta, *ops, mode="cuda")
    torch.cuda.synchronize()
    want = fused_cg.search_matvec_dot_torch(z, p, beta, *ops)
    assert _rel(got[0], want[0]) <= grid_tol and _rel(got[1], want[1]) <= grid_tol
    assert _rel(got[2], want[2]) <= dot_tol
    r = fused_cg.residual(z, p, *ops, mode="cuda")
    torch.cuda.synchronize()
    assert _rel(r, fused_cg.residual_torch(z, p, *ops)) <= grid_tol


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
