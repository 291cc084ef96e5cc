"""Import hygiene and configuration of the PyTorch port.

The port must import and run a small projection with JAX blocked, must not
import Triton or start nvcc at import time, must refuse the JAX package's
TPU-only knobs, and must refuse kernel_mode="cuda" on CPU tensors.
"""

import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from geometricmultigridpressuresolver_tpu_torch.config import SolverConfig
from geometricmultigridpressuresolver_tpu_torch.models import free_surface, sdf
from geometricmultigridpressuresolver_tpu_torch.ops import _cuda

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
PACKAGE = REPO / "geometricmultigridpressuresolver_tpu_torch"

_BLOCKED_JAX_RUN = r"""
import sys
sys.modules["jax"] = None  # any `import jax` now raises ImportError
import importlib, pkgutil
import torch
torch.set_num_threads(1)
import geometricmultigridpressuresolver_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
from geometricmultigridpressuresolver_tpu_torch.config import SolverConfig
from geometricmultigridpressuresolver_tpu_torch.models import free_surface, sdf
from geometricmultigridpressuresolver_tpu_torch.ops import _cuda
n = 16
phi, velocity = sdf.splash_scene((n, n, n))
cfg = SolverConfig(tolerance=1e-6)
setup = free_surface.build_setup(phi, sdf.open_box_weights((n, n, n)), config=cfg)
result = free_surface.project(setup, velocity, config=cfg)
assert result.cg.converged and float(result.max_divergence) < 1e-4
assert "triton" not in sys.modules
assert not any(m == "jax" or m.startswith(("jax.", "geometricmultigridpressuresolver_tpu."))
               for m in sys.modules if sys.modules[m] is not None)
assert _cuda.build_info is None and _cuda._lib is None  # nvcc never ran
print("OK", len(names), result.cg.iterations)
"""


def test_port_runs_with_jax_blocked():
    proc = subprocess.run(
        [sys.executable, "-c", _BLOCKED_JAX_RUN], cwd=REPO, capture_output=True,
        text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.startswith("OK")


def test_no_jax_import_in_port_sources():
    forbidden = re.compile(
        r"^\s*(from|import)\s+(jax\b|geometricmultigridpressuresolver_tpu\b(?!_torch))",
        re.MULTILINE,
    )
    for path in list(PACKAGE.rglob("*.py")) + [REPO / "chip_smoke.py"]:
        assert not forbidden.search(path.read_text()), path


@pytest.mark.parametrize(
    "knob, value",
    [
        ("pallas_interpret", True), ("pallas_block_t", 32), ("pallas_block_y", 48),
        ("pallas_pad_coarse", True), ("pallas_band_strip", 128), ("transfer_mode", "mm"),
        ("setup_fusion", "fused"), ("mg_field_dtype", torch.bfloat16),
        ("interior_smoother", "chebyshev"),
    ],
)
def test_config_refuses_tpu_only_knobs(knob, value):
    with pytest.raises(TypeError):
        SolverConfig(**{knob: value})


@pytest.mark.parametrize(
    "kwargs",
    [
        {"kernel_mode": "pallas"}, {"kernel_mode": "jnp"}, {"kernel_mode": "triton"},
        {"solve_dtype": torch.bfloat16}, {"mg_dtype": torch.float16},
        {"mg_ew_dtype": torch.int8},
    ],
)
def test_config_validates_values(kwargs):
    with pytest.raises(ValueError):
        SolverConfig(**kwargs)


def test_config_defaults_match_reference():
    cfg = SolverConfig()
    assert cfg.solve_dtype == torch.float64 and cfg.mg_dtype_resolved == torch.float64
    assert (cfg.jacobi_damping, cfg.boundary_width, cfg.boundary_iterations) == (2 / 3, 3, 3)
    assert (cfg.tolerance, cfg.max_iterations, cfg.theta_clamp) == (1e-5, 2500, 0.01)
    assert (cfg.dirichlet_band, cfg.coarse_dof_target, cfg.kernel_mode) == (4, 3000, "auto")


def test_cuda_mode_on_cpu_tensors_raises():
    n = 12
    phi, velocity = sdf.splash_scene((n, n, n))
    cfg = SolverConfig(kernel_mode="cuda")
    setup = free_surface.build_setup(phi, sdf.open_box_weights((n, n, n)), config=cfg)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        free_surface.project(setup, velocity, config=cfg)


def test_kernel_build_is_content_addressed_and_ignored():
    """The library name hashes the sources and flags; the build directory is
    listed in .gitignore.  (Computing the name runs no compiler.)"""
    path = _cuda._library_path()
    assert path.parent == _cuda.BUILD_DIR
    assert path.name.startswith("libgmg_kernels_") and path == _cuda._library_path()
    ignored = (REPO / ".gitignore").read_text().split()
    assert "geometricmultigridpressuresolver_tpu_torch/_build/" in ignored
    assert {p.name for p in _cuda.CSRC.iterdir()} >= {"common.cuh", "smoother.cu", "cg.cu"}
    for flag in ("-gencode=arch=compute_90a,code=sm_90a", "-O3"):
        assert flag in _cuda.NVCC_FLAGS


def test_interop_carries_bfloat16_bits():
    from geometricmultigridpressuresolver_tpu_torch import interop

    ml_dtypes = pytest.importorskip("ml_dtypes")
    values = np.array([1.0, 0.5, -3.25, 1e-3], dtype=np.float32)
    got = interop.tensor(values.astype(ml_dtypes.bfloat16))
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, torch.from_numpy(values).to(torch.bfloat16))
