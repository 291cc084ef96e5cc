"""Import hygiene and configuration of the PyTorch port.

The port must import and run a small projection, two fused frames and a
checkpoint with JAX blocked, must not
import Triton or start nvcc at import time, must refuse the JAX package's
knobs that have no meaning on the card, must resolve the ones it runs as
the JAX package does, and must refuse kernel_mode="cuda" on CPU tensors.
"""

import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from geometricmultigridpressuresolver_tpu_torch import diagnostics, interop
from geometricmultigridpressuresolver_tpu_torch.config import SolverConfig
from geometricmultigridpressuresolver_tpu_torch.models import assembled, free_surface, sdf
from geometricmultigridpressuresolver_tpu_torch.ops import _cuda
from geometricmultigridpressuresolver_tpu_torch.solver import mg

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
phi, velocity = sdf.splash_scene((n, n, n), device="cpu")
cfg = SolverConfig(tolerance=1e-6)
setup = free_surface.build_setup(phi, sdf.open_box_weights((n, n, n), device="cpu"), config=cfg)
result = free_surface.project(setup, velocity, config=cfg)
assert result.cg.converged and float(result.max_divergence) < 1e-4
import tempfile
from geometricmultigridpressuresolver_tpu_torch.models import simulate
phi1, vel1, p1, stats = simulate.run_fused(phi, velocity, sdf.open_box_weights((n, n, n), device="cpu"),
                                           num_frames=2, config=cfg, chunk=2)
with tempfile.TemporaryDirectory() as d:
    simulate.save_state(d, 2, phi1, vel1, p1)
    assert simulate.load_state(d)[0] == 2
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
        ("pallas_pad_coarse", True),
    ],
)
def test_config_refuses_tpu_only_knobs(knob, value):
    with pytest.raises(TypeError):
        SolverConfig(**{knob: value})


@pytest.mark.parametrize(
    "knob, default, good, bad",
    [
        ("pallas_band_strip", 128, 0, -1),
        ("pallas_band_strip", 128, 7, 1.5),
        ("mg_field_dtype", None, torch.bfloat16, torch.float16),
        ("mg_field_dtype", None, torch.bfloat16, torch.float32),
        ("advection", "semi_lagrangian", "upwind", "maccormack"),
        ("interior_smoother", None, "chebyshev", "jacobi"),
        ("transfer_mode", "auto", "mm", "bad"),
        ("setup_fusion", "auto", "per-level", "per_level"),
    ],
)
def test_config_accepts_ported_knobs(knob, default, good, bad):
    """Knobs the port now runs: the JAX package's names and defaults, and
    bad values raise."""
    from geometricmultigridpressuresolver_tpu.config import SolverConfig as JaxConfig

    assert getattr(SolverConfig(), knob) == default == getattr(JaxConfig(), knob)
    assert getattr(SolverConfig(**{knob: good}), knob) == good
    with pytest.raises(ValueError):
        SolverConfig(**{knob: bad})


@pytest.mark.parametrize("fusion", ["auto", "fused", "per-level"])
@pytest.mark.parametrize("n_devices", [1, 4])
@pytest.mark.parametrize("shape", [
    (384, 384, 640), (448, 448, 478), (448, 448, 512), (1000, 1000, 96), (1000, 1000, 97), (8, 8, 8),
])
def test_setup_fusion_resolves_like_jax(shape, n_devices, fusion):
    """The granularity the port picks for a window is the JAX package's,
    around its 96M-cell threshold, per device of a mesh."""
    from geometricmultigridpressuresolver_tpu.config import SolverConfig as JaxConfig

    assert SolverConfig.SETUP_FUSION_AUTO_CELLS == JaxConfig.SETUP_FUSION_AUTO_CELLS
    got = SolverConfig(setup_fusion=fusion).setup_fusion_resolved(shape, n_devices)
    assert got == JaxConfig(setup_fusion=fusion).setup_fusion_resolved(shape, n_devices)
    assert got in ("fused", "per-level")


@pytest.mark.parametrize("mode, device, want", [
    ("auto", "cpu", False), ("auto", "cuda", True), ("mm", "cpu", True), ("slice", "cuda", False),
])
def test_transfer_mode_resolves_by_device(mode, device, want):
    """Explicit modes win; "auto" is the slice form on a CPU device (as the
    JAX package's off the TPU) and the matrix form on a CUDA device (the
    rule reads the device's type; no card is touched)."""
    assert mg.use_mm_transfers(SolverConfig(transfer_mode=mode), torch.device(device)) is want


def test_frame_loop_knob_defaults_match_jax():
    from geometricmultigridpressuresolver_tpu.config import SolverConfig as JaxConfig

    for knob in ("window_slack", "advect_substeps", "chebyshev_degree"):
        assert getattr(SolverConfig(), knob) == getattr(JaxConfig(), knob), knob


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
    phi, velocity = sdf.splash_scene((n, n, n), device="cpu")
    cfg = SolverConfig(kernel_mode="cuda")
    setup = free_surface.build_setup(phi, sdf.open_box_weights((n, n, n), device="cpu"), config=cfg)
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


_NO_CARD_CALLS = {
    "splash_scene": lambda: sdf.splash_scene((8, 8, 8)),
    "open_box_weights": lambda: sdf.open_box_weights((8, 8, 8)),
    "build_setup_numpy": lambda: free_surface.build_setup(
        np.full((8, 8, 8), -1.0), [np.ones((9, 8, 8)), np.ones((8, 9, 8)), np.ones((8, 8, 9))]
    ),
    "build_hierarchy_numpy": lambda: mg.build_hierarchy(np.full((8, 8, 8), 2, np.int8), None, 2),
    "interop_level": lambda: interop.level_from_arrays(
        {f: np.zeros((4, 4, 4)) for f in ("solvable", "band", "diag", "inv_diag", "ew0", "ew1", "ew2")}
    ),
    "diagnostics_symmetry": lambda: diagnostics.run_symmetry_test(8),
    "diagnostics_smoother": lambda: diagnostics.run_smoother_test(8, max_smoother_iterations=1),
    "project_assembled_numpy": lambda: assembled.project_assembled(
        np.full((8, 8, 8), -1.0), [np.ones((9, 8, 8)), np.ones((8, 9, 8)), np.ones((8, 8, 9))],
        [np.zeros((9, 8, 8)), np.zeros((8, 9, 8)), np.zeros((8, 8, 9))],
    ),
}


@pytest.mark.parametrize("name", list(_NO_CARD_CALLS))
def test_entry_points_default_to_the_card(monkeypatch, name):
    """With no card and no device=, an entry point raises and names
    device='cpu'; it never runs on the CPU quietly."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _NO_CARD_CALLS[name]()


def test_cli_without_card_exits_nonzero(monkeypatch, capsys):
    from geometricmultigridpressuresolver_tpu_torch.models import simulate

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as exc:
        simulate.main(["--n", "8", "--frames", "1"])
    assert exc.value.code != 0
    assert "--device cpu" in capsys.readouterr().err


def test_diagnostics_cli_without_card_exits_nonzero(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as exc:
        diagnostics.main(["--grid-size", "8", "--test-symmetry"])
    assert exc.value.code != 0
    assert "--device cpu" in capsys.readouterr().err


def test_tensor_input_keeps_its_device(monkeypatch):
    """A tensor passed in keeps its device: no card is needed for it."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    phi, velocity = sdf.splash_scene((8, 8, 8), device="cpu")
    weights = sdf.open_box_weights((8, 8, 8), device="cpu")
    setup = free_surface.build_setup(phi, weights, config=SolverConfig())
    assert setup.liquid_phi.device.type == "cpu"
    assert setup.problem.hier.levels[0].diag.device.type == "cpu"


def test_interop_carries_bfloat16_bits():
    ml_dtypes = pytest.importorskip("ml_dtypes")
    values = np.array([1.0, 0.5, -3.25, 1e-3], dtype=np.float32)
    got = interop.tensor(values.astype(ml_dtypes.bfloat16), device="cpu")
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, torch.from_numpy(values).to(torch.bfloat16))
