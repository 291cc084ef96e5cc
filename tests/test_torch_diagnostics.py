"""The test node (diagnostics.py) and its CLI, port vs JAX.

The fixtures are bit-equal to the JAX package's (numpy).  The blocks run in
fp64 on the CPU (the plain versions of the kernels) against the JAX
package's blocks on the same inputs: the CG block's iterations equal, its
recomputed relative residual within 1e-6 relative of JAX's and its oracle
agreement < 1e-6; the one-level V-cycle's per-cycle L2 within 1e-10
relative; the smoother block's residual norms within 1e-10 relative (the
two packages' Gauss-Seidel updates differ in their rounding only).  The
port's symmetry block holds the reference's 1e-10 on its own (JAX's block
is not run: it jits six programs).
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from geometricmultigridpressuresolver_tpu import diagnostics as jax_diag
from geometricmultigridpressuresolver_tpu_torch import diagnostics
from geometricmultigridpressuresolver_tpu_torch.ops import domain

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("use_solid_sphere", [False, True])
def test_fixtures_bit_equal_to_jax(use_solid_sphere):
    labels, weights = diagnostics.build_complex_domain(24, use_solid_sphere=use_solid_sphere)
    want_labels, want_weights = jax_diag.build_complex_domain(24, use_solid_sphere=use_solid_sphere)
    assert labels.dtype == want_labels.dtype and np.array_equal(labels, want_labels)
    for w, v in zip(weights, want_weights):
        assert np.array_equal(w, v)
    got = diagnostics.expand(labels, weights)
    want = jax_diag.expand(want_labels, want_weights)
    assert np.array_equal(got[0], np.asarray(want[0])) and got[0].dtype == np.int8
    for w, v in zip(got[1], want[1]):
        assert np.array_equal(w, np.asarray(v))
    assert tuple(got[2]) == tuple(want[2]) and got[3] == want[3]
    assert domain.check_exterior_shell(got[0]) and domain.check_boundary_cells(got[0], got[1])
    simple = diagnostics.build_simple_domain(24)
    assert np.array_equal(simple, jax_diag.build_simple_domain(24))
    got, want = diagnostics.expand(simple), jax_diag.expand(simple)
    assert np.array_equal(got[0], np.asarray(want[0])) and got[1] is None and want[1] is None
    kw = dict(solvable=got[0] >= 2, offset=got[2], base_shape=simple.shape)
    assert np.array_equal(
        diagnostics.delta_spike_rhs(got[0].shape, **kw), jax_diag.delta_spike_rhs(got[0].shape, **kw)
    )
    assert np.array_equal(diagnostics.random_initial_guess(got[0], 3), jax_diag.random_initial_guess(got[0], 3))


CG_KW = dict(grid_size=16, use_complex_domain=True, use_solid_sphere=True, tolerance=1e-9, max_iterations=500)


@pytest.fixture(scope="module")
def jax_cg():
    return jax_diag.run_conjugate_gradient_test(**CG_KW)


def test_conjugate_gradient_block_matches_jax(jax_cg):
    got = diagnostics.run_conjugate_gradient_test(**CG_KW, device="cpu")
    assert set(got) == set(jax_cg)
    assert got["iterations"] == jax_cg["iterations"]
    assert got["dofs"] == jax_cg["dofs"] > 0
    assert abs(got["relative_l2"] - jax_cg["relative_l2"]) <= 1e-6 * jax_cg["relative_l2"]
    assert got["relative_l2"] < 1e-8
    assert got["max_relative_difference_vs_oracle"] < 1e-6


def test_conjugate_gradient_block_dx_round_trip():
    """The dx^2 scaling in and 1/dx^2 out leave the relative residual as it
    is (dx = 1/16 scales by a power of two: exactly)."""
    kw = dict(CG_KW, tolerance=1e-6)
    plain = diagnostics.run_conjugate_gradient_test(**kw, device="cpu")
    scaled = diagnostics.run_conjugate_gradient_test(**kw, dx=1.0 / 16, device="cpu")
    assert scaled["iterations"] == plain["iterations"]
    assert abs(scaled["relative_l2"] - plain["relative_l2"]) <= 1e-9 * plain["relative_l2"]
    assert abs(scaled["l_infinity"] - plain["l_infinity"]) <= 1e-9 * plain["l_infinity"]
    assert scaled["max_relative_difference_vs_oracle"] < 1e-4


def test_one_level_vcycle_block_matches_jax():
    want = jax_diag.run_one_level_vcycle_test(grid_size=32, num_cycles=8)
    got = diagnostics.run_one_level_vcycle_test(grid_size=32, num_cycles=8, device="cpu")
    assert set(got) == set(want)
    np.testing.assert_allclose(got["l2"], want["l2"], rtol=1e-10, atol=0)
    np.testing.assert_allclose(got["l_infinity"], want["l_infinity"], rtol=1e-10, atol=0)
    assert got["mean_convergence_factor"] < 0.5


def test_smoother_block_matches_jax():
    want = jax_diag.run_smoother_test(grid_size=24, max_smoother_iterations=6)
    got = diagnostics.run_smoother_test(grid_size=24, max_smoother_iterations=6, device="cpu")
    assert set(got) == set(want)
    np.testing.assert_allclose(got["residual_l2"], want["residual_l2"], rtol=1e-10, atol=0)
    assert got["residual_l2"][-1] < got["residual_l2"][0]
    assert all(got[k] > 0 for k in got if k.endswith("_seconds"))


@pytest.mark.parametrize("use_solid_sphere", [False, True])
def test_symmetry_block(use_solid_sphere):
    r = diagnostics.run_symmetry_test(16, use_solid_sphere=use_solid_sphere, device="cpu")
    assert len(r) == 6
    for name, v in r.items():
        assert v < 1e-10, (name, v)


def test_main_prints_jax_section_headers(capsys):
    """Every block through the CLI on the CPU; the section headers are the
    JAX package's, read from its source."""
    source = (REPO / "geometricmultigridpressuresolver_tpu" / "diagnostics.py").read_text()
    headers = re.findall(r'print\("(== [^"]+ ==)"\)', source)
    assert len(headers) == 4
    rc = diagnostics.main([
        "--device", "cpu", "--grid-size", "8", "--test-conjugate-gradient", "--test-symmetry",
        "--test-one-level-v-cycle", "--num-cycles", "3", "--test-smoother",
        "--max-smoother-iterations", "2",
    ])
    out = capsys.readouterr().out
    assert rc == 0
    assert [line for line in out.splitlines() if line.startswith("== ")] == headers
    assert out.count("[OK]") == 6 and "FAIL" not in out
