"""The stage profiler (utils/profiling.py), port vs JAX and vs the port's
own solve.

`instrumented_solve` must return `mgpcg.solve`'s x bit for bit (the same
operators in the same order, fp64 on the CPU), agree with the JAX
package's `instrumented_solve` within 1e-10 (max abs, on a pressure of
order 1) with equal iterations, and count one "matvec" per iteration.
`StageTimes.report()` prints the JAX package's text for the same entries;
`vcycle_stage_times` times the JAX package's stages on the same hierarchy,
with the transfers the configuration picks;
`trace` writes a Chrome trace.
"""

import io
import json
from contextlib import redirect_stdout

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geometricmultigridpressuresolver_tpu import diagnostics as jax_diag
from geometricmultigridpressuresolver_tpu.config import SolverConfig as JaxConfig
from geometricmultigridpressuresolver_tpu.models import free_surface as jax_fs
from geometricmultigridpressuresolver_tpu.models import sdf as jax_sdf
from geometricmultigridpressuresolver_tpu.solver import mg as jax_mg
from geometricmultigridpressuresolver_tpu.utils import profiling as jax_prof
from geometricmultigridpressuresolver_tpu_torch.config import SolverConfig
from geometricmultigridpressuresolver_tpu_torch.models import free_surface, sdf
from geometricmultigridpressuresolver_tpu_torch.solver import mg, mgpcg
from geometricmultigridpressuresolver_tpu_torch.utils import profiling

torch.set_num_threads(1)

N = 20
TOL = dict(tolerance=1e-6, max_iterations=100)


@pytest.fixture(scope="module")
def splash():
    """The port's 20^3 splash setup and right-hand side, fp64 on the CPU."""
    cfg = SolverConfig(**TOL)
    phi, velocity = sdf.splash_scene((N,) * 3, device="cpu")
    setup = free_surface.build_setup(phi, sdf.open_box_weights((N,) * 3, device="cpu"), config=cfg)
    rhs = free_surface.embed_window(
        free_surface.negative_divergence(setup.liquid_mask, velocity, setup.weights),
        setup.window_start, setup.base_pads, setup.expanded_shape,
    )
    return setup, rhs, cfg


@pytest.mark.parametrize(
    "knobs",
    [{}, {"project_null_space": True}, {"use_mg_preconditioner": False}, {"warm": True}],
    ids=["mgpcg", "null_space", "diagonal", "warm_start"],
)
def test_instrumented_solve_bit_equal_to_solve(splash, knobs):
    setup, rhs, cfg = splash
    knobs = dict(knobs)
    warm = knobs.pop("warm", False)
    cfg = SolverConfig(**TOL, **knobs)
    x0 = None
    if warm:
        x0 = 0.5 * mgpcg.solve(setup.problem, rhs, config=cfg).x
    lines = []
    x, times = profiling.instrumented_solve(setup.problem, rhs, x0=x0, config=cfg, printer=lines.append)
    result = mgpcg.solve(setup.problem, rhs, x0=x0, config=cfg)
    assert torch.equal(x, result.x)
    assert times.calls["matvec"] == result.iterations > 0
    assert times.calls["norm(r)"] == result.iterations + 1
    assert len(lines) == result.iterations + 2 and lines[-2].startswith(f"iterations: {result.iterations},")
    assert set(times.seconds) == {"norm(b)", "initial residual", "preconditioner", "dot", "norm(r)",
                                  "matvec", "axpy"}


def test_instrumented_solve_matches_jax(splash):
    setup, rhs, cfg = splash
    jcfg = JaxConfig(**TOL)
    phi, velocity = jax_sdf.splash_scene((N,) * 3)
    jsetup = jax_fs.build_setup(phi, jax_sdf.open_box_weights((N,) * 3), config=jcfg)
    jrhs = jax_fs._embed(
        jax_fs.negative_divergence(jsetup.liquid_mask, tuple(map(jnp.asarray, velocity)), jsetup.weights), jsetup
    )
    np.testing.assert_allclose(rhs.numpy(), np.asarray(jrhs), rtol=0, atol=1e-12)
    want, jtimes = jax_prof.instrumented_solve(jsetup.problem, jrhs, config=jcfg, print_stats=False)
    got, times = profiling.instrumented_solve(setup.problem, rhs, config=cfg, print_stats=False)
    assert times.calls["matvec"] == jtimes.calls["matvec"]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-10)


def test_stage_times_report_matches_jax():
    entries = [("matvec", 0.0125), ("dot", 0.0004), ("matvec", 0.0131), ("L0 smooth (down)", 1.5),
               ("preconditioner", 0.25), ("dot", 0.0006)]
    ours, theirs = profiling.StageTimes(), jax_prof.StageTimes()
    for name, s in entries:
        ours.add(name, s)
        theirs.add(name, s)
    assert ours.report() == theirs.report()
    assert ours.calls == theirs.calls and ours.seconds == theirs.seconds


def test_vcycle_stage_names_match_jax():
    labels, _, _, mg_levels = jax_diag.expand(jax_diag.build_simple_domain(16))
    labels = np.asarray(labels)
    jhier = jax_mg.build_hierarchy(labels, None, mg_levels, JaxConfig())
    hier = mg.build_hierarchy(labels, None, mg_levels, SolverConfig(), device="cpu")
    assert hier.num_levels == jhier.num_levels >= 3
    b = np.where(labels >= 2, np.random.default_rng(5).standard_normal(labels.shape), 0.0)
    want = jax_prof.vcycle_stage_times(jhier, jnp.asarray(b), JaxConfig(), warmup=0, reps=1)
    got = profiling.vcycle_stage_times(hier, torch.from_numpy(b), SolverConfig(), warmup=1, reps=2)
    assert sorted(got.seconds) == sorted(want.seconds)
    assert all(n == 2 for n in got.calls.values())


def test_vcycle_stage_times_run_the_configured_transfers(monkeypatch):
    """Under transfer_mode="mm" the stage profiler times the matrix form,
    the transfers `mg.v_cycle` runs (the slice form never runs), under the
    stage names of the slice-form run (JAX's, above)."""
    from geometricmultigridpressuresolver_tpu_torch.ops import transfer

    labels, _, _, mg_levels = jax_diag.expand(jax_diag.build_simple_domain(16))
    labels = np.asarray(labels)
    hier = mg.build_hierarchy(labels, None, mg_levels, SolverConfig(), device="cpu")
    b = torch.from_numpy(np.where(labels >= 2, np.random.default_rng(5).standard_normal(labels.shape), 0.0))
    names = sorted(profiling.vcycle_stage_times(hier, b, SolverConfig(), warmup=0, reps=1).seconds)
    calls = {"restrict_mm": 0, "prolong_add_mm": 0}

    def counted(name):
        fn = getattr(transfer, name)

        def wrapper(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)

        return wrapper

    def refused(*args, **kwargs):
        raise AssertionError("the slice form ran under transfer_mode='mm'")

    for name in calls:
        monkeypatch.setattr(transfer, name, counted(name))
    monkeypatch.setattr(transfer, "restrict", refused)
    monkeypatch.setattr(transfer, "prolong_add", refused)
    got = profiling.vcycle_stage_times(hier, b, SolverConfig(transfer_mode="mm"), warmup=1, reps=2)
    assert sorted(got.seconds) == names
    assert calls == dict.fromkeys(calls, 3 * (hier.num_levels - 1))


def test_stage_timer_sync_and_disabled():
    timer = profiling.StageTimer()
    with timer.stage("cpu"):
        out = timer.sync((torch.ones(3), torch.zeros(2)))
    assert len(out) == 2 and timer.times.calls == {"cpu": 1}
    off = profiling.StageTimer(enabled=False)
    with off.stage("x"):
        pass
    assert off.times.calls == {}


def test_trace_writes_a_chrome_trace(tmp_path, splash):
    setup, rhs, cfg = splash
    with profiling.trace(str(tmp_path / "log")) as prof:
        with redirect_stdout(io.StringIO()):
            mgpcg.solve(setup.problem, rhs, config=cfg)
    path = tmp_path / "log" / "trace.json"
    assert path.is_file() and "traceEvents" in json.loads(path.read_text())
    assert len(prof.key_averages()) > 0
