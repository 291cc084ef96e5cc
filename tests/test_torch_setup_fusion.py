"""The setup's program granularity (`setup_fusion`) and the program cache
(`solver/graph.py::PROGRAMS`), port vs JAX, on the CPU.

`mg.device_hierarchy` at "fused" and "per-level" gives JAX's
`device_hierarchy` labels and flags bit for bit and its coefficients
within 1e-12 relative; `build_setup(reuse_from=)` with the liquid moved
inside the kept window gives JAX's window, origin and hierarchy.  `run()`
over 4 frames at 24^3 through the programs at either granularity is held
against JAX's in `tests/test_torch_simulate.py`
(`test_run_through_programs_matches_jax`), which shares its JAX run.

Without a card the entry points run eagerly.  The `programs` fixture runs
them through the program cache instead, each program a
`tests.torch_programs.EmulatedProgram` (its function run eagerly on the
program's fixed buffers): the keys, hits, copies in and out and the
cache's eviction are the card's, and the results must be the eager
path's bits.  fp64
throughout, at most 32^3.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geometricmultigridpressuresolver_tpu.config import SolverConfig as JaxConfig
from geometricmultigridpressuresolver_tpu.models import free_surface as jax_fs
from geometricmultigridpressuresolver_tpu.models import sdf as jax_sdf
from geometricmultigridpressuresolver_tpu.solver import mg as jax_mg
from geometricmultigridpressuresolver_tpu_torch.config import SolverConfig
from geometricmultigridpressuresolver_tpu_torch.models import free_surface, sdf
from geometricmultigridpressuresolver_tpu_torch.solver import graph, mg, mgpcg
from tests import torch_programs

torch.set_num_threads(1)

# Port and JAX configurations: fp64 throughout; fp32 edge-weight storage
# (a separate fp64 fine CG operator's edge weights); an fp32 V-cycle (a
# full fp64 fine operator).
CONFIGS = {
    "fp64": ({}, {}),
    "ew32": ({"mg_ew_dtype": torch.float32}, {"mg_ew_dtype": jnp.float32}),
    "mg32": ({"mg_dtype": torch.float32}, {"mg_dtype": jnp.float32}),
}


@pytest.fixture
def programs(monkeypatch):
    """Entry points on CPU tensors run through a fresh program cache of
    emulated programs."""
    return torch_programs.emulate(monkeypatch)


@functools.lru_cache(maxsize=None)
def _window(n=24):
    """The expanded labels and weights of the n^3 splash (numpy), its
    depth, and the scene."""
    phi, velocity = jax_sdf.splash_scene((n, n, n))
    weights = jax_sdf.open_box_weights((n, n, n))
    phi_t = torch.from_numpy(np.asarray(phi))
    w_t = tuple(torch.from_numpy(np.asarray(w)) for w in weights)
    cfg = SolverConfig()
    material, mg_labels, trimmed, mg_weights, proj, count = free_surface._setup_base_fields(
        phi_t, w_t, None, cfg.theta_clamp, torch.float64, cfg.dirichlet_band
    )
    geom = free_surface.window_geometry(proj, count, phi_t.shape, cfg)
    labels, exp_w = free_surface._expand_window_fields(trimmed, mg_weights, geom.start, geom.base_pads,
                                                      geom.expanded_shape)
    return labels.numpy(), tuple(w.numpy() for w in exp_w), geom.mg_levels


@functools.lru_cache(maxsize=None)
def _jax_hierarchy(config_name: str, fusion: str):
    labels, exp_w, depth = _window()
    jcfg = JaxConfig(setup_fusion=fusion, **CONFIGS[config_name][1])
    from geometricmultigridpressuresolver_tpu.solver import mgpcg as jax_mgpcg

    _, fine_dtype, fine_full = jax_mgpcg.fine_plan(jcfg)
    return jax_mg.device_hierarchy(jnp.asarray(labels), tuple(map(jnp.asarray, exp_w)), depth, jcfg,
                                   fine_dtype, fine_full)


def _close(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    if want.dtype.kind in "bi":
        assert np.array_equal(got.numpy(), want)
        return
    got = got.double().numpy()
    want = want.astype(np.float64)
    scale = max(np.abs(want).max(), 1e-300)
    assert np.abs(got - want).max() <= 1e-12 * scale


def _assert_hierarchy_matches(got, want) -> None:
    levels, flags, label_levels, fine = got
    j_levels, j_flags, j_label_levels, j_fine = want
    assert len(levels) == len(j_levels) and len(label_levels) == len(j_label_levels)
    assert [bool(f) for f in flags] == [bool(f) for f in j_flags]
    for lv, jl in zip(label_levels, j_label_levels):
        assert np.array_equal(lv.numpy(), np.asarray(jl))
    for c, jc in zip(levels, j_levels):
        for field in jc._fields:
            _close(getattr(c, field), getattr(jc, field))
    assert (fine is None) == (j_fine is None)
    if fine is not None:
        for t, j in zip(fine, j_fine):
            _close(t, j)


@pytest.mark.parametrize("config_name", list(CONFIGS))
@pytest.mark.parametrize("fusion", ["fused", "per-level"])
@pytest.mark.parametrize("cached", [False, True], ids=["eager", "programs"])
def test_device_hierarchy_matches_jax(config_name, fusion, cached, request):
    """Labels and flags bit-equal, coefficients within 1e-12 relative, at
    either granularity, eagerly and as (emulated) cached programs."""
    if cached:
        request.getfixturevalue("programs")
    labels, exp_w, depth = _window()
    cfg = SolverConfig(setup_fusion=fusion, **CONFIGS[config_name][0])
    _, fine_dtype, fine_full = mgpcg.fine_plan(cfg)
    got = mg.device_hierarchy(torch.from_numpy(labels), tuple(map(torch.from_numpy, exp_w)), depth, cfg,
                              fine_dtype, fine_full)
    _assert_hierarchy_matches(got, _jax_hierarchy(config_name, fusion if config_name == "fp64" else "fused"))
    if cached:
        # One program; per-level one graph per level and one for the fine
        # operator.
        assert dict(graph.STATS.program_captures) == {"hierarchy": 1}
        (prog,) = graph.PROGRAMS.entries.values()
        assert prog.stages == (1 if fusion == "fused" else len(got[0]) + (got[3] is not None))
        # A second call replays every program and gives the same bits.
        again = mg.device_hierarchy(torch.from_numpy(labels), tuple(map(torch.from_numpy, exp_w)), depth, cfg,
                                    fine_dtype, fine_full)
        assert graph.STATS.program_hits == graph.STATS.program_captures
        assert all(torch.equal(a, b) for a, b in zip(graph.tensors(got), graph.tensors(again)))


def test_granularities_give_the_same_bits():
    """"fused" and "per-level" are the same operations: bit-equal
    hierarchies, also through the whole build_setup."""
    n = 24
    phi, _ = sdf.splash_scene((n, n, n), device="cpu")
    weights = sdf.open_box_weights((n, n, n), device="cpu")
    cfg = SolverConfig(mg_ew_dtype=torch.float32)
    fused = free_surface.build_setup(phi, weights, config=cfg)
    per_level = free_surface.build_setup(phi, weights, config=SolverConfig(mg_ew_dtype=torch.float32,
                                                                           setup_fusion="per-level"))
    got, want = graph.tensors(per_level.problem), graph.tensors(fused.problem)
    assert len(got) == len(want) and all(torch.equal(a, b) for a, b in zip(got, want))


def _moving_drop(n=32, shift=3):
    """A free drop (numpy), the same drop `shift` cells further along x,
    and the box's weights."""
    phi = np.asarray(jax_sdf.sphere_sdf(jax_sdf.cell_centers((n, n, n))[0], (0.35, 0.45, 0.5), 0.2))
    moved = np.roll(phi, shift, axis=0)  # air rolls in at the far end
    return phi, moved, None, jax_sdf.open_box_weights((n, n, n))


@functools.lru_cache(maxsize=None)
def _jax_moved_setup():
    """JAX's setup of the moved drop built with `reuse_from` the first
    drop's (its granularity does not change its bits: the device_hierarchy
    cases hold both against the port)."""
    phi, moved, _, weights = _moving_drop()
    j0 = jax_fs.build_setup(phi, weights, config=JaxConfig())
    return jax_fs.build_setup(moved, weights, config=JaxConfig(), reuse_from=j0)


@pytest.mark.parametrize("fusion", ["fused", "per-level"])
def test_moved_origin_in_a_kept_window_matches_jax(fusion, programs):
    """The liquid moves inside the window: the window is kept, its origin
    moves, the setup programs replay (no capture), and the hierarchy is
    JAX's, and a fresh eager build's, bit for bit."""
    phi, moved, _, weights = _moving_drop()
    tcfg = SolverConfig(setup_fusion=fusion)
    js = _jax_moved_setup()
    t0 = free_surface.build_setup(phi, weights, config=tcfg, device="cpu")
    captures = dict(graph.STATS.program_captures)
    ts = free_surface.build_setup(moved, weights, config=tcfg, reuse_from=t0, device="cpu")
    assert ts.expanded_shape == t0.expanded_shape == tuple(js.expanded_shape)
    assert ts.window_start != t0.window_start
    assert ts.window_start == tuple(int(s) for s in np.asarray(js.window_start))
    assert dict(graph.STATS.program_captures) == captures and sum(graph.STATS.program_hits.values()) > 0
    jh = js.problem.hier
    _assert_hierarchy_matches((ts.problem.hier.levels, (), (), None), (jh.levels, (), (), None))
    assert np.array_equal(ts.problem.hier.coarse_minv.numpy(), np.asarray(jh.coarse_minv))
    with graph.programs_off():
        fresh = free_surface.build_setup(moved, weights, config=tcfg, device="cpu")
    assert fresh.window_start == ts.window_start
    got, want = graph.tensors(ts.problem), graph.tensors(fresh.problem)
    assert len(got) == len(want) and all(torch.equal(a, b) for a, b in zip(got, want))
    # The setup a caller holds is its own: the replay left t0 as it was.
    again = free_surface.build_setup(phi, weights, config=tcfg, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(graph.tensors(t0.problem), graph.tensors(again.problem)))


def test_program_results_are_the_callers(programs):
    """A replay overwrites the program's own buffers, never a result the
    caller holds: the first call's output keeps its values after a second
    call with other inputs; one capture, one hit."""
    def fn(x, y, split):
        return {"sum": x + y, "both": (x * 2, y)}

    a = graph.call("test", (), fn, (torch.ones(4), torch.zeros(4)), "cpu")
    b = graph.call("test", (), fn, (torch.full((4,), 3.0), torch.ones(4)), "cpu")
    assert torch.equal(a["sum"], torch.ones(4)) and torch.equal(a["both"][0], torch.full((4,), 2.0))
    assert torch.equal(b["sum"], torch.full((4,), 4.0)) and torch.equal(b["both"][1], torch.ones(4))
    assert (graph.STATS.program_captures["test"], graph.STATS.program_hits["test"]) == (1, 1)
    # Another shape is another program.
    graph.call("test", (), fn, (torch.ones(5), torch.zeros(5)), "cpu")
    assert graph.STATS.program_captures["test"] == 2


def test_program_cache_evicts_least_recently_used(monkeypatch, programs):
    """At capacity, the least recently used program goes (and is closed)."""
    cache = graph.Programs(capacity=2)
    monkeypatch.setattr(graph, "PROGRAMS", cache)
    for n in (1, 2, 1, 3):
        graph.call("test", (), lambda x, split: x + 1, (torch.zeros(n),), "cpu")
    assert len(cache) == 2 and graph.STATS.program_evictions["test"] == 1
    captures = graph.STATS.program_captures["test"]
    for n in (3, 1):  # still cached
        graph.call("test", (), lambda x, split: x + 1, (torch.zeros(n),), "cpu")
    assert graph.STATS.program_captures["test"] == captures
    graph.call("test", (), lambda x, split: x + 1, (torch.zeros(2),), "cpu")  # the (2,) program went
    assert graph.STATS.program_captures["test"] == captures + 1
    cache.clear()
    assert len(cache) == 0


def test_program_over_half_the_budget_is_not_kept(monkeypatch, programs):
    """A program that takes more than half the cache's budget runs once and
    is not kept, and its key is not captured again: its later calls run
    uncached (counted as declined), with the same results.  A program
    under the limit is kept and replayed."""
    monkeypatch.setattr(programs, "budget_bytes", lambda device: 100.0)  # half: 50 bytes

    def fn(x, split):
        split()
        return x * 2

    big, small = torch.arange(8.0, dtype=torch.float64), torch.arange(2.0, dtype=torch.float64)  # 64, 16 bytes
    assert torch.equal(graph.call("test", (), fn, (big,), "cpu"), big * 2)  # captured, run, not kept
    assert len(programs) == 0 and graph.STATS.program_captures["test"] == 1
    assert torch.equal(graph.call("test", (), fn, (big + 1,), "cpu"), (big + 1) * 2)
    assert graph.STATS.program_declined["test"] == 1 and graph.STATS.program_captures["test"] == 1
    for _ in range(2):
        assert torch.equal(graph.call("test", (), fn, (small,), "cpu"), small * 2)
    assert len(programs) == 1 and graph.STATS.program_captures["test"] == 2 and graph.STATS.program_hits["test"] == 1


def test_solve_program_belongs_to_its_problem(programs):
    """A solve's program belongs to its key, not to one problem: it copies
    the problem in, so a second solve of the same problem and a solve of
    another problem of the same shapes both replay it, each with its own
    answer; another tolerance is another program."""
    n = 16
    phi, velocity = sdf.splash_scene((n, n, n), device="cpu")
    weights = sdf.open_box_weights((n, n, n), device="cpu")
    cfg = SolverConfig(tolerance=1e-8)
    with graph.programs_off():
        setups = [free_surface.build_setup(phi, weights, config=cfg)]
        setups.append(free_surface.build_setup(phi + 0.01, weights, config=cfg, reuse_from=setups[0]))
    assert setups[0].expanded_shape == setups[1].expanded_shape
    rhs = free_surface.embed_window(free_surface.negative_divergence(setups[0].liquid_mask, velocity,
                                                                     setups[0].weights),
                                    setups[0].window_start, setups[0].base_pads, setups[0].expanded_shape)
    with graph.programs_off():
        want = [mgpcg.solve(s.problem, rhs, config=cfg) for s in setups]
    got = [mgpcg.solve(setups[0].problem, rhs, config=cfg) for _ in range(2)]
    got.append(mgpcg.solve(setups[1].problem, rhs, config=cfg))
    assert (graph.STATS.program_captures["solve"], graph.STATS.program_hits["solve"]) == (1, 2)
    for g, w in zip(got, want[:1] * 2 + want[1:]):
        assert g.iterations == w.iterations and torch.equal(g.x, w.x)
        assert g.relative_residual == w.relative_residual and g.converged is w.converged is True
    assert not torch.equal(want[0].x, want[1].x)
    mgpcg.solve(setups[0].problem, rhs, config=SolverConfig(tolerance=1e-6))
    assert graph.STATS.program_captures["solve"] == 2
