"""The port's CG loop with its state on the device against the JAX package's.

The JAX package runs the loop under `lax.while_loop` (`solver/cg.py::
solve_pcg_fused`, state `_FState`); the port keeps the same state as
device tensors (`solver/cg.py::FusedState`), runs it eagerly on the CPU
(`cg.run_eager`, the host reading `running` after each iteration) and on
the card replays a captured iteration behind an IF node
(`solver/graph.py`).  fp64, fixtures made with numpy (a 24^3 fractional
sine domain expanded to 64^3, a closed 16^3 box expanded to 32^3):

* every case through `mgpcg.solve` of both packages: iterations and
  `converged` equal, residual histories within 1e-12, x within 1e-10 of
  max |x| -- cold and warm starts, a zero right-hand side, the tolerance
  met at iteration 0, the `max_iterations` cap, an `interrupt_check`
  stopping at iteration 4, and null-space projection (a closed box,
  diagonal preconditioner), with `record_residuals` on in all but one;
* `graph.run` with its IF node emulated on the host (`graph.Emulated`: the
  body runs only where `running` holds, into the same two p buffers) at
  K = 1, 3 and 8 launches per host read gives the eager loop's bits.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geometricmultigridpressuresolver_tpu.config import SolverConfig as JaxConfig
from geometricmultigridpressuresolver_tpu.ops import domain as jax_domain
from geometricmultigridpressuresolver_tpu.solver import mgpcg as jax_mgpcg
from geometricmultigridpressuresolver_tpu_torch import parallel
from geometricmultigridpressuresolver_tpu_torch.config import SolverConfig
from geometricmultigridpressuresolver_tpu_torch.solver import cg, graph, mgpcg
from tests import helpers

torch.set_num_threads(1)

X_TOL = 1e-10      # of max |x|
HIST_TOL = 1e-12   # absolute, on relative residuals

# name -> (fixture, config overrides, warm start, zero rhs, interrupt at).
# Most cases share one config (JAX compiles a solve per config).
BASE = dict(tolerance=1e-10, record_residuals=True)
CASES = {
    "cold": ("sine", BASE, False, False, None),
    "warm": ("sine", BASE, True, False, None),
    "zero_rhs": ("sine", BASE, False, True, None),
    "met_at_start": ("sine", dict(tolerance=1.0), False, False, None),
    "cap": ("sine", dict(BASE, tolerance=1e-14, max_iterations=3), False, False, None),
    "interrupt": ("sine", BASE, False, False, 4),
    "null_space": ("box", dict(record_residuals=True), False, False, None),
}
# The block-mesh case runs only against the eager loop (its plain sharded
# path is slow on the CPU): the default tolerance, on a (2, 2, 1) mesh.
MESH_CASE = ("sine", dict(record_residuals=True), False, False, None)
NULL_SPACE = dict(project_null_space=True, use_mg_preconditioner=False, max_mg_levels=1, max_iterations=400)


def _fixture(name):
    if name == "sine":  # expanded to 64^3, 3 levels
        labels, weights, levels = helpers.expanded_domain(helpers.sine_dirichlet_domain, 24, fractional=True)
    else:  # a closed box of liquid, expanded to 32^3: the all-Neumann system
        base = np.full((16, 16, 16), helpers.INT, dtype=np.int8)
        expanded, _, _ = jax_domain.expand_domain(base)
        weights = helpers.unit_weights(np.asarray(expanded))
        labels, levels = np.asarray(jax_domain.set_boundary_labels(expanded, weights)), 1
    rhs = helpers.random_solvable_field(labels, seed=7)
    if name == "box":
        solv = labels >= helpers.INT
        rhs = np.where(solv, rhs - rhs[solv].mean(), 0.0)
    x0 = 0.1 * helpers.random_solvable_field(labels, seed=8)
    return labels, weights, levels, rhs, x0


@functools.lru_cache(maxsize=None)
def _problems(name, extra: tuple):
    """(numpy inputs, port problem, JAX problem) of a fixture and config."""
    labels, weights, levels, rhs, x0 = _fixture(name)
    kw = dict(extra)
    port = mgpcg.build_problem(labels, weights, levels, SolverConfig(**kw), device="cpu")
    jax = jax_mgpcg.build_problem(labels, weights, levels, JaxConfig(solve_dtype=jnp.float64, **kw))
    return (labels, rhs, x0), port, jax


def _case(name):
    fixture, overrides, warm, zero, interrupt_at = MESH_CASE if name == "block_mesh" else CASES[name]
    kw = dict(NULL_SPACE) if fixture == "box" else {}
    kw.update(overrides)
    structural = tuple(sorted((k, v) for k, v in kw.items() if k in ("project_null_space",
                                                                      "use_mg_preconditioner",
                                                                      "max_mg_levels")))
    (labels, rhs, x0), port, jax = _problems(fixture, structural)
    if zero:
        rhs = np.zeros_like(rhs)
    return kw, rhs, (x0 if warm else None), interrupt_at, port, jax


def _emulated(monkeypatch, k):
    """`graph.run` with the IF node emulated on the host, K = `k`."""
    monkeypatch.setattr(graph, "REPLAYS", k)
    return functools.partial(graph.run, graphs=graph.Emulated)


def _port_solve(name, run_loop=None, mesh=None):
    """The port's solve of a case: `mgpcg.solve` (eager on the CPU), or with
    `run_loop` the same operators (on a block `mesh` when given) through
    `cg.solve_pcg_fused` driven by it."""
    kw, rhs, x0, interrupt_at, problem, _ = _case(name)
    config = SolverConfig(**kw)
    seen = []

    def check(it):
        seen.append(it)
        return it >= interrupt_at

    check = None if interrupt_at is None else check
    rhs_t = torch.from_numpy(rhs)
    x0_t = None if x0 is None else torch.from_numpy(x0)
    if run_loop is None:
        return mgpcg.solve(problem, rhs_t, x0_t, config=config, interrupt_check=check), seen
    stages = mgpcg.solve_stages(problem, config, mesh)
    result = cg.solve_pcg_fused(
        stages.step_p, stages.residual, stages.preconditioner, rhs_t, problem.fine.solvable, x0=x0_t,
        tolerance=config.tolerance, max_iterations=config.max_iterations,
        project_null_space=config.project_null_space, preconditioner_dot=stages.preconditioner_dot,
        record_residuals=config.record_residuals, interrupt_check=check, run_loop=run_loop,
    )
    return result, seen


@pytest.mark.parametrize("name", sorted(CASES))
def test_loop_matches_jax(name):
    kw, rhs, x0, interrupt_at, _, jax_problem = _case(name)
    got, seen = _port_solve(name)
    jcfg = JaxConfig(solve_dtype=jnp.float64, **kw)
    want = jax_mgpcg.solve(
        jax_problem, jnp.asarray(rhs), None if x0 is None else jnp.asarray(x0), config=jcfg,
        interrupt_check=None if interrupt_at is None else (lambda it: it >= interrupt_at),
    )
    iters = int(want.iterations)
    assert got.iterations == iters
    assert got.converged == bool(want.converged)
    want_x = np.asarray(want.x)
    scale = max(float(np.abs(want_x).max()), 1e-300)
    assert float(np.abs(got.x.numpy() - want_x).max()) <= X_TOL * scale
    assert abs(got.relative_residual - float(want.relative_residual)) <= HIST_TOL
    if kw.get("record_residuals"):
        np.testing.assert_allclose(got.residual_history.numpy(), np.asarray(want.residual_history),
                                   rtol=0, atol=HIST_TOL)
    else:
        assert got.residual_history is None
    if name == "zero_rhs":
        assert iters == 0 and got.converged and not got.x.any()
    if name == "met_at_start":
        assert iters == 0 and got.converged
    if name == "cap":
        assert iters == 3 and not got.converged
    if name == "interrupt":
        assert iters == interrupt_at and not got.converged and seen == list(range(1, interrupt_at + 1))
    if name == "null_space":
        assert got.converged and abs(float(got.x[torch.from_numpy(rhs) != 0].mean())) < 1e-10


@functools.lru_cache(maxsize=None)
def _eager_solve(name):
    """The eager loop's solve of a case, made once for all its K values."""
    mesh = parallel.make_mesh(4, device="cpu") if name == "block_mesh" else None
    return _port_solve(name, run_loop=cg.run_eager, mesh=mesh)


def _same(a, b) -> bool:
    return torch.equal(torch.nan_to_num(a, nan=-7.0), torch.nan_to_num(b, nan=-7.0)) and bool(
        (a.isnan() == b.isnan()).all()
    )


@pytest.mark.parametrize("name, k", [
    (name, k) for name in ("cold", "warm", "cap", "interrupt", "null_space") for k in (1, 3, 8)
] + [("block_mesh", 3)])
def test_emulated_replays_match_eager(name, k, monkeypatch):
    """K launches per host read, each launch's body gated by `running`,
    give the bits of the eager loop (and so of K = 1); "block_mesh" runs on
    a (2, 2, 1) block mesh, every level sharded (the CG step scatters p'
    into the loop's buffers)."""
    mesh = parallel.make_mesh(4, device="cpu") if name == "block_mesh" else None
    eager, seen_eager = _eager_solve(name)
    replayed, seen = _port_solve(name, run_loop=_emulated(monkeypatch, k), mesh=mesh)
    assert replayed.iterations == eager.iterations and replayed.converged == eager.converged
    assert torch.equal(replayed.x, eager.x)
    assert replayed.relative_residual == eager.relative_residual
    assert seen == seen_eager
    assert _same(replayed.residual_history, eager.residual_history)


def test_replay_reads_per_solve(monkeypatch):
    """One host read per K launches: the cold 24^3 solve's iterations after
    the eager first one, rounded up to K, and one read at K = 1 per
    iteration with an interrupt check."""
    graph.STATS.reset()
    got, _ = _port_solve("cold", run_loop=_emulated(monkeypatch, 4))
    assert graph.STATS.reads == max(1, -(-(got.iterations - 1) // 4))
    assert graph.STATS.captures == 0  # the emulation captures nothing
    graph.STATS.reset()
    got, seen = _port_solve("interrupt", run_loop=_emulated(monkeypatch, 8))
    assert graph.STATS.reads == got.iterations == len(seen)


def test_state_lives_in_place():
    """x, r and the scalars keep their tensors through the loop (a captured
    iteration reads and writes fixed addresses); p alternates between two
    buffers; the history is written at the device count."""
    kw, rhs, _, _, problem, _ = _case("cold")
    config = SolverConfig(**kw)
    stages = mgpcg.solve_stages(problem, config)
    b = torch.from_numpy(rhs)
    loop = cg._Loop(b, problem.fine.solvable, config.tolerance, config.max_iterations, True)
    loop.fetch()
    body = cg.FusedCG(stages.step_p, stages.preconditioner_dot, problem.fine.solvable, False, loop, b.dtype)
    r = torch.where(problem.fine.solvable, b, 0.0)
    z, rho = stages.preconditioner_dot(r)
    rr = (r * r).sum()
    s = cg.FusedState(torch.zeros_like(b), r, z, z, rho.clone(), torch.zeros_like(rho), rr,
                      torch.zeros((), dtype=torch.int32), torch.zeros((), dtype=torch.bool),
                      torch.zeros((), dtype=torch.bool), loop.history)
    ids = [id(t) for t in (s.x, s.r, s.rho, s.beta, s.rr, s.it, s.running)]
    body.head(s)
    p0, p1 = s.p, torch.empty_like(s.p)
    for step in range(4):
        body.tail(s)
        body.head(s, (p1, p0)[step % 2])
        assert s.p is (p1, p0)[step % 2]
    assert [id(t) for t in (s.x, s.r, s.rho, s.beta, s.rr, s.it, s.running)] == ids
    assert int(s.it) == 5 and bool(s.running)
    assert float(loop.history[5]) == float(s.rr) and torch.isnan(loop.history[6:]).all()
