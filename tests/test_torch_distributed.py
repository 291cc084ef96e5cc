"""The port's mesh of ranks (parallel/distributed.py, parallel/sharding.py,
the rank-to-rank halos, the ordered dots, build_setup / solve / project
with `mesh=` a `DistMesh`) against the JAX package.

Pure helpers (`local_slices`, `make_global_grid`, `host_local_dofs`) are
checked rank by rank without a world.  The rest spawns worlds of 2 or 4
ranks with the gloo backend on the CPU (`parallel.dryrun.launch`): the
ranks import this module with JAX blocked, so it imports JAX and the JAX
package only inside the functions the test process runs (`_jax`).  The
references: JAX's single-device solve and projection and its
`distribute_problem` solve on the conftest's 8 virtual CPU devices, at the
JAX tests' tolerances (1e-11 for the projection, iterations equal), and
the port's single process (x within 1e-12 in fp64: only the order of the
dots' additions differs).
"""

import numpy as np
import pytest
import torch

from geometricmultigridpressuresolver_tpu_torch import diagnostics
from geometricmultigridpressuresolver_tpu_torch.config import SolverConfig
from geometricmultigridpressuresolver_tpu_torch.models import free_surface, sdf
from geometricmultigridpressuresolver_tpu_torch.ops import blas
from geometricmultigridpressuresolver_tpu_torch.parallel import distributed, dryrun, halo
from geometricmultigridpressuresolver_tpu_torch.parallel.mesh import BlockMesh, DistMesh, grid_split, local_slices
from geometricmultigridpressuresolver_tpu_torch.solver import mg, mgpcg

torch.set_num_threads(1)
CPU = torch.device("cpu")
TIMEOUT = 240.0


def _jax():
    """JAX and the JAX package's modules the references need (test process only)."""
    import jax
    import jax.numpy as jnp

    from geometricmultigridpressuresolver_tpu import diagnostics as jax_diag
    from geometricmultigridpressuresolver_tpu.config import SolverConfig as JaxConfig
    from geometricmultigridpressuresolver_tpu.models import free_surface as jax_fs
    from geometricmultigridpressuresolver_tpu.models import sdf as jax_sdf
    from geometricmultigridpressuresolver_tpu.parallel import distributed as jax_dist
    from geometricmultigridpressuresolver_tpu.parallel import mesh as jax_mesh
    from geometricmultigridpressuresolver_tpu.solver import mgpcg as jax_mgpcg
    from tests import helpers

    return dict(jax=jax, jnp=jnp, diag=jax_diag, Config=JaxConfig, fs=jax_fs, sdf=jax_sdf,
                dist=jax_dist, mesh=jax_mesh, mgpcg=jax_mgpcg, helpers=helpers)


def _launch(job, world_size, **kwargs):
    return dryrun.launch(job, world_size, "gloo", "cpu", kwargs, timeout=TIMEOUT)


# ---- rank-side jobs (run in the spawned ranks) ------------------------------------


def world4_job(mesh, grid, simple16, scenes):
    """The (2, 2, 1) world: (d) halo exchanges at depths 8 and 1 of this
    rank's block of `grid`; (g) a dot and a max of seeded blocks over the
    ranks, and a solve that rank 0 interrupts after 3 iterations; (f) the
    splash `scenes` built and projected with `mesh=`."""
    out = {"rank": mesh.rank}
    split = (True, True, False)
    block = torch.as_tensor(grid)[local_slices(mesh.shape, grid.shape, mesh.rank, split)].contiguous()
    for depth in (8, 1):
        geom = halo.geometry(mesh, grid.shape, depth)
        out[f"haloed{depth}"] = halo.exchange_halos(block, geom, mesh).numpy()
    rng = np.random.default_rng(100 + mesh.rank)
    x, y = (torch.from_numpy(rng.standard_normal((8, 8, 4))) for _ in range(2))
    solvable = torch.from_numpy(rng.random((8, 8, 4)) < 0.7)
    ranks = distributed.Ranks(mesh, True)
    out["partial"] = float(blas.dot(x, y, solvable))
    out["total"] = float(blas.dot(x, y, solvable, ranks))
    out["partial_max"] = float(blas.inf_norm(x, solvable))
    out["total_max"] = float(blas.inf_norm(x, solvable, ranks))
    labels, mg_levels, rhs = simple16
    stopped = dryrun.solve_job(mesh, labels, None, mg_levels, rhs, dict(tolerance=1e-12), interrupt_at=3)
    out["interrupted"] = {k: stopped[k] for k in ("iterations", "converged", "flags")}
    for n, scene in scenes.items():
        out[n] = dryrun.project_job(mesh, n=n, tolerance=1e-7, fields=True, print_line=False, scene=scene)
    return out


def world2_job(mesh, problems):
    """The (2, 1, 1) world: (e) each labelled domain of `problems` solved
    with `mesh=`."""
    return {name: dryrun.solve_job(mesh, *args, config_kwargs=dict(tolerance=1e-8))
            for name, args in problems.items()}


# ---- (a)-(c), (h): no world ---------------------------------------------------------


@pytest.mark.parametrize("mesh_shape, shape", [
    ((2, 2, 1), (16, 16, 16)), ((2, 2, 2), (16, 16, 16)), ((2, 2, 2), (16, 16, 8)), ((2, 2, 2), (8, 8, 8)),
])
def test_local_slices_cover_grid_as_jax(mesh_shape, shape):
    """Every rank's slices tile the grid once per replica set, and rank r's
    are JAX's for device r of the same mesh (row-major device order)."""
    j = _jax()
    jmesh = j["mesh"].make_mesh(int(np.prod(mesh_shape)))
    assert tuple(jmesh.devices.shape) == mesh_shape
    seen = np.zeros(shape, dtype=np.int32)
    jax_idx = {d.id: idx for idx, d in j["dist"].process_local_slices(shape, jmesh)}
    for r in range(int(np.prod(mesh_shape))):
        idx = local_slices(mesh_shape, shape, r)
        seen[idx] += 1
        assert tuple((s.start, s.stop) for s in idx) == tuple(
            (s.start or 0, n if s.stop is None else s.stop) for s, n in zip(jax_idx[r], shape)
        )
    assert seen.min() >= 1 and (seen == seen.flat[0]).all()


@pytest.mark.parametrize("form", ["array", "callable"])
def test_make_global_grid_roundtrip(form):
    full = np.random.default_rng(3).standard_normal((16, 16, 16))
    got = np.zeros_like(full)
    for r in range(8):
        mesh = DistMesh((2, 2, 2), r, CPU, "gloo")
        block = distributed.make_global_grid(full.shape, full if form == "array" else (lambda idx: full[idx]), mesh)
        (idx, _), = distributed.process_local_slices(full.shape, mesh)
        assert block.shape == (8, 8, 8)
        got[idx] = block.numpy()
    np.testing.assert_array_equal(got, full)


@pytest.mark.parametrize("shape", [(16, 16, 16), (16, 16, 8), (8, 8, 8)])
def test_host_local_dofs_match_jax(shape):
    """Summed over the ranks, the port's shares equal JAX's
    `host_local_dofs` on the 8-virtual-device mesh (with a replicated z
    axis, and a grid replicated whole) and the grid's count."""
    j = _jax()
    jmesh = j["mesh"].make_mesh(8)
    solvable = np.random.default_rng(4).random(shape) < 0.4
    sharding = j["jax"].sharding.NamedSharding(jmesh, j["mesh"].grid_pspec(jmesh, shape))
    want = j["dist"].host_local_dofs(j["jax"].device_put(solvable, sharding))
    got = 0
    for r in range(8):
        mesh = DistMesh((2, 2, 2), r, CPU, "gloo")
        got += distributed.host_local_dofs(distributed.distribute_grid(solvable, mesh), mesh, shape)
    assert got == want == int(solvable.sum())


def test_initialize_without_card_raises(monkeypatch):
    """No backend and no card: NCCL cannot run, so it raises before starting
    anything; it does not start gloo on the CPU instead."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        distributed.initialize(init_method="file:///nonexistent/never", world_size=1, rank=0)
    with pytest.raises(ValueError, match="NCCL backend needs a CUDA device"):
        distributed.initialize(device="cpu", init_method="file:///nonexistent/never", world_size=1, rank=0)
    assert not torch.distributed.is_initialized()


# ---- (d)-(g): two worlds, 4 and 2 ranks, beside their references ----------------------------


@pytest.fixture(scope="module")
def worlds():
    """Both worlds run in background threads (the ranks are processes) while
    this process computes the references: JAX's solves of JAX
    `test_two_process_dryrun`'s fixture (the simple domain at 16, the
    delta-spike right-hand side) single-device and `distribute_problem` on
    8 virtual devices, JAX's single-device solve of the 32^3 fractional
    sine fixture, the port's single-process solves of both fixtures, and
    JAX's single-device setup and projection of the 32^3 splash (no level
    splits on (2, 2, 1)) and of the 40^3 one (window (48, 48, 48): L0 runs
    sharded), with the port's single-process projection at 40^3."""
    from concurrent.futures import ThreadPoolExecutor

    j = _jax()
    base = diagnostics.build_simple_domain(16)
    labels, _, offset, mg_levels = diagnostics.expand(base)
    cfg = SolverConfig(tolerance=1e-8)
    problem16 = mgpcg.build_problem(labels, None, mg_levels, cfg, device="cpu")
    rhs16 = diagnostics.delta_spike_rhs(
        labels.shape, solvable=problem16.fine.solvable.numpy(), offset=offset, base_shape=base.shape
    )
    s_labels, s_weights, s_levels = j["helpers"].expanded_domain(j["helpers"].sine_dirichlet_domain, 32,
                                                                  fractional=True)
    problems = {
        "simple16": (labels, None, mg_levels, rhs16),
        "sine32": (s_labels, s_weights, s_levels, j["helpers"].random_solvable_field(s_labels, seed=21)),
    }
    grid = np.random.default_rng(7).standard_normal((32, 32, 8))
    scenes = {}
    for n in (32, 40):
        phi, velocity = j["sdf"].splash_scene((n, n, n))
        weights = j["sdf"].open_box_weights((n, n, n))
        scenes[n] = (np.asarray(phi), tuple(np.asarray(v) for v in velocity), tuple(np.asarray(w) for w in weights))
    with ThreadPoolExecutor(2) as ex:
        w4 = ex.submit(_launch, f"{__name__}:world4_job", 4, grid=grid,
                       simple16=(labels, mg_levels, rhs16), scenes=scenes)
        w2 = ex.submit(_launch, f"{__name__}:world2_job", 2, problems=problems)
        jcfg = j["Config"](tolerance=1e-8)
        jproblem = j["mgpcg"].build_problem(labels, None, mg_levels, jcfg)
        jmesh = j["mesh"].make_mesh(8)
        jax16 = [
            j["mgpcg"].solve(jproblem, j["jnp"].asarray(rhs16), config=jcfg),
            j["mgpcg"].solve(j["dist"].distribute_problem(jproblem, jmesh),
                             j["dist"].distribute_grid(j["jnp"].asarray(rhs16), jmesh), config=jcfg),
        ]
        s_rhs = problems["sine32"][3]
        jax_sine32 = j["mgpcg"].solve(j["mgpcg"].build_problem(s_labels, s_weights, s_levels, jcfg),
                                      j["jnp"].asarray(s_rhs), config=jcfg)
        single = {}
        for name, (lab, w, lev, rhs) in problems.items():
            problem = mgpcg.build_problem(lab, w, lev, cfg, device="cpu")
            single[name] = (int(problem.fine.solvable.sum()), mgpcg.solve(problem, torch.from_numpy(rhs), config=cfg))
        jcfg7, cfg7 = j["Config"](tolerance=1e-7), SolverConfig(tolerance=1e-7)
        splash = {}
        for n, (phi, velocity, weights) in scenes.items():
            jsetup = j["fs"].build_setup(phi, weights, config=jcfg7)
            splash[n] = (jsetup, j["fs"].project(jsetup, velocity, config=jcfg7))
        phi, velocity, weights = scenes[40]
        setup40 = free_surface.build_setup(phi, weights, config=cfg7, device="cpu")
        port40 = free_surface.project(setup40, velocity, config=cfg7)
        return dict(grid=grid, problems=problems, jax16=jax16, jax_sine32=jax_sine32, single=single,
                    splash=splash, port40=port40, w4=w4.result(), w2=w2.result())


@pytest.mark.parametrize("depth", [8, 1])
def test_exchange_halos_equal_the_gather(worlds, depth):
    """Each rank's haloed block equals its block of the one-card gather of
    the global grid: neighbours' slabs, corners by the transitive exchange,
    zeros past the mesh edges."""
    grid = worlds["grid"]
    geom = halo.geometry(BlockMesh((2, 2, 1), CPU), grid.shape, depth)
    stacked = halo.halo_gather_torch(torch.from_numpy(grid), geom).numpy()
    rows = geom.block_shape[0]
    for r, res in enumerate(worlds["w4"]):
        assert res[f"haloed{depth}"].shape == geom.block_shape
        np.testing.assert_array_equal(res[f"haloed{depth}"], stacked[r * rows:(r + 1) * rows])


def test_dot_is_the_rank_ordered_sum_on_every_rank(worlds):
    results = worlds["w4"]
    totals = {res["total"] for res in results}
    assert len(totals) == 1
    acc = np.float64(results[0]["partial"])
    for res in results[1:]:
        acc = acc + np.float64(res["partial"])
    assert totals == {float(acc)}
    assert {res["total_max"] for res in results} == {max(res["partial_max"] for res in results)}


def test_interrupt_on_rank_zero_stops_every_rank(worlds):
    results = worlds["w4"]
    assert results[0]["interrupted"]["flags"][:2] == ["sharded", "sharded"]
    for res in results:
        assert res["interrupted"]["iterations"] == 3 and not res["interrupted"]["converged"]


@pytest.mark.parametrize("fixture", ["simple16", "sine32"])
def test_two_rank_solve_matches_jax(worlds, fixture):
    """JAX `test_two_process_dryrun`'s fixture (no level splits on (2, 1, 1):
    the solve runs whole on both ranks, the dots owned by rank 0): iterations
    equal to JAX's single-device solve and its `distribute_problem` solve,
    relative residual within 1e-10.  The 32^3 fractional sine fixture runs
    L0 sharded: iterations equal to JAX's single-device solve, x within
    1e-11 of it (`test_torch_sharded`'s tolerance for this fixture).  Both:
    x within 1e-12 of the port's single process, iterations equal, local
    DOFs summing to the total."""
    labels = worlds["problems"][fixture][0]
    dofs, single = worlds["single"][fixture]
    results = [res[fixture] for res in worlds["w2"]]
    assert results[0]["flags"][0] == ("single" if fixture == "simple16" else "sharded")
    x = np.zeros(labels.shape)
    for res in results:
        assert res["converged"] and res["iterations"] == single.iterations
        if fixture == "simple16":
            want, want_dist = worlds["jax16"]
            assert res["iterations"] == int(want.iterations) == int(want_dist.iterations)
            assert abs(res["relative_residual"] - float(want.relative_residual)) < 1e-10
        else:
            assert res["iterations"] == int(worlds["jax_sine32"].iterations)
        x[res["slices"]] = res["x"]
    np.testing.assert_allclose(x, single.x.numpy(), rtol=0, atol=1e-12)
    if fixture == "sine32":
        np.testing.assert_allclose(x, np.asarray(worlds["jax_sine32"].x), rtol=0, atol=1e-11)
    assert sum(res["local_dofs"] for res in results) == dofs


@pytest.mark.parametrize("n", [32, 40])
def test_four_rank_setup_blocks_bit_identical(worlds, n):
    """Every rank's blocks of the problem are the slices of JAX's whole
    single-device build (as JAX `test_sharded_setup_bit_identical`): no
    level split at 32^3, L0 split at 40^3."""
    setup = worlds["splash"][n][0]
    results = [res[n] for res in worlds["w4"]]
    flags = results[0]["flags"]
    assert flags[0] == ("sharded" if n == 40 else "single")
    hier = setup.problem.hier
    for res in results:
        assert tuple(res["expanded_shape"]) == tuple(setup.expanded_shape)
        assert tuple(res["window_start"]) == tuple(int(s) for s in np.asarray(setup.window_start))
        assert [tuple(s) for s in res["shapes"]] == [tuple(c.shape) for c in hier.levels]
        mesh = DistMesh(tuple(res["mesh"]), res["rank"], CPU, "gloo")
        pairs = list(zip(hier.levels, res["levels"], flags)) + [(setup.problem.fine, res["fine"], flags[0])]
        for level, (c, got, flag) in enumerate(pairs):
            split = tuple(s and flag == "sharded" for s in grid_split(mesh, c.shape))
            idx = local_slices(mesh.shape, c.shape, mesh.rank, split)
            for f in c._fields:
                want = np.asarray(getattr(c, f))[idx]
                np.testing.assert_array_equal(got[f].astype(want.dtype), want, err_msg=f"[{level}] {f}")
        for k in ("coarse_dofs", "coarse_minv", "coarse_chol"):
            np.testing.assert_array_equal(res["coarse"][k], np.asarray(getattr(hier, k)))


@pytest.mark.parametrize("n", [32, 40])
def test_four_rank_projection_matches(worlds, n):
    """`project(mesh=)` on 4 ranks: iterations equal, pressure and velocity
    within 1e-11 of JAX's single device (JAX
    `test_sharded_setup_projection_matches`' tolerance), and at 40^3, where
    L0 runs sharded, of the port's single process too; local DOFs summing
    to the total."""
    setup, want = worlds["splash"][n]
    results = [res[n] for res in worlds["w4"]]
    refs = [want] + ([worlds["port40"]] if n == 40 else [])
    for res in results:
        for ref in refs:
            assert res["iterations"] == int(ref.cg.iterations) and res["converged"]
            np.testing.assert_allclose(res["pressure"], np.asarray(ref.pressure), rtol=0, atol=1e-11)
            for a in range(3):
                np.testing.assert_allclose(res["velocity"][a], np.asarray(ref.velocity[a]), rtol=0, atol=1e-11)
    assert sum(res["local_dofs"] for res in results) == int(np.asarray(setup.problem.fine.solvable).sum())


def test_sharded_problem_rejects_a_second_cut():
    """A problem already holding a rank's blocks is not cut again, and a
    field that is neither the fine grid nor the rank's block is refused."""
    n = 16
    phi, _ = sdf.splash_scene((n, n, n), device="cpu")
    cfg = SolverConfig()
    setup = free_surface.build_setup(phi, sdf.open_box_weights((n, n, n), device="cpu"), config=cfg)
    mesh = DistMesh((2, 2, 1), 1, CPU, "gloo")
    problem = distributed.distribute_problem(setup.problem, mesh, cfg)
    assert problem.hier.shapes == tuple(tuple(c.shape) for c in setup.problem.hier.levels)
    with pytest.raises(ValueError, match="already holds"):
        distributed.distribute_problem(problem, mesh, cfg)
    layout = mgpcg.fine_layout(problem, cfg, mesh)
    with pytest.raises(ValueError, match="neither the fine grid"):
        mgpcg.fine_block(torch.zeros(3, 3, 3, dtype=torch.float64), problem, layout)
    assert mg.level_flags(problem.hier, cfg, mesh) == mg.level_flags(setup.problem.hier, cfg, mesh)
