"""The port's mesh of ranks (parallel/distributed.py, parallel/sharding.py,
the rank-to-rank halos, the ordered dots, the partitioned build_setup /
build_problem and project with `mesh=` a `DistMesh`) against the JAX
package.

Pure helpers (`local_slices`, `make_global_grid`, `host_local_dofs`, the
boxes of `parallel.mesh` and `redistribute`'s plan) are checked rank by
rank without a world.  The rest spawns worlds of 2 or 4
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
from geometricmultigridpressuresolver_tpu_torch.grids import CellLabel, MaterialLabel, face_shape
from geometricmultigridpressuresolver_tpu_torch.ops import domain
from geometricmultigridpressuresolver_tpu_torch.parallel import sharding
from geometricmultigridpressuresolver_tpu_torch.parallel.mesh import (
    BlockMesh,
    DistMesh,
    box_shape,
    box_slices,
    face_box,
    face_split,
    grid_split,
    grow_box,
    intersect,
    local_slices,
    shift_box,
    window_offset,
)
from geometricmultigridpressuresolver_tpu_torch.solver import mg, mgpcg

torch.set_num_threads(1)
CPU = torch.device("cpu")
TIMEOUT = 240.0
MM = dict(transfer_mode="mm")


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


def solid_scene(splash40: dict, seed: int = 9) -> dict:
    """The 40^3 splash with two small drops whose surfaces cross the x and
    y block edges of a (2, 2, 1) mesh (liquid-air faces on the edge
    planes, Dirichlet cells kept by liquid across them), a solid sphere in
    the pool with a seeded solid velocity, and a seeded warm start, in the
    splash's units (dx = 1/40)."""
    n = 40
    c = np.arange(n) + 0.5
    x, y, z = np.meshgrid(c, c, c, indexing="ij")
    drops = np.minimum(np.sqrt((x - 17.7) ** 2 + (y - 18.0) ** 2 + (z - 33.0) ** 2) - 2.5,
                       np.sqrt((x - 31.0) ** 2 + (y - 17.7) ** 2 + (z - 21.0) ** 2) - 2.5) / n
    rng = np.random.default_rng(seed)
    return dict(
        splash40,
        phi=np.minimum(splash40["phi"], drops),
        solid_phi=(4.0 - np.sqrt((x - 20.3) ** 2 + (y - 8.0) ** 2 + (z - 14.0) ** 2)) / n,
        solid_velocity=tuple(0.1 * rng.standard_normal(face_shape((n, n, n), a)) for a in range(3)),
        old_pressure=1e-3 * rng.standard_normal((n, n, n)),
    )


# ---- rank-side jobs (run in the spawned ranks) ------------------------------------


def world4_job(mesh, grid, simple16, scenes):
    """The (2, 2, 1) world: (d) halo exchanges at depths 8 and 1 of this
    rank's block of `grid`; (g) a dot and a max of seeded blocks over the
    ranks, and a solve that rank 0 interrupts after 3 iterations; (f) the
    `scenes` (name: (whole arrays, config)) built from this rank's blocks
    and projected with `mesh=`, and the 44^3 scene built once more with
    `validate=True`."""
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
    for name, (scene, config) in scenes.items():
        out[name] = dryrun.project_job(mesh, fields=True, print_line=False, scene=scene, config=config)
    scene, config = scenes[44]
    free_surface.build_setup(scene["phi"], scene["weights"], config=config, mesh=mesh, validate=True)
    return out


def world2_job(mesh, problems, mm=()):
    """The (2, 1, 1) world: (e) each labelled domain of `problems` solved
    with `mesh=`, and those named in `mm` once more with the matrix-form
    transfers (under "<name>_mm")."""
    out = {name: dryrun.solve_job(mesh, *args, config_kwargs=dict(tolerance=1e-8))
           for name, args in problems.items()}
    for name in mm:
        out[f"{name}_mm"] = dryrun.solve_job(mesh, *problems[name], config_kwargs=dict(tolerance=1e-8, **MM))
    return out


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


def test_boxes():
    """A block grown by a halo is clipped at the grid's edges; the faces of
    a cell box, intersections, and the window-to-base offset of JAX's
    ``_window_static`` (base index = start - pad_lo + j)."""
    shape = (32, 16, 24)
    core = ((16, 32), (0, 8), (0, 24))
    assert grow_box(core, 6, shape, (True, True, False)) == ((10, 32), (0, 14), (0, 24))
    assert face_box(core, 0) == ((16, 33), (0, 8), (0, 24))
    assert intersect(core, ((30, 40), (4, 6), (2, 3))) == ((30, 32), (4, 6), (2, 3))
    assert intersect(core, ((0, 16), (0, 8), (0, 24))) is None
    assert box_shape(core) == (16, 8, 24) and box_slices(((18, 20), (1, 2), (0, 4)), core)[:2] == (
        slice(2, 4), slice(1, 2))
    off = window_offset((3, 0, 5), ((4, 4), (2, 6), (4, 4)))
    assert off == (-1, -2, 1) and shift_box(core, off) == ((15, 31), (-2, 6), (1, 25))


def _moved(full, layout, dest, fill):
    """`redistribute` by its plan, rank by rank without a world: each
    destination box filled from the tensors the ranks hold (their boxes
    of `full`), with a count of the moves that wrote each cell."""
    outs = [np.full(box_shape(b), fill, dtype=full.dtype) for b in dest]
    counts = [np.zeros(box_shape(b), dtype=np.int32) for b in dest]
    for mv in distributed.redistribute_plan(layout, dest):
        holder = mv.dst if mv.local else mv.src
        assert mv.local == (mv.src == mv.dst or all(
            lo <= plo and phi <= hi for (lo, hi), (plo, phi) in zip(layout.held[mv.dst], mv.box)))
        held = full[box_slices(layout.held[holder])]
        outs[mv.dst][box_slices(mv.box, dest[mv.dst])] = held[box_slices(mv.box, layout.held[holder])]
        counts[mv.dst][box_slices(mv.box, dest[mv.dst])] += 1
    return outs, counts


@pytest.mark.parametrize("mesh_shape, shape, faces", [
    ((2, 2, 1), (32, 32, 16), None), ((2, 2, 1), (32, 32, 16), 0), ((2, 2, 1), (32, 32, 16), 1),
    ((2, 2, 2), (16, 16, 8), None), ((2, 2, 2), (16, 16, 8), 2),
])
def test_redistribute_plan_covers_each_cell_once(mesh_shape, shape, faces):
    """Every destination cell inside the grid comes from exactly one move,
    every cell outside it keeps the fill: base blocks (replicated where
    the mesh leaves an axis whole) into blocks grown by a halo, and into
    window blocks reaching past the grid (the padded base of
    `free_surface._window`); the faces of each rank's cells into the
    face arrays' blocks (whole along their own axis)."""
    mesh = DistMesh(mesh_shape, 0, CPU, "gloo")
    split = grid_split(mesh, shape)
    if faces is None:
        layout = distributed.block_layout(mesh, shape, split)
    else:
        layout = distributed.faces_layout(mesh, shape, split, faces)
    full = np.random.default_rng(5).standard_normal(layout.shape)
    window = (40, 36, 20)
    off = (-4, -2, -3)
    win_split = grid_split(mesh, window)
    cases = [
        [grow_box(b, 6, layout.shape, split) for b in layout.held],
        [shift_box(distributed.block_layout(mesh, window, win_split).held[r], off) for r in range(mesh.size)],
    ]
    if faces is not None:
        fs = face_split(mesh.shape, shape, faces)
        cases.append(distributed.block_layout(mesh, face_shape(shape, faces), fs).held)
    pad = [(max(0, -o), max(0, w + o - n)) for o, w, n in zip(off, window, layout.shape)]
    padded = np.pad(full, pad, constant_values=-7.0)
    for dest in cases:
        outs, counts = _moved(full, layout, dest, -7.0)
        for box, out, count in zip(dest, outs, counts):
            inside = np.zeros(box_shape(box), dtype=bool)
            clip = intersect(box, tuple((0, n) for n in layout.shape))
            if clip is not None:
                inside[box_slices(clip, box)] = True
            np.testing.assert_array_equal(count, inside.astype(np.int32))
            want = padded[tuple(slice(lo + p, hi + p) for (lo, hi), (p, _) in zip(box, pad))]
            np.testing.assert_array_equal(out, want)


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
    sharded), with the port's single-process projection at 40^3; with
    transfer_mode="mm", the port's single process on the 44^3 scene and the
    sine fixture, which the worlds also run with it."""
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
    cfg7 = SolverConfig(tolerance=1e-7)
    scenes = {}
    for n in (32, 40):
        phi, velocity = j["sdf"].splash_scene((n, n, n))
        weights = j["sdf"].open_box_weights((n, n, n))
        scenes[n] = (dict(phi=np.asarray(phi), velocity=tuple(np.asarray(v) for v in velocity),
                          weights=tuple(np.asarray(w) for w in weights)), cfg7)
    scenes["solid"] = (solid_scene(scenes[40][0]), cfg7)
    phi44, velocity44 = sdf.splash_scene((44, 44, 44), device="cpu")
    scenes[44] = (dict(phi=phi44.numpy(), velocity=tuple(v.numpy() for v in velocity44),
                       weights=tuple(w.numpy() for w in sdf.open_box_weights((44, 44, 44), device="cpu"))),
                  SolverConfig(tolerance=1e-7, coarse_dof_target=300))
    scenes["44mm"] = (scenes[44][0], SolverConfig(tolerance=1e-7, coarse_dof_target=300, **MM))
    with ThreadPoolExecutor(2) as ex:
        w4 = ex.submit(_launch, f"{__name__}:world4_job", 4, grid=grid,
                       simple16=(labels, mg_levels, rhs16), scenes=scenes)
        w2 = ex.submit(_launch, f"{__name__}:world2_job", 2, problems=problems, mm=("sine32",))
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
        lab, w, lev, rhs = problems["sine32"]
        cfg_mm = SolverConfig(tolerance=1e-8, **MM)
        single["sine32_mm"] = mgpcg.solve(mgpcg.build_problem(lab, w, lev, cfg_mm, device="cpu"),
                                          torch.from_numpy(rhs), config=cfg_mm)
        jcfg7 = j["Config"](tolerance=1e-7)
        splash = {}
        for name in (32, 40, "solid"):
            sc = scenes[name][0]
            jsetup = j["fs"].build_setup(sc["phi"], sc["weights"], sc.get("solid_phi"), config=jcfg7)
            splash[name] = (jsetup, j["fs"].project(jsetup, sc["velocity"], sc.get("solid_velocity"),
                                                     sc.get("old_pressure"), config=jcfg7))
        port = {}
        for name in (40, 44, "44mm"):
            sc, cfg = scenes[name]
            setup = free_surface.build_setup(sc["phi"], sc["weights"], config=cfg, device="cpu")
            port[name] = (setup, free_surface.project(setup, sc["velocity"], config=cfg))
        return dict(grid=grid, problems=problems, jax16=jax16, jax_sine32=jax_sine32, single=single,
                    splash=splash, port=port, scenes=scenes, w4=w4.result(), w2=w2.result())


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


@pytest.mark.parametrize("n", [32, 40, "solid"])
def test_four_rank_setup_blocks_bit_identical(worlds, n):
    """Every rank's blocks of the problem, built from its base blocks, are
    the slices of JAX's whole single-device build (as JAX
    `test_sharded_setup_bit_identical`): no level split at 32^3, L0 split
    at 40^3 and in the solid scene."""
    setup = worlds["splash"][n][0]
    results = [res[n] for res in worlds["w4"]]
    flags = results[0]["flags"]
    assert flags[0] == ("single" if n == 32 else "sharded")
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


@pytest.mark.parametrize("n", [32, 40, "solid"])
def test_four_rank_projection_matches(worlds, n):
    """`project(mesh=)` on 4 ranks from their blocks: iterations equal,
    pressure and velocity within 1e-11 of JAX's single device (JAX
    `test_sharded_setup_projection_matches`' tolerance), and at 40^3, where
    L0 runs sharded, of the port's single process too; local DOFs summing
    to the total.  The solid scene adds a solid, its velocity and a warm
    start."""
    setup, want = worlds["splash"][n]
    results = [res[n] for res in worlds["w4"]]
    refs = [want] + ([worlds["port"][40][1]] if n == 40 else [])
    for res in results:
        for ref in refs:
            assert res["iterations"] == int(ref.cg.iterations) and res["converged"]
            np.testing.assert_allclose(res["pressure"], np.asarray(ref.pressure), rtol=0, atol=1e-11)
            for a in range(3):
                np.testing.assert_allclose(res["velocity"][a], np.asarray(ref.velocity[a]), rtol=0, atol=1e-11)
    assert sum(res["local_dofs"] for res in results) == int(np.asarray(setup.problem.fine.solvable).sum())


def test_four_rank_l1_split_bit_identical(worlds):
    """The smallest splash whose hierarchy runs L1 sharded as well as L0 on
    (2, 2, 1) (44^3 with coarse_dof_target=300: window (64, 64, 64), L0-L2
    sharded, the coarsest level whole): every rank's blocks of the problem
    and of the base fields equal the port's single-process build cut by
    `shard_setup`, bit for bit; the projection equals the single process's
    (iterations, pressure and velocity within 1e-12); the ranks also passed
    `validate=True` on this scene (`world4_job`)."""
    setup, want = worlds["port"][44]
    config = worlds["scenes"][44][1]
    results = [res[44] for res in worlds["w4"]]
    assert results[0]["flags"] == ["sharded", "sharded", "sharded", "single"]
    for res in results:
        mesh = DistMesh(tuple(res["mesh"]), res["rank"], CPU, "gloo")
        share = sharding.shard_setup(setup, mesh, config)
        pairs = list(zip(share.problem.hier.levels, res["levels"])) + [(share.problem.fine, res["fine"])]
        for level, (c, got) in enumerate(pairs):
            for f in c._fields:
                np.testing.assert_array_equal(got[f], dryrun._numpy(getattr(c, f)), err_msg=f"[{level}] {f}")
        for k in ("coarse_dofs", "coarse_minv", "coarse_chol"):
            np.testing.assert_array_equal(res["coarse"][k], getattr(share.problem.hier, k).numpy())
        np.testing.assert_array_equal(res["base"]["material"], share.material.numpy())
        np.testing.assert_array_equal(res["base"]["liquid_phi"], share.liquid_phi.numpy())
        for a in range(3):
            np.testing.assert_array_equal(res["base"]["weights"][a], share.weights[a].numpy())
        assert res["iterations"] == want.cg.iterations and res["converged"]
        np.testing.assert_allclose(res["pressure"], want.pressure.numpy(), rtol=0, atol=1e-12)
        for a in range(3):
            np.testing.assert_allclose(res["velocity"][a], want.velocity[a].numpy(), rtol=0, atol=1e-12)


def test_mm_transfers_across_ranks_match_single_process(worlds):
    """The matrix-form transfers on the ranks' blocks with their one-cell
    margins: the 44^3 projection on (2, 2, 1) (L0-L2 sharded: restriction
    between sharded levels through the halos and into the whole coarsest
    level through the gather, prolongation from a halo and from a slice of
    the whole level) and the 32^3 sine solve on (2, 1, 1) (L0 sharded):
    iterations equal to the single process with transfer_mode="mm", the
    pressure (x) within 1e-10."""
    want = worlds["port"]["44mm"][1]
    for res in (r["44mm"] for r in worlds["w4"]):
        assert res["flags"] == ["sharded", "sharded", "sharded", "single"]
        assert res["converged"] and res["iterations"] == want.cg.iterations
        np.testing.assert_allclose(res["pressure"], want.pressure.numpy(), rtol=0, atol=1e-10)
    single = worlds["single"]["sine32_mm"]
    x = np.zeros(worlds["problems"]["sine32"][0].shape)
    for res in (r["sine32_mm"] for r in worlds["w2"]):
        assert res["flags"][0] == "sharded"
        assert res["converged"] and res["iterations"] == single.iterations
        x[res["slices"]] = res["x"]
    np.testing.assert_allclose(x, single.x.numpy(), rtol=0, atol=1e-10)


@pytest.mark.parametrize("n", [40, 44])
def test_partitioned_setup_holds_no_whole_grid(worlds, n):
    """After `build_setup(mesh=)` no tensor of a rank's setup spans the whole
    base or window grid on an axis the mesh splits (JAX
    `test_sharded_setup_fine_level_is_partitioned`): the base fields are
    the rank's blocks (a face array whole only along its own axis), the
    window's levels and fine operator its blocks of a quarter of the
    cells."""
    scene = worlds["scenes"][n][0]
    base = tuple(scene["phi"].shape)
    for res in (r[n] for r in worlds["w4"]):
        window = tuple(res["expanded_shape"])
        mesh = DistMesh(tuple(res["mesh"]), res["rank"], CPU, "gloo")
        split_b, split_w = grid_split(mesh, base), grid_split(mesh, window)
        assert any(split_b) and any(split_w) and res["flags"][0] == "sharded"
        for path, shape in res["setup_shapes"].items():
            if len(shape) != 3:
                continue
            for a in range(3):
                faces = [face_shape(base, f)[a] for f in range(3) if f != a]
                if split_b[a]:
                    assert shape[a] not in [base[a]] + faces, (path, shape)
                if split_w[a]:
                    assert shape[a] != window[a], (path, shape)
        fine = res["setup_shapes"]["setup.problem.fine.diag"]
        assert np.prod(fine) * mesh.size == np.prod(window)


@pytest.mark.parametrize("n", [32, 40, "solid"])
def test_four_rank_audit_matches_jax(worlds, n):
    """The divergence audit over the ranks' cells (max by `ordered_max`,
    the sum and the liquid count by `ordered_sum`) against JAX's single
    device, and the same on every rank."""
    want = worlds["splash"][n][1]
    results = [res[n] for res in worlds["w4"]]
    for key, tol in (("max_divergence", 1e-11), ("accumulated_divergence", 1e-11), ("avg_divergence", 1e-14)):
        assert len({res[key] for res in results}) == 1, key
        assert abs(results[0][key] - float(getattr(want, key))) <= tol, (key, results[0][key], float(getattr(want, key)))


def test_solid_scene_reads_across_block_edges(worlds):
    """The solid scene is a base-halo case on (2, 2, 1): liquid-air faces lie
    on both block-edge planes (theta reads the neighbour block's SDF) and
    trimming a block alone keeps other Dirichlet cells than trimming the
    whole grid (the rings reach across the edge), so the bit-identical
    blocks above rest on the partitioned build's base halo."""
    scene, config = worlds["scenes"]["solid"]
    t = torch.from_numpy
    material, mg_labels, trimmed, _ = free_surface.base_label_fields(
        t(scene["phi"]), tuple(t(w) for w in scene["weights"]), t(scene["solid_phi"]), config.theta_clamp,
        torch.float64, config.dirichlet_band,
    )
    liquid, air = int(MaterialLabel.LIQUID), int(MaterialLabel.AIR)
    for axis in (0, 1):
        lo, hi = material.narrow(axis, 19, 1), material.narrow(axis, 20, 1)
        assert bool((((lo == liquid) & (hi == air)) | ((lo == air) & (hi == liquid))).any()), axis
    changed = 0
    for r in range(4):
        idx = local_slices((2, 2, 1), trimmed.shape, r, (True, True, False))
        changed += int((domain.trim_far_dirichlet(mg_labels[idx], config.dirichlet_band) != trimmed[idx]).sum())
    assert changed > 0
    assert int(((t(scene["solid_phi"]) >= 0) & (material == liquid)).sum()) > 0
    assert int((trimmed == int(CellLabel.DIRICHLET)).sum()) > 0


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
