"""Run a world of ranks on one machine (counterpart of the JAX package's
``benchmarks/multihost_dryrun.py``).

    python -m geometricmultigridpressuresolver_tpu_torch.parallel.dryrun \\
        --world-size 4 --backend gloo --device cpu --n 32 [--bench]

`launch` spawns `world_size` rank processes with the **spawn** start method
(never fork: a forked CUDA context is unusable), starts their process
group through a ``file://`` init method in a temporary directory (so
concurrent launches never race for a TCP port), runs one job in every
rank and joins them all within a timeout.  A rank that raises, exits
non-zero or outlives the timeout makes `launch` raise (the others are
terminated); the command line then exits non-zero.  A job is named
``"module:function"`` and called as ``function(mesh, **kwargs)`` in each
rank with its `DistMesh`; it is imported in the rank after ``jax`` is
blocked (``sys.modules["jax"] = None``), so the rank runs no JAX.  Each
rank's return value comes back through a file it writes with torch.save.

`device="cuda"` puts rank r on ``cuda:{r % device_count}``: with one card
every rank shares it.  The parent builds the kernels before spawning, so
the ranks load the built library instead of each running nvcc.

`project_job` is the dryrun itself: the splash scene at n^3 through
`free_surface.build_setup(mesh=)` and `project(mesh=)` (with `bench`, in
``bench.py``'s configuration: fp32 solve and V-cycle, bf16 edge weights,
tol 1e-5, at most 200 iterations); each rank prints one JSON line with its
rank, iterations, relative residual, local DOFs, the milliseconds its
halo exchanges took and the bytes it staged through host memory.
Each rank builds and projects from its own blocks of the inputs, and the
results stay its blocks (gathered only for `fields`).  `solve_job` solves
a given labelled domain (`mgpcg.build_problem(mesh=)`).
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import sys
import tempfile
import time
import traceback
from pathlib import Path

import torch


def _rank_main(rank: int, world_size: int, init_method: str, backend: str, device: str,
               job: str, kwargs: dict, out_dir: str, timeout_s: float) -> None:
    sys.modules["jax"] = None  # any `import jax` in this rank now raises
    out = Path(out_dir)
    try:
        import datetime

        from geometricmultigridpressuresolver_tpu_torch.parallel import distributed

        dev = torch.device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", rank % torch.cuda.device_count())
        if dev.type == "cpu":
            torch.set_num_threads(1)
        os.environ["LOCAL_RANK"] = str(dev.index or 0)
        mesh = distributed.initialize(
            backend, init_method, world_size, rank, dev, datetime.timedelta(seconds=timeout_s)
        )
        module, name = job.split(":")
        result = getattr(importlib.import_module(module), name)(mesh, **kwargs)
        if any(
            m == "jax" or m.startswith(("jax.", "geometricmultigridpressuresolver_tpu."))
            for m, mod in sys.modules.items() if mod is not None
        ):
            raise RuntimeError("a rank imported JAX or the JAX package")
        torch.save(result, out / f"rank{rank}.pt")
        distributed.dist.destroy_process_group()
    except BaseException:
        # The launcher reports the traceback; exit non-zero without
        # multiprocessing printing it once more.
        (out / f"rank{rank}.err").write_text(traceback.format_exc())
        raise SystemExit(1) from None


def launch(job: str, world_size: int, backend: str, device: str, kwargs: dict | None = None,
           timeout: float = 600.0) -> list:
    """Run `job` in `world_size` spawned ranks; their results in rank order.
    Raises if a rank fails or does not finish within `timeout` seconds."""
    import multiprocessing

    if torch.device(device).type == "cuda":
        from geometricmultigridpressuresolver_tpu_torch.ops import _cuda

        _cuda.library()  # build once here, not once per rank
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="gmg_dryrun_") as tmp:
        init = f"file://{tmp}/init"
        procs = [
            ctx.Process(
                target=_rank_main,
                args=(r, world_size, init, backend, device, job, kwargs or {}, tmp, timeout),
                name=f"rank{r}",
            )
            for r in range(world_size)
        ]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        try:
            for p in procs:
                p.join(max(deadline - time.monotonic(), 0.0))
        finally:
            hung = [p.name for p in procs if p.is_alive()]
            for p in procs:
                if p.is_alive():
                    p.terminate()
                    p.join(10)
                    if p.is_alive():
                        p.kill()
                        p.join()
        errors = [
            f"{p.name} exited {p.exitcode}:\n" + (
                (Path(tmp) / f"{p.name}.err").read_text() if (Path(tmp) / f"{p.name}.err").exists() else ""
            )
            for p in procs if p.exitcode != 0 and p.name not in hung
        ]
        if hung or errors:
            raise RuntimeError(
                f"dryrun {job} on {world_size} ranks: "
                + (f"{', '.join(hung)} did not finish within {timeout:.0f} s; " if hung else "")
                + "\n".join(errors)
            )
        return [torch.load(Path(tmp) / f"rank{r}.pt", weights_only=False) for r in range(world_size)]


def bench_config():
    """``bench.py:94-128``'s configuration of the port's solver."""
    from geometricmultigridpressuresolver_tpu_torch.config import SolverConfig

    return SolverConfig(
        solve_dtype=torch.float32, mg_dtype=torch.float32, mg_ew_dtype=torch.bfloat16,
        tolerance=1e-5, max_iterations=200,
    )


def _numpy(t: torch.Tensor):
    """A tensor as numpy (bfloat16, which numpy lacks, widened to float32:
    exact)."""
    return (t.float() if t.dtype == torch.bfloat16 else t).cpu().numpy()


def _sync(mesh) -> None:
    if mesh.device.type == "cuda":
        torch.cuda.synchronize(mesh.device)


def project_job(mesh, n: int = 32, bench: bool = False, tolerance: float = 1e-7,
                fields: bool = False, print_line: bool = True, scene=None, config=None) -> dict:
    """The rank side of the dryrun: the n^3 splash built with
    `build_setup(mesh=)` and projected with `project(mesh=)`, both from
    this rank's blocks of the inputs (`distributed.make_global_grid` /
    `make_global_faces`).  `scene` (a mapping of whole arrays: ``phi``,
    ``velocity``, ``weights`` and optionally ``solid_phi``,
    ``solid_velocity``, ``old_pressure``) replaces the port's splash scene;
    `config` (a `SolverConfig`) replaces `tolerance` and `bench`.  Returns
    the JSON line's numbers (and, with `fields`, the rank's blocks of the
    problem, the shape of every tensor of its setup, the pressure and the
    velocity gathered whole, as numpy arrays)."""
    from geometricmultigridpressuresolver_tpu_torch.config import SolverConfig
    from geometricmultigridpressuresolver_tpu_torch.grids import face_shape
    from geometricmultigridpressuresolver_tpu_torch.models import free_surface, sdf
    from geometricmultigridpressuresolver_tpu_torch.parallel import distributed
    from geometricmultigridpressuresolver_tpu_torch.parallel.mesh import face_split, grid_split
    from geometricmultigridpressuresolver_tpu_torch.solver import mg

    if config is None:
        config = bench_config() if bench else SolverConfig(tolerance=tolerance)
    dtype = config.solve_dtype
    if scene is None:
        phi, velocity = sdf.splash_scene((n, n, n), device=mesh.device, dtype=dtype)
        scene = dict(phi=phi, velocity=velocity,
                     weights=sdf.open_box_weights((n, n, n), device=mesh.device, dtype=dtype))
    base = tuple(scene["phi"].shape)
    split = grid_split(mesh, base)
    blocks = dict(
        phi=distributed.make_global_grid(base, scene["phi"], mesh, split, dtype),
        weights=distributed.make_global_faces(base, scene["weights"], mesh, dtype),
        velocity=distributed.make_global_faces(base, scene["velocity"], mesh, dtype),
    )
    for key in ("solid_phi", "old_pressure"):
        if scene.get(key) is not None:
            blocks[key] = distributed.make_global_grid(base, scene[key], mesh, split, dtype)
    if scene.get("solid_velocity") is not None:
        blocks["solid_velocity"] = distributed.make_global_faces(base, scene["solid_velocity"], mesh, dtype)
    del scene
    _sync(mesh)
    t0 = time.perf_counter()
    setup = free_surface.build_setup(blocks["phi"], blocks["weights"], blocks.get("solid_phi"), config=config,
                                     mesh=mesh, base_shape=base)
    _sync(mesh)
    setup_s = time.perf_counter() - t0
    mesh.stats.reset()
    t0 = time.perf_counter()
    result = free_surface.project(setup, blocks["velocity"], blocks.get("solid_velocity"),
                                  blocks.get("old_pressure"), config=config, mesh=mesh)
    _sync(mesh)
    seconds = time.perf_counter() - t0
    hier = setup.problem.hier
    out = {
        "rank": mesh.rank,
        "coords": list(mesh.coords),
        "mesh": list(mesh.shape),
        "backend": mesh.backend,
        "device": str(mesh.device),
        "iterations": result.cg.iterations,
        "converged": result.cg.converged,
        "relative_residual": result.cg.relative_residual,
        "recomputed_residual": float(result.residual_rel_l2),
        "max_divergence": float(result.max_divergence),
        "avg_divergence": float(result.avg_divergence),
        "accumulated_divergence": float(result.accumulated_divergence),
        "local_dofs": distributed.host_local_dofs(setup.problem.fine.solvable, mesh, setup.expanded_shape),
        "flags": list(mg.level_flags(hier, config, mesh)),
        "halo_ms": mesh.stats.exchange_s * 1e3,
        "exchanges": mesh.stats.exchanges,
        "redistributes": mesh.stats.redistributes,
        "staged_bytes": mesh.stats.bytes_staged,
        "setup_s": setup_s,
        "project_s": seconds,
    }
    if print_line:
        # One write of the whole line: the ranks share the launcher's
        # stdout, and print's separate write of the newline (unbuffered
        # streams) lets another rank's line land between the two.
        sys.stdout.write(json.dumps(out) + "\n")
        sys.stdout.flush()
    if fields:
        out["levels"] = [{f: _numpy(getattr(c, f)) for f in c._fields} for c in hier.levels]
        out["fine"] = {f: _numpy(getattr(setup.problem.fine, f)) for f in setup.problem.fine._fields}
        out["coarse"] = {k: _numpy(getattr(hier, k)) for k in ("coarse_dofs", "coarse_minv", "coarse_chol")}
        out["shapes"] = [list(s) for s in hier.shapes]
        out["expanded_shape"] = list(setup.expanded_shape)
        out["window_start"] = list(setup.window_start)
        out["setup_shapes"] = {path: tuple(t.shape) for path, t in named_tensors(setup)}
        out["base"] = {"material": _numpy(setup.material), "liquid_phi": _numpy(setup.liquid_phi),
                       "weights": [_numpy(w) for w in setup.weights]}
        out["pressure"] = distributed.gather_blocks(result.pressure, mesh, base, split).cpu().numpy()
        out["velocity"] = [
            distributed.gather_blocks(v, mesh, face_shape(base, a), face_split(mesh.shape, base, a)).cpu().numpy()
            for a, v in enumerate(result.velocity)
        ]
    return out


def named_tensors(tree, path: str = "setup"):
    """(path, tensor) for every tensor in a (nested) tuple of tensors, such
    as a `ProjectionSetup`."""
    if isinstance(tree, torch.Tensor):
        yield path, tree
    elif isinstance(tree, tuple):
        for name, item in zip(getattr(tree, "_fields", None) or range(len(tree)), tree):
            yield from named_tensors(item, f"{path}.{name}")


def solve_job(mesh, labels, weights, mg_levels: int, rhs, config_kwargs: dict | None = None,
              x0=None, interrupt_at: int | None = None) -> dict:
    """Solve A x = rhs on a labelled domain across the ranks:
    `mgpcg.build_problem(mesh=)` and `mgpcg.solve(mesh=)` from numpy inputs
    that every rank holds whole (`x0` a warm start; `interrupt_at` an
    iteration at which rank 0's `interrupt_check` says stop).  Returns the
    rank's block of x with its slices, the iterations and residual, the
    local DOFs and the launch counts of the kernels the solve ran."""
    from geometricmultigridpressuresolver_tpu_torch.config import SolverConfig
    from geometricmultigridpressuresolver_tpu_torch.ops import fused_cg, fused_smoother
    from geometricmultigridpressuresolver_tpu_torch.parallel import distributed, halo
    from geometricmultigridpressuresolver_tpu_torch.parallel.mesh import local_slices
    from geometricmultigridpressuresolver_tpu_torch.solver import mg, mgpcg

    config = SolverConfig(**(config_kwargs or {}))
    problem = mgpcg.build_problem(labels, weights, mg_levels, config, mesh=mesh)
    layout = mgpcg.fine_layout(problem, config, mesh)
    dev = mesh.device
    rhs_t = torch.as_tensor(rhs, dtype=config.solve_dtype, device=dev)
    x0_t = None if x0 is None else torch.as_tensor(x0, dtype=config.solve_dtype, device=dev)
    check = None if interrupt_at is None else (lambda it: it >= interrupt_at)
    counters = (fused_smoother.PASS_LAUNCHES, fused_smoother.SHARDED_LAUNCHES, fused_cg.STEP_LAUNCHES,
                fused_cg.SHARDED_STEP_LAUNCHES, fused_cg.RESIDUAL_LAUNCHES, halo.HALO_LAUNCHES)
    for c in counters:
        c.reset()
    mesh.stats.reset()
    result = mgpcg.solve(problem, rhs_t, x0_t, config, mesh=mesh, interrupt_check=check)
    return {
        "rank": mesh.rank,
        "x": result.x.cpu().numpy(),
        "slices": local_slices(mesh.shape, layout.shape, mesh.rank, layout.split),
        "iterations": result.iterations,
        "converged": result.converged,
        "relative_residual": result.relative_residual,
        "local_dofs": distributed.host_local_dofs(problem.fine.solvable, mesh, layout.shape),
        "flags": list(mg.level_flags(problem.hier, config, mesh)),
        "launches": {c.name: c.count for c in counters},
        "exchanges": mesh.stats.exchanges,
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--world-size", type=int, required=True)
    parser.add_argument("--backend", choices=("nccl", "gloo"), required=True)
    parser.add_argument("--device", choices=("cuda", "cpu"), required=True)
    parser.add_argument("--n", type=int, default=32, help="splash scene size (default 32)")
    parser.add_argument("--bench", action="store_true", help="bench.py's solver configuration")
    parser.add_argument("--timeout", type=float, default=600.0, help="seconds for the whole world")
    args = parser.parse_args(argv)
    results = launch(
        "geometricmultigridpressuresolver_tpu_torch.parallel.dryrun:project_job", args.world_size, args.backend, args.device,
        dict(n=args.n, bench=args.bench), timeout=args.timeout,
    )
    iterations = {r["iterations"] for r in results}
    if len(iterations) != 1 or not all(r["converged"] for r in results):
        print(f"dryrun: ranks disagree or did not converge: {results}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
