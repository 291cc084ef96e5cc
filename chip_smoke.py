"""Drive the PyTorch/CUDA port once on one NVIDIA GPU and check it.

    python3 chip_smoke.py            # the 256^3 bench configuration
    python3 chip_smoke.py --n 40     # a quick check after a kernel edit (its
                                     # 48^3 window still splits for phase 8)

Phases (any failure exits non-zero and prints no result line):
  1. require CUDA; print the card (nvidia-smi) and the torch / CUDA versions;
  2. build the CUDA kernels from csrc/ (nvcc) and print the build time;
  3. main path at 256^3 in the bench configuration (solve fp32, V-cycle
     fp32 with bf16 edge weights, band-restricted boundary passes
     (pallas_band_strip=128, the default), tol 1e-5, 200 iterations): the
     port's splash_scene -> build_setup -> project, with every kernel launch
     counter reset just before and read just after (each kernel adds one to
     its counter on the device as it starts, so a launch from the replayed
     CUDA graph counts where it runs); the counts must equal
     what the hierarchy, the chunk plan and the iteration count imply; per
     smoothed level the chunk kernel's depth, tile and active tiles;
  4. each kernel against its plain PyTorch version on random inputs (a
     seeded torch.Generator) on the levels of that hierarchy, with bf16 and
     fp32 edge weights: the chunk kernel's blocks (downstroke with zero
     start and residual, upstroke with and without the dot, warm, Jacobi)
     in the full-grid and band-restricted configurations, a lone `b` pass,
     the bf16-field blocks, the CG step and the residual over the level's
     active tiles (twice: bit-equal; the residual also with bf16 storage);
     each kernel's time beside the plain version's at the fine-level shape,
     the fine upstroke block, the CG step and the residual beside their
     earlier times, the block's host time per call, and the block at chunk
     depths 2, 4 and 8;
  5. the best of 3 solve times (mgpcg.solve, as bench.py times the JAX
     package), in turns: with the kernels, with kernel_mode="torch", with
     full-grid boundary passes (pallas_band_strip=0) and with bf16 fields
     (mg_field_dtype=bfloat16); the projections compared; a bf16-field
     projection with exact launch counts; one warm solve under
     torch.profiler: device time by kernel, the device's busy share, the
     host ops' time, and the sum_partials launches (one per V-cycle: the
     CG step sums its own dot);
  6. a small fp64 projection on the card checked against a direct sparse
     solve of the assembled system, and the fp64 chunk kernel, CG step and
     residual against their plain versions on that hierarchy's smoothed
     levels; the same projection with the Chebyshev smoother (degree 3),
     which launches no chunk kernel and one CG step per iteration;
  7. the frame loop: simulate.run, 4 frames at 256^3 in the CLI's --fp32
     configuration with a checkpoint every 2 frames, launch counts exact
     over the whole run; per frame the iterations, residual, divergence,
     stage seconds and window reuse; frames 1-2 repeated with
     kernel_mode="torch" and compared; the frame-2 checkpoint loaded and
     frames 3-4 resumed from it (phi bit-equal at frame 3), with the write
     and read seconds and the bytes on disk against the raw bytes;
  8. the block-sharded path on a one-card block mesh (parallel.make_mesh(4),
     (2, 2, 1)): the per-level flags and stacked sizes; project(...,
     mesh=) with exact launch counts (block-mesh passes, halo gathers and
     scatters, block-mesh CG steps, and the single-device levels' kernels)
     and its pressure against phase 3's; the halo kernels, the block-mesh
     smoother and CG step against their plain versions and the
     single-device kernels at every sharded level; their times beside
     their bounds (and the F.pad + unfold gather as the library call), the
     block-mesh CG step split into its gathers, step and scatters; the
     best of 3 solves, single device and block mesh in turns;
  9. the fused frame loop: simulate.run_fused, 4 frames in one chunk of 4
     at 256^3 in phase 7's configuration, launch counts exact, iterations
     and fields against phase 7's run(); seconds per frame of run() and
     run_fused in turns, twice; the host syncs per frame of each path
     (torch.cuda.set_sync_debug_mode); at frame 1's geometry run_fused's
     coarse system (coarse_system_device) against the host path
     (coarse_system), the two timed, and the setup's own coarse inverse
     (coarse_system_card) bit-equal to run_fused's;
 10. the reference's test node (diagnostics.py) at its scene's gridSize
     128 (a 256^3 window, 6 levels, fp64), launch counts exact in each
     block: the CG block against the host's assembled-matrix oracle, again
     with kernel_mode="torch" and with dx = 1/128, and its solve held
     against the plain path; the fp64 chunk kernel, CG step and residual
     at the node's fine window against their plain versions, timed; 50
     warm-started V-cycles (a residual launch each) against the plain
     path; the smoother block against the plain path, with its phase
     times; the symmetry block at 32; utils.profiling.instrumented_solve on
     phase 3's problem (x bit-equal to mgpcg.solve's, the same launches)
     and vcycle_stage_times by level; the assembled baseline
     (project_assembled) against project on the 128^3 splash; the
     diagnostics CLI in a process of its own.  Phase 5's profile goes
     through utils.profiling.trace.
 11. the mesh of ranks (parallel.distributed, parallel.dryrun.launch: spawned
     processes, a file:// rendezvous), every rank on this one card -- a
     rehearsal of the multi-card path: [11a] NCCL, a world of one rank,
     the 64^3 splash in the bench configuration against a single-process
     projection of the same scene; [11b] four ranks on a (2, 2, 1) mesh,
     gloo with the CUDA tensors staged through pinned host memory: each
     rank makes the scene, keeps its base blocks and frees the rest, then
     runs the partitioned build_setup(mesh=) and project(mesh=), checking
     every field of its setup against phase 3's setup cut to its blocks
     (sha256 of the bytes), its launch and halo-exchange counts against
     the plan, its chunk-kernel blocks and CG step on its haloed blocks
     against their plain versions, printing the peak device memory of the
     build (at most half of phase 3's) and of the projection apart, and
     timing the best of 3 solves with each one's exchanges, staged bytes,
     exchange and compute milliseconds; the gathered pressure against
     phases 3 and 8 and the local DOFs against the total; [11c] two ranks
     on (2, 1, 1), fp64, the 32^3 fractional sine fixture from a warm
     start against the single process; [11d] the dryrun launcher's command
     line in a process of its own; [11e] the bench splash at twice the
     size (512^3): one single-process build and projection (its peak
     memory, DOFs, iterations), then four gloo ranks through the
     partitioned build and one projection each (setup and project seconds,
     peak memory, exchanges, box moves, staged bytes per rank), held to
     1e-5, the single process's iterations +-1, its pressure within 1e-3
     and its DOF count; [11f] run() at 512^3 through the program cache
     and with it off (phase 16 says what it checks).
 12. the transfers (config.transfer_mode; every earlier phase runs "auto",
     which is the matrix form on the card): [12a] each transfer at each
     level of the bench hierarchy in both forms, timed (CUDA events over
     20 calls) with its device launches per call; the matrix form against
     the slice form in fp32 (within 1e-6 relative, again with TF32
     switched on here: the products stay IEEE) and fp64 (1e-13), in bf16
     within one bf16 ulp of the same products accumulated exactly and
     rounded where the form rounds; each product's GFLOP/s beside its
     bytes and operations bounds; [12b] the 256^3 projection in both forms
     (iterations +-1, pressure within 1e-3, kernel launches exact), solves
     in turns (best wall, ms between CUDA events), one profiled solve each
     (device launches by kind, host ops by calls, the host's launch
     calls), and whether this run's faster form is the one "auto" takes;
     [12c] vcycle_stage_times in both forms; [12d] the 512^3 splash in both
     forms on one setup (iterations +-1, pressure within 1e-3, seconds,
     peak memory); [12e] run_fused's 4 frames in both forms (seconds and
     host syncs per frame).  Phase 8 also times one core scatter beside its
     bounds.
 13. the coarsest level factored on the card (fp32 on the card: an inverse
     up to 4096 bucketed DOFs, a Cholesky factor above, every setup path):
     [13a] on the bench hierarchy, _finish_hierarchy's card path against
     the host path (coarse_system, fp64 numpy) in turns, best of 3, with
     their host syncs (the card path: exactly one), the card inverse
     against the host's fp64 inverse rounded to fp32 (and coarse_solve of
     a random vector), two card builds and phase 3's setup bit-equal;
     [13b] the bench scene capped where the coarsest bucket lies in
     (4096, 16384]: the Cholesky branch taken, its info read off the hot
     path, the factor against np.linalg.cholesky in fp64, coarse_solve and
     the projection against the host factor's (iterations +-1, pressure
     1e-3); [13c] the 256^3 and 512^3 projections against the same setups
     with the host path's inverse swapped in; [13d] run() over phase 7's
     frames, from phase 9's runs in turns with run_fused: seconds per frame
     by stage and host syncs per frame.
 14. the CG loop as a captured CUDA graph (solver/graph.py; every earlier
     phase already ran every single-process solve through it) against the
     eager loop (`eager_cg_loop`): [14a] the bench projection with residual
     histories, graph and eager: iterations, pressure and history bit-equal,
     launch counts exact and equal, one capture, host syncs per solve at
     most ceil(iterations / K) + 3; [14b] the splash at n/4, n/2, n and 2n
     (64^3-512^3 at the default), graph and eager in turns, best of 3: wall
     and CUDA-event ms, x bit-equal, host syncs, capture and instantiate
     ms, graph launches and reads, peak device memory, one profiled solve
     each (device ms, the port's kernels by name beside the device launch
     counters, the host's launch calls by API; at n/4 also under a profiler
     schedule, with the device events it lacks), and after the largest
     size and the smallest, reserved memory before and after empty_cache
     with no capture pool left holding memory; [14c] the K sweep
     (1, 4, 8, 16) at n and n/4; [14d] captures per solve through every
     single-process entry point (solve, project, the block mesh, the plain
     path, Chebyshev, run(), run_fused); [14e] run() and run_fused seconds
     per frame, graph against eager in turns, and host syncs per frame.
 15. the fused frame chunk as one captured CUDA graph per frozen geometry
     (simulate.run_fused on the card: graph.FrameGraph, the CG loop a WHILE
     node; every earlier run_fused call already ran it): 8 frames in
     chunks of 4 at 256^3 in the bench configuration, [15a] against the
     same frames run eagerly (graph.EmulatedFrame): iterations equal,
     fields bit-equal, device launch counts equal, one frame capture, one
     launch per frame, one host read per chunk, capture and instantiate
     ms, peak memory and the frame pool; [15b] no host sync inside a frame
     launch (sync debug mode "error") and the call's syncs by source line;
     [15c] against run() (iterations +-1, pressure 1e-3); [15d] seconds
     per frame graph and eager in turns, and a chunk's launches alone (CUDA
     events, host issue time); [15e] advection's device ms.
 16. setup, solve and projection as programs captured once per key and
     replayed (solver/graph.py PROGRAMS; every phase but 14 and 15, which
     measure the per-solve loop graph and the frame graph with the cache
     off, ran through it) at
     the bench configuration, against the cache off (the setup eager, each
     solve's CG loop captured anew): [16a] run() for 8 frames with the
     sticky window in turns (on, off, off, on): captures per window key and
     replays, a second run capturing nothing, iterations equal and every
     frame's fields bit-equal, host syncs per frame, seconds per frame by
     stage, the programs' copies in and out (bytes, CUDA-event ms); [16b]
     mgpcg.solve 5 times on one problem at 64^3 and n^3: one capture, x
     bit-equal across the repeats and to the cache off, wall and CUDA-event
     ms per solve; [16c] setup_fusion "fused" against "per-level" at n^3
     (bit-equal setups, setup seconds, graphs per setup program, pools:
     per-level's one pool at most 1.25x fused's), and at 448^3 what
     "auto" picks and that the build completes, with either granularity,
     then the setup and projection again cached and off in turns: no
     capture (each program replays or is not kept, Programs.get) and the
     cached pair within 10% of the off pair; [16d] a drop moved inside a
     kept window: no new capture, setup and projection bit-equal to a
     fresh build with the cache off; and [11f] (in phase 11, where the
     process holds least) run() at 512^3 for 3 frames, cached and off in
     turns: no capture in the last cached run, frames bit-equal, the
     cached run within 10% of the off run.
Every kernel's entry in the kernels JSON has its launches on its path (and
on phase 10's blocks, `launches_test_node`, and per rank of [11b],
`launches_distributed`), its
error against the plain version, its time, the plain version's, its bound
(bytes over 3.35 TB/s or float32 operations over 67 TFLOP/s, the larger)
for the work this run's data needs -- inputs read on the solvable cells
(`bound_ms`, also `bound_active_ms`) -- and over the whole window
(`bound_window_ms`), and the library call's time where one PyTorch call
computes the same thing.
The last lines are the transfers JSON (phase 12a's rows), the kernels
JSON, the nvidia-smi line, and {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import gc
import json
import re
import shutil
import subprocess
import sys
import tempfile
import time
import warnings
from pathlib import Path


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def require(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    require(bool(out), "nvidia-smi printed nothing")
    return out[0].strip()


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call of `fn` over `reps` calls, CUDA events."""
    import torch

    fn()
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def count_syncs(fn):
    """(fn's result, Counter of the host syncs it made by source line), as
    torch.cuda.set_sync_debug_mode reports them (every implicit sync: an
    .item(), a copy to the host, a nonzero; explicit synchronize calls are
    not counted)."""
    import torch

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    sites = collections.Counter(
        f"{w.filename.split('geometricmultigridpressuresolver_tpu_torch/')[-1]}:{w.lineno}"
        for w in caught if "called a synchronizing" in str(w.message)
    )
    return out, sites


def rel_err(got, want) -> tuple[float, float]:
    """(max |got - want|, that divided by max |want|)."""
    diff = float((got.double() - want.double()).abs().max())
    scale = float(want.double().abs().max())
    return diff, diff / max(scale, 1e-300)


def bf16_ulp(scale: float) -> float:
    """One bfloat16 ulp at magnitude `scale` (8 significant bits)."""
    import math

    return 2.0 ** (math.floor(math.log2(scale)) - 7) if scale > 0 else 0.0


def expected_launches(hier, config, iters: int, warm: bool = False, mesh=None) -> dict:
    """Kernel launches of one projection (project: solve + the recomputed
    residual) with `iters` CG iterations: every V-cycle (iters + 1) runs a
    downstroke (from x = 0, with the residual) and an upstroke block per
    smoothed level, each one chunk-kernel launch per `chunk_plan` chunk at
    the level's depth.  A warm start adds the initial residual.

    With a block `mesh`, a level that `mg.level_flags` calls "sharded" runs
    over its stacked haloed blocks in chunks of at most H passes, each its
    own chunk plan at the stacked tiles' depth: per block, one gather of b,
    one of x per H-chunk (none for the downstroke's zero start), one
    scatter of x per H-chunk and one of the fused residual; a downstroke
    whose residual does not fit H launches the residual kernel after it.  A
    sharded fine level runs the CG step there too (two gathers and two
    scatters per step), and each solve gathers the constant coefficients
    once (six arrays per sharded level, four for the CG operator)."""
    import torch

    from geometricmultigridpressuresolver_tpu_torch.ops import fused_smoother
    from geometricmultigridpressuresolver_tpu_torch.parallel import halo
    from geometricmultigridpressuresolver_tpu_torch.parallel.mesh import DistMesh
    from geometricmultigridpressuresolver_tpu_torch.solver import mg

    flags = mg.level_flags(hier, config, mesh)
    narrow = mg.field_dtype(hier, config) == torch.bfloat16
    nlev = hier.num_levels
    depth = fused_smoother.CHUNK_DEPTH  # every solve's tiles (level_tiles' default)
    single = sharded = gathers = unfused = 0
    for level in mg.smoothed_levels(hier):
        strokes = (True, False) if nlev > 1 else (True,)
        for forward in strokes:
            n = len(fused_smoother.schedule_for(config, forward))
            down = forward and nlev > 1
            residual = down and (flags[level] == "single" or fused_smoother.residual_fusable(config, True))
            unfused += down and not residual
            if flags[level] == "sharded":
                outer = fused_smoother.chunk_plan(n, halo.H, forward, residual)
                sharded += sum(len(fused_smoother.chunk_plan(ch.stop - ch.start, depth)) for ch in outer)
                gathers += 1 + sum(not ch.zero for ch in outer) + len(outer) + int(residual)
            else:
                single += len(fused_smoother.chunk_plan(n, depth))
    cycles = iters + 1
    fine_sharded = flags[0] == "sharded"
    once = 6 * sum(flags[lv] == "sharded" for lv in mg.smoothed_levels(hier)) + 4 * fine_sharded
    return {
        "smoother": 0 if narrow else single * cycles,
        "smoother_bf16": single * cycles if narrow else 0,
        "residual": unfused * cycles + 1 + int(warm),
        "cg_step": 0 if fine_sharded else iters,
        "smoother_sharded": sharded * cycles,
        "cg_step_sharded": iters if fine_sharded else 0,
        # Across ranks no halo kernel runs: blocks travel by exchange.
        "halo": 0 if isinstance(mesh, DistMesh) else gathers * cycles + 4 * iters * fine_sharded + once,
    }


def expected_exchanges(hier, config, iters: int, mesh, project: bool = True, warm: bool = False) -> int:
    """Halo exchanges one rank of `mesh` (a `DistMesh`) makes in one
    projection (`project`: the solve and the recomputed residual) or one
    `mgpcg.solve`.  Once per solve: six coefficient arrays per sharded
    level and the CG operator's four.  Per V-cycle and sharded level: on
    the way down b, then x before every H-chunk but a zero-start one (and
    x and b for an unfused residual), the restricted residual's one-cell
    halo; on the way up the coarse correction's one-cell halo when the
    level below is sharded too, then b and x before every H-chunk.  Per CG
    iteration on a sharded fine level: z and p.  A warm start's residual
    and the projection's recomputed one: x and b (the latter on the
    solve's operator, whose four arrays are not exchanged again)."""
    from geometricmultigridpressuresolver_tpu_torch.ops import fused_smoother
    from geometricmultigridpressuresolver_tpu_torch.parallel import halo
    from geometricmultigridpressuresolver_tpu_torch.solver import mg

    flags = mg.level_flags(hier, config, mesh)
    sharded = [lv for lv in mg.smoothed_levels(hier) if flags[lv] == "sharded"]
    fine = flags[0] == "sharded"
    per_cycle = 0
    for lv in sharded:
        down_len = len(fused_smoother.schedule_for(config, True))
        fused = fused_smoother.residual_fusable(config, True)
        down = fused_smoother.chunk_plan(down_len, halo.H, True, fused)
        up = fused_smoother.chunk_plan(len(fused_smoother.schedule_for(config, False)), halo.H, False, False)
        per_cycle += 1 + sum(not ch.zero for ch in down) + 2 * (not fused) + 1
        per_cycle += (flags[lv + 1] == "sharded") + 1 + len(up)
    total = 6 * len(sharded) + 4 * fine + (iters + 1) * per_cycle + 2 * fine * iters
    return total + 2 * fine * warm + 2 * fine * project


def sine_fixture(n: int, seed: int = 0):
    """The parity tests' 32^3 fractional fixture (tests/helpers.py's
    `expanded_domain(sine_dirichlet_domain, n, fractional=True)`) built with
    the port's domain ops: (labels, face weights, mg levels) as numpy."""
    import numpy as np
    import torch

    from geometricmultigridpressuresolver_tpu_torch.grids import CellLabel, face_shape
    from geometricmultigridpressuresolver_tpu_torch.ops import domain

    x, y, z = np.meshgrid(*[(np.arange(n) + 0.5) / n] * 3, indexing="ij")
    phi = x - 0.5 + 0.25 * np.sin(2 * np.pi * y + 4 * np.pi * z)
    base = np.where(phi <= 0, int(CellLabel.INTERIOR), int(CellLabel.DIRICHLET)).astype(np.int8)
    expanded, _, mg_levels = domain.expand_domain(torch.from_numpy(base))
    labels = expanded.numpy()
    rng = np.random.default_rng(seed)
    weights = []
    for axis in range(3):
        w = np.zeros(face_shape(labels.shape, axis))
        lo, hi, inner = [slice(None)] * 3, [slice(None)] * 3, [slice(None)] * 3
        lo[axis], hi[axis], inner[axis] = slice(0, -1), slice(1, None), slice(1, -1)
        ext = int(CellLabel.EXTERIOR)
        w[tuple(inner)] = ((labels[tuple(lo)] != ext) & (labels[tuple(hi)] != ext)).astype(float)
        weights.append(w)
    for w in weights:
        mask = (w == 1.0) & (rng.random(w.shape) < 0.2)
        w[mask] = 0.25 + 0.75 * rng.random(w.shape)[mask]
    relabeled = domain.set_boundary_labels(expanded, [torch.from_numpy(w) for w in weights])
    return relabeled.numpy(), weights, mg_levels


def solvable_field(labels, seed: int):
    """A seeded random field, zero off the solvable cells."""
    import numpy as np

    from geometricmultigridpressuresolver_tpu_torch.grids import CellLabel

    x = np.random.default_rng(seed).standard_normal(labels.shape)
    x[labels < int(CellLabel.INTERIOR)] = 0.0
    return x


def window_levels(phi, s, cfg):
    """Setup `s`'s levels, capping flags and level labels rebuilt from the
    liquid SDF `phi` as `free_surface.build_setup` builds them (the window's
    labels, then `mg._build_levels` to the hierarchy's depth): the inputs of
    `mg._finish_hierarchy`, to time and compare the coarse solvers apart."""
    import torch

    from geometricmultigridpressuresolver_tpu_torch.models import free_surface
    from geometricmultigridpressuresolver_tpu_torch.solver import mg, mgpcg

    _, _, trimmed, mg_w, _, _ = free_surface._setup_base_fields(
        phi, s.weights, None, cfg.theta_clamp, torch.float32, cfg.dirichlet_band)
    labels, exp_w = free_surface._expand_window_fields(trimmed, mg_w, s.window_start, s.base_pads, s.expanded_shape)
    mg_dtype, fine_dtype, fine_full = mgpcg.fine_plan(cfg)
    levels, flags, label_levels, _ = mg._build_levels(
        labels, tuple(exp_w), s.problem.hier.num_levels, cfg.boundary_width, mg_dtype, cfg.mg_ew_dtype,
        fine_dtype, fine_full)
    return levels, flags, label_levels


def with_coarse(s, dofs, minv, chol):
    """Setup `s` with its hierarchy's coarse solver swapped for the given
    one (to run a projection with the host path's factor)."""
    hier = s.problem.hier._replace(coarse_dofs=dofs, coarse_minv=minv, coarse_chol=chol)
    return s._replace(problem=s.problem._replace(hier=hier))


def tensor_digests(tree) -> dict:
    """sha256 of the bytes of every tensor in a (nested) tuple of tensors,
    by path (a rank's blocks are compared by these, not shipped)."""
    import hashlib

    import torch

    from geometricmultigridpressuresolver_tpu_torch.parallel import dryrun

    return {
        path: hashlib.sha256(t.detach().contiguous().reshape(-1).view(torch.uint8).cpu().numpy().tobytes()).hexdigest()
        for path, t in dryrun.named_tensors(tree)
    }


def scene_blocks(mesh, n: int):
    """This rank's blocks of the n^3 bench splash (liquid SDF, cut-cell
    weights, velocity): the scene is made whole on the rank's device, cut
    (`make_global_grid` / `make_global_faces`) and freed, and the peak
    counter reset, so what a rank holds from here on is its blocks."""
    import torch

    from geometricmultigridpressuresolver_tpu_torch.models import sdf
    from geometricmultigridpressuresolver_tpu_torch.parallel import distributed
    from geometricmultigridpressuresolver_tpu_torch.parallel.mesh import grid_split

    dev, base = mesh.device, (n, n, n)
    phi, velocity = sdf.splash_scene(base, device=dev, dtype=torch.float32)
    weights = sdf.open_box_weights(base, device=dev, dtype=torch.float32)
    blocks = (distributed.make_global_grid(base, phi, mesh, grid_split(mesh, base)),
              distributed.make_global_faces(base, weights, mesh), distributed.make_global_faces(base, velocity, mesh))
    del phi, velocity, weights
    torch.cuda.synchronize(dev)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    return blocks


def partitioned_run(mesh, n: int):
    """Build (`build_setup(mesh=)`) and project (`project(mesh=)`) the n^3
    bench splash from this rank's blocks: (setup, result, numbers: the
    seconds and the peak device memory of each apart, the projection's
    exchanges, box moves and staged bytes), the launch counters reset just
    before the projection."""
    import dataclasses

    import torch

    from geometricmultigridpressuresolver_tpu_torch.models import free_surface
    from geometricmultigridpressuresolver_tpu_torch.ops import fused_cg, fused_smoother
    from geometricmultigridpressuresolver_tpu_torch.parallel import dryrun, halo

    dev, config = mesh.device, dryrun.bench_config()
    phi, weights, velocity = scene_blocks(mesh, n)
    t0 = time.perf_counter()
    setup = free_surface.build_setup(phi, weights, config=config, mesh=mesh, base_shape=(n, n, n))
    torch.cuda.synchronize(dev)
    numbers = dict(setup_s=time.perf_counter() - t0, build_peak_gib=torch.cuda.max_memory_allocated(dev) / 2**30)
    for c in (fused_smoother.PASS_LAUNCHES, fused_smoother.NARROW_LAUNCHES, fused_cg.STEP_LAUNCHES,
              fused_cg.RESIDUAL_LAUNCHES, fused_smoother.SHARDED_LAUNCHES, fused_cg.SHARDED_STEP_LAUNCHES,
              halo.HALO_LAUNCHES):
        c.reset()
    mesh.stats.reset()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    result = free_surface.project(setup, velocity, config=config, mesh=mesh)
    torch.cuda.synchronize(dev)
    numbers.update(project_s=time.perf_counter() - t0, project_peak_gib=torch.cuda.max_memory_allocated(dev) / 2**30,
                   project_stats=dataclasses.asdict(mesh.stats))
    return setup, result, velocity, numbers


def gathered_pressure(result, mesh, n: int):
    """The whole pressure from every rank's block (every rank calls)."""
    from geometricmultigridpressuresolver_tpu_torch.parallel import distributed
    from geometricmultigridpressuresolver_tpu_torch.parallel.mesh import grid_split

    return distributed.gather_blocks(result.pressure, mesh, (n, n, n), grid_split(mesh, (n, n, n)))


def rank_project(mesh, n: int) -> dict:
    """Phase [11e], one rank of the mesh: the n^3 bench splash through the
    partitioned build and one projection; rank 0 returns the gathered
    pressure."""
    from geometricmultigridpressuresolver_tpu_torch.parallel import distributed

    setup, result, _, numbers = partitioned_run(mesh, n)
    pressure = gathered_pressure(result, mesh, n)
    return dict(
        numbers, rank=mesh.rank, iterations=result.cg.iterations, converged=result.cg.converged,
        relative_residual=result.cg.relative_residual,
        local_dofs=distributed.host_local_dofs(setup.problem.fine.solvable, mesh, setup.expanded_shape),
        block_shapes=[list(c.shape) for c in setup.problem.hier.levels],
        pressure=pressure.cpu() if mesh.rank == 0 else None,
    )


def rank_bench(mesh, n: int, reps: int = 3) -> dict:
    """Phase [11b], one rank of the mesh: the n^3 bench projection through
    the partitioned build (`partitioned_run`), with launch and exchange
    counts exact against the plan for this rank's mesh; the digests of
    its blocks of the setup; this rank's chunk-kernel blocks and CG step on
    its haloed blocks against their plain versions (the same functions
    with kernel_mode="torch"); the best of `reps` solves with each one's
    exchanges, staged bytes, exchange and compute milliseconds.  Rank 0
    returns the gathered pressure."""
    import torch

    from geometricmultigridpressuresolver_tpu_torch.ops import fused_cg, fused_smoother
    from geometricmultigridpressuresolver_tpu_torch.parallel import distributed, dryrun, fused_sharded, halo, sharding
    from geometricmultigridpressuresolver_tpu_torch.solver import mg, mgpcg

    dev = mesh.device
    counters = (
        fused_smoother.PASS_LAUNCHES, fused_smoother.NARROW_LAUNCHES, fused_cg.STEP_LAUNCHES,
        fused_cg.RESIDUAL_LAUNCHES, fused_smoother.SHARDED_LAUNCHES, fused_cg.SHARDED_STEP_LAUNCHES,
        halo.HALO_LAUNCHES,
    )
    config = dryrun.bench_config()
    setup, result, velocity, numbers = partitioned_run(mesh, n)
    launches = {c.name: c.count for c in counters}
    exchanges = numbers["project_stats"]["exchanges"]
    hier = setup.problem.hier
    iters = result.cg.iterations
    expected = expected_launches(hier, config, iters, mesh=mesh)
    expected_x = expected_exchanges(hier, config, iters, mesh)
    require(launches == expected, f"rank {mesh.rank}: launches {launches}, expected {expected}")
    require(exchanges == expected_x, f"rank {mesh.rank}: {exchanges} halo exchanges, expected {expected_x}")
    flags = mg.level_flags(hier, config, mesh)
    require(launches["smoother_sharded"] > 0 and launches["cg_step_sharded"] > 0,
            f"rank {mesh.rank}: the rank-side block functions never ran")
    digests = tensor_digests(setup)

    # This rank's kernels against their plain versions on its haloed blocks.
    gen = torch.Generator(device=dev).manual_seed(20261017 + mesh.rank)

    def rand_field(c):
        v = torch.randn(c.shape, generator=gen, device=dev, dtype=torch.float32)
        return torch.where(c.solvable, v, torch.zeros_like(v))

    config_t = dataclasses.replace(config, kernel_mode="torch")
    errs = {"smoother_sharded": 0.0, "smoother_sharded_dot": 0.0, "cg_step_sharded": 0.0,
            "cg_step_sharded_dot": 0.0}

    def check(name, what, got, want, tol):
        rel = rel_err(got, want)[1]
        key = name + ("_dot" if got.dim() == 0 else "")
        errs[key] = max(errs[key], rel)
        require(rel <= tol, f"rank {mesh.rank} {name} {what}: relative error {rel:.3e} > {tol:g}")

    for lv in (lv for lv in mg.smoothed_levels(hier) if flags[lv] == "sharded"):
        c, shape = hier.levels[lv], hier.shapes[lv]
        sb = fused_sharded.sharded_blocks(c, mesh, "auto", shape)
        pre_t = fused_sharded.prehalo_coeffs(c, mesh, "torch", shape)
        x, b = rand_field(c), rand_field(c)
        for case, kw in (("down", dict(forward=True, x_is_zero=True, emit_residual=True)),
                         ("up", dict(forward=False, emit_dot=True))):
            xx = None if kw.get("x_is_zero") else x
            got = fused_sharded.smooth_level_sharded(
                xx, b, c, config, mesh=mesh, prehaloed=sb.prehaloed, blocks=sb.blocks, shape=shape, **kw)
            torch.cuda.synchronize(dev)
            want = fused_sharded.smooth_level_sharded(xx, b, c, config_t, mesh=mesh, prehaloed=pre_t, shape=shape, **kw)
            for i, (g, w) in enumerate(zip(got, want)):
                check("smoother_sharded", f"L{lv} {case} [{i}]", g, w, 1e-5 if g.dim() else 1e-4)
    fine, shape0 = setup.problem.fine, hier.shapes[0]
    pre_cg = fused_sharded.prehalo_cg_coeffs(fine, mesh, "auto", shape0)
    z, p = rand_field(fine), rand_field(fine)
    beta = torch.tensor(0.7371, dtype=torch.float32, device=dev)
    got = fused_sharded.cg_step_sharded(z, p, beta, fine, config, mesh, pre_cg,
                                        fused_sharded.stacked_cg_tiles(pre_cg), shape0)
    torch.cuda.synchronize(dev)
    want = fused_sharded.cg_step_sharded(z, p, beta, fine, config_t, mesh, shape=shape0)
    for what, g, w in zip(("p'", "Ap'", "<p', Ap'>"), got, want):
        check("cg_step_sharded", what, g, w, 1e-5 if g.dim() else 1e-4)

    # The best of `reps` solves, each with its exchange counts and times.
    rhs = sharding.window_rhs(setup, velocity, None, config, mesh)
    solves = []
    for _ in range(reps):
        mesh.stats.reset()
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        res = mgpcg.solve(setup.problem, rhs, config=config, mesh=mesh)
        torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
        st = mesh.stats
        solves.append(dict(
            seconds=wall, iterations=res.iterations, exchanges=st.exchanges, bytes_staged=st.bytes_staged,
            exchange_ms=st.exchange_s * 1e3, pack_ms=st.pack_s * 1e3, collectives=st.collectives,
            collective_ms=st.collective_s * 1e3, compute_ms=(wall - st.exchange_s - st.collective_s) * 1e3,
        ))
        require(st.exchanges == expected_exchanges(hier, config, res.iterations, mesh, project=False),
                f"rank {mesh.rank}: solve exchanges differ from the plan")
    pressure = gathered_pressure(result, mesh, n)
    return dict(
        numbers, rank=mesh.rank, coords=list(mesh.coords), flags=list(flags), iterations=iters,
        converged=result.cg.converged, relative_residual=result.cg.relative_residual,
        recomputed_residual=float(result.residual_rel_l2),
        local_dofs=distributed.host_local_dofs(fine.solvable, mesh, shape0),
        block_shapes=[list(c.shape) for c in hier.levels], launches=launches, exchanges=exchanges,
        digests=digests, errs=errs, solves=solves,
        pressure_digest=[float(pressure.double().sum()), float(pressure.double().square().sum())],
        pressure=pressure.cpu() if mesh.rank == 0 else None,
    )


# Published H100 SXM peaks (NVIDIA data sheet) for the bounds: device
# memory bytes per second and float32 operations per second outside the
# tensor cores.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def n_tiles(tiles) -> int:
    """Tiles of the level a chunk-kernel `Tiles` was built for."""
    from geometricmultigridpressuresolver_tpu_torch.ops import fused_smoother

    gx, gy, gz = fused_smoother.tile_grid(tiles.shape, tiles.core)
    return gx * gy * gz


def lengths(tiles) -> tuple[int, int, int]:
    """(active tiles, dead tiles, band cells) of a `Tiles`: its device
    `counts`, read here (a host sync)."""
    return tuple(int(v) for v in tiles.counts.tolist())


def active_bytes(cells: int, inputs, out_cells: int, outputs) -> int:
    """Bytes a function must move when it reads each input only on the
    `cells` cells that need it (the solvable ones) and writes each output on
    all `out_cells`: the work this run's data needs, whatever implements it."""
    return cells * sum(t.element_size() for t in inputs) + out_cells * sum(t.element_size() for t in outputs)


def bound(moved: float, ops: float) -> tuple[float, str]:
    """(ms, "bytes" or "operations"): the least time the card could take to
    move `moved` bytes and do `ops` float32 operations."""
    t_bytes, t_ops = moved / HBM_BYTES_PER_S * 1e3, ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# Float operations per updated cell: the six-point neighbour sum (6
# multiplies, 6 adds) plus the update's 4; the CG step adds p' = z + beta p
# and the dot; the residual b - (diag x - S).
OPS_PASS, OPS_CG_STEP, OPS_RESIDUAL, OPS_DOT = 16, 18, 15, 2


def block_ops(schedule, cells: int, band_cells: int, dot: bool) -> int:
    """Operations of one smoothing block as this run's data needs them: a
    `b` pass updates the band cells, a GS half-sweep half the cells, a
    Jacobi pass all of them."""
    per = {"b": band_cells, "r": cells // 2, "k": cells // 2, "j": cells}
    return OPS_PASS * sum(per[kind] for kind in schedule) + OPS_DOT * cells * dot


def device_events(fn, calls: int = 10):
    """(host launch calls, device events, device ms) per call of `fn`, from
    torch.profiler over `calls` calls after one call as the profiler's
    warm-up step: the host's kernel-launch calls (cudaLaunchKernel*, cuLaunchKernel*),
    and every kernel, copy and fill the card ran."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    torch.cuda.synchronize()
    kept = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1),
                 on_trace_ready=lambda p: kept.append(p.key_averages())) as prof:
        for n in (1, calls):
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
            prof.step()
    dev = [e for e in kept[0] if getattr(e, "device_type", None) == DeviceType.CUDA
           and not e.key.startswith("ProfilerStep")]  # the step's own range on the device timeline
    host = sum(e.count for e in kept[0] if getattr(e, "device_type", None) != DeviceType.CUDA
               and "LaunchKernel" in e.key)
    return host / calls, sum(e.count for e in dev) / calls, sum(device_us(e) for e in dev) / 1e3 / calls


def private_pools() -> set:
    """The ids of the private (CUDA graph) memory pools that hold a device
    memory segment."""
    import torch

    return {tuple(seg["segment_pool_id"]) for seg in torch.cuda.memory_snapshot()} - {(0, 0)}


def device_us(event) -> float:
    """A profiler event's self device time in microseconds (the attribute's
    name changed across torch versions)."""
    us = getattr(event, "self_device_time_total", None)
    return event.self_cuda_time_total if us is None else us


def rounded_once_reference(kind: str, *args):
    """The matrix-form transfer of bf16 `x` computed exactly (fp64) and
    rounded to bf16 where the matrix form rounds: after each product, and
    (prolongation) once for fine + 4 up after the last; the card's products
    differ from it only by their fp32 accumulation."""
    import torch

    from geometricmultigridpressuresolver_tpu_torch.ops import transfer

    bf16 = torch.bfloat16
    if kind == "restrict":
        x, coarse_solvable = args
        out = x.double()
        for axis in range(3):
            r = transfer.restrict_axis_matrix(out, axis, coarse_solvable.shape[axis], 0)
            out = transfer.axis_product(out, r, axis).to(bf16).double()
        return torch.where(coarse_solvable, out, 0.0).to(bf16)
    fine_x, coarse_x, fine_solvable = args
    up = coarse_x.double()
    for axis in range(3):
        up = transfer.axis_product(up, transfer.prolong_axis_matrix(fine_x.shape[axis], up, axis, 0), axis)
        if axis < 2:
            up = up.to(bf16).double()
    return torch.where(fine_solvable, (fine_x.double() + 4.0 * up).to(bf16), fine_x)


@contextlib.contextmanager
def eager_cg_loop():
    """Inside the block the CG loop runs eagerly, the host testing `running`
    after every iteration (`solver.cg.run_eager`), where it would run as
    the captured graph (`mgpcg.loop_runner`'s rule), and run_fused's frames
    run eagerly (`graph.EmulatedFrame`, the host testing `running` after
    every iteration) where each would be one captured graph
    (`simulate.frame_runner`'s rule), and no call runs as a cached program
    (`graph.programs_off`)."""
    from geometricmultigridpressuresolver_tpu_torch.models import simulate
    from geometricmultigridpressuresolver_tpu_torch.solver import graph, mgpcg

    saved = mgpcg.loop_runner, simulate.frame_runner
    mgpcg.loop_runner = lambda stages, rhs: None
    simulate.frame_runner = lambda device: graph.EmulatedFrame
    try:
        with graph.programs_off():
            yield
    finally:
        mgpcg.loop_runner, simulate.frame_runner = saved


def loop_mode(eager: bool):
    return eager_cg_loop() if eager else contextlib.nullcontext()


def bench_rhs(setup, velocity):
    """The projection's right-hand side of a setup (phase 5's)."""
    import torch

    from geometricmultigridpressuresolver_tpu_torch.models import free_surface

    return free_surface.embed_window(
        free_surface.negative_divergence(setup.liquid_mask, tuple(v.to(torch.float32) for v in velocity),
                                         setup.weights),
        setup.window_start, setup.base_pads, setup.expanded_shape,
    )


def timed_solve(problem, rhs, config, eager: bool, mesh=None):
    """One `mgpcg.solve`, through the graph or eagerly: (result, wall ms on
    the host clock up to a device sync, ms between CUDA events around it,
    a copy of `graph.STATS` for this solve)."""
    import torch

    from geometricmultigridpressuresolver_tpu_torch.solver import graph, mgpcg

    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    graph.STATS.reset()
    torch.cuda.synchronize()
    with loop_mode(eager):
        t0 = time.perf_counter()
        start.record()
        res = mgpcg.solve(problem, rhs, config=config, mesh=mesh)
        stop.record()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    return res, wall, start.elapsed_time(stop), dataclasses.replace(graph.STATS)


PORT_KERNEL = re.compile(r"(smooth_chunk|cg_step|residual|sum_partials|halo_gather|core_scatter|set_condition)_kernel")


def port_kernels(events) -> dict:
    """Launches of the port's kernels by name among profiler events (any
    spelling of the name)."""
    from torch.autograd import DeviceType

    port = collections.Counter()
    for e in events:
        m = PORT_KERNEL.search(e.key)
        if m and getattr(e, "device_type", None) == DeviceType.CUDA:
            port[m.group(0)] += e.count
    return dict(port)


def profiled_solve(problem, rhs, config, eager: bool) -> dict:
    """One warm `mgpcg.solve` under torch.profiler (the solve before it runs
    unprofiled): device ms and launches, the port's kernels by name as the
    trace shows them, the launch counters of the same solve (counted on
    the device), every device event's count and ms by key, and the host's
    launch calls by API name."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    from geometricmultigridpressuresolver_tpu_torch.ops import _cuda
    from geometricmultigridpressuresolver_tpu_torch.solver import mgpcg

    with loop_mode(eager):
        mgpcg.solve(problem, rhs, config=config)
        torch.cuda.synchronize()
        for c in _cuda.COUNTERS:
            c.reset()
        with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            mgpcg.solve(problem, rhs, config=config)
            torch.cuda.synchronize()
    events = prof.key_averages()
    dev = [e for e in events if getattr(e, "device_type", None) == DeviceType.CUDA]
    host = [e for e in events if getattr(e, "device_type", None) != DeviceType.CUDA]
    return dict(
        device_ms=sum(device_us(e) for e in dev) / 1e3, device_launches=sum(e.count for e in dev),
        port_kernels=port_kernels(dev), counters={c.name: c.count for c in _cuda.COUNTERS if c.count},
        keys={e.key: (e.count, device_us(e) / 1e3) for e in dev},
        launch_calls={e.key: e.count for e in host if "Launch" in e.key},
    )


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--n", type=int, default=256, help="scene size (default 256)")
    args = parser.parse_args(argv)

    import torch

    # ---- 1. the card --------------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    import numpy as np
    import scipy.sparse
    import scipy.sparse.linalg

    from geometricmultigridpressuresolver_tpu_torch import diagnostics, parallel
    from geometricmultigridpressuresolver_tpu_torch.config import SolverConfig
    from geometricmultigridpressuresolver_tpu_torch.models import assembled, free_surface, sdf, simulate
    from geometricmultigridpressuresolver_tpu_torch.ops import _cuda, blas, fused_cg, fused_smoother, stencil
    from geometricmultigridpressuresolver_tpu_torch.parallel import fused_sharded, halo
    from geometricmultigridpressuresolver_tpu_torch.solver import graph, mg, mgpcg
    from geometricmultigridpressuresolver_tpu_torch.utils import profiling

    torch.backends.cuda.matmul.allow_tf32 = False  # the coarse matmul in full fp32
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"[1] card: {card}")
    print(f"[1] torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    # ---- 2. build -------------------------------------------------------------
    _cuda.library()
    info = _cuda.build_info
    print(f"[2] kernels {'built' if info.compiled else 'loaded'} in {info.seconds:.1f} s: {info.path.name}")
    regs = [int(w) for w in re.findall(r"Used (\d+) registers", info.log)]
    spills = sum(int(w) for w in re.findall(r"(\d+) bytes spill", info.log))
    print(f"[2] ptxas: {len(regs)} kernels, at most {max(regs, default=0)} registers "
          f"per thread, {spills} bytes of spills")

    # ---- 3. main path -----------------------------------------------------------
    n = args.n
    config = SolverConfig(
        solve_dtype=torch.float32, mg_dtype=torch.float32, mg_ew_dtype=torch.bfloat16,
        tolerance=1e-5, max_iterations=200,
    )
    counters = (
        fused_smoother.PASS_LAUNCHES,
        fused_smoother.NARROW_LAUNCHES, fused_cg.STEP_LAUNCHES, fused_cg.RESIDUAL_LAUNCHES,
        fused_smoother.SHARDED_LAUNCHES, fused_cg.SHARDED_STEP_LAUNCHES, halo.HALO_LAUNCHES,
    )

    def reset_counts():
        for c in counters:
            c.reset()

    def read_counts():
        return {c.name: c.count for c in counters}

    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    liquid_phi, velocity = sdf.splash_scene((n, n, n), device=dev, dtype=torch.float32)
    weights = sdf.open_box_weights((n, n, n), device=dev, dtype=torch.float32)
    torch.cuda.synchronize()
    t_scene, t0 = time.perf_counter() - t0, time.perf_counter()
    setup = free_surface.build_setup(liquid_phi, weights, config=config)
    torch.cuda.synchronize()
    t_setup, t0 = time.perf_counter() - t0, time.perf_counter()
    result = free_surface.project(setup, velocity, config=config)
    torch.cuda.synchronize()
    t_project = time.perf_counter() - t0
    launches = read_counts()

    hier = setup.problem.hier
    nlev = hier.num_levels
    ndof = int(setup.problem.fine.solvable.sum())
    iters = result.cg.iterations
    print(f"[3] scene {t_scene:.2f} s, setup {t_setup:.2f} s, first project {t_project:.2f} s")
    print(f"[3] expanded {setup.expanded_shape}, levels {[tuple(c.shape) for c in hier.levels]}, "
          f"coarse system {tuple((hier.coarse_minv if hier.coarse_minv.numel() else hier.coarse_chol).shape)}")
    blocks = mg.hierarchy_block_lists(hier, config)
    for lv in mg.smoothed_levels(hier):
        tiles = blocks[lv].tiles
        (na, _, nb), nt = lengths(tiles), n_tiles(tiles)
        print(f"[3] L{lv} {tuple(hier.levels[lv].shape)}: {nb:,} band cells, "
              f"{nb / hier.levels[lv].diag.numel():.2%} of the level; chunk depth {tiles.depth}, "
              f"tile {tiles.core}, active tiles {na}/{nt} = {na / nt:.3f}")
    cg_tiles = mgpcg.fine_tiles(setup.problem, blocks)
    print(f"[3] CG step and residual at L0: tile {cg_tiles.core}, active tiles "
          f"{lengths(cg_tiles)[0]}/{n_tiles(cg_tiles)} = {lengths(cg_tiles)[0] / n_tiles(cg_tiles):.3f} "
          f"(the level's chunk-kernel tiles, built once per solve)")
    print(f"[3] liquid DOFs {ndof:,}; iterations {iters}; relative residual "
          f"{result.cg.relative_residual:.3e}; recomputed {float(result.residual_rel_l2):.3e} "
          f"(linf {float(result.residual_linf):.3e}); max divergence "
          f"{float(result.max_divergence):.3e}, avg {float(result.avg_divergence):.3e}")
    # The recomputed residual once more in fp64 from the fp32 solution (the
    # fine operator's fp32 coefficients, upcast exactly): this tells the
    # fp32 check's own rounding apart from the solve's error.
    fine3 = setup.problem.fine
    rhs3 = free_surface.embed_window(
        free_surface.negative_divergence(setup.liquid_mask, velocity, setup.weights),
        setup.window_start, setup.base_pads, setup.expanded_shape,
    ).double()
    f64 = stencil.LevelCoeffs(fine3.solvable, fine3.band, *(t.double() for t in fine3[2:]))
    rel64 = float(blas.l2_norm(stencil.residual(result.cg.x.double(), rhs3, f64), fine3.solvable)
                  / blas.l2_norm(rhs3, fine3.solvable))
    print(f"[3] recomputed relative residual: {float(result.residual_rel_l2):.3e} in fp32, {rel64:.3e} in fp64 "
          f"from the same fp32 solution (the recurrence: {result.cg.relative_residual:.3e})")
    peak3 = torch.cuda.max_memory_allocated() / 2**30
    # The same build and projection with the program cache off (the setup
    # eager, the CG loop captured per solve: no pools or copies): [11b] holds each rank's build to half of
    # this single-process peak, the scene's fields counted as above.
    with graph.programs_off():
        torch.cuda.synchronize()
        held3 = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        free_surface.project(free_surface.build_setup(liquid_phi, weights, config=config), velocity, config=config)
        torch.cuda.synchronize()
        peak3_off = (torch.cuda.max_memory_allocated() - held3 + nbytes(liquid_phi, *velocity, *weights)) / 2**30
    print(f"[3] peak device memory {peak3:.2f} GiB (the program cache's pools and copies included); the same "
          f"build and projection with the cache off {peak3_off:.2f} GiB")
    require(result.cg.converged and result.cg.relative_residual <= 1e-5, "did not converge to 1e-5")
    require(tuple(result.pressure.shape) == (n, n, n), "pressure shape")
    require(all(tuple(v.shape) == tuple(u.shape) for v, u in zip(result.velocity, velocity)),
            "velocity shapes")
    require(bool(torch.isfinite(result.pressure).all())
            and all(bool(torch.isfinite(v).all()) for v in result.velocity), "non-finite output")
    expected = expected_launches(hier, config, iters)
    print(f"[3] kernel launches {launches}, expected {expected}")
    require(launches == expected, "launch counts differ from what the hierarchy implies")
    require(launches["smoother"] > 0, "the chunk kernel never ran on the main path")
    print("[3] band-pass launches: 0 (no such kernel remains; the chunk kernel skips the neighbour "
          "sum of non-band cells in its b passes)")

    # ---- 4. kernels against their plain versions ----------------------------------
    gen = torch.Generator(device=dev).manual_seed(20261016)

    def rand_field(c):
        v = torch.randn(c.shape, generator=gen, device=dev, dtype=torch.float32)
        return torch.where(c.solvable, v, torch.zeros_like(v))

    grid_tol, dot_tol = 1e-5, 1e-4  # fp32: FMA contraction and summation order
    # bf16 fields: both sides compute in fp32 and round once, so they differ
    # by at most one bf16 ulp at the output's scale (plus the fp32 term).
    names = ("smoother", "smoother_band_strip", "smoother_bf16", "cg_step", "residual",
             "halo", "smoother_sharded", "cg_step_sharded")
    errs = dict.fromkeys(names + ("residual_bf16",), 0.0)      # grids, absolute
    dot_errs = dict.fromkeys(names[:3] + ("cg_step", "smoother_sharded", "cg_step_sharded"), 0.0)  # dots, relative

    def check(name, what, got, want, tol=None):
        """tol None: the bf16 bound; else a relative bound."""
        diff, rel = rel_err(got, want)
        if got.dim():
            errs[name] = max(errs[name], diff)
        else:
            dot_errs[name] = max(dot_errs[name], rel)
        if tol is None:
            scale = float(want.double().abs().max())
            bound = bf16_ulp(scale) + grid_tol * scale
            require(diff <= bound, f"{name} {what}: error {diff:.3e} > one bf16 ulp {bound:.3e}")
        else:
            require(rel <= tol, f"{name} {what}: relative error {rel:.3e} > {tol:g}")
        return rel

    config_full = dataclasses.replace(config, pallas_band_strip=0)
    cases = {
        "down(zero_x,emit_residual)": dict(forward=True, x_is_zero=True, emit_residual=True),
        "up": dict(forward=False),
        "up(emit_dot)": dict(forward=False, emit_dot=True),
        "down(warm)": dict(forward=True),
        "jacobi(emit_dot)": dict(forward=True, emit_dot=True),
    }

    def case_config(cfg, case):
        return dataclasses.replace(cfg, use_gauss_seidel=False) if case.startswith("jacobi") else cfg

    def as_tuple(v):
        return v if isinstance(v, tuple) else (v,)

    smoothed = [hier.levels[lv] for lv in mg.smoothed_levels(hier)]
    worst = {}
    band_vs_full = 0.0
    for lv, c_bf16 in enumerate(smoothed):
        c_f32 = c_bf16._replace(ew0=c_bf16.ew0.float(), ew1=c_bf16.ew1.float(), ew2=c_bf16.ew2.float())
        for tag, c in (("bf16", c_bf16), ("fp32", c_f32)):
            x, b = rand_field(c), rand_field(c)
            blk = fused_smoother.level_blocks(c, config)
            blk_bf16 = fused_smoother.level_blocks(c, config, torch.bfloat16)
            require(blk.band_cells is not None, f"L{lv}: no band cells")
            for case, kw in cases.items():
                xx = None if kw.get("x_is_zero") else x
                key = f"L{lv} {tag} {case}"
                cfg_b, cfg_f = case_config(config, case), case_config(config_full, case)
                # Full-grid boundary passes (pallas_band_strip=0) vs plain.
                got = as_tuple(fused_smoother.smooth_level(xx, b, c, cfg_f, **kw))
                torch.cuda.synchronize()
                want = as_tuple(fused_smoother.smooth_level_torch(xx, b, c, cfg_f, **kw))
                worst[key] = check("smoother", key + " x", got[0], want[0], grid_tol)
                if kw.get("emit_residual"):
                    check("smoother", key + " r", got[1], want[1], grid_tol)
                if kw.get("emit_dot"):
                    check("smoother", key + " dot", got[-1], want[-1], dot_tol)
                # Band-restricted block vs plain, and vs the full-grid kernel.
                full_kernel = got
                got = as_tuple(fused_smoother.smooth_level(xx, b, c, cfg_b, blocks=blk, **kw))
                torch.cuda.synchronize()
                want = as_tuple(fused_smoother.smooth_level_torch(xx, b, c, cfg_b, blocks=blk, **kw))
                for i, (g, w, fk) in enumerate(zip(got, want, full_kernel)):
                    check("smoother_band_strip", f"{key} [{i}] vs plain", g, w, grid_tol if g.dim() else dot_tol)
                    band_vs_full = max(band_vs_full, rel_err(g, fk)[1])
                    require(rel_err(g, fk)[1] <= (grid_tol if g.dim() else dot_tol),
                            f"band-restricted block {key} differs from the full-grid kernel")
                # bf16 fields vs plain.
                xb = None if xx is None else xx.to(torch.bfloat16)
                bb = b.to(torch.bfloat16)
                got = as_tuple(fused_smoother.smooth_level(xb, bb, c, cfg_b, blocks=blk_bf16, **kw))
                torch.cuda.synchronize()
                want = as_tuple(fused_smoother.smooth_level_torch(xb, bb, c, cfg_b, blocks=blk_bf16, **kw))
                require(got[0].dtype == torch.bfloat16, "bf16 block output dtype")
                for i, (g, w) in enumerate(zip(got, want)):
                    check("smoother_bf16", f"{key} [{i}]", g, w, None if g.dim() else dot_tol)
            # A lone `b` pass of the chunk kernel vs the plain band-restricted
            # pass into a copy of x (x itself off the band).
            got = fused_smoother.smooth_level(x, b, c, config, True, blocks=blk, schedule=("b",))
            torch.cuda.synchronize()
            want = fused_smoother.band_pass_torch(x, x.clone(), b, c, blk.band_cells, config.jacobi_damping)
            check("smoother_band_strip", f"L{lv} {tag} lone b pass", got, want, grid_tol)
            # The residual over the level's tiles: fp32, twice (bit-equal),
            # and with bf16 storage of b and r.
            ops = (c.diag, c.ew0, c.ew1, c.ew2)
            r_got = fused_cg.residual(x, b, *ops, mode="cuda", tiles=blk.tiles)
            r_again = fused_cg.residual(x, b, *ops, mode="cuda", tiles=blk.tiles)
            torch.cuda.synchronize()
            r_want = fused_cg.residual_torch(x, b, *ops)
            check("residual", f"L{lv} {tag}", r_got, r_want, grid_tol)
            require(torch.equal(r_got, r_again), f"residual L{lv} {tag}: two calls differ")
            r_got = fused_cg.residual(x, b.to(torch.bfloat16), *ops, mode="cuda", tiles=blk.tiles)
            torch.cuda.synchronize()
            check("residual_bf16", f"L{lv} {tag} bf16 storage", r_got,
                  fused_cg.residual_torch(x, b.to(torch.bfloat16), *ops), None)
    fine = setup.problem.fine
    z, p = rand_field(fine), rand_field(fine)
    beta = torch.tensor(0.7371, dtype=torch.float32, device=dev)
    fine_ops = (fine.diag, fine.ew0, fine.ew1, fine.ew2)
    got = fused_cg.search_matvec_dot(z, p, beta, *fine_ops, mode="cuda", tiles=cg_tiles)
    again = fused_cg.search_matvec_dot(z, p, beta, *fine_ops, mode="cuda", tiles=cg_tiles)
    torch.cuda.synchronize()
    want = fused_cg.search_matvec_dot_torch(z, p, beta, *fine_ops)
    check("cg_step", "p'", got[0], want[0], grid_tol)
    check("cg_step", "Ap'", got[1], want[1], grid_tol)
    check("cg_step", "<p', Ap'>", got[2], want[2], dot_tol)
    require(all(torch.equal(g, a) for g, a in zip(got, again)), "cg_step: two calls differ")
    # Without tiles: built in the call from diag != 0, the same tiles here.
    require(all(torch.equal(g, a) for g, a in zip(
        got, fused_cg.search_matvec_dot(z, p, beta, *fine_ops, mode="cuda"))), "cg_step without tiles differs")
    print(f"[4] kernel vs plain: fp32 within {grid_tol:g} (grids) / {dot_tol:g} (dots) relative, "
          f"bf16 fields within one bf16 ulp at the output's scale; max abs grid errors "
          f"{ {k: errs[k] for k in names[:5]} }, max relative dot errors "
          f"{ {k: dot_errs[k] for k in names[:4]} }")
    print(f"[4] CG step and residual: two calls on the same inputs bit-equal; bf16 residual storage within "
          f"one bf16 ulp (max abs error {errs['residual_bf16']:.3e})")
    print(f"[4] band-restricted vs full-grid kernel blocks: max relative difference {band_vs_full:.3e}")
    print(f"[4] worst full-grid smoother case: {max(worst, key=worst.get)} at {max(worst.values()):.3e} relative")

    # Times at the fine-level shape: fine upstroke blocks with the rho dot
    # (8 passes) in the full-grid and band-restricted configurations, the
    # bf16-field block, one CG step, one residual.
    c0 = hier.levels[0]
    x0f, b0f = rand_field(c0), rand_field(c0)
    x0h, b0h = x0f.to(torch.bfloat16), b0f.to(torch.bfloat16)
    blk0 = fused_smoother.level_blocks(c0, config)
    blk0f = fused_smoother.level_blocks(c0, config_full)
    blk0h = fused_smoother.level_blocks(c0, config, torch.bfloat16)
    reps = 20
    times = {
        "smoother": (
            cuda_ms(lambda: fused_smoother.smooth_level(x0f, b0f, c0, config_full, False, emit_dot=True, blocks=blk0f), reps),
            cuda_ms(lambda: fused_smoother.smooth_level_torch(x0f, b0f, c0, config_full, False, emit_dot=True, blocks=blk0f), reps),
        ),
        "smoother_band_strip": (
            cuda_ms(lambda: fused_smoother.smooth_level(x0f, b0f, c0, config, False, emit_dot=True, blocks=blk0), reps),
            cuda_ms(lambda: fused_smoother.smooth_level_torch(x0f, b0f, c0, config, False, emit_dot=True, blocks=blk0), reps),
        ),
        "smoother_bf16": (
            cuda_ms(lambda: fused_smoother.smooth_level(x0h, b0h, c0, config, False, emit_dot=True, blocks=blk0h), reps),
            cuda_ms(lambda: fused_smoother.smooth_level_torch(x0h, b0h, c0, config, False, emit_dot=True, blocks=blk0h), reps),
        ),
        "cg_step": (
            cuda_ms(lambda: fused_cg.search_matvec_dot(z, p, beta, *fine_ops, mode="cuda", tiles=cg_tiles), reps),
            cuda_ms(lambda: fused_cg.search_matvec_dot_torch(z, p, beta, *fine_ops), reps),
        ),
        "residual": (
            cuda_ms(lambda: fused_cg.residual(x0f, b0f, c0.diag, c0.ew0, c0.ew1, c0.ew2, mode="cuda",
                                              tiles=blk0.tiles), reps),
            cuda_ms(lambda: fused_cg.residual_torch(x0f, b0f, c0.diag, c0.ew0, c0.ew1, c0.ew2), reps),
        ),
    }
    what = {
        "smoother": "full-grid config, fine upstroke block + dot",
        "smoother_band_strip": "band-restricted config, fine upstroke block + dot",
        "smoother_bf16": "bf16-field fine upstroke block + dot",
        "cg_step": "CG step", "residual": "residual",
    }
    # The bound of the work this run's data needs (`bounds`, the JSON's
    # bound_ms): each input read once on the solvable cells, each output
    # written once on every cell.  Over the whole window (`bounds_window`):
    # each input read once and each output written once on every cell.
    nb0, n0 = lengths(blk0.tiles)[2], c0.diag.numel()
    ns0, nsf = int(c0.solvable.sum()), int(fine.solvable.sum())
    upstroke = fused_smoother.schedule_for(config, False)
    smoother_in = (x0f, b0f, c0.inv_diag, c0.ew0, c0.ew1, c0.ew2, c0.band)
    bf16_in = (x0h, b0h, blk0h.narrow.inv_diag, c0.ew0, c0.ew1, c0.ew2, c0.band)
    cg_in = (z, p, fine.diag, fine.ew0, fine.ew1, fine.ew2)
    residual_in = (x0f, b0f, c0.diag, c0.ew0, c0.ew1, c0.ew2)
    bounds = {
        "smoother": bound(active_bytes(ns0, smoother_in, n0, (x0f,)), block_ops(upstroke, ns0, nb0, True)),
        "smoother_bf16": bound(active_bytes(ns0, bf16_in, n0, (x0h,)), block_ops(upstroke, ns0, nb0, True)),
        "cg_step": bound(active_bytes(nsf, cg_in, fine.diag.numel(), (z, p)), OPS_CG_STEP * nsf),
        "residual": bound(active_bytes(ns0, residual_in, n0, (x0f,)), OPS_RESIDUAL * ns0),
    }
    bounds_window = {
        "smoother": bound(nbytes(*smoother_in, x0f), block_ops(upstroke, n0, nb0, True)),
        "smoother_bf16": bound(nbytes(*bf16_in, x0h), block_ops(upstroke, n0, nb0, True)),
        "cg_step": bound(nbytes(*cg_in, z, p), OPS_CG_STEP * fine.diag.numel()),
        "residual": bound(nbytes(*residual_in, x0f), OPS_RESIDUAL * n0),
    }
    for table in (bounds, bounds_window):
        table["smoother_band_strip"] = table["smoother"]
    library = dict.fromkeys(names)  # no single PyTorch call computes these
    for name, (k_ms, p_ms) in times.items():
        print(f"[4] {name} at {tuple(c0.shape)}, {what[name]}: kernel {k_ms:.4f} ms, "
              f"plain {p_ms:.4f} ms, bound over the solvable cells {bounds[name][0]:.4f} ms "
              f"({bounds[name][1]}), over the whole window {bounds_window[name][0]:.4f} ms "
              f"({bounds_window[name][1]}) [{card}]")
    print(f"[4] CG step {times['cg_step'][0]:.4f} ms (recorded for PR 4's thread-per-cell kernel in PERF.md: "
          f"0.4213 ms), residual {times['residual'][0]:.4f} ms (recorded: 0.2355 ms), over the tiles "
          f"{cg_tiles.core}, {lengths(cg_tiles)[0]}/{n_tiles(cg_tiles)} active [{card}]")
    cg_untiled_ms = cuda_ms(lambda: fused_cg.search_matvec_dot(z, p, beta, *fine_ops, mode="cuda"), reps)
    print(f"[4] CG step without tiles (built in each call from diag != 0, on the card): {cg_untiled_ms:.4f} ms [{card}]")
    print(f"[4] fine upstroke block + dot: band-restricted config {times['smoother_band_strip'][0]:.4f} ms "
          f"(recorded for the one-launch-per-pass kernel in PERF.md: 1.6521 ms), full-grid config "
          f"{times['smoother'][0]:.4f} ms (recorded: 1.9510 ms) [{card}]")
    # The host's share of a block: the wall time of the wrapper's calls
    # without a sync (Python, allocations, the launch), against the device's.
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fused_smoother.smooth_level(x0f, b0f, c0, config, False, emit_dot=True, blocks=blk0)
    host_ms = (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize()
    print(f"[4] fine upstroke block + dot: host {host_ms:.4f} ms per call to issue it (no sync), "
          f"device {times['smoother_band_strip'][0]:.4f} ms [{card}]")

    # The fine blocks at other chunk depths (the kept one is
    # fused_smoother.CHUNK_DEPTH), each checked against the kept one: the
    # upstroke with the dot and the downstroke from x = 0 with the residual.
    up_ref = fused_smoother.smooth_level(x0f, b0f, c0, config, False, emit_dot=True, blocks=blk0)
    for depth in (2, 4, 8):
        blk_d = blk0._replace(tiles=fused_smoother.level_tiles(c0.solvable, blk0.tiles.band, depth))
        got = fused_smoother.smooth_level(x0f, b0f, c0, config, False, emit_dot=True, blocks=blk_d)
        torch.cuda.synchronize()
        require(rel_err(got[0], up_ref[0])[1] <= grid_tol and rel_err(got[1], up_ref[1])[1] <= dot_tol,
                f"chunk depth {depth}: differs from the kept chunk plan")
        up_ms = cuda_ms(lambda blk=blk_d: fused_smoother.smooth_level(
            x0f, b0f, c0, config, False, emit_dot=True, blocks=blk), reps)
        down_ms = cuda_ms(lambda blk=blk_d: fused_smoother.smooth_level(
            None, b0f, c0, config, True, x_is_zero=True, emit_residual=True, blocks=blk), reps)
        t = blk_d.tiles
        print(f"[4] chunk depth {depth}, tile {t.core}: active tiles {lengths(t)[0]}/{n_tiles(t)}, "
              f"fine upstroke + dot {up_ms:.4f} ms, fine downstroke + residual {down_ms:.4f} ms [{card}]")
    # Where the fine block's time goes: one launch each with the dot (so each
    # pays the buffers, the copy-in and the final sweep): the six `b` passes
    # alone, the two GS half-sweeps alone, and `b` passes over an empty band
    # list (what is left is the launch, the buffers, the copy-in, the final
    # sweep and one grid barrier per pass).
    no_band = blk0._replace(tiles=fused_smoother.level_tiles(c0.solvable))
    parts = {"b x6": (("b",) * 6, blk0), "r k": (("r", "k"), blk0),
             "b x2, empty band": (("b",) * 2, no_band), "b x8, empty band": (("b",) * 8, no_band)}
    part_ms = [
        f"{tag} {cuda_ms(lambda s=s, bl=bl: fused_smoother.smooth_level(x0f, b0f, c0, config, False, emit_dot=True, blocks=bl, schedule=s), reps):.4f} ms"
        for tag, (s, bl) in parts.items()
    ]
    print(f"[4] fine block by pass kind, one launch each with the dot: {', '.join(part_ms)} [{card}]")
    # The work lists' lengths come from the device (`Tiles.counts`): the
    # lists built on the host from those lengths (the form the kernels took
    # before, with host counts), padded with other tiles and cells in place
    # of the sentinel, give the same bits -- the kernels read nothing past
    # the counts, and the device-built lists are the host-built ones.
    host_lists = [t.cpu() for t in fused_smoother.trimmed(blk0.tiles)]
    n_cells = c0.diag.numel()
    want_active = torch.nonzero(fused_smoother.tile_occupancy(c0.solvable, blk0.tiles.core).reshape(-1).cpu())
    want_band = torch.nonzero(c0.band.reshape(-1).cpu())
    require(torch.equal(host_lists[0].long(), want_active.reshape(-1))
            and torch.equal(host_lists[2].long(), want_band.reshape(-1)), "device-built lists differ from the host's")

    def junk_padded(lst, cap):
        pad = torch.arange(cap - lst.numel(), dtype=torch.int32) % max(lst.numel(), 1)
        return torch.cat([lst, lst[pad.long()] if lst.numel() else pad]).to(dev)

    junk = blk0.tiles._replace(
        active=junk_padded(host_lists[0], n_tiles(blk0.tiles)), dead=junk_padded(host_lists[1], n_tiles(blk0.tiles)),
        band=junk_padded(host_lists[2], n_cells),
        counts=torch.tensor([h.numel() for h in host_lists], dtype=torch.int32, device=dev),
    )
    same = {
        "smoother": all(torch.equal(a, b) for a, b in zip(
            fused_smoother.smooth_level(x0f, b0f, c0, config, False, emit_dot=True, blocks=blk0),
            fused_smoother.smooth_level(x0f, b0f, c0, config, False, emit_dot=True, blocks=blk0._replace(tiles=junk)))),
        "cg_step": all(torch.equal(a, b) for a, b in zip(
            fused_cg.search_matvec_dot(x0f, b0f, beta, c0.diag, c0.ew0, c0.ew1, c0.ew2, mode="cuda", tiles=blk0.tiles),
            fused_cg.search_matvec_dot(x0f, b0f, beta, c0.diag, c0.ew0, c0.ew1, c0.ew2, mode="cuda", tiles=junk))),
        "residual": torch.equal(
            fused_cg.residual(x0f, b0f, c0.diag, c0.ew0, c0.ew1, c0.ew2, mode="cuda", tiles=blk0.tiles),
            fused_cg.residual(x0f, b0f, c0.diag, c0.ew0, c0.ew1, c0.ew2, mode="cuda", tiles=junk)),
    }
    print(f"[4] device counts {lengths(blk0.tiles)} at L0: bit-equal to the host-built lists padded with other "
          f"entries: {same}; lists {nbytes(blk0.tiles.active, blk0.tiles.dead, blk0.tiles.band) / 2**20:.1f} MiB "
          f"(the band padded to {n_cells:,} cells)")
    require(all(same.values()), "a kernel read its work list past the device count")

    # ---- 5. solve times, kernels vs plain ---------------------------------------------
    rhs = bench_rhs(setup, velocity)
    config_t = dataclasses.replace(config, kernel_mode="torch")
    config_h = dataclasses.replace(config, mg_field_dtype=torch.bfloat16)

    # Three rounds, the configurations in turns within each (the host's
    # speed drifts between calls), the best of each kept.  Each solve also
    # counts the device-memory segments the caching allocator had to add
    # (cudaMalloc calls, which synchronize).
    solves, each = {}, {}
    for _ in range(3):
        for tag, cfg in (("kernels", config), ("plain torch", config_t),
                         ("kernels, pallas_band_strip=0", config_full),
                         ("kernels, mg_field_dtype=bf16", config_h)):
            segments = torch.cuda.memory_stats().get("segment.all.allocated", 0)
            torch.cuda.synchronize()
            t = time.perf_counter()
            res = mgpcg.solve(setup.problem, rhs, config=cfg)
            torch.cuda.synchronize()
            t = time.perf_counter() - t
            segments = torch.cuda.memory_stats().get("segment.all.allocated", 0) - segments
            each.setdefault(tag, []).append(f"{t:.4f} s ({segments} new segments)")
            solves[tag] = min(solves.get(tag, (t, res)), (t, res), key=lambda tr: tr[0])
    for tag, (t, res) in solves.items():
        print(f"[5] solve best of 3, {tag}: {t:.4f} s, {res.iterations} iters, rel. residual "
              f"{res.relative_residual:.3e}, {ndof / t:,.0f} DOF/s; each: {', '.join(each[tag])} [{card}]")
    res_k, res_0, res_h = (solves[k][1] for k in (
        "kernels", "kernels, pallas_band_strip=0", "kernels, mg_field_dtype=bf16"))
    _, band_rel = rel_err(res_k.x, res_0.x)
    print(f"[5] band-restricted vs full-grid passes: iterations {res_k.iterations} vs "
          f"{res_0.iterations}, pressure max relative difference {band_rel:.3e}")
    require(res_k.iterations == res_0.iterations, "band-strip and full-grid iteration counts differ")
    require(band_rel <= 1e-4, "band-strip and full-grid pressures differ by more than 1e-4")
    print(f"[5] bf16 fields: {res_h.iterations} iterations vs {res_k.iterations} with fp32 fields")
    require(res_h.converged and res_h.relative_residual <= 1e-5, "bf16-field solve did not converge")
    plain = free_surface.project(setup, velocity, config=config_t)
    _, p_rel = rel_err(result.pressure, plain.pressure)
    print(f"[5] kernel vs plain projection: iterations {iters} vs {plain.cg.iterations}, "
          f"pressure max relative difference {p_rel:.3e}")
    require(abs(iters - plain.cg.iterations) <= 1, "iteration counts differ by more than 1")
    require(p_rel <= 1e-3, "kernel and plain pressures differ by more than 1e-3")
    require(res_k.iterations == iters, "re-solve iteration count changed")
    # The bf16-field path through the projection, counted like phase 3.
    reset_counts()
    result_h = free_surface.project(setup, velocity, config=config_h)
    torch.cuda.synchronize()
    launches_h = read_counts()
    expected_h = expected_launches(hier, config_h, result_h.cg.iterations)
    print(f"[5] bf16-field projection: {result_h.cg.iterations} iterations, kernel launches "
          f"{launches_h}, expected {expected_h}")
    require(launches_h == expected_h, "bf16-field launch counts differ from the plan")
    require(launches_h["smoother_bf16"] > 0, "the bf16-field smoother never ran")
    require(result_h.cg.converged and bool(torch.isfinite(result_h.pressure).all()),
            "bf16-field projection failed")

    # One warm solve under torch.profiler: device time by kernel name, and
    # the device's busy share against the profiled and the best unprofiled
    # wall time.  With the program cache off: the profile reads the solve
    # whose CG loop is captured per solve (phase 16 times
    # the cached whole-solve program).
    from torch.autograd import DeviceType

    with graph.programs_off():
        mgpcg.solve(setup.problem, rhs, config=config)
        torch.cuda.synchronize()
        trace_dir = tempfile.mkdtemp(prefix="chip_smoke_trace_")
        with profiling.trace(trace_dir) as prof:
            t0 = time.perf_counter()
            mgpcg.solve(setup.problem, rhs, config=config)
            torch.cuda.synchronize()
            wall_prof = time.perf_counter() - t0
        trace_bytes = Path(trace_dir, "trace.json").stat().st_size
        print(f"[5] utils.profiling.trace wrote a Chrome trace of {trace_bytes:,} bytes")
        # The same solve under a second profiler session of this process, with
        # the launch counters beside it: does the profiler name the kernels
        # inside the CUDA graph's IF bodies in a later session too?
        reset_counts()
        with profiling.trace(trace_dir) as prof2:
            mgpcg.solve(setup.problem, rhs, config=config)
            torch.cuda.synchronize()
    shutil.rmtree(trace_dir)
    events2 = prof2.key_averages()
    print(f"[5] the same solve in a second profiler session: port kernels by name {port_kernels(events2)}, device "
          f"{sum(device_us(e) for e in events2 if getattr(e, 'device_type', None) == DeviceType.CUDA) / 1e3:.3f} ms; "
          f"launch counters (on the device) {read_counts()} [{card}]")
    device_ms, host_ms = {}, {}
    for e in prof.key_averages():
        if getattr(e, "device_type", None) != DeviceType.CUDA:
            host_ms[e.key] = (e.self_cpu_time_total / 1e3, e.count)
            continue
        us = getattr(e, "self_device_time_total", None)
        us = e.self_cuda_time_total if us is None else us
        device_ms[e.key] = (us / 1e3, e.count)
    total_ms = sum(ms for ms, _ in device_ms.values())
    if total_ms > 0:
        print(f"[5] profiled warm solve: device time {total_ms:.3f} ms over {len(device_ms)} kernel names, "
              f"{sum(n for _, n in device_ms.values())} device launches and copies, "
              f"wall {wall_prof * 1e3:.3f} ms profiled, {solves['kernels'][0] * 1e3:.3f} ms best unprofiled; "
              f"busy {total_ms / (wall_prof * 1e3):.3f} of the profiled wall, "
              f"{total_ms / (solves['kernels'][0] * 1e3):.3f} of the unprofiled [{card}]")
        for key, (ms, count) in sorted(device_ms.items(), key=lambda kv: -kv[1][0])[:16]:
            print(f"[5]   {ms:9.3f} ms {count:6d} launches  {key[:110]}")
        sums = sum(count for key, (_, count) in device_ms.items() if "sum_partials" in key)
        steps = [(ms, count) for key, (ms, count) in device_ms.items() if "cg_step_kernel" in key]
        print(f"[5] sum_partials launches {sums} (one per fine upstroke's dot: {iters + 1}; PR 4: 35 with the "
              f"CG steps'); CG step kernel {sum(ms for ms, _ in steps):.3f} ms in "
              f"{sum(n for _, n in steps)} launches (PR 4: 6.3 ms in 17) [{card}]")
        require(sums == iters + 1, "sum_partials launches differ from one per V-cycle")
        print(f"[5] host side of the profiled solve: {sum(ms for ms, _ in host_ms.values()):.3f} ms of self "
              f"CPU time in profiled host ops (the Python between them is not counted); the largest:")
        for key, (ms, count) in sorted(host_ms.items(), key=lambda kv: -kv[1][0])[:10]:
            print(f"[5]   {ms:9.3f} ms {count:6d} calls  {key[:80]}")
    else:
        print("[5] profiled warm solve: the profiler reported no device time (not measured)")

    # ---- 6. small fp64 projection vs a direct solve of the assembled system -----------
    m = 24
    cfg64 = SolverConfig(tolerance=1e-12, max_iterations=200)
    phi_s, vel_s = sdf.splash_scene((m, m, m), device=dev)
    setup_s = free_surface.build_setup(phi_s, sdf.open_box_weights((m, m, m), device=dev), config=cfg64)
    res_s = free_surface.project(setup_s, vel_s, config=cfg64)
    f = setup_s.problem.fine
    solv = f.solvable.cpu().numpy().ravel()
    diag = f.diag.cpu().numpy().ravel()
    shape = f.shape
    index = -np.ones(solv.size, dtype=np.int64)
    index[solv] = np.arange(int(solv.sum()))
    rows, cols, vals = [index[solv]], [index[solv]], [diag[solv]]
    strides = (shape[1] * shape[2], shape[2], 1)
    for axis, ew in enumerate((f.ew0, f.ew1, f.ew2)):
        e = ew.double().cpu().numpy().ravel()
        cells = np.flatnonzero(e != 0)
        rows += [index[cells], index[cells + strides[axis]]]
        cols += [index[cells + strides[axis]], index[cells]]
        vals += [-e[cells], -e[cells]]
    a = scipy.sparse.csr_matrix(
        (np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))),
        shape=(int(solv.sum()),) * 2,
    )
    rhs_s = free_surface.embed_window(
        free_surface.negative_divergence(setup_s.liquid_mask, tuple(v.double() for v in vel_s), setup_s.weights),
        setup_s.window_start, setup_s.base_pads, setup_s.expanded_shape,
    ).cpu().numpy().ravel()
    x_direct = scipy.sparse.linalg.spsolve(a.tocsc(), rhs_s[solv])
    x_port = res_s.cg.x.cpu().numpy().ravel()[solv]
    oracle = float(np.abs(x_port - x_direct).max() / np.abs(x_direct).max())
    print(f"[6] {m}^3 fp64 on the card: {res_s.cg.iterations} iters, vs direct sparse solve "
          f"max relative difference {oracle:.3e}")
    require(res_s.cg.converged and oracle <= 1e-9, "fp64 projection disagrees with the direct solve")
    # The fp64 chunk kernel against its plain version on this hierarchy.
    fp64_err = 0.0
    hier_s = setup_s.problem.hier
    for lv in mg.smoothed_levels(hier_s):
        c = hier_s.levels[lv]
        x, b = rand_field(c).double(), rand_field(c).double()
        blk = fused_smoother.level_blocks(c, cfg64)
        for case, kw in cases.items():
            xx = None if kw.get("x_is_zero") else x
            cfg_c = case_config(cfg64, case)
            got = as_tuple(fused_smoother.smooth_level(xx, b, c, cfg_c, blocks=blk, **kw))
            torch.cuda.synchronize()
            want = as_tuple(fused_smoother.smooth_level_torch(xx, b, c, cfg_c, blocks=blk, **kw))
            for i, (g, w) in enumerate(zip(got, want)):
                rel = rel_err(g, w)[1]
                fp64_err = max(fp64_err, rel)
                require(rel <= 1e-12, f"fp64 chunk kernel L{lv} {case} [{i}]: relative error {rel:.3e} > 1e-12")
        # The fp64 CG step and residual over the level's tiles.
        beta64 = torch.tensor(0.7371, dtype=torch.float64, device=dev)
        ops = (c.diag, c.ew0, c.ew1, c.ew2)
        got = fused_cg.search_matvec_dot(x, b, beta64, *ops, mode="cuda", tiles=blk.tiles)
        got = got + (fused_cg.residual(x, b, *ops, mode="cuda", tiles=blk.tiles),)
        torch.cuda.synchronize()
        want = fused_cg.search_matvec_dot_torch(x, b, beta64, *ops) + (fused_cg.residual_torch(x, b, *ops),)
        for i, (g, w) in enumerate(zip(got, want)):
            rel = rel_err(g, w)[1]
            fp64_err = max(fp64_err, rel)
            require(rel <= 1e-12, f"fp64 CG step / residual L{lv} [{i}]: relative error {rel:.3e} > 1e-12")
    print(f"[6] fp64 chunk kernel, CG step and residual vs plain on the {m}^3 hierarchy's smoothed levels: "
          f"max relative error {fp64_err:.3e} (limit 1e-12)")
    # The same projection with the Chebyshev smoother: every level's block
    # in plain PyTorch (no chunk-kernel launch), the CG step on the card.
    cfg_cheb = dataclasses.replace(cfg64, interior_smoother="chebyshev", chebyshev_degree=3)
    reset_counts()
    res_c = free_surface.project(setup_s, vel_s, config=cfg_cheb)
    torch.cuda.synchronize()
    launches_c = read_counts()
    x_cheb = res_c.cg.x.cpu().numpy().ravel()[solv]
    oracle_c = float(np.abs(x_cheb - x_direct).max() / np.abs(x_direct).max())
    print(f"[6] Chebyshev (degree 3) {m}^3 fp64: {res_c.cg.iterations} iters (GS: {res_s.cg.iterations}), vs direct "
          f"sparse solve max relative difference {oracle_c:.3e}; kernel launches {launches_c}")
    require(res_c.cg.converged and oracle_c <= 1e-9, "Chebyshev projection disagrees with the direct solve")
    require(launches_c["smoother"] == launches_c["smoother_bf16"] == 0, "the Chebyshev path launched the chunk kernel")
    require(launches_c["cg_step"] == res_c.cg.iterations > 0, "Chebyshev CG-step launches differ from the iterations")

    # ---- 7. the frame loop --------------------------------------------------------------
    frames_n = 4
    sim_cfg = config  # the CLI's --fp32 configuration (gmg-torch-simulate --fp32)
    phi0, vel0 = sdf.splash_scene((n, n, n), device=dev, dtype=torch.float32)
    per_frame, windows = [], []
    scratch = tempfile.mkdtemp(prefix="chip_smoke_")
    ckpt, ckpt2 = f"{scratch}/ckpt", f"{scratch}/ckpt_frame2"

    def on_frame(k, fr):
        per_frame.append(expected_launches(fr.setup.problem.hier, sim_cfg, fr.iterations, warm=k > 0))
        windows.append(fr.setup.expanded_shape)
        if k == 1:  # keep the frame-2 checkpoint (the frame-4 one replaces it)
            shutil.copytree(ckpt, ckpt2)
        print(f"[7] frame {k + 1}: {fr.iterations} iters, rel. residual {fr.relative_residual:.3e}, "
              f"max divergence {fr.max_divergence:.3e}, advect {fr.seconds['advect']:.3f} s, "
              f"setup {fr.seconds['setup']:.3f} s, project {fr.seconds['project']:.3f} s, "
              f"window {fr.setup.expanded_shape} {'kept' if fr.window_reused else 'new'} [{card}]")

    reset_counts()
    t0 = time.perf_counter()
    frames = simulate.run(phi0, vel0, weights, num_frames=frames_n, config=sim_cfg, on_frame=on_frame,
                          checkpoint_dir=ckpt, checkpoint_every=2)
    torch.cuda.synchronize()
    t_loop = time.perf_counter() - t0
    launches_loop = read_counts()
    expected_loop = {k: sum(e[k] for e in per_frame) for k in per_frame[0]}
    print(f"[7] {frames_n} frames in {t_loop:.3f} s ({t_loop / frames_n:.3f} s per frame); "
          f"kernel launches {launches_loop}, expected {expected_loop}")
    require(launches_loop == expected_loop, "frame-loop launch counts differ from the plan")
    for key in ("smoother", "cg_step", "residual"):
        require(launches_loop[key] > 0, f"the frame loop never launched {key}")
    for k, fr in enumerate(frames):
        require(fr.relative_residual <= sim_cfg.tolerance and fr.iterations < sim_cfg.max_iterations,
                f"frame {k + 1} did not converge")
        require(all(bool(torch.isfinite(t).all()) for t in (fr.liquid_phi, fr.pressure, *fr.velocity)),
                f"frame {k + 1}: non-finite field")
    t0 = time.perf_counter()
    plain_frames = simulate.run(phi0, vel0, weights, num_frames=2,
                                config=dataclasses.replace(sim_cfg, kernel_mode="torch"))
    torch.cuda.synchronize()
    t_plain = time.perf_counter() - t0
    for k, pf in enumerate(plain_frames):
        _, rel = rel_err(frames[k].pressure, pf.pressure)
        print(f"[7] frame {k + 1} kernels vs kernel_mode='torch': iterations {frames[k].iterations} "
              f"vs {pf.iterations}, pressure max relative difference {rel:.3e}")
        require(rel <= 1e-3, f"frame {k + 1}: kernel and plain pressures differ by more than 1e-3")
    print(f"[7] plain frames 1-2 in {t_plain:.3f} s [{card}]")
    # Checkpoint and resume: the frame-4 checkpoint reads back bit-equal; the
    # frame-2 one resumes frames 3-4.  Write and read timed apart on frame
    # 2's state (the same bytes as the loop's own checkpoint).
    f2 = frames[1]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    simulate.save_state(f"{scratch}/timed", 2, f2.liquid_phi, f2.velocity, f2.pressure)
    t_write = time.perf_counter() - t0
    t0 = time.perf_counter()
    frame_at, phi2, vel2, p2 = simulate.load_state(ckpt2)
    t_read = time.perf_counter() - t0
    names_on_disk = sorted(p.name for p in Path(ckpt2).glob("*.gmgf"))
    require(all(Path(f"{scratch}/timed/{f}").read_bytes() == Path(f"{ckpt2}/{f}").read_bytes()
                for f in names_on_disk), "a checkpoint of the same state differs byte for byte")
    disk = sum(Path(f"{ckpt2}/{f}").stat().st_size for f in names_on_disk)
    raw = nbytes(f2.liquid_phi, *f2.velocity, f2.pressure)
    last = simulate.load_state(ckpt)
    require(last[0] == frames_n and np.array_equal(last[1], frames[-1].liquid_phi.cpu().numpy())
            and np.array_equal(last[3], frames[-1].pressure.cpu().numpy()), "the frame-4 checkpoint differs")
    resumed_windows = []
    resumed = simulate.run(
        torch.as_tensor(phi2, device=dev), tuple(torch.as_tensor(v, device=dev) for v in vel2), weights,
        num_frames=2, config=sim_cfg, start_frame=frame_at, old_pressure=torch.as_tensor(p2, device=dev),
        on_frame=lambda k, fr: resumed_windows.append(fr.setup.expanded_shape),
    )
    torch.cuda.synchronize()
    print(f"[7] checkpoint of frame {frame_at}: {len(names_on_disk)} fields, {disk:,} bytes on disk against "
          f"{raw:,} raw ({disk / raw:.3f}); write {t_write:.3f} s, read {t_read:.3f} s [{card}]")
    require(frame_at == 2 and torch.equal(resumed[0].liquid_phi, frames[2].liquid_phi),
            "the resumed frame 3's phi is not bit-equal to the straight run's")
    for k, (rf, sf) in enumerate(zip(resumed, frames[2:]), start=3):
        _, rel = rel_err(rf.pressure, sf.pressure)
        print(f"[7] resumed frame {k}: {rf.iterations} iters (straight {sf.iterations}), pressure max relative "
              f"difference {rel:.3e}, window {resumed_windows[k - 3]} (straight {windows[k - 1]})")
        require(abs(rf.iterations - sf.iterations) <= 1, f"resumed frame {k}: iterations differ by more than 1")
        require(rel <= 1e-3, f"resumed frame {k}: pressure differs by more than 1e-3")
    shutil.rmtree(scratch)

    # ---- 8. the block-sharded path on a one-card block mesh ---------------------------
    mesh = parallel.make_mesh(4, device=dev)
    flags = mg.level_flags(hier, config, mesh)
    geoms = {}
    for lv, c in enumerate(hier.levels):
        line = f"[8] L{lv} {tuple(c.shape)} on {mesh.shape}: {flags[lv]}"
        if flags[lv] == "sharded":
            geoms[lv] = geom = halo.geometry(mesh, c.shape)
            stacked = geom.stacked_shape
            line += (f", {geom.blocks} blocks of {geom.core} cores + {halo.H}-cell halos, stacked "
                     f"{stacked} = {np.prod(stacked) / c.diag.numel():.3f}x the level")
        print(line)
    require(flags[0] == "sharded", f"the fine level {tuple(hier.levels[0].shape)} does not split on "
            f"{mesh.shape}; run at a size whose window splits (the default 256)")
    sharded_levels = [lv for lv in mg.smoothed_levels(hier) if flags[lv] == "sharded"]
    pre = {lv: fused_sharded.prehalo_coeffs(hier.levels[lv], mesh) for lv in sharded_levels}
    sblk = {lv: fused_sharded.stacked_blocks(pre[lv]) for lv in sharded_levels}
    for lv, blk in sblk.items():
        t = blk.tiles
        print(f"[8] L{lv} stacked grid: chunk depth {t.depth}, tile {t.core}, active tiles "
              f"{lengths(t)[0]}/{n_tiles(t)} = {lengths(t)[0] / n_tiles(t):.3f}, "
              f"{lengths(t)[2]:,} band cells")
    pre_cg = fused_sharded.prehalo_cg_coeffs(fine, mesh)
    cg_tiles_s = fused_sharded.stacked_cg_tiles(pre_cg)
    print(f"[8] L0 stacked grid, CG step: tile {cg_tiles_s.core}, active tiles {lengths(cg_tiles_s)[0]}/"
          f"{n_tiles(cg_tiles_s)} = {lengths(cg_tiles_s)[0] / n_tiles(cg_tiles_s):.3f}")
    print(f"[8] stacked coefficients per solve: smoother "
          f"{sum(nbytes(*(t for t in pc if t is not None)) for pc in pre.values()) / 1e9:.3f} GB, "
          f"CG operator {nbytes(*pre_cg) / 1e9:.3f} GB")

    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    result_m = free_surface.project(setup, velocity, config=config, mesh=mesh)
    torch.cuda.synchronize()
    t_mesh = time.perf_counter() - t0
    launches_m = read_counts()
    iters_m = result_m.cg.iterations
    expected_m = expected_launches(hier, config, iters_m, mesh=mesh)
    print(f"[8] project(mesh={mesh.shape}): {t_mesh:.2f} s, {iters_m} iterations, relative residual "
          f"{result_m.cg.relative_residual:.3e}, max divergence {float(result_m.max_divergence):.3e}, "
          f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    print(f"[8] kernel launches {launches_m}, expected {expected_m}")
    require(launches_m == expected_m, "block-mesh launch counts differ from what the flags imply")
    for key in ("smoother_sharded", "halo", "cg_step_sharded"):
        require(launches_m[key] > 0, f"the block-mesh path never launched {key}")
    require(result_m.cg.converged and result_m.cg.relative_residual <= 1e-5,
            "the block-mesh projection did not converge to 1e-5")
    require(bool(torch.isfinite(result_m.pressure).all()) and tuple(result_m.pressure.shape) == (n, n, n),
            "block-mesh pressure")
    _, mesh_rel = rel_err(result_m.pressure, result.pressure)
    print(f"[8] block mesh vs single device: iterations {iters_m} vs {iters}, pressure max relative "
          f"difference {mesh_rel:.3e}")
    require(abs(iters_m - iters) <= 1, "block-mesh and single-device iterations differ by more than 1")
    require(mesh_rel <= 1e-4, "block-mesh and single-device pressures differ by more than 1e-4")

    # Each block-mesh kernel against its plain version (the same functions with
    # kernel_mode="torch") and against the single-device kernel, at every
    # sharded level; the halo kernels on each dtype the path copies.
    single_diff = 0.0
    for lv in sharded_levels:
        c, geom = hier.levels[lv], geoms[lv]
        for t in (rand_field(c), c.ew0, c.band):
            got = halo.halo_gather(t, geom, "cuda")
            back = halo.core_scatter(got, geom, "cuda")
            torch.cuda.synchronize()
            want = halo.halo_gather_torch(t, geom)
            errs["halo"] = max(errs["halo"], float((got.double() - want.double()).abs().max()))
            require(torch.equal(got, want), f"L{lv} halo gather of {t.dtype} differs from plain")
            require(torch.equal(back, t) and torch.equal(back, halo.core_scatter_torch(got, geom)),
                    f"L{lv} core scatter of {t.dtype} differs from plain")
        x, b = rand_field(c), rand_field(c)
        pre_t = fused_sharded.prehalo_coeffs(c, mesh, "torch")
        for case, kw in cases.items():
            xx = None if kw.get("x_is_zero") else x
            key = f"L{lv} {case}"
            got = as_tuple(fused_sharded.smooth_level_sharded(
                xx, b, c, case_config(config, case), mesh=mesh, prehaloed=pre[lv], blocks=sblk[lv], **kw))
            torch.cuda.synchronize()
            want = as_tuple(fused_sharded.smooth_level_sharded(
                xx, b, c, case_config(config_t, case), mesh=mesh, prehaloed=pre_t, **kw))
            single = as_tuple(fused_smoother.smooth_level(xx, b, c, case_config(config_full, case), **kw))
            for i, (g, w, s) in enumerate(zip(got, want, single)):
                tol = grid_tol if g.dim() else dot_tol
                check("smoother_sharded", f"{key} [{i}] vs plain", g, w, tol)
                single_diff = max(single_diff, rel_err(g, s)[1])
                require(rel_err(g, s)[1] <= tol, f"block-mesh {key} [{i}] differs from the single-device kernel")
    zf, pf = rand_field(fine), rand_field(fine)
    got = fused_sharded.cg_step_sharded(zf, pf, beta, fine, config, mesh, prehaloed_cg=pre_cg, tiles=cg_tiles_s)
    torch.cuda.synchronize()
    pre_cg_t = fused_sharded.prehalo_cg_coeffs(fine, mesh, "torch")
    want = fused_sharded.cg_step_sharded(zf, pf, beta, fine, config_t, mesh, prehaloed_cg=pre_cg_t)
    single = fused_cg.search_matvec_dot(zf, pf, beta, fine.diag, fine.ew0, fine.ew1, fine.ew2, mode="cuda")
    for what_, g, w, s in zip(("p'", "Ap'", "<p', Ap'>"), got, want, single):
        tol = grid_tol if g.dim() else dot_tol
        check("cg_step_sharded", f"{what_} vs plain", g, w, tol)
        single_diff = max(single_diff, rel_err(g, s)[1])
        require(rel_err(g, s)[1] <= tol, f"block-mesh CG step {what_} differs from the single-device kernel")
    print(f"[8] block-mesh kernels vs plain: max abs grid errors "
          f"{ {k: errs[k] for k in names[5:]} }, max relative dot errors "
          f"{ {k: dot_errs[k] for k in names[6:]} }; vs the single-device kernels: max relative "
          f"difference {single_diff:.3e}")

    # Times at the fine level: one gather of an fp32 field, the fine upstroke
    # block with the rho dot (gathers, passes and scatter), one CG step.
    geom0 = geoms[0]
    (bx, by), (hx, hy) = geom0.core, geom0.halo
    pre0_t = fused_sharded.prehalo_coeffs(c0, mesh, "torch")

    def library_gather():
        padded = torch.nn.functional.pad(x0f, (0, 0, hy, hy, hx, hx))
        view = padded.unfold(0, bx + 2 * hx, bx).unfold(1, by + 2 * hy, by)
        return view.permute(0, 1, 3, 4, 2).contiguous().view(geom0.stacked_shape)

    require(torch.equal(library_gather(), halo.halo_gather(x0f, geom0)), "library gather differs")
    times["halo"] = (cuda_ms(lambda: halo.halo_gather(x0f, geom0, "cuda"), reps),
                     cuda_ms(lambda: halo.halo_gather_torch(x0f, geom0), reps))
    library["halo"] = cuda_ms(library_gather, reps)
    times["smoother_sharded"] = (
        cuda_ms(lambda: fused_sharded.smooth_level_sharded(
            x0f, b0f, c0, config, False, mesh, prehaloed=pre[0], blocks=sblk[0], emit_dot=True), reps),
        cuda_ms(lambda: fused_sharded.smooth_level_sharded(
            x0f, b0f, c0, config_t, False, mesh, prehaloed=pre0_t, emit_dot=True), reps),
    )
    times["cg_step_sharded"] = (
        cuda_ms(lambda: fused_sharded.cg_step_sharded(
            z, p, beta, fine, config, mesh, prehaloed_cg=pre_cg, tiles=cg_tiles_s), reps),
        cuda_ms(lambda: fused_sharded.cg_step_sharded(z, p, beta, fine, config_t, mesh, prehaloed_cg=pre_cg_t), reps),
    )
    # The block-mesh step in its parts: the two gathers, the step on the
    # stacked grid, the two scatters.
    zh, ph = halo.halo_gather(z, geom0, "cuda"), halo.halo_gather(p, geom0, "cuda")
    pnh, aph, _ = fused_cg.search_matvec_dot(zh, ph, beta, *pre_cg, mode="cuda", window=geom0.window,
                                             tiles=cg_tiles_s)
    parts_ms = {
        "2 gathers": cuda_ms(lambda: (halo.halo_gather(z, geom0, "cuda"), halo.halo_gather(p, geom0, "cuda")), reps),
        "step": cuda_ms(lambda: fused_cg.search_matvec_dot(
            zh, ph, beta, *pre_cg, mode="cuda", window=geom0.window, tiles=cg_tiles_s), reps),
        "2 scatters": cuda_ms(lambda: (halo.core_scatter(pnh, geom0, "cuda"), halo.core_scatter(aph, geom0, "cuda")),
                              reps),
    }
    print(f"[8] block-mesh CG step {times['cg_step_sharded'][0]:.4f} ms (recorded for PR 4: 0.8618 ms): "
          f"{', '.join(f'{k} {v:.4f} ms' for k, v in parts_ms.items())} [{card}]")
    # One core scatter (halo.cu's core_scatter) against its own bounds:
    # reads of the stacked cores (on the solvable cells, or all of them)
    # and the write of the global field.
    scatter_ms = cuda_ms(lambda: halo.core_scatter(pnh, geom0, "cuda"), reps)
    scatter_s = bound(active_bytes(nsf, (z,), z.numel(), (z,)), 0)
    scatter_w = bound(2 * nbytes(z), 0)
    print(f"[8] core_scatter of one fp32 L0 field {scatter_ms:.4f} ms, bound over the solvable cells "
          f"{scatter_s[0]:.4f} ms ({scatter_s[0] / scatter_ms:.0%}), over the whole window {scatter_w[0]:.4f} ms "
          f"({scatter_w[0] / scatter_ms:.0%}) [{card}]")
    p0 = pre[0]
    stacked0 = p0.band.numel()
    stacked_in = (p0.inv_diag, p0.ew0, p0.ew1, p0.ew2, p0.band)
    nb_s = int(torch.count_nonzero(p0.band))
    ns_s = int(torch.count_nonzero(p0.inv_diag))  # the stacked solvable cells, halo copies included
    bounds_window["halo"] = bound(nbytes(x0f) + x0f.element_size() * stacked0, 0)
    bounds_window["smoother_sharded"] = bound(
        nbytes(x0f, b0f, *stacked_in, x0f), block_ops(upstroke, stacked0, nb_s, True),
    )
    bounds_window["cg_step_sharded"] = bound(nbytes(z, p, *pre_cg, z, p), OPS_CG_STEP * stacked0)
    bounds["halo"] = bound(active_bytes(ns0, (x0f,), stacked0, (x0f,)), 0)
    bounds["smoother_sharded"] = bound(
        active_bytes(ns0, (x0f, b0f), n0, (x0f,)) + active_bytes(ns_s, stacked_in, 0, ()),
        block_ops(upstroke, ns_s, nb_s, True),
    )
    bounds["cg_step_sharded"] = bound(
        active_bytes(nsf, (z, p), fine.diag.numel(), (z, p)) + active_bytes(ns_s, pre_cg, 0, ()),
        OPS_CG_STEP * ns_s,
    )
    what.update(halo="halo gather of one fp32 field",
                smoother_sharded="block-mesh fine upstroke block + dot (gathers, 8 passes, scatter)",
                cg_step_sharded="block-mesh CG step (gathers, step, scatters)")
    for name in names[5:]:
        k_ms, p_ms = times[name]
        lib = "" if library[name] is None else f", library {library[name]:.4f} ms"
        print(f"[8] {name} at {tuple(c0.shape)}, {what[name]}: kernel {k_ms:.4f} ms, plain "
              f"{p_ms:.4f} ms{lib}, bound over the solvable cells {bounds[name][0]:.4f} ms ({bounds[name][1]}), "
              f"over the whole window {bounds_window[name][0]:.4f} ms ({bounds_window[name][1]}) [{card}]")

    # Whole solves, single device and block mesh in turns.
    order = (None, mesh, mesh, None, None, mesh)
    best_m = {None: float("inf"), mesh: float("inf")}
    for m in order:
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = mgpcg.solve(setup.problem, rhs, config=config, mesh=m)
        torch.cuda.synchronize()
        best_m[m] = min(best_m[m], time.perf_counter() - t)
        require(res.converged, "a timed solve did not converge")
    print(f"[8] solve best of 3: single device {best_m[None]:.4f} s, block mesh {mesh.shape} "
          f"{best_m[mesh]:.4f} s ({best_m[mesh] / best_m[None]:.2f}x) [{card}]")

    # ---- 9. the fused frame loop ---------------------------------------------------------
    # run_fused: one chunk of 4 frames on the geometry frozen from the input
    # state; every frame rebuilds its hierarchy and coarse inverse on the
    # card.  Frame 1 warm-starts from a zero pressure, so it launches the
    # residual kernel where run()'s cold start does not.
    geom_hier = free_surface.build_setup(phi0, weights, config=sim_cfg).problem.hier
    chunks = []
    reset_counts()
    t0 = time.perf_counter()
    phi_f, vel_f, p_f, stats_f = simulate.run_fused(
        phi0, vel0, weights, num_frames=frames_n, config=sim_cfg, chunk=frames_n,
        on_chunk=lambda done, st: chunks.append(done),
    )
    torch.cuda.synchronize()
    t_fused_first = time.perf_counter() - t0
    launches_fused = read_counts()
    iters_f = [int(i) for i in stats_f["iterations"]]
    plan = [expected_launches(geom_hier, sim_cfg, it, warm=True) for it in iters_f]
    expected_fused = {k: sum(e[k] for e in plan) for k in plan[0]}
    print(f"[9] run_fused, {frames_n} frames in chunks of {frames_n}: {t_fused_first:.3f} s (first call); chunks "
          f"run fused {chunks}; iterations {iters_f} (run(): {[fr.iterations for fr in frames]}); kernel "
          f"launches {launches_fused}, expected {expected_fused}")
    require(chunks == [frames_n], "the chunk did not run fused (re-run through run())")
    require(launches_fused == expected_fused, "fused-frame launch counts differ from the plan")
    for key in ("smoother", "cg_step", "residual"):
        require(launches_fused[key] > 0, f"the fused frames never launched {key}")
    require(all(abs(a - fr.iterations) <= 1 for a, fr in zip(iters_f, frames)),
            "fused-frame iterations differ from run()'s by more than 1")
    require(all(r <= sim_cfg.tolerance for r in stats_f["relative_residual"]), "a fused frame did not converge")
    for what_, got, want in (("pressure", p_f, frames[-1].pressure), ("phi", phi_f, frames[-1].liquid_phi),
                             *((f"velocity {a}", vel_f[a], frames[-1].velocity[a]) for a in range(3))):
        _, rel = rel_err(got, want)
        print(f"[9] frame {frames_n} {what_}: run_fused vs run() max relative difference {rel:.3e}")
        require(bool(torch.isfinite(got).all()) and rel <= 1e-3, f"fused frame {frames_n}: {what_} differs")

    # Seconds per frame, the two paths in turns, twice; each call ends on a
    # device sync.
    per_path, runs9, why9 = {"run()": [], "run_fused": []}, [], []
    for _ in range(2):
        for tag in per_path:
            graph.STATS.reset()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if tag == "run()":
                runs9.append(simulate.run(phi0, vel0, weights, num_frames=frames_n, config=sim_cfg))
            else:
                simulate.run_fused(phi0, vel0, weights, num_frames=frames_n, config=sim_cfg, chunk=frames_n)
            torch.cuda.synchronize()
            per_path[tag].append((time.perf_counter() - t0) / frames_n)
            st = graph.STATS
            why9.append(f"{tag} program captures {dict(st.program_captures)} in "
                        f"{sum(st.program_capture_seconds.values()):.3f} s, frame captures {st.frame_captures} in "
                        f"{st.frame_capture_seconds + st.frame_instantiate_seconds:.3f} s, CG-loop captures "
                        f"{st.captures}, cache releases {st.cache_releases}")
    for tag, ts in per_path.items():
        print(f"[9] {tag}: {min(ts):.4f} s per frame at {n}^3, best of 2 in turns "
              f"(each: {', '.join(f'{t:.4f}' for t in ts)}) [{card}]")
    print(f"[9] by turn: {'; '.join(why9)}")
    # Host syncs per frame of each path.
    sites9 = {}
    for tag, fn in (("run()", lambda: simulate.run(phi0, vel0, weights, num_frames=frames_n, config=sim_cfg)),
                    ("run_fused", lambda: simulate.run_fused(phi0, vel0, weights, num_frames=frames_n,
                                                             config=sim_cfg, chunk=frames_n))):
        _, sites = sites9[tag] = count_syncs(fn)
        total = sum(sites.values())
        print(f"[9] {tag}: {total / frames_n:.1f} host syncs per frame ({total} in {frames_n} frames), by source "
              f"line: {dict(sites.most_common(12))}")

    # At frame 1's geometry: the coarse system on the card (coarse_system_device,
    # run_fused's) against the host path (coarse_system: scipy assembly, fp64
    # inverse on the host), and the two timed with their syncs.  The setup's
    # own coarse inverse (coarse_system_card, build_setup's card path) must
    # be the same bits as coarse_system_device's.
    s1 = free_surface.build_setup(frames[0].liquid_phi, weights, config=sim_cfg)
    levels1, flags1, label_levels1 = window_levels(frames[0].liquid_phi, s1, sim_cfg)
    mg_dtype = sim_cfg.mg_dtype_resolved
    card_hier = s1.problem.hier
    nd_pad1 = card_hier.coarse_minv.shape[0]
    require(nd_pad1 > 0, "the card coarse system is not a dense inverse")
    dofs_h1, minv_h1, _ = mg.coarse_system(label_levels1[-1], mg_dtype, dev)
    coarse_ms = {"host": [], "card": []}
    for _ in range(3):
        for tag in coarse_ms:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if tag == "host":
                mg.coarse_system(label_levels1[-1], mg_dtype, dev)
            else:
                mg.coarse_system_device(levels1[-1], nd_pad1)
            torch.cuda.synchronize()
            coarse_ms[tag].append((time.perf_counter() - t0) * 1e3)
    _, host_syncs = count_syncs(lambda: mg.coarse_system(label_levels1[-1], mg_dtype, dev))
    (dofs1, minv1, ndof1), card_syncs = count_syncs(lambda: mg.coarse_system_device(levels1[-1], nd_pad1))
    again1 = mg.coarse_system_device(levels1[-1], nd_pad1)
    torch.cuda.synchronize()
    bit_equal = all(torch.equal(a, b) for a, b in zip((dofs1, minv1, ndof1), again1))
    setup_equal = torch.equal(card_hier.coarse_minv, minv1) and torch.equal(card_hier.coarse_dofs, dofs1)
    _, minv_rel = rel_err(minv1, minv_h1)
    c_last = card_hier.levels[-1]
    host_hier1 = card_hier._replace(coarse_dofs=dofs_h1, coarse_minv=minv_h1)
    r1 = torch.where(c_last.solvable, torch.randn(c_last.shape, generator=gen, device=dev), 0.0)
    _, solve_rel = rel_err(mg.coarse_solve(card_hier._replace(coarse_dofs=dofs1, coarse_minv=minv1), r1),
                           mg.coarse_solve(host_hier1, r1))
    print(f"[9] frame 1's coarse system ({int(ndof1)} DOFs, bucket {nd_pad1}): on the card vs the host's "
          f"max relative |dminv| {minv_rel:.3e}, coarse_solve of a random vector {solve_rel:.3e}; slot maps "
          f"equal {torch.equal(dofs1, dofs_h1)}; two card builds bit-equal {bit_equal}; the setup's "
          f"(coarse_system_card) bit-equal to it {setup_equal}")
    print(f"[9] coarse factorization, best of 3: host (coarse_system) {min(coarse_ms['host']):.2f} ms with "
          f"{sum(host_syncs.values())} host syncs, card (coarse_system_device) {min(coarse_ms['card']):.2f} ms "
          f"with {sum(card_syncs.values())}; each: host {[round(t, 2) for t in coarse_ms['host']]}, card "
          f"{[round(t, 2) for t in coarse_ms['card']]} [{card}]")
    require(bit_equal and torch.equal(dofs1, dofs_h1), "coarse system on the card: not reproducible")
    require(setup_equal, "the setup's coarse inverse differs from coarse_system_device's")
    # An fp32 LU inverse against an fp64 one rounded to fp32: the gap grows
    # with the coarse system's condition number.
    require(minv_rel <= 1e-2 and solve_rel <= 1e-2, "the card's coarse inverse differs from the host's")

    # ---- 10. the test node, the stage profiler and the assembled baseline ------------------
    # The reference's test scene (testMultigrid.hip, gridSize 128) expands to
    # a 256^3 domain with 6 levels; the test node solves in fp64.
    node = max(n // 2, 16)
    cfg_node = SolverConfig(tolerance=1e-5, max_iterations=1000)
    cfg_node_t = dataclasses.replace(cfg_node, kernel_mode="torch")
    base_n, weights_n = diagnostics.build_complex_domain(node, use_solid_sphere=True)
    labels_n, exp_w_n, offset_n, levels_n = diagnostics.expand(base_n, weights_n)
    problem_n = mgpcg.build_problem(labels_n, exp_w_n, levels_n, cfg_node, device=dev)
    hier_n = problem_n.hier
    print(f"[10] test node gridSize {node}: expanded {labels_n.shape}, {levels_n} levels "
          f"{[tuple(c.shape) for c in hier_n.levels]}, fp64")

    def sum_counts(*dicts):
        return {k: sum(d[k] for d in dicts) for k in dicts[0]}

    # [10a] The CG block: MGPCG on the card against the host's assembled CG.
    cg_kw = dict(grid_size=node, use_complex_domain=True, use_solid_sphere=True, tolerance=1e-5,
                 max_iterations=1000, device=dev)
    reset_counts()
    r_cg = diagnostics.run_conjugate_gradient_test(**cg_kw)
    torch.cuda.synchronize()
    launches_10a = read_counts()
    expected_10a = expected_launches(hier_n, cfg_node, r_cg["iterations"])
    print(f"[10a] CG block: {r_cg['dofs']:,} DOFs, {r_cg['iterations']} iterations, recomputed relative L2 "
          f"{r_cg['relative_l2']:.3e}, L-inf {r_cg['l_infinity']:.3e}; grid {r_cg['grid_seconds']:.4f} s against "
          f"the oracle's {r_cg['oracle_seconds']:.4f} s; max relative difference vs oracle "
          f"{r_cg['max_relative_difference_vs_oracle']:.3e} [{card}]")
    print(f"[10a] kernel launches {launches_10a}, expected {expected_10a}")
    require(launches_10a == expected_10a, "CG block launch counts differ from the plan")
    require(r_cg["relative_l2"] <= 1e-5, "CG block: recomputed relative residual above 1e-5")
    require(r_cg["max_relative_difference_vs_oracle"] <= 1e-3, "CG block disagrees with the assembled oracle")
    r_cg_t = diagnostics.run_conjugate_gradient_test(**cg_kw, kernel_mode="torch")
    r_cg_dx = diagnostics.run_conjugate_gradient_test(**cg_kw, dx=1.0 / node)
    dx_rel = abs(r_cg_dx["relative_l2"] - r_cg["relative_l2"]) / r_cg["relative_l2"]
    print(f"[10a] kernel_mode='torch': {r_cg_t['iterations']} iterations, relative L2 {r_cg_t['relative_l2']:.3e}, "
          f"grid {r_cg_t['grid_seconds']:.4f} s; dx=1/{node}: relative L2 {r_cg_dx['relative_l2']:.3e} "
          f"({dx_rel:.3e} relative to dx=1), L-inf {r_cg_dx['l_infinity']:.3e} in physical units")
    require(r_cg_t["iterations"] == r_cg["iterations"], "CG block: kernel and plain iterations differ")
    require(dx_rel <= 1e-9, "CG block: the dx round trip changed the relative residual")
    # The block's solve once more, kernels and plain, to hold the solutions
    # against each other (the block returns none).
    rhs_n = torch.as_tensor(diagnostics.delta_spike_rhs(
        labels_n.shape, solvable=problem_n.fine.solvable.cpu().numpy(), offset=offset_n,
        base_shape=base_n.shape), device=dev)
    x_k = mgpcg.solve(problem_n, rhs_n, config=cfg_node)
    x_p = mgpcg.solve(problem_n, rhs_n, config=cfg_node_t)
    _, node_rel = rel_err(x_k.x, x_p.x)
    print(f"[10a] the block's solve, kernels vs plain: iterations {x_k.iterations} vs {x_p.iterations}, "
          f"solution max relative difference {node_rel:.3e}")
    require(x_k.iterations == x_p.iterations == r_cg["iterations"] and node_rel <= 1e-9,
            "CG block: kernel and plain solutions differ by more than 1e-9")
    # The fp64 kernels at the test node's fine window, against their plain
    # versions and timed beside them (phase 4 times the fp32 ones at the
    # bench window).
    c_n = hier_n.levels[0]
    blk_n = fused_smoother.level_blocks(c_n, cfg_node)
    xn, bn = rand_field(c_n).double(), rand_field(c_n).double()
    ops_n = (c_n.diag, c_n.ew0, c_n.ew1, c_n.ew2)
    beta_n = torch.tensor(0.7371, dtype=torch.float64, device=dev)
    fp64_node_err = 0.0
    for case, kw in cases.items():
        xx = None if kw.get("x_is_zero") else xn
        cfg_c = case_config(cfg_node, case)
        got = as_tuple(fused_smoother.smooth_level(xx, bn, c_n, cfg_c, blocks=blk_n, **kw))
        want = as_tuple(fused_smoother.smooth_level_torch(xx, bn, c_n, cfg_c, blocks=blk_n, **kw))
        fp64_node_err = max([fp64_node_err] + [rel_err(g, w)[1] for g, w in zip(got, want)])
    got = fused_cg.search_matvec_dot(xn, bn, beta_n, *ops_n, mode="cuda", tiles=blk_n.tiles)
    got = got + (fused_cg.residual(xn, bn, *ops_n, mode="cuda", tiles=blk_n.tiles),)
    want = fused_cg.search_matvec_dot_torch(xn, bn, beta_n, *ops_n) + (fused_cg.residual_torch(xn, bn, *ops_n),)
    fp64_node_err = max([fp64_node_err] + [rel_err(g, w)[1] for g, w in zip(got, want)])
    print(f"[10a] fp64 chunk kernel (every case), CG step and residual vs plain at {tuple(c_n.shape)}: max relative "
          f"error {fp64_node_err:.3e} (limit 1e-12); active tiles {lengths(blk_n.tiles)[0]}/{n_tiles(blk_n.tiles)}")
    require(fp64_node_err <= 1e-12, "fp64 kernels at the test node's window differ from plain")
    ns_n, nc_n = int(c_n.solvable.sum()), c_n.diag.numel()
    node_rows = {
        "smoother": (
            lambda: fused_smoother.smooth_level(xn, bn, c_n, cfg_node, False, emit_dot=True, blocks=blk_n),
            lambda: fused_smoother.smooth_level_torch(xn, bn, c_n, cfg_node, False, emit_dot=True, blocks=blk_n),
            bound(active_bytes(ns_n, (xn, bn, c_n.inv_diag, *ops_n[1:], c_n.band), nc_n, (xn,)),
                  block_ops(upstroke, ns_n, lengths(blk_n.tiles)[2], True)),
        ),
        "cg_step": (
            lambda: fused_cg.search_matvec_dot(xn, bn, beta_n, *ops_n, mode="cuda", tiles=blk_n.tiles),
            lambda: fused_cg.search_matvec_dot_torch(xn, bn, beta_n, *ops_n),
            bound(active_bytes(ns_n, (xn, bn, *ops_n), nc_n, (xn, bn)), OPS_CG_STEP * ns_n),
        ),
        "residual": (
            lambda: fused_cg.residual(xn, bn, *ops_n, mode="cuda", tiles=blk_n.tiles),
            lambda: fused_cg.residual_torch(xn, bn, *ops_n),
            bound(active_bytes(ns_n, (xn, bn, *ops_n), nc_n, (xn,)), OPS_RESIDUAL * ns_n),
        ),
    }
    for name, (kern, plain_fn, (b_ms, b_by)) in node_rows.items():
        k_ms, p_ms = cuda_ms(kern, reps), cuda_ms(plain_fn, reps)
        print(f"[10a] fp64 {name} at {tuple(c_n.shape)} ({ns_n:,} solvable cells, {ns_n / nc_n:.3f} of the window): "
              f"kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, bound over the solvable cells {b_ms:.4f} ms ({b_by}); "
              f"fp32 at the bench window (phase 4): {times[name][0]:.4f} ms [{card}]")

    # [10b] The one-level V-cycle block: 50 warm-started cycles, each forming
    # its fine residual apart.
    cycles = 50
    labels_s, _, _, levels_s = diagnostics.expand(diagnostics.build_simple_domain(node))
    hier_s1 = mg.build_hierarchy(labels_s, None, levels_s, cfg_node, device=dev)
    blocks_s1 = mg.hierarchy_block_lists(hier_s1, cfg_node)
    per_cycle = sum(
        len(fused_smoother.chunk_plan(len(fused_smoother.schedule_for(cfg_node, fwd)), blocks_s1[lv].tiles.depth))
        for lv in mg.smoothed_levels(hier_s1) for fwd in (True, False)
    )
    reset_counts()
    t0 = time.perf_counter()
    r_v = diagnostics.run_one_level_vcycle_test(grid_size=node, num_cycles=cycles, device=dev)
    torch.cuda.synchronize()
    t_v = time.perf_counter() - t0
    launches_10b = read_counts()
    expected_10b = dict.fromkeys(launches_10b, 0)
    expected_10b.update(smoother=per_cycle * cycles, residual=cycles)
    r_v_t = diagnostics.run_one_level_vcycle_test(grid_size=node, num_cycles=cycles, kernel_mode="torch", device=dev)
    checked = [i for i, w in enumerate(r_v_t["l2"]) if w > 1e-10 * r_v_t["l2"][0]]
    v_rel = max(abs(r_v["l2"][i] - r_v_t["l2"][i]) / r_v_t["l2"][i] for i in checked)
    l2_v = r_v["l2"]
    factors_v = [b / a for a, b in zip(l2_v, l2_v[1:])]
    first8 = float(np.mean(factors_v[:8]))
    print(f"[10b] one-level V-cycle block, {cycles} cycles on {hier_s1.num_levels} levels in {t_v:.3f} s: L2 "
          f"{l2_v[0]:.3e} -> {l2_v[-1]:.3e}; mean convergence factor {r_v['mean_convergence_factor']:.4f} over all "
          f"{cycles}, {first8:.4f} over the first 8 (the JAX package's test length), {factors_v[-1]:.4f} in the "
          f"last; per cycle {[round(f, 3) for f in factors_v]}; vs plain: max relative L2 difference "
          f"{v_rel:.3e} over the {len(checked)} cycles above 1e-10 of the first [{card}]")
    print(f"[10b] kernel launches {launches_10b}, expected {expected_10b}")
    # The JAX package's bound, over its test's 8 cycles: the asymptotic
    # factor of this V(1,1) cycle grows with the grid (0.425 at gridSize 32,
    # 0.482 at 64, in both packages) and passes 0.5 at 128 (0.526).
    require(first8 < 0.5, "one-level V-cycle: the first 8 cycles converge slower than 0.5 per cycle")
    require(l2_v[-1] < 1e-10 * l2_v[0], "one-level V-cycle: 50 cycles did not reach 1e-10 of the initial error")
    require(launches_10b == expected_10b, "one-level V-cycle launch counts differ from the plan")
    require(v_rel <= 1e-9, "one-level V-cycle: kernel and plain L2 differ by more than 1e-9")

    # [10c] The smoother block: the chunk kernel entered with a nonzero x.
    iters_s = 20
    reset_counts()
    r_s = diagnostics.run_smoother_test(grid_size=node, max_smoother_iterations=iters_s, device=dev)
    torch.cuda.synchronize()
    launches_10c = read_counts()
    expected_10c = dict.fromkeys(launches_10c, 0)
    expected_10c["smoother"] = iters_s * len(fused_smoother.chunk_plan(
        len(fused_smoother.schedule_for(cfg_node, True)), fused_smoother.CHUNK_DEPTH))
    r_s_t = diagnostics.run_smoother_test(grid_size=node, max_smoother_iterations=iters_s, kernel_mode="torch",
                                          device=dev)
    s_rel = max(abs(a - b) / b for a, b in zip(r_s["residual_l2"], r_s_t["residual_l2"]))
    print(f"[10c] smoother block, {iters_s} iterations: residual L2 {r_s['residual_l2'][0]:.4e} -> "
          f"{r_s['residual_l2'][-1]:.4e} (vs plain: max relative difference {s_rel:.3e}); block "
          f"{r_s['avg_smooth_seconds'] * 1e3:.3f} ms (plain {r_s_t['avg_smooth_seconds'] * 1e3:.3f} ms), "
          f"boundary phase {r_s['avg_boundary_phase_seconds'] * 1e3:.3f} ms, interior phase "
          f"{r_s['avg_interior_phase_seconds'] * 1e3:.3f} ms (plain stencil ops) [{card}]")
    print(f"[10c] kernel launches {launches_10c}, expected {expected_10c}")
    require(r_s["residual_l2"][-1] < r_s["residual_l2"][0], "smoother block: the residual did not fall")
    require(launches_10c == expected_10c, "smoother block launch counts differ from the plan")
    require(s_rel <= 1e-10, "smoother block: kernel and plain residuals differ by more than 1e-10")

    # [10d] The symmetry block.
    reset_counts()
    r_sym = diagnostics.run_symmetry_test(32, device=dev)
    launches_10d = read_counts()
    print(f"[10d] symmetry at 32: { {k: f'{v:.3e}' for k, v in r_sym.items()} }; kernel launches {launches_10d}")
    require(len(r_sym) == 6 and all(v < 1e-10 for v in r_sym.values()), "an operator is not symmetric to 1e-10")
    require(launches_10d["smoother"] > 0, "the symmetry block never launched the chunk kernel")
    launches_node = sum_counts(launches_10a, launches_10b, launches_10c, launches_10d)

    # [10e] instrumented_solve on phase 3's bench problem and right-hand side.
    reset_counts()
    lines = []
    x_inst, stage_t = profiling.instrumented_solve(setup.problem, rhs, config=config, printer=lines.append)
    torch.cuda.synchronize()
    launches_10e = read_counts()
    res_ref = mgpcg.solve(setup.problem, rhs, config=config)
    expected_10e = expected_launches(hier, config, res_ref.iterations)
    expected_10e["residual"] -= 1  # no recomputed residual: a solve, not a projection
    stage_sum = sum(stage_t.seconds.values())
    print(f"[10e] instrumented_solve at {setup.expanded_shape}: {stage_t.calls['matvec']} iterations "
          f"(mgpcg.solve: {res_ref.iterations}); x bit-equal {torch.equal(x_inst, res_ref.x)}; launches "
          f"{launches_10e}, expected {expected_10e}")
    for line in stage_t.report().splitlines():
        print(f"[10e]   {line}")
    print(f"[10e] sum of the stages {stage_sum * 1e3:.3f} ms against the best unprofiled solve "
          f"{solves['kernels'][0] * 1e3:.3f} ms ({stage_sum / solves['kernels'][0]:.2f}x) [{card}]")
    require(torch.equal(x_inst, res_ref.x), "instrumented_solve's x differs from mgpcg.solve's")
    require(stage_t.calls["matvec"] == res_ref.iterations == iters, "instrumented_solve's iterations differ")
    require(launches_10e == expected_10e, "instrumented_solve's launch counts differ from the solve's")

    # [10f] The per-level V-cycle split on the bench hierarchy.
    split = profiling.vcycle_stage_times(hier, rhs, config, warmup=1, reps=3)
    kinds = ("smooth (down)", "residual+restrict", "prolong", "smooth (up)")
    print(f"[10f] one V-cycle at {setup.expanded_shape} by level, ms per call (mean of 3), each stage ending on a "
          f"device sync [{card}]:")
    print(f"[10f]   {'level':<22}" + "".join(f"{k:>20}" for k in kinds))
    for lv in range(nlev - 1):
        row = [1e3 * split.seconds[f"L{lv} {k}"] / split.calls[f"L{lv} {k}"] for k in kinds]
        print(f"[10f]   L{lv} {str(tuple(hier.levels[lv].shape)):<19}" + "".join(f"{v:>20.4f}" for v in row))
    coarse_key = f"L{nlev - 1} coarse direct solve"
    print(f"[10f]   {coarse_key}: {1e3 * split.seconds[coarse_key] / split.calls[coarse_key]:.4f} ms; cycle total "
          f"{1e3 * sum(split.seconds.values()) / 3:.4f} ms")

    # [10g] The assembled baseline against MGPCG on the 128^3 splash, fp64.
    cfg_b = SolverConfig(tolerance=1e-5)
    shape_b = (node,) * 3
    phi_b, vel_b = sdf.splash_scene(shape_b, device=dev)
    w_b = sdf.open_box_weights(shape_b, device=dev)
    t_mg = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        setup_b = free_surface.build_setup(phi_b, w_b, config=cfg_b)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        res_b = free_surface.project(setup_b, vel_b, config=cfg_b)
        torch.cuda.synchronize()
        t_mg.append((t1 - t0, time.perf_counter() - t1))
    t0 = time.perf_counter()
    p_base, v_base, div_base = assembled.project_assembled(phi_b, w_b, vel_b, tolerance=1e-5)
    t_base = time.perf_counter() - t0
    base_rel = float(np.abs(res_b.pressure.cpu().numpy() - p_base).max() / np.abs(p_base).max())
    v_rel_b = max(rel_err(torch.as_tensor(v, device=dev), u)[1] for v, u in zip(v_base, res_b.velocity))
    print(f"[10g] {node}^3 splash, fp64, tol 1e-5: MGPCG setup {t_mg[-1][0]:.4f} s + project {t_mg[-1][1]:.4f} s "
          f"({res_b.cg.iterations} iterations; first call {sum(t_mg[0]):.4f} s), assembled baseline "
          f"{t_base:.4f} s (host diagonal-PCG) [{card}]")
    print(f"[10g] pressure max relative difference {base_rel:.3e}, velocity {v_rel_b:.3e}; max divergence MGPCG "
          f"{float(res_b.max_divergence):.3e}, baseline {div_base:.3e}")
    require(base_rel <= 1e-4, "the assembled baseline's pressure differs from MGPCG's by more than 1e-4")
    require(np.isfinite(div_base) and bool(torch.isfinite(res_b.max_divergence)), "non-finite divergence")

    # [10h] The CLI on the card, in a process of its own.
    cli = [sys.executable, "-m", "geometricmultigridpressuresolver_tpu_torch.diagnostics", "--grid-size", "32",
           "--test-symmetry", "--test-one-level-v-cycle", "--num-cycles", "8"]
    t0 = time.perf_counter()
    proc = subprocess.run(cli, cwd=Path(__file__).resolve().parent, capture_output=True, text=True, timeout=600)
    sym_lines = [line for line in proc.stdout.splitlines() if line.endswith(("[OK]", "[FAIL]"))]
    print(f"[10h] gmg-torch-diagnostics --grid-size 32 --test-symmetry --test-one-level-v-cycle --num-cycles 8: "
          f"exit {proc.returncode} in {time.perf_counter() - t0:.1f} s; {sum(l.endswith('[OK]') for l in sym_lines)}"
          f"/{len(sym_lines)} symmetry lines [OK]; {proc.stdout.strip().splitlines()[-1] if proc.stdout.strip() else ''}")
    require(proc.returncode == 0, f"the diagnostics CLI failed: {proc.stderr[-2000:]}")
    require(len(sym_lines) == 6 and all(line.endswith("[OK]") for line in sym_lines),
            "a symmetry line of the CLI is not [OK]")

    # ---- 11. the mesh of ranks (torch.distributed) ---------------------------------------
    # One card: every rank shares cuda:0, so this is a rehearsal of the
    # multi-card path (halos and dots cross processes), not a speed-up.
    from geometricmultigridpressuresolver_tpu_torch.parallel import dryrun

    print(f"[11] card: {card_line()}")
    t11 = time.perf_counter()
    graph.PROGRAMS.clear()  # the ranks share the card with this process
    torch.cuda.empty_cache()
    dryrun_job = "geometricmultigridpressuresolver_tpu_torch.parallel.dryrun"
    # [11a] NCCL, a world of one rank: the 64^3 splash in the bench
    # configuration against a single-process projection of the same scene.
    m = 64
    phi_a, vel_a = sdf.splash_scene((m, m, m), device=dev, dtype=torch.float32)
    w_a = sdf.open_box_weights((m, m, m), device=dev, dtype=torch.float32)
    single_a = free_surface.project(free_surface.build_setup(phi_a, w_a, config=config), vel_a, config=config)
    scene_a = dict(phi=phi_a.cpu().numpy(), velocity=tuple(v.cpu().numpy() for v in vel_a),
                   weights=tuple(w.cpu().numpy() for w in w_a))
    t0 = time.perf_counter()
    (r11a,) = dryrun.launch(f"{dryrun_job}:project_job", 1, "nccl", "cuda",
                            dict(n=m, bench=True, fields=True, print_line=False, scene=scene_a), timeout=300)
    _, rel_a = rel_err(torch.from_numpy(r11a["pressure"]), single_a.pressure.cpu())
    print(f"[11a] NCCL, 1 rank, {m}^3 bench configuration: {time.perf_counter() - t0:.1f} s with the spawn; "
          f"{r11a['iterations']} iterations (single process {single_a.cg.iterations}), pressure max relative "
          f"difference {rel_a:.3e}; flags {r11a['flags']} (a one-rank mesh splits no level: the dots go "
          f"through NCCL all_gather, the kernels are the single-device ones) [{card}]")
    require(r11a["backend"] == "nccl" and r11a["converged"], "[11a] the NCCL rank did not converge")
    require(r11a["iterations"] == single_a.cg.iterations, "[11a] iterations differ from the single process")
    require(rel_a <= 1e-6, "[11a] pressure differs from the single process by more than 1e-6")

    # [11b] Four ranks on a (2, 2, 1) mesh, all on cuda:0, gloo with host
    # staging: the bench projection at n^3 through the partitioned build,
    # every rank's blocks held against phase 3's setup cut to them.
    from geometricmultigridpressuresolver_tpu_torch.parallel import sharding
    from geometricmultigridpressuresolver_tpu_torch.parallel.mesh import DistMesh

    t0 = time.perf_counter()
    r11b = dryrun.launch("chip_smoke:rank_bench", 4, "gloo", "cuda", dict(n=n), timeout=900)
    t11b = time.perf_counter() - t0
    ref_m = result_m.pressure.cpu()
    for r in r11b:
        best = min(r["solves"], key=lambda sv: sv["seconds"])
        st = r["project_stats"]
        want = tensor_digests(sharding.shard_setup(setup, DistMesh((2, 2, 1), r["rank"], dev, "gloo"), config))
        differ = sorted(k for k in want if r["digests"].get(k) != want[k])
        print(f"[11b] rank {r['rank']} {tuple(r['coords'])}: flags {r['flags']}, blocks {r['block_shapes'][:2]}, "
              f"{r['local_dofs']:,} local DOFs, {r['iterations']} iterations, relative residual "
              f"{r['relative_residual']:.3e} (recomputed {r['recomputed_residual']:.3e}); setup {r['setup_s']:.2f} s, "
              f"project {r['project_s']:.2f} s; peak device memory: build {r['build_peak_gib']:.3f} GiB, "
              f"projection {r['project_peak_gib']:.3f} GiB (phase 3's single process {peak3_off:.3f} GiB with the "
              f"program cache off, {peak3:.3f} GiB with it); "
              f"{len(want) - len(differ)}/{len(want)} fields of the setup bit-identical to phase 3's cut (sha256); "
              f"launches {r['launches']}, {r['exchanges']} halo exchanges (exact), {st['redistributes']} box moves "
              f"{st['redistribute_s'] * 1e3:.1f} ms, {st['bytes_staged']:,} bytes staged in the projection; "
              f"kernels vs plain on the haloed blocks {r['errs']} [{card}]")
        print(f"[11b] rank {r['rank']} best of {len(r['solves'])} solves {best['seconds']:.4f} s; per solve: "
              + "; ".join(f"{sv['seconds']:.4f} s, {sv['exchanges']} exchanges, {sv['bytes_staged']:,} bytes staged, "
                          f"exchanges {sv['exchange_ms']:.1f} ms (packing {sv['pack_ms']:.1f}), "
                          f"{sv['collectives']} collectives {sv['collective_ms']:.1f} ms, compute {sv['compute_ms']:.1f} ms"
                          for sv in r["solves"]) + f" [{card}]")
        require(not differ, f"[11b] rank {r['rank']}: setup fields differ from phase 3's cut: {differ[:8]}")
        require(r["converged"] and r["relative_residual"] <= 1e-5, f"[11b] rank {r['rank']} did not converge to 1e-5")
        require(abs(r["iterations"] - iters) <= 1, f"[11b] rank {r['rank']}: iterations differ from phase 3 by more than 1")
        require(r["build_peak_gib"] <= 0.5 * peak3_off,
                f"[11b] rank {r['rank']}: the build peaks at {r['build_peak_gib']:.3f} GiB, over half of phase 3's")
    require(len({r["iterations"] for r in r11b}) == 1, "[11b] the ranks' iterations differ")
    require(len({tuple(r["pressure_digest"]) for r in r11b}) == 1, "[11b] the ranks' gathered pressures differ")
    _, rel_b3 = rel_err(r11b[0]["pressure"], result.pressure.cpu())
    _, rel_b8 = rel_err(r11b[0]["pressure"], ref_m)
    dofs_b = sum(r["local_dofs"] for r in r11b)
    print(f"[11b] 4 ranks in {t11b:.1f} s with the spawn: pressure max relative difference {rel_b3:.3e} from phase 3, "
          f"{rel_b8:.3e} from phase 8's block mesh; local DOFs sum to {dofs_b:,} ({ndof:,}) [{card}]")
    require(rel_b3 <= 1e-3 and rel_b8 <= 1e-3, "[11b] pressure differs from phases 3 and 8 by more than 1e-3")
    require(dofs_b == ndof, "[11b] the ranks' local DOFs do not sum to the total")

    # [11c] Two ranks on (2, 1, 1), fp64, the 32^3 fractional sine fixture
    # from a warm start, against the single process.
    t0 = time.perf_counter()
    labels_c, weights_c, levels_c = sine_fixture(32)
    rhs_c, x0_c = solvable_field(labels_c, 21), 0.1 * solvable_field(labels_c, 5)
    kw_c = dict(tolerance=1e-8)
    prob_c = mgpcg.build_problem(labels_c, weights_c, levels_c, SolverConfig(**kw_c), device=dev)
    single_c = mgpcg.solve(prob_c, torch.from_numpy(rhs_c).to(dev), torch.from_numpy(x0_c).to(dev),
                           SolverConfig(**kw_c))
    r11c = dryrun.launch(f"{dryrun_job}:solve_job", 2, "gloo", "cuda",
                         dict(labels=labels_c, weights=weights_c, mg_levels=levels_c, rhs=rhs_c,
                              config_kwargs=kw_c, x0=x0_c), timeout=300)
    x_c = np.zeros(labels_c.shape)
    for r in r11c:
        x_c[r["slices"]] = r["x"]
    diff_c = float(np.abs(x_c - single_c.x.cpu().numpy()).max())
    print(f"[11c] 2 ranks, fp64, {labels_c.shape} sine fixture, warm start, {time.perf_counter() - t0:.1f} s with "
          f"the single process and the spawn: flags {r11c[0]['flags']}, "
          f"{r11c[0]['iterations']} iterations (single process {single_c.iterations}), x max difference "
          f"{diff_c:.3e}; launches {[r['launches'] for r in r11c]}")
    require(r11c[0]["flags"][0] == "sharded", "[11c] the fine level does not run sharded")
    require(all(r["iterations"] == single_c.iterations and r["converged"] for r in r11c),
            "[11c] iterations differ from the single process")
    require(diff_c <= 1e-12, "[11c] x differs from the single process by more than 1e-12")
    require(all(r["launches"]["residual"] >= 1 for r in r11c), "[11c] the warm start launched no residual kernel")

    # [11d] The launcher from the command line, in a process of its own.
    cmd = [sys.executable, "-m", dryrun_job, "--world-size", "2", "--backend", "gloo", "--device", "cuda",
           "--timeout", "300"]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=Path(__file__).resolve().parent, capture_output=True, text=True, timeout=400)
    lines = [json.loads(line) for line in proc.stdout.splitlines() if line.startswith("{")]
    print(f"[11d] {' '.join(cmd[1:])}: exit {proc.returncode} in {time.perf_counter() - t0:.1f} s; "
          + "; ".join(f"rank {d['rank']}: {d['iterations']} iterations, {d['local_dofs']} local DOFs, "
                      f"halos {d['halo_ms']:.1f} ms, {d['staged_bytes']:,} bytes staged" for d in lines))
    require(proc.returncode == 0 and len(lines) == 2, f"[11d] the launcher failed: {proc.stderr[-2000:]}")

    # [11e] Twice the size (512^3 at the default): one single-process build
    # and projection here (freed before the spawn), then four gloo ranks on
    # (2, 2, 1) through the partitioned build, one projection each.
    ne = 2 * n
    t0 = time.perf_counter()
    graph.PROGRAMS.clear()  # the earlier phases' programs and their pools
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base_e = torch.cuda.memory_allocated()
    phi_e, vel_e = sdf.splash_scene((ne, ne, ne), device=dev, dtype=torch.float32)
    w_e = sdf.open_box_weights((ne, ne, ne), device=dev, dtype=torch.float32)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    setup_e = free_surface.build_setup(phi_e, w_e, config=config)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    single_e = free_surface.project(setup_e, vel_e, config=config)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    peak_e = (torch.cuda.max_memory_allocated() - base_e) / 2**30
    ndof_e, iters_e = int(setup_e.problem.fine.solvable.sum()), single_e.cg.iterations
    pressure_e = single_e.pressure.cpu()
    print(f"[11e] single process, {ne}^3 bench splash: window {setup_e.expanded_shape}, levels "
          f"{[tuple(c.shape) for c in setup_e.problem.hier.levels]}, {ndof_e:,} DOFs, {iters_e} iterations "
          f"(relative residual {single_e.cg.relative_residual:.3e}); scene {t1 - t0:.2f} s, setup {t2 - t1:.2f} s, "
          f"project {t3 - t2:.2f} s; peak device memory {peak_e:.3f} GiB above the {base_e / 2**30:.3f} GiB "
          f"already held [{card}]")
    require(single_e.cg.converged and single_e.cg.relative_residual <= 1e-5, "[11e] the single process did not converge")
    del phi_e, vel_e, w_e, setup_e, single_e
    graph.PROGRAMS.clear()  # the ranks share the card: this process's programs go too
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    r11e = dryrun.launch("chip_smoke:rank_project", 4, "gloo", "cuda", dict(n=ne), timeout=600)
    t11e = time.perf_counter() - t0
    for r in r11e:
        st = r["project_stats"]
        print(f"[11e] rank {r['rank']}: blocks {r['block_shapes'][:2]}, {r['local_dofs']:,} local DOFs, "
              f"{r['iterations']} iterations, relative residual {r['relative_residual']:.3e}; setup {r['setup_s']:.2f} s, "
              f"project {r['project_s']:.2f} s; peak device memory: build {r['build_peak_gib']:.3f} GiB, projection "
              f"{r['project_peak_gib']:.3f} GiB; projection: {st['exchanges']} halo exchanges "
              f"{st['exchange_s'] * 1e3:.1f} ms, {st['redistributes']} box moves {st['redistribute_s'] * 1e3:.1f} ms, "
              f"{st['collectives']} collectives {st['collective_s'] * 1e3:.1f} ms, {st['bytes_staged']:,} bytes staged "
              f"[{card}]")
        require(r["converged"] and r["relative_residual"] <= 1e-5, f"[11e] rank {r['rank']} did not converge to 1e-5")
        require(abs(r["iterations"] - iters_e) <= 1, f"[11e] rank {r['rank']}: iterations differ from the single process")
    _, rel_e = rel_err(r11e[0]["pressure"], pressure_e)
    dofs_e = sum(r["local_dofs"] for r in r11e)
    print(f"[11e] 4 ranks at {ne}^3 in {t11e:.1f} s with the spawn: pressure max relative difference {rel_e:.3e} from "
          f"the single process; local DOFs sum to {dofs_e:,} ({ndof_e:,}) [{card}]")
    require(rel_e <= 1e-3, "[11e] pressure differs from the single process by more than 1e-3")
    require(dofs_e == ndof_e, "[11e] the ranks' local DOFs do not sum to the single process's")
    del pressure_e, r11e

    # [11f] run() at 512^3 ([11e]'s splash), 3 frames, through the program
    # cache and with it off, in turns (3 each): where a program is too large
    # for the cache to keep beside its frame partner (Programs.get), the
    # frames run PR 13's path and capture nothing per frame; seconds per
    # frame by stage.  Here, where the process holds least.
    graph.PROGRAMS.clear()
    gc.collect()
    torch.cuda.empty_cache()
    ne, frames_e = 2 * n, 3
    print(f"[11f] held before: {torch.cuda.memory_allocated() / 2**30:.3f} GiB allocated, "
          f"{torch.cuda.memory_reserved() / 2**30:.3f} GiB reserved, "
          f"{sum(seg['total_size'] for seg in torch.cuda.memory_snapshot() if tuple(seg['segment_pool_id']) != (0, 0)) / 2**30:.3f}"
          f" GiB of it in {len(private_pools())} private pools [{card}]")
    phi_e, vel_e = sdf.splash_scene((ne, ne, ne), device=dev, dtype=torch.float32)
    w_e = sdf.open_box_weights((ne, ne, ne), device=dev, dtype=torch.float32)
    per_e, runs_e = {True: [], False: []}, {True: [], False: []}
    for cached in (True, False, False, True, True, False):
        graph.STATS.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with contextlib.nullcontext() if cached else graph.programs_off():
            frs = simulate.run(phi_e, vel_e, w_e, num_frames=frames_e, config=config)
        torch.cuda.synchronize()
        per_e[cached].append((time.perf_counter() - t0) / frames_e)
        runs_e[cached].append([(fr.iterations, fr.pressure.cpu(), fr.seconds) for fr in frs])
        del frs
        if cached:
            caps_e, hits_e = dict(graph.STATS.program_captures), dict(graph.STATS.program_hits)
            declined_e = dict(graph.STATS.program_declined)
    for cached in (True, False):
        for i, frs in enumerate(runs_e[cached]):
            stage = {k: sum(fr[2][k] for fr in frs) / frames_e for k in ("advect", "setup", "project")}
            print(f"[11f] run() {frames_e} frames at {ne}^3, {'cached' if cached else 'off'} run {i + 1}: "
                  f"{per_e[cached][i]:.4f} s per frame, by stage {', '.join(f'{k} {v:.4f}' for k, v in stage.items())} "
                  f"s; iterations {[fr[0] for fr in frs]} [{card}]")
    bits_e = all(a[0] == b[0] and torch.equal(a[1], b[1]) for frs in runs_e[True] for a, b in zip(frs, runs_e[False][0]))
    print(f"[11f] the last cached run captures {caps_e}, replays {hits_e}, runs uncached {declined_e}; frames "
          f"bit-equal to the cache off {bits_e}; best cached {min(per_e[True]):.4f} s against off "
          f"{min(per_e[False]):.4f} s per frame [{card}]")
    require(bits_e, "[11f] the cached 512^3 frames differ from the frames with the cache off")
    require(sum(caps_e.values()) == 0, "[11f] a second 512^3 run() captured programs again")
    require(min(per_e[True]) <= 1.10 * min(per_e[False]), "[11f] the cached 512^3 run() is slower than the cache off")
    del phi_e, vel_e, w_e, runs_e
    graph.PROGRAMS.clear()
    torch.cuda.empty_cache()
    print(f"[11] phase 11 took {time.perf_counter() - t11:.1f} s [{card}]")

    # ---- 12. the transfers: per-axis matrix products against shifted slices ----------
    t12 = time.perf_counter()
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile
    from torch.profiler import schedule as profiler_schedule

    from geometricmultigridpressuresolver_tpu_torch.ops import transfer

    print(f"[12] card: {card_line()}")
    require(mg.use_mm_transfers(config, dev), "[12] transfer_mode='auto' is not the matrix form on the card")
    modes = {"mm": dataclasses.replace(config, transfer_mode="mm"),
             "slice": dataclasses.replace(config, transfer_mode="slice")}
    forms = {"mm": transfer.form(True), "slice": transfer.form(False)}
    reps12 = 20

    # [12a] Each transfer at each level of the bench hierarchy, both forms:
    # time (CUDA events over 20 calls) and launches per call; the matrix
    # form against the slice form in fp32 (also with TF32 switched on
    # here: the products must stay IEEE) and fp64, and in bf16 against the
    # same products accumulated exactly and rounded where the form rounds;
    # each product's rate and its two bounds.
    transfer_rows = []
    tf32_was = torch.backends.cuda.matmul.allow_tf32
    for lv in range(nlev - 1):
        cf, cc = hier.levels[lv], hier.levels[lv + 1]
        f, c = rand_field(cf), rand_field(cc)
        shapes = f"L{lv} {tuple(cf.shape)} <-> L{lv + 1} {tuple(cc.shape)}"
        calls = {
            "restrict": lambda form, x=f, cs=cc.solvable: forms[form].restrict(x, cs),
            "prolong_add": lambda form, x=f, y=c, fs=cf.solvable: forms[form].prolong_add(x, y, fs),
        }
        args = {"restrict": (f, cc.solvable), "prolong_add": (f, c, cf.solvable)}
        for which, call in calls.items():
            row = {"level": lv, "transfer": which, "fine": list(cf.shape), "coarse": list(cc.shape)}
            for form in forms:
                ms = cuda_ms(lambda: call(form), reps12)
                launches12, events12, _ = device_events(lambda: call(form))
                row[form] = {"ms": ms, "launches": launches12, "device_events": events12}
            mm_fn, sl_fn = getattr(forms["mm"], which), getattr(forms["slice"], which)
            _, e32 = rel_err(mm_fn(*args[which]), sl_fn(*args[which]))
            torch.backends.cuda.matmul.allow_tf32 = True
            try:
                got_tf32 = mm_fn(*args[which])
                require(torch.backends.cuda.matmul.allow_tf32, "[12a] the matrix form did not restore allow_tf32")
            finally:
                torch.backends.cuda.matmul.allow_tf32 = tf32_was
            _, e32_tf32 = rel_err(got_tf32, sl_fn(*args[which]))
            # fp64 inputs off the fp32 grid (fp32 values would make every
            # product and sum exact in fp64).
            a64 = tuple(t.double() * (1 + 1e-3 * torch.randn(t.shape, generator=gen, device=dev, dtype=torch.float64))
                        if t.is_floating_point() else t for t in args[which])
            _, e64 = rel_err(mm_fn(*a64), sl_fn(*a64))
            a16 = tuple(t.to(torch.bfloat16) if t.is_floating_point() else t for t in args[which])
            got16, sl16 = mm_fn(*a16), sl_fn(*a16)
            ref16 = rounded_once_reference(which, *a16)
            exact = mm_fn(*(t.double() if t.is_floating_point() else t for t in a16))
            ulp = bf16_ulp(float(ref16.double().abs().max()))
            u_ref = rel_err(got16, ref16)[0] / ulp
            u_mm, u_sl = rel_err(got16, exact)[0] / ulp, rel_err(sl16, exact)[0] / ulp
            u_pair = rel_err(got16, sl16)[0] / ulp
            row.update(fp32_rel_err=e32, fp32_rel_err_tf32_on=e32_tf32, fp64_rel_err=e64,
                       bf16_ulps_vs_rounded_once=u_ref, bf16_ulps_mm_vs_exact=u_mm,
                       bf16_ulps_slice_vs_exact=u_sl, bf16_ulps_mm_vs_slice=u_pair)
            # The three products of the matrix form, one at a time.
            products = []
            x = f if which == "restrict" else c
            with blas.ieee_products():
                for axis in range(3):
                    if which == "restrict":
                        a = transfer.restrict_axis_matrix(x, axis, cc.shape[axis], 0)
                        fn = lambda x=x, a=a, axis=axis: transfer.axis_product(x, a, axis)  # noqa: E731
                    elif axis < 2:
                        a = transfer.prolong_axis_matrix(cf.shape[axis], x, axis, 0)
                        fn = lambda x=x, a=a, axis=axis: transfer.axis_product(x, a, axis)  # noqa: E731
                    else:
                        a = transfer.prolong_axis_matrix(cf.shape[axis], x, axis, 0)
                        fn = lambda x=x, a=a: torch.addmm(  # noqa: E731
                            f.reshape(-1, f.shape[2]), x.reshape(-1, x.shape[2]), a.t(), alpha=4)
                    y = fn()
                    p_ms = cuda_ms(fn, reps12)
                    flops = 2 * a.shape[0] * a.shape[1] * (x.numel() // x.shape[axis])
                    moved = nbytes(x, y, a) + (nbytes(f) if which == "prolong_add" and axis == 2 else 0)
                    t_bytes, t_ops = moved / HBM_BYTES_PER_S * 1e3, flops / FP32_OPS_PER_S * 1e3
                    products.append({"axis": axis, "m_n_k": [a.shape[0], x.numel() // x.shape[axis], a.shape[1]],
                                     "gflop": flops / 1e9, "ms": p_ms, "gflops_per_s": flops / p_ms / 1e6,
                                     "bound_bytes_ms": t_bytes, "bound_ops_ms": t_ops,
                                     "bound_by": "bytes" if t_bytes >= t_ops else "operations"})
                    x = y
            row["mm"]["products"] = products
            transfer_rows.append(row)
            print(f"[12a] {shapes} {which}: mm {row['mm']['ms']:.4f} ms ({row['mm']['launches']:g} kernel launches, "
                  f"{row['mm']['device_events']:g} device events), slice {row['slice']['ms']:.4f} ms "
                  f"({row['slice']['launches']:g} launches, {row['slice']['device_events']:g} device events); "
                  f"mm vs slice: fp32 {e32:.3e} "
                  f"(TF32 on: {e32_tf32:.3e}), fp64 {e64:.3e}; bf16 {u_ref:.3f} ulp from the rounded-once "
                  f"reference (mm vs slice {u_pair:.2f} ulp; from the exact transfer: mm {u_mm:.2f}, slice "
                  f"{u_sl:.2f} ulp) [{card}]")
            for pr in products:
                print(f"[12a]   product axis {pr['axis']} (m, n, k) {tuple(pr['m_n_k'])}: {pr['gflop']:.3f} GFLOP in "
                      f"{pr['ms']:.4f} ms = {pr['gflops_per_s']:,.0f} GFLOP/s; bounds: bytes {pr['bound_bytes_ms']:.4f} "
                      f"ms, operations {pr['bound_ops_ms']:.4f} ms ({pr['bound_by']} bind; "
                      f"{max(pr['bound_bytes_ms'], pr['bound_ops_ms']) / pr['ms']:.0%} of it)")
            require(e32 <= 1e-6 and e32_tf32 <= 1e-6,
                    f"[12a] {shapes} {which}: fp32 matrix form {e32:.3e} / {e32_tf32:.3e} (TF32 on) from the slice form")
            require(e64 <= 1e-13, f"[12a] {shapes} {which}: fp64 matrix form {e64:.3e} from the slice form")
            require(u_ref <= 1.0, f"[12a] {shapes} {which}: bf16 matrix form {u_ref:.3f} ulp from its rounded-once "
                    "reference")
            require(0 < row["mm"]["launches"] < row["slice"]["launches"], f"[12a] {shapes} {which}: launches")

    # [12b] The 256^3 projection in both forms: iterations, pressure, kernel
    # launches against the plan; solves in turns (best wall, device ms by
    # CUDA events), and one profiled warm solve each: launches by kernel
    # and by host op, the host's kernel-launch calls.
    proj12 = {}
    for form, cfg in modes.items():
        reset_counts()
        proj12[form] = free_surface.project(setup, velocity, config=cfg)
        torch.cuda.synchronize()
        got12, want12 = read_counts(), expected_launches(hier, cfg, proj12[form].cg.iterations)
        print(f"[12b] {form} projection: {proj12[form].cg.iterations} iterations, relative residual "
              f"{proj12[form].cg.relative_residual:.3e}; kernel launches {got12}, expected {want12}")
        require(got12 == want12, f"[12b] {form}: kernel launches differ from the plan")
        require(proj12[form].cg.converged and proj12[form].cg.relative_residual <= 1e-5,
                f"[12b] {form} projection did not converge")
    it_mm, it_sl = proj12["mm"].cg.iterations, proj12["slice"].cg.iterations
    _, p12 = rel_err(proj12["mm"].pressure, proj12["slice"].pressure)
    print(f"[12b] iterations mm {it_mm} vs slice {it_sl}; pressure max relative difference {p12:.3e}")
    require(abs(it_mm - it_sl) <= 1 and p12 <= 1e-3, "[12b] the two forms' projections differ")
    wall12, ev12 = {form: [] for form in modes}, {form: [] for form in modes}
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for _ in range(3):
        for form, cfg in modes.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            start.record()
            res = mgpcg.solve(setup.problem, rhs, config=cfg)
            stop.record()
            torch.cuda.synchronize()
            wall12[form].append(time.perf_counter() - t0)
            ev12[form].append(start.elapsed_time(stop))
            require(res.converged, f"[12b] a timed {form} solve did not converge")
    for form, cfg in modes.items():
        kept = []
        with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                           schedule=profiler_schedule(wait=0, warmup=1, active=1),
                           on_trace_ready=lambda p: kept.append(p.key_averages())) as prof:
            for _ in range(2):  # the first solve is the profiler's warm-up step
                reset_counts()
                res = mgpcg.solve(setup.problem, rhs, config=cfg)
                torch.cuda.synchronize()
                prof.step()
        got12 = read_counts()
        want12 = expected_launches(hier, cfg, res.iterations)
        want12["residual"] -= 1  # a solve without the projection's recomputed residual
        dev_ev = [e for e in kept[0] if getattr(e, "device_type", None) == DeviceType.CUDA
                  and not e.key.startswith("ProfilerStep")]
        host_ev = [e for e in kept[0] if getattr(e, "device_type", None) != DeviceType.CUDA]
        port = ("smooth_chunk_kernel", "cg_step_kernel", "residual_kernel", "sum_partials", "halo_")
        port_ev = [e for e in dev_ev if any(k in e.key for k in port)]
        gemm_ev = [e for e in dev_ev if "gemm" in e.key.lower() or "cutlass" in e.key.lower()]
        n_port, n_gemm = sum(e.count for e in port_ev), sum(e.count for e in gemm_ev)
        ms_port, ms_gemm = (sum(device_us(e) for e in ev) / 1e3 for ev in (port_ev, gemm_ev))
        n_all = sum(e.count for e in dev_ev)
        dev_total = sum(device_us(e) for e in dev_ev) / 1e3
        launch_calls = [e for e in host_ev if "LaunchKernel" in e.key]
        aten = sorted((e for e in host_ev if e.key.startswith("aten::")), key=lambda e: -e.count)[:10]
        print(f"[12b] {form}: best solve {min(wall12[form]) * 1e3:.3f} ms wall, {min(ev12[form]):.3f} ms between "
              f"CUDA events (each: {', '.join(f'{t:.3f}' for t in ev12[form])}); profiled: {dev_total:.3f} ms of "
              f"device time in {n_all} device launches and copies per solve, of them {n_port} port kernels "
              f"({ms_port:.3f} ms), {n_gemm} cuBLAS products ({ms_gemm:.3f} ms), {n_all - n_port - n_gemm} other "
              f"plain-PyTorch kernels and copies ({dev_total - ms_port - ms_gemm:.3f} ms); "
              f"host launch calls {', '.join(f'{e.key} {e.count} ({e.self_cpu_time_total / 1e3:.3f} ms)' for e in launch_calls)} "
              f"[{card}]")
        print(f"[12b] {form}: host ops by calls per solve: "
              + ", ".join(f"{e.key} {e.count}" for e in aten))
        print(f"[12b] {form}: kernel launches {got12}, expected {want12}")
        require(got12 == want12, f"[12b] {form}: the profiled solve's kernel launches differ from the plan")
    better = "mm" if min(ev12["mm"]) <= min(ev12["slice"]) else "slice"
    print(f"[12b] transfer_mode='auto' on the card: mm (solver.mg.use_mm_transfers); this run's best solve: mm "
          f"{min(ev12['mm']):.3f} ms vs slice {min(ev12['slice']):.3f} ms between CUDA events, "
          f"{min(wall12['mm']) * 1e3:.3f} vs {min(wall12['slice']) * 1e3:.3f} ms wall: the faster form here is "
          f"{better}, {'as' if better == 'mm' else 'NOT as'} 'auto' takes [{card}]")

    # [12c] One V-cycle by level in both forms (utils.profiling.vcycle_stage_times).
    kinds = ("smooth (down)", "residual+restrict", "prolong", "smooth (up)")
    for form, cfg in modes.items():
        split = profiling.vcycle_stage_times(hier, rhs, cfg, warmup=1, reps=3)
        print(f"[12c] {form}: one V-cycle at {setup.expanded_shape} by level, ms per call (mean of 3), each stage "
              f"ending on a device sync [{card}]:")
        print(f"[12c]   {'level':<22}" + "".join(f"{k:>20}" for k in kinds))
        moves = 0.0
        for lv in range(nlev - 1):
            row = [1e3 * split.seconds[f"L{lv} {k}"] / split.calls[f"L{lv} {k}"] for k in kinds]
            moves += row[1] + row[2]
            print(f"[12c]   L{lv} {str(tuple(hier.levels[lv].shape)):<19}" + "".join(f"{v:>20.4f}" for v in row))
        coarse_key = f"L{nlev - 1} coarse direct solve"
        total = 1e3 * sum(split.seconds.values()) / 3
        print(f"[12c]   {coarse_key}: {1e3 * split.seconds[coarse_key] / split.calls[coarse_key]:.4f} ms; cycle "
              f"total {total:.4f} ms, of it residual+restrict and prolong {moves:.4f} ms")

    # [12d] The 512^3 splash ([11e]'s scene), single process, both forms in
    # turns on one setup: iterations, projection seconds, peak memory.
    ne = 2 * n
    graph.PROGRAMS.clear()
    torch.cuda.empty_cache()
    phi_e, vel_e = sdf.splash_scene((ne, ne, ne), device=dev, dtype=torch.float32)
    w_e = sdf.open_box_weights((ne, ne, ne), device=dev, dtype=torch.float32)
    setup_e = free_surface.build_setup(phi_e, w_e, config=config)
    del phi_e, w_e
    best_e, peak_e12, res_e = {}, {}, {}
    for _ in range(2):
        for form, cfg in modes.items():
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base_e = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            res_e[form] = free_surface.project(setup_e, vel_e, config=cfg)
            torch.cuda.synchronize()
            best_e[form] = min(best_e.get(form, float("inf")), time.perf_counter() - t0)
            peak_e12[form] = (torch.cuda.max_memory_allocated() - base_e) / 2**30
    for form in modes:
        print(f"[12d] {form}, {ne}^3 bench splash (window {setup_e.expanded_shape}): {res_e[form].cg.iterations} "
              f"iterations, relative residual {res_e[form].cg.relative_residual:.3e}; projection best of 2 "
              f"{best_e[form]:.4f} s; peak device memory {peak_e12[form]:.3f} GiB above the setup [{card}]")
        require(res_e[form].cg.converged and res_e[form].cg.relative_residual <= 1e-5,
                f"[12d] the {form} projection did not converge")
    _, pe = rel_err(res_e["mm"].pressure, res_e["slice"].pressure)
    print(f"[12d] iterations mm {res_e['mm'].cg.iterations} vs slice {res_e['slice'].cg.iterations}, pressure max "
          f"relative difference {pe:.3e}; projection mm {best_e['mm']:.4f} s vs slice {best_e['slice']:.4f} s")
    require(abs(res_e["mm"].cg.iterations - res_e["slice"].cg.iterations) <= 1 and pe <= 1e-3,
            "[12d] the two forms' 512^3 projections differ")
    del setup_e, vel_e, res_e
    torch.cuda.empty_cache()

    # [12e] The fused frame loop (run_fused, phase 9's 4 frames) in both
    # forms: seconds per frame in turns, twice, and host syncs per frame.
    per_form, stats12 = {form: [] for form in modes}, {}
    for _ in range(2):
        for form, cfg in modes.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            stats12[form] = simulate.run_fused(phi0, vel0, weights, num_frames=frames_n, config=cfg,
                                               chunk=frames_n)[3]
            torch.cuda.synchronize()
            per_form[form].append((time.perf_counter() - t0) / frames_n)
    for form, cfg in modes.items():
        _, sites = count_syncs(lambda: simulate.run_fused(phi0, vel0, weights, num_frames=frames_n, config=cfg,
                                                          chunk=frames_n))
        its = [int(i) for i in stats12[form]["iterations"]]
        print(f"[12e] run_fused {form}: {min(per_form[form]):.4f} s per frame at {n}^3, best of 2 in turns (each: "
              f"{', '.join(f'{t:.4f}' for t in per_form[form])}); {sum(sites.values()) / frames_n:.1f} host syncs "
              f"per frame; iterations {its} [{card}]")
    require(all(abs(int(a) - int(b)) <= 1 for a, b in zip(stats12["mm"]["iterations"], stats12["slice"]["iterations"])),
            "[12e] the two forms' frames differ by more than one iteration")
    print(f"[12] phase 12 took {time.perf_counter() - t12:.1f} s [{card}]")

    # ---- 13. the coarsest level factored on the card ----------------------------------
    # fp32 on the card: every setup factors the coarsest level on the card
    # (mg.coarse_direct -> coarse_system_card: an inverse up to 4096 bucketed
    # DOFs, a Cholesky factor above); the host path (coarse_system, fp64
    # numpy) is run here only to hold it against.
    t13 = time.perf_counter()
    print(f"[13] card: {card_line()}")
    # [13a] The bench hierarchy (phase 3's): _finish_hierarchy's card path
    # (one fetch of the flags and DOF counts, then the card) against the host
    # path, in turns, best of 3, with their host syncs.
    levels_a, flags_a, label_levels_a = window_levels(liquid_phi, setup, config)
    ndof_a = int(hier.levels[-1].solvable.sum())
    nd_pad_a = mg.coarse_bucket(ndof_a)
    require(tuple(hier.coarse_minv.shape) == (nd_pad_a, nd_pad_a) and hier.coarse_chol.numel() == 0,
            "[13a] the bench hierarchy's coarse solver is not the bucket's inverse")
    run_a = {"host": lambda: mg.coarse_system(label_levels_a[-1], torch.float32, dev),
             "card": lambda: mg._finish_hierarchy(levels_a, flags_a, label_levels_a, config)}
    ms_a = {tag: [] for tag in run_a}
    for _ in range(3):
        for tag, fn in run_a.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ms_a[tag].append((time.perf_counter() - t0) * 1e3)
    host_a, syncs_host_a = count_syncs(run_a["host"])
    card_a, syncs_card_a = count_syncs(run_a["card"])
    again_a = run_a["card"]()
    torch.cuda.synchronize()
    keys = ("coarse_dofs", "coarse_minv", "coarse_chol")
    bit_a = all(torch.equal(getattr(card_a, k), getattr(again_a, k)) for k in keys)
    setup_a = all(torch.equal(getattr(card_a, k), getattr(hier, k)) for k in keys)
    _, gap_a = rel_err(card_a.coarse_minv, host_a[1])
    c_a = hier.levels[-1]
    r_a = torch.where(c_a.solvable, torch.randn(c_a.shape, generator=gen, device=dev), 0.0)
    host_hier_a = hier._replace(coarse_dofs=host_a[0], coarse_minv=host_a[1], coarse_chol=host_a[2])
    _, solve_a = rel_err(mg.coarse_solve(card_a, r_a), mg.coarse_solve(host_hier_a, r_a))
    print(f"[13a] bench hierarchy {[tuple(c.shape) for c in hier.levels]}: coarsest {ndof_a:,} DOFs, bucket "
          f"{nd_pad_a} (inverse); best of 3 in turns: card (_finish_hierarchy) {min(ms_a['card']):.2f} ms with "
          f"{sum(syncs_card_a.values())} host syncs {dict(syncs_card_a)}, host (coarse_system) "
          f"{min(ms_a['host']):.2f} ms with {sum(syncs_host_a.values())}; each: card "
          f"{[round(t, 2) for t in ms_a['card']]}, host {[round(t, 2) for t in ms_a['host']]} [{card}]")
    print(f"[13a] card inverse vs the host's fp64 inverse rounded to fp32: max relative gap {gap_a:.3e}, "
          f"coarse_solve of a random vector {solve_a:.3e}; slot maps equal "
          f"{torch.equal(card_a.coarse_dofs, host_a[0])}; two card builds bit-equal {bit_a}; equal to phase 3's "
          f"setup {setup_a}")
    require(sum(syncs_card_a.values()) == 1, "[13a] the card path does not sync the host exactly once")
    require(bit_a and setup_a, "[13a] the card path is not reproducible")
    require(torch.equal(card_a.coarse_dofs, host_a[0]), "[13a] the slot maps differ")
    require(gap_a <= 1e-4 and solve_a <= 1e-4, "[13a] the card inverse differs from the host's beyond fp32 rounding")

    # [13b] The Cholesky branch at size: the bench scene capped where the
    # coarsest bucket lands in (4096, 16384] (the 256^3 scene when this
    # run's own has no such level).
    def cap_for(h):
        for lv in range(h.num_levels - 2, 0, -1):
            if mg.COARSE_INVERSE_MAX_PAD < -(-int(h.levels[lv].solvable.sum()) // 256) * 256 <= 16384:
                return lv + 1
        return None

    m_b, phi_b, vel_b, w_b, cap_b = n, liquid_phi, velocity, weights, cap_for(hier)
    if cap_b is None:
        m_b = 256
        phi_b, vel_b = sdf.splash_scene((m_b,) * 3, device=dev, dtype=torch.float32)
        w_b = sdf.open_box_weights((m_b,) * 3, device=dev, dtype=torch.float32)
        cap_b = cap_for(free_surface.build_setup(phi_b, w_b, config=config).problem.hier)
    require(cap_b is not None, "[13b] no level of the bench scene has a bucket in (4096, 16384]")
    cfg_b = dataclasses.replace(config, max_mg_levels=cap_b)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    setup_b = free_surface.build_setup(phi_b, w_b, config=cfg_b)
    torch.cuda.synchronize()
    t_setup_b = time.perf_counter() - t0
    hier_b = setup_b.problem.hier
    nd_pad_b = hier_b.coarse_chol.shape[0]
    require(hier_b.num_levels == cap_b and hier_b.coarse_minv.numel() == 0
            and nd_pad_b > mg.COARSE_INVERSE_MAX_PAD, "[13b] the capped hierarchy did not take the Cholesky branch")
    levels_b, flags_b, label_levels_b = window_levels(phi_b, setup_b, cfg_b)
    card_b, syncs_b = count_syncs(lambda: mg._finish_hierarchy(levels_b, flags_b, label_levels_b, cfg_b))
    ms_b = {"card": [], "host": []}
    for tag, fn in (("card", lambda: mg._finish_hierarchy(levels_b, flags_b, label_levels_b, cfg_b)),
                    ("host", lambda: mg.coarse_system(label_levels_b[-1], torch.float64, dev))):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out_b = fn()
        torch.cuda.synchronize()
        ms_b[tag] = (time.perf_counter() - t0) * 1e3
    dofs_hb, _, chol_hb = out_b  # the host path's factor in fp64 (np.linalg.cholesky)
    # Off the hot path: the factorization's own status, read here.
    info_b = int(torch.linalg.cholesky_ex(mg.coarse_matrix(hier_b.levels[-1], nd_pad_b)[0])[1])
    finite_b = bool(torch.isfinite(hier_b.coarse_chol).all())
    _, gap_b = rel_err(hier_b.coarse_chol, chol_hb)
    host_b = with_coarse(setup_b, dofs_hb, hier_b.coarse_minv, chol_hb.float())
    c_b = hier_b.levels[-1]
    r_b = torch.where(c_b.solvable, torch.randn(c_b.shape, generator=gen, device=dev), 0.0)
    _, solve_b = rel_err(mg.coarse_solve(hier_b, r_b), mg.coarse_solve(host_b.problem.hier, r_b))
    res_b = {tag: free_surface.project(s_, vel_b, config=cfg_b) for tag, s_ in (("card", setup_b), ("host", host_b))}
    _, p_b = rel_err(res_b["card"].pressure, res_b["host"].pressure)
    print(f"[13b] {m_b}^3 bench splash with max_mg_levels={cap_b}: levels {[tuple(c.shape) for c in hier_b.levels]}, "
          f"coarsest {int(c_b.solvable.sum()):,} DOFs, bucket {nd_pad_b} (Cholesky); setup {t_setup_b:.3f} s; "
          f"_finish_hierarchy on the card {ms_b['card']:.2f} ms with {sum(syncs_b.values())} host syncs, host fp64 "
          f"factor (coarse_system) {ms_b['host']:.2f} ms [{card}]")
    print(f"[13b] card factor: info {info_b}, finite {finite_b}, lower {torch.equal(hier_b.coarse_chol, hier_b.coarse_chol.tril())}; "
          f"max relative gap to np.linalg.cholesky in fp64 {gap_b:.3e}; coarse_solve vs the host factor's {solve_b:.3e}; "
          f"slot maps equal {torch.equal(hier_b.coarse_dofs, dofs_hb)}; projection iterations card "
          f"{res_b['card'].cg.iterations} vs host factor {res_b['host'].cg.iterations}, pressure max relative "
          f"difference {p_b:.3e}")
    require(info_b == 0 and finite_b, "[13b] the card Cholesky factor failed")
    require(sum(syncs_b.values()) == 1, "[13b] the card path does not sync the host exactly once")
    require(torch.equal(hier_b.coarse_dofs, dofs_hb) and torch.equal(card_b.coarse_chol, hier_b.coarse_chol),
            "[13b] the Cholesky path is not reproducible or its slot map differs")
    require(gap_b <= 1e-4 and solve_b <= 1e-4, "[13b] the card factor differs from the host's beyond fp32 rounding")
    require(all(r.cg.converged for r in res_b.values())
            and abs(res_b["card"].cg.iterations - res_b["host"].cg.iterations) <= 1 and p_b <= 1e-3,
            "[13b] the projections with the card and host factors differ")
    del setup_b, host_b, hier_b, levels_b, label_levels_b, card_b, res_b, chol_hb, phi_b, vel_b, w_b

    # [13c] The bench projections with the card inverse (phase 3's setup, and
    # the 512^3 splash of [11e] / [12d]) against the same setups with the host
    # path's inverse swapped in.
    res_ch = free_surface.project(with_coarse(setup, *host_a), velocity, config=config)
    _, p_c = rel_err(result.pressure, res_ch.pressure)
    print(f"[13c] {n}^3 projection: iterations card inverse {iters} vs host inverse {res_ch.cg.iterations} "
          f"(with the host path, as recorded in PERF.md: 17), pressure max relative difference {p_c:.3e}")
    require(res_ch.cg.converged and abs(iters - res_ch.cg.iterations) <= 1 and p_c <= 1e-3,
            "[13c] the bench projection differs between the card and host inverses")
    ne = 2 * n
    graph.PROGRAMS.clear()
    torch.cuda.empty_cache()
    phi_e, vel_e = sdf.splash_scene((ne, ne, ne), device=dev, dtype=torch.float32)
    w_e = sdf.open_box_weights((ne, ne, ne), device=dev, dtype=torch.float32)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    setup_e = free_surface.build_setup(phi_e, w_e, config=config)
    torch.cuda.synchronize()
    t_setup_e = time.perf_counter() - t0
    levels_e, _, label_levels_e = window_levels(phi_e, setup_e, config)
    host_e = mg.coarse_system(label_levels_e[-1], torch.float32, dev)
    del phi_e, w_e, levels_e, label_levels_e
    res_ce = {tag: free_surface.project(s_, vel_e, config=config)
              for tag, s_ in (("card", setup_e), ("host", with_coarse(setup_e, *host_e)))}
    _, p_e = rel_err(res_ce["card"].pressure, res_ce["host"].pressure)
    _, gap_e = rel_err(setup_e.problem.hier.coarse_minv, host_e[1])
    print(f"[13c] {ne}^3 projection (window {setup_e.expanded_shape}, coarse bucket "
          f"{setup_e.problem.hier.coarse_minv.shape[0]}, setup {t_setup_e:.3f} s): iterations card inverse "
          f"{res_ce['card'].cg.iterations} vs host inverse {res_ce['host'].cg.iterations} (with the host path, as recorded in PERF.md: 23), "
          f"pressure max relative difference {p_e:.3e}; inverse gap {gap_e:.3e} [{card}]")
    require(all(r.cg.converged for r in res_ce.values())
            and abs(res_ce["card"].cg.iterations - res_ce["host"].cg.iterations) <= 1 and p_e <= 1e-3,
            "[13c] the 512^3 projection differs between the card and host inverses")
    del setup_e, vel_e, res_ce, host_e
    torch.cuda.empty_cache()

    # [13d] run() over phase 7's frames, from phase 9's runs in turns with
    # run_fused: seconds per frame by stage and host syncs per frame.
    best9 = runs9[min(range(2), key=lambda i: per_path["run()"][i])]
    stage9 = {k: sum(fr.seconds[k] for fr in best9) / frames_n for k in ("advect", "setup", "project")}
    sites_run = sites9["run()"][1]
    print(f"[13d] run() at {n}^3 (phase 9): {min(per_path['run()']):.4f} s per frame, best of 2 in turns (each: "
          f"{', '.join(f'{t:.4f}' for t in per_path['run()'])}; with the host coarse path, as recorded in PERF.md: "
          f"0.3163 s), by stage {', '.join(f'{k} {v:.4f} s' for k, v in stage9.items())} (host coarse path: setup "
          f"0.172-0.199 s); run_fused {min(per_path['run_fused']):.4f} s per frame [{card}]")
    print(f"[13d] run(): {sum(sites_run.values()) / frames_n:.1f} host syncs per frame (host coarse path: 42.8), "
          f"{sum(v for k, v in sites_run.items() if k.startswith('solver/mg.py')) / frames_n:.1f} of them in "
          f"solver/mg.py (_finish_hierarchy's one fetch); iterations "
          f"{[fr.iterations for fr in best9]}")
    print(f"[13] phase 13 took {time.perf_counter() - t13:.1f} s [{card}]")

    # ---- 14. the CG loop as a captured CUDA graph against the eager loop -----------------
    # Phases 14 and 15 measure the per-solve capture of the CG loop and
    # run_fused's frame graphs with the program cache off (phase 16 turns
    # it back on).
    graph.PROGRAMS.clear()
    graph.PROGRAMS.enabled = False
    torch.cuda.empty_cache()
    t14 = time.perf_counter()
    k14 = graph.REPLAYS
    # [14a] The bench projection through the graph and eagerly, residual
    # histories on: iterations, history and pressure bit for bit, launch
    # counts exact and equal, host syncs of one solve each.
    cfg_r = dataclasses.replace(config, record_residuals=True)
    runs14 = {}
    for eager in (False, True):
        reset_counts()
        graph.STATS.reset()
        with loop_mode(eager):
            res14 = free_surface.project(setup, velocity, config=cfg_r)
            torch.cuda.synchronize()
        runs14[eager] = (res14, read_counts(), dataclasses.replace(graph.STATS))
    (res_g, counts_g, stats_g), (res_e, counts_e, _) = runs14[False], runs14[True]
    it14 = res_g.cg.iterations
    want14 = expected_launches(hier, cfg_r, it14)
    hist_bits = torch.equal(torch.nan_to_num(res_g.cg.residual_history, nan=-1.0),
                            torch.nan_to_num(res_e.cg.residual_history, nan=-1.0))
    p_bits = torch.equal(res_g.pressure, res_e.pressure)
    syncs14 = {}
    for eager in (False, True):
        with loop_mode(eager):
            _, sites = count_syncs(lambda: mgpcg.solve(setup.problem, rhs, config=config))
        syncs14["eager" if eager else "graph"] = (sum(sites.values()), dict(sites))
    print(f"[14a] {n}^3 projection, graph (K = {k14}) vs eager: iterations {it14} vs {res_e.cg.iterations}; "
          f"pressure bit-equal {p_bits}, residual history bit-equal {hist_bits}; one capture: "
          f"{stats_g.capture_seconds * 1e3:.2f} ms capturing, {stats_g.instantiate_seconds * 1e3:.2f} ms "
          f"instantiating, {stats_g.launches} graph launches, {stats_g.reads} host reads; "
          f"kernel launches {counts_g} (eager {counts_e}, expected {want14}) [{card}]")
    for tag, (total, sites) in syncs14.items():
        print(f"[14a] host syncs per mgpcg.solve, {tag}: {total}, by source line {sites}")
    require(it14 == res_e.cg.iterations == iters, "[14a] graph and eager iterations differ")
    require(p_bits and hist_bits, "[14a] the graph's pressure or residual history differs from the eager loop's")
    require(counts_g == counts_e == want14, "[14a] the graph's launch counts differ from the plan")
    require(stats_g.captures == 1, "[14a] the projection did not capture exactly once")
    require(syncs14["graph"][0] <= -(-it14 // k14) + 3,
            f"[14a] {syncs14['graph'][0]} host syncs per graph solve, over ceil({it14}/{k14}) + 3")

    # [14b] Sizes: graph and eager in turns (g e, e g, g e), best of 3 each;
    # x and iterations equal; host syncs, peak device memory above what the
    # run holds, capture ms and launches; one profiled solve each (device
    # ms, the host's launch calls).
    sizes14 = sorted({max(n // 4, 16), n // 2, n, 2 * n})
    for m in sizes14:
        if m == n:
            s_m, rhs_m = setup, rhs
        else:
            phi_m, vel_m = sdf.splash_scene((m, m, m), device=dev, dtype=torch.float32)
            s_m = free_surface.build_setup(phi_m, sdf.open_box_weights((m, m, m), device=dev, dtype=torch.float32),
                                           config=config)
            rhs_m = bench_rhs(s_m, vel_m)
            del phi_m, vel_m
        dofs_m = int(s_m.problem.fine.solvable.sum())
        for eager in (False, True):
            timed_solve(s_m.problem, rhs_m, config, eager)  # warm-up
        best = {}
        for order in ((False, True), (True, False), (False, True)):
            for eager in order:
                got = timed_solve(s_m.problem, rhs_m, config, eager)
                prev = best.get(eager)
                best[eager] = got if prev is None else min(prev, got, key=lambda r: r[1])
                best.setdefault(("events", eager), []).append(got[2])
        (rg, wg, _, sg), (re_, we, _, _) = best[False], best[True]
        peak = {}
        for eager in (False, True):
            torch.cuda.synchronize()
            base_mem = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            timed_solve(s_m.problem, rhs_m, config, eager)
            peak[eager] = (torch.cuda.max_memory_allocated() - base_mem) / 2**30
        syncs_m = {}
        for eager in (False, True):
            with loop_mode(eager):
                syncs_m[eager] = sum(count_syncs(lambda: mgpcg.solve(s_m.problem, rhs_m, config=config))[1].values())
        prof_m = {eager: profiled_solve(s_m.problem, rhs_m, config, eager) for eager in (False, True)}
        ev = {eager: min(best[("events", eager)]) for eager in (False, True)}
        print(f"[14b] {m}^3 ({dofs_m:,} DOFs, {rg.iterations} iterations): best solve graph {wg:.3f} ms wall, "
              f"{ev[False]:.3f} ms between CUDA events; eager {we:.3f} ms wall, {ev[True]:.3f} ms between events "
              f"(each, between events: graph {', '.join(f'{t:.3f}' for t in best[('events', False)])}; eager "
              f"{', '.join(f'{t:.3f}' for t in best[('events', True)])}) [{card}]")
        print(f"[14b] {m}^3: host syncs per solve graph {syncs_m[False]}, eager {syncs_m[True]}; capture "
              f"{sg.capture_seconds * 1e3:.2f} ms + instantiate {sg.instantiate_seconds * 1e3:.2f} ms, "
              f"{sg.launches} graph launches, {sg.reads} reads, {sg.cache_releases} cache releases; peak device memory "
              f"above the held {peak[False]:.3f} GiB graph, {peak[True]:.3f} GiB eager [{card}]")
        for eager in (False, True):
            pr = prof_m[eager]
            print(f"[14b] {m}^3 profiled {'eager' if eager else 'graph'} solve: device {pr['device_ms']:.3f} ms in "
                  f"{pr['device_launches']} device launches and copies, port kernels by name {pr['port_kernels']}, "
                  f"launch counters (on the device) {pr['counters']}; host launch calls {pr['launch_calls']} [{card}]")
        if m in (sizes14[0], n):
            # Where the graph profile puts the device time of the IF bodies:
            # its device events by key against the eager profile's.
            kg, ke = prof_m[False]["keys"], prof_m[True]["keys"]
            moved = sorted(set(kg) | set(ke), key=lambda k: -abs(kg.get(k, (0, 0.0))[1] - ke.get(k, (0, 0.0))[1]))
            print(f"[14b] {m}^3 device events, graph profile against eager (count, ms), largest differences: "
                  + "; ".join(f"{k[:90]}: {kg.get(k, (0, 0.0))[0]}, {kg.get(k, (0, 0.0))[1]:.3f} against "
                              f"{ke.get(k, (0, 0.0))[0]}, {ke.get(k, (0, 0.0))[1]:.3f}" for k in moved[:8]))
        for eager in (False, True):
            pr = prof_m[eager]
            named = [pr["port_kernels"].get(k, 0) for k in ("smooth_chunk_kernel", "cg_step_kernel")]
            counted = [pr["counters"].get(k, 0) for k in ("smoother", "cg_step")]
            print(f"[14b] {m}^3 {'eager' if eager else 'graph'}: chunk and CG-step kernels in the profile {named}, "
                  f"on the device counters {counted}: {'agree' if named == counted else 'DIFFER'}")
        require(prof_m[False]["counters"] == prof_m[True]["counters"],
                f"[14b] {m}^3: the profiled graph solve's launch counters differ from the eager solve's")
        require(rg.iterations == re_.iterations and torch.equal(rg.x, re_.x),
                f"[14b] {m}^3: the graph's iterations or x differ from the eager loop's")
        require(rg.converged and sg.captures == 1, f"[14b] {m}^3: the graph solve failed")
        require(syncs_m[False] <= -(-rg.iterations // k14) + 3, f"[14b] {m}^3: too many host syncs per graph solve")
        if m == sizes14[-1]:
            # A finished solve's capture pool goes back to the allocator: the
            # largest solve, then the smallest, then empty_cache.
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            pools0, held0 = private_pools(), torch.cuda.memory_reserved()
            mem = {}
            for tag, (s_x, rhs_x) in ((f"{m}^3", (s_m, rhs_m)), (f"then {sizes14[0]}^3", small14)):
                timed_solve(s_x.problem, rhs_x, config, False)
                mem[tag] = torch.cuda.memory_reserved()
            torch.cuda.empty_cache()
            mem["then empty_cache"] = torch.cuda.memory_reserved()
            pools1 = private_pools()
            print(f"[14b] reserved device memory, GiB: before {held0 / 2**30:.3f}, "
                  + ", ".join(f"after a graph solve at {k} {v / 2**30:.3f}" if "^3" in k else f"{k} {v / 2**30:.3f}"
                              for k, v in mem.items())
                  + f"; private pools holding memory before {len(pools0)}, after {len(pools1)} [{card}]")
            require(pools1 <= pools0, "[14b] a finished solve's capture pool still holds device memory")
        if m == sizes14[0]:
            small14 = (s_m, rhs_m)
        elif m != n:
            del s_m, rhs_m
            torch.cuda.empty_cache()
    del small14

    # [14c] The K sweep (launches per host read): the bench solve and the
    # smallest size, each K in turns, best of 3.
    for m in (n, sizes14[0]):
        if m == n:
            s_m, rhs_m = setup, rhs
        else:
            phi_m, vel_m = sdf.splash_scene((m, m, m), device=dev, dtype=torch.float32)
            s_m = free_surface.build_setup(phi_m, sdf.open_box_weights((m, m, m), device=dev, dtype=torch.float32),
                                           config=config)
            rhs_m = bench_rhs(s_m, vel_m)
        sweep = {}
        try:
            for _ in range(3):
                for kk in (1, 4, 8, 16):
                    graph.REPLAYS = kk
                    res_k, wall_k, ev_k, st_k = timed_solve(s_m.problem, rhs_m, config, False)
                    require(res_k.iterations == iters if m == n else res_k.converged, f"[14c] K = {kk} failed")
                    sweep.setdefault(kk, []).append((wall_k, ev_k, st_k.reads, st_k.launches))
        finally:
            graph.REPLAYS = k14
        print(f"[14c] {m}^3 K sweep, best of 3 in turns: " + "; ".join(
            f"K = {kk}: {min(r[0] for r in rs):.3f} ms wall, {min(r[1] for r in rs):.3f} ms between events, "
            f"{rs[0][2]} reads, {rs[0][3]} launches" for kk, rs in sweep.items()) + f" [{card}]")

    # [14d] Every single-process path through the graph: captures per solve.
    mesh14 = parallel.make_mesh(4, device=dev)
    paths14 = {
        "mgpcg.solve": (lambda: mgpcg.solve(setup.problem, rhs, config=config), 1),
        "free_surface.project": (lambda: free_surface.project(setup, velocity, config=config), 1),
        "project(mesh=make_mesh(4))": (lambda: free_surface.project(setup, velocity, config=config, mesh=mesh14), 1),
        "kernel_mode='torch'": (lambda: mgpcg.solve(setup.problem, rhs, config=config_t), 1),
        "chebyshev smoother": (lambda: mgpcg.solve(setup.problem, rhs, config=dataclasses.replace(
            config, interior_smoother="chebyshev", chebyshev_degree=3)), 1),
        "simulate.run, 2 frames": (lambda: simulate.run(phi0, vel0, weights, num_frames=2, config=sim_cfg), 2),
    }
    seen14 = {}
    for tag, (fn, solves_n) in paths14.items():
        graph.STATS.reset()
        fn()
        torch.cuda.synchronize()
        seen14[tag] = (graph.STATS.captures, solves_n)
    # run_fused's solves run inside its frame graph (phase 15): one frame
    # capture per frozen geometry, no capture of the CG loop alone.
    graph.STATS.reset()
    simulate.run_fused(phi0, vel0, weights, num_frames=2, config=sim_cfg, chunk=2)
    torch.cuda.synchronize()
    fused14 = (graph.STATS.captures, graph.STATS.frame_captures)
    print(f"[14d] graph captures / solves by entry point: "
          + ", ".join(f"{tag} {c}/{s_}" for tag, (c, s_) in seen14.items())
          + f"; run_fused, 2 frames: {fused14[0]} CG-loop captures, {fused14[1]} frame capture [{card}]")
    require(all(c == s_ for c, s_ in seen14.values()), "[14d] a single-process solve did not run as the graph")
    require(fused14 == (0, 1), "[14d] run_fused's frames did not run as one frame graph")

    # [14e] run() and run_fused per frame at n^3, graph against eager in
    # turns (twice), and host syncs per frame of each.
    frames14 = {}
    for _ in range(2):
        for eager in (False, True):
            for tag in ("run()", "run_fused"):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                with loop_mode(eager):
                    if tag == "run()":
                        simulate.run(phi0, vel0, weights, num_frames=frames_n, config=sim_cfg)
                    else:
                        simulate.run_fused(phi0, vel0, weights, num_frames=frames_n, config=sim_cfg, chunk=frames_n)
                    torch.cuda.synchronize()
                frames14.setdefault((tag, eager), []).append((time.perf_counter() - t0) / frames_n)
    syncs_f = {}
    for eager in (False, True):
        with loop_mode(eager):
            _, sites = count_syncs(lambda: simulate.run(phi0, vel0, weights, num_frames=frames_n, config=sim_cfg))
        syncs_f[eager] = sum(sites.values()) / frames_n
    for (tag, eager), ts in frames14.items():
        print(f"[14e] {tag} {'eager' if eager else 'graph'}: {min(ts):.4f} s per {n}^3 frame, best of 2 in turns "
              f"(each: {', '.join(f'{t:.4f}' for t in ts)}) [{card}]")
    print(f"[14e] run() host syncs per frame: graph {syncs_f[False]:.1f}, eager {syncs_f[True]:.1f}")
    print(f"[14] phase 14 took {time.perf_counter() - t14:.1f} s [{card}]")

    # ---- 15. the fused frame chunk as one captured CUDA graph per frozen geometry ---------
    # run_fused at n^3 in the bench configuration (phase 7's), 2 chunks of
    # 4 frames: each frame one launch of graph.FrameGraph, against the same
    # frames run eagerly (graph.EmulatedFrame, `eager_cg_loop`) and run().
    t15 = time.perf_counter()
    frames15, chunk15 = 8, 4

    def fused15(eager: bool, **kw):
        with loop_mode(eager):
            return simulate.run_fused(phi0, vel0, weights, num_frames=frames15, config=sim_cfg, chunk=chunk15, **kw)

    # [15a] graph and eager: iterations, fields bit for bit, launch counts,
    # captures, frame launches and chunk reads.
    runs15 = {}
    for eager in (False, True):
        chunks15 = []
        reset_counts()
        graph.STATS.reset()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        out = fused15(eager, on_chunk=lambda done, st, c=chunks15: c.append(done))
        torch.cuda.synchronize()
        peak = (torch.cuda.max_memory_allocated() - held) / 2**30
        runs15[eager] = (out, read_counts(), dataclasses.replace(graph.STATS), chunks15, peak)
    (g15, g_counts, g_stats, g_chunks, g_peak), (e15, e_counts, e_stats, e_chunks, e_peak) = runs15[False], runs15[True]
    it_g, it_e = [int(i) for i in g15[3]["iterations"]], [int(i) for i in e15[3]["iterations"]]
    fields15 = {"phi": (g15[0], e15[0]), "pressure": (g15[2], e15[2]),
                **{f"velocity {a}": (g15[1][a], e15[1][a]) for a in range(3)}}
    diffs15 = {k: rel_err(a, b)[1] for k, (a, b) in fields15.items()}
    bits15 = all(torch.equal(a, b) for a, b in fields15.values())
    print(f"[15a] run_fused {frames15} frames in chunks of {chunk15} at {n}^3: chunks run fused graph {g_chunks}, "
          f"eager {e_chunks}; iterations graph {it_g}, eager {it_e}; fields bit-equal {bits15}, max relative "
          f"difference {', '.join(f'{k} {v:.3e}' for k, v in diffs15.items())}")
    print(f"[15a] device launch counts graph {g_counts}, eager {e_counts}; frame captures {g_stats.frame_captures}, "
          f"frame launches {g_stats.frame_launches}, chunk reads {g_stats.frame_reads}, CG-loop captures "
          f"{g_stats.captures}; capture {g_stats.frame_capture_seconds * 1e3:.1f} ms + instantiate "
          f"{g_stats.frame_instantiate_seconds * 1e3:.1f} ms; peak memory above the held, graph {g_peak:.3f} GiB, "
          f"eager {e_peak:.3f} GiB; the frame pool {graph.expected_bytes(dev, 'frame') / 2**30:.3f} GiB [{card}]")
    require(g_chunks == e_chunks == [chunk15, frames15], "[15a] a chunk did not run fused")
    require(it_g == it_e, "[15a] graph iterations differ from the eager frames'")
    require(bits15, "[15a] graph fields differ from the eager frames' bits")
    require(g_counts == e_counts and g_counts["smoother"] > 0 and g_counts["cg_step"] == sum(it_g),
            "[15a] graph launch counts differ from the eager frames'")
    require((g_stats.frame_captures, g_stats.frame_launches, g_stats.frame_reads, g_stats.captures)
            == (1, frames15, frames15 // chunk15, 0), "[15a] not one capture, one launch per frame, one read per chunk")
    require(all(r <= sim_cfg.tolerance for r in g15[3]["relative_residual"]), "[15a] a graph frame did not converge")

    # [15b] Host syncs: every frame launch under set_sync_debug_mode("error")
    # (a sync inside a frame raises), the whole call counted by source line.
    launch15 = graph.FrameGraph.launch

    def strict_launch(self):
        mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("error")
        try:
            launch15(self)
        finally:
            torch.cuda.set_sync_debug_mode(mode)

    graph.FrameGraph.launch = strict_launch
    try:
        _, sites15 = count_syncs(lambda: fused15(False))
    finally:
        graph.FrameGraph.launch = launch15
    _, sites15e = count_syncs(lambda: fused15(True))
    print(f"[15b] host syncs: 0 inside the {frames15} frame launches (sync debug mode 'error'); whole run_fused call "
          f"{sum(sites15.values())} (eager frames {sum(sites15e.values())}), by source line: "
          f"{dict(sites15.most_common(8))}")
    require(not any(k.startswith(("solver/cg.py", "solver/graph.py")) for k in sites15),
            "[15b] the CG loop of a captured frame read the host")

    # [15c] Against run(): iterations +-1, fields within 1e-3 (phase 9's limits).
    runs_r = simulate.run(phi0, vel0, weights, num_frames=frames15, config=sim_cfg)
    _, rel_r = rel_err(g15[2], runs_r[-1].pressure)
    print(f"[15c] run() iterations {[fr.iterations for fr in runs_r]}; frame {frames15} pressure max relative "
          f"difference from run_fused {rel_r:.3e}")
    require(all(abs(a - fr.iterations) <= 1 for a, fr in zip(it_g, runs_r)) and rel_r <= 1e-3,
            "[15c] run_fused differs from run()")

    # [15d] Seconds per frame, graph and eager in turns (g e e g), each call
    # whole (geometry and capture included) and its chunk's launches alone
    # (one FrameGraph on phase 7's first geometry, CUDA events around a
    # chunk of launches: device ms per frame, and the host's time to issue
    # them).
    per15 = {False: [], True: []}
    for eager in (False, True, True, False):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fused15(eager)
        torch.cuda.synchronize()
        per15[eager].append((time.perf_counter() - t0) / frames15)
    geom15, prep15 = simulate.freeze_geometry(phi0, weights, None, sim_cfg)
    state15 = (phi0, *vel0, torch.zeros_like(phi0))
    chunk_ms = {}
    for eager in (False, True, True, False):
        buf15 = simulate.frame_buffers(state15, chunk15)
        runner15 = graph.EmulatedFrame if eager else graph.FrameGraph
        frame15 = runner15(simulate.frozen_frame(buf15, weights, None, sim_cfg, geom15, 1.0 / 120.0, -9.8),
                           dev, prep15)
        try:
            for b_, t_ in zip(buf15.state, state15):
                b_.copy_(t_)
            torch.cuda.synchronize()
            start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            for _ in range(chunk15):
                frame15.launch()
            stop.record()
            t_issue = time.perf_counter() - t0
            torch.cuda.synchronize()
            t_wall = time.perf_counter() - t0
            chunk_ms.setdefault(eager, []).append(
                (start.elapsed_time(stop) / chunk15, t_issue * 1e3 / chunk15, t_wall * 1e3 / chunk15))
        finally:
            frame15.close()
    for eager in (False, True):
        tag = "eager" if eager else "graph"
        best = min(chunk_ms[eager])
        print(f"[15d] {tag}: {min(per15[eager]):.4f} s per frame of the whole run_fused call, best of 2 in turns "
              f"(each: {', '.join(f'{t:.4f}' for t in per15[eager])}); a chunk's launches alone: "
              f"{best[2]:.2f} ms wall per frame, {best[0]:.2f} ms between CUDA events, host {best[1]:.2f} ms to "
              f"issue each frame [{card}]")

    # [15e] Advection's device time apart (PERF.md section 7): the frame's
    # advection and gravity at n^3, CUDA events over 5 calls.
    dx15 = 1.0 / n

    def advect15():
        new_phi, new_vel = simulate._advect(phi0, vel0, 1.0 / 120.0, dx15, sim_cfg)
        return new_phi, new_vel[1] + (-9.8) * (1.0 / 120.0)

    adv_ms = cuda_ms(advect15, 5)
    print(f"[15e] advection + gravity at {n}^3 ({sim_cfg.advection}): {adv_ms:.3f} ms on the device "
          f"(CUDA events, 5 calls) [{card}]")
    print(f"[15] phase 15 took {time.perf_counter() - t15:.1f} s [{card}]")

    # ---- 16. setup, solve and projection as programs captured once per key ----------------
    # The program cache (graph.PROGRAMS) back on, emptied: phases 14-15 ran
    # with it off.  The cached path against the cache off (the setup eager,
    # each solve's CG loop captured anew), at the bench configuration.
    graph.PROGRAMS.enabled = True
    graph.PROGRAMS.clear()
    torch.cuda.empty_cache()
    t16 = time.perf_counter()
    frames16 = 8
    gib = 2.0 ** 30

    def programs16(cached: bool):
        return contextlib.nullcontext() if cached else graph.programs_off()

    # [16a] run() with the sticky window, 8 frames, cached and off in turns
    # (on, off, off, on): captures per window key and replays, host syncs
    # per frame, seconds per frame by stage, iterations and fields.
    keys16 = []

    def on_frame16(k, fr):
        hier_k = fr.setup.problem.hier
        keys16.append((fr.setup.expanded_shape, max(hier_k.coarse_minv.shape[0], hier_k.coarse_chol.shape[0]),
                       k > 0))

    runs16, per16, stats16 = {True: [], False: []}, {True: [], False: []}, {True: [], False: []}
    for cached in (True, False, False, True):
        keys16.clear()
        graph.STATS.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with programs16(cached):
            frs = simulate.run(phi0, vel0, weights, num_frames=frames16, config=config, on_frame=on_frame16)
        torch.cuda.synchronize()
        per16[cached].append((time.perf_counter() - t0) / frames16)
        runs16[cached].append(frs)
        stats16[cached].append((dataclasses.replace(graph.STATS), list(keys16)))
    first_stats, keys_a = stats16[True][0]
    shapes_a = {k[0] for k in keys_a}
    want_caps = {"setup": len(shapes_a), "project": len(set(keys_a))}
    caps_a = {k: first_stats.program_captures[k] for k in ("setup", "project")}
    hits_a = {k: first_stats.program_hits[k] for k in ("setup", "project")}
    caps_b = dict(stats16[True][1][0].program_captures)
    hits_b = {k: stats16[True][1][0].program_hits[k] for k in ("setup", "project")}
    print(f"[16a] run() {frames16} frames at {n}^3, cached: window keys (shape, coarse bucket, warm start) "
          f"{sorted(set(keys_a))}; first run captures {caps_a} (one per window key: {want_caps}), replays {hits_a}, "
          f"capture seconds { {k: round(v, 4) for k, v in first_stats.program_capture_seconds.items()} }; second "
          f"run captures {caps_b}, replays {hits_b}; CG-loop captures cached {first_stats.captures}, off "
          f"{stats16[False][0][0].captures} [{card}]")
    ref_frames = runs16[False][0]
    bits16 = all(
        a.iterations == b.iterations and torch.equal(a.pressure, b.pressure) and torch.equal(a.liquid_phi, b.liquid_phi)
        and all(torch.equal(u, v) for u, v in zip(a.velocity, b.velocity))
        for frs in runs16[True] + runs16[False][1:] for a, b in zip(frs, ref_frames))
    print(f"[16a] iterations cached {[fr.iterations for fr in runs16[True][0]]}, off "
          f"{[fr.iterations for fr in ref_frames]}; every frame's pressure, phi and velocity bit-equal across the "
          f"four runs: {bits16}")
    for cached in (True, False):
        tag = "cached" if cached else "off"
        for i, frs in enumerate(runs16[cached]):
            stage = {k: sum(fr.seconds[k] for fr in frs) / frames16 for k in ("advect", "setup", "project")}
            steady = {k: sum(fr.seconds[k] for fr in frs[2:]) / (frames16 - 2) for k in ("setup", "project")}
            print(f"[16a] {tag} run {i + 1}: {per16[cached][i]:.4f} s per frame, by stage "
                  f"{', '.join(f'{k} {v:.4f}' for k, v in stage.items())} s; frames 3-{frames16}: "
                  f"{', '.join(f'{k} {v:.4f}' for k, v in steady.items())} s [{card}]")
    runs16.clear()  # 32 frames of fields, ~10 GiB
    syncs16 = {}
    for cached in (True, False):
        with programs16(cached):
            _, sites = count_syncs(lambda: simulate.run(phi0, vel0, weights, num_frames=frames16, config=config))
        syncs16[cached] = (sum(sites.values()) / frames16, dict(sites.most_common(6)))
    print(f"[16a] host syncs per frame: cached {syncs16[True][0]:.1f}, off {syncs16[False][0]:.1f}; by source line, "
          f"cached {syncs16[True][1]}; off {syncs16[False][1]}")
    copies16 = {}
    for key16, prog in graph.PROGRAMS.entries.items():
        if key16[0] in ("setup", "project") and key16[0] not in copies16:
            nb_in = graph._nbytes(graph.tensors(prog.inputs))
            nb_out = graph._nbytes(graph.tensors(prog.outputs))
            src16 = graph._clone(prog.inputs)  # other tensors than the buffers: copy_ skips a self-copy
            copies16[key16[0]] = (nb_in, cuda_ms(lambda p=prog, x=src16: p._copy_in(x), 5), nb_out,
                                  cuda_ms(lambda p=prog: graph._clone(p.outputs), 5), prog.pool_bytes)
            del src16
    for kind16, (nb_in, ms_in, nb_out, ms_out, pool16) in copies16.items():
        print(f"[16a] {kind16} program: copy in {nb_in / gib:.3f} GiB in {ms_in:.3f} ms, copy out {nb_out / gib:.3f} GiB "
              f"in {ms_out:.3f} ms per call (CUDA events, 5 calls); pool and buffers {pool16 / gib:.3f} GiB [{card}]")
    require(bits16, "[16a] the cached frames differ from the frames with the cache off")
    require(caps_a == want_caps, "[16a] run() did not capture its setup and projection once per window key")
    require(sum(caps_b.values()) == 0, "[16a] a second run() of the same window keys captured again")
    require(first_stats.captures == 0, "[16a] a cached run() captured a CG loop per solve")

    # [16b] mgpcg.solve 5 times on one problem at 64^3 and n^3: one capture,
    # x bit-equal across the repeats and to the cache off; wall and CUDA-event
    # ms per solve.
    for m in (64, n):
        if m == n:
            s_m, rhs_m = setup, rhs
        else:
            phi_m, vel_m = sdf.splash_scene((m, m, m), device=dev, dtype=torch.float32)
            s_m = free_surface.build_setup(phi_m, sdf.open_box_weights((m, m, m), device=dev, dtype=torch.float32),
                                           config=config)
            rhs_m = bench_rhs(s_m, vel_m)
        with graph.programs_off():
            ref_m = mgpcg.solve(s_m.problem, rhs_m, config=config)
        graph.STATS.reset()
        got_m, wall_m, ev_m = [], [], []
        for _ in range(5):
            start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            start.record()
            got_m.append(mgpcg.solve(s_m.problem, rhs_m, config=config))
            stop.record()
            torch.cuda.synchronize()
            wall_m.append((time.perf_counter() - t0) * 1e3)
            ev_m.append(start.elapsed_time(stop))
        caps_m, hits_m = graph.STATS.program_captures["solve"], graph.STATS.program_hits["solve"]
        same_m = all(torch.equal(r.x, got_m[0].x) and r.iterations == got_m[0].iterations for r in got_m)
        print(f"[16b] mgpcg.solve at {m}^3, 5 times: {caps_m} capture, {hits_m} replays; iterations "
              f"{[r.iterations for r in got_m]} (off {ref_m.iterations}); x bit-equal across the repeats {same_m}, to "
              f"the cache off {torch.equal(got_m[0].x, ref_m.x)}; ms per solve wall {[round(t, 3) for t in wall_m]}, "
              f"CUDA events {[round(t, 3) for t in ev_m]} (first against the best later: {wall_m[0]:.3f} / "
              f"{min(wall_m[1:]):.3f} wall) [{card}]")
        require(caps_m == 1 and hits_m == 4, f"[16b] {m}^3: not one capture and 4 replays")
        require(same_m and torch.equal(got_m[0].x, ref_m.x) and got_m[0].iterations == ref_m.iterations,
                f"[16b] {m}^3: the cached solves differ")
        if m != n:
            del s_m, rhs_m

    # [16c] setup_fusion "fused" against "per-level" at n^3: bit-equal setups,
    # setup seconds (the first call captures), programs per setup, pools.
    setups16, pools16 = {}, {}
    for fusion in ("fused", "per-level"):
        cfg_f = dataclasses.replace(config, setup_fusion=fusion)
        graph.PROGRAMS.clear()
        torch.cuda.empty_cache()
        graph.STATS.reset()
        secs = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            setups16[fusion] = free_surface.build_setup(liquid_phi, weights, config=cfg_f)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        (prog16,) = [p for k, p in graph.PROGRAMS.entries.items() if k[0] == "setup"]
        pools16[fusion] = graph.STATS.program_pool_bytes["setup"]
        print(f"[16c] {n}^3 setup_fusion={fusion!r}: build_setup {', '.join(f'{t:.4f}' for t in secs)} s (the first "
              f"captures); {graph.STATS.program_captures['setup']} program per setup of {len(prog16.graphs)} graphs, "
              f"replayed {graph.STATS.program_hits['setup']} times by the later two; pool and buffers "
              f"{pools16[fusion] / gib:.3f} GiB; capture {graph.STATS.program_capture_seconds['setup']:.4f} s [{card}]")
        del prog16
    t_f, t_p = graph.tensors(setups16["fused"].problem), graph.tensors(setups16["per-level"].problem)
    bits16c = len(t_f) == len(t_p) and all(torch.equal(a, b) for a, b in zip(t_f, t_p))
    t_3 = graph.tensors(setup.problem)
    bits16c3 = len(t_f) == len(t_3) and all(torch.equal(a, b) for a, b in zip(t_f, t_3))
    print(f"[16c] fused and per-level setups bit-equal {bits16c}; fused and phase 3's {bits16c3}; per-level's pool "
          f"{pools16['per-level'] / pools16['fused']:.3f}x fused's [{card}]")
    require(bits16c and bits16c3, "[16c] the granularities' setups differ")
    require(pools16["per-level"] <= 1.25 * pools16["fused"], "[16c] per-level holds more memory than fused")
    del setups16
    graph.PROGRAMS.clear()
    torch.cuda.empty_cache()
    m = 448
    try:
        phi_l, vel_l = sdf.splash_scene((m, m, m), device=dev, dtype=torch.float32)
        w_l = sdf.open_box_weights((m, m, m), device=dev, dtype=torch.float32)
        s_l = None
        for fusion in ("fused", "auto"):
            s_l = None  # the other granularity's setup goes before this build
            graph.PROGRAMS.clear()
            torch.cuda.empty_cache()
            graph.STATS.reset()
            torch.cuda.reset_peak_memory_stats()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            s_l = free_surface.build_setup(phi_l, w_l, config=dataclasses.replace(config, setup_fusion=fusion))
            torch.cuda.synchronize()
            cells = int(np.prod(s_l.expanded_shape))
            picked = dataclasses.replace(config, setup_fusion=fusion).setup_fusion_resolved(s_l.expanded_shape)
            print(f"[16c] {m}^3 setup_fusion={fusion!r}: window {s_l.expanded_shape} ({cells:,} cells, threshold "
                  f"{SolverConfig.SETUP_FUSION_AUTO_CELLS:,}) takes {picked!r}; the build completes in "
                  f"{time.perf_counter() - t0:.3f} s with {sum(graph.STATS.program_captures.values())} programs, "
                  f"pools and buffers {sum(graph.STATS.program_pool_bytes.values()) / gib:.3f} GiB, peak "
                  f"{torch.cuda.max_memory_allocated() / gib:.3f} GiB [{card}]")
        # The frame loop's pair at this size ("auto"): the setup and the
        # projection again, cached and with the cache off, in turns (3 each); each
        # program either replays or is not kept (no capture per call), and
        # the pair costs no more than with the cache off (PR 13's path).
        free_surface.project(s_l, vel_l, config=config)
        pair16 = {True: [], False: []}
        for cached in (True, False, False, True, True, False):
            graph.STATS.reset()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with programs16(cached):
                s_l = free_surface.build_setup(phi_l, w_l, config=config)
                r_l = free_surface.project(s_l, vel_l, config=config)
            torch.cuda.synchronize()
            pair16[cached].append(time.perf_counter() - t0)
            if cached:
                caps_l, hits_l = dict(graph.STATS.program_captures), dict(graph.STATS.program_hits)
                declined_l = dict(graph.STATS.program_declined)
        print(f"[16c] {m}^3 'auto' setup and projection ({r_l.cg.iterations} iterations) again, cached "
              f"{', '.join(f'{t:.4f}' for t in pair16[True])} s, off {', '.join(f'{t:.4f}' for t in pair16[False])} s "
              f"(in turns); the last cached pair captures {caps_l}, replays {hits_l}, runs uncached {declined_l}; the "
              f"cache holds {len(graph.PROGRAMS)} programs, {graph.PROGRAMS.held_bytes() / gib:.3f} GiB (budget "
              f"{graph.PROGRAMS.budget:.2f} of the card, a program kept up to half of it) [{card}]")
        require(sum(caps_l.values()) == 0, f"[16c] {m}^3: a second setup and projection captured again")
        require(min(pair16[True]) <= 1.10 * min(pair16[False]),
                f"[16c] {m}^3: the cached setup and projection cost more than with the cache off")
        del s_l, r_l, phi_l, vel_l, w_l
    except torch.cuda.OutOfMemoryError as exc:
        print(f"[16c] {m}^3: the allocator refused: {str(exc).splitlines()[0]} [{card}]")
    graph.PROGRAMS.clear()
    torch.cuda.empty_cache()

    # [16d] A drop moved inside a kept window: the setup program replays (no
    # capture) at the new origin and matches a fresh build with the cache
    # off bit for bit; so do the projections.
    pts16, _ = sdf.cell_centers((n, n, n), device=dev, dtype=torch.float32)
    drop0 = sdf.sphere_sdf(pts16, (0.35, 0.45, 0.5), 0.2)

    def drop16(shift: int):
        return torch.roll(drop0, shift, dims=0)  # air rolls in: the same drop, `shift` cells along x

    graph.STATS.reset()
    s_a = free_surface.build_setup(drop16(0), weights, config=config)
    caps_before = dict(graph.STATS.program_captures)
    s_b = free_surface.build_setup(drop16(3), weights, config=config, reuse_from=s_a)
    caps_after, hits_d = dict(graph.STATS.program_captures), graph.STATS.program_hits["setup"]
    with graph.programs_off():
        fresh = free_surface.build_setup(drop16(3), weights, config=config)
    t_b, t_fr = graph.tensors(s_b.problem), graph.tensors(fresh.problem)
    bits16d = len(t_b) == len(t_fr) and all(torch.equal(a, b) for a, b in zip(t_b, t_fr))
    p_b = free_surface.project(s_b, vel0, config=config)
    with graph.programs_off():
        p_fr = free_surface.project(fresh, vel0, config=config)
    p_a = free_surface.project(s_a, vel0, config=config)
    print(f"[16d] window {s_a.expanded_shape} kept: {s_b.expanded_shape}, origin {s_a.window_start} -> "
          f"{s_b.window_start} (fresh build {fresh.window_start}); setup captures {caps_before} then {caps_after}, "
          f"{hits_d} replay; setup bit-equal to the fresh build {bits16d}; projection iterations {p_b.cg.iterations} "
          f"(fresh {p_fr.cg.iterations}), pressure bit-equal {torch.equal(p_b.pressure, p_fr.pressure)}; the first "
          f"origin's projection after it: {p_a.cg.iterations} iterations, project captures "
          f"{graph.STATS.program_captures['project']}, replays {graph.STATS.program_hits['project']} [{card}]")
    require(s_b.expanded_shape == s_a.expanded_shape and s_b.window_start != s_a.window_start,
            "[16d] the drop did not move inside a kept window")
    require(caps_after == caps_before and hits_d == 1, "[16d] the moved origin captured the setup again")
    require(bits16d and s_b.window_start == fresh.window_start, "[16d] the replayed setup differs from a fresh build")
    require(torch.equal(p_b.pressure, p_fr.pressure) and p_b.cg.iterations == p_fr.cg.iterations,
            "[16d] the moved origin's projection differs from the fresh build's")
    del s_a, s_b, fresh, p_a, p_b, p_fr, pts16, drop0

    print(f"[16] phase 16 took {time.perf_counter() - t16:.1f} s [{card}]")

    src = "geometricmultigridpressuresolver_tpu_torch/csrc/"
    jax_src = "geometricmultigridpressuresolver_tpu/"
    # The band-strip and bf16-field rows are launches of the chunk kernel
    # (`counter` names the count they are in).
    kernels = [
        {"name": "smoother", "route": "cuda", "source": src + "smoother.cu",
         "replaces": jax_src + "ops/pallas_smoother.py:619"},
        {"name": "smoother_band_strip", "route": "cuda", "source": src + "smoother.cu",
         "replaces": jax_src + "ops/pallas_smoother.py:513", "counter": "smoother"},
        {"name": "smoother_bf16", "route": "cuda", "source": src + "smoother.cu",
         "replaces": jax_src + "ops/pallas_smoother.py:466", "counter": "smoother_bf16"},
        {"name": "cg_step", "route": "cuda", "source": src + "cg.cu",
         "replaces": jax_src + "ops/pallas_cg.py:329"},
        {"name": "residual", "route": "cuda", "source": src + "cg.cu",
         "replaces": jax_src + "ops/pallas_cg.py:253"},
        {"name": "halo", "route": "cuda", "source": src + "halo.cu",
         "replaces": jax_src + "parallel/halo.py:42"},
        {"name": "smoother_sharded", "route": "cuda", "source": src + "smoother.cu",
         "replaces": jax_src + "parallel/pallas_sharded.py:204"},
        {"name": "cg_step_sharded", "route": "cuda", "source": src + "cg.cu",
         "replaces": jax_src + "parallel/pallas_sharded.py:120"},
    ]
    for k in kernels:
        name = k["name"]
        counter = k.get("counter", name)
        # The bf16-field smoother runs on the bf16-field projection's path,
        # the block-mesh kernels on the block-mesh projection's.
        path = launches_h if name == "smoother_bf16" else launches_m if name in names[5:] else launches
        k.update(launches=path[counter], launches_distributed=[r["launches"][counter] for r in r11b],
                 launches_frame_loop=launches_loop[counter],
                 launches_fused_frames=launches_fused[counter], launches_test_node=launches_node[counter],
                 max_abs_err=errs[name],
                 ms=times[name][0], plain_ms=times[name][1], bound_ms=bounds[name][0],
                 bound_by=bounds[name][1], bound_active_ms=bounds[name][0],
                 bound_window_ms=bounds_window[name][0], bound_window_by=bounds_window[name][1],
                 library_ms=library[name])
        if name.startswith("smoother"):
            t = (sblk[0] if name == "smoother_sharded" else blk0h if name == "smoother_bf16" else blk0).tiles
            k.update(depth=t.depth, tile=list(t.core), active_tile_share=lengths(t)[0] / n_tiles(t))
        if name.startswith(("cg_step", "residual")):
            t = cg_tiles_s if name == "cg_step_sharded" else cg_tiles
            k.update(tile=list(t.core), active_tile_share=lengths(t)[0] / n_tiles(t))
        if name in dot_errs:
            k["dot_max_rel_err"] = dot_errs[name]
    print(json.dumps({"transfers": transfer_rows}))
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
