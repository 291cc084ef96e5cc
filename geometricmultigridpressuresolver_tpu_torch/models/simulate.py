"""Minimal incompressible free-surface simulation loop (PyTorch port).

Port of ``models/simulate.py``: the reference's ``flipSplash`` scene
without Houdini -- advect -> gravity -> MGPCG-project, frame after frame,
over the liquid SDF and the MAC velocity.  Each frame rebuilds the
projection setup (the liquid's topology changes), keeps the previous
frame's window shape while the liquid fits it (`build_setup(reuse_from=
...)`), and warm-starts CG from the previous pressure.  On CUDA tensors the
solve runs the port's kernels; the advection is plain PyTorch, as the JAX
package computes it outside Pallas.

  * run / step: the per-frame loop, with checkpoints every N frames
    (`save_state` / `load_state`, the native tiled format of `io`) and
    resume (`start_frame`, `old_pressure`); on the card the setup and the
    projection are programs captured once per window key and replayed
    frame after frame (`solver.graph.PROGRAMS`), as the JAX package
    reuses its compiled programs while the window is kept;
  * run_fused: chunks of frames on frozen geometry (window, level count,
    coarse bucket), the hierarchy and the coarse direct solve rebuilt on
    the device each frame with no host decision and no host read -- on
    the card one captured CUDA graph per frame, launched back to back --
    the geometry checked once per chunk and a failing chunk re-run
    through `run`.

    gmg-torch-simulate --n 128 --frames 24 --fp32 \\
        --checkpoint-dir out/ckpt --checkpoint-every 8 [--resume out/ckpt]
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import NamedTuple, Sequence

import numpy as np
import torch

from geometricmultigridpressuresolver_tpu_torch import device as device_mod
from geometricmultigridpressuresolver_tpu_torch import io as gmg_io
from geometricmultigridpressuresolver_tpu_torch.config import SolverConfig
from geometricmultigridpressuresolver_tpu_torch.models import free_surface
from geometricmultigridpressuresolver_tpu_torch.solver import graph, mgpcg
from geometricmultigridpressuresolver_tpu_torch.solver import mg as mg_mod


def _sl(axis: int, sl: slice) -> tuple:
    out = [slice(None)] * 3
    out[axis] = sl
    return tuple(out)


def _cell_center_velocity(velocity: Sequence[torch.Tensor]) -> tuple:
    """Average MAC faces to cell centers, per component."""
    return tuple(
        0.5 * (velocity[a][_sl(a, slice(0, -1))] + velocity[a][_sl(a, slice(1, None))])
        for a in range(3)
    )


def _sample(field: torch.Tensor, idx: Sequence[torch.Tensor]) -> torch.Tensor:
    """Trilinear sample at (fractional) index coordinates, edge-clamped:
    ``jax.scipy.ndimage.map_coordinates(order=1, mode="nearest")`` term for
    term (its corner order, weight products and left-to-right sum)."""
    nodes = []
    for coord, size in zip(idx, field.shape):
        lower = torch.floor(coord)
        upper_weight = coord - lower
        lower_weight = 1 - upper_weight
        index = lower.to(torch.int64)
        nodes.append((
            (index.clamp(0, size - 1), lower_weight),
            (torch.clamp(index + 1, 0, size - 1), upper_weight),
        ))
    _, ny, nz = field.shape
    flat = field.reshape(-1)
    result = None
    for i, wi in nodes[0]:
        for j, wj in nodes[1]:
            for k, wk in nodes[2]:
                term = (wi * wj * wk) * flat[(i * ny + j) * nz + k]
                result = term if result is None else result + term
    return result.to(field.dtype)


def _index_grid(shape, axis: int | None, device=None):
    """Index coordinates of cell centers (axis=None) or of `axis` faces.
    float32 whatever the solve dtype, as in the JAX package (:57)."""
    coords = []
    for a in range(3):
        n = shape[a] + (1 if a == axis else 0)
        # Cell center i sits at index i; face i along its own axis at i-0.5.
        offset = -0.5 if a == axis else 0.0
        coords.append(torch.arange(n, dtype=torch.float32, device=device) + offset)
    return torch.meshgrid(*coords, indexing="ij")


def advect_scalar(field: torch.Tensor, velocity, dt: float, dx: float) -> torch.Tensor:
    """Semi-Lagrangian advection of a cell-centered field."""
    vc = _cell_center_velocity(velocity)
    idx = _index_grid(field.shape, None, field.device)
    back = [idx[a] - (dt / dx) * vc[a] for a in range(3)]
    return _sample(field, back)


def advect_velocity(velocity, dt: float, dx: float) -> tuple:
    """Semi-Lagrangian advection of each MAC component."""
    vc_cell = _cell_center_velocity(velocity)
    out = []
    for axis in range(3):
        idx = _index_grid(vc_cell[0].shape, axis, velocity[axis].device)
        # Full velocity at this component's face positions.
        vel_at_face = [
            velocity[a] if a == axis else _sample(vc_cell[a], idx) for a in range(3)
        ]
        back = [idx[a] - (dt / dx) * vel_at_face[a] for a in range(3)]
        # `back` is in cell space (face i at i - 0.5 along its own axis); the
        # face array stores face i at index i.
        back[axis] = back[axis] + 0.5
        out.append(_sample(velocity[axis], back))
    return tuple(out)


def _edge_shift(f: torch.Tensor, axis: int, up: bool) -> torch.Tensor:
    """Edge-replicated unit shift: out[i] = f[i+1] (up) or f[i-1], clamped."""
    n = f.shape[axis]
    if up:
        return torch.cat([f[_sl(axis, slice(1, None))], f[_sl(axis, slice(n - 1, n))]], dim=axis)
    return torch.cat([f[_sl(axis, slice(0, 1))], f[_sl(axis, slice(0, n - 1))]], dim=axis)


def _upwind_substep(f, vel_at_points, c: float):
    """One first-order upwind Euler substep of df/dt = -v.grad(f), c =
    dt_sub/dx, per-axis upwinding from the unsplit field."""
    out = f
    for a in range(3):
        vp = vel_at_points[a]
        fwd = _edge_shift(f, a, True) - f
        bwd = f - _edge_shift(f, a, False)
        out = out - c * (torch.clamp(vp, min=0) * bwd + torch.clamp(vp, max=0) * fwd)
    return out


def _face_velocity(velocity, axis: int) -> tuple:
    """Full velocity at `axis`-face centers by 2-point averaging: component
    `axis` is the face array itself; component j the edge-padded average of
    its cell-centered values."""
    vc = _cell_center_velocity(velocity)
    out = []
    for j in range(3):
        if j == axis:
            out.append(velocity[axis])
            continue
        v = vc[j]
        n = v.shape[axis]
        vp = torch.cat([v[_sl(axis, slice(0, 1))], v, v[_sl(axis, slice(n - 1, n))]], dim=axis)
        out.append(0.5 * (vp[_sl(axis, slice(0, -1))] + vp[_sl(axis, slice(1, None))]))
    return tuple(out)


def advect_scalar_upwind(field, velocity, dt: float, dx: float, substeps: int = 4):
    """First-order upwind advection of a cell-centered field in `substeps`
    sub-Euler steps (stable for dt*|v|max/dx <= substeps)."""
    vc = _cell_center_velocity(velocity)
    c = (dt / substeps) / dx
    for _ in range(substeps):
        field = _upwind_substep(field, vc, c)
    return field


def advect_velocity_upwind(velocity, dt: float, dx: float, substeps: int = 4):
    """Upwind self-advection of the MAC velocity; the advecting velocity is
    frozen over the step."""
    c = (dt / substeps) / dx
    out = []
    for axis in range(3):
        vel_at_face = _face_velocity(velocity, axis)
        f = velocity[axis]
        for _ in range(substeps):
            f = _upwind_substep(f, vel_at_face, c)
        out.append(f)
    return tuple(out)


def _advect(liquid_phi, velocity, dt: float, dx: float, config: SolverConfig):
    """Scheme dispatch (config.advection)."""
    if config.advection == "upwind":
        return (
            advect_scalar_upwind(liquid_phi, velocity, dt, dx, config.advect_substeps),
            advect_velocity_upwind(velocity, dt, dx, config.advect_substeps),
        )
    return advect_scalar(liquid_phi, velocity, dt, dx), advect_velocity(velocity, dt, dx)


class FrameResult(NamedTuple):
    liquid_phi: torch.Tensor
    velocity: tuple
    pressure: torch.Tensor
    iterations: int
    relative_residual: float
    max_divergence: float
    setup: free_surface.ProjectionSetup | None  # pass as next frame's reuse_setup
    window_reused: bool    # the window shape was kept from reuse_setup
    seconds: dict          # host wall seconds: advect, setup, project


def _sync(t: torch.Tensor) -> None:
    if t.is_cuda:
        torch.cuda.synchronize(t.device)


def step(
    liquid_phi,
    velocity: Sequence,
    cut_cell_weights: Sequence,
    dt: float,
    gravity: float = -9.8,
    old_pressure=None,
    solid_phi=None,
    config: SolverConfig | None = None,
    reuse_setup: free_surface.ProjectionSetup | None = None,
    device=None,
) -> FrameResult:
    """One frame: advect, apply gravity, rebuild the setup, project, on
    `device` (default: liquid_phi's device if it is a tensor, else the
    card).

    `reuse_setup` (the previous frame's setup) keeps the window shape
    sticky across frames, so on the card the frame replays the setup and
    projection programs of that window (`build_setup`, `project`); the
    setup it returns is a value of its own, which the next frame's replay
    does not overwrite.  The stage times in `seconds` end on a device
    sync; the setup and the solve sync the host anyway.
    """
    if config is None:
        config = SolverConfig()
    sd = config.solve_dtype
    dev = device_mod.of(liquid_phi, device)
    dx = 1.0 / max(liquid_phi.shape)
    velocity = tuple(torch.as_tensor(v, dtype=sd, device=dev) for v in velocity)
    liquid_phi = torch.as_tensor(liquid_phi, dtype=sd, device=dev)

    t0 = time.perf_counter()
    new_phi, new_vel = _advect(liquid_phi, velocity, dt, dx, config)
    new_vel = list(new_vel)
    new_vel[1] = new_vel[1] + gravity * dt
    _sync(new_phi)
    t1 = time.perf_counter()
    setup = free_surface.build_setup(
        new_phi, cut_cell_weights, solid_phi=solid_phi, config=config,
        reuse_from=reuse_setup,
    )
    _sync(new_phi)
    t2 = time.perf_counter()
    result = free_surface.project(setup, tuple(new_vel), old_pressure=old_pressure, config=config)
    # The JAX package donates the advected velocity to the projection; the
    # port has no donation, so it drops its reference here instead (the
    # loop continues from result.velocity).
    del new_vel
    _sync(new_phi)
    t3 = time.perf_counter()
    return FrameResult(
        liquid_phi=new_phi,
        velocity=result.velocity,
        pressure=result.pressure,
        iterations=int(result.cg.iterations),
        relative_residual=float(result.cg.relative_residual),
        max_divergence=float(result.max_divergence),
        setup=setup,
        window_reused=reuse_setup is not None
        and setup.expanded_shape == reuse_setup.expanded_shape,
        seconds={"advect": t1 - t0, "setup": t2 - t1, "project": t3 - t2},
    )


def save_state(directory, frame: int, liquid_phi, velocity, pressure=None) -> None:
    """Checkpoint the simulation state in the native tiled format (`io`),
    the JAX package's `save_state` file for file: device tensors are copied
    to the host and written as they are (float32 or float64).  Resume with
    `load_state` + `run(start_frame=..., old_pressure=...)`."""
    fields = {
        "liquid_phi": liquid_phi,
        "velocity_u": velocity[0],
        "velocity_v": velocity[1],
        "velocity_w": velocity[2],
    }
    if pressure is not None:
        fields["pressure"] = pressure
    gmg_io.save_scene(directory, **fields)
    (Path(directory) / "state.json").write_text(json.dumps({"frame": int(frame), "format": 1}))


def load_state(directory):
    """Load a `save_state` checkpoint -> (frame, liquid_phi, velocity,
    pressure-or-None), as numpy arrays."""
    meta = json.loads((Path(directory) / "state.json").read_text())
    fields = gmg_io.load_scene(directory)
    velocity = (fields["velocity_u"], fields["velocity_v"], fields["velocity_w"])
    return int(meta["frame"]), fields["liquid_phi"], velocity, fields.get("pressure")


def run(
    liquid_phi,
    velocity,
    cut_cell_weights,
    num_frames: int,
    dt: float = 1.0 / 120.0,
    gravity: float = -9.8,
    solid_phi=None,
    config: SolverConfig | None = None,
    on_frame=None,
    start_frame: int = 0,
    old_pressure=None,
    device=None,
    checkpoint_dir=None,
    checkpoint_every: int = 0,
) -> list[FrameResult]:
    """Run `num_frames` steps, warm-starting each solve from the last
    pressure and keeping each frame's window shape for the next; returns
    the per-frame results (the flipSplash loop), on `device` as `step`
    places it.  `on_frame(k, result)` is called after frame k.

    Resume: `start_frame` / `old_pressure` continue from a `load_state`
    checkpoint; `checkpoint_dir` + `checkpoint_every` write one every N
    frames (`save_state`)."""
    if config is None:
        config = SolverConfig()
    frames = []
    pressure = old_pressure
    setup = None
    for k in range(start_frame, start_frame + num_frames):
        fr = step(
            liquid_phi, velocity, cut_cell_weights, dt, gravity,
            old_pressure=pressure, solid_phi=solid_phi, config=config,
            reuse_setup=setup, device=device,
        )
        setup = fr.setup
        # Keep only the latest setup (for reuse): one per frame would keep
        # every frame's multigrid hierarchy on the device.
        frames.append(fr._replace(setup=None))
        liquid_phi, velocity, pressure = fr.liquid_phi, fr.velocity, fr.pressure
        if checkpoint_dir is not None and checkpoint_every and (k + 1 - start_frame) % checkpoint_every == 0:
            save_state(checkpoint_dir, k + 1, liquid_phi, velocity, pressure)
        if on_frame is not None:
            on_frame(k, fr)
    return frames


class FrozenGeometry(NamedTuple):
    """The host decisions of `build_setup` frozen for a chunk of frames."""

    base_pads: tuple[tuple[int, int], ...]
    expanded_shape: tuple[int, int, int]
    start: tuple[int, int, int]   # window origin, padded-base coords
    target_levels: int            # hierarchy depth after capping
    nd_pad: int                   # coarse DOF bucket
    padding: int


def _frame_frozen(phi, velocity, pressure, cut_cell_weights, solid_phi, config: SolverConfig,
                  geom: FrozenGeometry, dt: float, gravity: float, device_loop):
    """One whole frame with the geometry frozen, the counterpart of the JAX
    package's `_frame_traced`: advect, gravity, labels and weights, the
    frozen window, `mg._build_levels`, `mg.coarse_system_device`,
    `mgpcg._finish_problem`, the warm-started projection with its CG loop
    handed to `device_loop` (`solver.graph.FrameGraph.loop`, or
    `EmulatedFrame.loop`).

    No host decision and no host read: the window, the depth and the
    coarse bucket come from `geom`.  Returns (new_phi, new_velocity,
    new_pressure, result, safety) with the CG scalars of `result` and
    `safety` = (fits, caps_ok, ndof_c) as device tensors, which `run_fused`
    reads once per chunk: the active region still inside the window, no
    level lost all its DOFs (where `build_setup` would cap the hierarchy),
    and the coarse DOF count (against the bucket).
    """
    sd = config.solve_dtype
    dx = 1.0 / max(phi.shape)
    new_phi, new_vel = _advect(phi, velocity, dt, dx, config)
    new_vel = list(new_vel)
    new_vel[1] = new_vel[1] + gravity * dt

    material, mg_labels, trimmed, mg_weights, projections, _ = free_surface._setup_base_fields(
        new_phi, cut_cell_weights, solid_phi, config.theta_clamp, sd, config.dirichlet_band,
        host=False,
    )
    window_labels = trimmed if config.compact_domain else mg_labels
    labels, exp_weights = free_surface._expand_window_fields(
        window_labels, mg_weights, geom.start, geom.base_pads, geom.expanded_shape
    )
    mg_dtype, fine_dtype, fine_full = mgpcg.fine_plan(config)
    levels, flags, _, fine = mg_mod._build_levels(
        labels, tuple(exp_weights), geom.target_levels, config.boundary_width, mg_dtype,
        config.mg_ew_dtype, fine_dtype, fine_full,
    )
    dofs, minv, ndof_c = mg_mod.coarse_system_device(levels[-1], geom.nd_pad)
    hier = mg_mod.MGHierarchy(
        levels=levels, coarse_dofs=dofs, coarse_minv=minv, coarse_chol=minv.new_zeros((0, 0))
    )
    setup = free_surface.ProjectionSetup(
        problem=mgpcg._finish_problem(hier, fine, fine_full),
        material=material,
        weights=tuple(cut_cell_weights),
        liquid_phi=new_phi,
        window_start=geom.start,
        expanded_shape=geom.expanded_shape,
        base_pads=geom.base_pads,
        padding=geom.padding,
        mg_levels=geom.target_levels,
    )
    result = free_surface.project(
        setup, tuple(new_vel), old_pressure=pressure, config=config, device_loop=device_loop
    )

    true = torch.ones((), dtype=torch.bool, device=phi.device)
    fits = true
    if config.compact_domain:
        for a in range(3):
            off = geom.start[a] - geom.base_pads[a][0]
            proj = projections[a]
            if off > 0:
                fits = fits & ~proj[:off].any()
            hi0 = min(off + geom.expanded_shape[a], proj.shape[0])
            fits = fits & ~proj[max(hi0, 0):].any()
    caps_ok = torch.stack(flags).all() if flags else true
    return new_phi, result.velocity, result.pressure, result, (fits, caps_ok, ndof_c)


# Per frame of a chunk, the stats row `run_fused` reads once per chunk.
STATS_ROW = ("iterations", "relative_residual", "max_divergence", "fits", "caps_ok", "ndof_c")


def frame_runner(device):
    """How `run_fused` runs a frame on `device`: one captured CUDA graph
    per frozen geometry on the card (`graph.FrameGraph`), its eager
    counterpart on the CPU (`graph.EmulatedFrame`)."""
    return graph.FrameGraph if torch.device(device).type == "cuda" else graph.EmulatedFrame


class FrameBuffers(NamedTuple):
    """The fixed tensors a captured frame reads and writes: the state
    (phi, u, v, w, pressure), overwritten in place with the next frame's,
    and the chunk's (chunk, 6) float64 stats rows (`STATS_ROW`), written at
    the device frame index `index`."""

    state: tuple
    rows: torch.Tensor
    index: torch.Tensor


def frame_buffers(state, chunk: int) -> FrameBuffers:
    """`FrameBuffers` shaped like `state` (phi, u, v, w, pressure) for
    chunks of `chunk` frames (their contents: whatever the caller loads)."""
    dev = state[0].device
    return FrameBuffers(
        tuple(torch.empty_like(t) for t in state),
        torch.zeros((chunk, len(STATS_ROW)), dtype=torch.float64, device=dev),
        torch.zeros((), dtype=torch.int64, device=dev),
    )


def frozen_frame(buf: FrameBuffers, weights, solid_phi, config: SolverConfig, geom: FrozenGeometry, dt: float,
           gravity: float):
    """The frame `run_fused` captures: `_frame_frozen` on `buf`'s state,
    the next state written back into it and the stats row into
    `buf.rows`, with no host read."""

    def frame(device_loop) -> None:
        phi, u, v, w, pressure = buf.state
        new_phi, new_vel, new_pressure, result, safety = _frame_frozen(
            phi, (u, v, w), pressure, weights, solid_phi, config, geom, dt, gravity, device_loop
        )
        row = torch.stack([
            t.to(torch.float64) for t in
            (result.cg.iterations, result.cg.relative_residual, result.max_divergence, *safety)
        ])
        buf.rows.index_copy_(0, buf.index.reshape(1), row.reshape(1, -1))
        buf.index.add_(1)
        for old, new in zip(buf.state, (new_phi, *new_vel, new_pressure)):
            old.copy_(new)  # every read of the old state is behind this frame

    return frame


def freeze_geometry(phi, weights, solid_phi, config: SolverConfig):
    """(geometry, prepare): `build_setup`'s host decisions on `phi`, frozen
    for a chunk (the coarse bucket with one extra bucket of headroom), and
    what a frame capture must find made for that geometry (the matrix-form
    transfers' matrices; `graph.FrameGraph`'s `prepare`)."""
    setup = free_surface.build_setup(phi, weights, solid_phi=solid_phi, config=config)
    hier = setup.problem.hier
    nd_pad = max(hier.coarse_minv.shape[0], hier.coarse_chol.shape[0])
    # One extra bucket of headroom for the liquid's motion over the chunk
    # (an overflow is detected whatever the headroom).
    geom = FrozenGeometry(
        setup.base_pads, setup.expanded_shape, setup.window_start, hier.num_levels,
        max(256, nd_pad + 256), setup.padding,
    )
    return geom, mgpcg.capture_prepare(setup.problem, config)


def run_fused(
    liquid_phi,
    velocity,
    cut_cell_weights,
    num_frames: int,
    dt: float = 1.0 / 120.0,
    gravity: float = -9.8,
    solid_phi=None,
    config: SolverConfig | None = None,
    chunk: int = 8,
    old_pressure=None,
    on_chunk=None,
    device=None,
):
    """The flipSplash loop in chunks of `chunk` frames on frozen geometry
    (the JAX package's `run_fused`), on `device` as `step` places it.

    Frame 0's geometry (window, level count, coarse bucket with one extra
    bucket of headroom) comes from `build_setup` on the input state and is
    frozen; every frame (`_frame_frozen`) rebuilds its labels, hierarchy
    and coarse inverse on the device.  On the card a frame is one CUDA
    graph (`frame_runner`: `graph.FrameGraph`, the JAX package's scanned
    chunk program), captured once per frozen geometry and launched once
    per frame with no host read between the frames of a chunk; each frame
    writes its stats row (`STATS_ROW`) on the device, and the host reads
    the chunk's rows once.  A chunk that broke the frozen geometry (the
    liquid left the window, a level lost its DOFs, or the coarse system
    outgrew the bucket) is discarded and re-run through `run()`, and the
    geometry is frozen again (and the frame captured again) from the new
    state: that is the JAX package's own rule, so the answer never rests
    on the frozen guess.  A tail shorter than `chunk` goes through
    `run()`.  `on_chunk(done, stats)` is called after each chunk that ran
    fused.  The frame graph and its memory pool are released on a
    refreeze and when this returns.

    With `old_pressure=None` the carried pressure starts as zeros (a warm
    start from zero, as in the JAX package).  Returns (phi, velocity,
    pressure, stats): the final state and a dict of numpy arrays per frame
    (iterations, relative_residual, max_divergence).
    """
    if config is None:
        config = SolverConfig()
    sd = config.solve_dtype
    dev = device_mod.of(liquid_phi, device)
    phi = torch.as_tensor(liquid_phi, dtype=sd, device=dev)
    vel = tuple(torch.as_tensor(v, dtype=sd, device=dev) for v in velocity)
    weights = tuple(torch.as_tensor(w, dtype=sd, device=dev) for w in cut_cell_weights)
    if solid_phi is not None:
        solid_phi = torch.as_tensor(solid_phi, dtype=sd, device=dev)
    pressure = (
        torch.zeros(phi.shape, dtype=sd, device=dev)
        if old_pressure is None
        else torch.as_tensor(old_pressure, dtype=sd, device=dev)
    )
    stats_frames: list[tuple] = []
    buf = None  # the frame's fixed buffers, made with the first frame

    def per_frame(k: int):
        frames = run(
            phi, vel, weights, num_frames=k, dt=dt, gravity=gravity, solid_phi=solid_phi,
            config=config, old_pressure=pressure, device=dev,
        )
        stats_frames.extend((fr.iterations, fr.relative_residual, fr.max_divergence) for fr in frames)
        return frames[-1].liquid_phi, frames[-1].velocity, frames[-1].pressure

    geom, prepare = freeze_geometry(phi, weights, solid_phi, config)
    frame = None
    done = 0
    try:
        while done < num_frames:
            k = min(chunk, num_frames - done)
            if k < chunk:
                phi, vel, pressure = per_frame(k)
                done += k
                continue
            if frame is None:
                if buf is None:
                    buf = frame_buffers((phi, *vel, pressure), chunk)
                frame = frame_runner(dev)(
                    frozen_frame(buf, weights, solid_phi, config, geom, dt, gravity), dev, prepare
                )
            for b, t in zip(buf.state, (phi, *vel, pressure)):
                b.copy_(t)
            buf.index.zero_()
            for _ in range(k):
                frame.launch()
            rows = buf.rows.cpu().numpy()  # the chunk's one host read
            graph.STATS.frame_reads += 1
            iters, rel, max_div, fits, caps_ok, ndof_c = rows.T
            if not (fits.all() and caps_ok.all() and ndof_c.max() <= geom.nd_pad):
                # The liquid broke the frozen geometry: discard the chunk (the
                # state before it is untouched), re-run it frame by frame, and
                # freeze the geometry again from the new state.
                phi, vel, pressure = per_frame(k)
                frame.close()
                frame = None
                geom, prepare = freeze_geometry(phi, weights, solid_phi, config)
                done += k
                continue
            phi, *vel, pressure = (b.clone() for b in buf.state)
            vel = tuple(vel)
            stats_frames.extend((int(i), float(r), float(m)) for i, r, m in zip(iters, rel, max_div))
            done += k
            if on_chunk is not None:
                on_chunk(done, stats_frames[-k:])
    finally:
        if frame is not None:
            frame.close()

    stats = {
        "iterations": np.asarray([s[0] for s in stats_frames]),
        "relative_residual": np.asarray([s[1] for s in stats_frames]),
        "max_divergence": np.asarray([s[2] for s in stats_frames]),
    }
    return phi, vel, pressure, stats


def main(argv=None):
    """The flipSplash loop as a command:

        gmg-torch-simulate --n 128 --frames 24 [--fp32] [--device cpu] \\
            [--checkpoint-dir out/ckpt --checkpoint-every 8] [--resume out/ckpt]
    """
    import argparse

    from geometricmultigridpressuresolver_tpu_torch.models import sdf

    p = argparse.ArgumentParser(description=main.__doc__)
    p.add_argument("--n", type=int, default=64, help="grid edge")
    p.add_argument("--frames", type=int, default=8)
    p.add_argument("--dt", type=float, default=1.0 / 120.0)
    p.add_argument("--gravity", type=float, default=-9.8)
    p.add_argument("--tolerance", type=float, default=1e-5)
    p.add_argument("--fp32", action="store_true",
                   help="solve in float32 (bfloat16 MG edge weights)")
    p.add_argument("--device", default="cuda",
                   help="cuda (the default; needs a card) or cpu")
    p.add_argument("--checkpoint-dir", default=None)
    p.add_argument("--checkpoint-every", type=int, default=0)
    p.add_argument("--resume", default=None,
                   help="checkpoint directory to resume from")
    args = p.parse_args(argv)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        p.error("no CUDA device is available; pass --device cpu to run on the CPU")

    kwargs = {"tolerance": args.tolerance}
    if args.fp32:
        kwargs.update(solve_dtype=torch.float32, mg_dtype=torch.float32,
                      mg_ew_dtype=torch.bfloat16)
    config = SolverConfig(**kwargs)
    dev = torch.device(args.device)
    shape = (args.n,) * 3
    dtype = config.solve_dtype
    weights = sdf.open_box_weights(shape, device=dev, dtype=dtype)
    start_frame, old_pressure = 0, None
    if args.resume:
        start_frame, phi, velocity, old_pressure = load_state(args.resume)
        phi = torch.as_tensor(phi, dtype=dtype, device=dev)
        velocity = tuple(torch.as_tensor(v, dtype=dtype, device=dev) for v in velocity)
        if old_pressure is not None:
            old_pressure = torch.as_tensor(old_pressure, dtype=dtype, device=dev)
        print(f"resumed frame {start_frame} from {args.resume}", flush=True)
    else:
        phi, velocity = sdf.splash_scene(shape, device=dev, dtype=dtype)

    def on_frame(k, fr):
        print(
            f"frame {k + 1}: iters={fr.iterations} "
            f"rel={fr.relative_residual:.2e} max|div|={fr.max_divergence:.2e} "
            f"window {fr.setup.expanded_shape}{' (kept)' if fr.window_reused else ''} "
            f"({time.time() - t0:.1f}s)",
            flush=True,
        )

    t0 = time.time()
    frames = run(
        phi, velocity, weights, num_frames=args.frames, dt=args.dt,
        gravity=args.gravity, config=config, on_frame=on_frame,
        start_frame=start_frame, old_pressure=old_pressure,
        checkpoint_dir=args.checkpoint_dir, checkpoint_every=args.checkpoint_every,
    )
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"{len(frames)} frames in {time.time() - t0:.1f}s on {name}", flush=True)
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
