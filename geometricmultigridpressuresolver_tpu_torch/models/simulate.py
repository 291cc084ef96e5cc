"""Minimal incompressible free-surface simulation loop (PyTorch port).

Port of ``models/simulate.py``: the reference's ``flipSplash`` scene
without Houdini -- advect -> gravity -> MGPCG-project, frame after frame,
over the liquid SDF and the MAC velocity.  Each frame rebuilds the
projection setup (the liquid's topology changes), keeps the previous
frame's window shape while the liquid fits it (`build_setup(reuse_from=
...)`), and warm-starts CG from the previous pressure.  On CUDA tensors the
solve runs the port's kernels; the advection is plain PyTorch, as the JAX
package computes it outside Pallas.

Not yet ported: checkpointing (`save_state` / `load_state`) and `run_fused`.

    gmg-torch-simulate --n 128 --frames 24 --fp32
"""

from __future__ import annotations

import time
from typing import NamedTuple, Sequence

import torch

from geometricmultigridpressuresolver_tpu_torch import device as device_mod
from geometricmultigridpressuresolver_tpu_torch.config import SolverConfig
from geometricmultigridpressuresolver_tpu_torch.models import free_surface


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
    sticky across frames.  The stage times in `seconds` end on a device
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
) -> list[FrameResult]:
    """Run `num_frames` steps, warm-starting each solve from the last
    pressure and keeping each frame's window shape for the next; returns
    the per-frame results (the flipSplash loop), on `device` as `step`
    places it.  `on_frame(k, result)` is called after frame k."""
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
        if on_frame is not None:
            on_frame(k, fr)
    return frames


def main(argv=None):
    """The flipSplash loop as a command:

        gmg-torch-simulate --n 128 --frames 24 [--fp32] [--device cpu]
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
    )
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"{len(frames)} frames in {time.time() - t0:.1f}s on {name}", flush=True)
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
