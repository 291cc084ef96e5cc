"""The general driver of the traffic mixes: each mix file names one of
the port's entries (`"entry"`) and the parameters it is driven with.

  * "run": `simulate.step` frame after frame, as `simulate.run` loops it
    (the previous setup kept for the sticky window, the last pressure as
    the warm start), one unit per frame, in shots of `shot_frames` frames
    that each start again from the seeded scene;
  * "project": `free_surface.project` on one `build_setup` setup, over a
    pool of velocity fields drawn from the seed, cycled from a cold start
    in an order drawn from the seed, one unit per call.

Each entry keeps a uniform sample (drawn from the seed) of its units'
inputs and outputs, by reference: nothing is copied in the window.  After
the window, `check` holds the sample against the plain reference
(`reference/splash.py`), and `control` puts that reference, computed in
bfloat16 (the precision below the configuration's float32), in the
program's place and holds it to the same comparison.
"""

from __future__ import annotations

import random

import torch

from portbench import check, roofline, scene
from portbench.reference import splash as ref

DTYPES = {"float64": torch.float64, "float32": torch.float32, "bfloat16": torch.bfloat16}
CONTROL_DTYPE = {torch.float32: torch.bfloat16, torch.float64: torch.float32}


def solver_config(config: dict, device):
    """The port's SolverConfig of a configuration file; the plain kernels
    (`kernel_mode="torch"`) off the card."""
    from geometricmultigridpressuresolver_tpu_torch.config import SolverConfig

    s = config["solver"]
    return SolverConfig(
        solve_dtype=DTYPES[s["solve_dtype"]], mg_dtype=DTYPES[s["mg_dtype"]],
        mg_ew_dtype=DTYPES[s["mg_ew_dtype"]], tolerance=s["tolerance"],
        max_iterations=s["max_iterations"], pallas_band_strip=s["pallas_band_strip"],
        transfer_mode=s["transfer_mode"], theta_clamp=s["theta_clamp"],
        coarse_dof_target=s["coarse_dof_target"],
        kernel_mode="auto" if torch.device(device).type == "cuda" else "torch",
    )


class Entry:
    """What every entry shares: the configuration, the seeded scene, the
    sample of units, and the frame-by-frame reference."""

    def __init__(self, config: dict, traffic: dict, seed: int, device, grid=None):
        self.config, self.traffic, self.device = config, traffic, torch.device(device)
        self.cfg = solver_config(config, device)
        self.dtype = self.cfg.solve_dtype
        self.control_dtype = CONTROL_DTYPE[self.dtype]
        self.scene = scene.make(config, seed, device, self.dtype, grid)
        self.dt, self.gravity = config["dt"], config["gravity"]
        self.theta_clamp = config["solver"]["theta_clamp"]
        self.sample = None
        self.seed = seed

    def start_sample(self) -> None:
        """Sample the units from here on (the window's)."""
        from portbench import window

        self.sample = window.Reservoir(self.traffic["checked"], self.seed)

    def failed(self, relative_residual: float) -> bool:
        return not relative_residual <= self.cfg.tolerance

    def ref_frame(self, phi, velocity, dtype=torch.float64):
        """One reference frame in `dtype`: (phi, pressure, velocity).  The
        solve runs in float64 whatever `dtype`, and its pressure is held in
        `dtype`."""
        new_phi, vel_star = ref.advect(phi, velocity, self.dt, self.gravity, dtype)
        prob = ref.build_problem(new_phi, self.scene.weights, self.theta_clamp)
        proj = ref.project(prob, vel_star)
        pressure = proj.pressure.to(dtype)
        return new_phi, pressure, ref.writeback(prob, vel_star, pressure)


class Run(Entry):
    """`simulate.step` frame after frame, as `simulate.run` loops it, in
    shots: every `shot_frames` frames the loop starts again from the
    scene, with no setup to keep and no warm start, as a new `run()`."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.frames = 0
        self.restart()

    def restart(self) -> None:
        self.state = (self.scene.phi, self.scene.velocity)
        self.pressure = None
        self.setup = None

    def unit(self) -> dict:
        from geometricmultigridpressuresolver_tpu_torch.models import simulate

        if self.frames and self.frames % self.traffic["shot_frames"] == 0:
            self.restart()
        self.frames += 1
        prev = self.state
        fr = simulate.step(prev[0], prev[1], self.scene.weights, self.dt, self.gravity,
                           old_pressure=self.pressure, config=self.cfg, reuse_setup=self.setup,
                           device=self.device)
        self.setup = fr.setup
        self.state, self.pressure = (fr.liquid_phi, fr.velocity), fr.pressure
        if self.sample is not None:
            self.sample.offer((prev, (fr.liquid_phi, fr.pressure, fr.velocity)))
        return {"frames": 1, "iterations": [fr.iterations], "seconds": fr.seconds,
                "failed": int(self.failed(fr.relative_residual))}

    def release(self) -> None:
        self.state = self.pressure = self.setup = None

    def check(self, control: bool = False) -> dict:
        """Each sampled frame against the reference's frame from the same
        previous state: the reference advects it, and builds and solves
        its own problem from its own phi.  `label_flips` (not limited)
        counts the cells whose liquid label differs between the two phis."""
        readings = []
        weights = self.scene.weights
        for (phi, velocity), out in self.sample.items:
            if control:
                out = self.ref_frame(phi, velocity, self.control_dtype)
            want_phi, vel_star = ref.advect(phi, velocity, self.dt, self.gravity)
            prob = ref.build_problem(want_phi, weights, self.theta_clamp)
            proj = ref.project(prob, vel_star)
            flips = ref.material_labels(out[0], weights) != ref.material_labels(want_phi, weights)
            readings.append({"phi_err": check.gap(out[0], want_phi),
                             "pressure_err": check.gap(out[1], proj.pressure),
                             "velocity_err": check.gap(out[2], proj.velocity),
                             "label_flips": float(flips.sum())})
        return check.worst(readings)


class Project(Entry):
    """`free_surface.project` over a pool of velocity fields on one setup."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        from geometricmultigridpressuresolver_tpu_torch.models import free_surface

        t, p = self.traffic, self.traffic["perturbation"]
        self.pool = scene.perturbed(self.scene.velocity, t["pool"], p["amplitude"], p["max_frequency"], self.seed)
        self.order = random.Random(self.seed).sample(range(t["pool"]), t["pool"])
        self.setup = free_surface.build_setup(self.scene.phi, self.scene.weights, config=self.cfg,
                                              device=self.device)
        liquid = ref.material_labels(self.scene.phi, self.scene.weights) == ref.LIQUID
        self.levels = roofline.hierarchy(liquid, self.cfg.coarse_dof_target)
        self.calls = 0

    def unit(self) -> dict:
        from geometricmultigridpressuresolver_tpu_torch.models import free_surface

        m = self.order[self.calls % len(self.pool)]
        self.calls += 1
        res = free_surface.project(self.setup, self.pool[m], old_pressure=None, config=self.cfg)
        if self.sample is not None:
            self.sample.offer((m, (res.pressure, res.velocity)))
        return {"projections": 1, "dofs": self.levels[0], "iterations": [int(res.cg.iterations)],
                "failed": int(self.failed(float(res.cg.relative_residual)))}

    def release(self) -> None:
        self.setup = None

    def check(self, control: bool = False) -> dict:
        prob = ref.build_problem(self.scene.phi, self.scene.weights, self.theta_clamp)
        projections = {m: ref.project(prob, self.pool[m]) for m in sorted({m for m, _ in self.sample.items})}
        readings = []
        for m, out in self.sample.items:
            want = projections[m]
            if control:
                p = want.pressure.to(self.control_dtype)
                out = (p, ref.writeback(prob, tuple(v.to(self.control_dtype) for v in self.pool[m]), p))
            readings.append({"pressure_err": check.gap(out[0], want.pressure),
                             "velocity_err": check.gap(out[1], want.velocity)})
        return check.worst(readings)


ENTRIES = {"run": Run, "project": Project}
