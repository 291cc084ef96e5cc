"""The comparison that decides `correct`, shown to fail: at a small size on
the CPU (the port's plain kernels), each cell's run is correct, and the
control (the plain reference in bfloat16 in the program's place) and each
fault planted in the timed path come out not correct.  The faults: a step
that returns its state unchanged, and an answer altered where it is
produced.  The card's readings, at the cells' own sizes, are in PERF.md
(`portbench/calibrate.py`)."""

import sys
import time
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from portbench import harness  # noqa: E402

SPEC = harness.load_spec(ROOT)
CELLS = ["splash256.run", "splash256.project"]
GRID = (24, 24, 24)
SEED = 2**31 + 45


def run(cell, **kwargs):
    files = harness.cell_files(SPEC, cell, ROOT)
    files["traffic"] = dict(files["traffic"], checked=2)
    return harness.run_cell(files, SEED, 0.5, False, "cpu", time.perf_counter(), grid=GRID, **kwargs)


@pytest.mark.parametrize("cell", CELLS)
def test_the_program_passes_and_the_control_fails(cell):
    record = run(cell, control=True)
    assert record["correct"], record["check"]
    limits = harness.cell_files(SPEC, cell, ROOT)["limits"]
    assert any(record["control_readings"][name] > limit for name, limit in limits.items()), \
        record["control_readings"]


def unchanged_step(step):
    def fault(phi, velocity, *args, **kwargs):
        fr = step(phi, velocity, *args, **kwargs)
        return fr._replace(liquid_phi=phi, velocity=tuple(velocity), pressure=torch.zeros_like(fr.pressure))
    return fault


def altered_step(step):
    def fault(*args, **kwargs):
        fr = step(*args, **kwargs)
        return fr._replace(pressure=fr.pressure * 1.001)
    return fault


def unchanged_project(project):
    def fault(setup, velocity, *args, **kwargs):
        res = project(setup, velocity, *args, **kwargs)
        return res._replace(pressure=torch.zeros_like(res.pressure), velocity=tuple(velocity))
    return fault


def altered_project(project):
    def fault(*args, **kwargs):
        res = project(*args, **kwargs)
        return res._replace(pressure=res.pressure * 1.001)
    return fault


FAULTS = {
    "splash256.run": ("simulate", "step", (unchanged_step, altered_step)),
    "splash256.project": ("free_surface", "project", (unchanged_project, altered_project)),
}


@pytest.mark.parametrize("cell,fault", [(c, k) for c in CELLS for k in range(2)])
def test_a_planted_fault_is_not_correct(cell, fault, monkeypatch):
    from geometricmultigridpressuresolver_tpu_torch.models import free_surface, simulate

    module_name, attr, makers = FAULTS[cell]
    module = {"simulate": simulate, "free_surface": free_surface}[module_name]
    monkeypatch.setattr(module, attr, makers[fault](getattr(module, attr)))
    record = run(cell)
    assert not record["correct"], record["check"]
