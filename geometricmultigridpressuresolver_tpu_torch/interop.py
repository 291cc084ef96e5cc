"""Carry solver state across from the JAX package as numpy arrays.

The port never sees a JAX object: the caller converts the JAX package's
containers (``LevelCoeffs``, ``MGHierarchy``, ``PoissonProblem``,
``ProjectionSetup``) to nested mappings of numpy arrays under the same
field names -- e.g. ``np.asarray`` over ``NamedTuple._asdict()``, with tuples
of levels as sequences -- and these functions rebuild the port's containers
on `device`: the card unless the call names another (``device="cpu"`` for
a CPU run).  A solve can then be compared on bit-identical hierarchies,
apart from the setup build.

bfloat16 arrays (numpy's ``ml_dtypes.bfloat16``, what ``np.asarray`` of a
JAX bfloat16 array gives) are carried bit for bit.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from geometricmultigridpressuresolver_tpu_torch import device as device_mod
from geometricmultigridpressuresolver_tpu_torch.models.free_surface import ProjectionSetup
from geometricmultigridpressuresolver_tpu_torch.ops.stencil import LevelCoeffs
from geometricmultigridpressuresolver_tpu_torch.solver.mg import MGHierarchy
from geometricmultigridpressuresolver_tpu_torch.solver.mgpcg import PoissonProblem


def tensor(arr, device=None) -> torch.Tensor:
    """numpy array -> torch tensor on `device`, bfloat16 included."""
    device = device_mod.resolve(device)
    arr = np.array(arr)  # a writable, contiguous copy
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device)


def level_from_arrays(d: Mapping, device=None) -> LevelCoeffs:
    device = device_mod.resolve(device)
    return LevelCoeffs(
        solvable=tensor(d["solvable"], device).to(torch.bool),
        band=tensor(d["band"], device).to(torch.int8),
        diag=tensor(d["diag"], device),
        inv_diag=tensor(d["inv_diag"], device),
        ew0=tensor(d["ew0"], device),
        ew1=tensor(d["ew1"], device),
        ew2=tensor(d["ew2"], device),
    )


def hierarchy_from_arrays(d: Mapping, device=None) -> MGHierarchy:
    device = device_mod.resolve(device)
    return MGHierarchy(
        levels=tuple(level_from_arrays(lv, device) for lv in d["levels"]),
        coarse_dofs=tensor(d["coarse_dofs"], device).to(torch.int64),
        coarse_minv=tensor(d["coarse_minv"], device),
        coarse_chol=tensor(d["coarse_chol"], device),
    )


def problem_from_arrays(d: Mapping, device=None) -> PoissonProblem:
    device = device_mod.resolve(device)
    return PoissonProblem(
        fine=level_from_arrays(d["fine"], device),
        hier=hierarchy_from_arrays(d["hier"], device),
    )


def setup_from_arrays(d: Mapping, device=None) -> ProjectionSetup:
    device = device_mod.resolve(device)
    return ProjectionSetup(
        problem=problem_from_arrays(d["problem"], device),
        material=tensor(d["material"], device).to(torch.int8),
        weights=tuple(tensor(w, device) for w in d["weights"]),
        liquid_phi=tensor(d["liquid_phi"], device),
        window_start=tuple(int(s) for s in np.asarray(d["window_start"]).ravel()),
        expanded_shape=tuple(int(s) for s in d["expanded_shape"]),
        base_pads=tuple((int(lo), int(hi)) for lo, hi in d["base_pads"]),
        padding=int(d["padding"]),
        mg_levels=int(d["mg_levels"]),
    )
