"""Assembled sparse Poisson system on the host (numpy + scipy).

Three roles, as in ``geometricmultigridpressuresolver_tpu.models.assembled``:

1. The V-cycle's coarsest level is solved directly; its matrix is
   assembled here from the label semantics of the reference's
   computeLaplacian, independently of
   `ops.domain.build_level_coefficients`, so the two can check each other.
2. The test node's oracle (`diagnostics.run_conjugate_gradient_test`): the
   same labels solved through the assembled matrix (scipy in place of the
   reference's Eigen).
3. The baseline node (the reference's HDK_FreeSurfacePressureSolver):
   `solve_assembled` runs diagonal-preconditioned CG on the assembled
   system on the host, and `project_assembled` is the whole projection
   around it, its fields set up and audited on the caller's device.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import scipy.sparse
import scipy.sparse.linalg

from geometricmultigridpressuresolver_tpu_torch.grids import CellLabel, is_solvable

EXT = int(CellLabel.EXTERIOR)


def dof_indices(labels: np.ndarray) -> tuple[np.ndarray, int]:
    """Row index per solvable cell (-1 elsewhere), lexicographic scan order."""
    solvable = is_solvable(labels)
    idx = np.full(labels.shape, -1, dtype=np.int64)
    idx[solvable] = np.arange(int(solvable.sum()))
    return idx, int(solvable.sum())


def assemble_poisson(
    labels: np.ndarray, face_weights: Sequence[np.ndarray] | None = None
) -> tuple[scipy.sparse.csr_matrix, np.ndarray]:
    """Assemble the dimensionless Poisson matrix over solvable DOFs.

    Per face f (weight w_f, 1 on coarse levels) between cells a, b:
      * both solvable           -> A[a,b] -= w, A[b,a] -= w, diagonals += w
      * solvable vs DIRICHLET   -> diagonal of the solvable cell += w
      * solvable vs EXTERIOR    -> nothing
    """
    labels = np.asarray(labels)
    idx, ndof = dof_indices(labels)
    solvable = is_solvable(labels)

    rows, cols, vals = [], [], []
    diag = np.zeros(labels.shape, dtype=np.float64)
    for axis in range(3):
        lo = [slice(None)] * 3
        hi = [slice(None)] * 3
        lo[axis] = slice(0, -1)
        hi[axis] = slice(1, None)
        lo, hi = tuple(lo), tuple(hi)
        if face_weights is not None:
            interior_faces = [slice(None)] * 3
            interior_faces[axis] = slice(1, -1)
            w = np.asarray(face_weights[axis], dtype=np.float64)[tuple(interior_faces)]
        else:
            w = np.ones(labels[lo].shape, dtype=np.float64)

        la, lb = labels[lo], labels[hi]
        sa, sb = solvable[lo], solvable[hi]
        ia, ib = idx[lo], idx[hi]
        both = sa & sb
        rows += [ia[both], ib[both]]
        cols += [ib[both], ia[both]]
        vals += [-w[both], -w[both]]
        diag[lo] += np.where(sa & (lb != EXT), w, 0.0)
        diag[hi] += np.where(sb & (la != EXT), w, 0.0)

    rows.append(idx[solvable])
    cols.append(idx[solvable])
    vals.append(diag[solvable])
    a = scipy.sparse.coo_matrix(
        (np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))),
        shape=(ndof, ndof),
    ).tocsr()
    return a, idx


def grid_to_vec(x: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """The DOF vector of a cell grid, in `dof_indices` order."""
    return np.asarray(x)[idx >= 0]


def vec_to_grid(v: np.ndarray, idx: np.ndarray, shape) -> np.ndarray:
    """A DOF vector scattered onto a zero cell grid of `shape`."""
    out = np.zeros(shape, dtype=v.dtype)
    out[idx >= 0] = v
    return out


def solve_assembled(
    labels: np.ndarray,
    rhs_grid: np.ndarray,
    face_weights: Sequence[np.ndarray] | None = None,
    tol: float = 1e-10,
    x0_grid: np.ndarray | None = None,
    max_iterations: int = 10000,
) -> np.ndarray:
    """Diagonal-preconditioned CG on the assembled system, on the host in
    float64 (the baseline node's Eigen solve).  Raises when it does not
    converge."""
    a, idx = assemble_poisson(labels, face_weights)
    b = grid_to_vec(np.asarray(rhs_grid, dtype=np.float64), idx)
    x0 = None if x0_grid is None else grid_to_vec(np.asarray(x0_grid, np.float64), idx)
    d = a.diagonal()
    # A liquid cell whose every face is closed has a zero diagonal; its
    # Jacobi entry is 1 so the preconditioner stays finite.
    m = scipy.sparse.diags(np.where(d > 0, 1.0 / np.where(d > 0, d, 1.0), 1.0))
    x, info = scipy.sparse.linalg.cg(a, b, x0=x0, rtol=tol, maxiter=max_iterations, M=m)
    if info != 0:
        raise RuntimeError(f"assembled CG did not converge: info={info}")
    return vec_to_grid(x, idx, labels.shape)


def project_assembled(
    liquid_phi,
    cut_cell_weights: Sequence,
    velocity: Sequence,
    solid_phi=None,
    solid_velocity: Sequence | None = None,
    old_pressure=None,
    tolerance: float = 1e-5,
    max_iterations: int = 2500,
    theta_clamp: float = 0.01,
    device=None,
):
    """The whole baseline projection (the reference's classic
    assembled-matrix node): the geometric node's material labels,
    ghost-fluid weights, RHS, writeback, gradient update and divergence
    audit, in float64 on `device` (default: liquid_phi's device if it is a
    tensor, else the card), around `solve_assembled` on the host over the
    raw base grid (no multigrid expansion).

    Returns (pressure, projected_velocity, max_divergence): numpy arrays
    and a float.
    """
    import torch

    from geometricmultigridpressuresolver_tpu_torch import device as device_mod
    from geometricmultigridpressuresolver_tpu_torch.models import free_surface

    free_surface.validate_fields(liquid_phi, cut_cell_weights, velocity=velocity, solid_phi=solid_phi)
    dev = device_mod.of(liquid_phi, device)
    dt = torch.float64

    def on_device(arrays):
        return tuple(torch.as_tensor(a, dtype=dt, device=dev) for a in arrays)

    phi = torch.as_tensor(liquid_phi, dtype=dt, device=dev)
    weights = on_device(cut_cell_weights)
    velocity = on_device(velocity)
    if solid_velocity is not None:
        solid_velocity = on_device(solid_velocity)
    solid = None if solid_phi is None else torch.as_tensor(solid_phi, dtype=dt, device=dev)

    material, mg_labels, _, mg_weights, _, _ = free_surface._setup_base_fields(
        phi, weights, solid, theta_clamp, dt, dirichlet_band=0, host=False
    )
    valid, grad_scale = free_surface.face_projection_fields(material, phi, weights, theta_clamp, dt)
    liquid_mask = material == free_surface.LIQUID
    rhs = free_surface.negative_divergence(liquid_mask, velocity, weights, solid_velocity)
    x0 = None
    if old_pressure is not None:
        old = torch.as_tensor(old_pressure, dtype=dt, device=dev)
        x0 = torch.where(liquid_mask, old, torch.zeros_like(old)).cpu().numpy()

    pressure = solve_assembled(
        mg_labels.cpu().numpy(), rhs.cpu().numpy(), [w.cpu().numpy() for w in mg_weights],
        tol=tolerance, x0_grid=x0, max_iterations=max_iterations,
    )
    p = torch.where(liquid_mask, torch.as_tensor(pressure, device=dev), torch.zeros((), dtype=dt, device=dev))
    new_velocity = free_surface.apply_pressure_gradient(velocity, p, valid, grad_scale)
    max_div, _, _ = free_surface.divergence_stats(liquid_mask, new_velocity, weights, solid_velocity)
    return p.cpu().numpy(), tuple(v.cpu().numpy() for v in new_velocity), float(max_div)
