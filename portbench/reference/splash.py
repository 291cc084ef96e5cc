"""Plain reference of one free-surface frame: advection, gravity, the
ghost-fluid Poisson problem, its solve and the pressure writeback.

Written in plain PyTorch from the semantics the port documents
(`models/simulate.py`, `models/free_surface.py`), importing nothing of the
port: the same operations on the same inputs give the same answers, with
no multigrid, no window, no cache and no kernels.  Every function takes
the dtype it computes in, so the control (the same reference in a lower
precision) is this module at another `dtype`.  Sample positions are
index arithmetic, kept in float64 (float32 below float64) whatever
`dtype`: only the values are in `dtype`.

  * advection: semi-Lagrangian, trilinear and edge-clamped, of the liquid
    SDF at cell centres and of each MAC component at its faces;
  * labels: a cell with no open face is SOLID, else LIQUID where phi <= 0,
    else AIR; a face is valid when its weight is > 0, it is not on the
    domain boundary, and a LIQUID cell touches it;
  * operator: per LIQUID cell, sum over valid faces of w / theta *
    (p_i - p_j), with p_j = 0 off the liquid (theta is the ghost-fluid
    fraction on liquid-air faces, clamped below at `theta_clamp`, 1
    elsewhere);
  * right-hand side: per LIQUID cell, sum of w * u over lower faces minus
    upper faces;
  * solve: Jacobi-preconditioned CG over the liquid cells;
  * writeback: u -= (p_hi - p_lo) / theta on valid faces.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

LIQUID, AIR, SOLID = 1, 2, 0


def _sl(axis: int, s: slice) -> tuple:
    out = [slice(None)] * 3
    out[axis] = s
    return tuple(out)


def _lo_hi(a: torch.Tensor, axis: int):
    return a[_sl(axis, slice(0, -1))], a[_sl(axis, slice(1, None))]


def _pad(a: torch.Tensor, axis: int, before: int, after: int, fill) -> torch.Tensor:
    shape = list(a.shape)
    parts = []
    if before:
        shape[axis] = before
        parts.append(torch.full(shape, fill, dtype=a.dtype, device=a.device))
    parts.append(a)
    if after:
        shape[axis] = after
        parts.append(torch.full(shape, fill, dtype=a.dtype, device=a.device))
    return torch.cat(parts, dim=axis)


def _cell_center_velocity(velocity):
    return tuple(0.5 * (velocity[a][_sl(a, slice(0, -1))] + velocity[a][_sl(a, slice(1, None))])
                 for a in range(3))


def _coord_dtype(dtype):
    return torch.float64 if dtype == torch.float64 else torch.float32


def _sample(field: torch.Tensor, coords) -> torch.Tensor:
    """Trilinear sample of `field` at fractional index coordinates, each
    index clamped to the grid; the weights come from the coordinates and
    the sum is in `field`'s dtype."""
    corners = []
    for c, n in zip(coords, field.shape):
        lower = torch.floor(c)
        w_hi = c - lower
        i = lower.to(torch.int64)
        corners.append(((i.clamp(0, n - 1), 1 - w_hi), ((i + 1).clamp(0, n - 1), w_hi)))
    _, ny, nz = field.shape
    flat = field.reshape(-1)
    out = torch.zeros(coords[0].shape, dtype=field.dtype, device=field.device)
    for i, wi in corners[0]:
        for j, wj in corners[1]:
            for k, wk in corners[2]:
                out = out + (wi * wj * wk).to(field.dtype) * flat[(i * ny + j) * nz + k]
    return out


def _index_grid(shape, axis, device, dtype):
    """Index coordinates of the cell centres (axis None) or of the faces
    along `axis` (face i at i - 0.5 in cell units)."""
    axes = [torch.arange(shape[a] + (1 if a == axis else 0), dtype=dtype, device=device)
            - (0.5 if a == axis else 0.0) for a in range(3)]
    return torch.meshgrid(*axes, indexing="ij")


def advect(phi, velocity, dt: float, gravity: float, dtype=torch.float64):
    """(phi, velocity) advanced by one semi-Lagrangian step of `dt`, with
    gravity added to the y component: values in `dtype`, sample positions
    in `_coord_dtype(dtype)`."""
    phi = phi.to(dtype)
    velocity = tuple(v.to(dtype) for v in velocity)
    cdtype = _coord_dtype(dtype)
    dx = 1.0 / max(phi.shape)
    c = dt / dx
    vc = _cell_center_velocity(velocity)
    idx = _index_grid(phi.shape, None, phi.device, cdtype)
    new_phi = _sample(phi, [idx[a] - c * vc[a].to(cdtype) for a in range(3)])
    new_vel = []
    for axis in range(3):
        idx = _index_grid(phi.shape, axis, phi.device, cdtype)
        at_face = [velocity[a] if a == axis else _sample(vc[a], idx) for a in range(3)]
        back = [idx[a] - c * at_face[a].to(cdtype) for a in range(3)]
        back[axis] = back[axis] + 0.5
        new_vel.append(_sample(velocity[axis], back))
    new_vel[1] = new_vel[1] + gravity * dt
    return new_phi, tuple(new_vel)


def material_labels(phi, weights):
    """SOLID (no open face), LIQUID (phi <= 0) or AIR, per cell."""
    open_face = torch.zeros(phi.shape, dtype=torch.bool, device=phi.device)
    for axis in range(3):
        lo, hi = _lo_hi(weights[axis], axis)
        open_face |= (lo > 0) | (hi > 0)
    liquid = torch.full(phi.shape, LIQUID, dtype=torch.int8, device=phi.device)
    labels = torch.where(phi <= 0, liquid, torch.full_like(liquid, AIR))
    return torch.where(open_face, labels, torch.full_like(labels, SOLID))


def face_fields(material, phi, weights, theta_clamp: float, dtype):
    """Per axis: (valid faces, 1/theta on the faces), face-shaped; 1/theta
    is 1 off the liquid-air faces."""
    valid, inv_theta = [], []
    for axis in range(3):
        m_lo, m_hi = _lo_hi(material, axis)
        inner = weights[axis][_sl(axis, slice(1, -1))] > 0
        valid.append(_pad(inner & ((m_lo == LIQUID) | (m_hi == LIQUID)), axis, 1, 1, False))
        p_lo, p_hi = (t.to(dtype) for t in _lo_hi(phi, axis))
        lo_in, hi_in = p_lo < 0, p_hi < 0
        d_lohi = torch.where(p_lo == p_hi, torch.ones_like(p_lo), p_lo - p_hi)
        theta = torch.where(lo_in, torch.where(hi_in, torch.ones_like(p_lo), p_lo / d_lohi),
                            torch.where(hi_in, -p_hi / d_lohi, torch.zeros_like(p_lo)))
        theta = theta.clamp(theta_clamp, 1.0)
        liquid_air = ((m_lo == LIQUID) & (m_hi == AIR)) | ((m_lo == AIR) & (m_hi == LIQUID))
        inv_theta.append(_pad(torch.where(liquid_air, 1.0 / theta, torch.ones_like(theta)), axis, 1, 1, 1.0))
    return valid, inv_theta


class Problem(NamedTuple):
    """The Poisson problem over the liquid cells of one grid."""

    shape: tuple
    liquid: torch.Tensor        # bool, cell grid
    cells: torch.Tensor         # flat index of each liquid cell (N,)
    diag: torch.Tensor          # (N,)
    neighbours: torch.Tensor    # (6, N) int64: liquid neighbour's row, or N
    coupling: torch.Tensor      # (6, N): w / theta to that neighbour, 0 if none
    weights: tuple              # cut-cell face weights, in dtype
    valid: list
    inv_theta: list


def build_problem(phi, weights, theta_clamp: float = 0.01, dtype=torch.float64) -> Problem:
    """The operator of `phi` and the cut-cell `weights`, in `dtype`."""
    material = material_labels(phi, weights)
    weights = tuple(w.to(dtype) for w in weights)
    valid, inv_theta = face_fields(material, phi, weights, theta_clamp, dtype)
    liquid = material == LIQUID
    flat = liquid.reshape(-1)
    cells = torch.nonzero(flat).reshape(-1)
    n = cells.numel()
    row = torch.full(flat.shape, n, dtype=torch.int64, device=phi.device)
    row[cells] = torch.arange(n, device=phi.device)
    row = row.reshape(phi.shape)
    diag = torch.zeros(phi.shape, dtype=dtype, device=phi.device)
    neighbours, coupling = [], []
    for axis in range(3):
        coef = torch.where(valid[axis], weights[axis] * inv_theta[axis], torch.zeros_like(weights[axis]))
        lo_face, hi_face = _lo_hi(coef, axis)       # each cell's lower and upper face
        diag += lo_face + hi_face
        for face, shift in ((lo_face, -1), (hi_face, 1)):
            nb = torch.roll(row, -shift, dims=axis)
            nb_liquid = torch.roll(liquid, -shift, dims=axis)
            edge = 0 if shift < 0 else phi.shape[axis] - 1
            in_grid = torch.ones_like(liquid)
            in_grid[_sl(axis, slice(edge, edge + 1))] = False
            link = in_grid & nb_liquid
            neighbours.append(torch.where(link, nb, n).reshape(-1)[cells])
            coupling.append(torch.where(link, face, torch.zeros_like(face)).reshape(-1)[cells])
    return Problem(tuple(phi.shape), liquid, cells, diag.reshape(-1)[cells], torch.stack(neighbours),
                   torch.stack(coupling), weights, valid, inv_theta)


def apply(prob: Problem, x: torch.Tensor) -> torch.Tensor:
    """A x over the liquid cells."""
    padded = torch.cat([x, x.new_zeros(1)])
    return prob.diag * x - (prob.coupling * padded[prob.neighbours]).sum(0)


def rhs(prob: Problem, velocity) -> torch.Tensor:
    """Per liquid cell: the weighted flux in through lower faces minus out
    through upper faces."""
    div = torch.zeros(prob.shape, dtype=prob.diag.dtype, device=prob.diag.device)
    for axis in range(3):
        lo, hi = _lo_hi(prob.weights[axis] * velocity[axis].to(prob.diag.dtype), axis)
        div += lo - hi
    return div.reshape(-1)[prob.cells]


def solve(prob: Problem, b: torch.Tensor, tolerance: float = 1e-10, max_iterations: int = 50_000,
          check_every: int = 32):
    """Jacobi-preconditioned CG from x = 0 to ||b - A x|| <= tolerance *
    ||b||.  Returns (x, iterations, relative residual)."""
    x = torch.zeros_like(b)
    b_norm = float(torch.linalg.vector_norm(b))
    if b_norm == 0.0:
        return x, 0, 0.0
    inv_diag = 1.0 / prob.diag
    r = b.clone()
    z = inv_diag * r
    p = z.clone()
    rz = torch.dot(r, z)
    it = 0
    rel = 1.0
    while it < max_iterations:
        ap = apply(prob, p)
        alpha = rz / torch.dot(p, ap)
        x += alpha * p
        r -= alpha * ap
        it += 1
        if it % check_every == 0:
            rel = float(torch.linalg.vector_norm(r)) / b_norm
            if rel <= tolerance:
                break
        z = inv_diag * r
        rz_new = torch.dot(r, z)
        p = z + (rz_new / rz) * p
        rz = rz_new
    rel = float(torch.linalg.vector_norm(b - apply(prob, x))) / b_norm
    return x, it, rel


def to_grid(prob: Problem, x: torch.Tensor) -> torch.Tensor:
    out = torch.zeros(prob.shape, dtype=x.dtype, device=x.device).reshape(-1)
    out[prob.cells] = x
    return out.reshape(prob.shape)


def writeback(prob: Problem, velocity, pressure) -> tuple:
    """velocity - grad(pressure) / theta on the valid faces."""
    out = []
    for axis in range(3):
        u = velocity[axis].to(pressure.dtype)
        p_lo, p_hi = _lo_hi(pressure, axis)
        grad = _pad((p_hi - p_lo), axis, 1, 1, 0.0) * prob.inv_theta[axis]
        out.append(torch.where(prob.valid[axis], u - grad, u))
    return tuple(out)


class Projection(NamedTuple):
    pressure: torch.Tensor     # cell grid, 0 off the liquid
    velocity: tuple
    iterations: int
    residual: float


def project(prob: Problem, velocity, tolerance: float = 1e-10) -> Projection:
    """The pressure of `velocity` on `prob` and the projected velocity."""
    x, it, rel = solve(prob, rhs(prob, velocity), tolerance)
    pressure = to_grid(prob, x)
    return Projection(pressure, writeback(prob, velocity, pressure), it, rel)
