"""The yardstick of the projection's roofline share, frozen with the
benchmark.

The least time of a piece of work is the larger of its bytes over the
card's memory bandwidth and its float32 operations over the card's
float32 peak outside the tensor cores (the rule of the repo's
`chip_smoke.py`: `HBM_BYTES_PER_S`, `FP32_OPS_PER_S`, `active_bytes`,
`bound`, `block_ops`, copied here so that a change to the program cannot
move it).  The bytes are reckoned from the problem, not from the
program's kernels or work lists: each input is read once on the cells
that need it and each output written once, in the configuration's dtypes.

MGPCG's work per CG iteration: on every smoothed level a downstroke block
from x = 0 that emits the residual, a restriction, a prolongation and an
upstroke block; the coarsest level's dense inverse applied once; on the
fine grid the CG step (p = z + beta p, A p, <p, A p>) and its tail (x, r
and ||r||^2).  The level sizes come from the liquid mask, coarsened by two
(a coarse cell carries a DOF when any of its eight children does) until a
level holds no more than the coarse DOF target.  A projection adds to
its solve the right-hand side (each liquid cell reads the velocity and
the face weight of its three lower faces, writes its divergence) and the
writeback (each reads its three faces' velocity and 1/theta and its
pressure, writes the three velocities).
"""

from __future__ import annotations

# Published H100 SXM peaks (NVIDIA data sheet): device memory bytes per
# second and float32 operations per second outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12

# Float operations per updated cell: the six-point neighbour sum (6
# multiplies, 6 adds) plus the update's 4; the CG step adds p' = z + beta p
# and the dot; the residual b - (diag x - S).
OPS_PASS, OPS_CG_STEP, OPS_RESIDUAL, OPS_DOT = 16, 18, 15, 2
# The CG tail per cell: x += a p, r -= a Ap, and the dot of r.
OPS_CG_TAIL = 6

DTYPE_BYTES = {"float64": 8, "float32": 4, "bfloat16": 2}


def active_bytes(cells: int, inputs, out_cells: int, outputs) -> int:
    """Bytes a function must move when it reads inputs of the byte sizes
    `inputs` on `cells` cells and writes outputs of the byte sizes
    `outputs` on `out_cells` cells."""
    return cells * sum(inputs) + out_cells * sum(outputs)


def bound(moved: float, ops: float) -> tuple[float, str]:
    """(seconds, "bytes" or "operations"): the least time the card could
    take to move `moved` bytes and do `ops` float32 operations."""
    t_bytes, t_ops = moved / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def block_ops(schedule, cells: int, band_cells: int, dot: bool) -> int:
    """Operations of one smoothing block: a `b` pass updates the band
    cells, a Gauss-Seidel half-sweep (`r`, `k`) half the cells, a Jacobi
    pass (`j`) all of them."""
    per = {"b": band_cells, "r": cells // 2, "k": cells // 2, "j": cells}
    return OPS_PASS * sum(per[kind] for kind in schedule) + OPS_DOT * cells * dot


def hierarchy(liquid, coarse_dof_target: int) -> list[int]:
    """DOFs per level of the liquid mask `liquid` (a bool tensor): the
    fine count, then the mask coarsened by two (any of eight children)
    until a level holds at most `coarse_dof_target` DOFs."""
    import torch

    mask = liquid
    counts = [int(mask.sum())]
    while counts[-1] > coarse_dof_target and min(mask.shape) > 1:
        pad = [0, mask.shape[2] % 2, 0, mask.shape[1] % 2, 0, mask.shape[0] % 2]
        grid = torch.nn.functional.pad(mask.float()[None, None], pad)
        mask = torch.nn.functional.max_pool3d(grid, 2)[0, 0] > 0
        counts.append(int(mask.sum()))
    return counts


def vcycle_work(levels, dtypes: dict) -> tuple[int, int]:
    """(bytes, operations) of one V-cycle over the DOF counts `levels`
    (fine first; the last is solved by its dense inverse), with the byte
    sizes `mg` (fields) and `ew` (edge weights)."""
    f, e = dtypes["mg"], dtypes["ew"]
    moved = ops = 0
    for n, n_coarse in zip(levels[:-1], levels[1:]):
        moved += active_bytes(n, (f, 3 * e, f), n, (f, f))          # downstroke: b, w, diag -> x, r
        moved += active_bytes(n, (f,), n_coarse, (f,))               # restriction
        moved += active_bytes(n_coarse, (f,), 0, ()) + active_bytes(n, (f,), n, (f,))  # prolongation
        moved += active_bytes(n, (f, f, 3 * e, f), n, (f,))          # upstroke: x, b, w, diag -> x
        ops += 2 * block_ops("rk", n, 0, False) + OPS_RESIDUAL * n
    c = levels[-1]
    moved += c * c * f + 2 * c * f                                  # dense inverse, b in, x out
    ops += 2 * c * c
    return moved, ops


def cg_work(cells: int, solve_bytes: int) -> tuple[int, int]:
    """(bytes, operations) of one CG step and its tail on `cells` DOFs."""
    s = solve_bytes
    moved = active_bytes(cells, (s, s, 3 * s, s), cells, (s, s))     # step: z, p, w, diag -> p, Ap
    moved += active_bytes(cells, (s, s, s, s), cells, (s, s))        # tail: x, p, r, Ap -> x, r
    return moved, (OPS_CG_STEP + OPS_DOT + OPS_CG_TAIL) * cells


def solve_seconds(iterations: int, levels, dtypes: dict) -> float:
    """The least seconds of a solve of `iterations` CG iterations: a
    V-cycle per iteration and the first one, a CG step per iteration."""
    vc_moved, vc_ops = vcycle_work(levels, dtypes)
    cg_moved, cg_ops = cg_work(levels[0], dtypes["solve"])
    return bound(vc_moved * (iterations + 1) + cg_moved * iterations,
                 vc_ops * (iterations + 1) + cg_ops * iterations)[0]


def field_work(cells: int, solve_bytes: int) -> tuple[int, int]:
    """(bytes, operations) of a projection's right-hand side and writeback
    on `cells` liquid cells."""
    s = solve_bytes
    moved = active_bytes(cells, (3 * s, 3 * s), cells, (s,))          # rhs: u, w -> b
    moved += active_bytes(cells, (3 * s, 3 * s, s), cells, (3 * s,))  # writeback: u, 1/theta, p -> u
    return moved, 12 * cells


def projection_seconds(iterations: int, levels, dtypes: dict) -> float:
    """The least seconds of a projection whose solve takes `iterations`
    CG iterations: the solve's work (`solve_seconds`) and `field_work`."""
    vc_moved, vc_ops = vcycle_work(levels, dtypes)
    cg_moved, cg_ops = cg_work(levels[0], dtypes["solve"])
    f_moved, f_ops = field_work(levels[0], dtypes["solve"])
    return bound(vc_moved * (iterations + 1) + cg_moved * iterations + f_moved,
                 vc_ops * (iterations + 1) + cg_ops * iterations + f_ops)[0]
