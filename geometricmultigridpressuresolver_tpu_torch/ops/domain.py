"""Multigrid domain construction on torch tensors.

The setup that runs once per label set: domain expansion, far-field
Dirichlet trimming, the compact window geometry, level coarsening, boundary
relabeling, the boundary band and per-level stencil coefficients.  Every
function is elementwise or shift-and-compare on label and weight grids, so
it runs unchanged on the CPU (tests) or on the card (the 256^3 setup), and
in float64 its results are bit-equal to
``geometricmultigridpressuresolver_tpu.ops.domain`` (same operations in the
same order).

The window geometry keeps the JAX package's lane-128 alignment
(`align_tile_extents`, `coarse_lane_pad`): the coarse levels depend on the
window's shape, and identical hierarchies keep the two packages' CG
iteration counts comparable.

Geometry helpers (`expansion_params`, `compact_expansion_params`,
`align_tile_extents`, `coarse_lane_pad`) are host integer arithmetic; the
``check_*`` invariants run on host copies.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch

from geometricmultigridpressuresolver_tpu_torch.grids import CellLabel, face_shape, is_solvable

EXT = int(CellLabel.EXTERIOR)
DIR = int(CellLabel.DIRICHLET)
INT = int(CellLabel.INTERIOR)
BND = int(CellLabel.BOUNDARY)

LABEL_DTYPE = torch.int8


def _axis_slice(axis: int, sl: slice) -> tuple:
    out = [slice(None)] * 3
    out[axis] = sl
    return tuple(out)


def pad(arr: torch.Tensor, pads: Sequence[tuple[int, int]], value) -> torch.Tensor:
    """Constant padding of a 3-D tensor by per-axis (before, after) widths."""
    shape = [s + lo + hi for s, (lo, hi) in zip(arr.shape, pads)]
    out = arr.new_full(shape, value)
    out[tuple(slice(lo, lo + s) for s, (lo, _) in zip(arr.shape, pads))] = arr
    return out


def _neighbor(arr: torch.Tensor, axis: int, direction: int, fill) -> torch.Tensor:
    """Face-neighbour values: direction 0 -> arr[i-1], 1 -> arr[i+1], `fill`
    outside the grid."""
    out = torch.full_like(arr, fill)
    if direction == 0:
        out[_axis_slice(axis, slice(1, None))] = arr[_axis_slice(axis, slice(0, -1))]
    else:
        out[_axis_slice(axis, slice(0, -1))] = arr[_axis_slice(axis, slice(1, None))]
    return out


def _cell_faces(w: torch.Tensor, axis: int):
    """(lower, upper) face values of each cell from a face array."""
    return w[_axis_slice(axis, slice(0, -1))], w[_axis_slice(axis, slice(1, None))]


def next_pow2(n: int) -> int:
    return 1 << max(0, math.ceil(math.log2(n))) if n > 1 else 1


def expansion_params(base_shape: Sequence[int]) -> tuple[int, int, tuple[int, int, int]]:
    """Multigrid level count, exterior padding and expanded grid shape of the
    reference's full-grid power-of-two expansion."""
    min_dim = min(base_shape)
    if min_dim < 4:
        raise ValueError(f"grid too small for multigrid: {base_shape}")
    mg_levels = math.ceil(math.log2(min_dim)) - 1
    padding = 2 ** (mg_levels - 1)
    expanded = tuple(next_pow2(s + 2 * padding) for s in base_shape)
    return mg_levels, padding, expanded


def expand_domain(base_labels: torch.Tensor):
    """Embed base labels into the padded power-of-two multigrid domain.

    Returns (expanded_labels, offset, mg_levels).
    """
    mg_levels, padding, expanded_shape = expansion_params(tuple(base_labels.shape))
    base = torch.where(base_labels == BND, INT, base_labels).to(LABEL_DTYPE)
    pads = [
        (padding, expanded_shape[a] - padding - base_labels.shape[a]) for a in range(3)
    ]
    return pad(base, pads, EXT), (padding, padding, padding), mg_levels


def dilate(mask: torch.Tensor, rings: int) -> torch.Tensor:
    """Face-neighbour dilation of a boolean mask, `rings` layers."""
    for _ in range(rings):
        grown = mask
        for axis in range(3):
            for direction in (0, 1):
                grown = grown | _neighbor(mask, axis, direction, False)
        mask = grown
    return mask


def trim_far_dirichlet(labels: torch.Tensor, keep_rings: int = 4) -> torch.Tensor:
    """Relabel DIRICHLET cells farther than `keep_rings` from any solvable
    cell as EXTERIOR: the matrix and RHS are unchanged, the active bounding
    box shrinks."""
    near = dilate(is_solvable(labels), keep_rings)
    return torch.where((labels == DIR) & ~near, EXT, labels).to(LABEL_DTYPE)


def compact_expansion_params(
    non_ext_proj: Sequence[np.ndarray],
    non_ext_count: int | None = None,
    coarse_dof_target: int = 3000,
    align_lanes: bool = True,
) -> tuple[int, int, tuple[tuple[int, int], ...], tuple[int, int, int]]:
    """Compact-domain geometry from per-axis occupancy projections (host).

    `non_ext_proj[a]` is the 1-D boolean projection of non-EXTERIOR cells
    along axis a.  Returns (mg_levels, padding, bbox, expanded_shape): the
    domain crops to the active bounding box, each axis a multiple of
    2**(mg_levels-1), and the depth is the smallest whose estimated
    coarsest-level DOF count fits `coarse_dof_target`.
    """
    bbox = []
    for proj in non_ext_proj:
        idx = np.flatnonzero(np.asarray(proj))
        if idx.size == 0:
            raise ValueError("domain has no non-exterior cells")
        bbox.append((int(idx[0]), int(idx[-1]) + 1))
    extents = [hi - lo for lo, hi in bbox]
    min_dim = min(extents)

    max_levels = 2 if min_dim < 4 else max(2, math.ceil(math.log2(min_dim)) - 1)
    mg_levels = max_levels
    if non_ext_count is not None:
        for level in range(2, max_levels + 1):
            if non_ext_count / 8 ** (level - 1) <= coarse_dof_target:
                mg_levels = level
                break

    padding = 2 ** (mg_levels - 1)
    expanded = [((e + 2 * padding + padding - 1) // padding) * padding for e in extents]
    if align_lanes:
        expanded = list(align_tile_extents(expanded, padding))
    return mg_levels, padding, tuple(bbox), tuple(expanded)


def align_tile_extents(expanded, padding: int):
    """Round the last axis up to a multiple of 128 when it is >= 96, as the
    JAX package does for its TPU tiling; kept so both packages build the
    same window and hierarchy.  `padding` must divide 128."""
    if 128 % padding:
        raise ValueError(
            f"lane alignment requires padding ({padding}) to divide 128; "
            "cap mg levels (config.max_mg_levels) or raise coarse_dof_target"
        )
    out = list(expanded)
    if out[2] >= 96:
        out[2] = ((out[2] + 127) // 128) * 128
    return tuple(out)


def expand_face_weights(
    base_weights: Sequence[torch.Tensor], expanded_shape: Sequence[int], offset: Sequence[int]
) -> list:
    """Copy per-axis face weights into the expanded index space (zero
    elsewhere); weights exist only at the finest level."""
    out = []
    for axis, w in enumerate(base_weights):
        target = face_shape(expanded_shape, axis)
        out.append(pad(w, [(offset[a], target[a] - offset[a] - w.shape[a]) for a in range(3)], 0.0))
    return out


def set_boundary_labels(labels: torch.Tensor, face_weights: Sequence | None) -> torch.Tensor:
    """Relabel INTERIOR -> BOUNDARY next to Dirichlet/exterior cells or
    non-unit incident face weights."""
    touches = torch.zeros(labels.shape, dtype=torch.bool, device=labels.device)
    for axis in range(3):
        for direction in (0, 1):
            nbr = _neighbor(labels, axis, direction, EXT)
            touches = touches | (nbr == DIR) | (nbr == EXT)
    if face_weights is not None:
        for axis in range(3):
            wl, wu = _cell_faces(face_weights[axis], axis)
            touches = touches | (wl != 1) | (wu != 1)
    return torch.where((labels == INT) & touches, BND, labels).to(LABEL_DTYPE)


def coarse_lane_pad(fine_nz: int) -> int:
    """Extra EXTERIOR z-cells appended to a coarse level so its last axis
    stays a multiple of 128 (the JAX package's lane alignment)."""
    cz = fine_nz // 2
    if fine_nz % 128 == 0 and cz >= 128 and cz % 128:
        return ((cz + 127) // 128) * 128 - cz
    return 0


def vote_labels(fine_labels: torch.Tensor) -> torch.Tensor:
    """The 8-children vote of `coarsen_labels`, before its boundary pass:
    each coarse cell reads only its own children, so a block of even
    extents votes on its own."""
    if any(s % 2 for s in fine_labels.shape):
        raise ValueError(f"cannot coarsen odd extents {tuple(fine_labels.shape)}")
    nx, ny, nz = (s // 2 for s in fine_labels.shape)
    children = fine_labels.reshape(nx, 2, ny, 2, nz, 2)
    has_dirichlet = (children == DIR).any(dim=(1, 3, 5))
    has_interior = is_solvable(children).any(dim=(1, 3, 5))
    return torch.where(has_dirichlet, DIR, torch.where(has_interior, INT, EXT)).to(LABEL_DTYPE)


def coarsen_labels(fine_labels: torch.Tensor, lane_align: bool = False) -> torch.Tensor:
    """One level of label coarsening (8-children vote + boundary pass).

    Any DIRICHLET child -> DIRICHLET; else any solvable child -> INTERIOR;
    else EXTERIOR.  With `lane_align`, the coarse grid gains
    `coarse_lane_pad` trailing EXTERIOR cells along z.
    """
    coarse = vote_labels(fine_labels)
    if lane_align:
        extra = coarse_lane_pad(fine_labels.shape[2])
        if extra:
            coarse = pad(coarse, [(0, 0), (0, 0), (0, extra)], EXT)
    return set_boundary_labels(coarse, None)


def boundary_band(labels: torch.Tensor, width: int) -> torch.Tensor:
    """Dense mask of the boundary smoothing band: BOUNDARY cells, grown
    `width - 1` layers through INTERIOR face neighbours."""
    visited = labels == BND
    frontier = visited
    interior = labels == INT
    for _ in range(width - 1):
        dilated = frontier
        for axis in range(3):
            for direction in (0, 1):
                dilated = dilated | _neighbor(frontier, axis, direction, False)
        frontier = dilated & interior & ~visited
        visited = visited | frontier
    return visited


def build_level_coefficients(
    labels: torch.Tensor,
    face_weights: Sequence | None,
    boundary_width: int,
    dtype=torch.float64,
) -> dict:
    """Static stencil coefficient grids of one multigrid level.

      * ``diag``      -- sum over faces of w_f for neighbours in {INTERIOR,
                         BOUNDARY, DIRICHLET}; 0 on non-solvable cells.
      * ``inv_diag``  -- 1/diag on solvable cells, 0 elsewhere.
      * ``ew[axis]``  -- cell-shaped upper-face weights: entry i is w_f of
                         the face between cells i and i+1 where both are
                         solvable, else 0.
      * ``solvable``  -- bool DOF mask.
      * ``band``      -- bool boundary smoothing band mask.

    On coarse levels (face_weights=None) all face weights are 1.
    """
    device = labels.device
    solvable = is_solvable(labels)
    one = torch.ones((), dtype=dtype, device=device)
    zero = torch.zeros(labels.shape, dtype=dtype, device=device)
    diag = torch.zeros(labels.shape, dtype=dtype, device=device)
    edge_weights = []
    for axis in range(3):
        if face_weights is not None:
            wl, wu = _cell_faces(face_weights[axis].to(dtype), axis)
        else:
            wl = wu = one
        lbl_m = _neighbor(labels, axis, 0, EXT)
        lbl_p = _neighbor(labels, axis, 1, EXT)
        diag = diag + torch.where(solvable & (lbl_p != EXT), wu, zero)
        diag = diag + torch.where(solvable & (lbl_m != EXT), wl, zero)
        edge_weights.append(torch.where(solvable & is_solvable(lbl_p), wu, zero))

    safe = torch.where(diag > 0, diag, one)
    inv_diag = torch.where(solvable & (diag > 0), one / safe, torch.zeros_like(diag))
    return {
        "labels": labels,
        "solvable": solvable,
        "band": boundary_band(labels, boundary_width),
        "diag": diag,
        "inv_diag": inv_diag,
        "ew": edge_weights,
    }


def build_label_hierarchy(
    expanded_labels: torch.Tensor, mg_levels: int, max_levels: int | None = None
) -> list:
    """Coarsen labels level by level (no lane padding), stopping before the
    first level without a DOF (the reference caps its level count there)."""
    if max_levels is not None:
        mg_levels = min(mg_levels, max_levels)
    levels = [expanded_labels]
    for _ in range(1, mg_levels):
        coarse = coarsen_labels(levels[-1])
        if not bool(is_solvable(coarse).any()):
            break
        levels.append(coarse)
    return levels


# ---------------------------------------------------------------------------
# Invariant checks (the reference's built-in unit tests; host copies)
# ---------------------------------------------------------------------------


def _host(a) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu()
    return torch.as_tensor(np.asarray(a))


def check_exterior_shell(labels) -> bool:
    """All six outer faces of the grid must be fully EXTERIOR."""
    labels = _host(labels)
    for axis in range(3):
        for idx in (0, -1):
            sl = [slice(None)] * 3
            sl[axis] = idx
            if not bool((labels[tuple(sl)] == EXT).all()):
                return False
    return True


def check_coarsening(fine, coarse) -> bool:
    """Fine <-> coarse label consistency in both directions (coarse equals
    an independent recoarsening; every vote rule holds both ways)."""
    fine = _host(fine)
    coarse = _host(coarse)
    natural_z = fine.shape[2] // 2
    if coarse.shape[2] > natural_z:
        if bool((coarse[:, :, natural_z:] != EXT).any()):
            return False
        coarse = coarse[:, :, :natural_z]
    if tuple(2 * s for s in coarse.shape) != tuple(fine.shape):
        return False
    if not torch.equal(coarse, coarsen_labels(fine)):
        return False

    nx, ny, nz = coarse.shape
    children = fine.reshape(nx, 2, ny, 2, nz, 2)
    has_dir = (children == DIR).any(dim=(1, 3, 5))
    has_solv = is_solvable(children).any(dim=(1, 3, 5))
    all_ext = (children == EXT).all(dim=(1, 3, 5))

    if not bool(has_dir[coarse == DIR].all()):
        return False
    coarse_solv = is_solvable(coarse)
    if not bool((has_solv[coarse_solv] & ~has_dir[coarse_solv]).all()):
        return False
    if not bool(all_ext[coarse == EXT].all()):
        return False

    parent = coarse.repeat_interleave(2, 0).repeat_interleave(2, 1).repeat_interleave(2, 2)
    if bool((parent[is_solvable(fine)] == EXT).any()):
        return False
    if not bool((parent[fine == DIR] == DIR).all()):
        return False
    return True


def check_boundary_cells(labels, face_weights: Sequence | None) -> bool:
    """Every INTERIOR cell is fully regular; every BOUNDARY cell is justified;
    no solvable cell on the grid's outer shell."""
    labels = _host(labels)
    if not _regular_labels(labels, _irregular(labels, face_weights)):
        return False
    return check_exterior_shell(torch.where(is_solvable(labels), labels, EXT))


def _irregular(labels: torch.Tensor, face_weights) -> torch.Tensor:
    irregular = torch.zeros(labels.shape, dtype=torch.bool)
    for axis in range(3):
        for direction in (0, 1):
            nbr = _neighbor(labels, axis, direction, EXT)
            irregular |= (nbr == DIR) | (nbr == EXT)
    if face_weights is not None:
        for axis in range(3):
            wl, wu = _cell_faces(_host(face_weights[axis]), axis)
            irregular |= (wl != 1) | (wu != 1)
    return irregular


def _regular_labels(labels: torch.Tensor, irregular: torch.Tensor) -> bool:
    """Every INTERIOR cell regular, every BOUNDARY cell irregular."""
    return not bool(irregular[labels == INT].any()) and not bool((~irregular[labels == BND]).any())


def check_block(labels, face_weights, core: tuple, edges) -> bool:
    """`check_boundary_cells` and `check_exterior_shell` on a rank's block
    of a grid: `labels` (and `face_weights`, the faces of its cells, or
    None) cover the block grown by a halo of at least one cell, clipped at
    the grid's edges; `core` slices the block out of them; `edges[axis]`
    says whether the block reaches the grid's (lower, upper) edge there.
    Cells of the core are judged with their true neighbours, and only the
    faces of the grid's own shell that the block holds are checked."""
    labels = _host(labels)
    irregular = _irregular(labels, face_weights)[core]
    labels = labels[core]
    if not _regular_labels(labels, irregular):
        return False
    for axis, sides in enumerate(edges):
        for idx, at_edge in zip((0, -1), sides):
            sl = [slice(None)] * 3
            sl[axis] = idx
            if at_edge and not bool((labels[tuple(sl)] == EXT).all()):
                return False
    return True
