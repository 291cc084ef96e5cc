"""Geometric multigrid V-cycle engine (PyTorch port of ``solver/mg.py``).

  * device_hierarchy: every level's coefficients at the program
    granularity `config.setup_fusion` sets (one captured program, or one
    per level, on the card; eagerly on the CPU).
  * build_hierarchy: label coarsening with the JAX package's lane alignment,
    per-level coefficients, capping at the first coarse level without DOFs,
    and the coarsest level's direct solver (a dense inverse, or a Cholesky
    factor above COARSE_INVERSE_MAX_PAD bucketed DOFs).  The rule is the
    JAX package's (its `_finish_hierarchy`, mg.py:469-509), by device and
    dtype (`coarse_on_card`): with the levels on a CUDA device and a
    float32 V-cycle the system is assembled, padded and factored on the
    card (`coarse_system_card`); in float64, or on the CPU, it is
    assembled with scipy and factored on the host in float64 with numpy
    (`coarse_system`).
  * v_cycle: a V(1,1) cycle whose smoothing blocks are
    `ops.fused_smoother.smooth_level` (the CUDA kernel on CUDA tensors),
    adjoint GS ordering on the upstroke, 4x trilinear prolongation, and a
    smoothing-only cycle when the hierarchy has one level.
  * hierarchy_block_lists: each smoothed level's solve-invariant smoother
    data (band-cell list, narrowed coefficients and active tiles, or a
    sharded level's stacked haloed coefficients and their tiles, with the
    active tiles of its own grid), built once per solve.
  * level_flags: with a block mesh (`parallel.mesh.BlockMesh`) or a mesh
    of ranks (`parallel.mesh.DistMesh`), which levels run the block-mesh
    smoother (`parallel.fused_sharded`).
  * use_mm_transfers: which form of the transfers `v_cycle` runs
    (`config.transfer_mode`): per-axis matrix products or shifted slices.
  * coarse_system_device: the coarsest level's identity-padded dense
    inverse assembled and inverted on the level's device with a bucket the
    caller sizes (JAX `_coarse_system_traced`), for the frozen-geometry
    frame loop (`models.simulate.run_fused`).

Without a mesh every smoothed level runs the single-device chunk kernel on
the card: it takes any shape, so there is no eligibility gate -- and
with `config.mg_field_dtype` every smoothed level stores its fields narrow.
With a mesh, a level is "sharded" where the mesh splits it and
`sharded_eligible` holds (JAX mg.py:666-726); sharded levels keep the mg
dtype, the others narrow as before (JAX mg.py:807-812).

Across ranks (a `DistMesh`) a "sharded" level holds the rank's blocks
(`parallel.sharding.partitioned_problem` builds it, `shard_problem` cuts
it from a whole hierarchy; the hierarchy's `shapes` keep the
global shapes) and every other level is whole on every rank and runs the
single-device chunk kernel as without a mesh.  JAX leaves a level that the
mesh splits but the block kernels cannot take sharded under jnp and lets
XLA insert the halos (JAX mg.py:706-726); the port gathers such a level
whole instead -- the same arithmetic per cell.  Between two sharded levels
the transfers read a one-cell halo (`halo.exchange_halos` at depth 1);
from a sharded level to a whole one the restricted blocks are gathered
into the whole coarse grid on every rank (`distributed.gather_blocks`);
on the way up a rank prolongs from its slice of the whole coarse grid
with a one-cell margin.  The sharded levels come first and share their
split axes (checked).  Every decision comes from global shapes and the
configuration, so every rank takes the same exchanges.  The transfers take
the form `use_mm_transfers` picks on every kind of level: whole, a block
mesh's global arrays, and a rank's blocks with their margins (the halos
and gathers are the same in both forms).

`config.interior_smoother="chebyshev"` flags every level "plain": the
smoothing block is `chebyshev_block` in plain PyTorch and the downstroke's
residual `stencil.residual`, with the fields in the mg dtype.  This is the
JAX package's design (its Pallas flags are all off under this smoother,
JAX mg.py:685), not a fallback: no level has tiles or band lists, and the
CG step of `mgpcg.solve` still runs its kernel on the card.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from geometricmultigridpressuresolver_tpu_torch import device as device_mod
from geometricmultigridpressuresolver_tpu_torch.config import SolverConfig
from geometricmultigridpressuresolver_tpu_torch.grids import is_solvable
from geometricmultigridpressuresolver_tpu_torch.models import assembled
from geometricmultigridpressuresolver_tpu_torch.ops import blas, fused_cg, fused_smoother, stencil, transfer
from geometricmultigridpressuresolver_tpu_torch.ops import domain as domain_ops
from geometricmultigridpressuresolver_tpu_torch.parallel import distributed, fused_sharded, halo
from geometricmultigridpressuresolver_tpu_torch.parallel.mesh import DistMesh, grid_split, local_slices

# Largest bucketed coarse system solved through an explicit dense inverse
# (one matmul per cycle); bigger systems use a Cholesky factor.
COARSE_INVERSE_MAX_PAD = 4096


class MGHierarchy(NamedTuple):
    """Static multigrid hierarchy.

    The coarsest direct solver is a dense inverse (small systems) or a lower
    Cholesky factor (large ones); the unused one is a (0, 0) tensor.
    `coarse_dofs` maps bucket slots to flat cell indices of the coarsest
    level; pad slots hold the out-of-range index ncell.  `shapes` are the
    levels' global shapes when the levels hold a rank's blocks
    (`parallel.sharding.partitioned_problem` / `shard_problem`), None when
    every level is whole.
    """

    levels: tuple[stencil.LevelCoeffs, ...]
    coarse_dofs: torch.Tensor  # int64 (nd_pad,)
    coarse_minv: torch.Tensor  # (nd_pad, nd_pad) or (0, 0)
    coarse_chol: torch.Tensor  # (nd_pad, nd_pad) or (0, 0)
    shapes: tuple[tuple[int, int, int], ...] | None = None

    @property
    def num_levels(self) -> int:
        return len(self.levels)


def _level_coeffs(labels, face_weights, boundary_width: int, dtype, ew_dtype) -> stencil.LevelCoeffs:
    """One level's LevelCoeffs; `ew_dtype` optionally narrows the edge-weight
    storage (diag/inv_diag stay in `dtype`, an exact reciprocal pair)."""
    c = domain_ops.build_level_coefficients(labels, face_weights, boundary_width, dtype)
    ew = c["ew"]
    if ew_dtype is not None:
        ew = [w.to(ew_dtype) for w in ew]
    return stencil.LevelCoeffs(
        solvable=c["solvable"],
        band=c["band"].to(torch.int8),
        diag=c["diag"],
        inv_diag=c["inv_diag"],
        ew0=ew[0],
        ew1=ew[1],
        ew2=ew[2],
    )


def _build_levels(
    labels,
    face_weights,
    target_levels: int,
    boundary_width: int,
    dtype,
    ew_dtype=None,
    fine_dtype=None,
    fine_full: bool = False,
):
    """Every level's coefficients plus the capping flags.

    `fine_dtype` additionally builds the finest-level CG operator in the
    solve dtype: the full LevelCoeffs when `fine_full`, else only its three
    edge-weight grids (shared solvable/band/diag/inv_diag).  Returns
    (levels, flags, label_levels, fine); flags[i] says whether level i+1
    has any DOF.
    """
    cur = labels
    label_levels = [cur]
    levels, flags = [], []
    for i in range(target_levels):
        fw_i = face_weights if i == 0 else None
        # Never coarsen past an odd extent (or the cap).
        can_coarsen = i + 1 < target_levels and all(s % 2 == 0 for s in cur.shape)
        levels.append(_level_coeffs(cur, fw_i, boundary_width, dtype, ew_dtype))
        if not can_coarsen:
            break
        coarse = domain_ops.coarsen_labels(cur, lane_align=True)
        flags.append(is_solvable(coarse).any())
        cur = coarse
        label_levels.append(cur)

    fine = None
    if fine_dtype is not None:
        fc = _level_coeffs(labels, face_weights, boundary_width, fine_dtype, None)
        fine = fc if fine_full else (fc.ew0, fc.ew1, fc.ew2)
    return tuple(levels), tuple(flags), tuple(label_levels), fine


def _device_level(labels, face_weights, boundary_width: int, dtype, ew_dtype=None, coarsen: bool = True):
    """One level's coefficients, and with `coarsen` the next coarser labels
    and whether they hold a DOF: the program of one level at
    ``setup_fusion="per-level"`` (JAX `_device_level`)."""
    coeffs = _level_coeffs(labels, face_weights, boundary_width, dtype, ew_dtype)
    if not coarsen:
        return coeffs
    coarse = domain_ops.coarsen_labels(labels, lane_align=True)
    return coeffs, coarse, is_solvable(coarse).any()


def _levels_per_level(labels, face_weights, target_levels: int, boundary_width: int, dtype, ew_dtype=None,
                      fine_dtype=None, fine_full: bool = False, split=None):
    """`_build_levels` as JAX's per-level dispatch (`device_hierarchy`'s
    loop over `_device_level`), the same bits: `split()` between one
    level's program and the next, and before the fine operator's."""
    cur = labels
    label_levels = [cur]
    levels, flags = [], []
    for i in range(target_levels):
        if i:
            split()
        fw_i = face_weights if i == 0 else None
        can_coarsen = i + 1 < target_levels and all(s % 2 == 0 for s in cur.shape)
        if not can_coarsen:
            levels.append(_device_level(cur, fw_i, boundary_width, dtype, ew_dtype, coarsen=False))
            break
        coeffs, coarse, has_dofs = _device_level(cur, fw_i, boundary_width, dtype, ew_dtype)
        levels.append(coeffs)
        flags.append(has_dofs)
        cur = coarse
        label_levels.append(cur)
    fine = None
    if fine_dtype is not None:
        split()
        fc = _device_level(labels, face_weights, boundary_width, fine_dtype, coarsen=False)
        fine = fc if fine_full else (fc.ew0, fc.ew1, fc.ew2)
    return tuple(levels), tuple(flags), tuple(label_levels), fine


def hierarchy_levels(labels, face_weights, target_levels: int, config: SolverConfig, fine_dtype=None,
                     fine_full: bool = False, per_level: bool = False, split=None):
    """(levels, flags, label_levels, fine) of `labels`: `_build_levels`, or
    with `per_level` its per-level form, whose stages `split` cuts."""
    dtype, bw, ew = config.mg_dtype_resolved, config.boundary_width, config.mg_ew_dtype
    if per_level:
        return _levels_per_level(labels, face_weights, target_levels, bw, dtype, ew, fine_dtype, fine_full, split)
    return _build_levels(labels, face_weights, target_levels, bw, dtype, ew, fine_dtype, fine_full)


def device_hierarchy(labels, face_weights, target_levels: int, config: SolverConfig,
                     fine_dtype=None, fine_full: bool = False, mesh=None):
    """`_build_levels` at the configured program granularity (JAX
    `device_hierarchy`): the same (levels, flags, label_levels, fine).

    On the card (`graph.programs_on`) it is one program, captured once
    per shape and key and replayed after that, the caller getting copies
    of its outputs (`graph.call`): "fused" one graph for every level and
    the fine operator, "per-level" one graph per level (JAX
    `_device_level`) and one for the fine operator, all in the program's
    one memory pool.  On the CPU, or across ranks, both run eagerly; the
    two granularities give the same bits.  The granularity comes from
    `config.setup_fusion_resolved(labels.shape, mesh.size)`."""
    from geometricmultigridpressuresolver_tpu_torch.solver import graph

    n_dev = 1 if mesh is None else mesh.size
    per_level = config.setup_fusion_resolved(labels.shape, n_dev) == "per-level"

    def build(lab, fw, split):
        return hierarchy_levels(lab, fw, target_levels, config, fine_dtype, fine_full, per_level, split)

    if isinstance(mesh, DistMesh) or not graph.programs_on(labels.device):
        return build(labels, face_weights, graph.no_split)
    key = (target_levels, config.mg_dtype_resolved, config.boundary_width, config.mg_ew_dtype, fine_dtype,
           fine_full, per_level)
    return graph.call("hierarchy", key, build, (labels, face_weights), labels.device)


def candidate_shapes(shape, target_levels: int) -> list[tuple[int, int, int]]:
    """The shapes `_build_levels` gives its levels before the capping: each
    coarse level half the one above (`coarsen_labels(lane_align=True)`'s z
    padding included) while the extents stay even, at most
    `target_levels`."""
    shapes = [tuple(int(n) for n in shape)]
    while len(shapes) < target_levels and all(n % 2 == 0 for n in shapes[-1]):
        nx, ny, nz = shapes[-1]
        shapes.append((nx // 2, ny // 2, nz // 2 + domain_ops.coarse_lane_pad(nz)))
    return shapes


def build_hierarchy(
    labels,
    face_weights: Sequence | None,
    mg_levels: int,
    config: SolverConfig | None = None,
    validate: bool = False,
    device=None,
) -> MGHierarchy:
    """Hierarchy from expanded and relabeled finest labels (+ finest weights),
    built on `device` (default: the labels' device if they are a tensor,
    else the card) at the configured granularity (`device_hierarchy`)."""
    if config is None:
        config = SolverConfig()
    dtype = config.mg_dtype_resolved
    target_levels = mg_levels
    if config.max_mg_levels is not None:
        target_levels = min(target_levels, config.max_mg_levels)
    dev = device_mod.of(labels, device)
    cur = torch.as_tensor(labels, device=dev).to(torch.int8)
    fw = None if face_weights is None else tuple(
        torch.as_tensor(w, dtype=dtype, device=dev) for w in face_weights
    )
    levels, flags, label_levels, _ = device_hierarchy(cur, fw, target_levels, config)
    return _finish_hierarchy(levels, flags, label_levels, config, validate=validate, host_fw=fw)


def _finish_hierarchy(
    levels, flags, label_levels, config: SolverConfig, validate: bool = False, host_fw=None
) -> MGHierarchy:
    """Level capping and the coarsest direct solver (`coarse_direct`).

    One round trip, as in the JAX package (mg.py:425-428): the capping
    flags and every level's DOF count come to the host as one tensor, so
    the cap and the bucket need no second fetch; the card path then syncs
    no more.  `validate` fetches every level's labels besides."""
    levels = list(levels)
    label_levels = list(label_levels)
    counts = torch.stack(
        [f.to(torch.int64) for f in flags] + [c.solvable.sum() for c in levels]
    ).cpu().tolist()
    for i, ok in enumerate(counts[: len(flags)]):
        if not ok:
            levels = levels[: i + 1]
            label_levels = label_levels[: i + 1]
            break
    ndof = counts[len(flags) + len(levels) - 1]

    if validate:
        label_host = [lv.cpu() for lv in label_levels]
        fw_host = None if host_fw is None else [w.cpu() for w in host_fw]
        assert domain_ops.check_exterior_shell(label_host[0])
        assert domain_ops.check_boundary_cells(label_host[0], fw_host)
        for fine, coarse_lv in zip(label_host, label_host[1:]):
            assert domain_ops.check_coarsening(fine, coarse_lv)
            assert domain_ops.check_boundary_cells(coarse_lv, None)

    coarse = levels[-1] if len(levels) > 1 else None
    dofs, minv, chol = coarse_direct(label_levels[-1], ndof, coarse, config, levels[0].diag.device)
    return MGHierarchy(levels=tuple(levels), coarse_dofs=dofs, coarse_minv=minv, coarse_chol=chol)


def coarse_on_card(device, dtype) -> bool:
    """Whether the coarsest level is factored on the card: a CUDA device
    and a float32 V-cycle -- the JAX package's rule (mg.py:474-477: an
    accelerator platform and float32) with the levels' device in place of
    JAX's default one.  Float64, or the CPU, takes the host path."""
    return torch.device(device).type == "cuda" and dtype == torch.float32


def coarse_bucket(ndof: int) -> int:
    """The bucketed DOF count of a coarsest level with `ndof` DOFs: a
    multiple of 256, at least 256 (0 without DOFs).  Pad slots get an
    identity block, so block_diag(A, I)^-1 = block_diag(A^-1, I).  Over
    16384 DOFs the dense solve is refused."""
    if ndof > 16384:
        raise ValueError(
            f"coarsest level has {ndof} DOFs; increase mg levels "
            "(dense coarse solve would be too large)"
        )
    return max(256, -(-ndof // 256) * 256) if ndof else 0


def coarse_direct(labels, ndof: int | None, coarse, config: SolverConfig, device):
    """The coarsest level's direct solver by `coarse_on_card`'s rule:
    (coarse_dofs, coarse_minv, coarse_chol).

    `labels` are the coarsest level's whole labels; `ndof` their DOF count
    (None: counted here, a host sync); `coarse` their whole coefficients
    with unit weights, or None to build them here (the finest level's own
    carry its face weights, which the coarse system never uses)."""
    dtype = config.mg_dtype_resolved
    if not coarse_on_card(device, dtype):
        return coarse_system(labels, dtype, device)
    if ndof is None:
        ndof = int(is_solvable(labels).sum())
    nd_pad = coarse_bucket(ndof)
    if coarse is None:
        coarse = _level_coeffs(labels, None, config.boundary_width, dtype, None)
    return coarse_system_card(coarse, nd_pad)


def coarse_system(labels, dtype, device):
    """The host path of the coarsest level's direct solver (JAX
    `_finish_hierarchy`'s non-accelerator branch, mg.py:500-509), taken in
    float64 or on the CPU: the matrix assembled from the whole labels with
    scipy (`assembled.assemble_poisson`), padded to `coarse_bucket`'s
    bucket with an identity block and factored on the host in float64 with
    numpy -- inverted and symmetrized up to COARSE_INVERSE_MAX_PAD, a lower
    Cholesky factor above -- then cast to `dtype` on `device`:
    (coarse_dofs, coarse_minv, coarse_chol)."""
    coarsest = labels.cpu().numpy()
    a, idx = assembled.assemble_poisson(coarsest, None)
    ndof = a.shape[0]
    nd_pad = coarse_bucket(ndof)
    empty = torch.zeros((0, 0), dtype=dtype, device=device)
    minv = chol = empty
    if ndof:
        a_pad = np.eye(nd_pad)
        a_pad[:ndof, :ndof] = a.toarray()
        if nd_pad > COARSE_INVERSE_MAX_PAD:
            chol = torch.as_tensor(np.linalg.cholesky(a_pad), dtype=dtype, device=device)
        else:
            minv = torch.as_tensor(np.linalg.inv(a_pad), dtype=dtype, device=device)
            minv = 0.5 * (minv + minv.T)  # exactly symmetric preconditioner
    dofs = np.flatnonzero(np.asarray(idx).ravel() >= 0)
    dofs = np.pad(dofs, (0, nd_pad - ndof), constant_values=idx.size)
    return torch.as_tensor(dofs, dtype=torch.int64, device=device), minv, chol


def coarse_matrix(c: stencil.LevelCoeffs, nd_pad: int):
    """The coarsest level's identity-padded dense system, assembled on the
    level's device and in its dtype: (a, coarse_dofs, ndof), the
    counterpart of the JAX package's `_densify` (and of the assembly in its
    `_coarse_system_traced`).

    The matrix comes straight from the stencil coefficients (A[i,i] = diag,
    A[i,j] = -ew between solvable neighbours, the operator
    `stencil.apply_poisson` applies), in flat C cell order as the host
    assembler numbers the DOFs; with unit weights it is the matrix of
    `assembled.assemble_poisson`, entry for entry.  It is built
    (nd_pad + 1)^2 with a dump row and column at nd_pad: non-DOF cells,
    couplings to Dirichlet or exterior neighbours and slots past the bucket
    (ndof > nd_pad) all write there, and the dump is cut off.  Every kept
    entry is written once, with no accumulation, so the matrix is the same
    bits on every call and device; no host sync.  `coarse_dofs` maps slots
    to flat cells, pad slots holding the sentinel ncell; `ndof` is a
    device scalar.
    """
    dtype, dev = c.diag.dtype, c.diag.device
    solv = c.solvable.reshape(-1)
    ncell = solv.numel()
    rank = torch.cumsum(solv.to(torch.int64), 0) - 1
    ndof = solv.sum()
    slot = torch.where(solv & (rank < nd_pad), rank, nd_pad)
    side = nd_pad + 1
    a = torch.zeros(side * side, dtype=dtype, device=dev)
    a[slot * side + slot] = torch.where(solv, c.diag.reshape(-1).to(dtype), 0.0)
    slot3 = slot.reshape(c.shape)
    for axis, ew in enumerate((c.ew0, c.ew1, c.ew2)):
        lo = [slice(None)] * 3
        hi = [slice(None)] * 3
        lo[axis], hi[axis] = slice(0, -1), slice(1, None)
        s_lo = slot3[tuple(lo)].reshape(-1)
        s_hi = slot3[tuple(hi)].reshape(-1)
        # ew[i] couples cells i and i+1 along `axis`; 0 - w keeps a zero
        # weight +0.0, as the JAX package's scatter-add leaves it.
        w = 0.0 - ew[tuple(lo)].reshape(-1).to(dtype)
        a[s_lo * side + s_hi] = w
        a[s_hi * side + s_lo] = w
    a = a.reshape(side, side)[:nd_pad, :nd_pad]
    i = torch.arange(nd_pad, device=dev)
    a[i, i] += (i >= ndof).to(dtype)
    dofs = torch.full((side,), ncell, dtype=torch.int64, device=dev)
    dofs[slot] = torch.arange(ncell, dtype=torch.int64, device=dev)
    return a, dofs[:nd_pad], ndof


def invert(a: torch.Tensor) -> torch.Tensor:
    """The inverse of a square matrix with no host sync (`inv_ex`, its
    error check skipped), through cuSOLVER on a CUDA device: PyTorch's
    default linalg backend may pick MAGMA, whose LU works partly on the
    host and cannot be captured in a CUDA graph (a frame of
    `models.simulate.run_fused` is), so every card path factors with the
    same library and gives the same bits eagerly and captured."""
    if not a.is_cuda:
        return torch.linalg.inv_ex(a)[0]
    backend = torch.backends.cuda.preferred_linalg_library()
    torch.backends.cuda.preferred_linalg_library("cusolver")
    try:
        return torch.linalg.inv_ex(a)[0]
    finally:
        torch.backends.cuda.preferred_linalg_library(backend)


def coarse_system_card(c: stencil.LevelCoeffs, nd_pad: int):
    """The card path of the coarsest level's direct solver (JAX
    `_finish_hierarchy`'s accelerator branch, mg.py:477-499): the padded
    system from `coarse_matrix`, then, on the level's device and in its
    dtype, with no host sync, either (nd_pad <= COARSE_INVERSE_MAX_PAD)
    its inverse symmetrized (JAX `_densify_invert`) or its lower Cholesky
    factor (JAX `_densify_cholesky`): (coarse_dofs, coarse_minv,
    coarse_chol), the unused one (0, 0).

    The factorizations skip their error checks, which would sync the host
    (`inv_ex`, `cholesky_ex`); a failed Cholesky factor is all NaN, as the
    JAX package's is, for the caller to see.  `nd_pad` must hold every DOF
    (`coarse_bucket`)."""
    empty = c.diag.new_zeros((0, 0))
    if nd_pad == 0:
        return torch.zeros(0, dtype=torch.int64, device=c.diag.device), empty, empty
    a, dofs, _ = coarse_matrix(c, nd_pad)
    if nd_pad > COARSE_INVERSE_MAX_PAD:
        chol, info = torch.linalg.cholesky_ex(a)
        return dofs, empty, torch.where(info == 0, chol, float("nan"))
    minv = invert(a)
    return dofs, 0.5 * (minv + minv.T), empty


def coarse_system_device(c: stencil.LevelCoeffs, nd_pad: int):
    """The coarsest level's direct solve built on the level's device and in
    its dtype, with no host round trip: (coarse_dofs, coarse_minv, ndof),
    the counterpart of the JAX package's `_coarse_system_traced`.

    `coarse_matrix` assembles the system in a bucket of `nd_pad` slots the
    caller sizes; then `invert` (`torch.linalg.inv_ex` through cuSOLVER,
    its error check skipped, which would sync the host; the JAX package's
    traced path also always inverts, whatever the bucket), symmetrized.
    Nothing here reads the host, so a captured frame holds it.  `ndof` is a
    device scalar, and `ndof > nd_pad` means the bucket overflowed (the
    preconditioner is then weakened but still symmetric; `run_fused` checks
    it).
    """
    a, dofs, ndof = coarse_matrix(c, nd_pad)
    minv = invert(a)
    minv = 0.5 * (minv + minv.T)
    return dofs, minv, ndof


def coarse_solve(hier: MGHierarchy, b: torch.Tensor) -> torch.Tensor:
    """Direct solve on the coarsest level: gather DOFs, apply the inverse
    (one matmul) or the Cholesky factor, scatter back.

    Pad slots carry the index ncell: the gather clamps it (the identity pad
    block keeps real rows clean), and the scatter sends pad slots to a spare
    element past the grid that is then dropped.
    """
    ncell = b.numel()
    dofs = hier.coarse_dofs
    bv = b.reshape(-1)[dofs.clamp(max=max(ncell - 1, 0))]
    if hier.coarse_chol.shape[0] > 0:
        xv = torch.cholesky_solve(bv[:, None], hier.coarse_chol).squeeze(1)
    else:
        with blas.ieee_products():  # JAX mg.py:540: precision=HIGHEST
            xv = torch.matmul(hier.coarse_minv, bv)
    flat = b.new_zeros(ncell + 1)
    flat.index_copy_(0, dofs, xv)
    return flat[:ncell].reshape(b.shape)


def use_mm_transfers(config: SolverConfig, device) -> bool:
    """Whether the V-cycle's transfers run as matrix products
    (`transfer.restrict_mm` / `prolong_add_mm`) on `device`: "mm" and
    "slice" win as given; "auto" takes the products on a CUDA device and
    the slices elsewhere -- the JAX package's rule (`_use_mm_transfers`,
    products on the TPU) with the card in the TPU's place."""
    if config.transfer_mode != "auto":
        return config.transfer_mode == "mm"
    return torch.device(device).type == "cuda"


def smoothed_levels(hier: MGHierarchy) -> range:
    """Levels that run a smoothing block: all but the coarsest (solved
    directly), or the only level of a one-level hierarchy."""
    return range(max(hier.num_levels - 1, 1))


def field_dtype(hier: MGHierarchy, config: SolverConfig) -> torch.dtype:
    """Storage dtype of the single-device smoothed levels' fields
    (mg.py:794-812 of the JAX package): `config.mg_field_dtype` on a
    float32 V-cycle whose downstroke can fuse its residual, else the
    hierarchy's dtype."""
    dtype = hier.levels[0].diag.dtype
    if (
        config.mg_field_dtype is not None
        and dtype == torch.float32
        and fused_smoother.residual_fusable(config, forward=True)
    ):
        return config.mg_field_dtype
    return dtype


def level_shapes(hier: MGHierarchy) -> tuple[tuple[int, int, int], ...]:
    """The levels' global shapes (`hier.shapes`, else the levels' own; any
    object with `levels` of some `shape` will do)."""
    shapes = getattr(hier, "shapes", None)
    return shapes if shapes is not None else tuple(tuple(c.shape) for c in hier.levels)


def level_flags(hier: MGHierarchy, config: SolverConfig, mesh=None) -> tuple[str, ...]:
    """Per level, "sharded" (the block-mesh smoother) or "single" (the
    single-device smoother on the whole tensor): "sharded" where `mesh`
    splits the level and `sharded_eligible` holds (JAX mg.py:707-722).
    Without a mesh, or on a one-block mesh, every level is "single".  Under
    `config.interior_smoother="chebyshev"` every level is "plain" (the
    smoother's plain PyTorch block, JAX mg.py:685)."""
    return shape_flags(level_shapes(hier), config, mesh)


def shape_flags(shapes, config: SolverConfig, mesh=None) -> tuple[str, ...]:
    """`level_flags` of a hierarchy whose levels have the global `shapes`
    (the partitioned build decides from them before any level exists)."""
    nlev = len(shapes)
    if config.interior_smoother == "chebyshev":
        return ("plain",) * nlev
    if mesh is None or mesh.size == 1:
        return ("single",) * nlev
    flags = []
    for level, shape in enumerate(shapes):
        split = grid_split(mesh, shape)
        sharded = any(split) and fused_sharded.sharded_eligible(shape, split, mesh, level, nlev)
        flags.append("sharded" if sharded else "single")
    return tuple(flags)


def _check_rank_levels(shapes, flags, mesh) -> None:
    """Across ranks the sharded levels must come first and share their
    split axes, each core half the one above (the transfers' one-cell halos
    and the gather of the last sharded level rely on it)."""
    sharded = [lv for lv, f in enumerate(flags) if f == "sharded"]
    if sharded != list(range(len(sharded))):
        raise NotImplementedError(f"sharded levels {sharded} do not lead the hierarchy")
    for lv in sharded[1:]:
        fine, coarse = halo.geometry(mesh, shapes[lv - 1]), halo.geometry(mesh, shapes[lv])
        if fine.blocks != coarse.blocks or any(f != 2 * c for f, c in zip(fine.core, coarse.core)):
            raise NotImplementedError(
                f"levels {lv - 1} and {lv} ({shapes[lv - 1]}, {shapes[lv]}) split differently on {mesh.shape}"
            )


def level_field_dtypes(hier: MGHierarchy, config: SolverConfig, flags) -> tuple[torch.dtype, ...]:
    """Storage dtype of each level's fields: `field_dtype` on single-device
    smoothed levels, the hierarchy's dtype on sharded levels and on the
    coarsest (directly solved) level."""
    dtype = hier.levels[0].diag.dtype
    fdt = field_dtype(hier, config)
    smoothed = smoothed_levels(hier)
    return tuple(
        fdt if level in smoothed and flag == "single" else dtype
        for level, flag in enumerate(flags)
    )


def hierarchy_block_lists(hier: MGHierarchy, config: SolverConfig, mesh=None):
    """Per-level solve-invariant smoother data of the smoothed levels:
    `ops.fused_smoother.LevelBlocks` on single-device levels,
    `fused_sharded.ShardedBlocks` (the stacked haloed coefficients and their
    blocks) on sharded ones, None for the coarsest.  Either kind's `tiles`
    are the active tiles of the level's own grid; "plain" levels have none.
    A CG loop builds this once and passes it to every `v_cycle` (JAX
    mg.py:729-768); on a single device it reads nothing on the host.  Across ranks a sharded level's entry holds the rank's
    haloed block (its coefficients exchanged here once)."""
    flags = level_flags(hier, config, mesh)
    fdts = level_field_dtypes(hier, config, flags)
    smoothed = smoothed_levels(hier)
    shapes = level_shapes(hier)
    if isinstance(mesh, DistMesh):
        _check_rank_levels(shapes, flags, mesh)
    out = []
    for level, c in enumerate(hier.levels):
        if level not in smoothed or flags[level] == "plain":
            out.append(None)
        elif flags[level] == "sharded":
            out.append(fused_sharded.sharded_blocks(c, mesh, config.kernel_mode, shapes[level]))
        else:
            out.append(fused_smoother.level_blocks(c, config, fdts[level]))
    return tuple(out)


def chebyshev_block(x, b, c: stencil.LevelCoeffs, config: SolverConfig, emit_dot: bool = False,
                    x_is_zero: bool = False):
    """The Chebyshev smoothing block b^k, polynomial, b^k in plain PyTorch
    (JAX mg.py:581-592): the same block on both strokes, the polynomial
    being self-adjoint in the A inner product.  With `x_is_zero` the
    argument `x` is ignored (it may be None).  Returns x', or (x', <x', b>)
    with `emit_dot`, the dot in x's dtype."""
    if x_is_zero:
        x = torch.zeros_like(b)
    for _ in range(config.boundary_iterations):
        x = stencil.boundary_jacobi(x, b, c, config.jacobi_damping)
    x = stencil.chebyshev_smooth(x, b, c, config.chebyshev_degree)
    for _ in range(config.boundary_iterations):
        x = stencil.boundary_jacobi(x, b, c, config.jacobi_damping)
    if emit_dot:
        return x, blas.dot(x, b, c.solvable)
    return x


def v_cycle(
    hier: MGHierarchy,
    x,
    b: torch.Tensor,
    config: SolverConfig | None = None,
    use_initial_guess: bool = False,
    emit_fine_dot: bool = False,
    block_lists=None,
    mesh=None,
):
    """One V(1,1) multigrid cycle; returns the updated solution grid, or
    (x, <x, b>) with `emit_fine_dot` (the CG rho when b is the CG residual).

    Without `use_initial_guess` the cycle starts from x = 0 and `x` may be
    None.  The single-device smoothed levels store their fields as
    `field_dtype` (the transfers, in the form `use_mm_transfers` picks,
    run in torch on those fields); sharded
    levels (with a block `mesh`, `level_flags`), the coarse solve and the
    returned x are in the hierarchy's dtype.  `block_lists` must come from
    `hierarchy_block_lists` with the same mesh.  Across ranks (a
    `DistMesh`) x and b are the rank's blocks of the finest level when it
    is sharded, and the fine dot is summed over the ranks.
    """
    if config is None:
        config = SolverConfig()
    dtype = hier.levels[0].diag.dtype
    nlev = hier.num_levels
    flags = level_flags(hier, config, mesh)
    vdt = level_field_dtypes(hier, config, flags)
    ranks = isinstance(mesh, DistMesh)
    shapes = level_shapes(hier)

    b = b.to(vdt[0])
    if use_initial_guess:
        x = x.to(vdt[0])
    if block_lists is None:
        block_lists = hierarchy_block_lists(hier, config, mesh)

    def smooth(level, xl, rhs_l, forward, **kw):
        c = hier.levels[level]
        if flags[level] == "plain":
            return chebyshev_block(xl, rhs_l, c, config, **kw)
        if flags[level] == "sharded":
            sb = block_lists[level]
            return fused_sharded.smooth_level_sharded(
                xl, rhs_l, c, config, forward, mesh, prehaloed=sb.prehaloed, blocks=sb.blocks,
                shape=shapes[level], **kw
            )
        return fused_smoother.smooth_level(xl, rhs_l, c, config, forward, blocks=block_lists[level], **kw)

    def split(level):
        return grid_split(mesh, shapes[level]) if flags[level] == "sharded" else (False,) * 3

    transfers = transfer.form(use_mm_transfers(config, b.device))

    def restrict(level, r):
        # Across ranks a sharded level restricts its block grown by a
        # one-cell halo, and a whole coarse level gathers the blocks.
        coarse = hier.levels[level + 1].solvable
        if not (ranks and flags[level] == "sharded"):
            return transfers.restrict(r, coarse)
        g1 = halo.geometry(mesh, shapes[level], depth=1)
        out = transfers.restrict_natural(halo.exchange_halos(r, g1, mesh), g1.halo + (0,))
        if flags[level + 1] != "sharded":
            natural = tuple(n // 2 for n in shapes[level])
            out = distributed.gather_blocks(out, mesh, natural, split(level))
        return transfer.fit_coarse(out, coarse)

    def prolong_add(level, xl, coarse_x):
        # Across ranks a sharded level prolongs from the coarse cells under
        # its block with a one-cell margin: a halo of a sharded coarse
        # level, or a slice of a whole one (zeros past its edge).
        c = hier.levels[level]
        if not (ranks and flags[level] == "sharded"):
            return transfers.prolong_add(xl, coarse_x, c.solvable)
        margin = halo.geometry(mesh, shapes[level], depth=1).halo + (0,)
        if flags[level + 1] == "sharded":
            coarse_x = halo.exchange_halos(coarse_x, halo.geometry(mesh, shapes[level + 1], depth=1), mesh)
        else:
            own = local_slices(mesh.shape, shapes[level], mesh.rank, split(level))
            padded = torch.nn.functional.pad(coarse_x, (0, 0, margin[1], margin[1], margin[0], margin[0]))
            coarse_x = padded[tuple(
                slice(s.start // 2, s.stop // 2 + 2 * m) if m else slice(None) for s, m in zip(own, margin)
            )]
        return transfers.prolong_add(xl, coarse_x, c.solvable, margin)

    def finish(out):
        # The caller gets the hierarchy dtype whatever the field storage.
        if emit_fine_dot:
            rho = out[1]
            if ranks and flags[0] != "sharded":
                rho = distributed.ordered_sum(mesh, rho, mesh.owns(split(0)))
            return out[0].to(dtype), rho
        return out.to(dtype)

    if nlev == 1:
        # Single-level cycle is smoothing-only.
        return finish(smooth(0, x, b, True, emit_dot=emit_fine_dot, x_is_zero=not use_initial_guess))

    # Downstroke.  Every level but a warm-started finest one enters with
    # x == 0: the smoother then skips reading x and emits the residual
    # (a sharded level only where the ring budget allows it, as in JAX
    # mg.py:853-858).
    rhs = [b] + [None] * (nlev - 1)
    sols = [None] * nlev
    for level in range(nlev - 1):
        c = hier.levels[level]
        x_zero = level > 0 or not use_initial_guess
        fuse = flags[level] == "single" or (
            flags[level] == "sharded" and fused_smoother.residual_fusable(config, forward=True)
        )
        if x_zero and fuse:
            xl, r = smooth(level, None, rhs[level], True, x_is_zero=True, emit_residual=True)
        else:
            xl = smooth(level, None if x_zero else x, rhs[level], True, x_is_zero=x_zero)
            if flags[level] == "plain":
                r = stencil.residual(xl, rhs[level], c)
            elif ranks and flags[level] == "sharded":
                sb = block_lists[level]
                r = fused_sharded.residual_sharded(
                    xl, rhs[level], (sb.prehaloed.diag, sb.prehaloed.ew0, sb.prehaloed.ew1, sb.prehaloed.ew2),
                    sb.tiles, mesh, shapes[level], config.kernel_mode,
                )
            else:
                # In the hierarchy's dtype, as the JAX package forms it here.
                r = fused_cg.residual(
                    xl.to(dtype), rhs[level].to(dtype), c.diag, c.ew0, c.ew1, c.ew2,
                    mode=config.kernel_mode, tiles=block_lists[level].tiles,
                )
        sols[level] = xl
        rhs[level + 1] = restrict(level, r).to(vdt[level + 1])

    sols[nlev - 1] = coarse_solve(hier, rhs[nlev - 1])

    # Upstroke with adjoint smoother ordering.
    for level in range(nlev - 2, -1, -1):
        xl = prolong_add(level, sols[level], sols[level + 1].to(vdt[level]))
        sols[level] = smooth(level, xl, rhs[level], False, emit_dot=emit_fine_dot and level == 0)
    return finish(sols[0])
