"""The multi-process mesh on torch.distributed (port of ``parallel/distributed.py``).

The JAX package joins processes with `jax.distributed.initialize`, after
which one `jax.sharding.Mesh` spans every process's devices and XLA emits
the collectives.  The port runs one process (a rank) per device and
builds a `parallel.mesh.DistMesh` over them: `initialize` starts the
process group, `global_mesh` lays the ranks out as `factor_mesh(world)`
in JAX's row-major device order.

A sharded grid is represented as the rank's block, a plain tensor, whose
global slices follow from the mesh and the grid's global shape
(`mesh.local_slices`); the global shapes of a hierarchy's levels travel
with it (`solver.mg.MGHierarchy.shapes`).  `make_global_grid` builds a
rank's block from a callable over its slices (a rank materializes only
its own block) or from a full array.

The collectives every rank runs in the same order:

  * `ordered_sum` / `ordered_max`: each rank's partial goes to every rank
    by `all_gather`, and every rank adds the values in rank order, so a
    dot, alpha, beta and the convergence test are bit-equal on every rank.
    `all_reduce(SUM)` is not used: its order belongs to NCCL or gloo.  Only
    the rank that owns a block (`DistMesh.owns`) contributes it, so a
    replicated grid counts once.
  * `gather_blocks`: every rank's block of a level, assembled into the
    whole grid on every rank (a split level feeding a replicated one, the
    pressure before the writeback).
  * `broadcast_flag`: rank 0's host decision (the CG loop's
    `interrupt_check`) on every rank.
  * `exchange`: the point-to-point messages of a halo exchange
    (`parallel.halo.exchange_halos`), one `dist.batch_isend_irecv`.
  * `redistribute`: a grid moved from one set of per-rank boxes (a
    `Layout`) into another (each rank's destination box, which may reach
    past the grid: those cells take a fill value): every rank sends the
    intersection of the box it owns with each other rank's destination and
    receives the parts of its own, in one `exchange`.  It carries base
    blocks into haloed blocks and window blocks (the partitioned setup, the
    right-hand side, the warm start), and window blocks into the base boxes
    of the writeback, never through a whole grid.

Transport: under NCCL, CUDA tensors go straight to the collective.  Under
gloo, a CUDA tensor is copied into a pinned host buffer before the
collective and back after it (`_staged` / `_unstaged`, counted in
`CommStats.bytes_staged`); the gathered parts are added, or assembled
into a whole grid, on the rank's device under either backend, so the
compute stays on the card.  Nothing switches backend
or device by itself: `initialize` uses NCCL on `cuda:{LOCAL_RANK}` unless
the caller names gloo, and raises when that cannot run.
"""

from __future__ import annotations

import datetime
import os
import time
from typing import Callable, NamedTuple, Sequence

import numpy as np
import torch
import torch.distributed as dist

from geometricmultigridpressuresolver_tpu_torch.grids import face_shape

from geometricmultigridpressuresolver_tpu_torch.parallel.mesh import (
    Box,
    DistMesh,
    block_box,
    box_shape,
    box_slices,
    contains,
    face_box,
    face_split,
    factor_mesh,
    grid_split,
    intersect,
    local_slices,
    owner,
)

DEFAULT_TIMEOUT = datetime.timedelta(seconds=600)


def _default_device() -> torch.device:
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available: a rank runs on cuda:{LOCAL_RANK} "
            "unless the caller names a device (device='cpu' with backend='gloo')"
        )
    return torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))


def initialize(
    backend: str | None = None,
    init_method: str | None = None,
    world_size: int | None = None,
    rank: int | None = None,
    device=None,
    timeout: datetime.timedelta = DEFAULT_TIMEOUT,
) -> DistMesh:
    """Join (or start) the process group and return this rank's `global_mesh`.

    `backend` defaults to "nccl" and `device` to ``cuda:{LOCAL_RANK}``;
    "gloo" runs only when named (with device="cpu" on a machine without a
    card, or a CUDA device whose tensors are staged through host memory).
    NCCL needs a CUDA device and raises before starting anything without
    one.  `init_method`, `world_size` and `rank` are those of
    `dist.init_process_group` (None: the environment's ``MASTER_ADDR`` /
    ``WORLD_SIZE`` / ``RANK``).  Every collective waits at most `timeout`.
    """
    backend = "nccl" if backend is None else backend
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"unknown backend {backend!r}: 'nccl' or 'gloo'")
    device = _default_device() if device is None else torch.device(device)
    if backend == "nccl" and device.type != "cuda":
        raise ValueError(f"the NCCL backend needs a CUDA device, got {device}")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(
        backend, init_method=init_method, world_size=-1 if world_size is None else world_size,
        rank=-1 if rank is None else rank, timeout=timeout,
    )
    return global_mesh(device)


def global_mesh(device=None, group=None) -> DistMesh:
    """The solver's (mx, my, mz) mesh over the running world: the ranks laid
    out as `factor_mesh(world)` in row-major order (JAX `make_mesh`'s device
    order), this rank on `device` (default ``cuda:{LOCAL_RANK}``)."""
    if not dist.is_initialized():
        raise RuntimeError("torch.distributed is not initialized: call distributed.initialize() first")
    device = _default_device() if device is None else torch.device(device)
    world = dist.get_world_size(group)
    return DistMesh(factor_mesh(world), dist.get_rank(group), device, dist.get_backend(group), group)


def process_local_slices(global_shape: Sequence[int], mesh: DistMesh, split=None):
    """The (global-index slices, device) pairs THIS rank must produce: one
    entry, its block (`split` defaults to `grid_split`'s rule)."""
    if split is None:
        split = grid_split(mesh, global_shape)
    return [(local_slices(mesh.shape, global_shape, mesh.rank, split), mesh.device)]


def make_global_grid(
    global_shape: Sequence[int],
    local_block: Callable[[tuple[slice, ...]], np.ndarray] | np.ndarray | torch.Tensor,
    mesh: DistMesh,
    split=None,
    dtype=None,
) -> torch.Tensor:
    """This rank's block of a grid of `global_shape`, on the mesh's device.

    `local_block` is a callable mapping the block's global-index slices to
    its values (the rank materializes only its own block), or a full-size
    array of which only this rank's slices are read.  Every rank calls this
    with the same `global_shape` and `split`."""
    (idx, device), = process_local_slices(global_shape, mesh, split)
    block = local_block(idx) if callable(local_block) else local_block[idx]
    out = torch.as_tensor(np.asarray(block) if not isinstance(block, torch.Tensor) else block)
    if tuple(out.shape) != tuple(s.stop - s.start for s in idx):
        raise ValueError(f"block of shape {tuple(out.shape)} for the slices {idx}")
    return out.to(device=device, dtype=dtype).contiguous()


def make_global_faces(cell_shape: Sequence[int], faces, mesh: DistMesh, dtype=None) -> tuple[torch.Tensor, ...]:
    """This rank's blocks of a MAC face field over a cell grid of
    `cell_shape` (three face arrays, each full-size or a callable as in
    `make_global_grid`), each cut by `mesh.face_split`: the cells' split,
    its own n+1 axis whole."""
    return tuple(
        make_global_grid(face_shape(cell_shape, a), f, mesh, face_split(mesh.shape, cell_shape, a), dtype)
        for a, f in enumerate(faces)
    )


def distribute_grid(arr, mesh: DistMesh, min_per_device: int = 8) -> torch.Tensor:
    """This rank's block of a full grid (`parallel.sharding.shard_grid` for
    a full array given to every rank): 3-D grids are split by `grid_split`'s
    rule, anything else is copied whole."""
    arr = torch.as_tensor(arr)
    if arr.dim() != 3:
        return arr.to(mesh.device)
    return make_global_grid(arr.shape, arr, mesh, grid_split(mesh, arr.shape, min_per_device))


def distribute_problem(problem, mesh: DistMesh, config=None):
    """This rank's share of a whole `mgpcg.PoissonProblem` handed to every
    rank (built by either package): moved to the mesh's device, the levels
    the solve runs sharded cut to the rank's blocks
    (`parallel.sharding.shard_problem`).  `mgpcg.build_problem(mesh=)`
    builds the blocks directly instead."""
    from geometricmultigridpressuresolver_tpu_torch.parallel import sharding

    return sharding.shard_problem(problem, mesh, config)


def host_local_dofs(solvable: torch.Tensor, mesh: DistMesh, global_shape: Sequence[int]) -> int:
    """This rank's share of the DOF count of the grid of `global_shape`
    whose block is `solvable`; summed over the ranks it is the global count.
    A block equal to the whole grid is replicated; where blocks repeat
    along mesh axes the grid does not split, the lowest rank owns the
    region (JAX's owner election, `DistMesh.owns`)."""
    split = (False,) * 3 if tuple(solvable.shape) == tuple(global_shape) else grid_split(mesh, global_shape)
    return int(solvable.sum()) if mesh.owns(split) else 0


class Ranks(NamedTuple):
    """How a rank's partial reductions over one grid become totals: over
    `mesh`, this rank contributing only when it `owned` its block."""

    mesh: DistMesh
    owned: bool

    def sum(self, value: torch.Tensor) -> torch.Tensor:
        return ordered_sum(self.mesh, value, self.owned)

    def max(self, value: torch.Tensor) -> torch.Tensor:
        return ordered_max(self.mesh, value, self.owned)

    def broadcast(self, flag: bool) -> bool:
        return broadcast_flag(self.mesh, flag)


def device_sync(device: torch.device) -> None:
    """Wait for the kernels queued on `device`, so a host timer started or
    stopped after it holds only the work between."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _check_transport(mesh: DistMesh, t: torch.Tensor) -> None:
    if mesh.backend == "nccl" and not t.is_cuda:
        raise ValueError(f"the NCCL backend moves CUDA tensors, got one on {t.device}")


def _staged(mesh: DistMesh, t: torch.Tensor) -> torch.Tensor:
    """The tensor the collective sees: `t` itself, or under gloo a CUDA
    tensor's copy in pinned host memory (the explicit staging)."""
    _check_transport(mesh, t)
    if mesh.backend != "gloo" or not t.is_cuda:
        return t
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t)
    mesh.stats.bytes_staged += t.numel() * t.element_size()
    return host


def _unstaged(mesh: DistMesh, wire: torch.Tensor, device: torch.device) -> torch.Tensor:
    """`wire` back on `device` (a copy from the pinned buffer under gloo)."""
    if wire.device == device:
        return wire
    mesh.stats.bytes_staged += wire.numel() * wire.element_size()
    return wire.to(device)


def _as_bytes(t: torch.Tensor) -> torch.Tensor:
    """A contiguous tensor's storage as a flat uint8 view (the collectives
    move bytes, so every dtype travels alike)."""
    return t.reshape(-1).view(torch.uint8)


def _all_gather(mesh: DistMesh, t: torch.Tensor) -> list[torch.Tensor]:
    """Every rank's `t` (same shape and dtype everywhere), in rank order, on
    `t`'s device: under gloo each part is copied back from host memory, so
    whatever is computed from them runs where `t` lives on either backend.
    The timer starts after a device sync, so it holds the collective and
    its staging, not the kernels queued before it."""
    device_sync(t.device)
    t0 = time.perf_counter()
    wire = _staged(mesh, t.contiguous())
    parts = [torch.empty_like(wire) for _ in range(mesh.size)]
    dist.all_gather([_as_bytes(p) for p in parts], _as_bytes(wire), group=mesh.group)
    parts = [_unstaged(mesh, p, t.device) for p in parts]
    device_sync(t.device)
    mesh.stats.collectives += 1
    mesh.stats.collective_s += time.perf_counter() - t0
    return parts


def ordered_sum(mesh: DistMesh, value: torch.Tensor, owned: bool = True) -> torch.Tensor:
    """The elementwise sum over the ranks of a partial (a 0-d dot, or any
    tensor of one shape on every rank), added in rank order in the
    partial's dtype, the same bits on every rank; a rank that does not own
    its block contributes zero."""
    parts = _all_gather(mesh, value if owned else torch.zeros_like(value))
    acc = parts[0]
    for p in parts[1:]:
        acc = acc + p
    return acc


def ordered_max(mesh: DistMesh, value: torch.Tensor, owned: bool = True) -> torch.Tensor:
    """The elementwise largest of the ranks' values (an owned block's;
    others give the dtype's lowest), the same on every rank."""
    low = float("-inf") if value.is_floating_point() else torch.iinfo(value.dtype).min
    parts = _all_gather(mesh, value if owned else torch.full_like(value, low))
    acc = parts[0]
    for p in parts[1:]:
        acc = torch.maximum(acc, p)
    return acc


def gather_blocks(block: torch.Tensor, mesh: DistMesh, global_shape: Sequence[int], split) -> torch.Tensor:
    """The whole grid of `global_shape` on every rank, from each rank's
    `block` of it (split on the axes `split`; ranks holding equal blocks
    send equal values)."""
    global_shape = tuple(int(n) for n in global_shape)
    if not any(split):
        return block
    parts = _all_gather(mesh, block)
    full = parts[0].new_zeros(global_shape)
    for r, part in enumerate(parts):
        full[local_slices(mesh.shape, global_shape, r, split)] = part
    return full


def broadcast_flag(mesh: DistMesh, flag: bool) -> bool:
    """Rank 0's `flag` on every rank (the others' argument is ignored)."""
    device_sync(mesh.device)
    t0 = time.perf_counter()
    dev = mesh.device if mesh.backend == "nccl" else torch.device("cpu")
    t = torch.tensor([int(bool(flag))], dtype=torch.int32, device=dev)
    dist.broadcast(t, src=0, group=mesh.group)
    mesh.stats.collectives += 1
    mesh.stats.collective_s += time.perf_counter() - t0
    return bool(t.item())


def exchange(mesh: DistMesh, sends, recvs) -> list[torch.Tensor]:
    """One batch of point-to-point messages: `sends` are (tensor, peer,
    tag), `recvs` (shape-and-dtype template, peer, tag).  Returns the
    received tensors on the templates' device.  Every send meets exactly
    one receive of the same tag on its peer."""
    ops, wires = [], []
    for t, peer, tag in sends:
        ops.append(dist.P2POp(dist.isend, _as_bytes(_staged(mesh, t.contiguous())), peer, mesh.group, tag))
    for like, peer, tag in recvs:
        _check_transport(mesh, like)
        on_host = mesh.backend == "gloo" and like.is_cuda
        wire = torch.empty(like.shape, dtype=like.dtype, pin_memory=on_host,
                           device="cpu" if on_host else like.device)
        wires.append(wire)
        ops.append(dist.P2POp(dist.irecv, _as_bytes(wire), peer, mesh.group, tag))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return [_unstaged(mesh, w, like.device) for w, (like, _, _) in zip(wires, recvs)]


class Layout(NamedTuple):
    """How a grid of global `shape` lies across the ranks: rank r's tensor
    holds the box `held[r]`, and sends from the box `owned[r]` (None:
    nothing); the owned boxes tile the grid once, so every cell has one
    sender."""

    shape: tuple[int, ...]
    held: tuple[Box, ...]
    owned: tuple[Box | None, ...]


def block_layout(mesh: DistMesh, shape: Sequence[int], split) -> Layout:
    """The blocks of a grid split on `split` (`make_global_grid`'s), ranks
    with equal blocks electing the lowest as the sender (`DistMesh.owns`)."""
    shape = tuple(int(n) for n in shape)
    held = tuple(block_box(mesh.shape, shape, r, split) for r in range(mesh.size))
    return Layout(shape, held, tuple(b if owner(mesh.shape, r, split) else None for r, b in enumerate(held)))


def faces_layout(mesh: DistMesh, cell_shape: Sequence[int], split, axis: int) -> Layout:
    """The faces along `axis` of each rank's block of a cell grid split on
    `split` (a block's upper face plane is also its neighbour's lower one:
    the lower block sends it, the last block its grid's last plane too)."""
    cells = block_layout(mesh, cell_shape, split)
    n = cells.shape[axis]
    shape = tuple(s + (a == axis) for a, s in enumerate(cells.shape))

    def own(box):
        lo, hi = box[axis]
        return tuple((lo, hi + (hi == n)) if a == axis else b for a, b in enumerate(box))

    return Layout(shape, tuple(face_box(b, axis) for b in cells.held),
                  tuple(None if b is None else own(b) for b in cells.owned))


class Move(NamedTuple):
    """One piece of a `redistribute`: the cells `box` (global indices) go
    from rank `src` to rank `dst`; `local` when `dst` already holds them."""

    src: int
    dst: int
    box: Box
    local: bool


def redistribute_plan(layout: Layout, dest: Sequence[Box]) -> list[Move]:
    """Every (owned box, destination box) intersection, in (dst, src) order.
    Each cell of a destination box inside the grid comes from exactly one
    move; cells outside the grid from none (they keep the fill).  Pure, so
    every rank derives the same plan."""
    moves = []
    for d, dbox in enumerate(dest):
        for s, obox in enumerate(layout.owned):
            piece = None if obox is None else intersect(dbox, obox)
            if piece is not None:
                moves.append(Move(s, d, piece, s == d or contains(layout.held[d], piece)))
    return moves


def redistribute(mesh: DistMesh, t: torch.Tensor, layout: Layout, dest: Sequence[Box], fill=0) -> torch.Tensor:
    """This rank's destination box `dest[mesh.rank]` of the grid whose
    `layout.held[mesh.rank]` box `t` holds: cells outside the grid are
    `fill`, the rest copied from this rank's own tensor where it holds them
    and received from their sender otherwise.  Every rank calls this
    together with the same layout and destinations."""
    rank = mesh.rank
    if tuple(t.shape) != box_shape(layout.held[rank]):
        raise ValueError(f"a tensor of {tuple(t.shape)} for the box {layout.held[rank]}")
    device_sync(t.device)
    t0 = time.perf_counter()
    out = t.new_full(box_shape(dest[rank]), fill)
    sends, recvs, places = [], [], []
    for mv in redistribute_plan(layout, dest):
        if mv.dst == rank and mv.local:
            out[box_slices(mv.box, dest[rank])] = t[box_slices(mv.box, layout.held[rank])]
        elif mv.dst == rank:
            recvs.append((t.new_empty(()).expand(box_shape(mv.box)), mv.src, 0))
            places.append(mv.box)
        elif mv.src == rank and not mv.local:
            sends.append((t[box_slices(mv.box, layout.held[rank])], mv.dst, 0))
    for box, part in zip(places, exchange(mesh, sends, recvs)):
        out[box_slices(box, dest[rank])] = part
    device_sync(t.device)
    mesh.stats.redistributes += 1
    mesh.stats.redistribute_s += time.perf_counter() - t0
    return out
