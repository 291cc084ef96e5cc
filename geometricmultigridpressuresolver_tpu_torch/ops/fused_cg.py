"""Fused CG step and residual: CUDA kernels (csrc/cg.cu) and plain versions.

`search_matvec_dot` replaces ops/pallas_cg.py::fused_search_matvec_dot of
the JAX package: p' = z + beta*p, Ap' = diag*p' - S(p') and <p', Ap'> in one
pass.  `residual` replaces ops/pallas_cg.py::fused_residual:
r = b - (diag*x - S(x)).  Both kernels are bound by device memory (about
32 and 22 bytes per cell, see csrc/cg.cu); they read each input once, keep
p' in registers for the stencil instead of storing and re-reading it, and
reduce the dot in a fixed order without float atomics.

Each wrapper runs the kernel for a CUDA tensor and its plain version
(`*_torch`) for a CPU tensor under ``mode="auto"``; ``mode="torch"`` always
runs the plain version, ``mode="cuda"`` raises on a CPU tensor.  There is no
fallback from a failed kernel to the plain version.
"""

from __future__ import annotations

import torch

from geometricmultigridpressuresolver_tpu_torch.ops import _cuda
from geometricmultigridpressuresolver_tpu_torch.ops.stencil import neighbor_sum_ew

STEP_LAUNCHES = _cuda.LaunchCounter("cg_step")
RESIDUAL_LAUNCHES = _cuda.LaunchCounter("residual")


def sum_partials(partials: torch.Tensor) -> torch.Tensor:
    """Fixed-order sum of per-block dot partials into a 0-d tensor (a helper
    launch of the kernel that wrote the partials; not counted separately)."""
    out = torch.empty((), dtype=partials.dtype, device=partials.device)
    lib = _cuda.library()
    _cuda.check(
        lib.gmg_sum_partials(
            _cuda.dtype_code(partials, "sum_partials"),
            _cuda.ptr(partials),
            partials.numel(),
            _cuda.ptr(out),
            _cuda.stream_of(partials),
        ),
        "gmg_sum_partials",
    )
    return out


def num_partials(shape) -> int:
    n = int(shape[0]) * int(shape[1]) * int(shape[2])
    bs = _cuda.block_size()
    return max(1, (n + bs - 1) // bs)


def search_matvec_dot_torch(z, p, beta, diag, ew0, ew1, ew2):
    """Plain version: (p', A p', <p', A p'>)."""
    pn = z + beta * p
    ap = diag * pn - neighbor_sum_ew(pn, ew0, ew1, ew2)
    return pn, ap, torch.sum(pn * ap)


def search_matvec_dot(z, p, beta, diag, ew0, ew1, ew2, mode: str = "auto"):
    """Returns (p', A p', <p', A p'>) with p' = z + beta*p.

    `beta` is a 0-d tensor on z's device (the kernel reads it by pointer, so
    the CG loop launches the step without a host read).  Fields share one
    float dtype; the edge weights may be narrower.
    """
    if not _cuda.use_kernel(mode, z):
        return search_matvec_dot_torch(z, p, beta, diag, ew0, ew1, ew2)
    what = "search_matvec_dot"
    beta = torch.as_tensor(beta, dtype=z.dtype, device=z.device).reshape(())
    _cuda.check_cuda_operands(what, z.shape, z=z, p=p, diag=diag, ew0=ew0, ew1=ew1, ew2=ew2)
    _cuda.check_cuda_operands(what, (), beta=beta)
    _cuda.check_dtypes(what, z, p, diag, beta, ews=(ew0, ew1, ew2))
    p_out = torch.empty_like(z)
    ap_out = torch.empty_like(z)
    partials = torch.empty(num_partials(z.shape), dtype=z.dtype, device=z.device)
    nx, ny, nz = z.shape
    lib = _cuda.library()
    _cuda.check(
        lib.gmg_cg_step(
            _cuda.dtype_code(z, what), _cuda.dtype_code(ew0, what),
            _cuda.ptr(z), _cuda.ptr(p), _cuda.ptr(beta), _cuda.ptr(diag),
            _cuda.ptr(ew0), _cuda.ptr(ew1), _cuda.ptr(ew2),
            _cuda.ptr(p_out), _cuda.ptr(ap_out), _cuda.ptr(partials),
            nx, ny, nz, _cuda.stream_of(z),
        ),
        "gmg_cg_step",
    )
    STEP_LAUNCHES.count += 1
    return p_out, ap_out, sum_partials(partials)


def residual_torch(x, b, diag, ew0, ew1, ew2):
    """Plain version: r = b - (diag*x - S(x))."""
    return b - (diag * x - neighbor_sum_ew(x, ew0, ew1, ew2))


def residual(x, b, diag, ew0, ew1, ew2, mode: str = "auto"):
    """r = b - A x.  Zero on non-solvable cells when x and b are (zero diag
    and edge weights there)."""
    if not _cuda.use_kernel(mode, x):
        return residual_torch(x, b, diag, ew0, ew1, ew2)
    what = "residual"
    _cuda.check_cuda_operands(what, x.shape, x=x, b=b, diag=diag, ew0=ew0, ew1=ew1, ew2=ew2)
    _cuda.check_dtypes(what, x, b, diag, ews=(ew0, ew1, ew2))
    r = torch.empty_like(x)
    nx, ny, nz = x.shape
    lib = _cuda.library()
    _cuda.check(
        lib.gmg_residual(
            _cuda.dtype_code(x, what), _cuda.dtype_code(ew0, what),
            _cuda.ptr(x), _cuda.ptr(b), _cuda.ptr(diag),
            _cuda.ptr(ew0), _cuda.ptr(ew1), _cuda.ptr(ew2), _cuda.ptr(r),
            nx, ny, nz, _cuda.stream_of(x),
        ),
        "gmg_residual",
    )
    RESIDUAL_LAUNCHES.count += 1
    return r
