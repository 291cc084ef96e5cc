"""Build and load the hand-written CUDA kernels (csrc/*.cu).

The kernels have a plain C interface and are bound with ctypes: nvcc
compiles every source in ``csrc/`` into one shared library for ``sm_90a``
the first time a kernel is launched, never at import.  The library lands in
``_build/`` beside this package (listed in ``.gitignore``) under a name that
hashes the sources and flags, so an edited source rebuilds by itself;
deleting ``_build/`` forces a rebuild.

Each C entry point returns ``cudaGetLastError()``; `check` raises on any
nonzero code, so a refused launch is reported where it happened.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-shared",
    "-Xcompiler",
    "-fPIC",
    "-Xptxas",
    "-v",
)

# Field dtype codes of csrc/common.cuh (enum DType).
DTYPE_CODES = {torch.float32: 0, torch.float64: 1, torch.bfloat16: 2}

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "gmg_block_size": ([], _I),
    "gmg_smooth_pass": (
        [_I, _I, _I, _I, ctypes.c_double] + [_P] * 8 + [_I, _I, _I, _P, _P], _I
    ),
    "gmg_cg_step": ([_I, _I] + [_P] * 10 + [_I, _I, _I, _P], _I),
    "gmg_residual": ([_I, _I] + [_P] * 7 + [_I, _I, _I, _P], _I),
    "gmg_sum_partials": ([_I, _P, ctypes.c_longlong, _P, _P], _I),
}


@dataclasses.dataclass
class BuildInfo:
    """What the last build or load did (chip_smoke.py prints it)."""

    path: Path
    seconds: float
    compiled: bool
    log: str


_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
build_info: BuildInfo | None = None


def _nvcc() -> str:
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME); the CUDA kernels are built at "
            "first use from the sources in " + str(CSRC)
        )
    return found


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _library_path() -> Path:
    digest = hashlib.sha256()
    for src in _sources():
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libgmg_kernels_{digest.hexdigest()[:16]}.so"


def _build(target: Path) -> str:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp)]
    cmd += [str(s) for s in sorted(CSRC.glob("*.cu"))]
    proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
    os.replace(tmp, target)  # atomic: a concurrent loader never sees half a file
    target.with_suffix(".log").write_text(log)
    return log


def library() -> ctypes.CDLL:
    """The loaded kernel library, built from ``csrc/`` on first call."""
    global _lib, build_info
    with _lock:
        if _lib is None:
            t0 = time.perf_counter()
            path = _library_path()
            compiled = not path.exists()
            if compiled:
                log = _build(path)
            else:
                log_path = path.with_suffix(".log")
                log = log_path.read_text() if log_path.exists() else ""
            lib = ctypes.CDLL(str(path))
            for name, (argtypes, restype) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = restype
            _lib = lib
            build_info = BuildInfo(path, time.perf_counter() - t0, compiled, log)
        return _lib


def block_size() -> int:
    return int(library().gmg_block_size())


def check(code: int, what: str) -> None:
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code}")


def stream_of(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def ptr(t: torch.Tensor | None) -> ctypes.c_void_p:
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def dtype_code(t: torch.Tensor, what: str) -> int:
    try:
        return DTYPE_CODES[t.dtype]
    except KeyError:
        raise TypeError(f"{what}: unsupported dtype {t.dtype}") from None


def use_kernel(mode: str, t: torch.Tensor) -> bool:
    """True when kernel mode `mode` sends tensor `t` to a CUDA kernel:
    "auto" for CUDA tensors, "cuda" always (raising on a CPU tensor),
    "torch" never."""
    if mode == "torch":
        return False
    if mode == "auto":
        return t.is_cuda
    if mode == "cuda":
        if not t.is_cuda:
            raise ValueError(f"kernel_mode='cuda' needs CUDA tensors, got {t.device}")
        return True
    raise ValueError(f"unknown kernel mode {mode!r}")


def check_dtypes(what: str, field: torch.Tensor, *others: torch.Tensor, ews=()) -> None:
    """Raise unless the fields share one dtype and the three edge-weight
    grids share another."""
    for t in others:
        if t.dtype != field.dtype:
            raise TypeError(f"{what}: mixed field dtypes {field.dtype} and {t.dtype}")
    if ews and any(e.dtype != ews[0].dtype for e in ews):
        raise TypeError(f"{what}: the three edge-weight grids must share a dtype")


@dataclasses.dataclass
class LaunchCounter:
    """Plain count of kernel launches; a wrapper adds one per launch."""

    name: str
    count: int = 0

    def reset(self) -> None:
        self.count = 0


def check_cuda_operands(what: str, shape, **tensors) -> None:
    """Raise unless every operand is a contiguous CUDA tensor of `shape` on
    the current device (the kernels index raw pointers with that shape)."""
    for name, t in tensors.items():
        if t is None:
            continue
        if not t.is_cuda:
            raise ValueError(f"{what}: {name} is on {t.device}, not CUDA")
        if t.device.index != torch.cuda.current_device():
            raise ValueError(
                f"{what}: {name} is on {t.device}, the current device is "
                f"cuda:{torch.cuda.current_device()}"
            )
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{what}: {name} has shape {tuple(t.shape)}, want {tuple(shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} is not contiguous")
