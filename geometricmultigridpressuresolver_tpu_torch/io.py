"""Field I/O: ctypes bindings to the native tiled-serialization library.

Port of ``geometricmultigridpressuresolver_tpu.io`` over the port's own copy
of its C++ source, `native/gmg_io.cpp` (unchanged, so the two packages
read and write the same files byte for byte).  Fields are stored in tiles
(16^3 by default) and constant tiles (far-field SDF regions, exterior
padding, still velocity) collapse to one stored value.

The library is compiled with g++ on first use into ``_build/`` beside this
package (listed in ``.gitignore``) under a name that hashes the source, so
an edited source rebuilds by itself.  The build goes through a temporary
file and `os.replace`, so processes that build at once never load half a
file.  A failed build raises; there is no pure-Python path.

API (numpy in and out; a tensor is accepted wherever an array is):
  save_field(path, array)  /  load_field(path) -> np.ndarray
  field_info(path) -> (shape, dtype, tile)
  save_scene(dir, **fields) / load_scene(dir) -> dict
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import os
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / "native" / "gmg_io.cpp"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
CXX_FLAGS = ("-O3", "-shared", "-fPIC")

_DTYPES = {
    np.dtype(np.float32): 0,
    np.dtype(np.float64): 1,
    np.dtype(np.int8): 2,
    np.dtype(np.int32): 3,
}
_DTYPE_NAMES = {v: k for k, v in _DTYPES.items()}

_ERRORS = {
    -1: "cannot open file",
    -2: "write failed",
    -3: "bad dtype/tile/shape",
    -4: "bad magic or version",
    -5: "shape/dtype mismatch",
    -6: "truncated file",
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def library_path() -> Path:
    """Where the library of the current source and flags is built."""
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libgmg_io_{digest.hexdigest()[:16]}.so"


def _build(target: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.NamedTemporaryFile(suffix=".so", dir=BUILD_DIR, delete=False) as tmp:
        tmp_path = tmp.name
    try:
        subprocess.run(
            ["g++", *CXX_FLAGS, "-o", tmp_path, str(SOURCE)],
            check=True, capture_output=True, text=True,
        )
        os.replace(tmp_path, target)
    except subprocess.CalledProcessError as e:
        os.unlink(tmp_path)
        raise RuntimeError(f"building gmg_io failed:\n{e.stderr}") from e


def _library() -> ctypes.CDLL:
    """Load (building if needed) the native library."""
    global _lib
    with _lock:
        if _lib is None:
            so = library_path()
            if not so.exists():
                _build(so)
            lib = ctypes.CDLL(str(so))
            lib.gmg_save.restype = ctypes.c_int64
            lib.gmg_save.argtypes = [
                ctypes.c_char_p, ctypes.c_void_p,
                ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_int32, ctypes.c_int32,
            ]
            lib.gmg_info.restype = ctypes.c_int64
            lib.gmg_info.argtypes = [
                ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64),
                ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ]
            lib.gmg_load.restype = ctypes.c_int64
            lib.gmg_load.argtypes = [
                ctypes.c_char_p, ctypes.c_void_p,
                ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int32,
            ]
            _lib = lib
        return _lib


def _check(rc: int, path) -> None:
    if rc != 0:
        raise IOError(f"gmg_io: {_ERRORS.get(rc, rc)} ({path})")


def _host_array(array) -> np.ndarray:
    if hasattr(array, "detach"):  # a torch tensor, on any device
        array = array.detach().cpu().numpy()
    return np.ascontiguousarray(np.asarray(array))


def save_field(path, array, tile: int = 16) -> None:
    """Write a 3-D field in the tiled constant-compressed format."""
    arr = _host_array(array)
    if arr.ndim != 3:
        raise ValueError(f"expected a 3-D field, got shape {arr.shape}")
    if arr.dtype not in _DTYPES:
        raise ValueError(f"unsupported dtype {arr.dtype}")
    rc = _library().gmg_save(str(path).encode(), arr.ctypes.data, *arr.shape, _DTYPES[arr.dtype], tile)
    _check(rc, path)


def field_info(path) -> tuple[tuple[int, int, int], np.dtype, int]:
    """(shape, dtype, tile) of a stored field."""
    shape = (ctypes.c_int64 * 3)()
    dtype = ctypes.c_int32()
    tile = ctypes.c_int32()
    rc = _library().gmg_info(str(path).encode(), shape, dtype, tile)
    _check(rc, path)
    return tuple(int(s) for s in shape), _DTYPE_NAMES[dtype.value], tile.value


def load_field(path) -> np.ndarray:
    """Read a field written by `save_field`."""
    shape, dtype, _ = field_info(path)
    out = np.empty(shape, dtype=dtype)
    rc = _library().gmg_load(str(path).encode(), out.ctypes.data, *shape, _DTYPES[np.dtype(dtype)])
    _check(rc, path)
    return out


def save_scene(directory, **fields) -> None:
    """Write named fields (one .gmgf each) plus a manifest."""
    d = Path(directory)
    d.mkdir(parents=True, exist_ok=True)
    manifest = {}
    for name, arr in fields.items():
        save_field(d / f"{name}.gmgf", arr)
        manifest[name] = f"{name}.gmgf"
    (d / "manifest.json").write_text(json.dumps(manifest, indent=1))


def load_scene(directory) -> dict:
    """Read every field of a scene directory into numpy arrays."""
    d = Path(directory)
    manifest = json.loads((d / "manifest.json").read_text())
    return {name: load_field(d / rel) for name, rel in manifest.items()}
