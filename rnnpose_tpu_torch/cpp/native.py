"""ctypes bindings for the native host ops of `csrc/native_ops.cpp` (grid
subsampling and the fixed-radius neighbour search of the KPConv pyramid).

The source is the port's own copy of `rnnpose_tpu/cpp/native_ops.cpp`
(`tests/test_torch_port_repairs.py` keeps the two byte-identical). The port
builds it with g++ and the JAX package's flags into the git-ignored
`rnnpose_tpu_torch/_build/` on first use, and loads it with ctypes; it
reads and imports nothing of the JAX package. The
file name carries a hash of the source, the flags and the host name:
`-march=native` code is for the host that built it. `available()` gates the
fast path: without a compiler `data/pyramid.py` runs its numpy version, as
the JAX package does.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

__all__ = ["available", "build", "grid_subsample", "radius_neighbors"]

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "native_ops.cpp"
_BUILD_DIR = _PKG / "_build"
_FLAGS = ("-O3", "-march=native", "-std=c++17", "-shared", "-fPIC")
_lock = threading.Lock()
_lib = None
_tried = False


def build_library(source: Path, stem: str) -> Path:
    """Compile `source` into `_build/lib<stem>_<hash>.so` unless it is
    built already; return its path. The compiler writes a temporary file that
    is renamed into place, so a process that loads the library never sees a
    partial one. Raises RuntimeError if the source is missing or g++ fails."""
    if not source.exists():
        raise RuntimeError(f"native source not found: {source}")
    digest = hashlib.sha256(source.read_bytes())
    digest.update(" ".join((*_FLAGS, platform.node())).encode())
    lib_path = _BUILD_DIR / f"lib{stem}_{digest.hexdigest()[:16]}.so"
    if lib_path.exists():
        return lib_path
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
    os.close(fd)
    try:
        res = subprocess.run(["g++", *_FLAGS, str(source), "-o", tmp],
                             capture_output=True, text=True)
    except FileNotFoundError as err:
        os.unlink(tmp)
        raise RuntimeError(f"g++ not found: {source.name} cannot be built") from err
    if res.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"g++ failed on {source.name}:\n{res.stderr}")
    os.replace(tmp, lib_path)
    return lib_path


def build() -> Path:
    """Compile the native ops library if it is not built yet; return its
    path. Raises RuntimeError if the source is missing or g++ fails."""
    return build_library(SOURCE, "native_ops")


def _load():
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        try:
            lib = ctypes.CDLL(str(build()))
        except (RuntimeError, OSError):
            return None
        fp = ctypes.POINTER(ctypes.c_float)
        lib.grid_subsample.restype = ctypes.c_int
        lib.grid_subsample.argtypes = [fp, ctypes.c_int64, ctypes.c_float, fp]
        lib.radius_neighbors.restype = None
        lib.radius_neighbors.argtypes = [
            fp, ctypes.c_int64, fp, ctypes.c_int64, ctypes.c_float,
            ctypes.c_int32, ctypes.POINTER(ctypes.c_int32),
        ]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def grid_subsample(points: np.ndarray, dl: float) -> np.ndarray:
    lib = _load()
    pts = np.ascontiguousarray(points, np.float32)
    out = np.empty_like(pts)
    m = lib.grid_subsample(_fptr(pts), len(pts), ctypes.c_float(dl), _fptr(out))
    return out[:m].copy()


def radius_neighbors(
    queries: np.ndarray, supports: np.ndarray, radius: float, max_neighbors: int
) -> np.ndarray:
    lib = _load()
    q = np.ascontiguousarray(queries, np.float32)
    s = np.ascontiguousarray(supports, np.float32)
    out = np.empty((len(q), max_neighbors), np.int32)
    lib.radius_neighbors(
        _fptr(q), len(q), _fptr(s), len(s), ctypes.c_float(radius),
        ctypes.c_int32(max_neighbors),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    return out
