"""The kernels' build and load: each `csrc/` source is built with `nvcc` on
first use into `rnnpose_tpu_torch/_build/` (plain C interface, loaded with
ctypes), or taken from `PREBUILT` (a bundle's libraries); nothing is built at
import time. `csrc/stamp.cu` (`utils/profiling`) is built here too.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
_BUILD_DIR = _PKG / "_build"
_NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_name(source: Path) -> str:
    """The file name of the kernel library of `source`: it carries a hash of
    the source, the shared headers and the flags, so an edited source is
    rebuilt and a bundle's library can be matched to the sources."""
    source = Path(source)
    digest = hashlib.sha256(source.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(_NVCC_FLAGS).encode())
    return f"lib{source.stem}_{digest.hexdigest()[:16]}.so"


def build_kernel(source: Path, verbose: bool = False) -> Path:
    """Compile the kernel library of `source` (a `csrc/` source) if it is not
    built yet; return its path (`_build/` + `library_name`).

    `verbose` adds `-Xptxas -v` and prints nvcc's report (registers, shared
    memory, spills). Sources build independently, so several may be built
    at once from threads.
    """
    source = Path(source)
    lib_path = _BUILD_DIR / library_name(source)
    if lib_path.exists():
        return lib_path
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *_NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
           "-o", tmp, str(source)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed on {source.name} ({res.returncode}):\n{res.stdout}\n{res.stderr}")
    if verbose:
        print(res.stdout + res.stderr, flush=True)
    os.replace(tmp, lib_path)
    return lib_path


# Source stem -> a prebuilt library to load instead of building the source:
# a serving bundle's (`utils/bundle.load`), for a copy of this package that
# has no sources beside it.
PREBUILT = {}


@functools.lru_cache(maxsize=None)
def _load(source: Path) -> ctypes.CDLL:
    lib = PREBUILT.get(source.stem) or build_kernel(source)
    return ctypes.CDLL(str(lib))


@functools.lru_cache(maxsize=None)
def entry(source: Path, name: str, argtypes: tuple):
    """The C entry point `name` of `source`'s library (built on first use),
    taking `argtypes` and returning the launch's cudaError."""
    fn = getattr(_load(source), name)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


def check_launch(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: cudaError {err}")


def check_device(t: torch.Tensor) -> None:
    """The operators run on CUDA (the kernel) and CPU (the plain version)
    tensors; raises for others."""
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {t.device}")


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count
