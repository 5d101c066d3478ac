"""The raster z-buffer sweep: the Hopper CUDA kernel and its plain version.

`zbuffer_sweep_rows_attrs` is the port of the Pallas TPU kernel
`rnnpose_tpu/ops/pallas_raster.py::zbuffer_sweep_rows_attrs_batched`: a
tile-culled z-buffer sweep that also interpolates the winning face's corner
attributes. A CUDA tensor goes to the hand-written kernel in
`rnnpose_tpu_torch/csrc/raster_rows_attrs.cu` (see the note at its top for
what bounds it on the H100 and how the design deals with that); a CPU tensor
goes to `zbuffer_sweep_rows_attrs_plain`, the chunked dense sweep of
`rnnpose_tpu/render/raster.py::_rasterize_single` plus a winner gather, with
the same contract and the same rounding.

The shared library is built with `nvcc` on first use into
`rnnpose_tpu_torch/_build/` (plain C interface, loaded with ctypes); nothing
is built or imported at module import time.
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
from typing import Tuple

import torch

__all__ = [
    "FAR",
    "zbuffer_sweep_rows_attrs",
    "zbuffer_sweep_rows_attrs_plain",
    "build_raster_kernel",
]

FAR = 1e9
TILE = 16         # pixel tile of the cull, 16 x 16
MIN_DEPTH = 0.01  # a covered pixel's depth must exceed it

_PKG = Path(__file__).resolve().parent.parent
_SOURCE = _PKG / "csrc" / "raster_rows_attrs.cu"
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
    raise RuntimeError("nvcc not found: the CUDA raster kernel cannot be built")


def build_raster_kernel(verbose: bool = False) -> Path:
    """Compile the kernel library if it is not built yet; return its path.

    The file name carries a hash of the source and flags, so an edited
    source is rebuilt. `verbose` adds `-Xptxas -v` and prints nvcc's report
    (registers, shared memory, spills).
    """
    src = _SOURCE.read_bytes()
    key = hashlib.sha256(src + " ".join(_NVCC_FLAGS).encode()).hexdigest()[:16]
    lib_path = _BUILD_DIR / f"libraster_rows_attrs_{key}.so"
    if lib_path.exists():
        return lib_path
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *_NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
           "-o", tmp, str(_SOURCE)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stdout}\n{res.stderr}")
    if verbose:
        print(res.stdout + res.stderr, flush=True)
    os.replace(tmp, lib_path)
    return lib_path


@functools.lru_cache(maxsize=1)
def _library() -> ctypes.CDLL:
    """The kernel library, built on first use and loaded once."""
    lib = ctypes.CDLL(str(build_raster_kernel()))
    fn = lib.rnnpose_raster_rows_attrs
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [
        ctypes.c_float, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return lib


def _check_inputs(face_data, bbox, corner_attrs, h, w, chunk):
    if face_data.dim() != 3 or face_data.shape[-1] != 16:
        raise ValueError(f"face_data must be (B, F, 16), got {tuple(face_data.shape)}")
    B, F = face_data.shape[:2]
    if tuple(bbox.shape) != (B, F, 4):
        raise ValueError(f"bbox must be ({B}, {F}, 4), got {tuple(bbox.shape)}")
    if corner_attrs.dim() != 4 or tuple(corner_attrs.shape[:3]) != (B, F, 3):
        raise ValueError(
            f"corner_attrs must be ({B}, {F}, 3, D), got {tuple(corner_attrs.shape)}"
        )
    for name, t in (("face_data", face_data), ("bbox", bbox),
                    ("corner_attrs", corner_attrs)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != face_data.device:
            raise ValueError(f"{name} is on {t.device}, face_data on {face_data.device}")
    if F % chunk or h % TILE or w % TILE:
        raise ValueError(
            f"F={F} must be a multiple of chunk={chunk}, h={h} and w={w} of {TILE}"
        )


def zbuffer_sweep_rows_attrs(
    face_data: torch.Tensor,
    bbox: torch.Tensor,
    corner_attrs: torch.Tensor,
    h: int,
    w: int,
    chunk: int = 128,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Tile-culled z-buffer + winner attribute interpolation.

    Args:
      face_data: (B, F, 16) f32 rows [9 edge coefs | 3 depth coefs | valid |
        pad x3] (see `render/raster.prepare_face_data`).
      bbox: (B, F, 4) f32 screen bboxes, empty for invalid faces.
      corner_attrs: (B, F, 3, D) f32 per-corner attributes.
    Returns:
      z (B, h, w) f32 (FAR where empty), fid (B, h, w) int32 (-1 where
      empty), attrs (B, h, w, D) f32 (0 where empty).

    A CUDA tensor launches the kernel (and raises if it cannot); a CPU tensor
    runs the plain version. `zbuffer_sweep_rows_attrs.launches` counts kernel
    launches.
    """
    _check_inputs(face_data, bbox, corner_attrs, h, w, chunk)
    if face_data.device.type == "cpu":
        return zbuffer_sweep_rows_attrs_plain(face_data, bbox, corner_attrs, h, w, chunk)
    if face_data.device.type != "cuda":
        raise ValueError(f"unsupported device {face_data.device}")
    lib = _library()
    face_data = face_data.contiguous()
    bbox = bbox.contiguous()
    if bbox.data_ptr() % 16:  # the kernel reads bbox rows as float4
        bbox = bbox.clone()
    corner_attrs = corner_attrs.contiguous()
    B, F = face_data.shape[:2]
    D = corner_attrs.shape[-1]
    dev = face_data.device
    z = torch.empty((B, h, w), dtype=torch.float32, device=dev)
    fid = torch.empty((B, h, w), dtype=torch.int32, device=dev)
    attrs = torch.empty((B, h, w, D), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.rnnpose_raster_rows_attrs(
            face_data.data_ptr(), bbox.data_ptr(), corner_attrs.data_ptr(),
            z.data_ptr(), fid.data_ptr(), attrs.data_ptr(),
            B, F, h, w, D, chunk, MIN_DEPTH, stream,
        )
    if err != 0:
        raise RuntimeError(f"raster kernel launch failed: cudaError {err}")
    zbuffer_sweep_rows_attrs.launches += 1
    return z, fid, attrs


zbuffer_sweep_rows_attrs.launches = 0


def zbuffer_sweep_rows_attrs_plain(
    face_data: torch.Tensor,
    bbox: torch.Tensor,
    corner_attrs: torch.Tensor,
    h: int,
    w: int,
    chunk: int = 128,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The kernel's contract in plain PyTorch, on any device.

    The dense chunked sweep of the JAX scan rasterizer (no culling: a face
    that covers a pixel centre always overlaps that pixel's tile, so culling
    changes no result) with first-minimum inside a chunk and strict `<`
    across ascending chunks, then the winner's edge coefficients and corner
    attributes gathered by index. Every value is computed as separate
    elementwise multiplies and adds in the kernel's order, so the two agree
    bit for bit.
    """
    _check_inputs(face_data, bbox, corner_attrs, h, w, chunk)
    B, F = face_data.shape[:2]
    D = corner_attrs.shape[-1]
    dev = face_data.device
    ys = torch.arange(h, dtype=torch.float32, device=dev) + 0.5
    xs = torch.arange(w, dtype=torch.float32, device=dev) + 0.5
    y = ys[:, None].expand(h, w).reshape(1, -1, 1)              # (1, P, 1)
    x = xs[None, :].expand(h, w).reshape(1, -1, 1)

    best_z = torch.full((B, h * w), FAR, dtype=torch.float32, device=dev)
    best_f = torch.full((B, h * w), -1, dtype=torch.int64, device=dev)
    for base in range(0, F, chunk):
        fd = face_data[:, None, base:base + chunk, :]          # (B, 1, C, 16)

        def affine(k):  # (B, P, C): x * a + y * b + c, rows k..k+2
            return x * fd[..., k] + y * fd[..., k + 1] + fd[..., k + 2]

        e0, e1, e2, depth = affine(0), affine(3), affine(6), affine(9)
        ok = (
            (e0 >= 0.0) & (e1 >= 0.0) & (e2 >= 0.0)
            & (depth > MIN_DEPTH) & (fd[..., 12] > 0.0)
        )
        zcand = torch.where(ok, depth, torch.full_like(depth, FAR))
        local_z, local_a = torch.min(zcand, dim=-1)            # first minimum
        take = local_z < best_z
        best_z = torch.where(take, local_z, best_z)
        best_f = torch.where(take, local_a + base, best_f)
    best_f = torch.where(best_z < FAR, best_f, torch.full_like(best_f, -1))

    hit = best_f >= 0
    safe = torch.where(hit, best_f, torch.zeros_like(best_f))  # (B, P)
    fd = torch.gather(face_data, 1, safe[..., None].expand(B, h * w, 16))
    xw, yw = x[..., 0], y[..., 0]
    w0 = xw * fd[..., 0] + yw * fd[..., 1] + fd[..., 2]
    w1 = xw * fd[..., 3] + yw * fd[..., 4] + fd[..., 5]
    w2 = xw * fd[..., 6] + yw * fd[..., 7] + fd[..., 8]
    ca = torch.gather(
        corner_attrs.reshape(B, F, 3 * D), 1,
        safe[..., None].expand(B, h * w, 3 * D),
    ).reshape(B, h * w, 3, D)
    attrs = (
        w0[..., None] * ca[:, :, 0] + w1[..., None] * ca[:, :, 1]
        + w2[..., None] * ca[:, :, 2]
    )
    attrs = torch.where(hit[..., None], attrs, torch.zeros_like(attrs))
    return (
        best_z.reshape(B, h, w),
        best_f.to(torch.int32).reshape(B, h, w),
        attrs.reshape(B, h, w, D),
    )
