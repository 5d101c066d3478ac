"""The port's hand-written Hopper CUDA kernels and their plain versions: the
raster z-buffer sweeps, the LM step and the correlation lookup.

Five raster wrappers, each the port of a Pallas TPU kernel of
`rnnpose_tpu/ops/pallas_raster.py`:

* `zbuffer_sweep_rows_attrs` (`zbuffer_sweep_rows_attrs_batched`): the
  culled sweep that also interpolates the winning face's corner
  attributes; kernel `csrc/raster_rows_attrs.cu`;
* `zbuffer_sweep_tiled_attrs_batched` (`zbuffer_sweep_tiled_attrs_batched`,
  the per-(b, tile) grid of `RNNPOSE_RASTER_GRID=tile`) and
  `zbuffer_sweep_tiled_attrs` (`zbuffer_sweep_tiled_attrs`, one mesh): the
  same contract; kernel `csrc/raster_tiled_attrs.cu`;
* `zbuffer_sweep_tiled` (`zbuffer_sweep_tiled`): the culled sweep, z and
  face id only; kernel `csrc/raster_tiled.cu`;
* `zbuffer_sweep` (`zbuffer_sweep`): the brute-force contract, face_data
  alone with no bbox; kernel `csrc/raster_tiled.cu` (`rnnpose_raster_brute`):
  a reach pass derives from each face's coefficients a box that holds
  every pixel it can cover (`brute_reach_bbox_plain` is that pass in
  PyTorch), then the culled sweep runs on it.

The culled kernels share one device sweep (`csrc/raster_sweep.cuh`; the
note at its top says what bounds it on the H100 and what the design does
about it): each CTA culls every face's bbox against its 32 x 32 pixel block
(`tile_face_overlap` is that predicate in PyTorch), and a cluster of
`_split` CTAs shares a block where the card would otherwise have too few.
The culled wrappers take a pixel `tile` (16 on the main path; any positive
int, as `RNNPOSE_RASTER_TILE` in `render/raster.py` may pick), the TPU
kernels' grid: it is checked (`pixels_per_thread`) and the
attribute sweeps need h and w to be multiples of it, as the TPU kernels do,
but culling changes no result, so the sweep's own block does not depend on
it. A CUDA tensor launches the kernel (and raises if it cannot); a CPU
tensor runs the plain version: `zbuffer_sweep_tiled_plain`, the chunked
dense sweep of `rnnpose_tpu/render/raster.py::_rasterize_single`, and for
the attributes `zbuffer_sweep_rows_attrs_plain`, which adds a winner gather
(the plain version of all three attribute sweeps;
`zbuffer_sweep_tiled_attrs_plain` is its one-mesh form). The plain versions
sweep every face and only check the tile. They have the kernels' contract
and rounding.

`lm_step` (kernel `csrc/lm_step.cu`, plain version `lm_step_plain`) is one
damped Gauss-Newton step of the refiner's LM pose solve
(`geometry/lm.reprojection_optim` calls it where no gradient is needed). It
ports no TPU kernel: the JAX package leaves the step to XLA, and in PyTorch
ops it is a chain of some 357 kernels.

`corr_lookup` (kernel `csrc/corr_lookup.cu`, plain version
`corr_lookup_plain`) is the windowed lookup of the correlation pyramid, all
levels at once (`ops/corr.corr_lookup` calls it where no gradient is
needed). It ports no TPU kernel either: the JAX package leaves the lookup to
XLA, and in PyTorch ops it is a chain of 257 kernels.

Each wrapper is a `torch.library` operator of the `rnnpose` namespace
(`torch.ops.rnnpose.<wrapper name>`), so that `torch.export` and other
tracers see it as one node: its CUDA implementation launches the kernel on
the current stream (and counts the launch on the wrapper, `.launches`), its
CPU implementation is the plain version, and its fake implementation gives
the outputs' shapes and types. The wrappers check their arguments (on
shapes, so the checks also run while tracing) and call the operator on
either device. The operators have no gradient: every caller runs them under
`torch.no_grad()` or on tensors that need none. The first copy of this
module imported in a process registers them (`REGISTERED`); it imports only
torch and the standard library, so a serving bundle carries a byte-for-byte
copy and a process without the package loads it by path (`utils/bundle.py`).

Each source is built with `nvcc` on first use into `rnnpose_tpu_torch/_build/`
(plain C interface, loaded with ctypes), or taken from `PREBUILT` (a
bundle's libraries); nothing is built at module import time.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import struct
import subprocess
import tempfile
from pathlib import Path
from typing import Optional, Tuple, Union

import torch

__all__ = [
    "FAR",
    "KERNEL_SOURCES",
    "RASTER_SOURCES",
    "LM_SOURCE",
    "CORR_SOURCE",
    "zbuffer_sweep_rows_attrs",
    "zbuffer_sweep_rows_attrs_plain",
    "zbuffer_sweep_tiled_attrs_batched",
    "zbuffer_sweep_tiled_attrs",
    "zbuffer_sweep_tiled_attrs_plain",
    "zbuffer_sweep_tiled",
    "zbuffer_sweep",
    "zbuffer_sweep_tiled_plain",
    "brute_reach_bbox_plain",
    "lm_step",
    "lm_step_plain",
    "corr_lookup",
    "corr_lookup_plain",
    "pixels_per_thread",
    "tile_face_overlap",
    "build_raster_kernel",
    "library_name",
    "PREBUILT",
    "OPS_NAMESPACE",
    "OPERATORS",
    "REGISTERED",
]

FAR = 1e9
TILE = 16         # the wrappers' default pixel tile (the TPU kernels' grid)
THREADS = 256     # the divisor of pixels_per_thread: a 16 x 16 tile, a pixel a thread
BLOCK = 32        # the culled sweep's pixel block (kBlock)
DILATE = 1.0      # bbox dilation of the cull, in pixels (kDil)
MIN_DEPTH = 0.01  # a covered pixel's depth must exceed it
# The reach pass's constants (`face_reach` in csrc/raster_tiled.cu): an
# edge's f32 error bound per unit of magnitude and its floor, the
# certificates' slack per unit and its floor, and the magnitude from which
# f32 could overflow (such a face gets the whole raster).
_EPS_REL, _EPS_ABS = 2.0 ** -22, 2.0 ** -100
_SLACK_REL, _SLACK_ABS = 2.0 ** -50, 2.0 ** -40
_WIDE = 2.0 ** 126

_PKG = Path(__file__).resolve().parent.parent
_CSRC = _PKG / "csrc"
ROWS_ATTRS_SOURCE = _CSRC / "raster_rows_attrs.cu"
TILED_SOURCE = _CSRC / "raster_tiled.cu"
TILED_ATTRS_SOURCE = _CSRC / "raster_tiled_attrs.cu"
RASTER_SOURCES = (ROWS_ATTRS_SOURCE, TILED_SOURCE, TILED_ATTRS_SOURCE)
LM_SOURCE = _CSRC / "lm_step.cu"
CORR_SOURCE = _CSRC / "corr_lookup.cu"
KERNEL_SOURCES = RASTER_SOURCES + (LM_SOURCE, CORR_SOURCE)
_BUILD_DIR = _PKG / "_build"
_NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
)
_P, _I, _F, _L, _D = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong,
                      ctypes.c_double)
_ATTRS_ARGS = [_P] * 6 + [_I] * 6 + [_F, _P]
# C entry point -> (source, argtypes); each returns the launch's cudaError.
_ENTRIES = {
    "rnnpose_raster_rows_attrs": (ROWS_ATTRS_SOURCE, _ATTRS_ARGS),
    "rnnpose_raster_tiled_attrs": (TILED_ATTRS_SOURCE, _ATTRS_ARGS),
    "rnnpose_raster_tiled": (TILED_SOURCE, [_P] * 4 + [_I] * 5 + [_F, _P]),
    "rnnpose_raster_brute": (TILED_SOURCE, [_P] * 4 + [_I] * 6 + [_F, _P]),
    "rnnpose_raster_reach": (TILED_SOURCE, [_P] * 2 + [_I] * 4 + [_P]),
    "rnnpose_lm_step": (LM_SOURCE, [_P] * 6 + [_I] * 5 + [_L] * 8 + [_F] + [_D] * 3 + [_P]),
    "rnnpose_corr_lookup": (CORR_SOURCE, [_P] * 3 + [_I] * 2 + [_P] + [_I] * 3 + [_L] * 4
                            + [_I] + [_P] * 2),
}


def pixels_per_thread(tile: int) -> int:
    """ceil(tile^2 / 256), the pixels per thread of a tile x tile CTA: the
    culled wrappers' tile check. The kernels' grid does not depend on the
    tile, so any positive int is taken; anything else raises ValueError."""
    if not isinstance(tile, int) or tile < 1:
        raise ValueError(f"tile={tile!r} must be a positive int")
    return -(-tile * tile // THREADS)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA raster kernels cannot be built")


def library_name(source: Path) -> str:
    """The file name of the kernel library of `source`: it carries a hash of
    the source, the shared headers and the flags, so an edited source is
    rebuilt and a bundle's library can be matched to the sources."""
    source = Path(source)
    digest = hashlib.sha256(source.read_bytes())
    for header in sorted(_CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(_NVCC_FLAGS).encode())
    return f"lib{source.stem}_{digest.hexdigest()[:16]}.so"


def build_raster_kernel(source: Path, verbose: bool = False) -> Path:
    """Compile the kernel library of `source` (one of KERNEL_SOURCES) if it
    is not built yet; return its path (`_build/` + `library_name`).

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
# a serving bundle's (`utils/bundle.load`), for a copy of this module that has
# no sources beside it.
PREBUILT = {}


@functools.lru_cache(maxsize=None)
def _load(source: Path) -> ctypes.CDLL:
    lib = PREBUILT.get(source.stem) or build_raster_kernel(source)
    return ctypes.CDLL(str(lib))


@functools.lru_cache(maxsize=None)
def _entry(name: str):
    """The C entry point `name`, its library built on first use."""
    source, argtypes = _ENTRIES[name]
    fn = getattr(_load(source), name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def _check_faces(face_data, bbox, h, w, chunk):
    if face_data.dim() != 3 or face_data.shape[-1] != 16:
        raise ValueError(f"face_data must be (B, F, 16), got {tuple(face_data.shape)}")
    B, F = face_data.shape[:2]
    if bbox is not None and tuple(bbox.shape) != (B, F, 4):
        raise ValueError(f"bbox must be ({B}, {F}, 4), got {tuple(bbox.shape)}")
    for name, t in (("face_data", face_data), ("bbox", bbox)):
        if t is None:
            continue
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != face_data.device:
            raise ValueError(f"{name} is on {t.device}, face_data on {face_data.device}")
    if F % chunk or h < 1 or w < 1:
        raise ValueError(f"F={F} must be a multiple of chunk={chunk}, h={h} and w={w} >= 1")


def _check_attrs_inputs(face_data, bbox, corner_attrs, h, w, chunk, tile):
    _check_faces(face_data, bbox, h, w, chunk)
    pixels_per_thread(tile)
    B, F = face_data.shape[:2]
    if corner_attrs.dim() != 4 or tuple(corner_attrs.shape[:3]) != (B, F, 3):
        raise ValueError(
            f"corner_attrs must be ({B}, {F}, 3, D), got {tuple(corner_attrs.shape)}"
        )
    if corner_attrs.dtype != torch.float32:
        raise TypeError(f"corner_attrs must be float32, got {corner_attrs.dtype}")
    if corner_attrs.device != face_data.device:
        raise ValueError(
            f"corner_attrs is on {corner_attrs.device}, face_data on {face_data.device}")
    if h % tile or w % tile:
        raise ValueError(f"h={h} and w={w} must be multiples of tile={tile}")


def _check_device(face_data) -> None:
    """The operators run on CUDA (the kernel) and CPU (the plain version)
    tensors; raises for others."""
    if face_data.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {face_data.device}")


def _aligned16(t):
    """t contiguous at a 16-byte aligned address (the kernels read float4
    and copy 16-byte pieces)."""
    t = t.contiguous()
    return t.clone() if t.data_ptr() % 16 else t


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _split(B: int, h: int, w: int, device) -> int:
    """CTAs per 32 x 32 block (a cluster): the least power of two up to 8
    that gives every SM of the card a CTA (B=1 at 240^2, 64 blocks, gets 4
    on a 132-SM H100; B=8 gets 1). The cluster shares the block's faces, so
    a crowded block does not hold the whole launch."""
    blocks = B * -(-h // BLOCK) * -(-w // BLOCK)
    sms = _sm_count(device.index if device.index is not None else torch.cuda.current_device())
    split = 1
    while split < 8 and blocks * split < sms:
        split *= 2
    return split


def zbuffer_sweep_rows_attrs(
    face_data: torch.Tensor,
    bbox: torch.Tensor,
    corner_attrs: torch.Tensor,
    h: int,
    w: int,
    chunk: int = 128,
    tile: int = TILE,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Tile-culled z-buffer + winner attribute interpolation.

    Args:
      face_data: (B, F, 16) f32 rows [9 edge coefs | 3 depth coefs | valid |
        pad x3] (see `render/raster.prepare_face_data`).
      bbox: (B, F, 4) f32 screen bboxes, empty for invalid faces.
      corner_attrs: (B, F, 3, D) f32 per-corner attributes.
      h, w: multiples of `tile`.
    Returns:
      z (B, h, w) f32 (FAR where empty), fid (B, h, w) int32 (-1 where
      empty), attrs (B, h, w, D) f32 (0 where empty).

    Calls the operator `torch.ops.rnnpose.zbuffer_sweep_rows_attrs`: a CUDA
    tensor launches the kernel (and raises if it cannot); a CPU tensor runs
    the plain version. `zbuffer_sweep_rows_attrs.launches` counts kernel
    launches.
    """
    _check_attrs_inputs(face_data, bbox, corner_attrs, h, w, chunk, tile)
    _check_device(face_data)
    return torch.ops.rnnpose.zbuffer_sweep_rows_attrs(
        face_data, bbox, corner_attrs, h, w, chunk, tile)


zbuffer_sweep_rows_attrs.launches = 0


def zbuffer_sweep_tiled_attrs_batched(
    face_data: torch.Tensor,
    bbox: torch.Tensor,
    corner_attrs: torch.Tensor,
    h: int,
    w: int,
    chunk: int = 128,
    tile: int = TILE,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """`zbuffer_sweep_rows_attrs`'s contract on the per-(b, tile) grid that
    the JAX package's `RNNPOSE_RASTER_GRID=tile` selects; kernel
    `csrc/raster_tiled_attrs.cu`, operator
    `torch.ops.rnnpose.zbuffer_sweep_tiled_attrs_batched`. A CPU tensor runs
    `zbuffer_sweep_rows_attrs_plain`.
    `zbuffer_sweep_tiled_attrs_batched.launches` counts kernel launches."""
    _check_attrs_inputs(face_data, bbox, corner_attrs, h, w, chunk, tile)
    _check_device(face_data)
    return torch.ops.rnnpose.zbuffer_sweep_tiled_attrs_batched(
        face_data, bbox, corner_attrs, h, w, chunk, tile)


zbuffer_sweep_tiled_attrs_batched.launches = 0


def _one_mesh(face_data, bbox, corner_attrs):
    """(F, 16), (F, 4), (F, 3, D) -> the batched shapes with B = 1."""
    if face_data.dim() != 2 or bbox.dim() != 2 or corner_attrs.dim() != 3:
        raise ValueError(
            "one mesh: face_data (F, 16), bbox (F, 4), corner_attrs (F, 3, D), got "
            f"{tuple(face_data.shape)}, {tuple(bbox.shape)}, {tuple(corner_attrs.shape)}")
    return face_data[None], bbox[None], corner_attrs[None]


def zbuffer_sweep_tiled_attrs(
    face_data: torch.Tensor,
    bbox: torch.Tensor,
    corner_attrs: torch.Tensor,
    h: int,
    w: int,
    chunk: int = 128,
    tile: int = TILE,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The one-mesh form: face_data (F, 16), bbox (F, 4), corner_attrs
    (F, 3, D) -> z (h, w), fid (h, w), attrs (h, w, D); the kernel of
    `zbuffer_sweep_tiled_attrs_batched` at B = 1, operator
    `torch.ops.rnnpose.zbuffer_sweep_tiled_attrs`. A CPU tensor runs
    `zbuffer_sweep_tiled_attrs_plain`. `zbuffer_sweep_tiled_attrs.launches`
    counts kernel launches."""
    fd, bb, ca = _one_mesh(face_data, bbox, corner_attrs)
    _check_attrs_inputs(fd, bb, ca, h, w, chunk, tile)
    _check_device(fd)
    return torch.ops.rnnpose.zbuffer_sweep_tiled_attrs(
        face_data, bbox, corner_attrs, h, w, chunk, tile)


zbuffer_sweep_tiled_attrs.launches = 0


def _launch_attrs(entry, face_data, bbox, corner_attrs, h, w):
    """One launch of an attribute sweep (`entry` of `_ENTRIES`)."""
    fn = _entry(entry)
    face_data, bbox = _aligned16(face_data), _aligned16(bbox)
    corner_attrs = corner_attrs.contiguous()
    B, F = face_data.shape[:2]
    D = corner_attrs.shape[-1]
    dev = face_data.device
    z = torch.empty((B, h, w), dtype=torch.float32, device=dev)
    fid = torch.empty((B, h, w), dtype=torch.int32, device=dev)
    attrs = torch.empty((B, h, w, D), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(
            face_data.data_ptr(), bbox.data_ptr(), corner_attrs.data_ptr(),
            z.data_ptr(), fid.data_ptr(), attrs.data_ptr(),
            B, F, h, w, D, _split(B, h, w, dev), MIN_DEPTH, stream,
        )
    if err != 0:
        raise RuntimeError(f"raster kernel launch failed: cudaError {err}")
    return z, fid, attrs


def _launch_tiled(face_data, bbox, h, w, chunk):
    """One call of `csrc/raster_tiled.cu`: the culled sweep when `bbox` is
    given, else the brute-force contract (the reach pass into a scratch
    (B, F, 4) allocated here, then the culled sweep on it)."""
    face_data = _aligned16(face_data)
    B, F = face_data.shape[:2]
    dev = face_data.device
    z = torch.empty((B, h, w), dtype=torch.float32, device=dev)
    fid = torch.empty((B, h, w), dtype=torch.int32, device=dev)
    split = _split(B, h, w, dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if bbox is None:
            reach = torch.empty((B, F, 4), dtype=torch.float32, device=dev)
            err = _entry("rnnpose_raster_brute")(
                face_data.data_ptr(), reach.data_ptr(), z.data_ptr(), fid.data_ptr(), B, F, h,
                w, chunk, split, MIN_DEPTH, stream)
        else:
            err = _entry("rnnpose_raster_tiled")(
                face_data.data_ptr(), _aligned16(bbox).data_ptr(), z.data_ptr(),
                fid.data_ptr(), B, F, h, w, split, MIN_DEPTH, stream)
    if err != 0:
        raise RuntimeError(f"raster kernel launch failed: cudaError {err}")
    return z, fid


def _launch_reach(face_data, h, w):
    """The brute-force contract's reach pass alone on the card: face_data
    (B, F, 16) -> (B, F, 4), `brute_reach_bbox_plain`'s result. No package
    path calls it (`zbuffer_sweep` runs it inside its own call);
    `chip_smoke.py` times it and holds it to the plain version."""
    face_data = _aligned16(face_data)
    B, F = face_data.shape[:2]
    dev = face_data.device
    reach = torch.empty((B, F, 4), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = _entry("rnnpose_raster_reach")(
            face_data.data_ptr(), reach.data_ptr(), B, F, h, w,
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"raster kernel launch failed: cudaError {err}")
    return reach


def zbuffer_sweep_tiled(
    face_data: torch.Tensor,
    bbox: torch.Tensor,
    h: int,
    w: int,
    chunk: int = 128,
    tile: int = TILE,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Tile-culled z-buffer sweep: z (B, h, w) f32 (FAR where empty) and fid
    (B, h, w) int32 (-1 where empty) of face_data (B, F, 16) with screen
    bboxes (B, F, 4), any h and w (partial edge tiles are masked).

    Calls the operator `torch.ops.rnnpose.zbuffer_sweep_tiled`: a CUDA
    tensor launches the kernel (and raises if it cannot); a CPU tensor runs
    `zbuffer_sweep_tiled_plain`. `zbuffer_sweep_tiled.launches` counts
    kernel launches.
    """
    if bbox is None:
        raise ValueError("the culled sweep needs bbox")
    _check_faces(face_data, bbox, h, w, chunk)
    pixels_per_thread(tile)
    _check_device(face_data)
    return torch.ops.rnnpose.zbuffer_sweep_tiled(face_data, bbox, h, w, chunk, tile)


zbuffer_sweep_tiled.launches = 0


def zbuffer_sweep(
    face_data: torch.Tensor, h: int, w: int, chunk: int = 128,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The brute-force z-buffer contract: that of `zbuffer_sweep_tiled`
    from face_data alone, without bboxes; operator
    `torch.ops.rnnpose.zbuffer_sweep`. A CUDA tensor launches the kernel
    (the reach pass, then the culled sweep on the boxes it derived; the
    result is the brute-force sweep's, bit for bit) and raises if it
    cannot; a CPU tensor runs the plain brute-force sweep,
    `zbuffer_sweep_tiled_plain(face_data, None, ...)`.
    `zbuffer_sweep.launches` counts calls that launched the kernel."""
    _check_faces(face_data, None, h, w, chunk)
    _check_device(face_data)
    return torch.ops.rnnpose.zbuffer_sweep(face_data, h, w, chunk)


zbuffer_sweep.launches = 0


def _pixel_centres(h, w, device):
    """x and y (1, h*w) f32 of the pixel centres, row-major."""
    ys = torch.arange(h, dtype=torch.float32, device=device) + 0.5
    xs = torch.arange(w, dtype=torch.float32, device=device) + 0.5
    return xs[None, :].expand(h, w).reshape(1, -1), ys[:, None].expand(h, w).reshape(1, -1)


def zbuffer_sweep_tiled_plain(
    face_data: torch.Tensor,
    bbox: Optional[torch.Tensor],
    h: int,
    w: int,
    chunk: int = 128,
    tile: int = TILE,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The sweeps' z/fid contract in plain PyTorch, on any device.

    The dense chunked sweep of the JAX scan rasterizer (no culling: a face
    that covers a pixel centre always overlaps that pixel's tile, so culling
    changes no result, and `bbox` and `tile` are only checked) with
    first-minimum inside a chunk and strict `<` across ascending chunks.
    Every value is computed as separate elementwise multiplies and adds in
    the kernels' order, so the two agree bit for bit.
    """
    _check_faces(face_data, bbox, h, w, chunk)
    pixels_per_thread(tile)
    B, F = face_data.shape[:2]
    dev = face_data.device
    x, y = (c[..., None] for c in _pixel_centres(h, w, dev))   # (1, P, 1)

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
    return best_z.reshape(B, h, w), best_f.to(torch.int32).reshape(B, h, w)


def zbuffer_sweep_rows_attrs_plain(
    face_data: torch.Tensor,
    bbox: torch.Tensor,
    corner_attrs: torch.Tensor,
    h: int,
    w: int,
    chunk: int = 128,
    tile: int = TILE,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The attribute sweeps' contract (`zbuffer_sweep_rows_attrs`,
    `zbuffer_sweep_tiled_attrs_batched`) in plain PyTorch, on any device:
    `zbuffer_sweep_tiled_plain`, then the winner's edge coefficients and
    corner attributes gathered by index, in the kernels' rounding. h and w
    must be multiples of `tile`, as for the kernels."""
    _check_attrs_inputs(face_data, bbox, corner_attrs, h, w, chunk, tile)
    z, fid = zbuffer_sweep_tiled_plain(face_data, bbox, h, w, chunk, tile)
    B, F = face_data.shape[:2]
    D = corner_attrs.shape[-1]
    best_f = fid.reshape(B, -1).long()
    xw, yw = _pixel_centres(h, w, face_data.device)             # (1, P)

    hit = best_f >= 0
    safe = torch.where(hit, best_f, torch.zeros_like(best_f))  # (B, P)
    fd = torch.gather(face_data, 1, safe[..., None].expand(B, h * w, 16))
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
    return z, fid, attrs.reshape(B, h, w, D)


def zbuffer_sweep_tiled_attrs_plain(
    face_data: torch.Tensor,
    bbox: torch.Tensor,
    corner_attrs: torch.Tensor,
    h: int,
    w: int,
    chunk: int = 128,
    tile: int = TILE,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """`zbuffer_sweep_rows_attrs_plain` of one mesh: (F, 16), (F, 4),
    (F, 3, D) -> z (h, w), fid (h, w), attrs (h, w, D)."""
    z, fid, attrs = zbuffer_sweep_rows_attrs_plain(
        *_one_mesh(face_data, bbox, corner_attrs), h, w, chunk, tile)
    return z[0], fid[0], attrs[0]


def brute_reach_bbox_plain(face_data: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """The brute-force sweep's reach pass in plain PyTorch, on any device:
    face_data (B, F, 16) f32 -> (B, F, 4) f32 [x0, y0, x1, y1], a box that
    holds every pixel centre of the h x w raster that the sweep's f32 test
    can cover for the face (the argument is at `face_reach` in
    `csrc/raster_tiled.cu`). The same f64 operations in the same order as
    the kernel, so the two agree bit for bit: empty (FAR, FAR, -FAR, -FAR)
    where the face covers nothing (valid <= 0 or NaN, a NaN among its 12
    coefficients, or sides that cross), (-1, -1, w + 1, h + 1) where an
    edge's magnitude reaches 2^126 (or is not finite), otherwise each side
    the tightest of the edge pairs' certificates, clamped to [-1, w + 1] x
    [-1, h + 1] and rounded outward to f32. `zbuffer_sweep` runs the culled
    sweep on it; the tests and `chip_smoke.py` hold the kernel to it."""
    if face_data.dim() != 3 or face_data.shape[-1] != 16 or face_data.dtype != torch.float32:
        raise ValueError(
            f"face_data must be (B, F, 16) float32, got {tuple(face_data.shape)} {face_data.dtype}")
    fd = face_data.double()
    a, b, c = fd[..., 0:9:3], fd[..., 1:9:3], fd[..., 2:9:3]          # (B, F, 3)
    W, H = float(w), float(h)
    t = torch.abs(a) * W + torch.abs(b) * H
    M = t + torch.abs(c)
    cp = c + (M * _EPS_REL + _EPS_ABS)
    m = t + torch.abs(cp)
    inf = torch.full_like(fd[..., 0], float("inf"))
    lo, hi = [-inf, -inf], [inf, inf]                                 # x, y
    for i, j in ((0, 1), (1, 2), (2, 0)):
        ai, bi, ci, mi = a[..., i], b[..., i], cp[..., i], m[..., i]
        aj, bj, cj, mj = a[..., j], b[..., j], cp[..., j], m[..., j]
        det = ai * bj - aj * bi
        paired = det != 0.0
        r = torch.ones_like(det) / torch.where(paired, det, torch.ones_like(det))
        # lambda for +x and for +y: lambda_i n_i + lambda_j n_j = -d.
        for axis, (li, lj) in enumerate((((-bj) * r, bi * r), (aj * r, (-ai) * r))):
            s = li * ci + lj * cj
            slack = ((torch.abs(li) * mi + torch.abs(lj) * mj) + torch.abs(s)) * _SLACK_REL \
                + _SLACK_ABS
            up = paired & (li >= 0.0) & (lj >= 0.0)
            down = paired & (li <= 0.0) & (lj <= 0.0)
            hi[axis] = torch.minimum(hi[axis], torch.where(up, s + slack, inf))
            lo[axis] = torch.maximum(lo[axis], torch.where(down, s - slack, -inf))
    x0, x1 = torch.clamp(lo[0], min=-1.0), torch.clamp(hi[0], max=W + 1.0)
    y0, y1 = torch.clamp(lo[1], min=-1.0), torch.clamp(hi[1], max=H + 1.0)

    def outward(v, up):
        f = v.float()
        if up:
            return torch.where(f.double() < v, torch.nextafter(f, torch.full_like(f, FAR)), f)
        return torch.where(f.double() > v, torch.nextafter(f, torch.full_like(f, -FAR)), f)

    reach = torch.stack([outward(x0, False), outward(y0, False),
                         outward(x1, True), outward(y1, True)], dim=-1)
    whole = torch.tensor([-1.0, -1.0, W + 1.0, H + 1.0], dtype=torch.float32,
                         device=fd.device)
    empty = torch.tensor([FAR, FAR, -FAR, -FAR], dtype=torch.float32, device=fd.device)
    wide = ~(M < _WIDE).all(-1)
    reach = torch.where(wide[..., None], whole, reach)
    blank = (torch.isnan(fd[..., :12]).any(-1) | ~(fd[..., 12] > 0.0)
             | (~wide & ((x0 > x1) | (y0 > y1))))
    return torch.where(blank[..., None], empty, reach)


def tile_face_overlap(bbox: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """The culled kernels' cull predicate in PyTorch, on any device: for each
    32 x 32 pixel block of an h x w raster and each face, the pixels of the
    block whose centres the face's bbox, dilated by DILATE pixels, holds.

    bbox (B, F, 4) f32 -> (B, ceil(h/32), ceil(w/32), F, 4) int32 [first
    column, last column, first row, last row] (raster pixel indices), and
    [0, -1, 0, -1] where the face is culled from the block; computed as
    `face_rect` in `csrc/raster_sweep.cuh` does (empty and NaN boxes compare
    false and stay culled). The kernel lists a face for a block where the
    rectangle is not empty and tests it at the rectangle's pixels only. No
    path of the package calls it: the tests hold the cull to the plain
    sweep with it, and `chip_smoke.py` counts the kernels' work with it.
    """
    if bbox.dim() != 3 or bbox.shape[-1] != 4 or bbox.dtype != torch.float32:
        raise ValueError(f"bbox must be (B, F, 4) float32, got {tuple(bbox.shape)} {bbox.dtype}")
    dev = bbox.device

    def clip(lo, hi, n, shape):
        """First and last pixel of each block in [lo, hi] (dilated bbox
        sides, (B, 1, 1, F)), blocks along an axis of n pixels laid out as
        `shape`; also whether the bbox reaches the block's centres."""
        t0 = torch.arange(0, n, BLOCK, device=dev)
        nb = torch.clamp(n - t0, max=BLOCK)
        f0 = t0.to(torch.float32).reshape(shape)
        last = (t0 + nb - 1).to(torch.float32).reshape(shape) + 0.5
        hit = (lo <= last) & (hi >= f0 + 0.5)
        zero = torch.zeros((), device=dev)
        p0 = torch.clamp(torch.ceil(torch.where(hit, lo - f0 - 0.5, zero)), min=0.0)
        p1 = torch.minimum(torch.floor(torch.where(hit, hi - f0 - 0.5, zero)),
                           (nb - 1).to(torch.float32).reshape(shape))
        t0 = t0.reshape(shape).to(torch.int32)
        return hit, p0.to(torch.int32) + t0, p1.to(torch.int32) + t0

    x0, y0, x1, y1 = (bbox[:, None, None, :, k] for k in range(4))  # (B, 1, 1, F)
    hx, c0, c1 = clip(x0 - DILATE, x1 + DILATE, w, (1, 1, -1, 1))
    hy, r0, r1 = clip(y0 - DILATE, y1 + DILATE, h, (1, -1, 1, 1))
    keep = hx & hy & (c0 <= c1) & (r0 <= r1)
    rect = torch.stack(torch.broadcast_tensors(c0, c1, r0, r1), dim=-1)
    empty = torch.tensor([0, -1, 0, -1], dtype=torch.int32, device=dev)
    return torch.where(keep[..., None], rect, empty)


# The plain geometry the LM step is made of: the JAX package's f32 rounding
# forms, the pinhole camera with its Jacobians, the se(3) exponential, the
# damped normal equations and their solve. This is the port's one copy of
# them: `geometry/precise`, `geometry/projective`, `geometry/se3` and
# `geometry/lm` take them from here, since this module imports nothing of
# the package (a serving bundle carries it alone). Each is differentiable.
Operand = Union[torch.Tensor, float]


def _f32(x: float) -> float:
    return struct.unpack("f", struct.pack("f", x))[0]  # a traced Python number is an f32 constant


def recip(c: float) -> float:
    """f32(1 / c): the constant XLA multiplies by where the JAX code divides
    by `c` (computed in f32, as XLA folds it; the f64 quotient rounded to f32
    is the f32 quotient)."""
    return _f32(1.0 / _f32(c))


def fma(a: Operand, b: Operand, c: Operand) -> torch.Tensor:
    """`a * b + c` with the product unrounded, as XLA's CPU backend contracts
    it: the f32 product is exact in f64, the sum is rounded to f64 and then
    to the tensors' dtype. That double rounding differs from a true fused
    multiply-add only at rare ties; f64 arithmetic gives the same bits on
    the CPU and on the card. One f64 kernel (the f32 operands are widened
    inside it) and the cast back; differentiable; Python numbers are f32
    constants."""
    tensors = [x for x in (a, b, c) if isinstance(x, torch.Tensor)]
    like = tensors[0]
    # c64 carries the most dimensions, so type promotion computes in f64 (a
    # tensor of fewer dimensions would promote like a scalar).
    nd = max(x.dim() for x in tensors)
    if isinstance(c, torch.Tensor):
        c64 = c.double().reshape((1,) * (nd - c.dim()) + tuple(c.shape))
    else:
        c64 = torch.full((1,) * nd, _f32(c), dtype=torch.float64, device=like.device)
    if isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor):
        out = torch.addcmul(c64, a, b)
    elif isinstance(a, torch.Tensor):
        out = torch.add(c64, a, alpha=_f32(b))
    else:
        out = torch.add(c64, b, alpha=_f32(a))
    return out.to(like.dtype)


PROJ_MIN_DEPTH = 0.01  # `project` clamps Z to it and zeroes 1/Z where it engaged


def coords_grid(h: int, w: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """Pixel-coordinate grid (H, W, 2) with channel order (x, y)."""
    ys = torch.arange(h, dtype=dtype, device=device)
    xs = torch.arange(w, dtype=dtype, device=device)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    return torch.stack([gx, gy], dim=-1)


def backproject(depth: torch.Tensor, intrinsics: torch.Tensor) -> torch.Tensor:
    """Depth (..., H, W) + intrinsics (..., 4) -> camera points (..., H, W, 3)."""
    h, w = depth.shape[-2], depth.shape[-1]
    grid = coords_grid(h, w, dtype=depth.dtype, device=depth.device)
    fx = intrinsics[..., 0][..., None, None]
    fy = intrinsics[..., 1][..., None, None]
    cx = intrinsics[..., 2][..., None, None]
    cy = intrinsics[..., 3][..., None, None]
    x = (grid[..., 0] - cx) / fx * depth
    y = (grid[..., 1] - cy) / fy * depth
    return torch.stack([x, y, depth], dim=-1)


def project(
    points: torch.Tensor, intrinsics: torch.Tensor, jacobian: bool = False
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Camera points (..., 3) -> pixel coords (..., 2) [+ d(u,v)/d(X,Y,Z)].

    Z is clamped to PROJ_MIN_DEPTH and the inverse depth zeroed where the
    clamp engaged (the reference's behind-camera guard).
    """
    fx, fy = intrinsics[..., 0], intrinsics[..., 1]
    cx, cy = intrinsics[..., 2], intrinsics[..., 3]
    X, Y, Z = points[..., 0], points[..., 1], points[..., 2]
    valid = Z > PROJ_MIN_DEPTH
    zinv = torch.where(valid, 1.0 / torch.clamp(Z, min=PROJ_MIN_DEPTH),
                       torch.zeros_like(Z))
    u = fx * X * zinv + cx
    v = fy * Y * zinv + cy
    uv = torch.stack([u, v], dim=-1)
    if not jacobian:
        return uv, None
    zero = torch.zeros_like(zinv)
    j_u = torch.stack([fx * zinv, zero, -fx * X * zinv * zinv], dim=-1)
    j_v = torch.stack([zero, fy * zinv, -fy * Y * zinv * zinv], dim=-1)
    return uv, torch.stack([j_u, j_v], dim=-2)


def transform_points(T: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """Apply SE(3): T (..., 4, 4) to point sets (..., N, 3) [same ndim] or
    single points (..., 3) [ndim - 1]."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    if points.dim() == T.dim():
        return points @ R.transpose(-1, -2) + t[..., None, :]
    return (R @ points[..., :, None])[..., 0] + t


def local_perturb_jacobian(points_transformed: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (..., 3, 6) Jacobian [I | -hat(Y)] of exp(xi) Y at xi=0."""
    x, y, z = (points_transformed[..., i] for i in range(3))
    one = torch.ones_like(x)
    zero = torch.zeros_like(x)
    rows = [
        torch.stack([one, zero, zero, zero, z, -y], dim=-1),
        torch.stack([zero, one, zero, -z, zero, x], dim=-1),
        torch.stack([zero, zero, one, y, -x, zero], dim=-1),
    ]
    return torch.stack(rows, dim=-2)


def so3_hat(w: torch.Tensor) -> torch.Tensor:
    """(..., 3) axis-angle vector -> (..., 3, 3) skew-symmetric matrix."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    zero = torch.zeros_like(wx)
    rows = [
        torch.stack([zero, -wz, wy], dim=-1),
        torch.stack([wz, zero, -wx], dim=-1),
        torch.stack([-wy, wx, zero], dim=-1),
    ]
    return torch.stack(rows, dim=-2)


# Switch to the Taylor series below this angle^2 (as the JAX package).
_TAYLOR_THETA2 = 1e-8


def _taylor_switched(theta2, exact_fn, taylor_fn):
    small = theta2 < _TAYLOR_THETA2
    safe = torch.where(small, torch.ones_like(theta2), theta2)
    return torch.where(small, taylor_fn(theta2), exact_fn(safe))


def _series(k0, p1, d1, p2, d2):
    """The Taylor branches' `k0 + p1 / d1 + p2 / d2`, rounded as XLA rounds
    the JAX package's form: each division by a constant a multiply by its
    f32 reciprocal, contracted with the add that follows (`fma`)."""
    return fma(p2, recip(d2), fma(p1, recip(d1), k0))


def _A(theta2):
    """sin(t)/t."""
    return _taylor_switched(
        theta2,
        lambda t2: torch.sin(torch.sqrt(t2)) / torch.sqrt(t2),
        lambda t2: _series(1.0, -t2, 6.0, t2 * t2, 120.0),
    )


def _B(theta2):
    """(1-cos(t))/t^2."""
    return _taylor_switched(
        theta2,
        lambda t2: (1.0 - torch.cos(torch.sqrt(t2))) / t2,
        lambda t2: _series(0.5, -t2, 24.0, t2 * t2, 720.0),
    )


def _C(theta2):
    """(t - sin(t))/t^3."""
    return _taylor_switched(
        theta2,
        lambda t2: (torch.sqrt(t2) - torch.sin(torch.sqrt(t2)))
        / (t2 * torch.sqrt(t2)),
        lambda t2: _series(1.0 / 6.0, -t2, 120.0, t2 * t2, 5040.0),
    )


def _bottom_row(like: torch.Tensor) -> torch.Tensor:
    # Made on the device: a list copied from the host would be a
    # synchronising copy, which a CUDA graph capture refuses.
    row = torch.eye(4, dtype=like.dtype, device=like.device)[3]
    return row.expand(like.shape[:-2] + (1, 4))


def se3_expm(xi: torch.Tensor) -> torch.Tensor:
    """Closed-form exp: se(3) twist (..., 6) [v, w] -> (..., 4, 4).

    R = exp(W);  t = V v with V = I + B*W + C*W^2 (left Jacobian of SO(3)).
    """
    v, w = xi[..., :3], xi[..., 3:]
    theta2 = torch.sum(w * w, dim=-1)[..., None, None]
    W = so3_hat(w)
    W2 = W @ W
    eye = torch.eye(3, dtype=xi.dtype, device=xi.device).expand(W.shape)
    A, B = _A(theta2), _B(theta2)
    R = eye + A * W + B * W2
    V = eye + B * W + _C(theta2) * W2
    t = V @ v[..., :, None]
    top = torch.cat([R, t], dim=-1)
    return torch.cat([top, _bottom_row(top)], dim=-2)


def solve_spd(H: torch.Tensor, b: torch.Tensor, delta_clamp: float = 1.0) -> torch.Tensor:
    """Solve H x = b for SPD H (..., n, n) with Jacobi preconditioning.

    Unrolled Cholesky-Crout, batched over the leading dims (no clamp inside:
    a non-SPD input yields NaN, which the isfinite zeroing catches), then x
    is zeroed where non-finite and clamped to +-delta_clamp.
    """
    d = torch.sqrt(torch.clamp(torch.diagonal(H, dim1=-2, dim2=-1), min=1e-12))
    d_inv = 1.0 / d
    Hs = H * d_inv[..., :, None] * d_inv[..., None, :]
    bs = b * d_inv
    n = H.shape[-1]
    L = [[None] * n for _ in range(n)]
    for j in range(n):
        s = Hs[..., j, j] - sum(L[j][k] ** 2 for k in range(j))
        L[j][j] = torch.sqrt(s)
        for i in range(j + 1, n):
            s = Hs[..., i, j] - sum(L[i][k] * L[j][k] for k in range(j))
            L[i][j] = s / L[j][j]
    yv = []
    for i in range(n):
        yv.append((bs[..., i] - sum(L[i][k] * yv[k] for k in range(i))) / L[i][i])
    xv = [None] * n
    for i in reversed(range(n)):
        xv[i] = (yv[i] - sum(L[k][i] * xv[k] for k in range(i + 1, n))) / L[i][i]
    x = torch.stack(xv, dim=-1) * d_inv
    x = torch.where(torch.isfinite(x), x, torch.zeros_like(x))
    return torch.clamp(x, -delta_clamp, delta_clamp)


def lm_normal_equations(T, target, weight, X0, valid, intrinsics, min_depth: float,
                        lm_lambda: float, ep_lambda: float):
    """The damped normal equations of one LM step, in f64: (H (B, 6, 6),
    b (B, 6)) of the pose T (B, 4, 4) against the target pixel field
    (B, H, W, 2) with per-pixel weights (B, H, W, 2), on the back-projected
    points X0 (B, H, W, 3) where `valid` (B, H, W) and the transformed depth
    exceeds `min_depth`."""
    B = T.shape[0]
    X1 = transform_points(T, X0.reshape(B, -1, 3)).reshape(X0.shape)
    uv, j_proj = project(X1, intrinsics[:, None, None, :], jacobian=True)
    J = j_proj @ local_perturb_jacobian(X1)           # (B, H, W, 2, 6)

    r = target - uv
    v = valid * (X1[..., 2] > min_depth).to(valid.dtype)
    w_all = weight * v[..., None]

    # The normal equations are summed and solved in f64: their sums cancel,
    # and in f32 the solve turns the summation order's rounding into pose
    # differences past 1e-4 between devices (`tools/numerics_check`).
    f64 = torch.float64
    Jf = J.reshape(B, -1, 6).to(f64)
    Jw = Jf * w_all.reshape(B, -1)[..., None].to(f64)
    H = Jw.transpose(1, 2) @ Jf                                     # (B, 6, 6)
    b = (Jw.transpose(1, 2) @ r.reshape(B, -1, 1).to(f64))[..., 0]  # (B, 6)

    eye = torch.eye(6, dtype=H.dtype, device=H.device)
    diag = torch.diagonal(H, dim1=-2, dim2=-1)
    return H + ep_lambda * eye + lm_lambda * diag[..., None] * eye, b


# The LM step (`csrc/lm_step.cu`): one damped Gauss-Newton step of the
# refiner's pose solve, `geometry/lm._lm_step` after `reprojection_optim`'s
# back-projection. It replaces no TPU kernel (the note at the top of the
# source says why it exists, what bounds it and what its design does).
LM_TILE = 128        # pixels a block at least: the 1/8 grid's 30^2 is 8 blocks
LM_MAX_TILES = 16    # blocks an item at most: one cluster, the H100's largest
LM_MAX_ITEMS = 65535  # the kernel's grid holds an item a row


def lm_step(
    T: torch.Tensor,
    target: torch.Tensor,
    weight: torch.Tensor,
    depth: torch.Tensor,
    intrinsics: torch.Tensor,
    lm_lambda: float = 1e-4,
    ep_lambda: float = 100.0,
    delta_clamp: float = 1.0,
    min_depth: float = 0.1,
) -> torch.Tensor:
    """One LM step of T (B, 4, 4) against the target pixel field (B, H, W,
    2) with per-pixel weights (B, H, W, 2), on the points back-projected from
    `depth` (B, H, W) with `intrinsics` (B, 4); all float32; the new T
    (B, 4, 4). The constants are `geometry/lm.LMConfig`'s.

    Calls the operator `torch.ops.rnnpose.lm_step`: a CUDA tensor launches
    the kernel (weight and target are read through their strides, so a
    stride-0 channel is not copied) and raises if it cannot; a CPU tensor
    runs `lm_step_plain`. No gradient: `geometry/lm.reprojection_optim`
    calls it only where none is needed. `lm_step.launches` counts kernel
    launches.
    """
    if T.dim() != 3 or tuple(T.shape[1:]) != (4, 4) or depth.dim() != 3:
        raise ValueError(f"T must be (B, 4, 4) and depth (B, H, W), got {tuple(T.shape)} "
                         f"and {tuple(depth.shape)}")
    B, h, w = depth.shape
    shapes = {"T": (B, 4, 4), "target": (B, h, w, 2), "weight": (B, h, w, 2),
              "intrinsics": (B, 4)}
    for name, t in (("T", T), ("target", target), ("weight", weight), ("depth", depth),
                    ("intrinsics", intrinsics)):
        if name in shapes and tuple(t.shape) != shapes[name]:
            raise ValueError(f"{name} must be {shapes[name]}, got {tuple(t.shape)}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != T.device:
            raise ValueError(f"{name} is on {t.device}, T on {T.device}")
    if h < 1 or w < 1 or not 1 <= B <= LM_MAX_ITEMS:
        raise ValueError(f"depth must be (B, H, W) with pixels and 1 <= B <= {LM_MAX_ITEMS}, "
                         f"got {tuple(depth.shape)}")
    _check_device(T)
    return torch.ops.rnnpose.lm_step(T, target, weight, depth, intrinsics, lm_lambda,
                                     ep_lambda, delta_clamp, min_depth)


lm_step.launches = 0


def _launch_lm_step(T, target, weight, depth, intrinsics, lm_lambda, ep_lambda, delta_clamp,
                    min_depth):
    """One launch of `csrc/lm_step.cu`: the new T (B, 4, 4), allocated here.
    Each item's pixels are split over at most LM_MAX_TILES blocks of at least
    LM_TILE pixels, one cluster."""
    T, depth, intrinsics = T.contiguous(), depth.contiguous(), intrinsics.contiguous()
    B, h, w = depth.shape
    tiles = min(LM_MAX_TILES, -(-h * w // LM_TILE))
    dev = T.device
    out = torch.empty((B, 4, 4), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = _entry("rnnpose_lm_step")(
            T.data_ptr(), target.data_ptr(), weight.data_ptr(), depth.data_ptr(),
            intrinsics.data_ptr(), out.data_ptr(), B, h, w, tiles, -(-h * w // tiles),
            *target.stride(), *weight.stride(), min_depth, lm_lambda, ep_lambda,
            delta_clamp, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"LM step kernel launch failed: cudaError {err}")
    return out


def lm_step_plain(
    T: torch.Tensor,
    target: torch.Tensor,
    weight: torch.Tensor,
    depth: torch.Tensor,
    intrinsics: torch.Tensor,
    lm_lambda: float = 1e-4,
    ep_lambda: float = 100.0,
    delta_clamp: float = 1.0,
    min_depth: float = 0.1,
) -> torch.Tensor:
    """`lm_step`'s contract in plain PyTorch, on any device: the
    back-projection of `reprojection_optim`, then `geometry/lm._lm_step`
    (the normal equations, the solve and the increment above, the
    functions it calls)."""
    X0 = backproject(depth, intrinsics)
    valid = (depth > min_depth).to(depth.dtype)
    H, b = lm_normal_equations(T, target, weight, X0, valid, intrinsics, min_depth, lm_lambda,
                               ep_lambda)
    return se3_expm(solve_spd(H, b, delta_clamp).to(T.dtype)) @ T


# The correlation lookup (`csrc/corr_lookup.cu`): the (2r+1)^2 window of
# every pyramid level around each position, `ops/corr.corr_lookup` without a
# gradient. It replaces no TPU kernel (the note at the top of the source says
# why it exists, what bounds it and what its design does).
CORR_MAX_LEVELS = 8  # the kernel's level table


def corr_lookup(levels, coords: torch.Tensor, radius: int = 4) -> torch.Tensor:
    """The windowed lookup of a correlation pyramid: `levels` (1 to
    CORR_MAX_LEVELS tensors (B, H*W, H_i, W_i), all float32 or all bfloat16),
    coords (B, H, W, 2) float32 at level 0's scale -> (B, H, W,
    L*(2r+1)^2) float32, level-major, dx-major, dy fastest.

    Calls the operator `torch.ops.rnnpose.corr_lookup`: a CUDA tensor
    launches the kernel (coords are read through their strides, so an
    expanded grid is not copied) and raises if it cannot; a CPU tensor runs
    `corr_lookup_plain`, which gives the same bits. No gradient:
    `ops/corr.corr_lookup` calls it only where none is needed.
    `corr_lookup.launches` counts kernel launches.
    """
    levels = list(levels)
    if coords.dim() != 4 or coords.shape[-1] != 2:
        raise ValueError(f"coords must be (B, H, W, 2), got {tuple(coords.shape)}")
    if coords.dtype != torch.float32:
        raise TypeError(f"coords must be float32, got {coords.dtype}")
    B, H, W, _ = coords.shape
    if not 1 <= len(levels) <= CORR_MAX_LEVELS or not isinstance(radius, int) or radius < 0:
        raise ValueError(f"1 to {CORR_MAX_LEVELS} levels and a radius >= 0, got "
                         f"{len(levels)} and {radius!r}")
    if B * H * W < 1:
        raise ValueError(f"coords must hold positions, got {tuple(coords.shape)}")
    for i, level in enumerate(levels):
        if level.dim() != 4 or tuple(level.shape[:2]) != (B, H * W):
            raise ValueError(f"level {i} must be ({B}, {H * W}, h, w), got {tuple(level.shape)}")
        if level.dtype not in (torch.float32, torch.bfloat16) or level.dtype != levels[0].dtype:
            raise TypeError(f"the levels must share one dtype, float32 or bfloat16; level {i} "
                            f"is {level.dtype}, level 0 {levels[0].dtype}")
        if level.device != coords.device:
            raise ValueError(f"level {i} is on {level.device}, coords on {coords.device}")
    _check_device(coords)
    return torch.ops.rnnpose.corr_lookup(levels, coords, radius)


corr_lookup.launches = 0


def _launch_corr_lookup(levels, coords, radius):
    """One launch of `csrc/corr_lookup.cu`: the lookup (B, H, W, L*(2r+1)^2),
    allocated here."""
    levels = [level.contiguous() for level in levels]
    B, H, W, _ = coords.shape
    L, win = len(levels), 2 * radius + 1
    dev = coords.device
    out = torch.empty((B, H, W, L * win * win), dtype=torch.float32, device=dev)
    data = (ctypes.c_void_p * L)(*[level.data_ptr() for level in levels])
    hs = (ctypes.c_int * L)(*[level.shape[2] for level in levels])
    ws = (ctypes.c_int * L)(*[level.shape[3] for level in levels])
    with torch.cuda.device(dev):
        err = _entry("rnnpose_corr_lookup")(
            data, hs, ws, L, int(levels[0].dtype == torch.bfloat16), coords.data_ptr(), B, H,
            W, *coords.stride(), radius, out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"correlation lookup kernel launch failed: cudaError {err}")
    return out


def _taps(center: torch.Tensor, radius: int, size: int):
    """Window positions center + d, d in [-r, r] -> the two bilinear taps
    (lower index, weights, validity) along one axis, each (Q, win)."""
    d = torch.arange(-radius, radius + 1, dtype=center.dtype, device=center.device)
    pos = center[:, None] + d[None, :]
    i0 = torch.floor(pos)
    w1 = pos - i0
    w0 = 1.0 - w1
    i1 = i0 + 1
    v0 = (i0 >= 0) & (i0 <= size - 1)
    v1 = (i1 >= 0) & (i1 <= size - 1)
    # Out-of-range (and non-finite) taps index 0 with weight 0 (or NaN).
    zero = torch.zeros_like(i0)
    return (
        (torch.where(v0, i0, zero).long(), w0 * v0),
        (torch.where(v1, i1, zero).long(), w1 * v1),
    )


def corr_lookup_plain(levels, coords: torch.Tensor, radius: int = 4) -> torch.Tensor:
    """`corr_lookup`'s contract in plain PyTorch, on any device and under
    autograd: the four bilinear taps of every window position gathered
    directly (zero outside the level), in the JAX package's separable order
    (rows first, then columns); a level pooled to zero size reads 0."""
    B, H, W, _ = coords.shape
    Q = B * H * W
    win = 2 * radius + 1
    cx = coords[..., 0].reshape(Q)
    cy = coords[..., 1].reshape(Q)
    outs = []
    for i, corr in enumerate(levels):
        Hl, Wl = corr.shape[-2], corr.shape[-1]
        if Hl == 0 or Wl == 0:  # a level pooled away (a 1/8 grid under 2^i): all taps 0
            outs.append(torch.zeros((B, H, W, win * win), dtype=corr.dtype,
                                    device=corr.device))
            continue
        scale = 1.0 / (2.0 ** i)
        ty = _taps(cy * scale, radius, Hl)                     # over dy
        tx = _taps(cx * scale, radius, Wl)                     # over dx
        vol = corr.reshape(Q, Hl * Wl)
        out = 0.0
        for xi, wx in tx:                                      # (Q, win)
            col = 0.0
            for yi, wy in ty:
                idx = yi[:, None, :] * Wl + xi[:, :, None]     # (Q, dx, dy)
                v = torch.gather(vol, 1, idx.reshape(Q, -1)).reshape(Q, win, win)
                col = col + wy[:, None, :] * v
            out = out + wx[:, :, None] * col
        outs.append(out.reshape(B, H, W, win * win))
    return torch.cat(outs, dim=-1)


# The operators. Each CUDA implementation launches its kernel on the current
# stream through `_launch_attrs` / `_launch_tiled` (16-byte alignment and the
# cluster split decided there, at run time), `_launch_lm_step` or
# `_launch_corr_lookup`, and counts the launch on its wrapper; each CPU
# implementation is the plain version; each fake implementation makes outputs
# of the right shapes and types and nothing else.
OPS_NAMESPACE = "rnnpose"
_ATTRS_SCHEMA = ("(Tensor face_data, Tensor bbox, Tensor corner_attrs, int h, int w, int chunk, "
                 "int tile) -> (Tensor, Tensor, Tensor)")


def _rows_attrs_cuda(face_data, bbox, corner_attrs, h, w, chunk, tile):
    out = _launch_attrs("rnnpose_raster_rows_attrs", face_data, bbox, corner_attrs, h, w)
    zbuffer_sweep_rows_attrs.launches += 1
    return out


def _tiled_attrs_batched_cuda(face_data, bbox, corner_attrs, h, w, chunk, tile):
    out = _launch_attrs("rnnpose_raster_tiled_attrs", face_data, bbox, corner_attrs, h, w)
    zbuffer_sweep_tiled_attrs_batched.launches += 1
    return out


def _tiled_attrs_cuda(face_data, bbox, corner_attrs, h, w, chunk, tile):
    z, fid, attrs = _launch_attrs("rnnpose_raster_tiled_attrs", face_data[None], bbox[None],
                                  corner_attrs[None], h, w)
    zbuffer_sweep_tiled_attrs.launches += 1
    return z[0], fid[0], attrs[0]


def _tiled_cuda(face_data, bbox, h, w, chunk, tile):
    out = _launch_tiled(face_data, bbox, h, w, chunk)
    zbuffer_sweep_tiled.launches += 1
    return out


def _brute_cuda(face_data, h, w, chunk):
    out = _launch_tiled(face_data, None, h, w, chunk)
    zbuffer_sweep.launches += 1
    return out


def _lm_step_cuda(T, target, weight, depth, intrinsics, lm_lambda, ep_lambda, delta_clamp,
                  min_depth):
    out = _launch_lm_step(T, target, weight, depth, intrinsics, lm_lambda, ep_lambda,
                          delta_clamp, min_depth)
    lm_step.launches += 1
    return out


def _corr_lookup_cuda(levels, coords, radius):
    out = _launch_corr_lookup(levels, coords, radius)
    corr_lookup.launches += 1
    return out


def _brute_cpu(face_data, h, w, chunk):
    return zbuffer_sweep_tiled_plain(face_data, None, h, w, chunk)


def _fake_z_fid(face_data, lead, h, w):
    shape = tuple(face_data.shape[:lead]) + (h, w)
    return face_data.new_empty(shape), face_data.new_empty(shape, dtype=torch.int32)


def _fake_attrs(face_data, bbox, corner_attrs, h, w, chunk, tile):
    lead = face_data.dim() - 2   # 1 for (B, F, 16), 0 for one mesh
    z, fid = _fake_z_fid(face_data, lead, h, w)
    return z, fid, corner_attrs.new_empty(tuple(z.shape) + (corner_attrs.shape[-1],))


_OPS = {  # name -> (schema, CPU, CUDA, fake implementation)
    "zbuffer_sweep_rows_attrs": (
        _ATTRS_SCHEMA, zbuffer_sweep_rows_attrs_plain, _rows_attrs_cuda, _fake_attrs),
    "zbuffer_sweep_tiled_attrs_batched": (
        _ATTRS_SCHEMA, zbuffer_sweep_rows_attrs_plain, _tiled_attrs_batched_cuda, _fake_attrs),
    "zbuffer_sweep_tiled_attrs": (
        _ATTRS_SCHEMA, zbuffer_sweep_tiled_attrs_plain, _tiled_attrs_cuda, _fake_attrs),
    "zbuffer_sweep_tiled": (
        "(Tensor face_data, Tensor bbox, int h, int w, int chunk, int tile) -> (Tensor, Tensor)",
        zbuffer_sweep_tiled_plain, _tiled_cuda,
        lambda face_data, bbox, h, w, chunk, tile: _fake_z_fid(face_data, 1, h, w)),
    "zbuffer_sweep": (
        "(Tensor face_data, int h, int w, int chunk) -> (Tensor, Tensor)",
        _brute_cpu, _brute_cuda, lambda face_data, h, w, chunk: _fake_z_fid(face_data, 1, h, w)),
    "lm_step": (
        "(Tensor T, Tensor target, Tensor weight, Tensor depth, Tensor intrinsics, "
        "float lm_lambda, float ep_lambda, float delta_clamp, float min_depth) -> Tensor",
        lm_step_plain, _lm_step_cuda, lambda T, *args: T.new_empty((T.shape[0], 4, 4))),
    "corr_lookup": (
        "(Tensor[] levels, Tensor coords, int radius) -> Tensor",
        corr_lookup_plain, _corr_lookup_cuda,
        lambda levels, coords, radius: coords.new_empty(
            tuple(coords.shape[:3]) + (len(levels) * (2 * radius + 1) ** 2,))),
}


OPERATORS = tuple(_OPS)


def _registered() -> bool:
    return all(hasattr(getattr(torch.ops, OPS_NAMESPACE), name) for name in _OPS)


# The operators' library, made by the copy of this module that registers. A
# `torch.library.Library` and not `torch.library.custom_op`, whose kernels
# import `torch._dynamo` on a process's first call (7.4 s on an H100 host
# with Triton installed, which it imports too).
LIBRARY = None
REGISTERED = not _registered()
if REGISTERED:
    LIBRARY = torch.library.Library(OPS_NAMESPACE, "FRAGMENT")
    for _name, (_schema, _cpu, _cuda, _fake) in _OPS.items():
        LIBRARY.define(_name + _schema)
        LIBRARY.impl(_name, _cpu, "CPU")
        LIBRARY.impl(_name, _cuda, "CUDA")
        torch.library.register_fake(f"{OPS_NAMESPACE}::{_name}", _fake, lib=LIBRARY)
