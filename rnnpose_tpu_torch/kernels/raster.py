"""The raster z-buffer sweeps: five operators, each the port of a Pallas TPU
kernel of `rnnpose_tpu/ops/pallas_raster.py`, with their launchers and
plain versions.

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
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from .build import CSRC, check_device, check_launch, entry, sm_count

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

ROWS_ATTRS_SOURCE = CSRC / "raster_rows_attrs.cu"
TILED_SOURCE = CSRC / "raster_tiled.cu"
TILED_ATTRS_SOURCE = CSRC / "raster_tiled_attrs.cu"
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ATTRS_ARGS = (_P,) * 6 + (_I,) * 6 + (_F, _P)


def pixels_per_thread(tile: int) -> int:
    """ceil(tile^2 / 256), the pixels per thread of a tile x tile CTA: the
    culled wrappers' tile check. The kernels' grid does not depend on the
    tile, so any positive int is taken; anything else raises ValueError."""
    if not isinstance(tile, int) or tile < 1:
        raise ValueError(f"tile={tile!r} must be a positive int")
    return -(-tile * tile // THREADS)


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


def _aligned16(t):
    """t contiguous at a 16-byte aligned address (the kernels read float4
    and copy 16-byte pieces)."""
    t = t.contiguous()
    return t.clone() if t.data_ptr() % 16 else t


def _split(B: int, h: int, w: int, device) -> int:
    """CTAs per 32 x 32 block (a cluster): the least power of two up to 8
    that gives every SM of the card a CTA (B=1 at 240^2, 64 blocks, gets 4
    on a 132-SM H100; B=8 gets 1). The cluster shares the block's faces, so
    a crowded block does not hold the whole launch."""
    blocks = B * -(-h // BLOCK) * -(-w // BLOCK)
    sms = sm_count(device.index if device.index is not None else torch.cuda.current_device())
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
    the plain version.
    """
    _check_attrs_inputs(face_data, bbox, corner_attrs, h, w, chunk, tile)
    check_device(face_data)
    return torch.ops.rnnpose.zbuffer_sweep_rows_attrs(
        face_data, bbox, corner_attrs, h, w, chunk, tile)


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
    `zbuffer_sweep_rows_attrs_plain`."""
    _check_attrs_inputs(face_data, bbox, corner_attrs, h, w, chunk, tile)
    check_device(face_data)
    return torch.ops.rnnpose.zbuffer_sweep_tiled_attrs_batched(
        face_data, bbox, corner_attrs, h, w, chunk, tile)


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
    `zbuffer_sweep_tiled_attrs_plain`."""
    fd, bb, ca = _one_mesh(face_data, bbox, corner_attrs)
    _check_attrs_inputs(fd, bb, ca, h, w, chunk, tile)
    check_device(fd)
    return torch.ops.rnnpose.zbuffer_sweep_tiled_attrs(
        face_data, bbox, corner_attrs, h, w, chunk, tile)


def _launch_attrs(source, name, face_data, bbox, corner_attrs, h, w):
    """One launch of an attribute sweep (the entry point `name` of `source`)."""
    fn = entry(source, name, _ATTRS_ARGS)
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
    check_launch(err, "raster")
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
            err = entry(TILED_SOURCE, "rnnpose_raster_brute", (_P,) * 4 + (_I,) * 6 + (_F, _P))(
                face_data.data_ptr(), reach.data_ptr(), z.data_ptr(), fid.data_ptr(), B, F, h,
                w, chunk, split, MIN_DEPTH, stream)
        else:
            err = entry(TILED_SOURCE, "rnnpose_raster_tiled", (_P,) * 4 + (_I,) * 5 + (_F, _P))(
                face_data.data_ptr(), _aligned16(bbox).data_ptr(), z.data_ptr(),
                fid.data_ptr(), B, F, h, w, split, MIN_DEPTH, stream)
    check_launch(err, "raster")
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
        err = entry(TILED_SOURCE, "rnnpose_raster_reach", (_P,) * 2 + (_I,) * 4 + (_P,))(
            face_data.data_ptr(), reach.data_ptr(), B, F, h, w,
            torch.cuda.current_stream(dev).cuda_stream)
    check_launch(err, "raster")
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
    `zbuffer_sweep_tiled_plain`.
    """
    if bbox is None:
        raise ValueError("the culled sweep needs bbox")
    _check_faces(face_data, bbox, h, w, chunk)
    pixels_per_thread(tile)
    check_device(face_data)
    return torch.ops.rnnpose.zbuffer_sweep_tiled(face_data, bbox, h, w, chunk, tile)


def zbuffer_sweep(
    face_data: torch.Tensor, h: int, w: int, chunk: int = 128,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The brute-force z-buffer contract: that of `zbuffer_sweep_tiled`
    from face_data alone, without bboxes; operator
    `torch.ops.rnnpose.zbuffer_sweep`. A CUDA tensor launches the kernel
    (the reach pass, then the culled sweep on the boxes it derived; the
    result is the brute-force sweep's, bit for bit) and raises if it
    cannot; a CPU tensor runs the plain brute-force sweep,
    `zbuffer_sweep_tiled_plain(face_data, None, ...)`."""
    _check_faces(face_data, None, h, w, chunk)
    check_device(face_data)
    return torch.ops.rnnpose.zbuffer_sweep(face_data, h, w, chunk)


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


# The operators' CUDA implementations (each launches its kernel on the current
# stream; 16-byte alignment and the cluster split are decided at run time)
# and fake implementations (outputs of the right shapes and types).
def rows_attrs_cuda(face_data, bbox, corner_attrs, h, w, chunk, tile):
    return _launch_attrs(ROWS_ATTRS_SOURCE, "rnnpose_raster_rows_attrs", face_data, bbox,
                         corner_attrs, h, w)


def tiled_attrs_batched_cuda(face_data, bbox, corner_attrs, h, w, chunk, tile):
    return _launch_attrs(TILED_ATTRS_SOURCE, "rnnpose_raster_tiled_attrs", face_data, bbox,
                         corner_attrs, h, w)


def tiled_attrs_cuda(face_data, bbox, corner_attrs, h, w, chunk, tile):
    z, fid, attrs = tiled_attrs_batched_cuda(face_data[None], bbox[None], corner_attrs[None],
                                             h, w, chunk, tile)
    return z[0], fid[0], attrs[0]


def tiled_cuda(face_data, bbox, h, w, chunk, tile):
    return _launch_tiled(face_data, bbox, h, w, chunk)


def brute_cuda(face_data, h, w, chunk):
    return _launch_tiled(face_data, None, h, w, chunk)


def brute_cpu(face_data, h, w, chunk):
    return zbuffer_sweep_tiled_plain(face_data, None, h, w, chunk)


def fake_z_fid(face_data, h, w):
    shape = tuple(face_data.shape[:-2]) + (h, w)
    return face_data.new_empty(shape), face_data.new_empty(shape, dtype=torch.int32)


def fake_attrs(face_data, bbox, corner_attrs, h, w, chunk, tile):
    z, fid = fake_z_fid(face_data, h, w)
    return z, fid, corner_attrs.new_empty(tuple(z.shape) + (corner_attrs.shape[-1],))
