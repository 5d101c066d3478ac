"""The z-buffer sweeps in plain PyTorch: a frozen copy of the plain
versions in `rnnpose_tpu_torch/ops/raster_kernels.py` (the kernels' own
reference), without the kernels. The dense chunked sweep with
first-minimum inside a chunk and strict `<` across ascending chunks; the
attribute sweep gathers the winner's edge coefficients and corner
attributes."""
from __future__ import annotations

from typing import Optional, Tuple

import torch

__all__ = ["FAR", "TILE", "MIN_DEPTH", "zbuffer_sweep_tiled_plain",
           "zbuffer_sweep_rows_attrs_plain"]

FAR = 1e9
TILE = 16         # the sweeps' default pixel tile (only checked by the kernels)
MIN_DEPTH = 0.01  # a covered pixel's depth must exceed it


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
