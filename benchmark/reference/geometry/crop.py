"""Object-centric zoom-crop parameters (port of `rnnpose_tpu/geometry/crop.py`).

A crop is (cx, cy, half_x, half_y): the centre and half-sides of the source
window, mapped onto an out_size x out_size target with the reference's
conventions (pixel-corner (S-1) intrinsics, align_corners=False sampling).
"""
from __future__ import annotations

import torch

from . import projective as proj
from .precise import fma, recip

__all__ = ["mask_bbox", "square_crop_params", "reference_crop_params", "mask_zoom_crop_params",
           "crop_intrinsics", "crop_source_coords"]

_BIG = 1e9


def mask_bbox(mask: torch.Tensor) -> torch.Tensor:
    """(B, 4) [x0, y0, x1, y1] (inclusive) of the nonzero pixels of each
    (B, H, W) mask; the full image box where a mask is empty."""
    h, w = mask.shape[-2], mask.shape[-1]
    m = mask > 0
    grid = proj.coords_grid(h, w, device=mask.device)
    gx, gy = grid[..., 0], grid[..., 1]
    big = torch.tensor(_BIG, dtype=grid.dtype, device=mask.device)
    x0 = torch.where(m, gx, big).amin(dim=(-2, -1))
    y0 = torch.where(m, gy, big).amin(dim=(-2, -1))
    x1 = torch.where(m, gx, -big).amax(dim=(-2, -1))
    y1 = torch.where(m, gy, -big).amax(dim=(-2, -1))
    empty = ~m.any(dim=-1).any(dim=-1)
    x0 = torch.where(empty, torch.zeros_like(x0), x0)
    y0 = torch.where(empty, torch.zeros_like(y0), y0)
    x1 = torch.where(empty, torch.full_like(x1, w - 1), x1)
    y1 = torch.where(empty, torch.full_like(y1, h - 1), y1)
    return torch.stack([x0, y0, x1, y1], dim=-1)


def square_crop_params(bbox: torch.Tensor, margin: float = 0.4) -> torch.Tensor:
    """Square window (B, 4) [cx, cy, half, half] around a bbox's centre,
    the longer side grown by `margin`, the half-side at least 1 (the model
    path uses `reference_crop_params`)."""
    cx = (bbox[..., 0] + bbox[..., 2]) * 0.5
    cy = (bbox[..., 1] + bbox[..., 3]) * 0.5
    half = torch.maximum(bbox[..., 2] - bbox[..., 0], bbox[..., 3] - bbox[..., 1])
    half = torch.clamp(half * 0.5 * (1.0 + margin), min=1.0)
    return torch.stack([cx, cy, half, half], dim=-1)


def mask_zoom_crop_params(mask: torch.Tensor, margin: float = 0.4) -> torch.Tensor:
    """mask (B, H, W) -> (B, 4) [cx, cy, half_x, half_y]."""
    return square_crop_params(mask_bbox(mask), margin)


def reference_crop_params(
    center: torch.Tensor, bbox: torch.Tensor, margin: float = 0.4,
    ratio: float = 1.0,
) -> torch.Tensor:
    """Zoom-crop window: center (B, 2), integer mask bbox (B, 4) -> (B, 4)."""
    left = center[..., 0] - bbox[..., 0]
    right = bbox[..., 2] - center[..., 0]
    up = center[..., 1] - bbox[..., 1]
    down = bbox[..., 3] - center[..., 1]
    crop_height = (
        torch.maximum(torch.maximum(ratio * right, ratio * left),
                      torch.maximum(up, down))
        * 2.0 * (1.0 + margin)
    )
    half_y = torch.clamp(crop_height * 0.5, min=1.0)
    half_x = half_y / ratio
    return torch.stack([center[..., 0], center[..., 1], half_x, half_y], dim=-1)


def crop_intrinsics(
    intrinsics: torch.Tensor, crop_params: torch.Tensor, out_size: int
) -> torch.Tensor:
    """Intrinsics (B, 4) of the virtual zoomed camera (pixel-corner S-1 map).
    The scale divides once, as jnp does (`precise`)."""
    span = torch.full_like(crop_params[..., 2:4], out_size - 1)
    sx, sy = (span / (2.0 * crop_params[..., 2:4])).unbind(-1)
    fx = intrinsics[..., 0] * sx
    fy = intrinsics[..., 1] * sy
    cx = (intrinsics[..., 2] - (crop_params[..., 0] - crop_params[..., 2])) * sx
    cy = (intrinsics[..., 3] - (crop_params[..., 1] - crop_params[..., 3])) * sy
    return torch.stack([fx, fy, cx, cy], dim=-1)


def crop_source_coords(crop_params: torch.Tensor, out_size: int) -> torch.Tensor:
    """Source (x, y) pixel coords (B, S, S, 2) of every crop pixel
    (`grid_sample` align_corners=False: u = (c - half - 0.5) + (i + 0.5) *
    2*half/S), rounded as XLA rounds the JAX package's form (`precise`)."""
    grid = proj.coords_grid(out_size, out_size, device=crop_params.device)
    s = (2.0 * crop_params[..., 2:4]) * recip(out_size)
    origin = crop_params[..., :2] - crop_params[..., 2:4]
    return fma(grid[None] + 0.5, s[:, None, None, :], origin[:, None, None, :]) - 0.5
