"""Object-centric zoom-crop parameters (port of `rnnpose_tpu/geometry/crop.py`).

A crop is (cx, cy, half_x, half_y): the centre and half-sides of the source
window, mapped onto an out_size x out_size target with the reference's
conventions (pixel-corner (S-1) intrinsics, align_corners=False sampling).
"""
from __future__ import annotations

import torch

from . import projective as proj

__all__ = ["reference_crop_params", "crop_intrinsics", "crop_source_coords"]


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
    """Intrinsics (B, 4) of the virtual zoomed camera (pixel-corner S-1 map)."""
    sx = (out_size - 1) / (2.0 * crop_params[..., 2])
    sy = (out_size - 1) / (2.0 * crop_params[..., 3])
    fx = intrinsics[..., 0] * sx
    fy = intrinsics[..., 1] * sy
    cx = (intrinsics[..., 2] - (crop_params[..., 0] - crop_params[..., 2])) * sx
    cy = (intrinsics[..., 3] - (crop_params[..., 1] - crop_params[..., 3])) * sy
    return torch.stack([fx, fy, cx, cy], dim=-1)


def crop_source_coords(crop_params: torch.Tensor, out_size: int) -> torch.Tensor:
    """Source (x, y) pixel coords (B, S, S, 2) of every crop pixel
    (`grid_sample` align_corners=False: u = (c - half - 0.5) + (i + 0.5) *
    2*half/S)."""
    grid = proj.coords_grid(out_size, out_size, device=crop_params.device)
    s = (2.0 * crop_params[..., 2:4]) / out_size
    origin = crop_params[..., :2] - crop_params[..., 2:4]
    return (grid[None] + 0.5) * s[:, None, None, :] + origin[:, None, None, :] - 0.5
