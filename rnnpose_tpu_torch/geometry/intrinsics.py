"""Intrinsics utilities (port of `rnnpose_tpu/geometry/intrinsics.py`):
[fx, fy, cx, cy] vectors, their 3x3 matrices, and rescaling with a
strided depth map."""
from __future__ import annotations

from typing import Tuple

import torch

__all__ = [
    "intrinsics_vec_to_matrix",
    "intrinsics_matrix_to_vec",
    "scale_intrinsics",
    "rescale_depth_and_intrinsics",
]


def intrinsics_vec_to_matrix(k: torch.Tensor) -> torch.Tensor:
    """(..., 4) [fx, fy, cx, cy] -> (..., 3, 3) K matrix."""
    fx, fy, cx, cy = k[..., 0], k[..., 1], k[..., 2], k[..., 3]
    zero, one = torch.zeros_like(fx), torch.ones_like(fx)
    return torch.stack([
        torch.stack([fx, zero, cx], dim=-1),
        torch.stack([zero, fy, cy], dim=-1),
        torch.stack([zero, zero, one], dim=-1),
    ], dim=-2)


def intrinsics_matrix_to_vec(K: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) -> (..., 4) [fx, fy, cx, cy]."""
    return torch.stack([K[..., 0, 0], K[..., 1, 1], K[..., 0, 2], K[..., 1, 2]], dim=-1)


def scale_intrinsics(intrinsics: torch.Tensor, sx: float, sy: float) -> torch.Tensor:
    """Rescale [fx, fy, cx, cy] for an image resized by (sx, sy)."""
    return torch.stack([intrinsics[..., 0] * sx, intrinsics[..., 1] * sy,
                        intrinsics[..., 2] * sx, intrinsics[..., 3] * sy], dim=-1)


def rescale_depth_and_intrinsics(
    depth: torch.Tensor, intrinsics: torch.Tensor, scale: float
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Subsample a depth map by the integer stride round(1 / scale) and
    rescale the intrinsics to match. Strided (nearest) sampling keeps the
    exact depth values: 0 marks the background."""
    stride = int(round(1.0 / scale))
    return depth[..., ::stride, ::stride], scale_intrinsics(intrinsics, scale, scale)
