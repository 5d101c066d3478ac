"""Projective camera ops with analytic Jacobians (port of
`rnnpose_tpu/geometry/projective.py`).

Channel-last layouts, intrinsics as (..., 4) vectors [fx, fy, cx, cy].
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from .precise import fma, recip

__all__ = [
    "MIN_DEPTH",
    "coords_grid",
    "normalize_coords",
    "intrinsics_vec_to_matrix",
    "intrinsics_matrix_to_vec",
    "backproject",
    "project",
    "transform_points",
    "local_perturb_jacobian",
]

MIN_DEPTH = 0.01


def coords_grid(h: int, w: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """Pixel-coordinate grid (H, W, 2) with channel order (x, y)."""
    ys = torch.arange(h, dtype=dtype, device=device)
    xs = torch.arange(w, dtype=dtype, device=device)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    return torch.stack([gx, gy], dim=-1)


def normalize_coords(coords: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Pixel coords (..., 2) -> [-1, 1] (the reference's
    `normalize_coords_grid`, the align-corners form), rounded as XLA rounds
    the JAX package's form (`precise`)."""
    x = fma(2.0 * coords[..., 0], recip(w - 1), -1.0)
    y = fma(2.0 * coords[..., 1], recip(h - 1), -1.0)
    return torch.stack([x, y], dim=-1)


def intrinsics_vec_to_matrix(k: torch.Tensor) -> torch.Tensor:
    """(..., 4) [fx, fy, cx, cy] -> (..., 3, 3) K matrix."""
    fx, fy, cx, cy = k.unbind(-1)
    zero, one = torch.zeros_like(fx), torch.ones_like(fx)
    return torch.stack([torch.stack([fx, zero, cx], dim=-1),
                        torch.stack([zero, fy, cy], dim=-1),
                        torch.stack([zero, zero, one], dim=-1)], dim=-2)


def intrinsics_matrix_to_vec(K: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) -> (..., 4) [fx, fy, cx, cy]."""
    return torch.stack([K[..., 0, 0], K[..., 1, 1], K[..., 0, 2], K[..., 1, 2]], dim=-1)


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

    Z is clamped to MIN_DEPTH and the inverse depth zeroed where the clamp
    engaged (the reference's behind-camera guard).
    """
    fx, fy = intrinsics[..., 0], intrinsics[..., 1]
    cx, cy = intrinsics[..., 2], intrinsics[..., 3]
    X, Y, Z = points[..., 0], points[..., 1], points[..., 2]
    valid = Z > MIN_DEPTH
    zinv = torch.where(valid, 1.0 / torch.clamp(Z, min=MIN_DEPTH),
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
