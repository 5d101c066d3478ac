"""Projective camera ops with analytic Jacobians (port of
`rnnpose_tpu/geometry/projective.py`).

Channel-last layouts, intrinsics as (..., 4) vectors [fx, fy, cx, cy].
`coords_grid`, `backproject`, `project`, `transform_points` and
`local_perturb_jacobian` are those of `kernels/geometry`, the port's one
copy of the geometry its LM step kernel's plain version is made of.
"""
from __future__ import annotations

import torch

from ..kernels.geometry import (  # noqa: F401  (the port's one copy)
    PROJ_MIN_DEPTH as MIN_DEPTH, backproject, coords_grid, local_perturb_jacobian, project,
    transform_points)
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
