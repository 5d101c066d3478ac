"""6-DoF pose metrics in torch (port of `rnnpose_tpu/eval/metrics.py`).

* `add_error` / `adds_error`: the mean model-point distance; the symmetric
  variant matches each GT-posed point to its nearest predicted-posed point
  (`ops/knn.pairwise_sqdist` and a min);
* `projection_2d_error`: the mean reprojection distance in pixels;
* `translation_error` / `rotation_error_deg`: the 5cm5deg ingredients.

Every function takes (R, t) batches and padded model points with an
optional validity mask and returns per-sample values; thresholds and
accumulation are `eval/evaluator.py`'s. Exact f32 on the card.
"""
from __future__ import annotations

import torch

from ..geometry.precise import peinsum
from ..ops.knn import pairwise_sqdist

__all__ = [
    "transform_pts",
    "add_error",
    "adds_error",
    "projection_2d_error",
    "translation_error",
    "rotation_error_deg",
]


def transform_pts(R: torch.Tensor, t: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """(B, 3, 3), (B, 3), (B, N, 3) -> (B, N, 3)."""
    return peinsum("bij,bnj->bni", R, pts) + t[:, None, :]


def _mean(d: torch.Tensor, valid) -> torch.Tensor:
    if valid is None:
        return torch.mean(d, dim=-1)
    m = valid.to(d.dtype)
    return torch.sum(d * m, dim=-1) / torch.clamp(torch.sum(m, dim=-1), min=1.0)


def add_error(R_pred, t_pred, R_gt, t_gt, pts, valid=None) -> torch.Tensor:
    """ADD: the mean distance of corresponding posed points."""
    d = torch.linalg.vector_norm(
        transform_pts(R_pred, t_pred, pts) - transform_pts(R_gt, t_gt, pts), dim=-1)
    return _mean(d, valid)


def adds_error(R_pred, t_pred, R_gt, t_gt, pts, valid=None) -> torch.Tensor:
    """ADD-S for symmetric objects: for each GT-posed point the distance to
    its nearest predicted-posed point, averaged over the GT points (the
    reference's matching direction)."""
    a = transform_pts(R_pred, t_pred, pts)
    b = transform_pts(R_gt, t_gt, pts)
    d2 = pairwise_sqdist(a, b)  # (B, N_pred, N_gt)
    if valid is not None:
        d2 = torch.where(valid[:, :, None] > 0, d2, torch.full_like(d2, 1e12))
    return _mean(torch.sqrt(torch.amin(d2, dim=-2)), valid)


def projection_2d_error(R_pred, t_pred, R_gt, t_gt, pts, K, valid=None) -> torch.Tensor:
    """The mean 2D reprojection distance in pixels. K: (B, 3, 3) or (B, 4)
    [fx, fy, cx, cy]."""
    if K.dim() == 2 and K.shape[-1] == 4:
        fx, fy, cx, cy = K[:, 0], K[:, 1], K[:, 2], K[:, 3]
    else:
        fx, fy, cx, cy = K[:, 0, 0], K[:, 1, 1], K[:, 0, 2], K[:, 1, 2]

    def project(p):
        z = torch.clamp(p[..., 2], min=1e-6)
        return torch.stack([fx[:, None] * p[..., 0] / z + cx[:, None],
                            fy[:, None] * p[..., 1] / z + cy[:, None]], dim=-1)

    d = torch.linalg.vector_norm(
        project(transform_pts(R_pred, t_pred, pts)) - project(transform_pts(R_gt, t_gt, pts)),
        dim=-1)
    return _mean(d, valid)


def translation_error(t_pred, t_gt) -> torch.Tensor:
    """Euclidean translation error (B,)."""
    return torch.linalg.vector_norm(t_pred - t_gt, dim=-1)


def rotation_error_deg(R_pred, R_gt) -> torch.Tensor:
    """Geodesic rotation error in degrees from the trace."""
    trace = peinsum("bij,bij->b", R_pred, R_gt)
    return torch.rad2deg(torch.arccos(torch.clamp((trace - 1.0) / 2.0, -1.0, 1.0)))
