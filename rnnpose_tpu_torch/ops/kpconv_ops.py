"""KPConv core ops (port of `rnnpose_tpu/ops/kpconv_ops.py`), batched.

Every function takes a leading batch axis where the JAX package vmaps an
unbatched one. Neighbour lists are dense with a shadow index: an index at or
past the support count marks a missing neighbour. The two contractions of
`kpconv` are plain products (`torch.einsum`, run by cuBLAS on the card), as
the JAX package leaves them to XLA; callers on the card keep TF32 off so
they are exact f32.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

__all__ = [
    "gather_neighbors",
    "kpconv",
    "max_pool",
    "closest_pool",
    "global_average",
]


def _gather(features: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """features (B, M, C) at idx (B, N, K) in [0, M) -> (B, N, K, C)."""
    B, N, K = idx.shape
    C = features.shape[-1]
    flat = idx.reshape(B, N * K, 1).expand(B, N * K, C)
    return torch.gather(features, 1, flat).reshape(B, N, K, C)


def gather_neighbors(features: torch.Tensor, neighb_inds: torch.Tensor) -> torch.Tensor:
    """Neighbour features (B, N, K, C) of support features (B, M, C); shadow
    neighbours (index >= M) are zeros."""
    valid = neighb_inds < features.shape[1]
    idx = torch.where(valid, neighb_inds, torch.zeros_like(neighb_inds))
    return _gather(features, idx) * valid[..., None].to(features.dtype)


def kpconv(
    q_pts: torch.Tensor,
    s_pts: torch.Tensor,
    neighb_inds: torch.Tensor,
    features: torch.Tensor,
    kernel_points: torch.Tensor,
    weights: torch.Tensor,
    kp_extent: float,
    influence: str = "linear",
    aggregation: str = "sum",
) -> torch.Tensor:
    """Rigid kernel-point convolution.

    Args:
      q_pts: (B, N, 3) query points; s_pts: (B, M, 3) support points.
      neighb_inds: (B, N, K) indices into s_pts (shadow = M).
      features: (B, M, C_in) support features.
      kernel_points: (P, 3) dispositions (not differentiated).
      weights: (P, C_in, C_out).
      kp_extent: influence radius of each kernel point.
      influence: 'linear' | 'gaussian' | 'constant'; aggregation: 'sum' |
        'closest'.
    Returns:
      (B, N, C_out), divided by the number of neighbours whose gathered
      feature sum is > 0 (at least 1): the reference's density
      normalisation, which also drops real neighbours with a non-positive
      channel sum.
    """
    kernel_points = kernel_points.detach()
    M = s_pts.shape[1]
    valid = neighb_inds < M                                    # (B, N, K)
    idx = torch.where(valid, neighb_inds, torch.zeros_like(neighb_inds))
    # Shadow neighbours sit at 1e6, so their influence is exactly zero.
    neighbors = _gather(s_pts, idx) - q_pts[:, :, None, :]     # (B, N, K, 3)
    neighbors = torch.where(valid[..., None], neighbors, torch.full_like(neighbors, 1e6))
    diff = neighbors[..., None, :] - kernel_points             # (B, N, K, P, 3)
    sq_dist = torch.sum(diff * diff, dim=-1)                   # (B, N, K, P)

    if influence == "constant":
        all_weights = torch.ones_like(sq_dist)
    elif influence == "linear":
        dist = torch.sqrt(torch.clamp(sq_dist, min=1e-12))
        all_weights = torch.clamp(1.0 - dist / kp_extent, min=0.0)
    elif influence == "gaussian":
        sigma = kp_extent * 0.3
        all_weights = torch.exp(-sq_dist / (2.0 * sigma * sigma))
    else:
        raise ValueError(f"unknown influence mode {influence!r}")

    if aggregation == "closest":
        closest = torch.argmin(sq_dist, dim=-1)                # first minimum
        all_weights = all_weights * F.one_hot(
            closest, kernel_points.shape[0]).to(all_weights.dtype)
    elif aggregation != "sum":
        raise ValueError(f"unknown aggregation mode {aggregation!r}")
    all_weights = all_weights * valid[..., None].to(all_weights.dtype)

    neighb_x = gather_neighbors(features, neighb_inds)         # (B, N, K, C_in)
    weighted = torch.einsum("bnkp,bnkc->bnpc", all_weights, neighb_x)
    out = torch.einsum("bnpc,pcd->bnd", weighted, weights)
    n_valid = torch.clamp(
        torch.sum((torch.sum(neighb_x, dim=-1) > 0.0).to(out.dtype), dim=-1), min=1.0)
    return out / n_valid[..., None]


def max_pool(features: torch.Tensor, pool_inds: torch.Tensor) -> torch.Tensor:
    """Max over the pooled neighbours (B, N, K) of features (B, M, C) ->
    (B, N, C). A shadow neighbour contributes a zero row, as the reference's
    padded shadow row does, so the max is clamped below at 0 wherever a list
    has one."""
    valid = pool_inds < features.shape[1]
    idx = torch.where(valid, pool_inds, torch.zeros_like(pool_inds))
    x = _gather(features, idx)
    x = torch.where(valid[..., None], x, torch.zeros_like(x))
    return torch.amax(x, dim=2)


def closest_pool(features: torch.Tensor, pool_inds: torch.Tensor) -> torch.Tensor:
    """The first (nearest) neighbour's features: (B, M, C), (B, N, K) ->
    (B, N, C); zeros where it is a shadow."""
    first = pool_inds[..., :1]
    valid = first < features.shape[1]
    idx = torch.where(valid, first, torch.zeros_like(first))
    return _gather(features, idx)[:, :, 0] * valid.to(features.dtype)


def global_average(features: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Masked mean over points: (B, N, C) -> (B, C)."""
    if mask is None:
        return torch.mean(features, dim=1)
    w = mask.to(features.dtype)
    return torch.sum(features * w[..., None], dim=1) / torch.clamp(
        torch.sum(w, dim=1, keepdim=True), min=1.0)
