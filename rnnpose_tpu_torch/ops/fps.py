"""Furthest point sampling (port of `rnnpose_tpu/ops/fps.py`; reference
`utils/furthest_point_sample.py:6-54`).

Fragments mesh vertices into patches when a renderer is built
(`render/fragments.py`): once per mesh, a loop over the sample count with
a running minimum distance.
"""
from __future__ import annotations

import torch

__all__ = ["furthest_point_sample"]


def furthest_point_sample(points: torch.Tensor, num_samples: int) -> torch.Tensor:
    """`num_samples` indices of `points` (N, 3) by iterative furthest-point
    sampling, int32, index 0 first. Each next index is the first point of
    the largest distance to the chosen set (`torch.argmax` returns the first
    maximum, as `jnp.argmax` does)."""
    n = points.shape[0]
    min_d2 = torch.full((n,), float("inf"), dtype=points.dtype, device=points.device)
    idxs = torch.zeros(num_samples, dtype=torch.int32, device=points.device)
    for i in range(1, num_samples):
        d2 = ((points - points[idxs[i - 1]]) ** 2).sum(-1)
        min_d2 = torch.minimum(min_d2, d2)
        idxs[i] = torch.argmax(min_d2)
    return idxs
