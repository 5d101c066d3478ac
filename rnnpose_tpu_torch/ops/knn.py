"""Nearest-neighbour ops as one distance matmul and a reduction (port of
`rnnpose_tpu/ops/knn.py`).

The reference ran a brute-force CUDA kernel (one thread per query) for the
symmetric-object ADD-S metric; the JAX package computes the same with a
pairwise-distance einsum and an argmin, outside any Pallas kernel. Here it
is `torch.matmul` in exact f32 (TF32 off on the card): ADD-S is a
millimetre-scale metric.
"""
from __future__ import annotations

import torch

from ..geometry.precise import pmatmul

__all__ = ["pairwise_sqdist", "nearest_neighbor_idx", "nearest_neighbor_dist", "knn"]


def pairwise_sqdist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Squared euclidean distances (..., N, D) x (..., M, D) -> (..., N, M):
    ||a||^2 + ||b||^2 - 2 a.b, clamped at 0."""
    a2 = torch.sum(a * a, dim=-1)[..., :, None]
    b2 = torch.sum(b * b, dim=-1)[..., None, :]
    cross = pmatmul(a, b.transpose(-1, -2))
    return torch.clamp(a2 + b2 - 2.0 * cross, min=0.0)


def nearest_neighbor_idx(queries: torch.Tensor, refs: torch.Tensor) -> torch.Tensor:
    """Index of the nearest ref point for each query (..., N)."""
    return torch.argmin(pairwise_sqdist(queries, refs), dim=-1)


def nearest_neighbor_dist(queries: torch.Tensor, refs: torch.Tensor) -> torch.Tensor:
    """Distance to the nearest ref for each query (..., N)."""
    return torch.sqrt(torch.amin(pairwise_sqdist(queries, refs), dim=-1))


def knn(queries: torch.Tensor, refs: torch.Tensor, k: int):
    """k nearest refs per query, nearest first: (dists (..., N, k), idx
    (..., N, k))."""
    d2, idx = torch.topk(pairwise_sqdist(queries, refs), k, dim=-1, largest=False)
    return torch.sqrt(torch.clamp(d2, min=0.0)), idx
