"""Kernel-point dispositions of the KPConv layers (port of
`rnnpose_tpu/ops/kernel_points.py`).

Numpy at model-build time, cached in-process, no file assets: points repel
each other (inverse-square) inside a unit ball, a spring keeps them in it,
and the first point is pinned at the centre ('center' mode). The same seed,
steps and arithmetic as the JAX package's module, so both give the same
array bit for bit.
"""
from __future__ import annotations

import functools

import numpy as np

__all__ = ["make_kernel_points"]


@functools.lru_cache(maxsize=32)
def _unit_dispositions(num_points: int, seed: int, fixed: str) -> tuple:
    rs = np.random.RandomState(seed)
    pts = rs.randn(num_points, 3)
    pts /= np.linalg.norm(pts, axis=1, keepdims=True) + 1e-9
    pts *= rs.uniform(0.3, 1.0, (num_points, 1)) ** (1 / 3)
    if fixed == "center":
        pts[0] = 0.0

    lr = 0.01
    for _ in range(2000):
        diff = pts[:, None, :] - pts[None, :, :]
        d2 = np.sum(diff * diff, axis=-1) + 1e-9
        np.fill_diagonal(d2, np.inf)
        # Inverse-square repulsion + spring toward the ball interior.
        force = np.sum(diff / (d2[..., None] * np.sqrt(d2)[..., None]), axis=1)
        r = np.linalg.norm(pts, axis=1, keepdims=True)
        force -= pts * np.maximum(r - 0.7, 0.0) * 50.0 / (r + 1e-9)
        norm = np.linalg.norm(force, axis=1, keepdims=True)
        force = force / np.maximum(norm, 1.0)  # clip step direction
        pts = pts + lr * force
        if fixed == "center":
            pts[0] = 0.0
        r = np.linalg.norm(pts, axis=1, keepdims=True)
        pts = np.where(r > 1.0, pts / np.maximum(r, 1e-9), pts)
    return tuple(map(tuple, pts))


def make_kernel_points(
    num_points: int = 15,
    radius: float = 1.0,
    dimension: int = 3,
    fixed: str = "center",
    seed: int = 42,
) -> np.ndarray:
    """(num_points, 3) f32 kernel dispositions within `radius`, the first at
    the origin for fixed='center'. Deterministic."""
    if dimension != 3:
        raise ValueError("only 3D kernels are supported")
    pts = np.asarray(_unit_dispositions(num_points, seed, fixed), np.float32)
    return (pts * radius).astype(np.float32)
