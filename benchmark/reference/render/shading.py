"""Headlight shading of the rendered reference image (port of
`rnnpose_tpu/render/shading.py`)."""
from __future__ import annotations

import numpy as np
import torch

from ..geometry.precise import fma

__all__ = ["compute_vertex_normals", "headlight_shade"]


def compute_vertex_normals(verts: np.ndarray, faces: np.ndarray) -> np.ndarray:
    """Area-weighted per-vertex normals (host, numpy). Degenerate/padded
    faces contribute zero."""
    v0, v1, v2 = verts[faces[:, 0]], verts[faces[:, 1]], verts[faces[:, 2]]
    fn = np.cross(v1 - v0, v2 - v0)
    out = np.zeros_like(verts)
    for k in range(3):
        np.add.at(out, faces[:, k], fn)
    norm = np.linalg.norm(out, axis=-1, keepdims=True)
    return (out / np.maximum(norm, 1e-12)).astype(np.float32)


def headlight_shade(
    colors: torch.Tensor, normals_cam: torch.Tensor,
    ambient: float = 0.4, diffuse: float = 0.6,
) -> torch.Tensor:
    """Shade interpolated colors (..., 3) with a camera-colocated light,
    two-sided, from interpolated camera-frame normals (..., 3). The light
    term rounds as XLA rounds the JAX package's form (`precise.fma`)."""
    n = normals_cam / torch.clamp(
        torch.linalg.vector_norm(normals_cam, dim=-1, keepdim=True), min=1e-6
    )
    return colors * fma(diffuse, torch.abs(n[..., 2:3]), ambient)
