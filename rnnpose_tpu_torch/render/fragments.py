"""Mesh fragmentation into furthest-point-sampled patches (port of
`rnnpose_tpu/render/fragments.py`; reference `fragmentation_fps`,
`utils/furthest_point_sample.py:6-54`, called when its renderer is built).

The vertex set splits into patches around FPS centres; a patch id can be
rendered as one more vertex attribute.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..ops.fps import furthest_point_sample
from ..ops.knn import nearest_neighbor_idx

__all__ = ["fragment_vertices"]


def fragment_vertices(verts: np.ndarray, num_patches: int = 64
                      ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """FPS-fragment vertices (V, 3) into patches: (pat_centers (P, 3) f32,
    pat_center_inds (P,) int32 vertex indices of the centres,
    vert_frag_ids (V,) int32, each vertex's nearest centre)."""
    v = torch.as_tensor(np.asarray(verts, np.float32))
    idx = furthest_point_sample(v, num_patches)
    centers = v[idx.long()]
    frag = nearest_neighbor_idx(v, centers)
    return centers.numpy(), idx.numpy(), frag.numpy().astype(np.int32)
