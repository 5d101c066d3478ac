"""Host-side KPConv input pyramid (port of `rnnpose_tpu/data/pyramid.py`).

Numpy preprocessing, as in the JAX package: voxel-grid subsampling, the
fixed-radius distance-ordered neighbour search with the shadow index (the
number of support points) marking missing neighbours, each level padded to
a static size. The native C++ path (`cpp/native.py`) runs when it builds,
the numpy version otherwise; the two may order neighbours at equal distance
differently. The result is a `models.kpconv_net.PointPyramid` of tensors.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..cpp import native
from ..models.kpconv_net import KPConvConfig, PointPyramid

__all__ = [
    "grid_subsample",
    "radius_neighbors",
    "PyramidArrays",
    "build_pyramid_arrays",
    "calibrate_neighbor_limits",
    "pad_and_batch_pyramids",
]


def _cpp():
    """The native ops module, or None if it cannot be built."""
    return native if native.available() else None


def grid_subsample(points: np.ndarray, dl: float) -> np.ndarray:
    """Voxel-grid barycentres of (N, 3) f32 points for voxel edge `dl`, in
    order of first occupancy: (M, 3) f32."""
    lib = _cpp()
    if lib is not None:
        return lib.grid_subsample(points, dl)
    origin = points.min(axis=0)
    vox = np.floor((points - origin) / dl).astype(np.int64)
    keys = (vox[:, 0] << 42) + (vox[:, 1] << 21) + vox[:, 2]
    uniq, first_idx, inv = np.unique(keys, return_index=True, return_inverse=True)
    order = np.argsort(first_idx)
    rank = np.empty_like(order)
    rank[order] = np.arange(len(order))
    inv = rank[inv]
    sums = np.zeros((len(uniq), 3), np.float64)
    counts = np.zeros(len(uniq), np.int64)
    np.add.at(sums, inv, points)
    np.add.at(counts, inv, 1)
    return (sums / counts[:, None]).astype(np.float32)


def radius_neighbors(
    queries: np.ndarray,
    supports: np.ndarray,
    radius: float,
    max_neighbors: int,
) -> np.ndarray:
    """For each query the indices of the supports within `radius`, nearest
    first, cut or padded to `max_neighbors` with the shadow index
    len(supports): (n, max_neighbors) int32."""
    lib = _cpp()
    if lib is not None:
        return lib.radius_neighbors(queries, supports, radius, max_neighbors)
    n, m = len(queries), len(supports)
    out = np.full((n, max_neighbors), m, np.int32)
    r2 = radius * radius
    chunk = max(1, int(2e7 / max(m, 1)))  # bounds the distance matrix
    for s in range(0, n, chunk):
        q = queries[s : s + chunk]
        d2 = ((q[:, None, :] - supports[None, :, :]) ** 2).sum(-1)
        d2_masked = np.where(d2 <= r2, d2, np.inf)
        k = min(max_neighbors, m)
        idx = np.argpartition(d2_masked, kth=k - 1, axis=1)[:, :k]
        dsel = np.take_along_axis(d2_masked, idx, axis=1)
        order = np.argsort(dsel, axis=1)
        idx = np.take_along_axis(idx, order, axis=1)
        dsel = np.take_along_axis(dsel, order, axis=1)
        idx = np.where(np.isinf(dsel), m, idx).astype(np.int32)
        out[s : s + chunk, :k] = idx
    return out


@dataclasses.dataclass
class PyramidArrays:
    """Unpadded single-cloud pyramid (numpy)."""

    points: List[np.ndarray]
    neighbors: List[np.ndarray]
    pools: List[np.ndarray]
    upsamples: List[np.ndarray]


def build_pyramid_arrays(
    points: np.ndarray,
    cfg: KPConvConfig,
    neighbor_limits: Sequence[int],
) -> PyramidArrays:
    """Per-level points, neighbours, pools and upsamples of one cloud: level l
    subsamples with voxel dl*2^l and searches radius dl*2^l*conv_radius;
    `pools[l]` are level-(l+1) queries in level-l supports, `upsamples[l]`
    level-l queries in level-(l+1) supports (radius doubled)."""
    levels: List[np.ndarray] = [points.astype(np.float32)]
    for l in range(1, cfg.num_layers):
        levels.append(grid_subsample(levels[-1], cfg.first_subsampling_dl * (2.0 ** l)))

    neighbors, pools, upsamples = [], [], []
    for l in range(cfg.num_layers):
        r = cfg.first_subsampling_dl * cfg.conv_radius * (2.0 ** l)
        neighbors.append(radius_neighbors(levels[l], levels[l], r, neighbor_limits[l]))
        if l + 1 < cfg.num_layers:
            pools.append(radius_neighbors(levels[l + 1], levels[l], r, neighbor_limits[l]))
            upsamples.append(radius_neighbors(
                levels[l], levels[l + 1], 2.0 * r, neighbor_limits[l + 1]))
    return PyramidArrays(levels, neighbors, pools, upsamples)


def calibrate_neighbor_limits(
    clouds: Sequence[np.ndarray],
    cfg: KPConvConfig,
    percentile: float = 0.8,
    untruncated_cap: int = 256,
) -> List[int]:
    """Per-layer neighbour caps: the `percentile` quantile of the neighbour
    counts over `clouds` (searched up to `untruncated_cap`)."""
    counts: List[List[int]] = [[] for _ in range(cfg.num_layers)]
    for cloud in clouds:
        pyr = build_pyramid_arrays(cloud, cfg, [untruncated_cap] * cfg.num_layers)
        for l, nb in enumerate(pyr.neighbors):
            counts[l].extend((nb < len(pyr.points[l])).sum(axis=1).tolist())
    return [
        max(1, int(np.quantile(np.asarray(c), percentile))) if c else untruncated_cap
        for c in counts
    ]


def pad_and_batch_pyramids(
    pyramids: Sequence[PyramidArrays],
    level_sizes: Optional[Sequence[int]] = None,
) -> PointPyramid:
    """Pad a batch of pyramids to common sizes (default: the largest level of
    the batch) and stack them into a `PointPyramid` of CPU tensors.

    Under padding a neighbour index at or past the real count of its
    support level becomes the padded size N_pad (the shadow index of the
    padded level)."""
    num_levels = len(pyramids[0].points)
    if level_sizes is None:
        level_sizes = [max(len(p.points[l]) for p in pyramids) for l in range(num_levels)]

    def pad_pts(arr, n):
        out = np.zeros((n, 3), np.float32)
        out[: len(arr)] = arr[:n]
        return out

    def pad_idx(arr, n_rows, support_real, support_pad):
        out = np.full((n_rows, arr.shape[1]), support_pad, np.int32)
        rows = min(len(arr), n_rows)
        a = arr[:rows].copy()
        a[a >= support_real] = support_pad
        a[a >= support_pad] = support_pad
        out[:rows] = a
        return out

    points, masks, neighbors, pools, upsamples = [], [], [], [], []
    for l in range(num_levels):
        n = level_sizes[l]
        points.append(np.stack([pad_pts(p.points[l], n) for p in pyramids]))
        masks.append(np.stack([(np.arange(n) < len(p.points[l])).astype(np.float32)
                               for p in pyramids]))
        neighbors.append(np.stack([pad_idx(p.neighbors[l], n, len(p.points[l]), n)
                                   for p in pyramids]))
        if l + 1 < num_levels:
            n_next = level_sizes[l + 1]
            pools.append(np.stack([pad_idx(p.pools[l], n_next, len(p.points[l]), n)
                                   for p in pyramids]))
            upsamples.append(np.stack([pad_idx(p.upsamples[l], n, len(p.points[l + 1]), n_next)
                                       for p in pyramids]))

    def t(arrs, dtype):
        return [torch.as_tensor(a, dtype=dtype) for a in arrs]

    return PointPyramid(t(points, torch.float32), t(masks, torch.float32),
                        t(neighbors, torch.int64), t(pools, torch.int64),
                        t(upsamples, torch.int64))
