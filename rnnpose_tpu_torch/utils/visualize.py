"""Visualization helpers (reference `utils/visualize.py:5-61` +
`flow_vis` usage at `tools/train.py:615`): the port's own copy of
`rnnpose_tpu/utils/visualize.py`, which imports no JAX.

Pure numpy — produce HWC uint8/float images for the logger's image channel.
"""
from __future__ import annotations

import numpy as np

__all__ = [
    "flow_to_color",
    "draw_points",
    "project_pose_overlay",
    "depth_to_color",
]


def _flow_colorwheel() -> np.ndarray:
    """Middlebury-style color wheel (55 colors per segment spec)."""
    RY, YG, GC, CB, BM, MR = 15, 6, 4, 11, 13, 6
    cols = []
    for n, (c0, c1) in zip(
        (RY, YG, GC, CB, BM, MR),
        [
            ((255, 0, 0), (255, 255, 0)),
            ((255, 255, 0), (0, 255, 0)),
            ((0, 255, 0), (0, 255, 255)),
            ((0, 255, 255), (0, 0, 255)),
            ((0, 0, 255), (255, 0, 255)),
            ((255, 0, 255), (255, 0, 0)),
        ],
    ):
        for i in range(n):
            t = i / n
            cols.append(tuple((1 - t) * a + t * b for a, b in zip(c0, c1)))
    return np.asarray(cols, np.float32)  # (55, 3)


_WHEEL = _flow_colorwheel()


def flow_to_color(flow: np.ndarray, max_mag: float | None = None) -> np.ndarray:
    """(H, W, 2) flow -> (H, W, 3) float [0,1] color coding."""
    fx, fy = flow[..., 0], flow[..., 1]
    mag = np.sqrt(fx * fx + fy * fy)
    if max_mag is None:
        max_mag = max(float(mag.max()), 1e-6)
    ang = np.arctan2(-fy, -fx) / np.pi  # [-1, 1]
    fk = (ang + 1) / 2 * (len(_WHEEL) - 1)
    k0 = np.floor(fk).astype(int) % len(_WHEEL)
    k1 = (k0 + 1) % len(_WHEEL)
    f = (fk - np.floor(fk))[..., None]
    col = (1 - f) * _WHEEL[k0] + f * _WHEEL[k1]  # (H, W, 3) in [0,255]
    norm = np.clip(mag / max_mag, 0, 1)[..., None]
    col = 1.0 - norm * (1.0 - col / 255.0)
    return col.astype(np.float32)


def depth_to_color(depth: np.ndarray) -> np.ndarray:
    """(H, W) depth -> (H, W, 3) normalized grayscale-viridis-ish."""
    m = depth > 0
    if not m.any():
        return np.zeros(depth.shape + (3,), np.float32)
    lo, hi = depth[m].min(), depth[m].max()
    t = np.where(m, (depth - lo) / max(hi - lo, 1e-9), 0.0)
    return np.stack([t, 1.0 - np.abs(t - 0.5) * 2, 1.0 - t], axis=-1) * m[..., None]


def draw_points(
    image: np.ndarray, uv: np.ndarray, color=(0.0, 1.0, 0.0), radius: int = 1
) -> np.ndarray:
    """Scatter points onto a float image copy."""
    out = image.copy()
    h, w = out.shape[:2]
    for x, y in np.round(uv).astype(int):
        if 0 <= x < w and 0 <= y < h:
            out[
                max(y - radius, 0) : y + radius + 1,
                max(x - radius, 0) : x + radius + 1,
            ] = color
    return out


def project_pose_overlay(
    image: np.ndarray,
    model_points: np.ndarray,
    T: np.ndarray,
    K_vec: np.ndarray,
    color=(0.0, 1.0, 0.0),
    max_points: int = 2000,
) -> np.ndarray:
    """Project model points at pose T and scatter them on the image
    (the reference's qualitative pose overlays)."""
    pts = model_points[:: max(1, len(model_points) // max_points)]
    pc = pts @ T[:3, :3].T + T[:3, 3]
    z = np.maximum(pc[:, 2], 1e-6)
    uv = np.stack(
        [K_vec[0] * pc[:, 0] / z + K_vec[2], K_vec[1] * pc[:, 1] / z + K_vec[3]],
        axis=-1,
    )
    return draw_points(image, uv, color)
