"""Per-frame preprocessing of a training sample, frozen here: a copy of the
parts of `rnnpose_tpu_torch/data/preprocess.py` that a LINEMOD training
sample runs (numpy; scipy's cKDTree for the correspondences).

* model normalisation: centre and scale by the bbox extent, with the pose
  translation compensated (t' = R c + t);
* the object-centric patch crop around the init-pose mask to a fixed
  output size, with the intrinsics updated (`patch_crop`), through
  `warp_affine`, which rounds as OpenCV 5's `cv2.warpAffine` does: each
  source coordinate in f32 as fma(x, m00, f32(y * m01 + m02)) from the
  f32-cast inverse map, INTER_LINEAR with fma lerps, INTER_NEAREST
  rounding half to even, BORDER_CONSTANT 0;
* depth lifting and the 2D-3D radius correspondences (K=5), padded to a
  fixed count with background rows appended.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np

from ..models.rnnpose import CorrespondenceSet

__all__ = [
    "PreprocessConfig",
    "normalize_model",
    "warp_affine",
    "patch_crop",
    "mask_depth_to_points",
    "lift_to_model_frame",
    "get_correspondences",
    "build_correspondence_set",
    "TooFewCorrespondences",
]


class TooFewCorrespondences(Exception):
    """Raised on a degenerate frame; the caller advances to the next one."""


@dataclasses.dataclass(frozen=True)
class PreprocessConfig:
    max_points: int = 20000
    correspondence_radius: float = 0.01
    crop_margin_ratio: float = 0.85     # the reference's patch-crop margin
    crop_size: int = 320
    num_corr: int = 256                 # rows of the circle loss
    bg_fraction: float = 0.1            # background rows appended
    min_correspondences: int = 10


def normalize_model(
    points: np.ndarray, RT: np.ndarray
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, float]:
    """Centre and scale the model; compensate the pose translation.

    Returns (points_norm, RT_norm (3, 4), center, scale) with t' = R c + t.
    """
    center = points.mean(axis=0)
    scale = float((points.max(0) - points.min(0)).max())
    pts = (points - center) / scale
    RT_n = RT.copy()
    RT_n[:, 3] = RT[:, :3] @ center + RT[:, 3]
    return pts.astype(np.float32), RT_n.astype(np.float32), center.astype(np.float32), scale


def _inverse_map(M: np.ndarray) -> np.ndarray:
    """The destination->source map of a forward 2x3 affine, in f64, as
    `cv2.warpAffine` inverts it."""
    m = np.asarray(M, np.float64).reshape(2, 3)
    det = m[0, 0] * m[1, 1] - m[0, 1] * m[1, 0]
    det = 1.0 / det if det != 0 else 0.0
    inv = np.empty((2, 3))
    inv[0, 0], inv[1, 1] = m[1, 1] * det, m[0, 0] * det
    inv[0, 1], inv[1, 0] = -m[0, 1] * det, -m[1, 0] * det
    inv[0, 2] = -inv[0, 0] * m[0, 2] - inv[0, 1] * m[1, 2]
    inv[1, 2] = -inv[1, 0] * m[0, 2] - inv[1, 1] * m[1, 2]
    return inv


def _fma32(a, b, c) -> np.ndarray:
    """a * b + c rounded once to f32 (the f32 product is exact in f64)."""
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64)
            + np.asarray(c, np.float64)).astype(np.float32)


def _gather(src: np.ndarray, ys: np.ndarray, xs: np.ndarray) -> np.ndarray:
    """src[ys, xs], 0 where (ys, xs) lies outside src."""
    h, w = src.shape[:2]
    inside = (ys >= 0) & (ys < h) & (xs >= 0) & (xs < w)
    vals = src[np.clip(ys, 0, h - 1), np.clip(xs, 0, w - 1)]
    if src.ndim == 3:
        inside = inside[..., None]
    return np.where(inside, vals, np.zeros((), src.dtype))


def warp_affine(src: np.ndarray, M: np.ndarray, dsize: Sequence[int],
                interpolation: str = "linear") -> np.ndarray:
    """`cv2.warpAffine(src, M, dsize, flags=INTER_LINEAR | INTER_NEAREST)`
    with BORDER_CONSTANT 0. dsize is (width, height); "linear" takes f32
    images (H, W[, C]), "nearest" any dtype."""
    if interpolation not in ("linear", "nearest"):
        raise ValueError(f"interpolation must be 'linear' or 'nearest', got {interpolation!r}")
    if interpolation == "linear" and src.dtype != np.float32:
        raise TypeError(f"linear warp takes a float32 image, got {src.dtype}")
    f = _inverse_map(M).astype(np.float32)
    ys = np.arange(int(dsize[1]), dtype=np.float32)[:, None]
    xs = np.arange(int(dsize[0]), dtype=np.float32)[None, :]
    sx = _fma32(xs, f[0, 0], ys * f[0, 1] + f[0, 2])
    sy = _fma32(xs, f[1, 0], ys * f[1, 1] + f[1, 2])
    if interpolation == "nearest":
        return _gather(src, np.rint(sy).astype(np.int64), np.rint(sx).astype(np.int64))
    ix, iy = np.floor(sx), np.floor(sy)
    a, b = sx - ix, sy - iy
    ix, iy = ix.astype(np.int64), iy.astype(np.int64)
    if src.ndim == 3:
        a, b = a[..., None], b[..., None]
    p00, p01 = _gather(src, iy, ix), _gather(src, iy, ix + 1)
    p10, p11 = _gather(src, iy + 1, ix), _gather(src, iy + 1, ix + 1)
    top = _fma32(a, p01 - p00, p00)
    bottom = _fma32(a, p11 - p10, p10)
    return _fma32(b, bottom - top, top)


def patch_crop(
    image: np.ndarray,
    depth: Optional[np.ndarray],
    mask: np.ndarray,
    K: np.ndarray,
    margin_ratio: float = 0.85,
    output_size: int = 320,
    offset_ratio: Tuple[float, float] = (0.0, 0.0),
) -> Tuple[np.ndarray, Optional[np.ndarray], np.ndarray, np.ndarray]:
    """Square crop around the mask bbox, resized to output_size: bbox of the
    mask, the margin, a square aspect, bilinear image and nearest depth and
    mask, K updated. Returns (image, depth, mask, K_new)."""
    ys, xs = np.nonzero(mask)
    h, w = mask.shape[:2]
    if len(xs) == 0:
        x0, y0, x1, y1 = 0, 0, w - 1, h - 1
    else:
        x0, y0, x1, y1 = xs.min(), ys.min(), xs.max(), ys.max()
    cx, cy = (x0 + x1) / 2.0, (y0 + y1) / 2.0
    half = max(x1 - x0, y1 - y0) / 2.0 * (1.0 + margin_ratio)
    half = max(half, 8.0)
    cx += offset_ratio[0] * half
    cy += offset_ratio[1] * half

    sx0, sy0 = cx - half, cy - half
    s = output_size / (2.0 * half)

    M = np.asarray([[s, 0.0, -sx0 * s], [0.0, s, -sy0 * s]], np.float32)
    size = (output_size, output_size)
    img_c = warp_affine(image, M, size, "linear")
    depth_c = warp_affine(depth, M, size, "nearest") if depth is not None else None
    mask_c = warp_affine(mask.astype(np.uint8), M, size, "nearest").astype(bool)

    K_new = K.copy().astype(np.float32)
    K_new[0, 0] *= s
    K_new[1, 1] *= s
    K_new[0, 2] = (K[0, 2] - sx0) * s
    K_new[1, 2] = (K[1, 2] - sy0) * s
    return img_c, depth_c, mask_c, K_new


def mask_depth_to_points(
    depth: np.ndarray, K: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """Lift nonzero depth pixels to camera-frame points: (points (M, 3),
    pixel coords (M, 2) as (x, y))."""
    ys, xs = np.nonzero(depth > 0)
    z = depth[ys, xs]
    x = (xs - K[0, 2]) / K[0, 0] * z
    y = (ys - K[1, 2]) / K[1, 1] * z
    return (
        np.stack([x, y, z], axis=-1).astype(np.float32),
        np.stack([xs, ys], axis=-1).astype(np.int64),
    )


def lift_to_model_frame(
    pts_cam: np.ndarray, RT_norm: np.ndarray, scale: float
) -> np.ndarray:
    """Camera points -> normalised model frame: R^T (X - t') / s."""
    return ((RT_norm[:, :3].T @ (pts_cam.T - RT_norm[:, 3:])).T / scale).astype(np.float32)


def get_correspondences(
    lifted: np.ndarray, model: np.ndarray, radius: float, k: int = 5
) -> np.ndarray:
    """(N_l, 3) x (N_m, 3) -> (P, 2) [lifted_idx, model_idx] pairs within
    `radius`, up to k per lifted point, in (lifted, then neighbour) order."""
    from scipy.spatial import cKDTree

    tree = cKDTree(model)
    _, idxs = tree.query(lifted, k=k, distance_upper_bound=radius, workers=-1)
    if k == 1:
        idxs = idxs[:, None]
    # A miss is reported as idx == n_model.
    li, kj = np.nonzero(idxs < len(model))
    return np.stack([li, idxs[li, kj]], axis=-1).astype(np.int64).reshape(-1, 2)


def build_correspondence_set(
    lifted_points: np.ndarray,     # (M, 3) normalised model frame
    lifted_px: np.ndarray,         # (M, 2) pixel coords
    model_points: np.ndarray,      # (N, 3) normalised
    pairs: np.ndarray,             # (P, 2) [lifted_idx, model_idx]
    depth_mask: np.ndarray,        # (H, W) bool fg mask
    cfg: PreprocessConfig,
    rs: np.random.RandomState,
) -> CorrespondenceSet:
    """A fixed-size correspondence set of numpy arrays (no batch axis; the
    collate stacks): up to 90% of the rows sampled from `pairs`, then
    background-pixel rows with 1e6 sentinel coordinates."""
    P = cfg.num_corr
    n_bg = max(1, int(P * cfg.bg_fraction))
    n_fg = P - n_bg

    if len(pairs) < cfg.min_correspondences:
        raise TooFewCorrespondences(f"only {len(pairs)} pairs")

    sel = rs.permutation(len(pairs))[:n_fg]
    pairs_sel = pairs[sel]
    n_real_fg = len(pairs_sel)

    px = np.zeros((P, 2), np.int64)
    src_pts = np.full((P, 3), 1e6, np.float32)
    tgt_pts = np.full((P, 3), 1e6, np.float32)
    model_idx = np.zeros((P,), np.int64)
    is_bg = np.ones((P,), np.float32)
    valid = np.zeros((P,), np.float32)

    px[:n_real_fg] = lifted_px[pairs_sel[:, 0]]
    src_pts[:n_real_fg] = lifted_points[pairs_sel[:, 0]]
    tgt_pts[:n_real_fg] = model_points[pairs_sel[:, 1]]
    model_idx[:n_real_fg] = pairs_sel[:, 1]
    is_bg[:n_real_fg] = 0.0
    valid[:n_real_fg] = 1.0

    bg_ys, bg_xs = np.nonzero(~depth_mask)
    if len(bg_xs) > 0:
        bsel = rs.randint(0, len(bg_xs), size=n_bg)
        px[n_fg:] = np.stack([bg_xs[bsel], bg_ys[bsel]], axis=-1)
        valid[n_fg:] = 1.0
    return CorrespondenceSet(
        px=px, src_pts=src_pts, tgt_pts=tgt_pts,
        model_idx=model_idx, is_bg=is_bg, valid=valid,
    )
