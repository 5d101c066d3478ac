"""Pose utilities on the host (numpy; port of `rnnpose_tpu/data/poses.py`):
noisy initial-pose sampling (per-axis Euler noise of sigma 15 deg, 1 cm x/y
and 5 cm z translation noise, resampled while the geodesic rotation error
exceeds 45 deg), rotation re-orthonormalisation and homogeneous padding."""
from __future__ import annotations

import numpy as np

__all__ = ["sample_noisy_poses", "reorthonormalize", "pose_padding", "rotation_geodesic_deg"]

SYN_STD_ROTATION_DEG = 15.0
SYN_STD_TRANSLATION = 0.01
ANGLE_MAX_DEG = 45.0


def rotation_geodesic_deg(R1: np.ndarray, R2: np.ndarray) -> float:
    cos = (np.trace(R1.T @ R2) - 1.0) / 2.0
    return float(np.degrees(np.arccos(np.clip(cos, -1.0, 1.0))))


def _euler_noise(R, rs):
    from scipy.spatial.transform import Rotation

    euler = Rotation.from_matrix(R).as_euler("xyz")
    euler = euler + np.radians(SYN_STD_ROTATION_DEG) * rs.randn(3)
    return Rotation.from_euler("xyz", euler).as_matrix()


def sample_noisy_poses(pose_tgt: np.ndarray, rs: np.random.RandomState) -> np.ndarray:
    """(B, 4, 4) GT poses -> (B, 4, 4) noisy init poses (draws from `rs`)."""
    out = pose_tgt.copy()
    for b in range(len(pose_tgt)):
        R = _euler_noise(pose_tgt[b, :3, :3], rs)
        while rotation_geodesic_deg(R, pose_tgt[b, :3, :3]) > ANGLE_MAX_DEG:
            R = _euler_noise(pose_tgt[b, :3, :3], rs)
        out[b, :3, :3] = R
        out[b, 0, 3] = pose_tgt[b, 0, 3] + SYN_STD_TRANSLATION * rs.randn()
        out[b, 1, 3] = pose_tgt[b, 1, 3] + SYN_STD_TRANSLATION * rs.randn()
        out[b, 2, 3] = pose_tgt[b, 2, 3] + 5 * SYN_STD_TRANSLATION * rs.randn()
    return out.astype(np.float32)


def reorthonormalize(R: np.ndarray) -> np.ndarray:
    """Project to the nearest rotation (SVD)."""
    u, _, vt = np.linalg.svd(R)
    out = u @ vt
    if np.linalg.det(out) < 0:
        u[:, -1] *= -1
        out = u @ vt
    return out.astype(np.float32)


def pose_padding(RT: np.ndarray) -> np.ndarray:
    """(..., 3, 4) -> (..., 4, 4) homogeneous."""
    out = np.zeros(RT.shape[:-2] + (4, 4), RT.dtype)
    out[..., :3, :] = RT
    out[..., 3, 3] = 1.0
    return out
