"""Levenberg-Marquardt pose optimisation on reprojection residuals (port of
`rnnpose_tpu/geometry/lm.py`).

f32 normal equations with Jacobi preconditioning and an unrolled 6x6
Cholesky; non-finite solutions are zeroed and the update clamped. The step
is differentiable through autograd; the pose increment's exponential takes
the reference's approximate backward by default (`expm_approx_grad`).
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from . import projective as proj
from . import se3 as se3_ops

__all__ = [
    "LMConfig",
    "solve_spd",
    "pose_transform_coords",
    "induced_flow",
    "reprojection_optim",
]


class LMConfig(NamedTuple):
    """Damping / safety constants (the fields and defaults of the JAX
    package's `LMConfig`)."""

    lm_lambda: float = 1e-4   # multiplicative damping: H += lm_lambda * diag(H)
    ep_lambda: float = 100.0  # additive damping:       H += ep_lambda * I
    delta_clamp: float = 1.0  # clamp on the twist update
    min_depth: float = 0.1    # validity threshold on source depth
    expm_approx_grad: bool = True  # back the increment's expm with the
                                   # reference's small-angle VJP; False =
                                   # exact expm differentials


def solve_spd(H: torch.Tensor, b: torch.Tensor, delta_clamp: float = 1.0) -> torch.Tensor:
    """Solve H x = b for SPD H (..., n, n) with Jacobi preconditioning.

    Unrolled Cholesky-Crout, batched over the leading dims (no clamp inside:
    a non-SPD input yields NaN, which the isfinite zeroing catches), then x
    is zeroed where non-finite and clamped to +-delta_clamp.
    """
    d = torch.sqrt(torch.clamp(torch.diagonal(H, dim1=-2, dim2=-1), min=1e-12))
    d_inv = 1.0 / d
    Hs = H * d_inv[..., :, None] * d_inv[..., None, :]
    bs = b * d_inv
    n = H.shape[-1]
    L = [[None] * n for _ in range(n)]
    for j in range(n):
        s = Hs[..., j, j] - sum(L[j][k] ** 2 for k in range(j))
        L[j][j] = torch.sqrt(s)
        for i in range(j + 1, n):
            s = Hs[..., i, j] - sum(L[i][k] * L[j][k] for k in range(j))
            L[i][j] = s / L[j][j]
    yv = []
    for i in range(n):
        yv.append((bs[..., i] - sum(L[i][k] * yv[k] for k in range(i))) / L[i][i])
    xv = [None] * n
    for i in reversed(range(n)):
        xv[i] = (yv[i] - sum(L[k][i] * xv[k] for k in range(i + 1, n))) / L[i][i]
    x = torch.stack(xv, dim=-1) * d_inv
    x = torch.where(torch.isfinite(x), x, torch.zeros_like(x))
    return torch.clamp(x, -delta_clamp, delta_clamp)


def pose_transform_coords(
    T: torch.Tensor, depth: torch.Tensor, intrinsics: torch.Tensor,
    min_depth: float = 0.1,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Backproject -> rigid transform -> project.

    T (B, 4, 4), depth (B, H, W), intrinsics (B, 4) -> coords (B, H, W, 2),
    valid (B, H, W) float mask (depth > min_depth).
    """
    X0 = proj.backproject(depth, intrinsics)
    B = X0.shape[0]
    X1 = proj.transform_points(T, X0.reshape(B, -1, 3)).reshape(X0.shape)
    coords1, _ = proj.project(X1, intrinsics[:, None, None, :])
    return coords1, (depth > min_depth).to(depth.dtype)


def induced_flow(
    T: torch.Tensor, depth: torch.Tensor, intrinsics: torch.Tensor,
    min_depth: float = 0.1,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pose-induced optical flow (B, H, W, 2) and its validity mask
    (B, H, W) (reference `transformation.py:200-208`)."""
    coords1, valid = pose_transform_coords(T, depth, intrinsics, min_depth)
    h, w = depth.shape[-2], depth.shape[-1]
    return coords1 - proj.coords_grid(h, w, dtype=depth.dtype, device=depth.device), valid


def _lm_step(T, target, weight, X0, valid, intrinsics, cfg: LMConfig):
    """One damped Gauss-Newton step. T (B,4,4), target/weight (B,H,W,2),
    X0 (B,H,W,3), valid (B,H,W), intrinsics (B,4)."""
    B = T.shape[0]
    X1 = proj.transform_points(T, X0.reshape(B, -1, 3)).reshape(X0.shape)
    uv, j_proj = proj.project(X1, intrinsics[:, None, None, :], jacobian=True)
    J = j_proj @ proj.local_perturb_jacobian(X1)           # (B, H, W, 2, 6)

    r = target - uv
    v = valid * (X1[..., 2] > cfg.min_depth).to(valid.dtype)
    w_all = weight * v[..., None]

    Jf = J.reshape(B, -1, 6)
    Jw = Jf * w_all.reshape(B, -1)[..., None]
    H = Jw.transpose(1, 2) @ Jf                             # (B, 6, 6)
    b = (Jw.transpose(1, 2) @ r.reshape(B, -1, 1))[..., 0]  # (B, 6)

    eye = torch.eye(6, dtype=H.dtype, device=H.device)
    diag = torch.diagonal(H, dim1=-2, dim2=-1)
    H = H + cfg.ep_lambda * eye + cfg.lm_lambda * diag[..., None] * eye
    delta = solve_spd(H, b, cfg.delta_clamp)
    return se3_ops.se3_increment(T, delta, approx_grad=cfg.expm_approx_grad)


def reprojection_optim(
    T: torch.Tensor,
    target: torch.Tensor,
    weight: torch.Tensor,
    depth: torch.Tensor,
    intrinsics: torch.Tensor,
    num_iters: int = 1,
    cfg: LMConfig = LMConfig(),
) -> torch.Tensor:
    """`num_iters` damped Gauss-Newton steps of T (B, 4, 4) against the
    target pixel field (B, H, W, 2) with per-pixel weights (B, H, W, 2), on
    the points back-projected from `depth` (B, H, W) with `intrinsics`."""
    X0 = proj.backproject(depth, intrinsics)
    valid = (depth > cfg.min_depth).to(depth.dtype)
    for _ in range(num_iters):
        T = _lm_step(T, target, weight, X0, valid, intrinsics, cfg)
    return T
