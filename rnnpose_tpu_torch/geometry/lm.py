"""Levenberg-Marquardt pose optimisation on reprojection residuals (port of
`rnnpose_tpu/geometry/lm.py`).

f64 normal equations with Jacobi preconditioning and an unrolled 6x6
Cholesky (`lm_normal_equations` and `solve_spd`, kept in
`kernels/geometry` beside the operator's plain version); non-finite
solutions are zeroed and the update clamped. Where a gradient is needed the
step is `_lm_step`, differentiable through autograd; the pose increment's
exponential takes the reference's approximate backward by default
(`expm_approx_grad`). Where none is (eval and serving run under
`torch.no_grad()`) each step is one call of the operator
`kernels/lm.lm_step`: one kernel launch on the card, and on the CPU
its plain version, which gives `_lm_step`'s bits.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from .. import kernels
from ..kernels import lm as lm_kernel
from ..kernels.geometry import lm_normal_equations, solve_spd
from . import projective as proj
from . import se3 as se3_ops

__all__ = [
    "LMConfig",
    "solve_spd",
    "pose_transform_coords",
    "induced_flow",
    "reprojection_optim",
    "solve_pose_from_flow",
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
    X0 (B,H,W,3), valid (B,H,W), intrinsics (B,4). The operator's plain
    version (`lm_kernel.lm_step_plain`) is the same functions."""
    H, b = lm_normal_equations(T, target, weight, X0, valid, intrinsics, cfg.min_depth,
                               cfg.lm_lambda, cfg.ep_lambda)
    delta = solve_spd(H, b, cfg.delta_clamp).to(T.dtype)
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
    the points back-projected from `depth` (B, H, W) with `intrinsics`.
    Without a gradient to keep each step is one `lm_kernel.lm_step` (the kernel on
    the card); otherwise, and for CPU inputs the kernel does not take
    (float64; on the card the wrapper raises on them), `_lm_step`, under
    autograd where it is on (`kernels.uses_kernel`)."""
    if kernels.uses_kernel("lm_step", T, target, weight, depth, intrinsics):
        for _ in range(num_iters):
            T = lm_kernel.lm_step(T, target, weight, depth, intrinsics, cfg.lm_lambda,
                                  cfg.ep_lambda, cfg.delta_clamp, cfg.min_depth)
        return T
    X0 = proj.backproject(depth, intrinsics)
    valid = (depth > cfg.min_depth).to(depth.dtype)
    for _ in range(num_iters):
        T = _lm_step(T, target, weight, X0, valid, intrinsics, cfg)
    return T


def solve_pose_from_flow(
    T_init: torch.Tensor,
    flow: torch.Tensor,
    weight: torch.Tensor,
    depth: torch.Tensor,
    intrinsics: torch.Tensor,
    num_iters: int = 1,
    cfg: LMConfig = LMConfig(),
) -> torch.Tensor:
    """`reprojection_optim` against the target grid + flow."""
    h, w = depth.shape[-2], depth.shape[-1]
    grid = proj.coords_grid(h, w, dtype=depth.dtype, device=depth.device)
    return reprojection_optim(T_init, grid + flow, weight, depth, intrinsics, num_iters, cfg)
