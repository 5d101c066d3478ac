"""The plain geometry the LM step is made of: the JAX package's f32
rounding forms, the pinhole camera with its Jacobians, the se(3)
exponential, the damped normal equations and their solve. This is the
port's one copy of them: `geometry/precise`, `geometry/projective`,
`geometry/se3`, `geometry/lm` and `models/raft_flow` take them from here.
Each is differentiable.
"""
from __future__ import annotations

import struct
from typing import Optional, Tuple, Union

import torch

Operand = Union[torch.Tensor, float]


def _f32(x: float) -> float:
    return struct.unpack("f", struct.pack("f", x))[0]  # a traced Python number is an f32 constant


def recip(c: float) -> float:
    """f32(1 / c): the constant XLA multiplies by where the JAX code divides
    by `c` (computed in f32, as XLA folds it; the f64 quotient rounded to f32
    is the f32 quotient)."""
    return _f32(1.0 / _f32(c))


def fma(a: Operand, b: Operand, c: Operand) -> torch.Tensor:
    """`a * b + c` with the product unrounded, as XLA's CPU backend contracts
    it: the f32 product is exact in f64, the sum is rounded to f64 and then
    to the tensors' dtype. That double rounding differs from a true fused
    multiply-add only at rare ties; f64 arithmetic gives the same bits on
    the CPU and on the card. One f64 kernel (the f32 operands are widened
    inside it) and the cast back; differentiable; Python numbers are f32
    constants."""
    tensors = [x for x in (a, b, c) if isinstance(x, torch.Tensor)]
    like = tensors[0]
    # c64 carries the most dimensions, so type promotion computes in f64 (a
    # tensor of fewer dimensions would promote like a scalar).
    nd = max(x.dim() for x in tensors)
    if isinstance(c, torch.Tensor):
        c64 = c.double().reshape((1,) * (nd - c.dim()) + tuple(c.shape))
    else:
        c64 = torch.full((1,) * nd, _f32(c), dtype=torch.float64, device=like.device)
    if isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor):
        out = torch.addcmul(c64, a, b)
    elif isinstance(a, torch.Tensor):
        out = torch.add(c64, a, alpha=_f32(b))
    else:
        out = torch.add(c64, b, alpha=_f32(a))
    return out.to(like.dtype)


PROJ_MIN_DEPTH = 0.01  # `project` clamps Z to it and zeroes 1/Z where it engaged


def coords_grid(h: int, w: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """Pixel-coordinate grid (H, W, 2) with channel order (x, y)."""
    ys = torch.arange(h, dtype=dtype, device=device)
    xs = torch.arange(w, dtype=dtype, device=device)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    return torch.stack([gx, gy], dim=-1)


def backproject(depth: torch.Tensor, intrinsics: torch.Tensor) -> torch.Tensor:
    """Depth (..., H, W) + intrinsics (..., 4) -> camera points (..., H, W, 3)."""
    h, w = depth.shape[-2], depth.shape[-1]
    grid = coords_grid(h, w, dtype=depth.dtype, device=depth.device)
    fx = intrinsics[..., 0][..., None, None]
    fy = intrinsics[..., 1][..., None, None]
    cx = intrinsics[..., 2][..., None, None]
    cy = intrinsics[..., 3][..., None, None]
    x = (grid[..., 0] - cx) / fx * depth
    y = (grid[..., 1] - cy) / fy * depth
    return torch.stack([x, y, depth], dim=-1)


def project(
    points: torch.Tensor, intrinsics: torch.Tensor, jacobian: bool = False
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Camera points (..., 3) -> pixel coords (..., 2) [+ d(u,v)/d(X,Y,Z)].

    Z is clamped to PROJ_MIN_DEPTH and the inverse depth zeroed where the
    clamp engaged (the reference's behind-camera guard).
    """
    fx, fy = intrinsics[..., 0], intrinsics[..., 1]
    cx, cy = intrinsics[..., 2], intrinsics[..., 3]
    X, Y, Z = points[..., 0], points[..., 1], points[..., 2]
    valid = Z > PROJ_MIN_DEPTH
    zinv = torch.where(valid, 1.0 / torch.clamp(Z, min=PROJ_MIN_DEPTH),
                       torch.zeros_like(Z))
    u = fx * X * zinv + cx
    v = fy * Y * zinv + cy
    uv = torch.stack([u, v], dim=-1)
    if not jacobian:
        return uv, None
    zero = torch.zeros_like(zinv)
    j_u = torch.stack([fx * zinv, zero, -fx * X * zinv * zinv], dim=-1)
    j_v = torch.stack([zero, fy * zinv, -fy * Y * zinv * zinv], dim=-1)
    return uv, torch.stack([j_u, j_v], dim=-2)


def transform_points(T: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """Apply SE(3): T (..., 4, 4) to point sets (..., N, 3) [same ndim] or
    single points (..., 3) [ndim - 1]."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    if points.dim() == T.dim():
        return points @ R.transpose(-1, -2) + t[..., None, :]
    return (R @ points[..., :, None])[..., 0] + t


def local_perturb_jacobian(points_transformed: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (..., 3, 6) Jacobian [I | -hat(Y)] of exp(xi) Y at xi=0."""
    x, y, z = (points_transformed[..., i] for i in range(3))
    one = torch.ones_like(x)
    zero = torch.zeros_like(x)
    rows = [
        torch.stack([one, zero, zero, zero, z, -y], dim=-1),
        torch.stack([zero, one, zero, -z, zero, x], dim=-1),
        torch.stack([zero, zero, one, y, -x, zero], dim=-1),
    ]
    return torch.stack(rows, dim=-2)


def so3_hat(w: torch.Tensor) -> torch.Tensor:
    """(..., 3) axis-angle vector -> (..., 3, 3) skew-symmetric matrix."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    zero = torch.zeros_like(wx)
    rows = [
        torch.stack([zero, -wz, wy], dim=-1),
        torch.stack([wz, zero, -wx], dim=-1),
        torch.stack([-wy, wx, zero], dim=-1),
    ]
    return torch.stack(rows, dim=-2)


# Switch to the Taylor series below this angle^2 (as the JAX package).
_TAYLOR_THETA2 = 1e-8


def _taylor_switched(theta2, exact_fn, taylor_fn):
    small = theta2 < _TAYLOR_THETA2
    safe = torch.where(small, torch.ones_like(theta2), theta2)
    return torch.where(small, taylor_fn(theta2), exact_fn(safe))


def _series(k0, p1, d1, p2, d2):
    """The Taylor branches' `k0 + p1 / d1 + p2 / d2`, rounded as XLA rounds
    the JAX package's form: each division by a constant a multiply by its
    f32 reciprocal, contracted with the add that follows (`fma`)."""
    return fma(p2, recip(d2), fma(p1, recip(d1), k0))


def _A(theta2):
    """sin(t)/t."""
    return _taylor_switched(
        theta2,
        lambda t2: torch.sin(torch.sqrt(t2)) / torch.sqrt(t2),
        lambda t2: _series(1.0, -t2, 6.0, t2 * t2, 120.0),
    )


def _B(theta2):
    """(1-cos(t))/t^2."""
    return _taylor_switched(
        theta2,
        lambda t2: (1.0 - torch.cos(torch.sqrt(t2))) / t2,
        lambda t2: _series(0.5, -t2, 24.0, t2 * t2, 720.0),
    )


def _C(theta2):
    """(t - sin(t))/t^3."""
    return _taylor_switched(
        theta2,
        lambda t2: (torch.sqrt(t2) - torch.sin(torch.sqrt(t2)))
        / (t2 * torch.sqrt(t2)),
        lambda t2: _series(1.0 / 6.0, -t2, 120.0, t2 * t2, 5040.0),
    )


def _bottom_row(like: torch.Tensor) -> torch.Tensor:
    # Made on the device: a list copied from the host would be a
    # synchronising copy, which a CUDA graph capture refuses.
    row = torch.eye(4, dtype=like.dtype, device=like.device)[3]
    return row.expand(like.shape[:-2] + (1, 4))


def se3_expm(xi: torch.Tensor) -> torch.Tensor:
    """Closed-form exp: se(3) twist (..., 6) [v, w] -> (..., 4, 4).

    R = exp(W);  t = V v with V = I + B*W + C*W^2 (left Jacobian of SO(3)).
    """
    v, w = xi[..., :3], xi[..., 3:]
    theta2 = torch.sum(w * w, dim=-1)[..., None, None]
    W = so3_hat(w)
    W2 = W @ W
    eye = torch.eye(3, dtype=xi.dtype, device=xi.device).expand(W.shape)
    A, B = _A(theta2), _B(theta2)
    R = eye + A * W + B * W2
    V = eye + B * W + _C(theta2) * W2
    t = V @ v[..., :, None]
    top = torch.cat([R, t], dim=-1)
    return torch.cat([top, _bottom_row(top)], dim=-2)


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


def lm_normal_equations(T, target, weight, X0, valid, intrinsics, min_depth: float,
                        lm_lambda: float, ep_lambda: float):
    """The damped normal equations of one LM step, in f64: (H (B, 6, 6),
    b (B, 6)) of the pose T (B, 4, 4) against the target pixel field
    (B, H, W, 2) with per-pixel weights (B, H, W, 2), on the back-projected
    points X0 (B, H, W, 3) where `valid` (B, H, W) and the transformed depth
    exceeds `min_depth`."""
    B = T.shape[0]
    X1 = transform_points(T, X0.reshape(B, -1, 3)).reshape(X0.shape)
    uv, j_proj = project(X1, intrinsics[:, None, None, :], jacobian=True)
    J = j_proj @ local_perturb_jacobian(X1)           # (B, H, W, 2, 6)

    r = target - uv
    v = valid * (X1[..., 2] > min_depth).to(valid.dtype)
    w_all = weight * v[..., None]

    # The normal equations are summed and solved in f64: their sums cancel,
    # and in f32 the solve turns the summation order's rounding into pose
    # differences past 1e-4 between devices (`tools/numerics_check`).
    f64 = torch.float64
    Jf = J.reshape(B, -1, 6).to(f64)
    Jw = Jf * w_all.reshape(B, -1)[..., None].to(f64)
    H = Jw.transpose(1, 2) @ Jf                                     # (B, 6, 6)
    b = (Jw.transpose(1, 2) @ r.reshape(B, -1, 1).to(f64))[..., 0]  # (B, 6)

    eye = torch.eye(6, dtype=H.dtype, device=H.device)
    diag = torch.diagonal(H, dim1=-2, dim2=-1)
    return H + ep_lambda * eye + lm_lambda * diag[..., None] * eye, b
