"""SE(3) / SO(3) Lie-group math on batched torch tensors.

Port of `rnnpose_tpu/geometry/se3.py`: the same Taylor-switched closed-form
exponential, inverse and left-multiplicative increment, over `(..., 4, 4)`
float32 tensors. All contractions are tiny and run in exact f32 (the
forward turns TF32 off on the card, see `models/rnnpose.py`).

`se3_expm` differentiates exactly through autograd; `se3_expm_approx_grad`
has the same forward and the reference's approximate backward, selected for
the LM step by `LMConfig.expm_approx_grad`. `so3_logm`/`se3_logm` invert the
exponential (Taylor-switched near the identity); the wxyz quaternion helpers
pick the same branch and sign as the JAX package.
"""
from __future__ import annotations

import torch

from .precise import fma, recip

__all__ = ["so3_hat", "hat", "vee", "so3_expm", "se3_expm", "se3_expm_approx_grad",
           "se3_inverse", "se3_increment", "so3_logm", "se3_logm", "quat_to_matrix",
           "matrix_to_quat", "se3_from_quat_trans"]

# Switch to the Taylor series below this angle^2 (as the JAX package).
_TAYLOR_THETA2 = 1e-8


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


def hat(xi: torch.Tensor) -> torch.Tensor:
    """se(3) twist (..., 6) [v, w] -> (..., 4, 4) generator matrix."""
    v, w = xi[..., :3], xi[..., 3:]
    top = torch.cat([so3_hat(w), v[..., :, None]], dim=-1)
    return torch.cat([top, torch.zeros_like(top[..., :1, :])], dim=-2)


def vee(X: torch.Tensor) -> torch.Tensor:
    """Inverse of `hat`: (..., 4, 4) -> (..., 6) [v, w]."""
    w = torch.stack([X[..., 2, 1], X[..., 0, 2], X[..., 1, 0]], dim=-1)
    return torch.cat([X[..., :3, 3], w], dim=-1)


def _taylor_switched(theta2, exact_fn, taylor_fn):
    small = theta2 < _TAYLOR_THETA2
    safe = torch.where(small, torch.ones_like(theta2), theta2)
    return torch.where(small, taylor_fn(theta2), exact_fn(safe))


def _series(k0, p1, d1, p2, d2):
    """The Taylor branches' `k0 + p1 / d1 + p2 / d2`, rounded as XLA rounds
    the JAX package's form: each division by a constant a multiply by its
    f32 reciprocal, contracted with the add that follows (`precise`)."""
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


def so3_expm(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues formula: (..., 3) -> (..., 3, 3) rotation matrix."""
    theta2 = torch.sum(w * w, dim=-1)[..., None, None]
    W = so3_hat(w)
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand(W.shape)
    return eye + _A(theta2) * W + _B(theta2) * (W @ W)


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


class _ExpmApproxGrad(torch.autograd.Function):
    """`se3_expm` forward; the backward is the expm VJP linearised at the
    identity (reference `geometry/se3.py:212-222`): grad_k = <dL/dT, G_k>
    for the se(3) generators, [g03, g13, g23 | g21 - g12, g02 - g20,
    g10 - g01] in [v, w] layout, with no dependence on the output."""

    @staticmethod
    def forward(xi):
        return se3_expm(xi)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, g):
        return torch.stack([
            g[..., 0, 3], g[..., 1, 3], g[..., 2, 3],
            g[..., 2, 1] - g[..., 1, 2],
            g[..., 0, 2] - g[..., 2, 0],
            g[..., 1, 0] - g[..., 0, 1],
        ], dim=-1)


def se3_expm_approx_grad(xi: torch.Tensor) -> torch.Tensor:
    """`se3_expm` with the reference's approximate backward pass."""
    return _ExpmApproxGrad.apply(xi)


def se3_inverse(T: torch.Tensor) -> torch.Tensor:
    """Closed-form SE(3) inverse."""
    Rt = T[..., :3, :3].transpose(-1, -2)
    top = torch.cat([Rt, -(Rt @ T[..., :3, 3:])], dim=-1)
    return torch.cat([top, _bottom_row(top)], dim=-2)


def se3_increment(T: torch.Tensor, delta: torch.Tensor,
                  approx_grad: bool = False) -> torch.Tensor:
    """Left-multiplicative update T <- exp(delta) @ T; `approx_grad` backs
    the exponential with `se3_expm_approx_grad`."""
    expm = se3_expm_approx_grad if approx_grad else se3_expm
    return expm(delta) @ T


def so3_logm(R: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) rotation -> (..., 3) axis-angle. Valid away from theta=pi."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_theta = torch.clamp((trace - 1.0) * 0.5, -1.0 + 1e-7, 1.0 - 1e-7)
    theta = torch.arccos(cos_theta)
    # w_hat = theta / (2 sin theta) (R - R^T)
    skew = (R - R.transpose(-1, -2)) * 0.5
    w_raw = torch.stack([skew[..., 2, 1], skew[..., 0, 2], skew[..., 1, 0]], dim=-1)
    factor = _taylor_switched(
        (theta * theta)[..., None],
        lambda t2: torch.sqrt(t2) / torch.sin(torch.sqrt(t2)),
        lambda t2: _series(1.0, t2, 6.0, 7.0 * t2 * t2, 360.0),
    )
    return w_raw * factor


def se3_logm(T: torch.Tensor) -> torch.Tensor:
    """(..., 4, 4) -> (..., 6) twist [v, w]; the inverse of `se3_expm`."""
    w = so3_logm(T[..., :3, :3])
    theta2 = torch.sum(w * w, dim=-1)[..., None, None]
    W = so3_hat(w)
    eye = torch.eye(3, dtype=T.dtype, device=T.device).expand(W.shape)
    # V^-1 = I - W/2 + (1/t^2)(1 - A/(2B)) W^2
    coef = _taylor_switched(
        theta2,
        lambda t2: (1.0 - _A(t2) / (2.0 * _B(t2))) / t2,
        lambda t2: _series(1.0 / 12.0, t2, 720.0, t2 * t2, 30240.0),
    )
    V_inv = eye - 0.5 * W + coef * (W @ W)
    v = (V_inv @ T[..., :3, 3:])[..., 0]
    return torch.cat([v, w], dim=-1)


# Quaternions, wxyz (the reference `geometry/se3.py:30-109`).
_EPS = 1e-8


def quat_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion (..., 4) wxyz -> rotation matrix (..., 3, 3)."""
    q = q / torch.clamp(torch.linalg.norm(q, dim=-1, keepdim=True), min=_EPS)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    rows = [
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
    ]
    return torch.stack(rows, dim=-2)


def matrix_to_quat(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix (..., 3, 3) -> unit quaternion (..., 4) wxyz, w >= 0.

    Shepperd's extraction: all four candidates, the one with the largest
    pivot kept (the JAX package's branch selection)."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    def safe_sqrt(x):
        return torch.sqrt(torch.clamp(x, min=_EPS))

    qw = safe_sqrt(1.0 + tr) * 0.5
    qx = safe_sqrt(1.0 + m00 - m11 - m22) * 0.5
    qy = safe_sqrt(1.0 - m00 + m11 - m22) * 0.5
    qz = safe_sqrt(1.0 - m00 - m11 + m22) * 0.5
    qs = torch.stack([
        torch.stack([qw, (m21 - m12) / (4 * qw), (m02 - m20) / (4 * qw),
                     (m10 - m01) / (4 * qw)], -1),
        torch.stack([(m21 - m12) / (4 * qx), qx, (m01 + m10) / (4 * qx),
                     (m02 + m20) / (4 * qx)], -1),
        torch.stack([(m02 - m20) / (4 * qy), (m01 + m10) / (4 * qy), qy,
                     (m12 + m21) / (4 * qy)], -1),
        torch.stack([(m10 - m01) / (4 * qz), (m02 + m20) / (4 * qz),
                     (m12 + m21) / (4 * qz), qz], -1),
    ], dim=-2)
    pivots = torch.stack([1.0 + tr, 1.0 + m00 - m11 - m22, 1.0 - m00 + m11 - m22,
                          1.0 - m00 - m11 + m22], dim=-1)
    best = torch.argmax(pivots, dim=-1)
    q = torch.take_along_dim(qs, best[..., None, None], dim=-2)[..., 0, :]
    q = q / torch.clamp(torch.linalg.norm(q, dim=-1, keepdim=True), min=_EPS)
    return q * torch.where(q[..., :1] < 0, -1.0, 1.0)


def se3_from_quat_trans(q: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Quaternion (..., 4) + translation (..., 3) -> (..., 4, 4)."""
    top = torch.cat([quat_to_matrix(q), t[..., :, None]], dim=-1)
    return torch.cat([top, _bottom_row(top)], dim=-2)
