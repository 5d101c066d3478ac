"""The port's geometry (`rnnpose_tpu_torch.geometry`) against the JAX
package on the same seeded inputs.

Tolerance: 1e-5 absolute (plus 1e-6 relative for pixel-scale values, a few
f32 ulps at 100 px): both sides run exact f32 on the CPU and differ only in
summation order.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_port_common  # noqa: F401  (pins torch to one thread)
from rnnpose_tpu.geometry import crop as jcrop
from rnnpose_tpu.geometry import lm as jlm
from rnnpose_tpu.geometry import projective as jproj
from rnnpose_tpu.geometry import se3 as jse3
from rnnpose_tpu_torch.geometry import crop as tcrop
from rnnpose_tpu_torch.geometry import lm as tlm
from rnnpose_tpu_torch.geometry import projective as tproj
from rnnpose_tpu_torch.geometry import se3 as tse3

ATOL, RTOL = 1e-5, 1e-6


def close(t, j, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), atol=atol, rtol=rtol)


def _twists(rs, n, scale):
    return (rs.randn(n, 6) * scale).astype(np.float32)


def _poses(rs, n):
    xi = _twists(rs, n, 0.5)
    xi[:, 2] += 0.6  # object in front of the camera
    return np.array(jse3.se3_expm(jnp.asarray(xi)))


def test_so3_hat():
    xi = _twists(np.random.RandomState(0), 5, 1.0)
    close(tse3.so3_hat(torch.from_numpy(xi[:, 3:])), jse3.so3_hat(xi[:, 3:]))


@pytest.mark.parametrize("scale", [1e-6, 1e-3, 0.3, 2.0])
def test_se3_expm(scale):
    """Covers both sides of the Taylor switch (theta^2 < 1e-8)."""
    xi = _twists(np.random.RandomState(1), 16, scale)
    close(tse3.se3_expm(torch.from_numpy(xi)), jse3.se3_expm(jnp.asarray(xi)))


def test_se3_inverse_and_increment():
    rs = np.random.RandomState(2)
    T = _poses(rs, 8)
    d = _twists(rs, 8, 0.05)
    close(tse3.se3_inverse(torch.from_numpy(T)), jse3.se3_inverse(T))
    out_t = tse3.se3_increment(torch.from_numpy(T), torch.from_numpy(d))
    for approx in (False, True):  # the approximate-gradient expm: same forward
        close(out_t, jse3.se3_increment(jnp.asarray(T), jnp.asarray(d), approx))


def test_coords_grid_and_backproject():
    rs = np.random.RandomState(3)
    close(tproj.coords_grid(5, 7), jproj.coords_grid(5, 7))
    depth = rs.uniform(0.3, 1.0, (2, 6, 9)).astype(np.float32)
    K = np.asarray([[120.0, 118.0, 4.5, 3.0], [90.0, 95.0, 4.0, 2.5]], np.float32)
    close(tproj.backproject(torch.from_numpy(depth), torch.from_numpy(K)),
          jproj.backproject(depth, K))


def test_project_with_jacobian_and_depth_guard():
    rs = np.random.RandomState(4)
    pts = rs.randn(2, 50, 3).astype(np.float32) * 0.1
    pts[..., 2] += 0.5
    pts[0, :5, 2] = -0.2  # behind the camera: inverse depth zeroed
    K = np.asarray([[[572.0, 573.0, 160.0, 160.0]], [[150.0, 150.0, 48.0, 48.0]]],
                   np.float32)
    uv_t, jac_t = tproj.project(torch.from_numpy(pts), torch.from_numpy(K), True)
    uv_j, jac_j = jproj.project(pts, K, True)
    close(uv_t, uv_j)
    # Jacobian entries reach ~1e4 px/m: held to 1e-6 relative.
    np.testing.assert_allclose(jac_t.numpy(), np.asarray(jac_j), rtol=1e-6, atol=1e-5)


def test_transform_points_and_perturb_jacobian():
    rs = np.random.RandomState(5)
    T = _poses(rs, 3)
    sets = rs.randn(3, 40, 3).astype(np.float32) * 0.1
    single = rs.randn(3, 3).astype(np.float32)
    close(tproj.transform_points(torch.from_numpy(T), torch.from_numpy(sets)),
          jproj.transform_points(T, sets))
    close(tproj.transform_points(torch.from_numpy(T), torch.from_numpy(single)),
          jproj.transform_points(T, single))
    close(tproj.local_perturb_jacobian(torch.from_numpy(sets)),
          jproj.local_perturb_jacobian(sets))


@pytest.mark.parametrize("ratio", [1.0, 0.75])
def test_crop_params_intrinsics_and_source_coords(ratio):
    rs = np.random.RandomState(6)
    center = rs.uniform(100, 220, (4, 2)).astype(np.float32)
    lo = np.round(center - rs.uniform(10, 60, (4, 2))).astype(np.float32)
    hi = np.round(center + rs.uniform(10, 60, (4, 2))).astype(np.float32)
    bbox = np.concatenate([lo, hi], -1)
    cp_t = tcrop.reference_crop_params(torch.from_numpy(center), torch.from_numpy(bbox),
                                       0.4, ratio)
    cp_j = jcrop.reference_crop_params(center, bbox, 0.4, ratio)
    close(cp_t, cp_j)
    K = np.tile(np.asarray([[572.4, 573.6, 160.0, 160.0]], np.float32), (4, 1))
    close(tcrop.crop_intrinsics(torch.from_numpy(K), cp_t, 240),
          jcrop.crop_intrinsics(K, cp_j, 240))
    close(tcrop.crop_source_coords(cp_t, 24), jcrop.crop_source_coords(cp_j, 24))


def test_solve_spd_conditioned_nan_and_clamp():
    rs = np.random.RandomState(7)
    A = rs.randn(5, 6, 6).astype(np.float32)
    H = np.einsum("bij,bkj->bik", A, A) + 0.5 * np.eye(6, dtype=np.float32)
    H[:, :3, :3] *= 1e4  # pixel/metric unit mismatch the preconditioner fixes
    b = rs.randn(5, 6).astype(np.float32) * 10
    H[3] = -np.eye(6, dtype=np.float32)  # not SPD -> NaN -> zeroed
    b[4] *= 1e6                          # -> clamped to +-delta_clamp
    x_t = tlm.solve_spd(torch.from_numpy(H), torch.from_numpy(b), 0.5)
    x_j = jlm.solve_spd(jnp.asarray(H), jnp.asarray(b), 0.5)
    close(x_t, x_j)
    assert np.all(x_t[3].numpy() == 0.0)
    assert np.abs(x_t[4].numpy()).max() == pytest.approx(0.5)


def _lm_problem(rs, B=2, h=6, w=6):
    depth = rs.uniform(0.4, 0.7, (B, h, w)).astype(np.float32)
    depth[:, 0, 0] = 0.0  # invalid source depth
    K = np.tile(np.asarray([[60.0, 60.0, 3.0, 3.0]], np.float32), (B, 1))
    T = np.array(jse3.se3_expm(jnp.asarray(_twists(rs, B, 0.02))))
    target = (np.array(jproj.coords_grid(h, w))[None]
              + rs.randn(B, h, w, 2).astype(np.float32) * 0.5)
    weight = rs.uniform(0.0, 1.0, (B, h, w, 2)).astype(np.float32)
    return T, target, weight, depth, K


def test_pose_transform_coords():
    T, _, _, depth, K = _lm_problem(np.random.RandomState(8))
    c_t, v_t = tlm.pose_transform_coords(torch.from_numpy(T), torch.from_numpy(depth),
                                         torch.from_numpy(K))
    c_j, v_j = jlm.pose_transform_coords(T, depth, K)
    close(c_t, c_j)
    close(v_t, v_j)


@pytest.mark.parametrize("num_iters", [1, 2])
def test_reprojection_optim(num_iters):
    T, target, weight, depth, K = _lm_problem(np.random.RandomState(9))
    cfg_j = jlm.LMConfig()
    cfg_t = tlm.LMConfig()
    assert cfg_t._asdict() == {k: getattr(cfg_j, k) for k in cfg_t._fields}
    out_t = tlm.reprojection_optim(*(torch.from_numpy(a) for a in (T, target, weight, depth, K)),
                                   num_iters=num_iters, cfg=cfg_t)
    out_j = jlm.reprojection_optim(*(jnp.asarray(a) for a in (T, target, weight, depth, K)),
                                   num_iters=num_iters, cfg=cfg_j)
    close(out_t, out_j)
    assert np.abs(out_t.numpy() - T).max() > 1e-4  # it moved the pose
