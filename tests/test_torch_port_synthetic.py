"""The port's synthetic scene equals the JAX package's
`make_synthetic_inputs` at the tiny config, with and without the
correspondence set: same RandomState draws in the same order, the observed
image rendered by the port's rasterizer."""
import numpy as np
import pytest
import torch

import _torch_port_common as C
from rnnpose_tpu.data.poses import sample_noisy_poses as j_sample
from rnnpose_tpu_torch.data.poses import sample_noisy_poses as t_sample
from rnnpose_tpu_torch.data.synthetic import SyntheticConfig, make_synthetic_inputs


@pytest.mark.parametrize("batch_size", [1, 2])
def test_scene_matches_jax(batch_size):
    ref, _ = C.jax_scene(batch_size)
    out = make_synthetic_inputs(SyntheticConfig(batch_size=batch_size, **C.TINY_SCENE))
    for name in ("intrinsics", "T_init", "T_gt", "model_points", "point_valid"):
        np.testing.assert_array_equal(C.to_numpy(getattr(out, name)),
                                      np.asarray(getattr(ref, name)), err_msg=name)
    # The foreground is the shaded raster (attrs held to 1e-4, as in the
    # raster tests). The pixel noise is drawn after it, one triple per
    # covered pixel, so the image agrees only if both rasters covered exactly
    # the same pixels.
    np.testing.assert_allclose(C.to_numpy(out.image), np.asarray(ref.image), atol=1e-4)
    for name in ("verts", "faces", "colors", "vert_valid", "face_valid", "normals"):
        np.testing.assert_array_equal(C.to_numpy(getattr(out.mesh, name)),
                                      np.asarray(getattr(ref.mesh, name)), err_msg=name)
    assert (C.to_numpy(out.image).max(-1) > 0.1).mean() > 0.02  # object visible


def test_noisy_pose_sampling_matches_jax():
    T = np.tile(np.eye(4, dtype=np.float32), (3, 1, 1))
    T[:, 2, 3] = 0.6
    np.testing.assert_array_equal(t_sample(T, np.random.RandomState(4)),
                                  j_sample(T, np.random.RandomState(4)))


def test_correspondence_set_matches_jax():
    """`with_corr=True` continues the same RandomState stream in the same
    order: both packages build the same correspondence set (and the same
    image, drawn before it)."""
    from rnnpose_tpu.data.synthetic import SyntheticConfig as JConfig
    from rnnpose_tpu.data.synthetic import make_synthetic_inputs as j_make

    kw = dict(batch_size=2, num_corr=64, kp_layers=3, kp_dl=0.015, **C.TINY_SCENE)
    ref, _ = j_make(JConfig(**kw), with_corr=True)
    out = make_synthetic_inputs(SyntheticConfig(**kw), with_corr=True)
    for name in ref.corr._fields:
        np.testing.assert_array_equal(C.to_numpy(getattr(out.corr, name)),
                                      np.asarray(getattr(ref.corr, name)), err_msg=name)
    np.testing.assert_allclose(C.to_numpy(out.image), np.asarray(ref.image), atol=1e-4)
    assert out.corr.px.dtype == out.corr.model_idx.dtype == torch.int64
    assert float(out.corr.is_bg.sum()) == 2 * (64 - int(64 * 0.9))
