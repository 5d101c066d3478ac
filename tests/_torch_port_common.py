"""Shared fixtures of the `test_torch_port_*` files: one tiny RNNPose scene
and model built by both packages from the same seeds.

The JAX side runs as the JAX package's own tests run it on the CPU (its
refiner takes the unfused scan raster there); the port runs on the CPU with
the plain raster sweep. Inputs and cached 3D features are made with numpy
and handed to both.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

torch.set_num_threads(1)

# The `__graft_entry__._tiny_setup` scene: 96^2 image, 48^2 crop, 256/512
# mesh budget, chunk 64, 3 corr levels.
TINY_SCENE = dict(
    image_size=96, num_verts=256, num_faces=512, subdivisions=2,
    fx=150.0, fy=150.0,
)
TINY_REFINER = dict(zoom_crop_size=48, corr_levels=3, raster_chunk=64)


def jax_scene(batch_size: int = 1):
    """(RNNPoseInputs of jnp leaves, KPConvConfig) from the JAX package."""
    import jax
    import jax.numpy as jnp

    from rnnpose_tpu.data.synthetic import SyntheticConfig, make_synthetic_inputs

    cfg = SyntheticConfig(batch_size=batch_size, num_corr=64, kp_layers=3,
                          kp_dl=0.015, **TINY_SCENE)
    inputs, kp_cfg = make_synthetic_inputs(cfg, with_corr=False)
    return jax.tree.map(jnp.asarray, inputs), kp_cfg


def cached_3d(batch_size: int, num_verts: int, seed: int = 0):
    """Seeded stand-ins for the towers' outputs: desc3d (B, V, 32) unit-norm
    and ctx3d (B, V, 256)."""
    rs = np.random.RandomState(seed)
    d3 = rs.randn(batch_size, num_verts, 32).astype(np.float32)
    d3 /= np.linalg.norm(d3, axis=-1, keepdims=True)
    c3 = rs.randn(batch_size, num_verts, 256).astype(np.float32)
    return d3, c3


def refiner_kwargs(**over):
    kw = dict(TINY_REFINER)
    kw.update(over)
    return kw


def jax_model_and_params(inputs, kp_cfg, d3, c3, **refiner_over):
    """The JAX RNNPose at the tiny config and its params (jitted init with
    cached 3D features: no KPConv tower is built)."""
    import jax

    from rnnpose_tpu.models.refiner import RefinerConfig
    from rnnpose_tpu.models.rnnpose import RNNPose, RNNPoseConfig

    cfg = RNNPoseConfig(
        desc_kp=dataclasses.replace(kp_cfg, final_feats_dim=32),
        ctx_kp=dataclasses.replace(kp_cfg, final_feats_dim=256,
                                   normalize_output=False),
        refiner=RefinerConfig(**refiner_kwargs(**refiner_over)),
    )
    model = RNNPose(cfg)
    params = jax.jit(
        lambda k: model.init(k, inputs, train=False, cached_desc3d=d3,
                             cached_ctx3d=c3)
    )(jax.random.PRNGKey(0))
    return model, jax.device_get(params)


def port_model(params, **refiner_over):
    """The port's RNNPose at the same config, with the converted params."""
    from rnnpose_tpu_torch.models.convert import load_jax_params
    from rnnpose_tpu_torch.models.refiner import RefinerConfig
    from rnnpose_tpu_torch.models.rnnpose import RNNPose, RNNPoseConfig

    model = RNNPose(RNNPoseConfig(
        refiner=RefinerConfig(**refiner_kwargs(**refiner_over))))
    return load_jax_params(model, params).eval()


def port_inputs(inputs):
    """The JAX package's numpy inputs as the port's RNNPoseInputs."""
    from rnnpose_tpu_torch.models.refiner import MeshAssets
    from rnnpose_tpu_torch.models.rnnpose import RNNPoseInputs

    t = lambda a: torch.as_tensor(np.array(a))  # noqa: E731
    m = inputs.mesh
    return RNNPoseInputs(
        image=t(inputs.image), intrinsics=t(inputs.intrinsics),
        T_init=t(inputs.T_init), T_gt=t(inputs.T_gt),
        mesh=MeshAssets(
            verts=t(m.verts), faces=t(np.asarray(m.faces, np.int64)),
            colors=t(m.colors), vert_valid=t(m.vert_valid),
            face_valid=t(m.face_valid), normals=t(m.normals),
        ),
        model_points=t(inputs.model_points), point_valid=t(inputs.point_valid),
    )


def to_numpy(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
