"""Shared fixtures of the `test_torch_port_train*` files: the
`__graft_entry__._tiny_setup` training scene (with its correspondence set)
in f32, the JAX model and params built from it, and the same inputs and
weights as the port's."""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

import _torch_port_common as C


def jax_train_setup(batch_size: int, render_iters: int):
    """(JAX RNNPose in f32, its params with both towers and biases off zero
    (`offset_biases`), jnp inputs with the correspondence set)."""
    import jax

    from __graft_entry__ import _tiny_setup
    from rnnpose_tpu.models.rnnpose import RNNPose

    model, inputs = _tiny_setup(batch_size=batch_size, train=True, render_iters=render_iters)
    cfg = dataclasses.replace(model.cfg, refiner=dataclasses.replace(
        model.cfg.refiner, mixed_precision=False))
    model = RNNPose(cfg)
    params = jax.jit(lambda k: model.init(k, inputs, train=False))(jax.random.PRNGKey(0))
    return model, offset_biases(jax.device_get(params)), inputs


def offset_biases(params, seed: int = 0, scale: float = 0.02):
    """The params with every bias moved off zero (seeded normal offsets).
    Zero biases put each ReLU after a conv at its kink wherever the conv's
    input is ~0, e.g. the motion encoder's flow input at the identity pose
    (rounding noise of ~1e-6 px, which differs between XLA and torch), so
    the subgradient, and with it the bias gradient, would depend on that
    noise's sign."""
    import jax

    rs = np.random.RandomState(seed)

    def move(path, x):
        if getattr(path[-1], "key", None) != "bias":
            return x
        return (np.asarray(x) + rs.randn(*np.shape(x)) * scale).astype(np.float32)

    return jax.tree_util.tree_map_with_path(move, params)


def port_config(jcfg):
    """The port's RNNPoseConfig mirroring a JAX one (losses included)."""
    from rnnpose_tpu_torch.models.kpconv_net import KPConvConfig
    from rnnpose_tpu_torch.models.refiner import RefinerConfig
    from rnnpose_tpu_torch.models.rnnpose import RNNPoseConfig
    from rnnpose_tpu_torch.train.losses import CircleLossConfig, RefinerLossConfig

    return RNNPoseConfig(
        desc_kp=KPConvConfig(**dataclasses.asdict(jcfg.desc_kp)),
        ctx_kp=KPConvConfig(**dataclasses.asdict(jcfg.ctx_kp)),
        refiner=RefinerConfig(**dataclasses.asdict(jcfg.refiner)),
        circle=CircleLossConfig(**dataclasses.asdict(jcfg.circle)),
        motion=RefinerLossConfig(**dataclasses.asdict(jcfg.motion)),
    )


def port_model(jmodel, params):
    from rnnpose_tpu_torch.models.convert import load_jax_params
    from rnnpose_tpu_torch.models.rnnpose import RNNPose

    return load_jax_params(RNNPose(port_config(jmodel.cfg)), params)


def port_train_inputs(inputs):
    """The JAX training inputs as the port's RNNPoseInputs (pyramid and
    correspondence set included)."""
    from rnnpose_tpu_torch.models.kpconv_net import PointPyramid
    from rnnpose_tpu_torch.models.rnnpose import CorrespondenceSet

    def t(a):
        return torch.as_tensor(np.array(a))

    pyr = inputs.pyramid
    pyramid = PointPyramid([t(a) for a in pyr.points], [t(a) for a in pyr.masks],
                           *([t(a).long() for a in arrs]
                             for arrs in (pyr.neighbors, pyr.pools, pyr.upsamples)))
    c = inputs.corr
    corr = CorrespondenceSet(px=t(c.px).long(), src_pts=t(c.src_pts), tgt_pts=t(c.tgt_pts),
                             model_idx=t(c.model_idx).long(), is_bg=t(c.is_bg),
                             valid=t(c.valid))
    return C.port_inputs(inputs)._replace(pyramid=pyramid, corr=corr)
