"""The weight bridge: flax params -> the port's state_dict, strictly, and
key by key equal to the JAX package's reference torch export, the KPConv
towers included."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

import _torch_port_common as C
from rnnpose_tpu.models.convert import export_reference_state_dict
from rnnpose_tpu_torch.models.convert import flax_to_state_dict, load_jax_params
from rnnpose_tpu_torch.data.synthetic import SyntheticConfig, kpconv_config
from rnnpose_tpu_torch.models.refiner import RefinerConfig
from rnnpose_tpu_torch.models.rnnpose import RNNPose, RNNPoseConfig


@pytest.fixture(scope="module")
def full_params():
    """Params of the whole tiny JAX model, KPConv towers included."""
    import dataclasses

    from rnnpose_tpu.models.rnnpose import RNNPose as JRNNPose
    from rnnpose_tpu.models.rnnpose import RNNPoseConfig as JConfig
    from rnnpose_tpu.models.refiner import RefinerConfig as JRefiner

    inputs, kp = C.jax_scene(1)
    cfg = JConfig(
        desc_kp=dataclasses.replace(kp, final_feats_dim=32),
        ctx_kp=dataclasses.replace(kp, final_feats_dim=256, normalize_output=False),
        refiner=JRefiner(render_iters=1, gru_iters=1, **C.TINY_REFINER),
    )
    model = JRNNPose(cfg)
    params = jax.jit(lambda k: model.init(k, inputs, train=False))(jax.random.PRNGKey(0))
    return jax.device_get(params), kp.num_layers


def _port(**over):
    """The port's RNNPose with the towers of the tiny scene (3 layers,
    widths 64)."""
    kp = kpconv_config(SyntheticConfig(kp_layers=3, kp_dl=0.015, **C.TINY_SCENE))
    return RNNPose(RNNPoseConfig(
        desc_kp=dataclasses.replace(kp, final_feats_dim=32),
        ctx_kp=dataclasses.replace(kp, final_feats_dim=256, normalize_output=False),
        refiner=RefinerConfig(**C.refiner_kwargs(**over))))


@pytest.mark.parametrize("mixed_precision", [True, False])
def test_state_dict_equals_reference_export(full_params, mixed_precision):
    params, num_layers = full_params
    ref = export_reference_state_dict(params, num_layers)
    port = load_jax_params(_port(mixed_precision=mixed_precision), params)
    sd = port.state_dict()
    assert set(sd) == set(ref)  # towers included: nothing missing, nothing extra
    for k, v in sd.items():
        assert tuple(v.shape) == ref[k].shape, k
        np.testing.assert_array_equal(v.numpy(), ref[k], err_msg=k)


def test_conv_kernels_become_oihw(full_params):
    params, _ = full_params
    sd = flax_to_state_dict(params)
    k = params["params"]["motion"]["inner"]["cf_step"]["update_block"]["gru"]["convz_h"]["kernel"]
    w = sd["motion_net.cf_net.update_block.gru.convz1.weight"]
    assert k.shape == (1, 5, 384, 128) and w.shape == (128, 384, 1, 5)
    np.testing.assert_array_equal(w[3, 7, 0, 2], k[0, 2, 7, 3])
    assert sd["motion_net.sigma.0"].shape == (1,)


def test_load_is_strict(full_params):
    params, _ = full_params
    pruned = jax.tree.map(lambda x: x, params)
    del pruned["params"]["motion"]["inner"]["cf_step"]["update_block"]["mask2"]
    with pytest.raises(RuntimeError, match="Missing key"):
        load_jax_params(_port(), pruned)
    with pytest.raises(RuntimeError, match="size mismatch"):
        load_jax_params(_port(corr_levels=4), params)  # built for 3 levels
