"""The per-class eval entry point against the JAX package: the full weight
bridge, the uncached forward (3D towers + refiner), `InferenceEngine` and
the synthetic scene's pyramid.

* `load_jax_params` loads the whole JAX `RNNPose` tree, towers included,
  strictly; `export_reference_state_dict` loads into the port's `RNNPose`
  with zero missing and zero unexpected keys.
* The uncached `forward(train=False)` on the `__graft_entry__._tiny_setup`
  scene (B=2; render_iters=1, f32) equals JAX's `model.apply(params,
  inputs, train=False)` with no caches: Ti_pred within 1e-3 (the bound of
  tests/test_full_model_rehearsal.py); `encode_3d` meets the towers'
  bounds (5e-4 descriptors, 2e-3 context).
* `InferenceEngine` runs `encode_3d` once per class; `evict` clears it.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

import _torch_port_common as C
from rnnpose_tpu.models.convert import export_reference_state_dict
from rnnpose_tpu_torch.data.synthetic import (
    SyntheticConfig, kpconv_config, make_synthetic_inputs)
from rnnpose_tpu_torch.models.convert import load_jax_params
from rnnpose_tpu_torch.models.engine import InferenceEngine
from rnnpose_tpu_torch.models.kpconv_net import KPConvConfig, PointPyramid
from rnnpose_tpu_torch.models.refiner import RefinerConfig
from rnnpose_tpu_torch.models.rnnpose import RNNPose, RNNPoseConfig, init_random_


def _port_config(jcfg):
    """The port's RNNPoseConfig mirroring a JAX one."""
    return RNNPoseConfig(
        desc_kp=KPConvConfig(**dataclasses.asdict(jcfg.desc_kp)),
        ctx_kp=KPConvConfig(**dataclasses.asdict(jcfg.ctx_kp)),
        refiner=RefinerConfig(**dataclasses.asdict(jcfg.refiner)),
    )


def _port_pyramid(pyr):
    def t(arrs):
        return [torch.as_tensor(np.array(a)) for a in arrs]

    return PointPyramid(t(pyr.points), t(pyr.masks), *([x.long() for x in t(ts)] for ts in (
        pyr.neighbors, pyr.pools, pyr.upsamples)))


@pytest.fixture(scope="module")
def tiny():
    """The `_tiny_setup` scene at B=2, f32, one render iteration: the JAX
    model, its full params (towers included) and its outputs with no
    caches."""
    from __graft_entry__ import _tiny_setup
    from rnnpose_tpu.models.rnnpose import RNNPose as JRNNPose

    model, inputs = _tiny_setup(batch_size=2, train=False, render_iters=1)
    cfg = dataclasses.replace(model.cfg, refiner=dataclasses.replace(
        model.cfg.refiner, mixed_precision=False))
    model = JRNNPose(cfg)
    params = jax.jit(lambda k: model.init(k, inputs, train=False))(jax.random.PRNGKey(0))
    params = jax.device_get(params)
    out = jax.jit(lambda p, x: model.apply(p, x, train=False))(params, inputs)
    enc = jax.jit(lambda p, pyr: model.apply(p, pyr, method=JRNNPose.encode_3d))(
        params, inputs.pyramid)
    port_in = C.port_inputs(inputs)._replace(pyramid=_port_pyramid(inputs.pyramid))
    return cfg, params, inputs, port_in, out, enc


def test_full_tree_loads_strictly(tiny):
    cfg, params, *_ = tiny
    port = load_jax_params(RNNPose(_port_config(cfg)), params)
    p = params["params"]
    tower = port.hybrid_desc_net.corr_fea_extractor_3d
    np.testing.assert_array_equal(tower.encoder_blocks[0].KPConv.kernel_points.numpy(),
                                  p["hybrid"]["desc3d"]["enc_simple"]["KPConv"]["kernel_points"])
    np.testing.assert_array_equal(
        port.ctx_fea_net.context_fea_extractor_3d.bottle.weight[..., 0].detach().numpy().T,
        p["ctx"]["ctx3d"]["bottle"]["kernel"])
    # A tower that is present must be complete.
    pruned = jax.tree.map(lambda x: x, params)
    del pruned["params"]["ctx"]["ctx3d"]["enc_resnetb_1a"]["unary2"]
    with pytest.raises(RuntimeError, match="Missing key"):
        load_jax_params(RNNPose(_port_config(cfg)), pruned)


def test_reference_export_loads_with_no_missing_or_unexpected_keys(tiny):
    cfg, params, *_ = tiny
    ref = export_reference_state_dict(params, cfg.desc_kp.num_layers)
    port = RNNPose(_port_config(cfg))
    res = port.load_state_dict({k: torch.from_numpy(np.array(v, np.float32))
                                for k, v in ref.items()}, strict=False)
    assert res.missing_keys == [] and res.unexpected_keys == []
    assert any(k.startswith("ctx_fea_net.context_fea_extractor_3d.") for k in ref)


def test_uncached_forward_matches_jax(tiny):
    cfg, params, inputs, port_in, out_j, (d3_j, c3_j) = tiny
    port = load_jax_params(RNNPose(_port_config(cfg)), params).eval()
    d3, c3 = port.encode_3d(port_in.pyramid)
    np.testing.assert_allclose(d3.numpy(), np.asarray(d3_j), atol=5e-4, rtol=0)
    np.testing.assert_allclose(c3.numpy(), np.asarray(c3_j), atol=2e-3, rtol=0)
    out = port(port_in)
    T_j, T_t = np.asarray(out_j["Ti_pred"]), C.to_numpy(out["Ti_pred"])
    assert T_t.shape == (2, 4, 4)
    np.testing.assert_allclose(T_t, T_j, atol=1e-3)
    assert np.abs(T_t - np.asarray(inputs.T_init)).max() > 1e-3  # it refined


def test_engine_encodes_once_per_class_and_evicts():
    scene = SyntheticConfig(kp_layers=3, kp_dl=0.015, **C.TINY_SCENE)
    inputs = make_synthetic_inputs(scene)
    kp = kpconv_config(scene)
    model = RNNPose(RNNPoseConfig(
        desc_kp=dataclasses.replace(kp, final_feats_dim=32),
        ctx_kp=dataclasses.replace(kp, final_feats_dim=256, normalize_output=False),
        refiner=RefinerConfig(**C.refiner_kwargs(render_iters=1, gru_iters=1))))
    init_random_(model, torch.Generator().manual_seed(0))
    engine = InferenceEngine(model)
    T1 = engine.refine("ico", inputs)["Ti_pred"]
    T2 = engine.refine("ico", inputs._replace(T_init=inputs.T_gt))["Ti_pred"]
    assert engine.encode_3d_calls == 1
    d3, c3 = engine.class_features("ico", None)  # cached: the pyramid is not read
    assert d3.shape == (1, 256, 32) and c3.shape == (1, 256, 256)
    assert torch.equal(T1, model(inputs)["Ti_pred"])  # same as the uncached forward
    assert not torch.equal(T1, T2)
    engine.refine("other", inputs)
    assert engine.encode_3d_calls == 2
    engine.evict("ico")
    engine.refine("ico", inputs)
    assert engine.encode_3d_calls == 3
    engine.evict()
    engine.refine("other", inputs)
    engine.refine("ico", inputs)
    assert engine.encode_3d_calls == 5


@pytest.mark.parametrize("batch_size", [1, 2])
def test_synthetic_pyramid_equals_jax(batch_size, monkeypatch):
    """Both packages on the numpy pyramid path (the native backends may
    order neighbours at equal distance differently from it)."""
    import rnnpose_tpu.data.pyramid as jpyr
    import rnnpose_tpu_torch.data.pyramid as tpyr

    monkeypatch.setattr(jpyr, "_cpp", lambda: None)
    monkeypatch.setattr(tpyr, "_cpp", lambda: None)
    scene = dict(kp_layers=3, kp_dl=0.015, **C.TINY_SCENE)
    ref, _ = C.jax_scene(batch_size)
    out = make_synthetic_inputs(SyntheticConfig(batch_size=batch_size, **scene)).pyramid
    assert out.num_levels == len(ref.pyramid.points) == 3
    for name in ("points", "masks", "neighbors", "pools", "upsamples"):
        for t, j in zip(getattr(out, name), getattr(ref.pyramid, name)):
            np.testing.assert_array_equal(t.numpy(), np.asarray(j), err_msg=name)
    assert out.points[0].shape == (batch_size, 256, 3)
    assert all(p.shape[1] % 8 == 0 for p in out.points[1:])
