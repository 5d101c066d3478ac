"""The whole eval slice: the port's `RNNPose.forward(train=False)` with
cached 3D features against the JAX package's, on the same scene, cached
features and converted weights, at the tiny config (render_iters=1,
gru_iters=2).

f32: Ti_pred within 1e-3 (the eval bound of the reference A/B,
PARITY.md). bf16 (the serving default): within 2e-3, looser because the two
frameworks round bf16 activations at different places and the untrained
recurrence carries those differences into the pose.
"""
import jax
import numpy as np
import pytest
import torch

import _torch_port_common as C
from rnnpose_tpu_torch.models.refiner import RefinerConfig
from rnnpose_tpu_torch.models.rnnpose import RNNPose, RNNPoseConfig


def _run_both(batch_size, mixed_precision, **refiner_over):
    inputs, kp = C.jax_scene(batch_size)
    d3, c3 = C.cached_3d(batch_size, inputs.mesh.verts.shape[0])
    over = dict(render_iters=1, gru_iters=2, mixed_precision=mixed_precision, **refiner_over)
    model, params = C.jax_model_and_params(inputs, kp, d3, c3, **over)
    out_j = jax.jit(lambda p, x: model.apply(
        p, x, train=False, cached_desc3d=d3, cached_ctx3d=c3))(params, inputs)
    port = C.port_model(params, **over)
    out_t = port(C.port_inputs(inputs), cached_desc3d=torch.from_numpy(d3),
                 cached_ctx3d=torch.from_numpy(c3))
    return inputs, out_j, out_t


def test_slice_f32_matches_jax():
    inputs, out_j, out_t = _run_both(2, False)
    T_j, T_t = np.asarray(out_j["Ti_pred"]), C.to_numpy(out_t["Ti_pred"])
    np.testing.assert_allclose(T_t, T_j, atol=1e-3)
    assert np.abs(T_t - np.asarray(inputs.T_init)).max() > 1e-3  # it refined
    rj, rt = out_j["refiner"], out_t["refiner"]
    np.testing.assert_allclose(C.to_numpy(rt.Tij_history), np.asarray(rj.Tij_history), atol=1e-3)
    np.testing.assert_allclose(C.to_numpy(rt.intrinsics_history),
                               np.asarray(rj.intrinsics_history), rtol=1e-5)
    # On the CPU the JAX refiner rasterizes with its scan sweep, which
    # evaluates depth as an XLA dot (a fused multiply-add chain); the kernel
    # contract rounds each multiply and add. Near-parallel faces cancel, so
    # the two differ by up to ~1e-4 at a few pixels (the sweep itself is
    # held to 1e-5 against the Pallas kernel in test_torch_port_raster.py).
    np.testing.assert_allclose(C.to_numpy(rt.syn_depth_history),
                               np.asarray(rj.syn_depth_history), atol=1e-4)
    np.testing.assert_allclose(C.to_numpy(rt.syn_img), np.asarray(rj.syn_img), atol=1e-4)
    np.testing.assert_allclose(C.to_numpy(rt.image_crop), np.asarray(rj.image_crop), atol=1e-5)
    np.testing.assert_allclose(C.to_numpy(rt.flow_history), np.asarray(rj.flow_history), atol=1e-3)
    np.testing.assert_allclose(C.to_numpy(rt.weight), np.asarray(rj.weight), atol=1e-3)
    assert rt.flow_history.shape == rj.flow_history.shape


def test_slice_bf16_matches_jax_loosely():
    _, out_j, out_t = _run_both(1, True)
    np.testing.assert_allclose(C.to_numpy(out_t["Ti_pred"]), np.asarray(out_j["Ti_pred"]),
                               atol=2e-3)


def test_slice_without_corr_weight_matches_jax():
    """`with_corr_weight=False`: the LM weight is the rendered depth mask
    on the LM's grid, and the model has no similarity temperature."""
    _, out_j, out_t = _run_both(1, False, with_corr_weight=False)
    np.testing.assert_allclose(C.to_numpy(out_t["Ti_pred"]), np.asarray(out_j["Ti_pred"]),
                               atol=1e-3)
    w_t, w_j = C.to_numpy(out_t["refiner"].weight), np.asarray(out_j["refiner"].weight)
    assert set(np.unique(w_t)) <= {0.0, 1.0}
    assert (w_t != w_j).mean() < 0.01  # depth differs by ~1e-4 at a few edge pixels


def _tiny_port(**over):
    return RNNPose(RNNPoseConfig(refiner=RefinerConfig(**C.refiner_kwargs(**over))))


@pytest.mark.parametrize("over,call", [
    (dict(corr_weight_res="full"), {}),
    ({}, dict(train=True)),
    ({}, dict(cached=False)),
])
def test_modes_outside_the_slice_raise(over, call):
    """The inputs the JAX package rejects raise: a full-res similarity under
    the 1/8-grid LM (ValueError), a training forward without a
    correspondence set (the JAX package's assert), and a forward with
    neither cached 3D features nor a pyramid to compute them from. The
    parity preset, backface culling and other crop sizes run
    (tests/test_torch_port_parity.py), the uncached forward too
    (tests/test_torch_port_engine.py), training in
    tests/test_torch_port_train_*.py."""
    error, match = ValueError, "corr_weight_res='eighth'"
    if call.get("train"):
        match = "requires a CorrespondenceSet"
    if call.get("cached") is False:
        match = "needs inputs.pyramid"
    from rnnpose_tpu_torch.data.synthetic import SyntheticConfig, make_synthetic_inputs

    inputs = make_synthetic_inputs(SyntheticConfig(**C.TINY_SCENE))._replace(pyramid=None)
    d3, c3 = (torch.from_numpy(a) for a in C.cached_3d(1, inputs.mesh.verts.shape[0]))
    if call.get("cached") is False:
        d3 = c3 = None
    with pytest.raises(error, match=match):
        _tiny_port(**over)(inputs, train=call.get("train", False),
                           cached_desc3d=d3, cached_ctx3d=c3)


def test_refiner_config_mirrors_jax_fields():
    import dataclasses

    from rnnpose_tpu.models.refiner import RefinerConfig as JRefiner
    from rnnpose_tpu.models.rnnpose import RNNPoseConfig as JConfig

    def defaults(cls):
        return {f.name: f.default for f in dataclasses.fields(cls)}

    assert defaults(RefinerConfig) == defaults(JRefiner)
    assert set(defaults(RNNPoseConfig)) == set(defaults(JConfig))
