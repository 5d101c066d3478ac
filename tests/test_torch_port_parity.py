"""The non-fused eval forward against the JAX package: the reference-exact
parity preset (`apply_parity_preset`: full-res LM and similarity, f32,
`legacy_squash_255`, full-res SuperPoint tail), backface culling, a crop
that is not a multiple of 16, and the full-res LM with the 1/8-grid
similarity; plus the ops they add (`convex_upsample`, `downsample_flow`).

Same scene, cached 3D features and converted weights on both sides, at the
tiny config with render_iters=1, gru_iters=2, f32. On the CPU the JAX
refiner rasterizes with its scan sweep and the port with its plain sweep.
Tolerances: Ti_pred, Tij_history, the flow history and the last weight
1e-3 (the eval bound of the reference A/B, PARITY.md); syn_depth 1e-4 (the
scan evaluates depth as an XLA dot, a fused multiply-add chain, the port
rounds each multiply and add: ~5e-5 at a few near-parallel faces).
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

import _torch_port_common as C
from rnnpose_tpu.config.defaults import apply_parity_preset as j_apply_parity_preset
from rnnpose_tpu.models import cfnet as jcfnet
from rnnpose_tpu.models.rnnpose import RNNPose as JRNNPose
from rnnpose_tpu.ops import upsample as jupsample
from rnnpose_tpu_torch import kernels
from rnnpose_tpu_torch.models import cfnet as tcfnet
from rnnpose_tpu_torch.models.convert import load_jax_params
from rnnpose_tpu_torch.models.refiner import RefinerConfig
from rnnpose_tpu_torch.models.rnnpose import RNNPose, RNNPoseConfig, apply_parity_preset
from rnnpose_tpu_torch.ops import upsample as tupsample


def test_convex_upsample_matches_jax():
    rs = np.random.RandomState(11)
    flow = rs.randn(2, 5, 6, 2).astype(np.float32)
    mask = (3.0 * rs.randn(2, 5, 6, 9 * 8 * 8)).astype(np.float32)
    ref = jupsample.convex_upsample(flow, mask, factor=8)
    out = tupsample.convex_upsample(torch.from_numpy(flow), torch.from_numpy(mask), factor=8)
    assert out.shape == (2, 40, 48, 2)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)
    np.testing.assert_array_equal(tupsample.unfold3x3(torch.from_numpy(flow)).numpy(),
                                  np.asarray(jupsample.unfold3x3(flow)))


def test_downsample_flow_matches_jax():
    flow = (5.0 * np.random.RandomState(12).randn(2, 48, 40, 2)).astype(np.float32)
    ref = jcfnet.downsample_flow(flow, 8)
    out = tcfnet.downsample_flow(torch.from_numpy(flow), 8)
    assert out.shape == (2, 6, 5, 2)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)


def test_parity_preset_mirrors_jax():
    from rnnpose_tpu.models.rnnpose import RNNPoseConfig as JConfig

    t = apply_parity_preset(RNNPoseConfig())
    j = j_apply_parity_preset(JConfig())
    assert t.desc2d_eval_tail_res == j.desc2d_eval_tail_res == "full"
    assert dataclasses.asdict(t.refiner) == dataclasses.asdict(j.refiner)


def _run_both(parity, batch_size=2, **over):
    """The JAX RNNPose and the port on one scene, weights and cached 3D
    features; `parity` applies each package's parity preset."""
    inputs, kp = C.jax_scene(batch_size)
    d3, c3 = C.cached_3d(batch_size, inputs.mesh.verts.shape[0])
    over = dict(render_iters=1, gru_iters=2, mixed_precision=False, **over)
    model, params = C.jax_model_and_params(inputs, kp, d3, c3, **over)
    cfg_t = RNNPoseConfig(refiner=RefinerConfig(**C.refiner_kwargs(**over)))
    if parity:
        model = JRNNPose(j_apply_parity_preset(model.cfg))
        cfg_t = apply_parity_preset(cfg_t)
    out_j = jax.jit(lambda p, x: model.apply(
        p, x, train=False, cached_desc3d=d3, cached_ctx3d=c3))(params, inputs)
    port = load_jax_params(RNNPose(cfg_t), params).eval()
    out_t = port(C.port_inputs(inputs), cached_desc3d=torch.from_numpy(d3),
                 cached_ctx3d=torch.from_numpy(c3))
    return inputs, out_j, out_t


@pytest.mark.parametrize("parity,over,flow_res", [
    (True, {}, "full"),                                    # the --parity preset
    (True, dict(backface_cull=True), "full"),              # parity + compaction
    (False, dict(backface_cull=True), "eighth"),           # serving + compaction
    (False, dict(zoom_crop_size=40), "eighth"),            # crop not a multiple of 16
    (False, dict(lm_res="full"), "full"),                  # full LM, 1/8 similarity
], ids=["parity", "parity_backface", "backface", "crop40", "lm_full"])
def test_non_fused_forward_matches_jax(parity, over, flow_res):
    before = kernels.LAUNCHES["zbuffer_sweep_tiled"], kernels.LAUNCHES["zbuffer_sweep_rows_attrs"]
    inputs, out_j, out_t = _run_both(parity, **over)
    assert (kernels.LAUNCHES["zbuffer_sweep_tiled"],
            kernels.LAUNCHES["zbuffer_sweep_rows_attrs"]) == before  # CPU: plain sweeps
    T_j, T_t = np.asarray(out_j["Ti_pred"]), C.to_numpy(out_t["Ti_pred"])
    np.testing.assert_allclose(T_t, T_j, atol=1e-3)
    assert np.abs(T_t - np.asarray(inputs.T_init)).max() > 1e-3  # it refined
    rj, rt = out_j["refiner"], out_t["refiner"]
    S = rt.syn_depth_history.shape[-1]
    s = S if flow_res == "full" else S // 8
    assert rt.flow_history.shape == rj.flow_history.shape == (2, 2, s, s, 2)
    np.testing.assert_allclose(C.to_numpy(rt.Tij_history), np.asarray(rj.Tij_history), atol=1e-3)
    np.testing.assert_allclose(C.to_numpy(rt.flow_history), np.asarray(rj.flow_history), atol=1e-3)
    np.testing.assert_allclose(C.to_numpy(rt.weight), np.asarray(rj.weight), atol=1e-3)
    np.testing.assert_allclose(C.to_numpy(rt.syn_depth_history),
                               np.asarray(rj.syn_depth_history), atol=1e-4)
    np.testing.assert_allclose(C.to_numpy(rt.intrinsics_history),
                               np.asarray(rj.intrinsics_history), rtol=1e-5)
    np.testing.assert_allclose(C.to_numpy(rt.syn_img), np.asarray(rj.syn_img), atol=1e-4)
    assert float(rt.valid_mask.mean()) > 0.05


def test_full_res_modes_need_the_full_flow():
    """As in the JAX package: the full-res LM or similarity without the
    full-res flow is a ValueError."""
    from rnnpose_tpu_torch.data.synthetic import SyntheticConfig, make_synthetic_inputs

    inputs = make_synthetic_inputs(SyntheticConfig(**C.TINY_SCENE))
    d3, c3 = (torch.from_numpy(a) for a in C.cached_3d(1, inputs.mesh.verts.shape[0]))
    cfg = apply_parity_preset(RNNPoseConfig(refiner=RefinerConfig(**C.refiner_kwargs())))
    model = RNNPose(cfg)
    with pytest.raises(ValueError, match="emit_full_flow=False"):
        model.motion_net(inputs.image, inputs.T_init, inputs.intrinsics, inputs.mesh,
                         c3, d3, torch.zeros(1, 96, 96, 32), emit_full_flow=False)
