"""The public helpers of the JAX modules that the port adds under the same
module names, against the JAX functions on the same seeded inputs: equal,
or within 1e-6 where the two packages' arithmetic differs in rounding
(bound stated per test). `tools/eval.evaluate_frames` is held to the JAX
package's in `test_torch_port_eval_runner.py`; `export_reference_state_dict`
in `test_torch_port_pretrained.py`.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_port_common  # noqa: F401  (pins torch to one thread)

TOL = 1e-6


def _t(a):
    return torch.from_numpy(np.array(a))


def _masks():
    rs = np.random.RandomState(0)
    m = (rs.rand(3, 20, 28) > 0.97).astype(np.float32)
    m[1] = 0.0  # empty: the full image box
    m[2, 4:9, 7:21] = 1.0
    return m


def test_crop_helpers_equal_jax():
    from rnnpose_tpu.geometry import crop as J
    from rnnpose_tpu_torch.geometry import crop as T

    m = _masks()
    np.testing.assert_array_equal(T.mask_bbox(_t(m)).numpy(), np.asarray(J.mask_bbox(m)))
    np.testing.assert_array_equal(T.mask_bbox(_t(m > 0)).numpy(), np.asarray(J.mask_bbox(m > 0)))
    bbox = np.random.RandomState(1).rand(5, 4).astype(np.float32) * 50
    bbox[0] = [3.0, 3.0, 3.2, 3.1]  # half-side clamped to 1
    for margin in (0.4, 0.0, 1.5):
        np.testing.assert_allclose(T.square_crop_params(_t(bbox), margin).numpy(),
                                   np.asarray(J.square_crop_params(bbox, margin)), rtol=0,
                                   atol=TOL)
        np.testing.assert_allclose(T.mask_zoom_crop_params(_t(m), margin).numpy(),
                                   np.asarray(J.mask_zoom_crop_params(m, margin)), rtol=0,
                                   atol=TOL)


def test_solve_pose_from_flow_equals_jax():
    from rnnpose_tpu.geometry import lm as J
    from rnnpose_tpu_torch.geometry import lm as T

    rs = np.random.RandomState(2)
    T0 = np.tile(np.eye(4, dtype=np.float32), (2, 1, 1))
    T0[:, :3, 3] = [0.01, -0.02, 0.0]
    flow = (rs.randn(2, 16, 16, 2) * 0.5).astype(np.float32)
    w = rs.rand(2, 16, 16, 2).astype(np.float32)
    depth = (rs.rand(2, 16, 16) * 0.3 + 0.5).astype(np.float32)
    K = np.tile(np.float32([[40.0, 40.0, 8.0, 8.0]]), (2, 1))
    for iters in (1, 2):
        got = T.solve_pose_from_flow(_t(T0), _t(flow), _t(w), _t(depth), _t(K), iters)
        want = J.solve_pose_from_flow(T0, flow, w, depth, K, iters)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=TOL)


def test_normalize_coords_equals_jax():
    from rnnpose_tpu.geometry import projective as J
    from rnnpose_tpu_torch.geometry import projective as T

    c = (np.random.RandomState(3).rand(2, 7, 9, 2) * 30).astype(np.float32)
    np.testing.assert_allclose(T.normalize_coords(_t(c), 7, 9).numpy(),
                               np.asarray(J.normalize_coords(c, 7, 9)), rtol=0, atol=TOL)


def test_intrinsics_vec_matrix_equal_jax():
    from rnnpose_tpu.geometry import projective as J
    from rnnpose_tpu_torch.geometry import projective as T

    k = (np.random.RandomState(7).rand(2, 3, 4) * 500).astype(np.float32)
    K = T.intrinsics_vec_to_matrix(_t(k))
    np.testing.assert_array_equal(K.numpy(), np.asarray(J.intrinsics_vec_to_matrix(k)))
    np.testing.assert_array_equal(T.intrinsics_matrix_to_vec(K).numpy(), k)


def test_se3_hat_vee_so3_expm_equal_jax():
    from rnnpose_tpu.geometry import se3 as J
    from rnnpose_tpu_torch.geometry import se3 as T

    xi = (np.random.RandomState(4).randn(6, 6) * 0.5).astype(np.float32)
    xi[0, 3:] = 0.0        # zero rotation: the Taylor branch
    xi[1, 3:] = 1e-5
    X = T.hat(_t(xi))
    np.testing.assert_array_equal(X.numpy(), np.asarray(J.hat(xi)))
    np.testing.assert_array_equal(T.vee(X).numpy(), xi)
    np.testing.assert_array_equal(T.vee(X).numpy(), np.asarray(J.vee(np.asarray(J.hat(xi)))))
    np.testing.assert_allclose(T.so3_expm(_t(xi[:, 3:])).numpy(),
                               np.asarray(J.so3_expm(xi[:, 3:])), rtol=0, atol=TOL)
    # so3_expm is the rotation block of se3_expm.
    np.testing.assert_array_equal(T.so3_expm(_t(xi[:, 3:])).numpy(),
                                  T.se3_expm(_t(xi))[:, :3, :3].numpy())


def test_posenet_registry_as_jax():
    from rnnpose_tpu.models import rnnpose as J
    from rnnpose_tpu_torch.models import rnnpose as T

    assert T.get_posenet_class("RNNPose") is T.RNNPose
    assert sorted(T._POSENET_REGISTRY) == sorted(J._POSENET_REGISTRY)

    @T.register_posenet
    class Other(torch.nn.Module):
        pass

    try:
        assert T.get_posenet_class("Other") is Other
    finally:
        del T._POSENET_REGISTRY["Other"]
    with pytest.raises(KeyError):
        T.get_posenet_class("Missing")


def test_bilinear_sample_nchw_equals_jax():
    from rnnpose_tpu.ops import sampler as J
    from rnnpose_tpu_torch.ops import sampler as T

    rs = np.random.RandomState(5)
    img = rs.randn(2, 3, 12, 10).astype(np.float32)
    coords = (rs.rand(2, 5, 6, 2) * 14 - 2).astype(np.float32)  # some out of range
    np.testing.assert_allclose(T.bilinear_sample_nchw(_t(img), _t(coords)).numpy(),
                               np.asarray(J.bilinear_sample_nchw(img, coords)), rtol=0,
                               atol=TOL)


@pytest.mark.parametrize("factor", [2, 8])
def test_upflow_equals_jax(factor):
    from rnnpose_tpu.ops import upsample as J
    from rnnpose_tpu_torch.ops import upsample as T

    flow = np.random.RandomState(6).randn(2, 5, 7, 2).astype(np.float32)
    got = T.upflow(_t(flow), factor).numpy()
    want = np.asarray(J.upflow(flow, factor))
    assert got.shape == want.shape == (2, 5 * factor, 7 * factor, 2)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL * factor)


def test_freeze_mask_equals_jax():
    import _torch_port_common as C
    from rnnpose_tpu.train.optim import freeze_mask as j_mask
    from rnnpose_tpu_torch.train.optim import freeze_mask

    inputs, kp = C.jax_scene(1)
    d3, c3 = C.cached_3d(1, 256)
    _, params = C.jax_model_and_params(inputs, kp, d3, c3, render_iters=1, gru_iters=1)
    model = C.port_model(params, render_iters=1, gru_iters=1)
    from rnnpose_tpu_torch.models.convert import flax_paths

    import jax

    paths = flax_paths(model)
    for patterns in ((), ("hybrid/desc2d",), ("motion/inner/cf_step/update_block/gru", "sigma")):
        jm = j_mask(params, patterns)
        flat = {"/".join(str(getattr(k, "key", k)) for k in p): v
                for p, v in jax.tree_util.tree_flatten_with_path(jm)[0]}
        got = freeze_mask(model, patterns)
        assert got.keys() == paths.keys()
        # The JAX model runs on cached 3D features: it has no KPConv towers.
        shared = [n for n in got if paths[n] in flat]
        assert len(shared) == len(flat)
        assert all("3d" in n for n in got if n not in shared)
        assert {n: flat[paths[n]] for n in shared} == {n: got[n] for n in shared}
        assert any(got.values())
        if patterns:
            assert not all(got.values())


def test_apply_parity_preset_in_config_defaults():
    from rnnpose_tpu.config import defaults as jdef
    from rnnpose_tpu_torch.config import defaults as tdef
    from rnnpose_tpu_torch.models.rnnpose import apply_parity_preset

    assert tdef.apply_parity_preset is apply_parity_preset
    jcfg = jdef.apply_parity_preset(jdef.build_model_config(jdef.default_config()))
    tcfg = tdef.apply_parity_preset(tdef.build_model_config(tdef.default_config()))
    assert tcfg.desc2d_eval_tail_res == jcfg.desc2d_eval_tail_res == "full"
    for f in ("lm_res", "corr_weight_res", "mixed_precision", "legacy_squash_255"):
        assert getattr(tcfg.refiner, f) == getattr(jcfg.refiner, f), f
    assert dataclasses.asdict(tcfg.refiner) == {
        k: v for k, v in dataclasses.asdict(jcfg.refiner).items()
        if k in dataclasses.asdict(tcfg.refiner)}


def test_attrdict_as_jax():
    from rnnpose_tpu.utils.config_io import AttrDict as J
    from rnnpose_tpu_torch.utils.config_io import AttrDict as T

    raw = {"a": {"b": [1, {"c": 2}]}, "d": 3}
    t, j = T.wrap(raw), J.wrap(raw)
    assert t == j == raw
    assert t.a.b[1].c == j.a.b[1].c == 2
    t.e = 5
    assert t["e"] == 5
    with pytest.raises(AttributeError):
        t.missing


def test_timeit_runs_the_chained_protocol():
    """`tools/profile_components.timeit`: ms per call, the inputs perturbed
    per call and the calls chained; a non-finite output raises."""
    from rnnpose_tpu_torch.tools.profile_components import timeit

    seen = []

    def fn(x, y):
        seen.append(float(x.sum()))
        return {"out": x @ y, "ints": torch.ones(2, dtype=torch.int64)}

    x, y = torch.zeros(4, 4), torch.ones(4, 4)  # zeros: each epsilon shows
    ms = timeit(fn, x, y, iters=3, name="mm")
    assert ms > 0 and len(seen) == 4 and len(set(seen)) == 4  # every call perturbed
    with pytest.raises(AssertionError, match="non-finite"):
        timeit(lambda a: a / 0.0, torch.ones(3), iters=2, name="inf")
    with pytest.raises(AssertionError, match="perturb"):
        timeit(lambda a: a.float(), torch.ones(3, dtype=torch.int64), iters=2, name="int")
