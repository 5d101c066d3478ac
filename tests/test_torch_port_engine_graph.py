"""The compiled serving forward: the port's `InferenceEngine` (one program
per class and shape, a CUDA graph on the card, the same static-buffer
program around the eager forward on the CPU) against the JAX package's
jitted `InferenceEngine`.

* At the `__graft_entry__._tiny_setup` scene (f32, one render iteration of
  two GRU steps), on converted weights, for two class names (the scene and
  a coarser icosphere of another seed) at B=1 and B=2: the port's
  `refine` equals the JAX engine's within 1e-3 on Ti_pred (the bound of
  `test_torch_port_engine.test_uncached_forward_matches_jax`), and equals
  the port's eager cached forward bit for bit.
* Two requests of one key return independent tensors, each bit-equal to
  the eager forward; the first request's outputs do not change with the
  second.
* Another batch size makes another program; `evict(name)` and `evict()`
  drop the programs with the features (`graph_captures` counts them).
* A request whose tensors disagree on the batch, or whose batch differs
  from its class's cached features, raises instead of broadcasting.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

import _torch_port_common as C
from chip_smoke import output_tensors
from rnnpose_tpu_torch.data.synthetic import (
    SyntheticConfig, kpconv_config, make_synthetic_inputs)
from rnnpose_tpu_torch.models.convert import load_jax_params
from rnnpose_tpu_torch.models.engine import InferenceEngine
from rnnpose_tpu_torch.models.kpconv_net import KPConvConfig, PointPyramid
from rnnpose_tpu_torch.models.refiner import RefinerConfig
from rnnpose_tpu_torch.models.rnnpose import RNNPose, RNNPoseConfig, init_random_

# class name -> the JAX SyntheticConfig overrides of its scene
CLASSES = {"ico": {}, "coarse": dict(subdivisions=1, seed=1)}
BATCHES = (1, 2)


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


def _assert_bit_equal(a, b):
    ta, tb = output_tensors(a), output_tensors(b)
    assert ta.keys() == tb.keys() and len(ta) > 10
    for k in ta:
        assert torch.equal(ta[k], tb[k]), k


@pytest.fixture(scope="module")
def engines():
    """The JAX engine's outputs for each (class, B) and the port's engine on
    the converted weights, with the port's requests."""
    from __graft_entry__ import _tiny_setup
    from rnnpose_tpu.data.synthetic import SyntheticConfig as JSyn
    from rnnpose_tpu.data.synthetic import make_synthetic_inputs as jmake
    from rnnpose_tpu.models.engine import InferenceEngine as JEngine
    from rnnpose_tpu.models.rnnpose import RNNPose as JRNNPose

    model, inputs = _tiny_setup(batch_size=1, train=False, render_iters=1)
    cfg = dataclasses.replace(model.cfg, refiner=dataclasses.replace(
        model.cfg.refiner, mixed_precision=False))
    model = JRNNPose(cfg)
    params = jax.device_get(
        jax.jit(lambda k: model.init(k, inputs, train=False))(jax.random.PRNGKey(0)))
    jeng = JEngine(model, params)
    port = load_jax_params(RNNPose(_port_config(cfg)), params).eval()
    requests, expected = {}, {}
    for cls, over in CLASSES.items():
        for B in BATCHES:
            syn = dict(image_size=96, batch_size=B, num_verts=256, num_faces=512,
                       subdivisions=2, num_corr=64, kp_layers=3, kp_dl=0.015, fx=150.0,
                       fy=150.0)
            syn.update(over)
            jin, _ = jmake(JSyn(**syn), with_corr=False)
            jin = jax.tree.map(jax.numpy.asarray, jin)
            name = f"{cls}_b{B}"
            expected[name] = np.asarray(jeng.refine(name, jin)["Ti_pred"])
            requests[name] = C.port_inputs(jin)._replace(pyramid=_port_pyramid(jin.pyramid))
    return port, InferenceEngine(port), requests, expected


@pytest.mark.parametrize("cls", sorted(CLASSES))
@pytest.mark.parametrize("batch", BATCHES)
def test_engine_matches_jax_engine(engines, cls, batch):
    port, engine, requests, expected = engines
    name = f"{cls}_b{batch}"
    req = requests[name]
    out = engine.refine(name, req)
    T = C.to_numpy(out["Ti_pred"])
    assert T.shape == (batch, 4, 4)
    np.testing.assert_allclose(T, expected[name], atol=1e-3)
    assert np.abs(T - C.to_numpy(req.T_init)).max() > 1e-3  # it refined
    d3, c3 = engine.class_features(name, None)
    _assert_bit_equal(out, port(req, cached_desc3d=d3, cached_ctx3d=c3))


def _port_engine(render_iters=1):
    scene = SyntheticConfig(kp_layers=3, kp_dl=0.015, **C.TINY_SCENE)
    kp = kpconv_config(scene)
    model = RNNPose(RNNPoseConfig(
        desc_kp=dataclasses.replace(kp, final_feats_dim=32),
        ctx_kp=dataclasses.replace(kp, final_feats_dim=256, normalize_output=False),
        refiner=RefinerConfig(**C.refiner_kwargs(render_iters=render_iters, gru_iters=1))))
    init_random_(model, torch.Generator().manual_seed(0))
    inputs = {B: make_synthetic_inputs(dataclasses.replace(scene, batch_size=B))
              for B in BATCHES}
    return model, InferenceEngine(model), inputs


def test_requests_of_one_key_are_independent_and_bit_equal_to_eager():
    model, engine, inputs = _port_engine()
    req1 = inputs[2]
    req2 = req1._replace(T_init=req1.T_gt, image=req1.image.flip(1))
    out1 = engine.refine("ico", req1)
    kept = {k: v.clone() for k, v in output_tensors(out1).items()}
    out2 = engine.refine("ico", req2)
    assert engine.graph_captures == 1 and engine.encode_3d_calls == 1
    d3, c3 = engine.class_features("ico", None)
    _assert_bit_equal(out1, model(req1, cached_desc3d=d3, cached_ctx3d=c3))
    _assert_bit_equal(out2, model(req2, cached_desc3d=d3, cached_ctx3d=c3))
    for k, v in output_tensors(out1).items():  # request 2 did not write into request 1's
        assert torch.equal(v, kept[k]), k
    assert not torch.equal(out1["Ti_pred"], out2["Ti_pred"])
    # Fresh tensors: none shared between the requests or with the request.
    ptrs1 = {v.data_ptr() for v in output_tensors(out1).values() if v.numel()}
    ptrs2 = {v.data_ptr() for v in output_tensors(out2).values() if v.numel()}
    assert not ptrs1 & ptrs2
    assert not ptrs2 & {t.data_ptr() for t in output_tensors(req2).values()}
    assert isinstance(out2["refiner"], type(model(req2, cached_desc3d=d3,
                                                    cached_ctx3d=c3)["refiner"]))


def test_programs_per_class_and_shape_and_eviction():
    model, engine, inputs = _port_engine()
    engine.refine("a", inputs[1])
    engine.refine("a", inputs[1]._replace(T_init=inputs[1].T_gt))
    assert engine.graph_captures == 1
    engine.refine("b", inputs[2])  # another class at another batch size
    engine.refine("b", inputs[2])
    assert engine.graph_captures == 2 and engine.encode_3d_calls == 2
    # The same class and shapes without T_gt: another key.
    engine.refine("a", inputs[1]._replace(T_gt=None))
    assert engine.graph_captures == 3
    engine.evict("a")
    assert {k[0] for k in engine._programs} == {"b"}
    engine.refine("b", inputs[2])
    assert engine.graph_captures == 3
    engine.refine("a", inputs[1])
    assert engine.graph_captures == 4 and engine.encode_3d_calls == 3
    engine.evict()
    assert not engine._programs
    engine.refine("b", inputs[2])
    assert engine.graph_captures == 5 and engine.encode_3d_calls == 4


def test_request_that_would_broadcast_raises():
    model, engine, inputs = _port_engine()
    req = inputs[2]
    with pytest.raises(ValueError, match="T_init has batch 1"):
        engine.refine("ico", req._replace(T_init=req.T_init[:1]))
    assert engine.graph_captures == 0
    engine.refine("ico", req)
    # The class's features carry B=2: a B=1 request of it raises.
    small = inputs[1]
    with pytest.raises(ValueError, match="cached_desc3d has batch 2"):
        engine.refine("ico", small)
    assert engine.graph_captures == 1
