"""The port's networks with weights converted from the JAX package's flax
parameters, against the flax modules on the same seeded inputs.

Tolerance 1e-4 in f32 (convolutions accumulate in another order). One bf16
check of the encoder with a loose bound: the two frameworks round bf16
activations at different places (XLA fuses elementwise chains in f32, eager
PyTorch rounds after every op), so values agree to a few bf16 ulps.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_port_common as C
from rnnpose_tpu.models import cfnet as jcfnet
from rnnpose_tpu.models import raft as jraft
from rnnpose_tpu.models import superpoint as jsp
from rnnpose_tpu.ops import corr as jcorr
from rnnpose_tpu_torch.models import raft as traft
from rnnpose_tpu_torch.ops import corr as tcorr

ATOL = 1e-4


@pytest.fixture(scope="module")
def nets():
    """Flax params of the tiny f32 model, and the port's model loaded with
    them."""
    inputs, kp = C.jax_scene(1)
    d3, c3 = C.cached_3d(1, inputs.mesh.verts.shape[0])
    _, params = C.jax_model_and_params(inputs, kp, d3, c3, render_iters=1,
                                       gru_iters=1, mixed_precision=False)
    port = C.port_model(params, render_iters=1, gru_iters=1, mixed_precision=False)
    return params["params"], port


def close(t, j, atol=ATOL):
    np.testing.assert_allclose(C.to_numpy(t).astype(np.float32),
                               np.asarray(j, np.float32), atol=atol, rtol=1e-4)


def test_instance_norm_f32_statistics():
    x = np.random.RandomState(0).randn(2, 5, 7, 3).astype(np.float32) * 3 + 1
    out_j = jraft.InstanceNorm().apply({}, jnp.asarray(x))
    out_t = traft.to_nhwc(traft.InstanceNorm()(traft.to_nchw(torch.from_numpy(x))))
    close(out_t, out_j, 1e-5)
    xb = torch.from_numpy(x).bfloat16()
    assert traft.InstanceNorm()(xb).dtype == torch.bfloat16


@pytest.mark.parametrize("tail", ["half", "full"])
def test_superpoint_both_tails(nets, tail):
    p, port = nets
    img = np.random.RandomState(1).rand(1, 32, 32, 3).astype(np.float32)
    _, dj = jsp.SuperPoint2D(mixed_precision=False).apply(
        {"params": p["hybrid"]["desc2d"]}, jnp.asarray(img), compute_scores=False,
        tail_res=tail)
    dt = port.hybrid_desc_net.encode_2d(torch.from_numpy(img), tail)
    assert tuple(dt.shape) == dj.shape == ((1, 16, 16, 32) if tail == "half" else (1, 32, 32, 32))
    close(dt, dj)


def test_image_feature_encoder(nets):
    p, port = nets
    rs = np.random.RandomState(2)
    a, b = (rs.rand(2, 48, 48, 3).astype(np.float32) for _ in range(2))
    fj = jcfnet.ImageFeaEncoder().apply({"params": p["motion"]["image_fea_enc"]}, a, b)
    ft = port.motion_net.image_fea_enc(torch.from_numpy(a), torch.from_numpy(b))
    for t, j in zip(ft, fj):
        assert tuple(t.shape) == j.shape == (2, 6, 6, 256)
        close(t, j)


def _update_inputs(seed, levels=3, radius=4):
    rs = np.random.RandomState(seed)
    h = np.tanh(rs.randn(2, 6, 6, 128)).astype(np.float32)
    inp = np.maximum(rs.randn(2, 6, 6, 128), 0).astype(np.float32)
    corr = rs.randn(2, 6, 6, levels * (2 * radius + 1) ** 2).astype(np.float32)
    flow = rs.randn(2, 6, 6, 2).astype(np.float32)
    return h, inp, corr, flow


def test_basic_update_block(nets):
    p, port = nets
    h, inp, corr, flow = _update_inputs(3)
    hj, mj, dj = jraft.BasicUpdateBlock().apply(
        {"params": p["motion"]["inner"]["cf_step"]["update_block"]}, h, inp, corr, flow)
    block = port.motion_net.cf_net.update_block
    ht, dt = block(*(torch.from_numpy(x) for x in (h, inp, corr, flow)))
    mt = block.upsample_mask(ht)
    close(ht, hj)
    close(mt, mj)
    close(dt, dj)
    assert mt.dtype == dt.dtype == torch.float32


def test_gru_flow_step(nets):
    p, port = nets
    h, inp, _, _ = _update_inputs(4)
    rs = np.random.RandomState(5)
    f1, f2 = (rs.randn(2, 6, 6, 256).astype(np.float32) for _ in range(2))
    grid = np.array(jnp.stack(jnp.meshgrid(jnp.arange(6.0), jnp.arange(6.0),
                                             indexing="xy"), -1))[None]
    coords = (grid + rs.randn(2, 6, 6, 2) * 1.5).astype(np.float32)
    pj = jcorr.build_corr_pyramid(f1, f2, 3)
    hj, cj, fj = jcfnet.GRUFlowStep(emit_full_flow=False).apply(
        {"params": p["motion"]["inner"]["cf_step"]}, h, inp, pj, coords, grid)
    pt = tcorr.build_corr_pyramid(torch.from_numpy(f1), torch.from_numpy(f2), 3)
    ht, ct, ft = port.motion_net.cf_net(
        torch.from_numpy(h), torch.from_numpy(inp), pt, torch.from_numpy(coords),
        torch.from_numpy(grid))
    close(ht, hj)
    close(ct, cj)
    close(ft, fj)


def test_encoder_bf16_loose(nets):
    """Same converted weights, bf16 compute on both sides (the serving
    default). The two bf16 results differ by a few bf16 ulps (features reach
    ~4, where an ulp is 1.6e-2): every value within 0.1, and the port's mean
    deviation from the f32 result at most 1.5x the JAX package's own."""
    p, _ = nets
    a = 2 * np.random.RandomState(6).rand(2, 32, 32, 3).astype(np.float32) - 1
    fnet = {"params": p["motion"]["image_fea_enc"]["fnet"]}
    f32 = np.asarray(jraft.BasicEncoder().apply(fnet, a))
    fj = np.asarray(jraft.BasicEncoder(dtype=jnp.bfloat16).apply(fnet, a).astype(jnp.float32))
    enc = traft.BasicEncoder(dtype=torch.bfloat16)
    enc.load_state_dict(C.port_model(jax.device_get({"params": p}), render_iters=1,
                                     gru_iters=1).motion_net.image_fea_enc.fnet.state_dict())
    ft = enc(torch.from_numpy(a))
    assert ft.dtype == torch.bfloat16
    ft = C.to_numpy(ft.float())
    assert np.abs(ft - fj).max() <= 0.1
    err_t, err_j = np.abs(ft - f32).mean(), np.abs(fj - f32).mean()
    assert err_t <= 1.5 * err_j, (err_t, err_j)
