"""The port's sampling, correlation and upsampling ops against the JAX
package on seeded inputs.

Tolerance 1e-5 (sampler, corr, resizes): exact f32 on both sides, with
other summation orders; the corr window order must match exactly for
converted `convc1` weights to stay valid, which the per-tap comparison
checks.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_port_common  # noqa: F401  (pins torch to one thread)
from rnnpose_tpu.models import cfnet as jcfnet
from rnnpose_tpu.ops import corr as jcorr
from rnnpose_tpu.ops import sampler as jsampler
from rnnpose_tpu.ops import upsample as jup
from rnnpose_tpu_torch.models import cfnet as tcfnet
from rnnpose_tpu_torch.models.refiner import to_full
from rnnpose_tpu_torch.ops import corr as tcorr
from rnnpose_tpu_torch.ops import sampler as tsampler
from rnnpose_tpu_torch.ops import upsample as tup

ATOL = 1e-5


def close(t, j, atol=ATOL):
    np.testing.assert_allclose(t.detach().float().numpy(), np.asarray(j, np.float32),
                               atol=atol, rtol=1e-6)


def test_bilinear_sample_zero_padding():
    rs = np.random.RandomState(0)
    img = rs.randn(2, 9, 11, 5).astype(np.float32)
    coords = rs.uniform(-2.5, 12.5, (2, 7, 6, 2)).astype(np.float32)
    coords[0, 0, 0] = [3.0, 4.0]    # integer position
    coords[0, 0, 1] = [10.0, 8.0]   # last pixel exactly
    close(tsampler.bilinear_sample(torch.from_numpy(img), torch.from_numpy(coords)),
          jsampler.bilinear_sample(img, coords))


@pytest.mark.parametrize("out_size", [6, 24])
def test_separable_crop_sample(out_size):
    rs = np.random.RandomState(1)
    img = rs.rand(2, 40, 40, 3).astype(np.float32)
    cp = np.asarray([[20.3, 18.7, 9.1, 9.1], [5.0, 33.0, 12.5, 10.0]], np.float32)
    close(tsampler.separable_crop_sample(torch.from_numpy(img), torch.from_numpy(cp), out_size),
          jsampler.separable_crop_sample(img, cp, out_size))


@pytest.mark.parametrize("hw,levels", [(15, 3), (30, 4), (6, 3)])
def test_corr_pyramid_odd_sizes(hw, levels):
    """The avg-pool drops an odd last row/column: 15 -> 7 -> 3, 30 -> 15 -> 7 -> 3."""
    rs = np.random.RandomState(2)
    f1 = rs.randn(2, hw, hw, 16).astype(np.float32)
    f2 = rs.randn(2, hw, hw, 16).astype(np.float32)
    pt = tcorr.build_corr_pyramid(torch.from_numpy(f1), torch.from_numpy(f2), levels)
    pj = jcorr.build_corr_pyramid(f1, f2, levels)
    assert [tuple(l.shape) for l in pt.levels] == [l.shape for l in pj.levels]
    for lt, lj in zip(pt.levels, pj.levels):
        close(lt, lj)


def test_corr_pyramid_bf16_features():
    """bf16 feature maps (the mixed-precision encoder) contract in f32."""
    rs = np.random.RandomState(3)
    f1 = rs.randn(1, 6, 6, 256).astype(np.float32)
    f2 = rs.randn(1, 6, 6, 256).astype(np.float32)
    b1, b2 = jnp.asarray(f1, jnp.bfloat16), jnp.asarray(f2, jnp.bfloat16)
    pj = jcorr.build_corr_pyramid(b1, b2, 2)
    pt = tcorr.build_corr_pyramid(torch.from_numpy(f1).bfloat16(),
                                  torch.from_numpy(f2).bfloat16(), 2)
    for lt, lj in zip(pt.levels, pj.levels):
        assert lt.dtype == torch.float32
        close(lt, lj)


@pytest.mark.parametrize("radius", [4, 2])
def test_corr_lookup_window_order(radius):
    rs = np.random.RandomState(4)
    f1 = rs.randn(2, 8, 8, 16).astype(np.float32)
    f2 = rs.randn(2, 8, 8, 16).astype(np.float32)
    coords = rs.uniform(-3.0, 11.0, (2, 8, 8, 2)).astype(np.float32)
    coords[0, 0, 0] = [2.0, 5.0]  # integer centre: taps land exactly
    pt = tcorr.build_corr_pyramid(torch.from_numpy(f1), torch.from_numpy(f2), 3)
    pj = jcorr.build_corr_pyramid(f1, f2, 3)
    out_t = tcorr.corr_lookup(pt, torch.from_numpy(coords), radius)
    out_j = jcorr.corr_lookup(pj, coords, radius)
    assert tuple(out_t.shape) == out_j.shape == (2, 8, 8, 3 * (2 * radius + 1) ** 2)
    close(out_t, out_j)
    # Window order: x-offset-major. At an integer centre on level 0, tap
    # (dx, dy) reads corr[y + dy, x + dx].
    win = 2 * radius + 1
    vol = pt.levels[0][0, 0].numpy()
    taps = out_t[0, 0, 0, :win * win].numpy().reshape(win, win)  # [dx, dy]
    for dx in (-1, 0, 2):
        for dy in (-2, 0, 1):
            np.testing.assert_allclose(taps[dx + radius, dy + radius],
                                       vol[5 + dy, 2 + dx], atol=ATOL)


def test_upsample2x_bilinear():
    x = np.random.RandomState(5).randn(2, 5, 7, 3).astype(np.float32)
    close(tup.upsample2x_bilinear(torch.from_numpy(x)), jup.upsample2x_bilinear(x))


@pytest.mark.parametrize("out_hw", [(6, 6), (3, 5), (1, 1)])
def test_resize_bilinear_align_corners(out_hw):
    x = np.random.RandomState(6).randn(2, 12, 10, 4).astype(np.float32)
    close(tcfnet.resize_bilinear_ac(torch.from_numpy(x), out_hw),
          jcfnet.resize_bilinear_ac(x, out_hw))


@pytest.mark.parametrize("src,dst", [(6, 48), (30, 240)])
def test_weight_upsample_matches_jax_resize(src, dst):
    """The refiner's one post-loop upsample of the 1/8-grid weight."""
    x = np.random.RandomState(7).rand(2, src, src, 1).astype(np.float32)
    close(to_full(torch.from_numpy(x), dst),
          jax.image.resize(x, (2, dst, dst, 1), "bilinear"))


def test_split_context():
    x = np.random.RandomState(8).randn(2, 6, 6, 256).astype(np.float32)
    for dtype_t, dtype_j in ((None, None), (torch.bfloat16, jnp.bfloat16)):
        net_t, inp_t = tcfnet.split_context(torch.from_numpy(x), 128, 128, dtype_t, (6, 6))
        net_j, inp_j = jcfnet.split_context(jnp.asarray(x), 128, 128, dtype_j, (6, 6))
        atol = ATOL if dtype_t is None else 1e-2  # one bf16 rounding of O(1) values
        close(net_t, net_j.astype(jnp.float32), atol)
        close(inp_t, inp_j.astype(jnp.float32), atol)
