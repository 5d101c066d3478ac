"""The port's KPConv towers and their host preprocessing against the JAX
package, on the same seeded numpy inputs, in f32 on the CPU.

* `make_kernel_points`: bit for bit.
* The pyramid (`data/pyramid.py`): exactly equal, with the same backend on
  both sides (numpy, or each package's build of the same native C++ source;
  the two backends may order neighbours at equal distance differently).
* Every `kpconv_ops` function, each influence x aggregation mode, shadow
  neighbours and the zero-clamp of `max_pool`; `masked_instance_norm`:
  1e-5.
* `KPFCNN` at a small config with converted weights: descriptors within
  5e-4 and context features within 2e-3 (the towers' bounds of the JAX
  suite's reference A/B, PARITY.md); padding invariance.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_port_common as C
import rnnpose_tpu.data.pyramid as jpyr
from rnnpose_tpu.models import kpconv_net as jnet
from rnnpose_tpu.ops import kernel_points as jkp
from rnnpose_tpu.ops import kpconv_ops as jops
from rnnpose_tpu_torch.data import pyramid as tpyr
from rnnpose_tpu_torch.data.synthetic import SyntheticConfig, make_synthetic_inputs
from rnnpose_tpu_torch.models import kpconv_net as tnet
from rnnpose_tpu_torch.models.convert import flax_to_state_dict
from rnnpose_tpu_torch.ops import kernel_points as tkp
from rnnpose_tpu_torch.ops import kpconv_ops as tops

TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("num,radius", [(15, 1.0), (15, 0.0375), (9, 0.5)])
def test_kernel_points_bit_equal(num, radius):
    np.testing.assert_array_equal(tkp.make_kernel_points(num, radius),
                                  jkp.make_kernel_points(num, radius))


def _clouds():
    """A random cloud and the tiny scene's real mesh vertices."""
    rs = np.random.RandomState(0)
    mesh = make_synthetic_inputs(SyntheticConfig(**C.TINY_SCENE)).mesh
    n = int(mesh.vert_valid.sum())
    return [rs.rand(300, 3).astype(np.float32) * 0.5, mesh.verts[:n].numpy()]


@pytest.fixture(params=["numpy", "native"])
def backend(request, monkeypatch):
    """Both packages on the numpy path, or both on their native builds."""
    if request.param == "numpy":
        monkeypatch.setattr(jpyr, "_cpp", lambda: None)
        monkeypatch.setattr(tpyr, "_cpp", lambda: None)
    else:
        from rnnpose_tpu.cpp import native as jnative
        from rnnpose_tpu_torch.cpp import native as tnative

        if not jnative.available():
            # The JAX loader gives up for the process if its first load met
            # a library another test process was still writing: try again.
            monkeypatch.setattr(jnative, "_tried", False)
        assert jnative.available() and tnative.available()
    return request.param


def test_pyramid_arrays_equal(backend):
    jcfg = jnet.KPConvConfig(num_layers=3, first_subsampling_dl=0.05)
    tcfg = tnet.KPConvConfig(num_layers=3, first_subsampling_dl=0.05)
    clouds = _clouds()
    limits_j = jpyr.calibrate_neighbor_limits(clouds, jcfg, untruncated_cap=64)
    assert tpyr.calibrate_neighbor_limits(clouds, tcfg, untruncated_cap=64) == limits_j
    pj = [jpyr.build_pyramid_arrays(c, jcfg, limits_j) for c in clouds]
    pt = [tpyr.build_pyramid_arrays(c, tcfg, limits_j) for c in clouds]
    for a, b in zip(pj, pt):
        for name in ("points", "neighbors", "pools", "upsamples"):
            for x, y in zip(getattr(a, name), getattr(b, name)):
                np.testing.assert_array_equal(y, x, err_msg=name)
    sizes = [512, 160, 48]
    bj = jpyr.pad_and_batch_pyramids(pj, level_sizes=sizes)
    bt = tpyr.pad_and_batch_pyramids(pt, level_sizes=sizes)
    for name in ("points", "masks", "neighbors", "pools", "upsamples"):
        for x, y in zip(getattr(bj, name), getattr(bt, name)):
            np.testing.assert_array_equal(y.numpy(), x, err_msg=name)
    # Shadow indices are remapped to the padded size.
    assert int(bt.neighbors[0].max()) == sizes[0]


def _op_inputs(seed=1, B=2, M=40, N=30, K=8, Cin=5, Cout=7, P=15):
    rs = np.random.RandomState(seed)
    s_pts = (rs.rand(B, M, 3) * 0.1).astype(np.float32)
    q_pts = (s_pts[:, :N] + rs.randn(B, N, 3) * 0.005).astype(np.float32)
    inds = rs.randint(0, M + 1, size=(B, N, K))   # M is the shadow index
    inds[:, :, -2:] = M                             # every list has a shadow ...
    inds[0, :5] = rs.randint(0, M, size=(5, K))     # ... but these rows
    feats = rs.randn(B, M, Cin).astype(np.float32)
    kp = tkp.make_kernel_points(P, 0.05)
    w = (rs.randn(P, Cin, Cout) / np.sqrt(P * Cin)).astype(np.float32)
    return q_pts, s_pts, inds, feats, kp, w


def _t(*arrs):
    return [torch.from_numpy(np.asarray(a)) for a in arrs]


@pytest.mark.parametrize("aggregation", ["sum", "closest"])
@pytest.mark.parametrize("influence", ["linear", "gaussian", "constant"])
def test_kpconv_matches_jax(influence, aggregation):
    q, s, inds, feats, kp, w = _op_inputs()
    fn = functools.partial(jops.kpconv, kernel_points=jnp.asarray(kp), weights=jnp.asarray(w),
                           kp_extent=0.04, influence=influence, aggregation=aggregation)
    ref = jax.vmap(fn)(q, s, jnp.asarray(inds, jnp.int32), feats)
    out = tops.kpconv(*_t(q, s, inds, feats, kp, w), 0.04, influence, aggregation)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    assert np.abs(np.asarray(ref)).max() > 1e-3


def test_gather_pool_and_average_match_jax():
    _, _, inds, feats, _, _ = _op_inputs()
    ji = jnp.asarray(inds, jnp.int32)
    ti, tf = torch.from_numpy(inds), torch.from_numpy(feats)
    np.testing.assert_array_equal(tops.gather_neighbors(tf, ti).numpy(),
                                  np.asarray(jax.vmap(jops.gather_neighbors)(feats, ji)))
    np.testing.assert_array_equal(tops.closest_pool(tf, ti).numpy(),
                                  np.asarray(jax.vmap(jops.closest_pool)(feats, ji)))
    shadow_first = inds.copy()
    shadow_first[:, ::3, 0] = feats.shape[1]
    np.testing.assert_array_equal(
        tops.closest_pool(tf, torch.from_numpy(shadow_first)).numpy(),
        np.asarray(jax.vmap(jops.closest_pool)(feats, jnp.asarray(shadow_first, jnp.int32))))
    mask = (np.random.RandomState(2).rand(*feats.shape[:2]) < 0.7).astype(np.float32)
    np.testing.assert_allclose(
        tops.global_average(tf, torch.from_numpy(mask)).numpy(),
        np.asarray(jax.vmap(jops.global_average)(feats, mask)), **TOL)
    np.testing.assert_allclose(tops.global_average(tf).numpy(),
                               np.asarray(jax.vmap(jops.global_average)(feats)), **TOL)


def test_max_pool_zero_clamp_matches_jax():
    """All features negative: a pool list with a shadow neighbour gives 0
    (the reference's zero shadow row), one without gives the true max."""
    _, _, inds, feats, _, _ = _op_inputs()
    neg = -np.abs(feats) - 0.1
    ref = np.asarray(jax.vmap(jops.max_pool)(neg, jnp.asarray(inds, jnp.int32)))
    out = tops.max_pool(torch.from_numpy(neg), torch.from_numpy(inds)).numpy()
    np.testing.assert_array_equal(out, ref)
    has_shadow = (inds >= feats.shape[1]).any(-1)
    assert np.all(out[has_shadow] == 0.0) and np.all(out[~has_shadow] < 0.0)
    assert (~has_shadow).any()


def test_masked_instance_norm_matches_jax():
    rs = np.random.RandomState(3)
    x = (rs.randn(2, 30, 6) * 3 + 1).astype(np.float32)
    mask = (rs.rand(2, 30) < 0.6).astype(np.float32)
    ref = np.asarray(jnet.masked_instance_norm(x, mask))
    out = tnet.masked_instance_norm(torch.from_numpy(x), torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(out, ref, **TOL)
    assert np.all(out[mask == 0] == 0.0)


def _tower_pyramid(cfg, B=2):
    """The tiny scene's mesh pyramid at `cfg`, both packages' forms."""
    tcfg = tnet.KPConvConfig(**dataclasses.asdict(cfg))
    clouds = _clouds()[1:] * B
    pyrs = [tpyr.build_pyramid_arrays(c, tcfg, [24] * cfg.num_layers) for c in clouds]
    sizes = [256] + [-(-len(pyrs[0].points[l]) // 8) * 8 for l in range(1, cfg.num_layers)]
    bt = tpyr.pad_and_batch_pyramids(pyrs, level_sizes=sizes)
    bj = jnet.PointPyramid(*([jnp.asarray(t.numpy().astype(
        np.int32 if t.dtype == torch.int64 else np.float32)) for t in ts]
        for ts in (bt.points, bt.masks, bt.neighbors, bt.pools, bt.upsamples)))
    return bt, bj, tcfg


def _port_tower(params, tcfg):
    """The port's KPFCNN with the flax tower params converted."""
    sd = flax_to_state_dict({"params": {"hybrid": {"desc3d": params["params"]}}})
    prefix = "hybrid_desc_net.corr_fea_extractor_3d."
    tower = tnet.KPFCNN(tcfg)
    tower.load_state_dict({k[len(prefix):]: torch.from_numpy(np.array(v, np.float32))
                           for k, v in sd.items()}, strict=True)
    return tower.eval()


TOWERS = {  # name -> (config overrides, bound)
    "desc": (dict(final_feats_dim=32), 5e-4),
    "ctx": (dict(final_feats_dim=256, normalize_output=False), 2e-3),
}


@pytest.mark.parametrize("tower", sorted(TOWERS))
def test_kpfcnn_matches_jax_with_converted_weights(tower):
    over, tol = TOWERS[tower]
    cfg = jnet.KPConvConfig(num_layers=3, first_subsampling_dl=0.015, first_feats_dim=32,
                            gnn_feats_dim=32, **over)
    bt, bj, tcfg = _tower_pyramid(cfg)
    model = jnet.KPFCNN(cfg)
    params = jax.device_get(jax.jit(model.init)(jax.random.PRNGKey(1), bj))
    ref = np.asarray(jax.jit(model.apply)(params, bj))
    with torch.no_grad():
        out = _port_tower(params, tcfg)(bt).numpy()
    assert out.shape == ref.shape == (2, 256, over["final_feats_dim"])
    np.testing.assert_allclose(out, ref, atol=tol, rtol=0)
    real = bt.masks[0].numpy() > 0
    assert np.all(out[~real] == 0.0) and np.abs(out[real]).max() > 1e-2
    if cfg.normalize_output:
        np.testing.assert_allclose(np.linalg.norm(out[real], axis=-1), 1.0, atol=1e-5)


def test_kpfcnn_padding_invariance():
    """More padding on every level leaves the real points' features as they
    are (the JAX package's test_kpfcnn_padding_invariance, on the port)."""
    cfg = tnet.KPConvConfig(num_layers=2, first_subsampling_dl=0.05, first_feats_dim=8,
                            final_feats_dim=4, gnn_feats_dim=8)
    cloud = np.random.RandomState(4).rand(100, 3).astype(np.float32) * 0.4
    p = tpyr.build_pyramid_arrays(cloud, cfg, [12, 12])
    b1 = tpyr.pad_and_batch_pyramids([p])
    b2 = tpyr.pad_and_batch_pyramids([p], level_sizes=[t.shape[1] + 37 for t in b1.points])
    torch.manual_seed(0)
    tower = tnet.KPFCNN(cfg).eval()
    with torch.no_grad():
        f1, f2 = tower(b1).numpy(), tower(b2).numpy()
    n_real = len(p.points[0])
    np.testing.assert_allclose(f1[0, :n_real], f2[0, :n_real], atol=1e-4)
    assert np.all(f2[0, n_real:] == 0.0)
