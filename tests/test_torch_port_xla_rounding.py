"""The port rounds as the JAX package does where XLA's CPU backend decides
the form (`rnnpose_tpu_torch/geometry/precise.py`): bit for bit against the
JAX functions, jitted as the JAX package's model runs them.

* On the full-budget rehearsal scene at its initial pose
  (`tools/full_budget_rehearsal.build_scene(320, 4, 2048, 4096)`, a 240^2
  crop): the zoom crop (camera-frame vertices, crop window, crop
  intrinsics) and the crop's source coordinates; the projected vertices
  and `_face_screen_data` against the JAX formulas as written (eager: the
  port keeps the edge constants watertight where XLA contracts them);
  then render iteration 1's raster against the JAX refiner's CPU scan
  raster: coverage equal, face ids apart only on shared corners, depths
  and barycentrics near an f64 evaluation, and the observed crop within
  2.4e-7 (XLA's tent-matrix products sum in another order).
* `normalize_coords`, the Taylor branches of `geometry/se3` (the switch
  threshold raised so that seeded small angles take them), bilinear
  sampling, headlight shading and the clip factor of
  `safe_clip_by_global_norm` on seeded inputs.
* A guard: the tiny eval forward (serving defaults and the parity preset)
  and one training step divide no number but a power of two by a tensor
  (torch computes `c / x` as `x.reciprocal() * c`, two roundings).
"""
import dataclasses
import math
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_port_common as C
from rnnpose_tpu.geometry import crop as jcrop
from rnnpose_tpu.geometry import projective as jproj
from rnnpose_tpu.geometry import se3 as jse3
from rnnpose_tpu.ops import sampler as jsampler
from rnnpose_tpu.render import raster as jraster
from rnnpose_tpu.render import shading as jshading
from rnnpose_tpu.train import optim as joptim
from rnnpose_tpu_torch.geometry import crop as tcrop
from rnnpose_tpu_torch.geometry import projective as tproj
from rnnpose_tpu_torch.geometry import se3 as tse3
from rnnpose_tpu_torch.models.refiner import MeshAssets, zoom_crop
from rnnpose_tpu_torch.kernels import geometry as kernel_geometry
from rnnpose_tpu_torch.ops import sampler as tsampler
from rnnpose_tpu_torch.render import raster as traster
from rnnpose_tpu_torch.render import shading as tshading
from rnnpose_tpu_torch.tools import full_budget_rehearsal as R
from rnnpose_tpu_torch.train import optim as toptim

CROP = 240


def _bits_equal(a, b):
    """Bit-equal f32 arrays (signed zeros told apart)."""
    a = np.ascontiguousarray(np.asarray(a, np.float32))
    b = np.ascontiguousarray(np.asarray(b.detach() if torch.is_tensor(b) else b, np.float32))
    assert a.shape == b.shape
    differ = int((a.view(np.int32) != b.view(np.int32)).sum())
    assert differ == 0, f"{differ} of {a.size} differ, max |d| {np.abs(a - b).max():.3e}"


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.fixture(scope="module")
def scene():
    return R.build_scene(320, 4, 2048, 4096)


def _jax_zoom_crop(scene):
    """The JAX refiner's zoom crop (`models/refiner.py`, render loop) at
    T_init, jitted: (verts_cam, crop_params, K_crop)."""
    h_img = w_img = scene["image"].shape[1]

    def f(T, verts, vert_valid, K):
        verts_cam = jproj.transform_points(T, verts[None])
        uv, _ = jproj.project(verts_cam, K[:, None, :])
        vvalid = (vert_valid[None] > 0) & (verts_cam[..., 2] > jproj.MIN_DEPTH)
        x0 = jnp.min(jnp.where(vvalid, uv[..., 0], 1e9), axis=1)
        y0 = jnp.min(jnp.where(vvalid, uv[..., 1], 1e9), axis=1)
        x1 = jnp.max(jnp.where(vvalid, uv[..., 0], -1e9), axis=1)
        y1 = jnp.max(jnp.where(vvalid, uv[..., 1], -1e9), axis=1)
        bbox = jnp.stack([jnp.clip(jnp.round(x0), 0, w_img - 1),
                          jnp.clip(jnp.round(y0), 0, h_img - 1),
                          jnp.clip(jnp.round(x1), 0, w_img - 1),
                          jnp.clip(jnp.round(y1), 0, h_img - 1)], axis=-1)
        center, _ = jproj.project(T[:, None, :3, 3], K[:, None, :])
        cp = jcrop.reference_crop_params(center[:, 0], bbox, 0.4, ratio=h_img / w_img)
        return verts_cam, cp, jcrop.crop_intrinsics(K, cp, CROP)

    return jax.jit(f)(scene["T_init"], scene["verts"], scene["vert_valid"], scene["K"])


def _port_zoom_crop(scene):
    mesh = MeshAssets(verts=_t(scene["verts"]), faces=_t(scene["faces"].astype(np.int64)),
                      colors=_t(scene["colors"]), vert_valid=_t(scene["vert_valid"]),
                      face_valid=_t(scene["face_valid"]))
    h = scene["image"].shape[1]
    return zoom_crop(_t(scene["T_init"]), mesh, _t(scene["K"]), h, h, CROP, 0.4)


def test_zoom_crop_intrinsics_bit_equal(scene):
    """K_crop divides once (`(S-1) / (2 half)` as a tensor over a tensor)."""
    for a, b in zip(_jax_zoom_crop(scene), _port_zoom_crop(scene)):
        _bits_equal(a, b)


def test_face_setup_bit_equal(scene):
    """The projected vertices and `_face_screen_data` bit-equal to the JAX
    package's formulas as written, each product rounded (the JAX functions
    run eagerly: XLA's CPU backend, jitted, contracts u = fx X / Z + cx and
    the edge constants into multiply-adds). The edge constants c_k = x_i y_j
    - x_j y_i of the two faces of every edge are exact negatives, so no
    pixel centre falls between the faces; XLA's contracted fma(x_i, y_j,
    -(x_j y_i)) rounds one product and not the other, and most of its
    pairs are not (printed)."""
    verts_cam, _, K = (np.asarray(x) for x in _jax_zoom_crop(scene))
    faces, fv = scene["faces"].astype(np.int32), scene["face_valid"]

    def f(v, k):
        uv, _ = jproj.project(v, k[:, None, :])
        ec, _, valid, area2 = jraster._face_screen_data(
            uv[0], v[0, :, 2], jnp.asarray(faces), jnp.asarray(fv))
        return uv, ec, valid, area2

    uv_t, _ = tproj.project(_t(verts_cam), _t(K)[:, None, :])
    ec_t, _, valid_t, area_t, _ = traster._face_screen_data(
        uv_t, _t(verts_cam)[..., 2], _t(faces.astype(np.int64)), _t(fv))
    with jax.disable_jit():
        uv_j, ec_j, valid_j, area_j = f(verts_cam, K)
    _bits_equal(uv_j, uv_t)
    for k in range(3):
        _bits_equal(np.asarray(ec_j)[..., k], ec_t[0, ..., k])
    _bits_equal(area_j, area_t[0])
    assert np.array_equal(np.asarray(valid_j), valid_t[0].numpy())
    assert int(valid_t.sum()) == scene["nf"]

    rows, i, j = np.flatnonzero(fv), [1, 2, 0], [2, 0, 1]

    def by_edge(c):
        return {(faces[r, i[k]], faces[r, j[k]]): c[r, k] for r in rows for k in range(3)}

    uv_x, ec_x, _, _ = jax.jit(f)(verts_cam, K)
    port, xla = by_edge(ec_t[0, ..., 2].numpy()), by_edge(np.asarray(ec_x)[..., 2])
    shared = [(e, (e[1], e[0])) for e in port if e[0] < e[1] and (e[1], e[0]) in port]
    assert len(shared) > 3 * scene["nf"] // 4
    assert all(port[e] == -port[r] for e, r in shared)
    leaky = sum(xla[e] != -xla[r] for e, r in shared)
    print(f"XLA's contracted edge constants: {leaky} of {len(shared)} shared edges not "
          f"exact negatives; against XLA's forms the port's uv differ at "
          f"{int((np.asarray(uv_x) != uv_t.numpy()).sum())} of {uv_t.numel()} (max |d| "
          f"{np.abs(np.asarray(uv_x) - uv_t.numpy()).max():.3e} px), c at "
          f"{int((np.asarray(ec_x)[..., 2] != ec_t[0, ..., 2].numpy()).sum())} of "
          f"{ec_t[0, ..., 2].numel()}")
    assert leaky > len(shared) // 2


@pytest.mark.parametrize("size", [CROP, 30, 128])
def test_crop_source_coords_bit_equal(scene, size):
    """fma(i + 0.5, 2 half * f32(1/S), c - half) - 0.5, at the crop, its
    1/8 grid and another size."""
    _, cp, _ = _jax_zoom_crop(scene)
    ref = jax.jit(lambda c: jcrop.crop_source_coords(c, size))(cp)
    _bits_equal(ref, tcrop.crop_source_coords(_t(np.asarray(cp)), size))


@pytest.mark.parametrize("hw", [(240, 240), (30, 30), (64, 96)])
def test_normalize_coords_bit_equal(hw):
    """fma(2x, f32(1/(w-1)), -1)."""
    coords = (np.random.RandomState(0).rand(2, 40, 40, 2) * 260 - 10).astype(np.float32)
    ref = jax.jit(lambda c: jproj.normalize_coords(c, *hw))(coords)
    _bits_equal(ref, tproj.normalize_coords(_t(coords), *hw))


def test_render_iteration_1_raster_and_crop(scene):
    """Render iteration 1 at the full budget: the port's `rasterize` (plain
    sweep) against the JAX refiner's CPU raster (the scan sweep, jitted),
    and the observed crop. The coverage is equal. The port's edge
    constants are the watertight uncontracted ones (see
    `test_face_setup_bit_equal`), so the face ids differ only at a few pixels on a corner that
    the two winners share, and the covered depths by a median of at most
    5e-6. Against an f64 evaluation of each winner's edge functions the
    port's barycentrics and depths stay within a median of 2e-5 and 1e-5
    (JAX's printed beside them). The observed crop within 2.4e-7 (XLA's
    tent-matrix products sum in another order)."""
    verts_cam, cp, K = (np.asarray(x) for x in _jax_zoom_crop(scene))
    faces, fv = scene["faces"].astype(np.int32), scene["face_valid"]
    ref = jax.jit(lambda v, k: jraster.rasterize(
        v, jnp.asarray(faces), k, CROP, CROP, jnp.asarray(fv), chunk=128))(verts_cam, K)
    out = traster.rasterize(_t(verts_cam), _t(faces.astype(np.int64)), _t(K), CROP, CROP,
                            face_valid=_t(fv), chunk=128)
    fid_j, fid_t = np.asarray(ref.face_id)[0], out.face_id.numpy()[0]
    z_j, z_t = np.asarray(ref.zbuf)[0], out.zbuf.numpy()[0]
    covered = z_j > 0
    np.testing.assert_array_equal(z_t > 0, covered)
    assert covered.sum() > 20000
    differ = np.argwhere(fid_j != fid_t)
    assert len(differ) <= 8, len(differ)
    for y, x in differ:
        assert set(faces[fid_j[y, x]]) & set(faces[fid_t[y, x]]), (y, x)
    dz = np.abs(z_t - z_j)[covered]
    assert np.median(dz) <= 5e-6, np.median(dz)

    uv, _ = tproj.project(_t(verts_cam), _t(K)[:, None, :])
    uv = uv[0].double().numpy()
    zf = verts_cam[0, :, 2].astype(np.float64)[faces]
    ys, xs = np.mgrid[0:CROP, 0:CROP] + 0.5

    def errors(fid, bary, zbuf):
        """|bary - exact|, |depth - exact| at the covered pixels."""
        f, x, y = fid[covered], xs[covered], ys[covered]
        p = uv[faces[f]]
        e = np.stack([p[:, i, 0] * p[:, j, 1] - p[:, j, 0] * p[:, i, 1]
                      + (p[:, i, 1] - p[:, j, 1]) * x + (p[:, j, 0] - p[:, i, 0]) * y
                      for i, j in ((1, 2), (2, 0), (0, 1))], -1)
        b64 = e / e.sum(-1, keepdims=True)
        return (np.abs(bary[covered] - b64).max(-1),
                np.abs(zbuf[covered] - (b64 * zf[f]).sum(-1)))

    eb_t, ez_t = errors(fid_t, out.bary.numpy()[0], z_t)
    eb_j, ez_j = errors(fid_j, np.asarray(ref.bary)[0], z_j)
    print(f"face ids differ at {len(differ)} of {int(covered.sum())}, depth median |d| "
          f"{np.median(dz):.3e}; against f64, bary "
          f"max/median port {eb_t.max():.3e}/{np.median(eb_t):.3e}, JAX "
          f"{eb_j.max():.3e}/{np.median(eb_j):.3e}; depth port {ez_t.max():.3e}/"
          f"{np.median(ez_t):.3e}, JAX {ez_j.max():.3e}/{np.median(ez_j):.3e}")
    assert np.median(eb_t) <= 2e-5 and np.median(ez_t) <= 1e-5
    crop_j = jax.jit(lambda im, c: jsampler.separable_crop_sample(im, c, CROP))(
        scene["image"], cp)
    crop_t = tsampler.separable_crop_sample(_t(scene["image"]), _t(cp), CROP)
    assert np.abs(crop_t.numpy() - np.asarray(crop_j)).max() <= 2.4e-7


def _taylor_fns(module, fn, arg):
    """The Taylor-branch functions `fn` hands to `_taylor_switched`, in call
    order (the JAX ones captured while `fn` traces). The switch patched is
    `module`'s for the JAX package and, for the port, that of the module
    defining `fn` (`_A`, `_B` and `_C` live in `kernels/geometry`)."""
    if module is not jse3:
        module = sys.modules[fn.__module__]
    got = []
    orig = module._taylor_switched

    def capture(theta2, exact_fn, taylor_fn):
        got.append(taylor_fn)
        return orig(theta2, exact_fn, taylor_fn)

    module._taylor_switched = capture
    try:
        if module is jse3:
            jax.eval_shape(lambda a: fn(a), arg)  # a new function: traced anew
        else:
            fn(_t(arg))
    finally:
        module._taylor_switched = orig
    return got


# (function, index of the branch among its captured calls): A = sin(t)/t,
# B = (1 - cos t)/t^2, C = (t - sin t)/t^3 and the two logm series
# (`se3.py`'s five Taylor sites).
TAYLOR_SITES = {"A": ("_A", 0), "B": ("_B", 0), "C": ("_C", 0),
                "so3_logm": ("so3_logm", 0), "se3_logm": ("se3_logm", 1)}


@pytest.mark.parametrize("site", list(TAYLOR_SITES))
def test_se3_taylor_branch_bit_equal(site):
    """Each branch k0 + p1/d1 + p2/d2 is fma(p2, f32(1/d2), fma(p1,
    f32(1/d1), k0)), on seeded small angles t2 in [0, 0.5)."""
    name, idx = TAYLOR_SITES[site]
    arg = {"so3_logm": np.eye(3, dtype=np.float32)[None].repeat(8, 0),
           "se3_logm": np.eye(4, dtype=np.float32)[None].repeat(8, 0)}.get(
        name, np.full((8, 1, 1), 0.01, np.float32))
    fj = _taylor_fns(jse3, getattr(jse3, name), arg)[idx]
    ft = _taylor_fns(tse3, getattr(tse3, name), arg)[idx]
    t2 = (np.random.RandomState(0).rand(4096) * 0.5).astype(np.float32)
    _bits_equal(jax.jit(fj)(t2), ft(_t(t2)))


def test_se3_taylor_switch_takes_the_branch():
    """With the threshold raised, the switched functions return their
    Taylor branches in both packages, bit-equal."""
    t2 = (np.random.RandomState(1).rand(1024) * 0.5).astype(np.float32)[:, None, None]
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(jse3, "_TAYLOR_THETA2", 1.0)
        mp.setattr(kernel_geometry, "_TAYLOR_THETA2", 1.0)  # where the port's switch reads it
        for name in ("_A", "_B", "_C"):
            _bits_equal(jax.jit(getattr(jse3, name))(t2), getattr(tse3, name)(_t(t2)))
    finally:
        mp.undo()


def test_bilinear_sample_bit_equal():
    """The four taps' sum, contracted as XLA contracts the JAX form."""
    rs = np.random.RandomState(0)
    img = rs.rand(2, 60, 50, 32).astype(np.float32)
    coords = (rs.rand(2, 30, 30, 2) * 70 - 5).astype(np.float32)
    _bits_equal(jax.jit(jsampler.bilinear_sample)(img, coords),
                tsampler.bilinear_sample(_t(img), _t(coords)))


def test_headlight_shade_bit_equal():
    """colors * fma(diffuse, |n_z|, ambient)."""
    rs = np.random.RandomState(0)
    c = rs.rand(1, 64, 64, 3).astype(np.float32)
    n = rs.randn(1, 64, 64, 3).astype(np.float32)
    _bits_equal(jax.jit(jshading.headlight_shade)(c, n),
                tshading.headlight_shade(_t(c), _t(n)))


def test_clip_factor_bit_equal():
    """`max_norm / norm` divides once, at grad_clip 10: 1024 seeded
    one-element gradients in (10, 1e4), whose global norm is |g| exactly in
    both packages (a sum of many squares rounds by its order)."""
    rs = np.random.RandomState(0)
    g = (np.exp(rs.rand(1024) * np.log(1e3)) * 10.0 * np.sign(rs.randn(1024)))
    g = g.astype(np.float32)[:, None]
    tx = joptim.safe_clip_by_global_norm(10.0)
    clipped = jax.jit(jax.vmap(lambda a: tx.update([a], tx.init([a]))[0][0]))(g)
    for i in range(len(g)):
        grads = [_t(g[i].copy())]
        _bits_equal(np.abs(g[i]), toptim.safe_clip_by_global_norm(grads, 10.0)[None])
        _bits_equal(np.asarray(clipped)[i], grads[0])


def _power_of_two(x) -> bool:
    return isinstance(x, (int, float)) and x != 0 and math.frexp(abs(x))[0] == 0.5


def test_no_number_divided_by_tensor(monkeypatch):
    """The tiny forward (serving defaults, then the parity preset) and one
    training step divide no number but a power of two by a tensor."""
    from rnnpose_tpu_torch.data.synthetic import (
        SyntheticConfig, kpconv_config, make_synthetic_inputs)
    from rnnpose_tpu_torch.models.refiner import RefinerConfig
    from rnnpose_tpu_torch.models.rnnpose import (
        RNNPose, RNNPoseConfig, apply_parity_preset, init_random_)
    from rnnpose_tpu_torch.train.loop import Trainer
    from rnnpose_tpu_torch.train.optim import OptimizerConfig

    numerators = []
    rdiv = torch.Tensor.__rtruediv__

    def spy(self, other):
        numerators.append(other)
        return rdiv(self, other)

    monkeypatch.setattr(torch.Tensor, "__rtruediv__", spy)
    syn = SyntheticConfig(num_corr=64, kp_layers=3, kp_dl=0.015, **C.TINY_SCENE)
    inputs = make_synthetic_inputs(syn, with_corr=True)
    kp = kpconv_config(syn)
    cfg = RNNPoseConfig(
        desc_kp=dataclasses.replace(kp, final_feats_dim=32),
        ctx_kp=dataclasses.replace(kp, final_feats_dim=256, normalize_output=False),
        refiner=RefinerConfig(render_iters=2, gru_iters=2, **C.TINY_REFINER))
    model = init_random_(RNNPose(cfg), torch.Generator().manual_seed(0))
    with torch.no_grad():
        assert torch.isfinite(model(inputs)["Ti_pred"]).all()
        parity = RNNPose(apply_parity_preset(cfg))
        parity.load_state_dict(model.state_dict())
        assert torch.isfinite(parity(inputs)["Ti_pred"]).all()
    metrics = Trainer(model, OptimizerConfig(total_steps=4)).run_step(inputs)
    assert float(metrics["skipped_nonfinite"]) == 0.0
    assert numerators, "the spy saw no division"
    assert all(_power_of_two(x) for x in numerators), sorted(
        {repr(x) for x in numerators if not _power_of_two(x)})
