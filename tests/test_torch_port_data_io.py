"""The port's stand-ins for OpenCV and PyYAML on the host, against them:

* the PNG codec (`data/imageio.py`): PNGs that `cv2.imwrite` writes with
  each row filter (None, Sub, Up, Avg, Paeth and the adaptive mix) decode
  bit for bit, for 8-bit RGB, RGBA and gray and 16-bit depth; files the port
  writes read back through `cv2.imread` bit for bit; other formats raise;
* `preprocess.warp_affine` against `cv2.warpAffine`: INTER_NEAREST exact,
  INTER_LINEAR within 1e-5; `patch_crop` against the JAX package's (which
  calls cv2): depth, mask and K exact, image 1e-5;
* `transforms.gaussian_blur` against `cv2.GaussianBlur(img, (k, k), 0)`
  within 1e-5;
* `utils/config_io.read_yaml` reads a JSON config under `#` comments
  without PyYAML, and a YAML one through it.
"""
import json

import numpy as np
import pytest

import _torch_port_common  # noqa: F401  (pins torch to one thread)
from rnnpose_tpu_torch.data import imageio
from rnnpose_tpu_torch.data import preprocess as tprep
from rnnpose_tpu_torch.data.transforms import gaussian_blur, gaussian_kernel

cv2 = pytest.importorskip("cv2")

FILTERS = ["NONE", "SUB", "UP", "AVG", "PAETH", "ALL_FILTERS"]


def _images():
    """Seeded test images with flat, noisy and ramp regions (so the
    adaptive writer picks several filters)."""
    rs = np.random.RandomState(0)
    yy, xx = np.mgrid[0:75, 0:97]
    ramp = np.stack([xx * 2.5, yy * 3.1, xx + yy], -1)
    rgb = np.where(((xx // 12 + yy // 12) % 2 == 0)[..., None], rs.rand(75, 97, 3) * 255,
                   ramp).astype(np.uint8)
    depth = np.where(rs.rand(75, 97) > 0.3, 400 + xx * 7 + yy * 11 + rs.randint(0, 900, (75, 97)),
                     0).astype(np.uint16)
    return {"rgb": rgb, "rgba": np.concatenate([rgb, rgb[..., 1:2]], -1),
            "gray": rgb[..., 0].copy(), "depth": depth}


@pytest.mark.parametrize("kind", ["rgb", "rgba", "gray", "depth"])
@pytest.mark.parametrize("filt", FILTERS)
def test_png_written_by_cv2_decodes_bit_for_bit(kind, filt, tmp_path):
    img = _images()[kind]
    path = str(tmp_path / "x.png")
    flag = getattr(cv2, f"IMWRITE_PNG_{filt}" if filt == "ALL_FILTERS" else
                   f"IMWRITE_PNG_FILTER_{filt}")
    # cv2 stores the channels it is given as B, G, R(, A).
    bgr = img[..., [2, 1, 0, 3][:img.shape[-1]]] if img.ndim == 3 else img
    assert cv2.imwrite(path, bgr, [cv2.IMWRITE_PNG_FILTER, flag])
    got = imageio.read_png(path)
    assert got.dtype == img.dtype and got.shape == img.shape
    np.testing.assert_array_equal(got, img)
    if img.dtype == np.uint8:
        ref = cv2.cvtColor(cv2.imread(path, cv2.IMREAD_COLOR), cv2.COLOR_BGR2RGB)
        np.testing.assert_array_equal(imageio.read_rgb(path), ref)


def test_png_written_by_the_port_reads_back_through_cv2(tmp_path):
    imgs = _images()
    for kind in ("rgb", "rgba", "gray", "depth"):
        path = str(tmp_path / f"{kind}.png")
        imageio.write_png(path, imgs[kind])
        ref = cv2.imread(path, cv2.IMREAD_UNCHANGED)
        if ref.ndim == 3:
            ref = ref[..., [2, 1, 0, 3][:ref.shape[-1]]]
        np.testing.assert_array_equal(ref, imgs[kind])
        np.testing.assert_array_equal(imageio.read_png(path), imgs[kind])


def test_png_other_formats_raise_with_the_file_name(tmp_path):
    path = str(tmp_path / "pal.png")
    cv2.imwrite(path, np.zeros((4, 4, 3), np.uint16))  # 16-bit RGB: not taken
    with pytest.raises(ValueError, match="pal.png"):
        imageio.read_png(path)
    jpg = str(tmp_path / "x.jpg")
    cv2.imwrite(jpg, np.zeros((4, 4, 3), np.uint8))
    with pytest.raises(ValueError, match="x.jpg"):
        imageio.read_png(jpg)
    with pytest.raises(ValueError, match="cannot write"):
        imageio.write_png(str(tmp_path / "f.png"), np.zeros((4, 4), np.float32))


def _crop_matrix(rs, h, w):
    s = np.float32(rs.uniform(0.4, 3.5))
    sx0, sy0 = rs.uniform(-0.2 * w, 0.8 * w), rs.uniform(-0.2 * h, 0.8 * h)
    return np.asarray([[s, 0.0, -sx0 * s], [0.0, s, -sy0 * s]], np.float32)


@pytest.mark.parametrize("shape,size", [((96, 96, 3), 64), ((480, 640, 3), 320),
                                        ((75, 97), 50), ((96, 96, 3), 33)])
def test_warp_affine_matches_cv2(shape, size):
    """20 crops each: nearest exact (f32 depth and u8 mask), linear 1e-5."""
    rs = np.random.RandomState(size)
    for _ in range(20):
        img = rs.rand(*shape).astype(np.float32)
        M = _crop_matrix(rs, *shape[:2])
        np.testing.assert_allclose(
            tprep.warp_affine(img, M, (size, size), "linear"),
            cv2.warpAffine(img, M, (size, size), flags=cv2.INTER_LINEAR), atol=1e-5)
        depth = img[..., 0] if img.ndim == 3 else img
        mask = (depth > 0.5).astype(np.uint8)
        for src in (depth, mask):
            np.testing.assert_array_equal(
                tprep.warp_affine(src, M, (size, size), "nearest"),
                cv2.warpAffine(src, M, (size, size), flags=cv2.INTER_NEAREST))


def test_patch_crop_matches_jax():
    from rnnpose_tpu.data import preprocess as jprep

    rs = np.random.RandomState(1)
    K = np.asarray([[115.0, 0, 48], [0, 115.0, 48], [0, 0, 1]], np.float32)
    for _ in range(12):
        img = rs.rand(96, 96, 3).astype(np.float32)
        depth = (rs.rand(96, 96) * (rs.rand(96, 96) > 0.4)).astype(np.float32)
        mask = np.zeros((96, 96), bool)
        y0, x0 = rs.randint(0, 90, 2)
        mask[y0:y0 + rs.randint(1, 40), x0:x0 + rs.randint(1, 40)] = True
        got = tprep.patch_crop(img, depth, mask, K, 0.85, 64)
        ref = jprep.patch_crop(img, depth, mask, K, 0.85, 64)
        np.testing.assert_allclose(got[0], ref[0], atol=1e-5)
        for a, b in zip(got[1:], ref[1:]):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("k", [3, 5, 7, 9])
def test_gaussian_blur_matches_cv2(k):
    rs = np.random.RandomState(k)
    np.testing.assert_array_equal(gaussian_kernel(k),
                                  cv2.getGaussianKernel(k, 0, ktype=cv2.CV_32F)[:, 0])
    for shape in ((64, 64, 3), (37, 50, 3), (20, 31)):
        img = rs.rand(*shape).astype(np.float32)
        np.testing.assert_allclose(gaussian_blur(img, k), cv2.GaussianBlur(img, (k, k), 0),
                                   atol=1e-5)


def test_read_yaml_takes_json_without_pyyaml(tmp_path, monkeypatch):
    import sys

    from rnnpose_tpu_torch.utils.config_io import read_yaml

    cfg = {"train_config": {"steps": 3}, "basic": {"zoom_crop_size": [64, 64]}}
    path = tmp_path / "c.yml"
    path.write_text("# a comment\n# source: x\n" + json.dumps(cfg, indent=2) + "\n")
    monkeypatch.setitem(sys.modules, "yaml", None)  # importing yaml now raises
    assert read_yaml(str(path)) == cfg
    monkeypatch.undo()
    path.write_text("# yaml\ntrain_config:\n  steps: 3\n")
    assert read_yaml(str(path)) == {"train_config": {"steps": 3}}
