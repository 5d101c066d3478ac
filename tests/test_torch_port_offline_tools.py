"""The port's offline tools against the JAX package's, and the codecs they
need in place of OpenCV:

* `tools/make_configs`: every class file, read with `yaml.safe_load`, equal
  to the JAX tool's, with and without `--occ`;
* `tools/transform_pvnet_data` over the fixtures of
  `tests/test_offline_tooling.py` (syn with a crop, fuse_single) and a
  multi-object fuse and a syn_lmk layout: every written file (JPEG, depth
  `.npy`, `_params.pkl`, mask PNG) byte-equal to the JAX tool's;
* `cpp/jpeg.encode` byte-equal to `cv2.imencode(".jpg")` on the committed
  JPEG fixtures (decoded), a 4:2:0 image of odd size and a gray one;
  `data/imageio.write_png` byte-equal to `cv2.imencode(".png")`;
* `data/preprocess.resize_nearest` equal to `cv2.resize(INTER_NEAREST)` and
  `resize_linear` on uint8 equal to `cv2.resize(INTER_LINEAR)`, over up-
  and down-scales.
"""
import glob
import os
import pickle

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")
yaml = pytest.importorskip("yaml")

import _torch_port_common  # noqa: E402,F401  (pins torch to one thread)
from test_offline_tooling import _make_pvnet_syn, _png  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JPEG_DIR = os.path.join(REPO, "rnnpose_tpu_torch", "testdata", "jpeg")


@pytest.mark.parametrize("occ", [False, True])
def test_make_configs_equal_jax(tmp_path, occ, capsys):
    from rnnpose_tpu.tools.make_configs import main as jax_main
    from rnnpose_tpu_torch.tools.make_configs import main as port_main
    from rnnpose_tpu_torch.utils.config_io import read_yaml

    flags = ["--info_root", "/data/infos", "--data_root", "/data/LM6d"] + (["--occ"] if occ
                                                                         else [])
    jax_main(["--out_dir", str(tmp_path / "jax")] + flags)
    jax_out = capsys.readouterr().out
    names = port_main(["--out_dir", str(tmp_path / "port")] + flags)
    assert capsys.readouterr().out == jax_out
    assert sorted(os.listdir(tmp_path / "jax")) == sorted(os.listdir(tmp_path / "port")) \
        == sorted(names)
    assert len(names) == 13
    for name in names:
        with open(tmp_path / "jax" / name) as f:
            want = yaml.safe_load(f)
        with open(tmp_path / "port" / name) as f:
            assert yaml.safe_load(f) == want, name
        assert read_yaml(str(tmp_path / "port" / name)) == want


def _tree(root):
    return sorted(os.path.relpath(p, root) for p in glob.glob(os.path.join(root, "**", "*"),
                                                               recursive=True)
                  if os.path.isfile(p))


def _assert_same_files(a, b):
    files = _tree(a)
    assert files and files == _tree(b)
    for rel in files:
        with open(os.path.join(a, rel), "rb") as fa, open(os.path.join(b, rel), "rb") as fb:
            assert fa.read() == fb.read(), rel


def _fuse_fixture(root, depth_root, single, crop_rs=0):
    """A fuse composite of `cat` (class slot 2, mask id 3) or, `single`, the
    single-object layout, as `test_process_fuse_single` lays it out."""
    cls = "cat"
    os.makedirs(os.path.join(root, cls), exist_ok=True)
    os.makedirs(os.path.join(depth_root, cls), exist_ok=True)
    K = np.array([[572.4114, 0, 325.2611], [0, 573.57043, 242.04899], [0, 0, 1]], np.float32)
    H, W = 480, 640
    info = {cls: []}
    slot = 0 if single else 2
    for i in range(2):
        rng = np.ones((H, W), np.float32)
        y0, x0 = 100 + 20 * i, 200 + 30 * i
        ys, xs = np.mgrid[y0:y0 + 40, x0:x0 + 60]
        ray = np.sqrt(K[0, 0] ** 2 + (K[0, 2] - xs - 0.5) ** 2 + (K[1, 2] - ys - 0.5) ** 2)
        rng[y0:y0 + 40, x0:x0 + 60] = (0.8 * ray / K[0, 0]) / 2.0
        np.save(os.path.join(depth_root, cls, f"{5 + i}_depth.png.npy"), rng)
        stem = os.path.join(root, cls, str(i)) if single else os.path.join(root, "", str(i))
        _png(stem + "_rgb.jpg", (H, W))
        m = np.zeros((H, W, 3), np.uint8)
        m[y0 + 10:y0 + 30, x0 + 10:x0 + 50, 0] = slot + 1
        m[y0:y0 + 5, x0:x0 + 5, 0] = slot + 2  # another object
        cv2.imwrite(stem + "_mask.png", m)
        RT = np.eye(4)[:3].astype(np.float32)
        RT[2, 3] = 0.8 + 0.01 * i
        offsets = [(10, 20)] * 3
        with open(stem + "_info.pkl", "wb") as f:
            pickle.dump((offsets, [RT] * 3, [{"img_idx": 5 + i}] * 3), f)
        info[cls].append({"index": i, "image_path": os.path.join(cls, f"{i}.jpg"),
                          "depth_path": ""})
    return info


def _syn_lmk_fixture(root):
    info = _make_pvnet_syn(root, n=2)
    for fr in info["cat"]:
        K = np.array([[600.0, 0, 30.0], [0, 610.0, 25.0], [0, 0, 1]])
        with open(os.path.join(root, fr["image_path"].replace(".jpg", "_RT.pkl")), "wb") as f:
            pickle.dump({"K": K, "RT": np.asarray(fr["RT"])}, f)
    return info


@pytest.mark.parametrize("mode,crop", [("syn", {"margin_ratio": 0.1, "output_size": 32}),
                                       ("syn", None), ("syn_lmk", {"margin_ratio": 0.2,
                                                                   "output_size": 48}),
                                       ("fuse_single", None),
                                       ("fuse", {"margin_ratio": 0.1, "output_size": 64})])
def test_transform_pvnet_data_writes_the_jax_tools_bytes(tmp_path, mode, crop):
    from rnnpose_tpu.tools import transform_pvnet_data as J
    from rnnpose_tpu_torch.tools import transform_pvnet_data as T

    src, dep = str(tmp_path / "src"), str(tmp_path / "renders")
    os.makedirs(src)
    outs = {}
    if mode in ("syn", "syn_lmk"):
        info = _make_pvnet_syn(src, n=3) if mode == "syn" else _syn_lmk_fixture(src)
        for name, mod in (("jax", J), ("port", T)):
            outs[name] = str(tmp_path / name)
            n = mod.process_syn(info, src, outs[name], crop, use_lmk=mode == "syn_lmk")
            assert n == len(info["cat"])
    else:
        info = _fuse_fixture(src, dep, single=mode == "fuse_single")
        for name, mod in (("jax", J), ("port", T)):
            outs[name] = str(tmp_path / name)
            assert mod.process_fuse(info, src, dep, outs[name], crop,
                                    single=mode == "fuse_single") == 2
        assert any(f.endswith("_mask_visb.png") for f in _tree(outs["port"]))
    _assert_same_files(outs["jax"], outs["port"])


def test_transform_pvnet_data_cli(tmp_path, capsys):
    from rnnpose_tpu_torch.tools.transform_pvnet_data import main

    src = str(tmp_path / "src")
    os.makedirs(src)
    info = _make_pvnet_syn(src, n=2)
    with open(tmp_path / "info.pkl", "wb") as f:
        pickle.dump(info, f)
    assert main(["syn", "--data_info", str(tmp_path / "info.pkl"), "--data_root", src,
                 "--save_root", str(tmp_path / "out"), "--crop_size", "32"]) == 2
    assert "wrote 2 frames" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        main(["fuse", "--data_info", str(tmp_path / "info.pkl"), "--data_root", src,
              "--save_root", str(tmp_path / "out2")])


def _jpeg_cases():
    from rnnpose_tpu_torch.data.imageio import read_jpeg

    rs = np.random.RandomState(0)
    cases = {os.path.basename(p): read_jpeg(p) for p in sorted(glob.glob(
        os.path.join(JPEG_DIR, "*.jpg")))}
    cases["rgb_420_odd_157x93"] = rs.randint(0, 256, (93, 157, 3)).astype(np.uint8)
    y, x = np.mgrid[0:61, 0:77]
    cases["smooth_61x77"] = np.stack([(3 * x) % 256, (4 * y) % 256, (x + y) % 256],
                                     -1).astype(np.uint8)
    cases["gray_45x51"] = rs.randint(0, 256, (45, 51)).astype(np.uint8)
    cases["one_pixel"] = np.array([[[10, 200, 30]]], np.uint8)
    return cases


def test_jpeg_encoder_writes_cv2s_bytes():
    from rnnpose_tpu_torch.cpp import jpeg

    cases = _jpeg_cases()
    assert len(cases) >= 9
    for name, img in cases.items():
        bgr = img[..., ::-1] if img.ndim == 3 else img
        for quality in (95, 75):
            want = cv2.imencode(".jpg", np.ascontiguousarray(bgr),
                                [cv2.IMWRITE_JPEG_QUALITY, quality])[1].tobytes()
            assert jpeg.encode(img, quality) == want, (name, quality)
    with pytest.raises(ValueError, match="uint8"):
        jpeg.encode(np.zeros((4, 4, 2), np.uint8))


def test_write_jpeg_and_png_write_cv2s_bytes(tmp_path):
    from rnnpose_tpu_torch.data import imageio

    rs = np.random.RandomState(1)
    for name, img in (("rgb", rs.randint(0, 256, (33, 47, 3)).astype(np.uint8)),
                      ("gray", rs.randint(0, 256, (20, 9)).astype(np.uint8)),
                      ("mask", (rs.rand(48, 64) > 0.5).astype(np.uint8) * 255),
                      ("column", rs.randint(0, 256, (7, 1)).astype(np.uint8)),
                      ("depth16", rs.randint(0, 65535, (30, 40)).astype(np.uint16)),
                      ("rgba", rs.randint(0, 256, (15, 16, 4)).astype(np.uint8))):
        bgr = img[..., [2, 1, 0, 3][:img.shape[2]]] if img.ndim == 3 else img
        path = str(tmp_path / f"{name}.png")
        imageio.write_png(path, img)
        with open(path, "rb") as f:
            assert f.read() == cv2.imencode(".png", np.ascontiguousarray(bgr))[1].tobytes(), name
        np.testing.assert_array_equal(imageio.read_png(path), img)
        if img.dtype == np.uint8 and (img.ndim == 2 or img.shape[2] == 3):
            path = str(tmp_path / f"{name}.jpg")
            imageio.write_jpeg(path, img)
            with open(path, "rb") as f:
                assert f.read() == cv2.imencode(".jpg", np.ascontiguousarray(bgr))[1].tobytes()


SIZES = [(30, 30), (37, 53), (7, 7), (160, 120), (1, 1), (5, 2)]
OUTS = [(32, 32), (128, 128), (16, 16), (50, 70), (3, 5), (1, 1)]


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_resizes_equal_cv2(dtype):
    from rnnpose_tpu_torch.data.preprocess import resize_linear, resize_nearest

    rs = np.random.RandomState(2)
    for h, w in SIZES:
        for out in OUTS:
            for shape in ((h, w), (h, w, 3)):
                img = (rs.rand(*shape) * 255).astype(dtype)
                np.testing.assert_array_equal(
                    resize_nearest(img, out), cv2.resize(img, out, interpolation=cv2.INTER_NEAREST))
                if dtype == np.uint8:
                    np.testing.assert_array_equal(
                        resize_linear(img, out),
                        cv2.resize(img, out, interpolation=cv2.INTER_LINEAR))
    with pytest.raises(TypeError, match="float32 or uint8"):
        resize_linear(np.zeros((4, 4), np.float64), (2, 2))
