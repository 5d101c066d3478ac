"""The port's training-data helpers against the JAX package's, on the CPU.

* `data/samplers`: the index streams of `GivenIterationSampler` (seed-7
  permutations, contiguous shard slices, resume fast-forward), its epoch
  variant and `SequentialShardSampler`, exactly equal;
* `geometry/se3` (logm, quaternions) and `geometry/intrinsics` at 1e-5 (f32),
  the small-angle Taylor branches and every quaternion branch included;
* the JPEG decoder (`cpp/jpeg`, `data/imageio`): the committed fixtures
  against their stored sha256 (no cv2 needed), and they and files written
  here by `cv2.imwrite` (qualities 50 and 95, every chroma subsampling,
  restart intervals, progressive, gray) bit for bit equal to `cv2.imread`;
  a truncated file and the unsupported kinds raise ValueError naming it;
* `preprocess.resize_linear` against `cv2.resize` (INTER_LINEAR) at 1e-6,
  up and down;
* `tools/deepim_info`: the pickles of all four modes equal to the JAX
  tool's on a DeepIM-layout tree written here;
* `tools/bench_host_pipeline` runs at `--frames 2` on the CPU;
* on a card's machine (marked `cuda`), the decoder against the stored
  sha256 there.
"""
import hashlib
import json
import os
import pickle
from pathlib import Path

import numpy as np
import pytest
import torch

import _torch_port_common  # noqa: F401  (pins torch to one thread)
from rnnpose_tpu_torch.cpp import jpeg
from rnnpose_tpu_torch.data import imageio

FIXTURES = Path(jpeg.SOURCE).parent.parent / "testdata" / "jpeg"
with open(FIXTURES / "manifest.json") as _f:
    MANIFEST = json.load(_f)["files"]


# ---- samplers -----------------------------------------------------------

@pytest.mark.parametrize("size,iters,batch,shard,nshards,last_iter", [
    (10, 7, 3, 0, 1, -1),
    (10, 7, 3, 0, 1, 2),
    (5, 20, 2, 1, 3, -1),
    (5, 20, 2, 2, 3, 4),
    (13, 4, 8, 0, 2, 0),
    (1, 3, 1, 0, 1, 1),
])
def test_given_iteration_samplers_match_jax(size, iters, batch, shard, nshards, last_iter):
    from rnnpose_tpu.data import samplers as js
    from rnnpose_tpu_torch.data import samplers as ts

    kw = dict(total_iter=iters, batch_size=batch, shard_id=shard, num_shards=nshards,
              last_iter=last_iter)
    j, t = js.GivenIterationSampler(size, **kw), ts.GivenIterationSampler(size, **kw)
    assert list(t) == list(j) and len(t) == len(j) == len(list(j))
    np.testing.assert_array_equal(t.indices, j.indices)
    je, te = js.GivenIterationSamplerEpoch(size, **kw), ts.GivenIterationSamplerEpoch(size, **kw)
    assert list(te) == list(je)
    for k in range(nshards + 1):
        assert (list(ts.SequentialShardSampler(size, k, nshards + 1))
                == list(js.SequentialShardSampler(size, k, nshards + 1)))
        assert (len(ts.SequentialShardSampler(size, k, nshards + 1))
                == len(js.SequentialShardSampler(size, k, nshards + 1)))


# ---- se3 / intrinsics ---------------------------------------------------

def _rotations():
    from scipy.spatial.transform import Rotation

    rs = np.random.RandomState(0)
    rots = [Rotation.random(8, random_state=rs).as_matrix()]
    # Near the identity (the Taylor branches) and near half turns about each
    # axis (each quaternion branch in turn).
    rots.append(Rotation.from_rotvec(rs.randn(4, 3) * 1e-5).as_matrix())
    rots.append(np.eye(3)[None])
    for axis in np.eye(3):
        rots.append(Rotation.from_rotvec((axis * 3.0)[None]).as_matrix())
    return np.concatenate(rots).astype(np.float32)


def test_logm_and_quaternions_match_jax():
    from rnnpose_tpu.geometry import se3 as jse3
    from rnnpose_tpu_torch.geometry import se3 as tse3

    R = _rotations()
    rs = np.random.RandomState(1)
    T = np.tile(np.eye(4, dtype=np.float32), (len(R), 1, 1))
    T[:, :3, :3] = R
    T[:, :3, 3] = rs.randn(len(R), 3).astype(np.float32) * 0.1

    def close(t_out, j_out):
        np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), atol=1e-5, rtol=0)

    close(tse3.so3_logm(torch.from_numpy(R)), jse3.so3_logm(R))
    close(tse3.se3_logm(torch.from_numpy(T)), jse3.se3_logm(T))
    q_j = np.asarray(jse3.matrix_to_quat(R))
    q_t = tse3.matrix_to_quat(torch.from_numpy(R))
    close(q_t, q_j)
    # The branch taken (largest pivot) and the sign (w >= 0) as in JAX.
    assert (q_t[:, 0] >= 0).all()
    q = rs.randn(6, 4).astype(np.float32)
    close(tse3.quat_to_matrix(torch.from_numpy(q)), jse3.quat_to_matrix(q))
    t = rs.randn(6, 3).astype(np.float32)
    close(tse3.se3_from_quat_trans(torch.from_numpy(q), torch.from_numpy(t)),
          jse3.se3_from_quat_trans(q, t))
    # logm inverts expm, the small-angle twists included.
    xi = np.concatenate([rs.randn(5, 6) * 0.3, rs.randn(3, 6) * 1e-6]).astype(np.float32)
    np.testing.assert_allclose(tse3.se3_logm(tse3.se3_expm(torch.from_numpy(xi))).numpy(), xi,
                               atol=2e-5)


def test_intrinsics_match_jax():
    from rnnpose_tpu.geometry import intrinsics as ji
    from rnnpose_tpu_torch.geometry import intrinsics as ti

    rs = np.random.RandomState(2)
    k = (rs.rand(3, 4) * 300 + 50).astype(np.float32)
    depth = (rs.rand(2, 3, 64, 48) * (rs.rand(2, 3, 64, 48) > 0.3)).astype(np.float32)
    K = ti.intrinsics_vec_to_matrix(torch.from_numpy(k))
    np.testing.assert_array_equal(K.numpy(), np.asarray(ji.intrinsics_vec_to_matrix(k)))
    np.testing.assert_array_equal(ti.intrinsics_matrix_to_vec(K).numpy(), k)
    np.testing.assert_allclose(ti.scale_intrinsics(torch.from_numpy(k), 0.5, 0.25).numpy(),
                               np.asarray(ji.scale_intrinsics(k, 0.5, 0.25)), atol=1e-5)
    for scale in (0.125, 0.5, 1.0):
        d_t, k_t = ti.rescale_depth_and_intrinsics(torch.from_numpy(depth),
                                                   torch.from_numpy(k[:2, None]), scale)
        d_j, k_j = ji.rescale_depth_and_intrinsics(depth, k[:2, None], scale)
        np.testing.assert_array_equal(d_t.numpy(), np.asarray(d_j))
        np.testing.assert_allclose(k_t.numpy(), np.asarray(k_j), atol=1e-5)


# ---- JPEG ---------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(MANIFEST))
def test_committed_jpeg_fixtures_decode_to_their_stored_hash(name):
    """No cv2 needed: each fixture's decode (as RGB) hashes to the sha256 of
    `cv2.imread`'s decode stored beside it."""
    rgb = imageio.read_rgb(str(FIXTURES / name))
    entry = MANIFEST[name]
    assert list(rgb.shape) == entry["shape"] and rgb.dtype == np.uint8
    assert hashlib.sha256(np.ascontiguousarray(rgb).tobytes()).hexdigest() == entry["rgb_sha256"]


@pytest.mark.parametrize("name", sorted(MANIFEST))
def test_committed_jpeg_fixtures_equal_cv2(name):
    cv2 = pytest.importorskip("cv2")
    path = str(FIXTURES / name)
    np.testing.assert_array_equal(imageio.read_rgb(path), cv2.imread(path)[..., ::-1])
    gray = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    if gray.ndim == 2:  # a gray file reads as one channel, as cv2 leaves it
        np.testing.assert_array_equal(imageio.read_image(path), gray)


def _scene(h, w, seed):
    rs = np.random.RandomState(seed)
    y, x = np.mgrid[:h, :w].astype(np.float32)
    img = np.stack([x * 255 / w, y * 255 / h, ((x + y) % 48) * 5], -1) + rs.randn(h, w, 3) * 25
    return np.clip(img, 0, 255).astype(np.uint8)


@pytest.mark.parametrize("quality", [50, 95])
def test_cv2_written_jpegs_decode_bit_for_bit(tmp_path, quality):
    """Every chroma subsampling OpenCV writes, baseline and progressive,
    with and without a restart interval, gray too, at odd sizes: the decode
    equals `cv2.imread`'s bit for bit."""
    cv2 = pytest.importorskip("cv2")
    S = cv2.IMWRITE_JPEG_SAMPLING_FACTOR
    samplings = [cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
                 cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440,
                 cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411]
    checked = 0
    for k, (h, w) in enumerate([(93, 157), (37, 21), (8, 8), (2, 3)]):
        img = _scene(h, w, k)
        for prog in (0, 1):
            for rst in (0, 2):
                params = [cv2.IMWRITE_JPEG_QUALITY, quality, cv2.IMWRITE_JPEG_PROGRESSIVE, prog,
                          cv2.IMWRITE_JPEG_RST_INTERVAL, rst]
                variants = [(img, params + [S, s]) for s in samplings]
                variants.append((cv2.cvtColor(img, cv2.COLOR_RGB2GRAY), params))
                for v, (src, p) in enumerate(variants):
                    path = str(tmp_path / f"f{k}_{prog}_{rst}_{v}.jpg")
                    assert cv2.imwrite(path, src, p)
                    np.testing.assert_array_equal(imageio.read_rgb(path),
                                                  cv2.imread(path)[..., ::-1], err_msg=path)
                    checked += 1
    assert checked == 4 * 2 * 2 * 6


def test_bad_jpegs_raise_naming_the_file(tmp_path):
    data = (FIXTURES / "baseline_420_157x93.jpg").read_bytes()
    cases = {"truncated.jpg": data[:len(data) // 2], "cut_header.jpg": data[:40],
             "no_eoi.jpg": data[:-2]}
    sof = data.index(b"\xff\xc0")
    arith = bytearray(data)
    arith[sof + 1] = 0xC9  # SOF9: arithmetic coding
    cases["arith.jpg"] = bytes(arith)
    twelve = bytearray(data)
    twelve[sof + 4] = 12   # 12-bit samples
    cases["twelve.jpg"] = bytes(twelve)
    cmyk = bytearray(data)
    cmyk[sof + 9] = 4      # four components
    cases["cmyk.jpg"] = bytes(cmyk)
    expect = {"truncated.jpg": "truncated", "cut_header.jpg": "truncated",
              "no_eoi.jpg": "truncated", "arith.jpg": "arithmetic", "twelve.jpg": "12-bit",
              "cmyk.jpg": "4 components"}
    for name, body in cases.items():
        path = tmp_path / name
        path.write_bytes(body)
        with pytest.raises(ValueError, match=rf"{name}: .*{expect[name]}"):
            imageio.read_rgb(str(path))
    junk = tmp_path / "junk.jpg"
    junk.write_bytes(b"not an image at all")
    with pytest.raises(ValueError, match="junk.jpg: not a PNG or JPEG"):
        imageio.read_rgb(str(junk))


def test_decoder_build_or_load_failure_raises_runtime_error(tmp_path, monkeypatch):
    """A decoder that cannot be built or loaded is not an unreadable image:
    it raises RuntimeError, which the VOC paste lets through (no silent
    fallback to a frame without background)."""
    from types import SimpleNamespace

    from rnnpose_tpu_torch.cpp import native
    from rnnpose_tpu_torch.data.linemod import LinemodSynRealDataset

    voc = tmp_path / "voc"
    (voc / "VOCdevkit/VOC2012/JPEGImages").mkdir(parents=True)
    (voc / "VOCdevkit/VOC2012/ImageSets/Main").mkdir(parents=True)
    (voc / "VOCdevkit/VOC2012/JPEGImages/bg.jpg").write_bytes((FIXTURES / "gray.jpg").read_bytes())
    (voc / "VOCdevkit/VOC2012/ImageSets/Main/diningtable_trainval.txt").write_text("bg 1\n")

    def paste():
        image = np.zeros((8, 8, 3), np.float32)
        return LinemodSynRealDataset._paste_voc_background(
            SimpleNamespace(voc_root=str(voc)), image, image[..., 0] > 0,
            np.random.RandomState(0))

    monkeypatch.setattr(jpeg, "_lib", None)
    broken = tmp_path / "libjpeg_decode_broken.so"
    broken.write_bytes(b"not a shared library")
    monkeypatch.setattr(jpeg, "build", lambda: broken)
    with pytest.raises(RuntimeError, match="did not load"):
        paste()
    monkeypatch.undo()
    monkeypatch.setattr(jpeg, "_lib", None)
    monkeypatch.setattr(native, "_BUILD_DIR", tmp_path / "build")
    monkeypatch.setenv("PATH", "")
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        paste()


def test_resize_linear_matches_cv2():
    cv2 = pytest.importorskip("cv2")
    from rnnpose_tpu_torch.data.preprocess import resize_linear

    rs = np.random.RandomState(3)
    for (h, w) in [(375, 500), (93, 157), (64, 64)]:
        for (H, W) in [(480, 640), (96, 96), (40, 50), (93, 157), (3, 2)]:
            for img in (rs.rand(h, w, 3).astype(np.float32), rs.rand(h, w).astype(np.float32)):
                got = resize_linear(img, (W, H))
                ref = cv2.resize(img, (W, H))
                assert got.shape == ref.shape and got.dtype == np.float32
                np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0,
                                           err_msg=f"{(h, w)} -> {(H, W)}")


@pytest.mark.cuda
def test_jpeg_decoder_on_the_card_machine_matches_stored_hashes():
    """Where the port runs on a card (no cv2 there), the decoder built on
    that machine decodes every committed fixture to its stored sha256."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for name, entry in MANIFEST.items():
        rgb = imageio.read_rgb(str(FIXTURES / name))
        assert hashlib.sha256(rgb.tobytes()).hexdigest() == entry["rgb_sha256"], name


# ---- deepim_info ----------------------------------------------------------

def _pose_txt(path, RT):
    with open(path, "w") as f:
        f.write("pose\n")
        for row in RT:
            f.write(" ".join(repr(float(v)) for v in row) + "\n")


def _deepim_tree(root):
    """One tree with the layouts of all four generators: real observed
    frames and renders (orig), the synthetic split (syn), the PoseCNN-val
    split (posecnnval), and a PVNet-rendering walk under `pvnet/` (v2)."""
    rs = np.random.RandomState(4)
    png = np.zeros((8, 8, 3), np.uint8)
    cls, idx = "cat", 6
    gt = root / "data" / "gt_observed" / cls
    split = root / "image_set" / "observed"
    for d in (gt, split):
        d.mkdir(parents=True, exist_ok=True)
    layouts = {
        "orig": (f"{idx:02d}", root / "data" / "rendered" / cls, "{i:06d}_{r}", 2,
                 f"{cls}_train.txt", (3, 7)),
        "syn": (cls, root / "data" / "rendered" / cls, "cat_{i:06d}_{r}", 1,
                f"LM6d_data_syn_train_observed_{cls}.txt", (1, 4)),
        "posecnnval": (f"{idx:02d}", root / "data" / "rendered" / f"{idx:02d}" / cls,
                       "cat_{i:06d}_{r}", 1, f"{cls}_test.txt", (2, 5)),
    }
    for obs_name, ren, stem, n_ren, split_name, ids in layouts.values():
        obs = root / "data" / "observed" / obs_name
        obs.mkdir(parents=True, exist_ok=True)
        ren.mkdir(parents=True, exist_ok=True)
        for i in ids:
            RT = np.concatenate([np.eye(3), rs.randn(3, 1)], 1)
            _pose_txt(gt / f"{i:06d}-pose.txt", RT)
            for name in (f"{i:06d}-color.png", f"{i:06d}-depth.png"):
                imageio.write_png(str(obs / name), png)
            for r in range(n_ren):
                s = stem.format(i=i, r=r)
                imageio.write_png(str(ren / f"{s}-color.png"), png)
                imageio.write_png(str(ren / f"{s}-depth.png"), png)
                _pose_txt(ren / f"{s}-pose.txt", RT + rs.randn(3, 4) * 0.01)
        with open(split / split_name, "a") as f:
            f.write("".join(f"{obs_name}/{i:06d}\n" for i in ids))
    pv = root / "pvnet" / cls
    pv.mkdir(parents=True)
    for i in range(5):
        (pv / f"{i}.jpg").write_bytes((FIXTURES / "gray.jpg").read_bytes())
        np.save(pv / f"{i}_depth.npy", np.zeros((4, 4), np.float32))
        with open(pv / f"{i}_params.pkl", "wb") as f:
            pickle.dump({"RT": np.concatenate([np.eye(3), rs.randn(3, 1)], 1),
                         "K": np.eye(3) * 500, "bbox": [1, 2, 3, 4]}, f)
    conv = np.eye(4)
    conv[:3, 3] = [0.01, -0.02, 0.03]
    np.save(root / "b2b.npy", {cls: conv}, allow_pickle=True)


def _assert_same(a, b, where=""):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            _assert_same(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{where}[{i}]")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype, where
        np.testing.assert_array_equal(a, b, err_msg=where)
    else:
        assert a == b, where


def test_deepim_info_pickles_match_jax(tmp_path):
    from rnnpose_tpu.tools.deepim_info import main as jmain
    from rnnpose_tpu_torch.tools.deepim_info import main as tmain

    _deepim_tree(tmp_path)
    runs = [["orig", "--num_rendered", "2"], ["syn"], ["posecnnval"],
            ["v2", "--blender_to_bop", str(tmp_path / "b2b.npy"), "--ratio", "0.6"]]
    for args in runs:
        root = str(tmp_path / "pvnet") if args[0] == "v2" else str(tmp_path)
        outs = {}
        for pkg, run in (("jax", jmain), ("port", tmain)):
            out = str(tmp_path / f"{pkg}_{args[0]}")
            run(args + ["--data_root", root, "--out", out, "--classes", "cat"])
            for suffix in (".train", ".eval"):
                if os.path.exists(out + suffix):
                    with open(out + suffix, "rb") as f:
                        outs.setdefault(pkg, {})[suffix] = pickle.load(f)
        assert outs["port"].keys() == outs["jax"].keys()
        _assert_same(outs["port"], outs["jax"], args[0])
        frames = next(iter(outs["port"].values()))["cat"]
        assert frames, args[0]
        assert all(f["is_syn"] for f in frames) == (args[0] in ("syn", "v2"))


# ---- bench_host_pipeline --------------------------------------------------

def test_bench_host_pipeline_runs_on_the_cpu(capsys):
    from rnnpose_tpu_torch.tools.bench_host_pipeline import main

    summary = main(["--frames", "2", "--samples", "3", "--threads", "1", "2",
                    "--device", "cpu"])
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert last == summary and set(last["per_threads"]) == {"1", "2"}
    assert last["value"] > 0 and last["single_thread_ms"] > 0
    assert last["device_budget_samples_per_sec"] == round(1000.0 / 559.1, 2)
