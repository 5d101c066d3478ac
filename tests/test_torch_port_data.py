"""The port's host data path against the JAX package's, on the CPU.

* mesh loaders (OBJ with colours and polygons, ASCII and binary PLY),
  `normalize_mesh`, `decimate_mesh`, the pose helpers, `normalize_model`,
  `mask_depth_to_points`, the correspondence search and the correspondence
  set from one `RandomState`: exactly equal;
* `LinemodSynRealDataset` on an on-disk fixture written by the JAX
  package's `make_synthetic_linemod --occ` (96^2 frames): eval samples with
  the PoseCNN pickle and with the PVNet-occ npy (blender->bop), train
  samples (noisy inits, blur + jitter, correspondences): poses, crop
  intrinsics, depth and correspondences exact, images within 1e-5 (the
  warp's linear interpolation; OpenCV on the JAX side); `collate_samples`
  equal to the JAX collate; a frame without `index` raises; a synthetic
  frame under a `voc_root` without the VOC list keeps its image and draws
  nothing, as in JAX; `build_dataset` from the written config;
* the port's `make_synthetic_linemod` against the JAX writer at the same
  seed: poses, info pickles, init poses, the occ npys and the config
  equal; decoded pixels equal except where the two renders round apart
  (at most one unit, under 2% of the pixels) and at face-edge ties (more,
  at most 3 pixels a frame), which the test counts;
* a hand-built DeepIM-format fixture in the reference's own layouts
  (float64 poses and K, a `model_path` field, a PoseCNN pickle of float64
  quaternions, a PVNet-occ npy holding an (N, 3, 4) array): the same
  samples as the JAX dataset's;
* `generate_data_info` and the prefetch loaders against the JAX ones.

Both packages build the KPConv pyramid with numpy here (the native version
orders equal-distance neighbours differently).
"""
import json
import pickle

import numpy as np
import pytest
import torch

import _torch_port_common  # noqa: F401  (pins torch to one thread)
import rnnpose_tpu.data.pyramid as jpyr
import rnnpose_tpu_torch.data.pyramid as tpyr
from rnnpose_tpu.data import linemod as jlm
from rnnpose_tpu.data import preprocess as jprep
from rnnpose_tpu.models.kpconv_net import KPConvConfig as JKP
from rnnpose_tpu_torch.data import imageio
from rnnpose_tpu_torch.data import linemod as tlm
from rnnpose_tpu_torch.data import preprocess as tprep
from rnnpose_tpu_torch.models.kpconv_net import KPConvConfig as TKP

pytest.importorskip("cv2")

FIXTURE_ARGS = ["--frames", "4", "--eval_frames", "3", "--height", "96", "--width", "96",
                "--fx", "115.0", "--fy", "115.0", "--cx", "48.0", "--cy", "48.0",
                "--object_scale", "0.05", "--distance", "0.4", "--batch", "7", "--occ"]
PREP = dict(crop_size=64, num_corr=64, correspondence_radius=0.05, min_correspondences=5)


@pytest.fixture(scope="module")
def numpy_pyramids():
    mp = pytest.MonkeyPatch()
    mp.setattr(jpyr, "_cpp", lambda: None)
    mp.setattr(tpyr, "_cpp", lambda: None)
    yield
    mp.undo()


@pytest.fixture(scope="module")
def written(tmp_path_factory):
    """The same tiny dataset written by both packages' writers."""
    from rnnpose_tpu.tools.make_synthetic_linemod import main as jwrite
    from rnnpose_tpu_torch.tools.make_synthetic_linemod import main as twrite

    root = tmp_path_factory.mktemp("lm")
    jwrite(["--out", str(root / "jax")] + FIXTURE_ARGS)
    twrite(["--out", str(root / "port"), "--device", "cpu"] + FIXTURE_ARGS)
    return root / "jax", root / "port"


def _datasets(root, **kw):
    common = dict(root_paths=[str(root)], model_dir=str(root / "models"), max_verts=256,
                  max_faces=512, **kw)
    j = jlm.LinemodSynRealDataset(kp_cfg=JKP(num_layers=2, first_subsampling_dl=0.02),
                                  prep_cfg=jprep.PreprocessConfig(**PREP), **common)
    t = tlm.LinemodSynRealDataset(kp_cfg=TKP(num_layers=2, first_subsampling_dl=0.02),
                                  prep_cfg=tprep.PreprocessConfig(**PREP), **common)
    return j, t


def _check_sample(s_t, s_j):
    assert s_t["class_name"] == s_j["class_name"]
    np.testing.assert_allclose(s_t["image"], s_j["image"], atol=1e-5)
    for key in ("intrinsics", "orig_intrinsics", "T_gt", "T_init", "depth"):
        np.testing.assert_array_equal(s_t[key], s_j[key], err_msg=key)
    assert (s_t["corr"] is None) == (s_j["corr"] is None)
    if s_t["corr"] is not None:
        for f in s_t["corr"]._fields:
            np.testing.assert_array_equal(getattr(s_t["corr"], f), getattr(s_j["corr"], f),
                                          err_msg=f)


def test_eval_samples_and_collate_match_jax(written, numpy_pyramids):
    root = written[0]
    j, t = _datasets(root, info_paths=[str(root / "cat_eval.info")], is_train=False,
                     init_pose_paths={"POSECNN_LINEMOD": str(root / "cat_init_poses.pkl")})
    assert len(t) == len(j) == 3
    samples_t, samples_j = [t[i] for i in range(3)], [j[i] for i in range(3)]
    for s_t, s_j in zip(samples_t, samples_j):
        _check_sample(s_t, s_j)
        assert not np.allclose(s_t["T_init"], s_t["T_gt"], atol=1e-4)  # a noisy init
    b_t = tlm.collate_samples(samples_t, device="cpu")
    b_j = jlm.collate_samples(samples_j)
    for f in ("image", "intrinsics", "T_init", "T_gt", "model_points", "point_valid"):
        np.testing.assert_allclose(getattr(b_t, f).numpy(), getattr(b_j, f), atol=1e-5,
                                   err_msg=f)
    for f in ("verts", "faces", "colors", "vert_valid", "face_valid", "normals"):
        np.testing.assert_array_equal(getattr(b_t.mesh, f).numpy(), getattr(b_j.mesh, f),
                                      err_msg=f)
    assert b_t.mesh.faces.dtype == torch.int64 and b_t.corr is None
    for level in range(2):
        for f in ("points", "masks", "neighbors"):
            np.testing.assert_array_equal(getattr(b_t.pyramid, f)[level].numpy(),
                                          getattr(b_j.pyramid, f)[level], err_msg=f)
    for f in ("pools", "upsamples"):
        np.testing.assert_array_equal(getattr(b_t.pyramid, f)[0].numpy(),
                                      getattr(b_j.pyramid, f)[0], err_msg=f)


def test_occ_samples_match_jax(written, numpy_pyramids):
    root = written[0]
    kw = dict(info_paths=[str(root / "cat_test_occ.info")], is_train=False,
              init_pose_type="PVNET_LINEMOD_OCC",
              init_pose_paths={"PVNET_LINEMOD_OCC": str(root / "pvnet_catocc_test.npy")},
              blender_to_bop_path=str(root / "blender2bop_RT.npy"))
    j, t = _datasets(root, **kw)
    with open(root / "cat_init_poses.pkl", "rb") as f:
        posecnn = pickle.load(f)["cat"]
    for i in range(3):
        s_t = t[i]
        _check_sample(s_t, j[i])
        # The blender->bop conversion lands on the PoseCNN pickle's init.
        q = np.asarray(posecnn[t.frames[i]["index"]]["pose"], np.float32)
        np.testing.assert_allclose(s_t["T_init"][:3], tlm.quat_pose_to_matrix(q), atol=1e-4)


def test_train_samples_match_jax(written, numpy_pyramids):
    root = written[0]
    j, t = _datasets(root, info_paths=[str(root / "cat_train.info")], is_train=True, seed=3)
    for i in (0, 1, 2, 3, 0):  # the dataset-lifetime random stream
        _check_sample(t[i], j[i])
    for i, pos in ((1, 5), (2, 17)):
        _check_sample(t.sample_at(i, pos), j.sample_at(i, pos))
    b_t = tlm.collate_samples([t.sample_at(0, 0), t.sample_at(1, 1)])
    b_j = jlm.collate_samples([j.sample_at(0, 0), j.sample_at(1, 1)])
    for f in b_t.corr._fields:
        np.testing.assert_array_equal(getattr(b_t.corr, f).numpy(), getattr(b_j.corr, f))


@pytest.fixture(scope="module")
def deepim(tmp_path_factory):
    """The layouts of the reference's own info files and init-pose results
    (tests/test_occ_and_deepim_format.py builds the same for the JAX
    package alone)."""
    from scipy.spatial.transform import Rotation

    from rnnpose_tpu_torch.data.synthetic import make_icosphere

    root = tmp_path_factory.mktemp("deepim")
    rs = np.random.RandomState(3)
    K = np.asarray([[115.0, 0.0, 48.0], [0.0, 115.0, 48.0], [0.0, 0.0, 1.0]], np.float64)
    mesh = make_icosphere(2, 0.05)
    (root / "models" / "cat").mkdir(parents=True)
    with open(root / "models" / "cat" / "textured.obj", "w") as f:
        for v, c in zip(mesh.verts, mesh.vert_colors):
            f.write("v {} {} {} {} {} {}\n".format(*v, *c))
        for a, b, c in mesh.faces + 1:
            f.write(f"f {a} {b} {c}\n")
    (root / "observed").mkdir()
    conv = np.eye(4)
    conv[:3, :3] = Rotation.from_euler("zx", [90, 180], degrees=True).as_matrix()
    conv[:3, 3] = [0.002, 0.005, -0.004]
    frames, quats, blender = [], [], []
    for i in range(3):
        RT = np.zeros((3, 4))
        RT[:, :3] = Rotation.random(random_state=rs).as_matrix()
        RT[:, 3] = [rs.uniform(-0.02, 0.02), rs.uniform(-0.02, 0.02), 0.42]
        pc = mesh.verts @ RT[:, :3].T + RT[:, 3]
        pix = np.round(pc[:, :2] / pc[:, 2:3] * 115.0 + 48.0).astype(int)
        rgb = (rs.rand(96, 96, 3) * 40).astype(np.uint8)
        depth = np.zeros((96, 96), np.uint16)
        ok = ((pix >= 1) & (pix < 95)).all(1)
        for (x, y), z, col in zip(pix[ok], pc[ok, 2], mesh.vert_colors[ok]):
            rgb[y - 1:y + 2, x - 1:x + 2] = (col * 255).astype(np.uint8)
            depth[y - 1:y + 2, x - 1:x + 2] = int(z * 1000)
        imageio.write_png(str(root / "observed" / f"{i:06d}-color.png"), rgb)
        imageio.write_png(str(root / "observed" / f"{i:06d}-depth.png"), depth)
        frames.append({"index": i, "model_path": "models/cat/textured.obj",
                       "rgb_observed_path": f"observed/{i:06d}-color.png",
                       "depth_gt_observed_path": f"observed/{i:06d}-depth.png",
                       "gt_pose": RT, "K": K})
        Rn = Rotation.from_euler("xyz", rs.uniform(-8, 8, 3), degrees=True).as_matrix() @ RT[:, :3]
        tn = RT[:, 3] + rs.uniform(-0.01, 0.01, 3)
        q = Rotation.from_matrix(Rn).as_quat()
        quats.append(np.asarray([q[3], q[0], q[1], q[2], *tn]))
        blender.append(np.concatenate([Rn @ conv[:3, :3], (tn + Rn @ conv[:3, 3])[:, None]], 1))
    with open(root / "cat_test.info", "wb") as f:
        pickle.dump({"cat": frames}, f)
    with open(root / "posecnn.pkl", "wb") as f:
        pickle.dump({"cat": {i: {"pose": q} for i, q in enumerate(quats)}}, f)
    np.save(root / "pvnet.npy", {"cat": np.stack(blender)}, allow_pickle=True)
    np.save(root / "b2b.npy", {"cat": conv}, allow_pickle=True)
    return root


@pytest.mark.parametrize("init", ["POSECNN_LINEMOD", "PVNET_LINEMOD_OCC"])
def test_reference_layouts_match_jax(deepim, init, numpy_pyramids):
    root = deepim
    path = str(root / ("posecnn.pkl" if init == "POSECNN_LINEMOD" else "pvnet.npy"))
    j, t = _datasets(root, info_paths=[str(root / "cat_test.info")], is_train=False,
                     init_pose_type=init, init_pose_paths={init: path},
                     blender_to_bop_path=str(root / "b2b.npy"))
    for i in range(3):
        s_t = t[i]
        _check_sample(s_t, j[i])
        assert s_t["T_gt"].dtype == np.float32
    b_t, b_j = tlm.collate_samples([t[0], t[2]]), jlm.collate_samples([j[0], j[2]])
    np.testing.assert_array_equal(b_t.T_init.numpy(), b_j.T_init)


def test_dataset_refusals(written, tmp_path, numpy_pyramids):
    root = written[0]
    with open(root / "cat_eval.info", "rb") as f:
        frames = pickle.load(f)["cat"]
    bad = tmp_path / "noindex.info"
    with open(bad, "wb") as f:
        pickle.dump({"cat": [{k: v for k, v in frames[0].items() if k != "index"}]}, f)
    _, t = _datasets(root, info_paths=[str(bad)], is_train=False,
                     init_pose_paths={"POSECNN_LINEMOD": str(root / "cat_init_poses.pkl")})
    with pytest.raises(KeyError, match="no 'index' field"):
        t[0]
    syn = tmp_path / "syn.info"
    with open(syn, "wb") as f:
        pickle.dump({"cat": [dict(frames[0], is_syn=True)]}, f)
    # A VOC root without the list file: the frame keeps its image and draws
    # nothing, as in the JAX package.
    j, t = _datasets(root, info_paths=[str(syn)], is_train=True, voc_root=str(tmp_path / "voc"))
    _check_sample(t[0], j[0])
    _, t_plain = _datasets(root, info_paths=[str(syn)], is_train=True)
    _check_sample(t.sample_at(0, 3), t_plain.sample_at(0, 3))


def test_class_assets_are_built_once_under_contention(written, numpy_pyramids):
    """Eight threads ask for one class's assets at once (a short switch
    interval forces interleaving): one build, one shared result."""
    import sys
    import threading

    root = written[0]
    _, t = _datasets(root, info_paths=[str(root / "cat_eval.info")], is_train=False)
    builds, build = [], t._build_class_assets
    t._build_class_assets = lambda cls: builds.append(cls) or build(cls)
    got = []
    threads = [threading.Thread(target=lambda: got.append(t.class_assets("cat")))
               for _ in range(8)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(th.is_alive() for th in threads)
    assert builds == ["cat"] and len(got) == 8 and all(a is got[0] for a in got)


def test_build_dataset_from_the_written_config(written, numpy_pyramids):
    from rnnpose_tpu.config import defaults as jdef
    from rnnpose_tpu.utils.config_io import merge_cfg as jmerge
    from rnnpose_tpu_torch.config import defaults as tdef
    from rnnpose_tpu_torch.utils.config_io import merge_cfg as tmerge

    root = written[0]
    path = str(root / "train_config.yml")
    cj, ct = jmerge([path], defaults=jdef.default_config()), tmerge(
        [path], defaults=tdef.default_config())
    for section in ("train_input_reader", "eval_input_reader"):
        for c in (cj, ct):
            c[section]["dataset"]["kwargs"]["preprocess"].update(PREP, max_verts=256,
                                                                max_faces=512)
    kp_j, kp_t = JKP(num_layers=2, first_subsampling_dl=0.02), TKP(
        num_layers=2, first_subsampling_dl=0.02)
    for is_train in (False, True):
        dj = jdef.build_dataset(cj, kp_j, is_train=is_train)
        dt = tdef.build_dataset(ct, kp_t, is_train=is_train)
        assert len(dt) == len(dj) == (4 if is_train else 3)
        assert dt.prep_cfg.crop_size == 64 and dt.max_faces == 512
        _check_sample(dt[0], dj[0])


def test_writer_matches_jax(written):
    jroot, troot = written
    for name in ("cat_train.info", "cat_eval.info", "cat_test_occ.info", "cat_init_poses.pkl"):
        with open(jroot / name, "rb") as f:
            a = pickle.load(f)
        with open(troot / name, "rb") as f:
            b = pickle.load(f)
        assert a.keys() == b.keys()
        items_a = a["cat"].items() if isinstance(a["cat"], dict) else enumerate(a["cat"])
        for k, rec in items_a:
            other = b["cat"][k]
            assert rec.keys() == other.keys()
            for field in rec:
                np.testing.assert_array_equal(np.asarray(rec[field]), np.asarray(other[field]))
    for name in ("pvnet_catocc_test.npy", "blender2bop_RT.npy"):
        a = np.load(jroot / name, allow_pickle=True).flat[0]["cat"]
        b = np.load(troot / name, allow_pickle=True).flat[0]["cat"]
        if isinstance(a, dict):
            assert a.keys() == b.keys()
            a, b = np.stack(list(a.values())), np.stack(list(b.values()))
        np.testing.assert_array_equal(a, b)
    import yaml

    for name in ("train_config.yml", "eval_config_occ.yml"):
        with open(jroot / name) as f:
            cfg_j = yaml.safe_load(f)
        with open(troot / name) as f:
            cfg_t = json.load(f)
        assert json.dumps(cfg_t, sort_keys=True) == json.dumps(cfg_j, sort_keys=True).replace(
            str(jroot), str(troot))
    with open(jroot / "models/cat/textured.obj") as f, open(troot / "models/cat/textured.obj") as g:
        assert f.read() == g.read()
    for i in range(7):
        for kind in ("color", "depth"):
            a = imageio.read_png(str(jroot / f"frames/{i:06d}-{kind}.png")).astype(np.int64)
            b = imageio.read_png(str(troot / f"frames/{i:06d}-{kind}.png")).astype(np.int64)
            assert a.shape == b.shape
            d = np.abs(a - b)
            d = d.max(-1) if d.ndim == 3 else d
            assert (d > 0).mean() < 0.02, (i, kind, int((d > 0).sum()))
            assert (d > 1).sum() <= 3, (i, kind, int((d > 1).sum()))


def _write_obj(path):
    with open(path, "w") as f:
        f.write("# a quad, a triangle and vertex colours\n")
        for v in ((0, 0, 0), (1, 0, 0), (1, 1, 0), (0, 1, 0), (0.5, 0.5, 1)):
            f.write("v {} {} {} 0.1 0.2 0.3\n".format(*v))
        f.write("vn 0 0 1\nf 1/1/1 2/2/1 3/3/1 4/4/1\nf 1 2 5\n")


def _write_ply(path, binary):
    verts = np.asarray([(0, 0, 0), (1, 0, 0), (1, 1, 0), (0.5, 0.5, 1)], np.float32)
    cols = np.asarray([(255, 0, 0), (0, 255, 0), (0, 0, 255), (9, 9, 9)], np.uint8)
    faces = [(0, 1, 2), (0, 1, 3), (1, 2, 3)]
    head = ("ply\nformat {} 1.0\ncomment x\nelement vertex 4\nproperty float x\n"
            "property float y\nproperty float z\nproperty uchar red\nproperty uchar green\n"
            "property uchar blue\nelement face 3\nproperty list uchar int vertex_indices\n"
            "end_header\n").format("binary_little_endian" if binary else "ascii")
    with open(path, "wb") as f:
        f.write(head.encode())
        for v, c in zip(verts, cols):
            if binary:
                f.write(v.tobytes() + c.tobytes())
            else:
                f.write(("{} {} {} ".format(*v) + "{} {} {}\n".format(*c)).encode())
        for tri in faces:
            if binary:
                f.write(np.uint8(3).tobytes() + np.asarray(tri, "<i4").tobytes())
            else:
                f.write("3 {} {} {}\n".format(*tri).encode())


def test_mesh_loaders_match_jax(tmp_path):
    from rnnpose_tpu.render import mesh as jmesh
    from rnnpose_tpu_torch.render import mesh as tmesh

    _write_obj(tmp_path / "m.obj")
    _write_ply(tmp_path / "a.ply", binary=False)
    _write_ply(tmp_path / "b.ply", binary=True)
    for name in ("m.obj", "a.ply", "b.ply"):
        mj, mt = jmesh.load_mesh(str(tmp_path / name)), tmesh.load_mesh(str(tmp_path / name))
        for f in ("verts", "faces", "vert_colors"):
            np.testing.assert_array_equal(getattr(mt, f), getattr(mj, f))
        (nj, cj, sj), (nt, ct, st) = jmesh.normalize_mesh(mj), tmesh.normalize_mesh(mt)
        np.testing.assert_array_equal(nt.verts, nj.verts)
        np.testing.assert_array_equal(ct, cj)
        assert st == sj
    assert len(tmesh.load_mesh(str(tmp_path / "m.obj")).faces) == 3  # the quad fanned
    with pytest.raises(ValueError, match="unsupported"):
        tmesh.load_mesh(str(tmp_path / "m.stl"))
    from rnnpose_tpu.data.synthetic import make_icosphere

    ico = make_icosphere(2, 0.1)
    dj, dt = jmesh.decimate_mesh(ico, 100, seed=4), tmesh.decimate_mesh(ico, 100, seed=4)
    np.testing.assert_array_equal(dt.faces, dj.faces)


def test_preprocess_helpers_match_jax():
    from rnnpose_tpu.data import poses as jposes
    from rnnpose_tpu_torch.data import poses as tposes

    rs = np.random.RandomState(0)
    pts = (rs.randn(300, 3) * 0.04).astype(np.float32)
    RT = np.concatenate([np.linalg.qr(rs.randn(3, 3))[0], [[0.01], [0.02], [0.5]]], 1).astype(
        np.float32)
    for a, b in zip(tprep.normalize_model(pts, RT), jprep.normalize_model(pts, RT)):
        np.testing.assert_array_equal(a, b)
    noisy = (RT[:, :3] + rs.randn(3, 3) * 0.01).astype(np.float32)
    np.testing.assert_array_equal(tposes.reorthonormalize(noisy), jposes.reorthonormalize(noisy))
    np.testing.assert_array_equal(tposes.pose_padding(RT), jposes.pose_padding(RT))

    depth = (rs.rand(64, 64) * (rs.rand(64, 64) > 0.6) + 0.3).astype(np.float32)
    depth[rs.rand(64, 64) > 0.5] = 0
    K = np.asarray([[80.0, 0, 32], [0, 80.0, 32], [0, 0, 1]], np.float32)
    for a, b in zip(tprep.mask_depth_to_points(depth, K), jprep.mask_depth_to_points(depth, K)):
        np.testing.assert_array_equal(a, b)
    pts_cam, px = tprep.mask_depth_to_points(depth, K)
    _, RT_n, _, scale = tprep.normalize_model(pts, RT)
    lifted = tprep.lift_to_model_frame(pts_cam, RT_n, scale)
    np.testing.assert_array_equal(lifted, jprep.lift_to_model_frame(pts_cam, RT_n, scale))
    model = tprep.normalize_model(pts, RT)[0]
    lifted = (model[rs.randint(0, 300, 500)] + rs.randn(500, 3) * 0.02).astype(np.float32)
    pairs = tprep.get_correspondences(lifted, model, 0.05)
    np.testing.assert_array_equal(pairs, jprep.get_correspondences(lifted, model, 0.05))
    assert len(pairs) > 100
    px = rs.randint(0, 64, (500, 2))
    cfg_t, cfg_j = tprep.PreprocessConfig(num_corr=64), jprep.PreprocessConfig(num_corr=64)
    a = tprep.build_correspondence_set(lifted, px, model, pairs, depth > 0, cfg_t,
                                       np.random.RandomState(7))
    b = jprep.build_correspondence_set(lifted, px, model, pairs, depth > 0, cfg_j,
                                       np.random.RandomState(7))
    for f in a._fields:
        np.testing.assert_array_equal(getattr(a, f), np.asarray(getattr(b, f)), err_msg=f)
    with pytest.raises(tprep.TooFewCorrespondences):
        tprep.build_correspondence_set(lifted, px, model, pairs[:3], depth > 0, cfg_t,
                                       np.random.RandomState(7))


def test_generate_data_info_matches_jax(tmp_path):
    from rnnpose_tpu.tools.generate_data_info import main as jmain
    from rnnpose_tpu_torch.tools.generate_data_info import main as tmain

    d = tmp_path / "data" / "train" / "cat"
    d.mkdir(parents=True)
    for i in range(3):
        imageio.write_png(str(d / f"{i:06d}-color.png"), np.zeros((8, 8, 3), np.uint8))
        imageio.write_png(str(d / f"{i:06d}-depth.png"), np.zeros((8, 8), np.uint16))
        np.savetxt(str(d / f"{i:06d}-pose.txt"), np.eye(3, 4) * (i + 1))
    for main, out in ((jmain, "j.info"), (tmain, "t.info")):
        main(["--data_root", str(tmp_path), "--classes", "cat", "--split", "train",
              "--out", str(tmp_path / out)])
    with open(tmp_path / "j.info", "rb") as f, open(tmp_path / "t.info", "rb") as g:
        a, b = pickle.load(f)["cat"], pickle.load(g)["cat"]
    assert len(a) == len(b) == 3
    for x, y in zip(a, b):
        assert x.keys() == y.keys()
        for k in x:
            np.testing.assert_array_equal(np.asarray(x[k]), np.asarray(y[k]))


def test_prefetch_loaders_match_jax():
    from rnnpose_tpu.data import loader as jloader
    from rnnpose_tpu_torch.data import loader as tloader

    def fetch(i):
        if i % 5 == 3:
            raise ValueError(i)
        return i * i

    for mod in (jloader, tloader):
        assert list(mod.prefetch_map(range(20), fetch, skip_exc=(ValueError,))) == [
            i * i for i in range(20) if i % 5 != 3]
    out = []
    for mod in (jloader, tloader):
        with mod.PrefetchLoader(range(23), fetch, 4, collate=tuple, num_threads=3,
                                skip_exc=ValueError) as loader:
            out.append(list(loader))
    assert out[0] == out[1] and len(out[1]) == 4
