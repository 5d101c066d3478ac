"""Shared fixture of the `test_torch_port_train_linemod*` files: a tiny
LINEMOD-format training set written by the port's `make_synthetic_linemod`
(64^2 frames, the scaled camera, the elongated capsule: on the symmetric
icosphere the KPConv towers' exact output is 0 and their f32 output and
first-layer gradients are rounding noise in both packages, ROADMAP Queue
3), every other train frame marked `is_syn`,
VOC trees built from the committed JPEG fixtures, and the shrunken JSON
config (2-layer 16-wide towers, 32^2 zoom, 1 render x 1 GRU iteration,
64^2 crops and 64 correspondence rows) that both packages read."""
from __future__ import annotations

import json
import pickle
from pathlib import Path

from rnnpose_tpu_torch.cpp import jpeg

FIXTURES = Path(jpeg.SOURCE).parent.parent / "testdata" / "jpeg"
WRITER_ARGS = ["--frames", "6", "--eval_frames", "2", "--height", "64", "--width", "64",
               "--fx", "77.0", "--fy", "77.0", "--cx", "32.0", "--cy", "32.0",
               "--object_scale", "0.05", "--distance", "0.4", "--batch", "8",
               "--shape", "capsule"]
PREP = dict(crop_size=64, num_corr=64, correspondence_radius=0.05, min_correspondences=5)
KP = {"num_layers": 2, "first_subsampling_dl": 0.02, "first_feats_dim": 16,
      "final_feats_dim": 32, "gnn_feats_dim": 16}
VOC_LIST = "VOCdevkit/VOC2012/ImageSets/Main/diningtable_trainval.txt"
VOC_JPEGS = "VOCdevkit/VOC2012/JPEGImages"


def voc_tree(root: Path, entries) -> str:
    """A VOC root whose list names `entries` ({name: bytes or None}; None
    leaves the JPEG out)."""
    (root / VOC_JPEGS).mkdir(parents=True, exist_ok=True)
    (root / VOC_LIST).parent.mkdir(parents=True, exist_ok=True)
    for name, body in entries.items():
        if body is not None:
            (root / VOC_JPEGS / f"{name}.jpg").write_bytes(body)
    with open(root / VOC_LIST, "w") as f:
        f.write("".join(f"{name} -1\n" for name in entries))
    return str(root)


def good_voc_entries():
    return {p.stem: p.read_bytes() for p in sorted(FIXTURES.glob("*.jpg"))}


def bad_voc_entries():
    """Backgrounds that `cv2.imread` returns None for: junk bytes, a cut
    JPEG and a missing file."""
    cut = (FIXTURES / "baseline_444.jpg").read_bytes()
    return {"junk": b"not a jpeg", "cut": cut[:len(cut) // 2], "missing": None}


def write_train_fixture(root: Path) -> str:
    """The dataset under `root/lm` with its shrunken config; returns the
    config path. The train reader pastes VOC backgrounds from `root/voc`."""
    from rnnpose_tpu_torch.tools.make_synthetic_linemod import main as write

    lm = root / "lm"
    cfg_path = write(["--out", str(lm), "--device", "cpu"] + WRITER_ARGS)
    info = lm / "cat_train.info"
    with open(info, "rb") as f:
        frames = pickle.load(f)
    for i, fr in enumerate(frames["cat"]):
        fr["is_syn"] = i % 2 == 0
    with open(info, "wb") as f:
        pickle.dump(frames, f)
    voc = voc_tree(root / "voc", good_voc_entries())
    with open(cfg_path) as f:
        cfg = json.load(f)
    cfg["basic"] = {"zoom_crop_size": [32, 32]}
    cfg["model"] = {
        "descriptor_net": {"keypoints_detector_3d": KP,
                           "context_fea_extractor_3d": dict(KP, final_feats_dim=256)},
        "motion_net": {"iter_count": 1, "render_iter_count": 1, "raster": {"chunk": 64}},
    }
    budget = {"max_verts": 256, "max_faces": 512}
    train_kw = cfg["train_input_reader"]["dataset"]["kwargs"]
    train_kw["preprocess"] = dict(PREP, **budget)
    train_kw["voc_root"] = voc
    cfg["eval_input_reader"]["dataset"]["kwargs"]["preprocess"] = dict(crop_size=64, **budget)
    cfg["train_config"] = {"steps": 3, "steps_per_eval": 2}
    with open(cfg_path, "w") as f:
        json.dump(cfg, f)
    return cfg_path

