"""Build `.info` pickles for the dataset layer (port of
`rnnpose_tpu/tools/generate_data_info.py`).

Walks a DeepIM- or BOP-style tree and writes the {class: [frame dicts]}
pickle that `data/linemod.LinemodSynRealDataset` reads. Frame fields:
index, rgb_observed_path, depth_gt_observed_path, gt_pose (3, 4), K (3, 3).

Usage:
  python -m rnnpose_tpu_torch.tools.generate_data_info \\
      --data_root /data/LM6d --classes cat ape --split train --out cat_train.info
"""
from __future__ import annotations

import argparse
import json
import os
import pickle

import numpy as np


def scan_class(data_root: str, cls: str, split: str):
    """Frames of `<root>/data/<split>/<cls>/` laid out as `<idx>-color.png`,
    `<idx>-depth.png`, `<idx>-pose.txt` (DeepIM), else of
    `<root>/<cls>/{rgb,depth}/` with `scene_gt.json` (BOP)."""
    frames = []
    deepim_dir = os.path.join(data_root, "data", split, cls)
    if os.path.isdir(deepim_dir):
        from ..data.linemod_config import LINEMOD_K

        names = sorted(f[: -len("-color.png")] for f in os.listdir(deepim_dir)
                       if f.endswith("-color.png"))
        for i, n in enumerate(names):
            pose_path = os.path.join(deepim_dir, f"{n}-pose.txt")
            if not os.path.exists(pose_path):
                continue
            RT = np.loadtxt(pose_path).reshape(3, 4).astype(np.float32)
            frames.append({
                "index": i,
                "rgb_observed_path": os.path.relpath(
                    os.path.join(deepim_dir, f"{n}-color.png"), data_root),
                "depth_gt_observed_path": os.path.relpath(
                    os.path.join(deepim_dir, f"{n}-depth.png"), data_root),
                "gt_pose": RT,
                "K": LINEMOD_K.copy(),
            })
        return frames

    bop_dir = os.path.join(data_root, cls)
    if os.path.isdir(os.path.join(bop_dir, "rgb")):
        with open(os.path.join(bop_dir, "scene_gt.json")) as f:
            gt = json.load(f)
        with open(os.path.join(bop_dir, "scene_camera.json")) as f:
            cams = json.load(f)
        for key in sorted(gt, key=int):
            rec = gt[key][0]
            RT = np.concatenate([
                np.asarray(rec["cam_R_m2c"], np.float32).reshape(3, 3),
                np.asarray(rec["cam_t_m2c"], np.float32).reshape(3, 1) / 1000.0,
            ], axis=1)
            K = np.asarray(cams[key]["cam_K"], np.float32).reshape(3, 3)
            frames.append({
                "index": int(key),
                "rgb_observed_path": os.path.relpath(
                    os.path.join(bop_dir, "rgb", f"{int(key):06d}.png"), data_root),
                "depth_gt_observed_path": os.path.relpath(
                    os.path.join(bop_dir, "depth", f"{int(key):06d}.png"), data_root),
                "gt_pose": RT,
                "K": K,
            })
    return frames


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--data_root", required=True)
    p.add_argument("--classes", nargs="+", required=True)
    p.add_argument("--split", default="train")
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)

    info = {}
    for cls in args.classes:
        frames = scan_class(args.data_root, cls, args.split)
        if frames:
            info[cls] = frames
            print(f"{cls}: {len(frames)} frames")
        else:
            print(f"{cls}: WARNING no frames found")
    with open(args.out, "wb") as f:
        pickle.dump(info, f)
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
