"""DeepIM-layout `.info` generators (port of `rnnpose_tpu/tools/deepim_info.py`;
numpy only).

The reference's four split generators: real training pairs (`orig`),
synthetic renders (`syn`, frames marked `is_syn`: the training dataset
pastes a VOC background behind them), the PoseCNN-val eval split
(`posecnnval`) and the ratio-split PVNet-rendering walk (`v2`). Each writes
the `{class: [frame dict]}` pickle that `data/linemod.py` reads; every frame
carries its source frame id as `index`, which eval uses to align the
PoseCNN/PVNet initial poses.

DeepIM LM6d directory layout:
  data/observed/{class_idx:02d}/{frame:06d}-{color.png,depth.png,label.png}
  data/gt_observed/{class}/{frame:06d}-{pose.txt,depth.png}
  data/rendered/{class}/{frame:06d}_{i}-{color.png,depth.png,pose.txt}
  image_set/observed/{class}_train.txt | {class}_test.txt

Usage:
  python -m rnnpose_tpu_torch.tools.deepim_info orig --data_root R --out x
  python -m rnnpose_tpu_torch.tools.deepim_info syn --data_root R --out x
  python -m rnnpose_tpu_torch.tools.deepim_info posecnnval --data_root R --out x
  python -m rnnpose_tpu_torch.tools.deepim_info v2 --data_root R --out x \
      --blender_to_bop conv.npy --ratio 0.8
(`.train` / `.eval` is appended to `--out`.)
"""
from __future__ import annotations

import argparse
import glob
import os
import pickle
import re
from typing import Dict, List, Optional

import numpy as np

from ..data.linemod_config import CLASS_TO_IDX, LINEMOD_CLASSES, LINEMOD_K

__all__ = [
    "create_orig_info",
    "create_syn_info",
    "create_posecnnval_info",
    "create_v2_info",
    "save_info",
]


def _read_split(path: str) -> List[int]:
    with open(path) as f:
        return [int(line.strip().split("/")[-1]) for line in f if line.strip()]


def _read_pose(path: str) -> np.ndarray:
    # DeepIM pose.txt: one header line, then the 3x4 row-major matrix.
    return np.loadtxt(path, skiprows=1).reshape(3, 4).astype(np.float32)


def _frame(
    index: int,
    rgb: str,
    depth_observed: str,
    depth_gt_observed: str,
    gt_pose: np.ndarray,
    cls: str,
    rendered: Optional[Dict[str, object]] = None,
    is_syn: bool = False,
) -> Dict[str, object]:
    info: Dict[str, object] = {
        "index": index,
        "rgb_observed_path": rgb,
        "depth_observed_path": depth_observed,
        "depth_gt_observed_path": depth_gt_observed,
        "gt_pose": gt_pose,
        "rgb_noisy_rendered": None,
        "depth_noisy_rendered": None,
        "pose_noisy_rendered": None,
        "model_points_path": f"{cls}.bin",
        "K": LINEMOD_K.copy(),
        "is_syn": is_syn,
    }
    if rendered:
        info.update(rendered)
    return info


def _pairs_for_class(
    data_root: str,
    cls: str,
    split_ids: List[int],
    observed_sub: str,
    rendered_sub: str,
    rendered_stem,
    num_rendered: int,
    check_files: bool,
    is_syn: bool = False,
) -> List[Dict[str, object]]:
    """Emit one frame dict per (observed frame, noisy render) pair."""
    gt_dir = os.path.join("data", "gt_observed", cls)
    frames = []
    for idx in split_ids:
        gt_pose = _read_pose(
            os.path.join(data_root, gt_dir, f"{idx:06d}-pose.txt")
        )
        rgb = os.path.join(observed_sub, f"{idx:06d}-color.png")
        depth_obs = os.path.join(observed_sub, f"{idx:06d}-depth.png")
        depth_gt = os.path.join(gt_dir, f"{idx:06d}-depth.png")
        for i in range(num_rendered):
            stem = rendered_stem(cls, idx, i)
            ren = {
                "rgb_noisy_rendered": os.path.join(
                    rendered_sub, f"{stem}-color.png"
                ),
                "depth_noisy_rendered": os.path.join(
                    rendered_sub, f"{stem}-depth.png"
                ),
                "pose_noisy_rendered": _read_pose(
                    os.path.join(data_root, rendered_sub, f"{stem}-pose.txt")
                ),
            }
            if check_files:
                for rel in (rgb, depth_obs, ren["rgb_noisy_rendered"],
                            ren["depth_noisy_rendered"]):
                    full = os.path.join(data_root, rel)
                    if not os.path.exists(full):
                        raise FileNotFoundError(full)
            frames.append(
                _frame(idx, rgb, depth_obs, depth_gt, gt_pose, cls,
                       rendered=ren, is_syn=is_syn)
            )
    return frames


def create_orig_info(
    data_root: str,
    classes: Optional[List[str]] = None,
    num_rendered: int = 10,
    check_files: bool = True,
) -> Dict[str, List[Dict[str, object]]]:
    """Real observed frames x 10 noisy renders, train split
    (`generate_data_info_deepim_0_orig.py:120-173`)."""
    res = {}
    for cls in classes or LINEMOD_CLASSES:
        split = _read_split(os.path.join(
            data_root, "image_set", "observed", f"{cls}_train.txt"))
        res[cls] = _pairs_for_class(
            data_root, cls, split,
            observed_sub=os.path.join(
                "data", "observed", f"{CLASS_TO_IDX[cls]:02d}"),
            rendered_sub=os.path.join("data", "rendered", cls),
            rendered_stem=lambda c, idx, i: f"{idx:06d}_{i}",
            num_rendered=num_rendered, check_files=check_files,
        )
    return res


def create_syn_info(
    data_root: str,
    classes: Optional[List[str]] = None,
    check_files: bool = True,
) -> Dict[str, List[Dict[str, object]]]:
    """LM6d_data_syn frames (class-named observed dirs, one render each,
    `generate_data_info_deepim_1_syn.py:100-196`)."""
    res = {}
    for cls in classes or LINEMOD_CLASSES:
        split = _read_split(os.path.join(
            data_root, "image_set", "observed",
            f"LM6d_data_syn_train_observed_{cls}.txt"))
        res[cls] = _pairs_for_class(
            data_root, cls, split,
            observed_sub=os.path.join("data", "observed", cls),
            rendered_sub=os.path.join("data", "rendered", cls),
            rendered_stem=lambda c, idx, i: f"{c}_{idx:06d}_{i}",
            num_rendered=1, check_files=check_files, is_syn=True,
        )
    return res


def create_posecnnval_info(
    data_root: str,
    classes: Optional[List[str]] = None,
    check_files: bool = True,
) -> Dict[str, List[Dict[str, object]]]:
    """Test-split frames with PoseCNN-rendered inits
    (`generate_data_info_deepim_2_posecnnval.py:100-182`; renders live under
    rendered/{class_idx:02d}/{class}/)."""
    res = {}
    for cls in classes or LINEMOD_CLASSES:
        split = _read_split(os.path.join(
            data_root, "image_set", "observed", f"{cls}_test.txt"))
        res[cls] = _pairs_for_class(
            data_root, cls, split,
            observed_sub=os.path.join(
                "data", "observed", f"{CLASS_TO_IDX[cls]:02d}"),
            rendered_sub=os.path.join(
                "data", "rendered", f"{CLASS_TO_IDX[cls]:02d}", cls),
            rendered_stem=lambda c, idx, i: f"{c}_{idx:06d}_{i}",
            num_rendered=1, check_files=check_files,
        )
    return res


def create_v2_info(
    data_root: str,
    classes: Optional[List[str]] = None,
    blender_to_bop_path: Optional[str] = None,
    ratio: float = 0.8,
    shuffle: bool = True,
    seed: int = 0,
    max_items: int = 10000,
):
    """PVNet-rendering walk: per-class dirs of {n}.jpg / {n}_depth.npy /
    {n}_params.pkl (the `transform_pvnet_data` output), blender->bop pose
    conversion, ratio train/eval split
    (`generate_data_info_v2_deepim.py:40-160`).

    Returns (train_info, eval_info).
    """
    conv = None
    if blender_to_bop_path:
        conv = np.load(blender_to_bop_path, allow_pickle=True).flat[0]
    rs = np.random.RandomState(seed)
    train_res, eval_res = {}, {}
    for cls in classes or LINEMOD_CLASSES:
        cdir = os.path.join(data_root, cls)
        images = sorted(
            glob.glob(os.path.join(cdir, "*.jpg")),
            key=lambda s: int(re.split(r"\.|_", os.path.basename(s))[0]),
        )[:max_items]

        def load(idx):
            stem = os.path.splitext(images[idx])[0]
            with open(stem + "_params.pkl", "rb") as f:
                params = pickle.load(f)
            RT = np.asarray(params["RT"], np.float32).copy()
            if conv is not None:
                # blender frame -> bop frame (conversion table keys use
                # 'camera' for the 'cam' class).
                c = conv["camera" if cls == "cam" else cls]
                RT[:3, :3] = RT[:3, :3] @ c[:3, :3].T
                RT[:3, 3:] = -RT[:3, :3] @ c[:3, 3:] + RT[:3, 3:]
            rel = os.path.relpath(stem, data_root)
            fr = _frame(
                index=idx,
                rgb=rel + ".jpg",
                depth_observed=rel + "_depth.npy",
                depth_gt_observed=rel + "_depth.npy",
                gt_pose=RT, cls=cls, is_syn=True,
            )
            fr["K"] = np.asarray(params["K"], np.float32)
            fr["bbox"] = params.get("bbox")
            return fr

        order = rs.permutation(len(images)) if shuffle else np.arange(len(images))
        cut = int(len(images) * ratio)
        train_res[cls] = [load(i) for i in order[:cut]]
        eval_res[cls] = [load(i) for i in order[cut:]]
    return train_res, eval_res


def save_info(info, path: str):
    with open(path, "wb") as f:
        pickle.dump(info, f)
    n = sum(len(v) for v in info.values())
    print(f"wrote {path}: {n} frames / {len(info)} classes")


def main(argv=None):
    p = argparse.ArgumentParser(description="DeepIM .info generators")
    p.add_argument("mode", choices=["orig", "syn", "posecnnval", "v2"])
    p.add_argument("--data_root", required=True)
    p.add_argument("--out", required=True,
                   help="output path; '.train'/'.eval' suffixes are appended "
                        "like the reference generators")
    p.add_argument("--classes", nargs="*", default=None)
    p.add_argument("--num_rendered", type=int, default=10)
    p.add_argument("--no_check", action="store_true")
    p.add_argument("--blender_to_bop", type=str, default=None)
    p.add_argument("--ratio", type=float, default=0.8)
    p.add_argument("--no_shuffle", action="store_true")
    args = p.parse_args(argv)

    if args.mode == "orig":
        save_info(create_orig_info(
            args.data_root, args.classes, args.num_rendered,
            check_files=not args.no_check), args.out + ".train")
    elif args.mode == "syn":
        save_info(create_syn_info(
            args.data_root, args.classes, check_files=not args.no_check),
            args.out + ".train")
    elif args.mode == "posecnnval":
        save_info(create_posecnnval_info(
            args.data_root, args.classes, check_files=not args.no_check),
            args.out + ".eval")
    else:
        train, ev = create_v2_info(
            args.data_root, args.classes, args.blender_to_bop,
            ratio=args.ratio, shuffle=not args.no_shuffle)
        save_info(train, args.out + ".train")
        save_info(ev, args.out + ".eval")


if __name__ == "__main__":
    main()
