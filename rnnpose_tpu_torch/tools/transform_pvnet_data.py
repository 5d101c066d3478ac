"""Convert PVNet-rendering outputs into the per-frame layout that
`tools/generate_data_info`'s v2 walk reads (port of
`rnnpose_tpu/tools/transform_pvnet_data.py`, offline data tooling).

PVNet's synthetic renderer writes range images (distance along the pixel
ray, stored as range * 0.5, 1.0 marking background) and fused
multi-object composites; this tool turns them into z-depth, optionally
crops around the object (intrinsics updated), and writes per frame
  {index:05d}.jpg  {index:05d}_depth.npy  {index:05d}_params.pkl
(and `{index:05d}_mask_visb.png` for the fuse modes). The files equal the
JAX tool's byte for byte: the images are read with `data/imageio`, resized
with `data/preprocess.resize_linear` (uint8, OpenCV's fixed point) and
`resize_nearest`, and written with the port's JPEG and PNG writers, which
write `cv2.imwrite`'s bytes. No OpenCV is needed.

Modes (the reference's `transform_data_format.py` variants):
  syn          blender-K range renders
  syn_lmk      LINEMOD-K renders with a per-frame `_RT.pkl`
  fuse         multi-object fuse composites
  fuse_single  single-object fuse layout

Usage:
  python -m rnnpose_tpu_torch.tools.transform_pvnet_data syn|syn_lmk|fuse|fuse_single \\
      --data_info info.pkl --data_root DIR [--depth_root DIR] --save_root DIR
      [--crop_size 128 --crop_margin 0.1]
"""
from __future__ import annotations

import argparse
import os
import pickle
from typing import Dict, Optional, Tuple

import numpy as np

from ..data.imageio import read_rgb, write_jpeg, write_png
from ..data.linemod_config import BLENDER_K, LINEMOD_K
from ..data.preprocess import resize_linear, resize_nearest

__all__ = ["range_to_depth", "bbox_crop", "process_syn", "process_fuse",
           "LINEMOD_FUSE_CLASSES"]

# Class order of the PVNet fusing step; the fuse mask stores (index + 1).
LINEMOD_FUSE_CLASSES = (
    "ape", "cam", "cat", "duck", "glue", "iron", "phone",
    "benchvise", "can", "driller", "eggbox", "holepuncher", "lamp",
)


def range_to_depth(mask: np.ndarray, rng: np.ndarray, K: np.ndarray) -> np.ndarray:
    """Range image -> z-depth: z = f * range / sqrt(f^2 + (cx - x)^2 +
    (cy - y)^2) at the pixel centres (+0.5) of the mask."""
    f, cx, cy = K[0, 0], K[0, 2], K[1, 2]
    ys, xs = np.nonzero(mask)
    x = xs.astype(np.float32) + 0.5
    y = ys.astype(np.float32) + 0.5
    ray_len = np.sqrt(f * f + (cx - x) ** 2 + (cy - y) ** 2)
    depth = np.zeros_like(rng)
    depth[ys, xs] = f * rng[ys, xs] / ray_len
    return depth


def bbox_crop(
    image: np.ndarray,
    depth: np.ndarray,
    mask: np.ndarray,
    K: np.ndarray,
    margin_ratio: float = 0.1,
    output_size: int = 128,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Square crop around the mask's bbox, resized (bilinear image, nearest
    depth) with the intrinsics updated; outside the frame the image pads
    with 0 and the depth with 1.0 (invalid)."""
    ys, xs = np.nonzero(mask)
    x0, y0 = xs.min(), ys.min()
    w, h = xs.max() - x0 + 1, ys.max() - y0 + 1
    cx, cy = x0 + w / 2.0, y0 + h / 2.0
    L = int(max(w, h) * (1.0 + 2.0 * margin_ratio))
    x = max(0, int(cx - L / 2))
    y = max(0, int(cy - L / 2))

    patch = np.zeros((L, L) + image.shape[2:], image.dtype)
    dpatch = np.ones((L, L), depth.dtype)
    src_img = image[y:y + L, x:x + L]
    src_dep = depth[y:y + L, x:x + L]
    patch[: src_img.shape[0], : src_img.shape[1]] = src_img
    dpatch[: src_dep.shape[0], : src_dep.shape[1]] = src_dep

    patch = resize_linear(patch, (output_size, output_size))
    dpatch = resize_nearest(dpatch, (output_size, output_size))

    s = output_size / L
    K_new = np.array(
        [[K[0, 0] * s, 0.0, (K[0, 2] - x) * s],
         [0.0, K[1, 1] * s, (K[1, 2] - y) * s],
         [0.0, 0.0, 1.0]], K.dtype if K.dtype.kind == "f" else np.float32,
    )
    return patch, dpatch, K_new


def _write_frame(save_dir, index, image, depth, RT, K, bbox, mask=None):
    os.makedirs(save_dir, exist_ok=True)
    write_jpeg(os.path.join(save_dir, f"{index:05d}.jpg"), image)
    np.save(os.path.join(save_dir, f"{index:05d}_depth.npy"), depth)
    if mask is not None:
        write_png(os.path.join(save_dir, f"{index:05d}_mask_visb.png"),
                  mask.astype(np.uint8) * 255)
    with open(os.path.join(save_dir, f"{index:05d}_params.pkl"), "wb") as f:
        pickle.dump({"RT": RT, "K": K, "bbox": bbox}, f)


def process_syn(
    data_info: Dict,
    data_root: str,
    save_root: str,
    crop_param: Optional[Dict] = None,
    use_lmk: bool = False,
) -> int:
    """Per-class PVNet synthetic renders -> frame files; returns the number
    of frames written. `data_info`: {class: [{index, image_path, depth_path,
    RT, ...}]}. `use_lmk` reads each frame's `<image>_RT.pkl` for K and RT."""
    n = 0
    for seq, frames in data_info.items():
        for info in frames:
            image = read_rgb(os.path.join(data_root, info["image_path"]))
            depth_rng = np.load(os.path.join(data_root, info["depth_path"]))
            if use_lmk:
                rt_path = os.path.join(data_root, info["image_path"].replace(".jpg", "_RT.pkl"))
                with open(rt_path, "rb") as f:
                    params = pickle.load(f)
                K_old, RT = np.asarray(params["K"]), np.asarray(params["RT"])
            else:
                K_old, RT = BLENDER_K.copy(), np.asarray(info["RT"])

            mask = depth_rng < 1.0
            ys, xs = np.nonzero(mask)
            bbox = [ys.min(), xs.min(), ys.max(), xs.max()]
            depth = range_to_depth(mask, depth_rng * 2.0, K_old)
            if crop_param is not None:
                image, depth, K_new = bbox_crop(image, depth, mask, K_old, **crop_param)
            else:
                K_new = K_old
            _write_frame(os.path.join(save_root, seq), info["index"], image, depth, RT, K_new,
                         bbox)
            n += 1
    return n


def process_fuse(
    data_info: Dict,
    data_root: str,
    depth_root: str,
    save_root: str,
    crop_param: Optional[Dict] = None,
    single: bool = False,
) -> int:
    """PVNet fuse composites -> frame files; returns the number written.

    Per frame stem: `<stem>_rgb.jpg` (the composite), `<stem>_mask.png`
    (fused class ids, class index + 1), `<stem>_info.pkl` ([per-class
    (dy, dx) offsets], [per-class RT], [per-class {img_idx}]), and the
    source render's range map `<depth_root>/<class dir>/{img_idx}_depth.png.npy`.
    `single` is the single-object layout (class slot 0, the stem keeps the
    class name). A frame whose render falls outside the composite is
    skipped."""
    n = 0
    for seq, frames in data_info.items():
        seq_idx = 0 if single else LINEMOD_FUSE_CLASSES.index(seq)
        for info in frames:
            stem = os.path.join(data_root, info["image_path"])[: -len(".jpg")]
            if not single:
                stem = stem.replace(seq, "")
            with open(stem + "_info.pkl", "rb") as f:
                fuse_info = pickle.load(f)
            offsets, RTs, meta = fuse_info[0], fuse_info[1], fuse_info[2]
            image = read_rgb(stem + "_rgb.jpg")
            # The mask's first channel in OpenCV's BGR order: blue.
            fuse_mask = read_rgb(stem + "_mask.png")[..., 2] == (seq_idx + 1)

            img_idx = meta[seq_idx]["img_idx"]
            ren_rng = np.load(os.path.join(
                os.path.dirname(os.path.join(depth_root, info["image_path"])),
                f"{img_idx}_depth.png.npy"))

            ys, xs = np.nonzero(ren_rng < 1.0)
            hmin, hmax, wmin, wmax = ys.min(), ys.max(), xs.min(), xs.max()
            dy, dx = offsets[seq_idx][0], offsets[seq_idx][1]
            bbox = [hmin + dy, wmin + dx, hmax + dy, wmax + dx]

            depth_rng = np.ones_like(ren_rng)
            H, W = depth_rng.shape[:2]
            if hmax + dy + 1 > H or wmax + dx + 1 > W or hmin + dy < 0 or wmin + dx < 0:
                print(f"{info['image_path']}: render outside composite, skipped")
                continue
            depth_rng[hmin + dy:hmax + dy + 1, wmin + dx:wmax + dx + 1] = (
                ren_rng[hmin:hmax + 1, wmin:wmax + 1])

            # The composite was pasted at an offset: the principal point moves.
            K_old = LINEMOD_K.copy()
            K_old[0, 2] += dx
            K_old[1, 2] += dy

            mask = depth_rng < 1.0
            depth = range_to_depth(mask, depth_rng * 2.0, K_old)
            if crop_param is not None:
                image, depth, K_new = bbox_crop(image, depth, mask, K_old, **crop_param)
            else:
                K_new = K_old
            _write_frame(os.path.join(save_root, seq), info["index"], image, depth,
                         np.asarray(RTs[seq_idx]), K_new, bbox, mask=fuse_mask)
            n += 1
    return n


def main(argv=None):
    p = argparse.ArgumentParser(description="PVNet-rendering -> v2 frame-file converter")
    p.add_argument("mode", choices=["syn", "syn_lmk", "fuse", "fuse_single"])
    p.add_argument("--data_info", required=True, help="PVNet renderer info pickle")
    p.add_argument("--data_root", required=True)
    p.add_argument("--depth_root", default=None,
                   help="fuse modes: root of the source render range maps")
    p.add_argument("--save_root", required=True)
    p.add_argument("--crop_size", type=int, default=0,
                   help="if > 0, crop around the object to this size")
    p.add_argument("--crop_margin", type=float, default=0.1)
    args = p.parse_args(argv)

    with open(args.data_info, "rb") as f:
        data_info = pickle.load(f)
    crop_param = ({"margin_ratio": args.crop_margin, "output_size": args.crop_size}
                  if args.crop_size > 0 else None)
    if args.mode in ("syn", "syn_lmk"):
        n = process_syn(data_info, args.data_root, args.save_root, crop_param,
                        use_lmk=args.mode == "syn_lmk")
    else:
        if not args.depth_root:
            raise SystemExit("--depth_root is required for fuse modes")
        n = process_fuse(data_info, args.data_root, args.depth_root, args.save_root,
                         crop_param, single=args.mode == "fuse_single")
    print(f"wrote {n} frames to {args.save_root}")
    return n


if __name__ == "__main__":
    main()
