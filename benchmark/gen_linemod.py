"""A LINEMOD-format data set written from the seed, frozen here: a copy of
`rnnpose_tpu_torch/tools/make_synthetic_linemod.py` (its icosphere, without
`--occ` and `--shape capsule`) that imports nothing of the program.

It renders with the reference's plain raster (`reference/render`), on any
device, and writes through the reference's PNG writer
(`reference/data/imageio.py`): PNG frames of a textured icosphere at random
poses over a noise background, uint16 depth in mm, the OBJ model, the
train and eval `.info` pickles, a PoseCNN-format pickle of noisy eval
initial poses and a JSON config (`train_config.yml`: JSON is YAML too).
With the program writer's parameters (`DEFAULTS`) and one seed it writes
the same files, byte for byte, as the program's tool does on the CPU; the
object's depth range (`distance_range`, the tool's 0.85-1.25) is a
parameter here, so that a traffic mix can state its own. The random draws
are sequential; the PNG encodings run in a few threads (zlib releases the
interpreter lock), which changes no byte.
"""
from __future__ import annotations

import json
import os
import pickle
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict

import numpy as np
import torch

from .gen import icosphere
from .reference.data import imageio
from .reference.data.poses import sample_noisy_poses
from .reference.render import mesh as mesh_lib
from .reference.render.raster import rasterize_with_vis_attrs
from .reference.render.shading import compute_vertex_normals, headlight_shade

__all__ = ["DEFAULTS", "write"]

# `make_synthetic_linemod`'s defaults.
DEFAULTS: Dict[str, Any] = dict(
    frames=640, eval_frames=64, height=480, width=640, class_name="cat", object_scale=0.06,
    distance=0.55, distance_range=(0.85, 1.25), fx=572.4114, fy=573.57043, cx=325.2611,
    cy=242.04899, seed=0, batch=8, steps=20000)

WRITERS = 4  # threads that encode and write PNGs


def write(root: str, p: Dict[str, Any], device) -> str:
    """Write the data set under `root` with parameters `p` (every key of
    `DEFAULTS`), rendering on `device`; returns the config's path."""
    from scipy.spatial.transform import Rotation

    device = torch.device(device)
    H, W = p["height"], p["width"]
    cls = p["class_name"]
    K = np.asarray([[p["fx"], 0.0, p["cx"]], [0.0, p["fy"], p["cy"]], [0, 0, 1]], np.float32)
    rs = np.random.RandomState(p["seed"])
    os.makedirs(os.path.join(root, "models", cls), exist_ok=True)
    os.makedirs(os.path.join(root, "frames"), exist_ok=True)

    # The subdivision-4 icosphere (2562 verts); the dataset simplifies it to
    # its budget at load.
    mesh = icosphere(4, p["object_scale"])
    with open(os.path.join(root, "models", cls, "textured.obj"), "w") as f:
        for v, c in zip(mesh.verts, mesh.vert_colors):
            f.write(f"v {v[0]} {v[1]} {v[2]} {c[0]} {c[1]} {c[2]}\n")
        for a, b, c_ in mesh.faces + 1:
            f.write(f"f {a} {b} {c_}\n")

    rmesh = mesh_lib.orient_faces_outward(mesh)
    normals = compute_vertex_normals(rmesh.verts, rmesh.faces)
    faces = torch.as_tensor(rmesh.faces.astype(np.int64), device=device)
    face_valid = torch.ones(len(rmesh.faces), dtype=torch.bool, device=device)
    verts_t = torch.as_tensor(rmesh.verts, device=device)
    normals_t = torch.as_tensor(normals, device=device)
    colors_t = torch.as_tensor(rmesh.vert_colors, device=device)
    intr = torch.as_tensor([[K[0, 0], K[1, 1], K[0, 2], K[1, 2]]], device=device)

    n_total = p["frames"] + p["eval_frames"]
    lo, hi = p["distance_range"]
    poses = np.tile(np.eye(4, dtype=np.float32), (n_total, 1, 1))
    for i in range(n_total):
        poses[i, :3, :3] = Rotation.random(random_state=rs).as_matrix()
        poses[i, :3, 3] = [rs.uniform(-0.08, 0.08), rs.uniform(-0.06, 0.06),
                           p["distance"] * rs.uniform(lo, hi)]

    def render(T):
        R, t = T[:, :3, :3], T[:, None, :3, 3]
        vc = torch.einsum("bij,vj->bvi", R, verts_t) + t
        nc = torch.einsum("bij,vj->bvi", R, normals_t)
        attrs = torch.cat([colors_t[None].expand(nc.shape[0], -1, -1), nc], dim=-1)
        attr_img, zbuf, fid = rasterize_with_vis_attrs(
            vc, faces, intr.expand(T.shape[0], 4), attrs, H, W, face_valid=face_valid)
        shaded = headlight_shade(attr_img[..., :3], attr_img[..., 3:6])
        return shaded.cpu().numpy(), zbuf.cpu().numpy(), fid.cpu().numpy()

    frames = []
    B = p["batch"]
    with ThreadPoolExecutor(WRITERS, thread_name_prefix="png") as pool:
        pending = []
        for beg in range(0, n_total, B):
            T = poses[beg:beg + B]
            pad = B - len(T)
            if pad:
                T = np.concatenate([T, np.tile(np.eye(4, dtype=np.float32), (pad, 1, 1))])
            shaded, zbuf, fid = render(torch.as_tensor(T, device=device))
            for j in range(len(T) - pad):
                i = beg + j
                fg = fid[j] >= 0
                img = rs.rand(H, W, 3).astype(np.float32) * 0.15
                img[fg] = np.clip(shaded[j][fg] + rs.randn(int(fg.sum()), 3) * 0.02, 0, 1)
                rgb8 = (img * 255).astype(np.uint8)
                depth_mm = np.where(fg, zbuf[j] * 1000.0, 0.0).astype(np.uint16)
                for name, pix in (("color", rgb8), ("depth", depth_mm)):
                    pending.append(pool.submit(
                        imageio.write_png, os.path.join(root, "frames", f"{i:06d}-{name}.png"),
                        pix))
                frames.append({
                    "index": i,
                    "rgb_observed_path": f"frames/{i:06d}-color.png",
                    "depth_gt_observed_path": f"frames/{i:06d}-depth.png",
                    "gt_pose": poses[i, :3, :4].copy(),
                    "K": K.copy(),
                })
        for fut in pending:
            fut.result()

    train_frames, eval_frames = frames[:p["frames"]], frames[p["frames"]:]
    with open(os.path.join(root, f"{cls}_train.info"), "wb") as f:
        pickle.dump({cls: train_frames}, f)
    with open(os.path.join(root, f"{cls}_eval.info"), "wb") as f:
        pickle.dump({cls: eval_frames}, f)

    def mat_to_quat_pose(T):
        q = Rotation.from_matrix(T[:3, :3]).as_quat()  # xyzw
        return np.asarray([q[3], q[0], q[1], q[2], T[0, 3], T[1, 3], T[2, 3]], np.float32)

    noisy = sample_noisy_poses(
        np.stack([np.vstack([f["gt_pose"], [0, 0, 0, 1]]) for f in eval_frames]),
        np.random.RandomState(p["seed"] + 1))
    init_poses = {cls: {f["index"]: {"pose": mat_to_quat_pose(noisy[k])}
                        for k, f in enumerate(eval_frames)}}
    init_path = os.path.join(root, f"{cls}_init_poses.pkl")
    with open(init_path, "wb") as f:
        pickle.dump(init_poses, f)

    def reader(info):
        return {"info_paths": [os.path.join(root, info)], "root_paths": [root],
                "model_dir": os.path.join(root, "models"), "class_names": [cls]}

    cfg = {
        "train_config": {"steps": p["steps"], "steps_per_eval": 1000},
        "train_input_reader": {"dataset": {"kwargs": reader(f"{cls}_train.info")},
                               "batch_size": 1},
        "eval_input_reader": {"dataset": {"kwargs": dict(
            reader(f"{cls}_eval.info"), init_pose_paths={"POSECNN_LINEMOD": init_path})}},
    }
    cfg_path = os.path.join(root, "train_config.yml")
    with open(cfg_path, "w") as f:
        json.dump(cfg, f, indent=2)
        f.write("\n")
    return cfg_path
