"""Write an on-disk LINEMOD-format synthetic dataset (port of
`rnnpose_tpu/tools/make_synthetic_linemod.py`).

The layout of the DeepIM-format trees the reference reads: PNG frames of a
textured icosphere (or capsule) at random poses, rendered with the port's
`rasterize_with_vis_attrs` (on a card, the rows-attrs CUDA kernel), uint16
depth in mm, the OBJ model, a train/eval `.info` split, a PoseCNN-format
pickle of noisy eval init poses, and a ready-to-run config. The random
draws are the JAX writer's, so both write the same poses, info pickles and
init-pose files from one seed. PNGs go through `data/imageio.py`, the
configs are JSON (under the JAX writer's `.yml` names; JSON is YAML too).

Usage:
  python -m rnnpose_tpu_torch.tools.make_synthetic_linemod --out /data/synlm \\
      [--frames 640] [--eval_frames 64] [--batch 8] [--device cuda]
"""
from __future__ import annotations

import argparse
import copy
import json
import os
import pickle


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--out", type=str, required=True)
    p.add_argument("--frames", type=int, default=640, help="train frames")
    p.add_argument("--eval_frames", type=int, default=64)
    p.add_argument("--height", type=int, default=480)
    p.add_argument("--width", type=int, default=640)
    p.add_argument("--class_name", type=str, default="cat")
    p.add_argument("--object_scale", type=float, default=0.06)
    p.add_argument("--distance", type=float, default=0.55)
    # The LINEMOD camera by default; tests render tiny frames with a scaled one.
    p.add_argument("--fx", type=float, default=572.4114)
    p.add_argument("--fy", type=float, default=573.57043)
    p.add_argument("--cx", type=float, default=325.2611)
    p.add_argument("--cy", type=float, default=242.04899)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--batch", type=int, default=8, help="render batch")
    p.add_argument("--steps", type=int, default=20000,
                   help="steps written into the emitted config")
    p.add_argument("--occ", action="store_true",
                   help="also emit the Occlusion-LINEMOD eval variant: PVNet-occ init "
                   "poses in the BLENDER frame, a blender2bop_RT conversion table, a "
                   "`{cls}_test_occ.info` and an eval config with init_pose_type "
                   "PVNET_LINEMOD_OCC")
    p.add_argument("--shape", type=str, default="icosphere", choices=["icosphere", "capsule"],
                   help="object geometry: 'icosphere' or an elongated 2.5:1 'capsule'")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device of the renders (default: cuda; pass cpu on a host "
                   "without a card)")
    return p.parse_args(argv)


def _write_json(path, cfg):
    with open(path, "w") as f:
        json.dump(cfg, f, indent=2)
        f.write("\n")


def main(argv=None):
    args = parse_args(argv)
    import numpy as np
    import torch
    from scipy.spatial.transform import Rotation

    from ..data import imageio
    from ..data.poses import sample_noisy_poses
    from ..data.synthetic import make_capsule, make_icosphere
    from ..render import mesh as mesh_lib
    from ..render.raster import rasterize_with_vis_attrs
    from ..render.shading import compute_vertex_normals, headlight_shade

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device}: no CUDA device is visible; pass "
                           "--device cpu to render on the host")
    H, W = args.height, args.width
    cls = args.class_name
    K = np.asarray([[args.fx, 0.0, args.cx], [0.0, args.fy, args.cy], [0, 0, 1]], np.float32)
    rs = np.random.RandomState(args.seed)

    root = args.out
    os.makedirs(os.path.join(root, "models", cls), exist_ok=True)
    os.makedirs(os.path.join(root, "frames"), exist_ok=True)

    # A subdivision-4 icosphere (2562 verts) or a capsule of the same
    # budget; the dataset simplifies it to its 2048v/4096f budget at load.
    if args.shape == "capsule":
        mesh = make_capsule(4, args.object_scale * 0.5)
    else:
        mesh = make_icosphere(4, args.object_scale)
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

    n_total = args.frames + args.eval_frames
    poses = np.tile(np.eye(4, dtype=np.float32), (n_total, 1, 1))
    for i in range(n_total):
        poses[i, :3, :3] = Rotation.random(random_state=rs).as_matrix()
        poses[i, :3, 3] = [
            rs.uniform(-0.08, 0.08),
            rs.uniform(-0.06, 0.06),
            args.distance * rs.uniform(0.85, 1.25),
        ]

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
    B = args.batch
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
            imageio.write_png(os.path.join(root, "frames", f"{i:06d}-color.png"), rgb8)
            imageio.write_png(os.path.join(root, "frames", f"{i:06d}-depth.png"), depth_mm)
            frames.append({
                "index": i,
                "rgb_observed_path": f"frames/{i:06d}-color.png",
                "depth_gt_observed_path": f"frames/{i:06d}-depth.png",
                "gt_pose": poses[i, :3, :4].copy(),
                "K": K.copy(),
            })
        print(f"rendered {min(beg + B, n_total)}/{n_total}", flush=True)

    train_frames = frames[:args.frames]
    eval_frames = frames[args.frames:]
    with open(os.path.join(root, f"{cls}_train.info"), "wb") as f:
        pickle.dump({cls: train_frames}, f)
    with open(os.path.join(root, f"{cls}_eval.info"), "wb") as f:
        pickle.dump({cls: eval_frames}, f)

    # Noisy eval init poses in the PoseCNN pickle layout ({cls: {idx:
    # {'pose': [qw qx qy qz tx ty tz]}}}): eval starts from a perturbed pose.
    def mat_to_quat_pose(T):
        q = Rotation.from_matrix(T[:3, :3]).as_quat()  # xyzw
        return np.asarray([q[3], q[0], q[1], q[2], T[0, 3], T[1, 3], T[2, 3]], np.float32)

    noisy = sample_noisy_poses(
        np.stack([np.vstack([f["gt_pose"], [0, 0, 0, 1]]) for f in eval_frames]),
        np.random.RandomState(args.seed + 1),
    )
    init_poses = {cls: {f["index"]: {"pose": mat_to_quat_pose(noisy[k])}
                        for k, f in enumerate(eval_frames)}}
    init_path = os.path.join(root, f"{cls}_init_poses.pkl")
    with open(init_path, "wb") as f:
        pickle.dump(init_poses, f)

    if args.occ:
        # PVNet init poses live in the BLENDER camera frame; the loader maps
        # them to the BOP frame by R_bop = R_bl C_R^T, t_bop = -R_bop C_t +
        # t_bl. The blender-frame poses are built as that map's inverse, so
        # they land on the PoseCNN pickle's inits.
        conv = np.eye(4, dtype=np.float32)
        conv[:3, :3] = Rotation.from_euler("xyz", [180.0, 0.0, 90.0], degrees=True).as_matrix()
        conv[:3, 3] = [0.004, -0.002, 0.003]
        occ_init = {}
        for k, f_ in enumerate(eval_frames):
            T_bop = noisy[k]
            R_bl = T_bop[:3, :3] @ conv[:3, :3]
            t_bl = T_bop[:3, 3] + T_bop[:3, :3] @ conv[:3, 3]
            occ_init[f_["index"]] = np.concatenate([R_bl, t_bl[:, None]], axis=1).astype(
                np.float32)
        occ_npy = os.path.join(root, f"pvnet_{cls}occ_test.npy")
        np.save(occ_npy, {cls: occ_init}, allow_pickle=True)
        b2b_npy = os.path.join(root, "blender2bop_RT.npy")
        np.save(b2b_npy, {cls: conv}, allow_pickle=True)
        with open(os.path.join(root, f"{cls}_test_occ.info"), "wb") as f:
            pickle.dump({cls: eval_frames}, f)

    def reader(info):
        return {"info_paths": [os.path.join(root, info)], "root_paths": [root],
                "model_dir": os.path.join(root, "models"), "class_names": [cls]}

    cfg = {
        "train_config": {"steps": args.steps, "steps_per_eval": 1000},
        "train_input_reader": {"dataset": {"kwargs": reader(f"{cls}_train.info")},
                               "batch_size": 1},
        "eval_input_reader": {"dataset": {"kwargs": dict(
            reader(f"{cls}_eval.info"), init_pose_paths={"POSECNN_LINEMOD": init_path})}},
    }
    cfg_path = os.path.join(root, "train_config.yml")
    _write_json(cfg_path, cfg)
    if args.occ:
        cfg_occ = copy.deepcopy(cfg)
        ek = cfg_occ["eval_input_reader"]["dataset"]["kwargs"]
        ek["info_paths"] = [os.path.join(root, f"{cls}_test_occ.info")]
        ek["init_pose_type"] = "PVNET_LINEMOD_OCC"
        ek["init_pose_paths"] = {"PVNET_LINEMOD_OCC": occ_npy}
        ek["blender_to_bop_path"] = b2b_npy
        _write_json(os.path.join(root, "eval_config_occ.yml"), cfg_occ)
    print(f"wrote {len(train_frames)} train + {len(eval_frames)} eval frames")
    print(f"config: {cfg_path}")
    return cfg_path


if __name__ == "__main__":
    main()
