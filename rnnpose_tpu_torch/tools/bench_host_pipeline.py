"""Host input-pipeline throughput at shipping sizes (port of
`rnnpose_tpu/tools/bench_host_pipeline.py`).

The trainer overlaps host preprocessing with device compute through
`data/loader.PrefetchLoader`; this tool measures whether the host keeps up.
It writes a LINEMOD-layout fixture at the shipping operating point (640x480
PNG frames, a 2048-vertex model, the 4-layer KPConv pyramid, 320x320 crops,
the full correspondence build), each frame rendered over the object's
window with the port's raster on `--device` (on a card, the rows-attrs CUDA
kernel) and written with the port's PNG codec, then measures

  * the latency of one `dataset[i]` (decode, crop, correspondences) on one
    thread,
  * `PrefetchLoader` samples/s at each of `--threads`,

and reports the margin against the device's training step, `--device_ms`
per step at `--batch_size`. Its default, 559.1 ms, is the median B=1
training step of PERF.md section 5 (chip_smoke.py phase 11; NVIDIA H100
80GB HBM3, 700 W).

Usage: python -m rnnpose_tpu_torch.tools.bench_host_pipeline [--frames 24]
       [--samples 96] [--device_ms 559.1] [--batch_size 1] [--threads 1 2 4 8]
       [--device cuda]
The last stdout line is a JSON summary.
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

from .train import positive_int

TILE = 16  # the raster's pixel tile: rendered windows are multiples of it


def make_shipping_fixture(root: str, num_frames: int = 24, seed: int = 0, device="cuda"):
    """A LINEMOD-layout tree at shipping sizes: 640x480 frames of a textured
    icosphere (real foreground pixel counts drive the KD-tree cost) and its
    2048-vertex model. Returns the `.info` path."""
    import pickle

    import numpy as np
    import torch
    from scipy.spatial.transform import Rotation

    from ..data import imageio
    from ..data.synthetic import make_icosphere
    from ..render import mesh as mesh_lib
    from ..render.raster import rasterize_with_vis_attrs

    rs = np.random.RandomState(seed)
    H, W = 480, 640
    K = np.asarray([[572.4114, 0, 325.2611], [0, 573.57043, 242.04899], [0, 0, 1]], np.float32)

    mesh = make_icosphere(4, 0.06)  # 2562 vertices
    mesh = mesh_lib.simplify_mesh(mesh, 2048, 4096)
    mesh = mesh_lib.orient_faces_outward(mesh)
    model_dir = os.path.join(root, "models", "cat")
    os.makedirs(model_dir, exist_ok=True)
    with open(os.path.join(model_dir, "textured.obj"), "w") as f:
        for v, c in zip(mesh.verts, mesh.vert_colors):
            f.write(f"v {v[0]} {v[1]} {v[2]} {c[0]} {c[1]} {c[2]}\n")
        for a, b, c_ in mesh.faces + 1:
            f.write(f"f {a} {b} {c_}\n")
    n_faces = mesh.num_faces
    mesh = mesh_lib.pad_mesh(mesh, 2048, 4096)  # the raster's static face budget
    faces = torch.as_tensor(mesh.faces.astype(np.int64), device=device)
    face_valid = torch.as_tensor(np.arange(4096) < n_faces, device=device)
    frames_dir = os.path.join(root, "frames")
    os.makedirs(frames_dir, exist_ok=True)
    frames = []
    for i in range(num_frames):
        RT = np.eye(3, 4, dtype=np.float32)
        RT[:3, :3] = Rotation.random(random_state=rs).as_matrix()
        RT[:, 3] = [rs.uniform(-0.05, 0.05), rs.uniform(-0.05, 0.05), rs.uniform(0.45, 0.65)]
        vc = mesh.verts @ RT[:3, :3].T + RT[:, 3]
        attrs = np.concatenate([mesh.vert_colors, vc[:, 2:3]], axis=-1).astype(np.float32)
        # Rendered over the object's projected window only (tile-aligned,
        # the camera shifted to it): the plain sweep on a host costs
        # O(pixels x faces).
        uv = vc[:, :2] / vc[:, 2:3] * K[[0, 1], [0, 1]] + K[:2, 2]
        x0, y0 = (max(0, int(np.floor(c)) - 1) // TILE * TILE for c in uv.min(0))
        x1, y1 = (min(n, -(-(int(np.ceil(c)) + 2) // TILE) * TILE)
                  for c, n in zip(uv.max(0), (W, H)))
        kvec = torch.as_tensor([[K[0, 0], K[1, 1], K[0, 2] - x0, K[1, 2] - y0]], device=device)
        win, _, wfid = rasterize_with_vis_attrs(
            torch.as_tensor(vc[None], device=device), faces, kvec,
            torch.as_tensor(attrs[None], device=device), y1 - y0, x1 - x0,
            face_valid=face_valid)
        amap = np.zeros((H, W, 4), np.float32)
        fid = np.full((H, W), -1, np.int64)
        amap[y0:y1, x0:x1] = win[0].cpu().numpy()
        fid[y0:y1, x0:x1] = wfid[0].cpu().numpy()
        fg = fid >= 0
        rgb = (rs.rand(H, W, 3) * 40).astype(np.uint8)
        rgb[fg] = np.clip(amap[fg, :3] * 255, 0, 255).astype(np.uint8)
        depth_mm = np.zeros((H, W), np.uint16)
        depth_mm[fg] = (amap[fg, 3] * 1000).astype(np.uint16)
        imageio.write_png(os.path.join(frames_dir, f"{i}-color.png"), rgb)
        imageio.write_png(os.path.join(frames_dir, f"{i}-depth.png"), depth_mm)
        frames.append({
            "index": i,
            "rgb_observed_path": f"frames/{i}-color.png",
            "depth_gt_observed_path": f"frames/{i}-depth.png",
            "gt_pose": RT,
            "K": K,
        })
    info_path = os.path.join(root, "cat.info")
    with open(info_path, "wb") as f:
        pickle.dump({"cat": frames}, f)
    return info_path


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="host input-pipeline throughput")
    p.add_argument("--frames", type=positive_int, default=24)
    p.add_argument("--samples", type=positive_int, default=96,
                   help="samples to time (cycling over --frames)")
    p.add_argument("--device_ms", type=float, default=559.1,
                   help="device ms per training step at --batch_size (default: the "
                        "median B=1 step of PERF.md section 5, chip_smoke.py phase 11 on "
                        "an NVIDIA H100 80GB HBM3 at 700 W)")
    p.add_argument("--batch_size", type=positive_int, default=1)
    p.add_argument("--threads", type=positive_int, nargs="*", default=[1, 2, 4, 8])
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device of the fixture's renders (default: cuda; pass cpu "
                        "on a host without a card)")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    import torch

    from ..data.linemod import LinemodSynRealDataset, collate_samples
    from ..data.loader import PrefetchLoader
    from ..data.preprocess import TooFewCorrespondences
    from ..models.kpconv_net import KPConvConfig

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device}: no CUDA device is visible; pass "
                           "--device cpu to render on the host")
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        info_path = make_shipping_fixture(root, args.frames, device=device)
        print(f"fixture built in {time.perf_counter() - t0:.1f}s "
              f"({args.frames} frames, 640x480, 2048v model)", flush=True)

        ds = LinemodSynRealDataset(
            info_paths=[info_path], root_paths=[root],
            model_dir=os.path.join(root, "models"),
            kp_cfg=KPConvConfig(num_layers=4, first_subsampling_dl=0.025),
            is_train=True,
        )
        ds.class_assets("cat")  # the one-time pyramid, outside the timing
        ds[0]

        n = args.samples
        t0 = time.perf_counter()
        for i in range(n):
            try:
                ds[i % len(ds)]
            except TooFewCorrespondences:
                pass
        t_sample = (time.perf_counter() - t0) / n * 1000
        print(f"dataset[i] single-thread: {t_sample:.1f} ms/sample "
              f"({1000 / t_sample:.1f} samples/s)", flush=True)

        bs = args.batch_size
        need = 1000.0 / args.device_ms * bs  # samples/s that keep the device busy
        results = {}
        for nt in args.threads:
            loader = PrefetchLoader([i % len(ds) for i in range(n)], ds.__getitem__, bs,
                                    collate_samples, num_threads=nt,
                                    skip_exc=TooFewCorrespondences)
            it = iter(loader)
            next(it)  # warm the pipeline
            t0 = time.perf_counter()
            got = sum(1 for _ in it)
            dt = time.perf_counter() - t0
            loader.close()
            sps = got * bs / max(dt, 1e-9)
            results[nt] = sps
            print(f"PrefetchLoader x{nt} threads: {sps:.1f} samples/s (need {need:.2f} for "
                  f"the {args.device_ms:g} ms/step device time at bs={bs}; margin "
                  f"{sps / need:.2f}x)", flush=True)

        best = max(results.values())
        summary = {
            "metric": "host_pipeline_samples_per_sec",
            "value": round(best, 2),
            "single_thread_ms": round(t_sample, 2),
            "per_threads": {str(k): round(v, 2) for k, v in results.items()},
            "device_budget_samples_per_sec": round(need, 2),
            "margin": round(best / need, 2),
        }
        print(json.dumps(summary))
        return summary


if __name__ == "__main__":
    main()
