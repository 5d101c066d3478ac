"""Demo: refine a noisy pose on a synthetic scene and dump visualizations
(port of `rnnpose_tpu/tools/demo.py`).

The reference ships demo GIFs (`demo/`); this produces the same qualitative
images from scratch: overlays of the model points at the initial (red),
refined (green) and true (blue) poses, the rendered reference view, the
observed crop, the last rendered depth, the flow coloring and the
similarity weights. Six PNGs, written by the port's own PNG writer
(`data/imageio.write_png`; no OpenCV).

Usage: python -m rnnpose_tpu_torch.tools.demo --out_dir /tmp/demo
           [--device cuda|cpu] [--ckpt_path PATH]

The model runs on `--device` (default `cuda`; where no card is visible it
raises unless `--device cpu` is given), with random weights (seed 0) or the
model of a port checkpoint (`--ckpt_path`, `train/checkpoint.py`).
"""
from __future__ import annotations

import argparse
import dataclasses
import os

from .train import positive_int

OUTPUTS = ("poses_init-red_refined-green_gt-blue.png", "syn_img.png", "image_crop.png",
           "syn_depth.png", "flow.png", "similarity_weight.png")


def main(argv=None):
    p = argparse.ArgumentParser(description="rnnpose_tpu_torch demo")
    p.add_argument("--out_dir", default="demo_out")
    p.add_argument("--image_size", type=positive_int, default=160)
    p.add_argument("--zoom", type=positive_int, default=120)
    p.add_argument("--ckpt_path", type=str, default=None)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device (default: cuda; pass cpu to run on the host)")
    args = p.parse_args(argv)

    import numpy as np
    import torch

    from ..data.imageio import write_png
    from ..data.synthetic import SyntheticConfig, kpconv_config, make_synthetic_inputs
    from ..models.refiner import RefinerConfig
    from ..models.rnnpose import RNNPose, RNNPoseConfig, init_random_
    from ..utils.visualize import depth_to_color, flow_to_color, project_pose_overlay

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device}: no CUDA device is visible; pass "
                           "--device cpu to run on the host")
    os.makedirs(args.out_dir, exist_ok=True)
    syn = SyntheticConfig(
        image_size=args.image_size, num_verts=512, num_faces=1024,
        subdivisions=3, kp_layers=3, kp_dl=0.012, seed=7,
    )
    inputs = make_synthetic_inputs(syn, device=device)
    kp = kpconv_config(syn)
    cfg = RNNPoseConfig(
        desc_kp=dataclasses.replace(kp, final_feats_dim=32),
        ctx_kp=dataclasses.replace(kp, final_feats_dim=256, normalize_output=False),
        refiner=RefinerConfig(zoom_crop_size=args.zoom),
    )
    model = init_random_(RNNPose(cfg), torch.Generator().manual_seed(0))
    if args.ckpt_path:
        from ..train.checkpoint import restore_checkpoint

        model.load_state_dict(restore_checkpoint(args.ckpt_path, map_location="cpu")["model"])
    model = model.to(device).eval()
    out = model(inputs, train=False)

    def host(t):
        return t.detach().float().cpu().numpy()

    def save(name, arr):
        img = np.clip(np.asarray(arr, np.float32), 0, 1)
        write_png(os.path.join(args.out_dir, name), (img * 255).astype(np.uint8))

    img = host(inputs.image[0])
    pts = host(inputs.model_points[0])[host(inputs.point_valid[0]) > 0]
    K = host(inputs.intrinsics[0])
    overlay = project_pose_overlay(img, pts, host(inputs.T_init[0]), K, color=(1.0, 0.2, 0.2))
    overlay = project_pose_overlay(overlay, pts, host(out["Ti_pred"][0]), K,
                                   color=(0.2, 1.0, 0.2))
    overlay = project_pose_overlay(overlay, pts, host(inputs.T_gt[0]), K, color=(0.2, 0.4, 1.0))
    ref = out["refiner"]
    w = host(ref.weight[0, ..., 0])
    images = (overlay, host(ref.syn_img[0]), host(ref.image_crop[0]),
              depth_to_color(host(ref.syn_depth_history[-1, 0])),
              flow_to_color(host(ref.flow_history[-1, 0])), np.stack([w, w, w], axis=-1))
    for name, arr in zip(OUTPUTS, images):
        save(name, arr)
    print(f"wrote {len(OUTPUTS)} visualizations to {args.out_dir}")
    return [os.path.join(args.out_dir, name) for name in OUTPUTS]


if __name__ == "__main__":
    main()
