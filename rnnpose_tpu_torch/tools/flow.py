"""Optical flow between two images with RAFT through the port's graphed
engine (`models/engine.FlowEngine`), written as a Middlebury `.flo` file.

  python -m rnnpose_tpu_torch.tools.flow IMAGE1 IMAGE2 --out flow.flo
      [--pretrained_path raft-sintel.pth] [--iters 32] [--device cuda|cpu]
      [--seed 0]

IMAGE1 and IMAGE2 are PNG or JPEG files of one size (8-bit; gray repeated,
alpha dropped). `--pretrained_path` is a RAFT `state_dict` (RAFT's own
`raft-*.pth`, saved from `nn.DataParallel`): its `module.` prefixes are
stripped and it loads strictly. Without it the weights are PyTorch's
default initialisation under `--seed`. The model runs in f32, as RAFT's
evaluation does. The flow from IMAGE1 to IMAGE2 at
the images' size goes to `--out` in RAFT's `writeFlow` layout: the float32
tag 202021.25, the width and the height as int32, then (u, v) float32 per
pixel, row by row. The last stdout line is a JSON summary.
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from .train import positive_int

__all__ = ["TAG", "write_flo", "read_flo", "load_raft_state", "main"]

TAG = 202021.25  # b"PIEH" read as a little-endian float32


def write_flo(path: str, flow: np.ndarray) -> None:
    """(H, W, 2) flow -> a Middlebury `.flo` file."""
    h, w, c = flow.shape
    if c != 2:
        raise ValueError(f"a flow has 2 channels, got {c}")
    with open(path, "wb") as f:
        np.array([TAG], "<f4").tofile(f)
        np.array([w, h], "<i4").tofile(f)
        np.ascontiguousarray(flow, "<f4").tofile(f)


def read_flo(path: str) -> np.ndarray:
    """A Middlebury `.flo` file -> (H, W, 2) float32."""
    with open(path, "rb") as f:
        tag = np.fromfile(f, "<f4", 1)
        if tag.size != 1 or tag[0] != TAG:
            raise ValueError(f"{path}: not a .flo file")
        w, h = (int(v) for v in np.fromfile(f, "<i4", 2))
        data = np.fromfile(f, "<f4", 2 * w * h)
    return data.reshape(h, w, 2)


def load_raft_state(model, path: str) -> None:
    """A RAFT `state_dict` at `path` into `model`, `module.` prefixes
    stripped, strictly."""
    import torch

    state = torch.load(path, map_location="cpu", weights_only=True)
    state = {k.removeprefix("module."): v for k, v in state.items()}
    model.load_state_dict(state, strict=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("image1")
    p.add_argument("image2")
    p.add_argument("--out", required=True)
    p.add_argument("--pretrained_path")
    p.add_argument("--iters", type=positive_int, default=32)
    p.add_argument("--device", default="cuda")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)

    import torch

    from ..data.imageio import read_rgb
    from ..models.engine import FlowEngine
    from ..models.raft_flow import RAFT, RAFTConfig

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device}: no CUDA device is visible; pass "
                           "--device cpu to run on the host")
    frames = [read_rgb(path) for path in (args.image1, args.image2)]
    if frames[0].shape != frames[1].shape:
        raise ValueError(f"the images differ in size: {frames[0].shape} and {frames[1].shape}")
    torch.manual_seed(args.seed)
    model = RAFT(RAFTConfig())
    if args.pretrained_path:
        load_raft_state(model, args.pretrained_path)
    model = model.to(device).eval()
    image1, image2 = (torch.from_numpy(f).float()[None].to(device) for f in frames)
    flow = FlowEngine(model).flow(image1, image2, args.iters).flow[0].cpu().numpy()
    write_flo(args.out, flow)
    print(json.dumps({"out": args.out, "height": flow.shape[0], "width": flow.shape[1],
                      "iters": args.iters, "pretrained": bool(args.pretrained_path),
                      "mean_flow_px": float(np.linalg.norm(flow, axis=-1).mean())}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
