"""Frames per second of the eval forward by the JAX package's tracking-chain
protocol (port of `bench.py`'s `measure_fps`).

The forward is the main path: `models/engine.InferenceEngine.refine`, the
counterpart of bench.py's jitted forward, which computes the per-class 3D
descriptors once, captures the cached forward as a CUDA graph on the first
request and replays it on every later one; seeded random weights, at
bench.py's operating
point (`SCENES["bench"]`: 320^2 image, 240^2 crop, a 2048-vertex /
4096-face icosphere, 4-layer 128-wide KPConv towers, 3 x 4 x 1
iterations, the default bf16 precision). The protocol:

  * every frame's init pose is the scene's, plus a fresh jitter of 1e-3
    (an entropy-seeded normal per element) plus 1e-30 times the previous
    frame's output: each frame depends on the last, and a chain re-centred
    on the true pose does not drift off the image;
  * 8 frames of warm-up (the first makes the engine's program), then best
    of 3 chains of 40 frames: each frame's init pose is copied into the
    program's static `T_init` and the graph replayed; the window of each
    chain closes on a host read of the last pose (its finiteness), which
    synchronises with the card inside the window;
  * fps = B / (seconds per frame), and every repeat's fps is returned.

The FLOPs per frame are `torch.utils.flop_counter.FlopCounterMode`'s count
of one eager forward (matmuls and convolutions only; it cannot count a
replay), labelled as that count; it is not the JAX package's XLA cost
analysis and is not compared with it.

Usage:
  python -m rnnpose_tpu_torch.tools.measure_fps [--batch 1 8] [--render_iters R]
      [--gru_iters G] [--device cuda|cpu] [--scene bench|tiny] [--frames 40]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

from .train import positive_int

# Each scene: the synthetic scene (SyntheticConfig overrides), the refiner's
# crop, correlation levels and raster chunk, and the towers' width.
SCENES = {
    "bench": dict(syn=dict(image_size=320, num_verts=2048, num_faces=4096, subdivisions=4,
                           num_corr=256, kp_layers=4, kp_dl=0.006),
                  refiner=dict(), tower_width=128),
    # The tests' size (`__graft_entry__._tiny_setup`'s scene, 2-layer towers).
    "tiny": dict(syn=dict(image_size=96, num_verts=256, num_faces=512, subdivisions=2,
                          num_corr=64, kp_layers=2, kp_dl=0.03, fx=150.0, fy=150.0),
                 refiner=dict(zoom_crop_size=48, corr_levels=3, raster_chunk=64),
                 tower_width=16),
}
WARMUP_FRAMES, REPEATS = 8, 3


def build(batch_size, render_iters=None, gru_iters=None, device="cuda", scene="bench"):
    """(an `InferenceEngine` over the model, the scene's inputs): the model
    at the scene's operating point, the budget overridden where given; the
    engine serves the scene under the class name `scene`."""
    import torch

    from ..data.synthetic import SyntheticConfig, kpconv_config, make_synthetic_inputs
    from ..models.refiner import RefinerConfig
    from ..models.engine import InferenceEngine
    from ..models.rnnpose import RNNPose, RNNPoseConfig, init_random_

    spec = SCENES[scene]
    syn = SyntheticConfig(batch_size=batch_size, **spec["syn"])
    inputs = make_synthetic_inputs(syn, device=device)
    refiner = RefinerConfig(**spec["refiner"])
    refiner = dataclasses.replace(
        refiner,
        render_iters=refiner.render_iters if render_iters is None else render_iters,
        gru_iters=refiner.gru_iters if gru_iters is None else gru_iters)
    kp = kpconv_config(syn)
    width = dict(first_feats_dim=spec["tower_width"], gnn_feats_dim=spec["tower_width"])
    cfg = RNNPoseConfig(
        desc_kp=dataclasses.replace(kp, final_feats_dim=32, **width),
        ctx_kp=dataclasses.replace(kp, final_feats_dim=256, normalize_output=False, **width),
        refiner=refiner)
    model = init_random_(RNNPose(cfg), torch.Generator().manual_seed(0)).to(device).eval()
    return InferenceEngine(model), inputs


def measure_fps(batch_size: int, render_iters=None, gru_iters=None, device="cuda",
                scene="bench", frames=40):
    """(best fps, FlopCounterMode GFLOPs per frame, the 3 repeats' fps) of
    the chained eval forward (see the module docstring)."""
    import numpy as np
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device}: no CUDA device is visible; pass cpu to run on "
                           "the host")
    engine, inputs = build(batch_size, render_iters, gru_iters, device, scene)
    T_base = inputs.T_init
    desc3d, ctx3d = engine.class_features(scene, inputs.pyramid)
    with FlopCounterMode(display=False) as counter:
        engine.model(inputs, cached_desc3d=desc3d, cached_ctx3d=ctx3d)
    gflops_per_frame = counter.get_total_flops() / 1e9 / batch_size

    rs = np.random.RandomState(int.from_bytes(os.urandom(4), "little"))

    def forward(T_init):
        return engine.refine(scene, inputs._replace(T_init=T_init))["Ti_pred"]

    def measure(iters):
        jitters = [torch.from_numpy(rs.randn(*T_base.shape).astype(np.float32) * 1e-3)
                   .to(device) for _ in range(iters)]
        T_out = T_base
        t0 = time.perf_counter()
        for i in range(iters):
            T_out = forward(T_base + jitters[i] + 1e-30 * T_out)
        finite = bool(torch.isfinite(T_out).all())  # the host read, inside the window
        dt = (time.perf_counter() - t0) / iters
        if not finite:
            raise AssertionError("measure_fps: non-finite poses")
        return dt

    measure(WARMUP_FRAMES)
    reps = [batch_size / measure(frames) for _ in range(REPEATS)]
    return max(reps), gflops_per_frame, reps


def main(argv=None):
    p = argparse.ArgumentParser(description="fps of the chained eval forward")
    p.add_argument("--batch", type=positive_int, nargs="+", default=[1, 8])
    p.add_argument("--render_iters", type=positive_int, default=None)
    p.add_argument("--gru_iters", type=positive_int, default=None)
    p.add_argument("--scene", choices=sorted(SCENES), default="bench")
    p.add_argument("--frames", type=positive_int, default=40,
                   help="frames per timed chain (the protocol's 40)")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device (default: cuda; pass cpu to run on the host)")
    args = p.parse_args(argv)
    rows = []
    for B in args.batch:
        fps, gflops, reps = measure_fps(B, args.render_iters, args.gru_iters, args.device,
                                        args.scene, args.frames)
        row = {"batch": B, "fps": fps, "fps_runs": reps,
               "spread_pct": 100.0 * (max(reps) - min(reps)) / max(reps),
               "ms_per_frame": 1e3 / fps, "flop_counter_gflops_per_frame": gflops}
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows


if __name__ == "__main__":
    main()
