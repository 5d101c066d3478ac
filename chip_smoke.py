#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of RNNPose once on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases (each raises on failure, so any failure exits non-zero):
  1. build the three CUDA raster sources of `rnnpose_tpu_torch/csrc/` (one
     nvcc each, started together, with -Xptxas -v) and the host library of
     the native KPConv pyramid ops;
  2. the fused rows-attrs kernel against its plain PyTorch version at the
     serving path's raster shapes (B=1 and B=8, 4096 faces, 240^2 crop,
     D=6), plus a sparse small-object pose and a padding-heavy mesh:
     face-id mismatches, max |dz|, max |dattrs|; per case the culled
     sweep's work counted on the card (32 x 32 blocks that list a face,
     (block, face) pairs, pixel tests, pixel-in-bbox pairs), the bytes and
     the bound; at B=1, B=8 and the sparse pose the kernel's device time
     (CUDA events around a CUDA graph of launches, `_device_ms`), its share
     of the bound, the time of a call from the host, the plain version's
     time, and the device time at each cluster split (1, 2, 4, 8) beside
     the wrapper's choice;
  3. the whole serving eval forward in f32 at the reference operating
     point, once through the kernel and once through the plain raster:
     Ti_pred agrees;
  4. serving: the default (bf16) config with seeded random weights and
     cached 3D features, 8 requests at B=1 and 4 at B=8 in a tracking chain
     re-centred on the initial pose (a fresh small rigid jitter each frame);
     poses must be finite and rigid, and the rows-attrs kernel's launch
     count must equal render_iters per request; ms/frame;
  5. the z/fid kernels (`zbuffer_sweep_tiled`: culled; `zbuffer_sweep`:
     the brute-force contract, a reach pass then the culled sweep) against
     the plain sweep, through `rasterize` and alone: B=1 and B=8 at 240^2
     with 4096 faces, the backface-compacted 2560 faces at B=8, the sparse
     and padding-heavy cases of phase 2 and a 232^2 crop (partial edge
     tiles); face-id mismatches, max |dz|, max |dbary|; `zbuffer_sweep`'s
     reach pass equal to `brute_reach_bbox_plain`; the culled sweep's work,
     bytes and bound per case as in phase 2, on the vertex bboxes and on
     the derived boxes, with the mean pixels per box of both and the faces
     given the whole raster; device times of both kernels at B=1, B=8,
     backface B=8 and the sparse pose, the brute-force one also as its
     reach pass and its sweep apart;
  6. the reference-exact parity forward (`apply_parity_preset`, f32) and
     the backface-culled forward at B=8, each through the kernels and
     through the plain sweep: Ti_pred agrees;
  7. parity serving: the parity preset with seeded random weights, 4
     requests at B=1 and 2 at B=8 in the tracking chain of phase 4; poses
     finite and rigid, `zbuffer_sweep_tiled` launched render_iters times
     per request and the rows-attrs kernel never; ms/frame and peak device
     memory; then the refined poses of the B=8 requests rendered through
     `rasterize(use_pallas=True)`, which must launch the brute-force kernel
     once per request and agree with the culled render;
  8. the kernels at other pixel tiles and on the per-(b, tile) grid against
     their plain versions: `zbuffer_sweep_tiled_attrs_batched` at tiles 16,
     24 and 40 (B=1, B=8) and at 16 on the sparse and padding-heavy cases,
     `zbuffer_sweep_tiled_attrs` (one mesh) at 16, 24 and 40 on 240^2 and at
     32 on a 256^2 crop, `zbuffer_sweep_rows_attrs` and
     `zbuffer_sweep_tiled` at 24 and 40 (B=8); device times at B=1 and B=8;
  9. the per-class entry point at full width (bench.py's KPConv towers:
     4 layers, 128 wide, 2048-point level 0): `encode_3d` ms at B=1 and B=8
     (unit-norm descriptors on real points, zero on padding); the f32
     uncached forward at B=8 through the kernels and through the plain
     sweeps (Ti_pred agrees); serving through `InferenceEngine` on the
     per-(b, tile) grid (`_GRID_PREF = "tile"`), 4 requests at B=1 and 2 at
     B=8, one class name per batch size: `encode_3d` once per class,
     `zbuffer_sweep_tiled_attrs_batched` launched render_iters times per
     request and the rows-attrs kernel never, poses finite and rigid;
     ms/request, ms/frame, peak memory; one B=8 request again at
     `_TILE_PREF = 40`, which must agree with it at tile 16;
 10. the refined poses of the B=1 engine requests rendered one mesh at a
     time through `zbuffer_sweep_tiled_attrs` at tile 40: one launch per
     request, equal to the batched render;
 11. training at full width (phase 4's operating point, phase 9's towers,
     the scene's 256-row correspondence set): `Trainer` with the default
     `OptimizerConfig`, one warm-up and 5 timed steps at B=1 and at B=8;
     per step the loss, grad_norm, ms/step (synchronised) and peak device
     memory; the loss and the parameters finite and the rows-attrs kernel
     launched render_iters times per step; one f32 step at B=2 through the
     kernel (render_iters launches) and through the plain raster (none)
     under `torch.use_deterministic_algorithms(True)`: loss, every gradient
     and every updated parameter identical; the B=8 trainer saved as a
     checkpoint and restored into a fresh one, bitwise; after the timed
     steps of each batch size, one more warm step under torch.profiler:
     device busy against wall time, device ops and kernel-launch calls per
     step, the host split into forward, backward and update, and the ops
     that own the most device time (see `_profile_train_step`);
 12. the LINEMOD evaluation entry point at full width: the port's
     `make_synthetic_linemod` writes a LINEMOD-format dataset (640x480
     frames, the LINEMOD camera, one icosphere simplified at load to the
     2048-vertex / 4096-face budget, 16 eval frames with a PoseCNN-layout
     init-pose pickle, a JSON config) through the rows-attrs kernel (its wall
     time and launches); then `tools/eval.main` over it with seeded random
     weights saved as a port checkpoint, the defaults' crop 320, zoom 240
     and 3 x 4 iterations, four runs: `--eval_batch 1`, `--eval_batch 8`,
     `--parity --eval_batch 8` and `--icp --eval_batch 1`. Each checks
     `encode_3d` once per run (one class), the rows-attrs kernel launched
     render_iters times per forward and `zbuffer_sweep_tiled` never (the
     reverse under `--parity`), every dumped pose (16 rows) finite and
     rigid, and every metric key of the JAX evaluator in the summary; it
     prints fps, forward ms, host ms per frame for reading and cropping and
     for collation, and peak device memory. The parity run once more with
     `--plain_raster` (f32, the plain sweeps, no launch): the dumped poses
     agree with the kernel run's within 1e-3. The ADD values of random
     weights are printed, not judged;
 13. training on LINEMOD-format data: the writer puts a 640x480 dataset
     (32 train and 16 eval frames) on disk, every other train frame is
     marked `is_syn` in its info pickle, and a VOC tree is laid out from
     the committed JPEG fixtures (`rnnpose_tpu_torch/testdata/jpeg/`); then
     `tools/train.main` at the defaults' operating point (crop 320, zoom
     240, 2048/4096 budget, 4-layer 128-wide towers, 3 x 4 iterations, the
     default precision) with seeded random weights, three ways: B=1 for 6
     steps (a checkpoint every 3) with 4 loader threads and the periodic
     eval (`--eval_frames 8 --eval_batch 8`), under
     `torch.use_deterministic_algorithms(True)`; B=1 again, synchronous and
     without eval, stopped after step 3 and resumed to step 6 (the same
     mode): its final checkpoint (model and optimizer) equal to the first
     run's, max |delta| 0; then, without deterministic algorithms, B=1 for
     6 steps with 4 loader threads, and B=8 for 4 steps with 4 loader
     threads and synchronously. Each run checks every step applied and
     finite, the rows-attrs kernel launched render_iters times per step and
     per eval forward and no other kernel, every `eval/*` key present and
     finite; it prints ms per step (median, the first step apart), the
     loop's wait on the loader per step, the gap between steps, the wall ms
     per sample in the loader threads split into PNG decode, VOC paste
     (JPEG decode, resize, blend), crop and correspondences (the dataset's
     methods wrapped here, not in the CLI), launches and peak device
     memory. Then the same split for 32 samples read on one thread, the
     decode time of the 500x375 JPEG fixture and
     `tools/bench_host_pipeline`'s samples/s at 1, 2, 4 and 8 threads;
 14. adversarial faces for `zbuffer_sweep`, at 240^2 and 232^2, B=8,
     F=4096: the phase-5 B=8 rows with an eighth of each item replaced by
     `adversarial_faces` (slivers, vertices at 1e5 px, edges through pixel
     centres, huge, infinite and NaN coefficients, invalid rows, depth ties
     across chunks, depth at MIN_DEPTH, zero and negated edges): face ids
     equal to the plain brute-force sweep and z within TOL_Z, the reach pass
     equal to the plain one, every covered pixel inside its winner's box;
 15. serving export at full width (`utils/export`, `utils/bundle`,
     `tools/export_model`, `tools/serve_bundle.py`): phase 4's model,
     scenes and cached features exported with `torch.export` at B=1 and at
     B=8, each saved as a bundle and loaded back in this process while no
     other process of this script runs (export, save and load seconds,
     bytes, operator nodes: render_iters rows-attrs nodes); Ti_pred of each
     loaded artifact against the eager forward on the same inputs
     (TOL_POSE). Then phase 4's tracking chain through each loaded
     artifact and eagerly, in turns on the same jitters (8 requests at B=1,
     4 at B=8): ms/request of both beside phase 4's, rows-attrs launched
     render_iters times per artifact request, poses finite, rigid and equal
     to the eager chain's within TOL_POSE. Then three processes at once:
     a standalone consumer, `tools/serve_bundle.py`, on the B=1 bundle's
     example (`utils/export.save_example`: computed under deterministic
     algorithms), with `rnnpose_tpu`, `rnnpose_tpu_torch`, `jax` and `flax`
     blocked and the bundle's own module copies and kernel libraries:
     Ti_pred within its bound (1e-6), render_iters launches counted by its
     own operators, its load time (beside the other two); and
     `tools/export_model` twice, an f32 artifact and a parity-preset one,
     each with `--selftest` (1e-5): render_iters rows-attrs launches through
     the f32 artifact, render_iters `zbuffer_sweep_tiled` launches and no
     rows-attrs one through the parity artifact; the phase's wall time;
 16. `tools/profile_components` at full width, B=1 and B=8: per component
     (the rasterizer, `splat_depth`, the image encoder on both crops, the
     correlation pyramid build and lookup, one LM step, the cached eval
     forward, `encode_3d`, one training step) the host ms of a call, the
     CUDA-event ms per call of back-to-back calls, the device ms per call
     under torch.profiler over calls that fill 10 ms ("not captured" where
     it recorded no device time); the phase's wall time;
 17. `tools/demo` at its defaults: six PNGs written and decoded by the
     port's reader at the expected shapes;
 18. data parallelism on the card (`parallel/`, `--multihost`), at phase
     11's operating point: (a) `dryrun_multichip(2)`: two gloo processes on
     the card, each with 1 item of phase 11's B=2 batch, f32 under
     deterministic algorithms with TF32 off, 3 `Trainer` steps; the first
     step's loss and averaged gradient against one process's full-batch
     ones (rel err 1e-3; cosine > 0.9999, norm ratio 1 +- 1e-3), its loss
     against the mean of one process's two B=1 losses (rel err 1e-6), one
     process's B=2 loss terms against the mean of its B=1 ones (reported),
     the parameters bitwise equal across the ranks after the last, each rank's
     launches (render_iters rows-attrs per step, no other kernel), the
     gradient buffer's bytes and the gloo all-reduce's ms on it, and each
     rank's ms/step beside phase 11's B=1 median; (b), inside phase 13,
     phase 13's deterministic uninterrupted B=1 run again as an NCCL world of
     one (`--multihost --num_processes 1 --dist_backend nccl`): its final
     checkpoint equal to that run's (max |delta| 0), launches as there; (c),
     inside phase 13, the training CLI on phase 13's data in two gloo
     processes on the card (per-rank B=1, 4 steps, one periodic eval of 8
     frames, 4 per rank): both exit 0, rank 0 alone writes one set of files,
     the losses are finite, each rank's model digest at the checkpoint is
     the other's, the gathered eval summary counts the 8 frames, each rank
     launches render_iters rows-attrs per step and per eval forward; ms/step
     per rank.
 19. the jax-free card tests: `pytest --noconftest tests/test_torch_port_cuda.py`
     in a subprocess (the kernel-vs-plain tests of the raster files at their
     scenes and bounds); all 8 must pass, none skip;
 20. `tools/numerics_check --full`: each pose-critical op, the raster, the
     fused raster and the f32 forward (2 x 2, 64^2 crop) on the card and on
     the CPU on the same inputs, max |cuda - cpu| beside the JAX tool's
     tolerance (5e-6 per pose op, 5e-3 on `Ti_pred`); any FAIL exits;
 21. `tools/ablate_inner_step --batch 8` (240^2, bf16): host, CUDA-event and
     device ms of each inner-step sub-op; then `--scan 8`, per iteration;
 22. `tools/parse_trace` over phase 16's `profile_components --trace` at
     B=8 and phase 15's traces of one eager request and one request through
     the loaded artifact at B=1 and B=8: launches, device ms, host ops, the
     traced span, and the top 10 families and host ops of each;
 23. `tools/overfit_check --eval_mode heldout --steps 160` at its defaults
     (160 px, 120 crop, 512/1024 mesh): ADD(init), ADD(refined), their
     ratio, the first and last 50 losses' means, launches and the wall time;
     it fails unless ratio < 0.7 and the last-50 loss < 0.7x the first-50
     (the JAX package's checks in tests/test_viewpoint_health.py);
 24. `tools/measure_fps` at B=1 and B=8 (bench.py's chained protocol at its
     operating point), then `tools/budget_frontier` over phase 13's dataset
     and its B=1 run's checkpoint, `--grid 3x4,2x2 --max_frames 8`, its fps
     points on chains of 10 frames.
Then one JSON line on the kernels (the rows-attrs kernel's launches are
the training phase's, the other kernels' those of the phase that drives
them; launches per request on the default paths; `launches_export`, the
launches through the loaded artifacts of phase 15: rows-attrs over the
serving chains, `zbuffer_sweep_tiled` through the parity artifact; at B=8,
the one-mesh kernel at B=1: device ms, plain ms, bytes and the bound;
`launches_dp`, rows-attrs launches per rank per step in phase 18a;
`launches_tools`, the launches of phases 20, 23 and 24 by tool), the
card's name and power limit from nvidia-smi, and the final JSON line
{"ok": true, "device": {...}}.

It imports nothing of JAX. Without a CUDA device, or outside the
repository, it exits non-zero and prints no result.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

# The reference operating point: 320^2 image, 2048/4096 mesh, 240^2 crop,
# the model's default widths (REFINER holds no override).
# The KPConv pyramid of bench.py's configuration: 4 layers, first voxel 6 mm.
SCENE = dict(image_size=320, num_verts=2048, num_faces=4096, subdivisions=4,
             kp_layers=4, kp_dl=0.006)
CROP = 240
REFINER = {}
TOWER_WIDTH = 128  # first_feats_dim and gnn_feats_dim of both towers
N_REQ_B1, N_REQ_B8 = 8, 4
N_PAR_B1, N_PAR_B8 = 4, 2
N_ENG_B1, N_ENG_B8 = 4, 2
N_TRAIN_STEPS = 5  # timed training steps per batch size, after one warm-up
TILES = (16, 24, 40)
BIG_TILE = 40                  # the engine's second tile and the one-mesh renders
WIDE_CROP, WIDE_TILE = 256, 32  # a crop for the fourth TPU tile
PALLAS = "rnnpose_tpu/ops/pallas_raster.py"
CSRC = "rnnpose_tpu_torch/csrc"
KERNELS = {  # name -> (source, the TPU kernel's entry line)
    "zbuffer_sweep_rows_attrs": (f"{CSRC}/raster_rows_attrs.cu", f"{PALLAS}:945"),
    "zbuffer_sweep_tiled": (f"{CSRC}/raster_tiled.cu", f"{PALLAS}:222"),
    "zbuffer_sweep": (f"{CSRC}/raster_tiled.cu", f"{PALLAS}:108"),
    "zbuffer_sweep_tiled_attrs_batched": (f"{CSRC}/raster_tiled_attrs.cu", f"{PALLAS}:675"),
    "zbuffer_sweep_tiled_attrs": (f"{CSRC}/raster_tiled_attrs.cu", f"{PALLAS}:446"),
}
TOL_Z, TOL_ATTR, TOL_BARY, TOL_POSE = 1e-5, 1e-4, 1e-5, 1e-3
# Phase 15: the CLI artifacts beside the serving ones.
EXPORT_CLI = {"f32": ["--f32"], "parity": ["--parity"]}
# Phase 16: timed calls per component, at the tool's defaults (full width);
# phase 17: the demo's images at its defaults (160^2 image, 120^2 crop, the
# flow at 1/8).
PROFILE_ITERS = 5
DEMO_SHAPES = {"poses_init-red_refined-green_gt-blue.png": (160, 160, 3),
               "syn_img.png": (120, 120, 3), "image_crop.png": (120, 120, 3),
               "syn_depth.png": (120, 120, 3), "flow.png": (15, 15, 3),
               "similarity_weight.png": (120, 120, 3)}
# Phase 12: the fixture writer's arguments (its defaults: 640x480 frames,
# the LINEMOD camera; the written config: the defaults' 320 crop, 240 zoom,
# 3 x 4 iterations and full-width towers).
EVAL_FRAMES, EVAL_RENDER_BATCH = 16, 8
EVAL_WRITER_ARGS = ["--frames", "0", "--eval_frames", str(EVAL_FRAMES),
                    "--batch", str(EVAL_RENDER_BATCH)]
# Phase 13: the training dataset (the writer's defaults: 640x480 frames,
# the LINEMOD camera), the runs' steps and the host pipeline benchmark.
TRAIN_FRAMES, TRAIN_EVAL_FRAMES = 32, 16
TRAIN_WRITER_ARGS = ["--frames", str(TRAIN_FRAMES), "--eval_frames", str(TRAIN_EVAL_FRAMES),
                     "--batch", "8"]
B1_STEPS, B1_EVERY, B8_STEPS = 6, 3, 4
SPLIT_SAMPLES = 32  # training samples read on one thread for the host split
PERIODIC_EVAL = ["--eval_frames", "8", "--eval_batch", "8"]
BENCH_ARGS = ["--frames", "8", "--samples", "32", "--threads", "1", "2", "4", "8"]
JPEG_FIXTURES = "rnnpose_tpu_torch/testdata/jpeg"
# Phase 18: data-parallel steps per rank in the dry run (the first checked
# against one process), and the two-rank CLI run's steps and periodic eval
# (4 of the 16 eval frames per rank).
DP_STEPS = 3
DP_CLI_STEPS = 4
DP_CLI_EVAL = ["--eval_frames", "8", "--eval_batch", "4"]
DP_TIMEOUT_S = 600
# Phase 19: the jax-free card tests and how many must pass. Phase 23: the
# overfit check's steps. Phase 24: the frontier's grid and the frames per
# timed chain of its fps points (the protocol's 40 in measure_fps alone).
CARD_TESTS, CARD_TESTS_N = "tests/test_torch_port_cuda.py", 8
OVERFIT_STEPS = 160
FRONTIER_GRID, FRONTIER_FPS_FRAMES = "3x4,2x2", 10
# The summary keys of the JAX package's `PoseEvaluator` and eval CLI.
EVAL_KEYS = ("add01", "add005", "add002", "proj5", "cm5deg5", "trans_err", "rot_err_deg",
             "add_dist", "add_dist_raw", "adds_dist_raw", "seq_len", "fps")
# The bound of a kernel, from the published H100 SXM peaks: the HBM3
# memory rate and f32 rate outside the tensor cores; about 20 flops (four
# affine values of two multiplies and two adds, their tests) for each pixel
# whose centre lies in a face's bbox, the work the z-buffer needs.
HBM_BYTES_PER_S, F32_FLOPS_PER_S, FLOPS_PER_PAIR = 3.35e12, 67e12, 20


def _smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def _device():
    import torch

    return torch.device("cuda", 0)


def _time_ms(fn, iters: int, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def _device_ms(fn, iters: int = 40) -> float:
    """Device time of one call of `fn`: CUDA events around replays of a
    CUDA graph that holds `iters` calls, so the host's per-call cost (the
    wrapper's checks, allocations and the launch) is left out."""
    import torch

    fn()
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(5):
        graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / (5 * iters)


def _work(bbox, h, w):
    """The culled sweep's work on these inputs, counted on the card with
    plain torch (`raster_kernels.tile_face_overlap`, the kernel's cull):
    32 x 32 blocks that list any face, of all blocks; listed (block, face)
    pairs; pixel tests (the listed faces' rectangles); and the pixel-in-bbox
    pairs (pixel centres inside a face's exact bbox, the work the z-buffer
    needs)."""
    import torch
    from rnnpose_tpu_torch.ops import raster_kernels as rk

    rect = rk.tile_face_overlap(bbox, h, w)
    listed = rect[..., 0] <= rect[..., 1]
    tests = ((rect[..., 1] - rect[..., 0] + 1) * (rect[..., 3] - rect[..., 2] + 1)).long()
    return dict(blocks=int(listed.any(-1).sum()), of=listed[..., 0].numel(),
                pairs=int(listed.sum()), tests=int((tests * listed).sum()),
                in_bbox=int(_pixels_in(bbox, h, w).double().sum()))


def _pixels_in(box, h, w):
    """Pixel centres of the h x w raster inside each box [x0, y0, x1, y1]
    (..., 4) f32, as f32 counts."""
    import torch

    def span(lo, hi, n):  # pixel centres of [lo, hi] inside [0, n)
        first = torch.clamp(torch.ceil(lo - 0.5), min=0.0)
        last = torch.clamp(torch.floor(hi - 0.5), max=n - 1.0)
        return torch.clamp(last - first + 1.0, min=0.0)

    return span(box[..., 0], box[..., 2], w) * span(box[..., 1], box[..., 3], h)


def _check_reach(label, fd, size):
    """The brute-force kernel's reach pass on the card against
    `brute_reach_bbox_plain` on the same rows: equal bit for bit, else it
    prints the first differing rows and raises. Returns the card's boxes."""
    import torch
    from rnnpose_tpu_torch.ops import raster_kernels as rk

    reach = rk._launch_reach(fd, size, size)
    plain = rk.brute_reach_bbox_plain(fd, size, size)
    torch.cuda.synchronize()
    diff = (reach != plain).any(-1)
    if bool(diff.any()):
        at = torch.nonzero(diff)[:4].tolist()
        rows = [(i, fd[tuple(i)].tolist(), reach[tuple(i)].tolist(), plain[tuple(i)].tolist())
                for i in at]
        raise AssertionError(f"{label}: reach pass differs from the plain one on "
                             f"{int(diff.sum())} faces: {rows}")
    return reach


def _reach_line(reach, bb, size):
    """Mean pixel centres per derived box against the vertex bbox `bb`
    (faces with a non-empty vertex bbox), and the faces given the whole
    raster (-1, -1, size + 1, size + 1) or nothing."""
    import torch
    from rnnpose_tpu_torch.ops import raster_kernels as rk

    real = bb[..., 0] <= bb[..., 2]
    whole = torch.tensor([-1.0, -1.0, size + 1.0, size + 1.0], device=reach.device)
    return (f"pixels per box: derived {float(_pixels_in(reach, size, size)[real].mean()):.3f} "
            f"against the vertex bbox's {float(_pixels_in(bb, size, size)[real].mean()):.3f} "
            f"over {int(real.sum())} faces; whole raster {int((reach == whole).all(-1).sum())}, "
            f"empty {int((reach[..., 0] == rk.FAR).sum())} of {reach.shape[0] * reach.shape[1]}")


def _bound(kname, B, F, h, w, D, in_bbox):
    """Bytes (each input read once, each output written once), the bound in
    ms and what sets it, for one call of kernel `kname`."""
    attrs = kname not in ("zbuffer_sweep", "zbuffer_sweep_tiled")
    per_face = 64 + (0 if kname == "zbuffer_sweep" else 16) + (12 * D if attrs else 0)
    nbytes = B * F * per_face + B * h * w * (8 + (4 * D if attrs else 0))
    ms_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    ms_ops = in_bbox * FLOPS_PER_PAIR / F32_FLOPS_PER_S * 1e3
    return nbytes, max(ms_bytes, ms_ops), "bytes" if ms_bytes >= ms_ops else "operations"


def _work_line(work, nbytes, bound_ms, bound_by, ms=None):
    line = (f"blocks listing a face {work['blocks']}/{work['of']}, (block, face) pairs "
            f"{work['pairs']}, pixel tests {work['tests']}, pixel-in-bbox pairs "
            f"{work['in_bbox']}; bytes {nbytes}, bound {bound_ms * 1e3:.3f} us ({bound_by})")
    if ms is not None:
        line += f", kernel device time {ms * 1e3:.3f} us: {bound_ms / ms:.2%} of the bound"
    return line


def _crop_view(inputs, pose, crop_pose=None, out_size=None):
    """The mesh at `pose` in the camera frame and the intrinsics of the zoom
    crop of `crop_pose` (default: `pose`) of size `out_size` (default:
    CROP), as the refiner renders it."""
    from rnnpose_tpu_torch.geometry import projective as proj
    from rnnpose_tpu_torch.models.refiner import zoom_crop

    h_img, w_img = inputs.image.shape[1:3]
    _, _, K_crop = zoom_crop(pose if crop_pose is None else crop_pose, inputs.mesh,
                             inputs.intrinsics, h_img, w_img, out_size or CROP, 0.4)
    return proj.transform_points(pose, inputs.mesh.verts[None]), K_crop


def _sweep_inputs(mesh, verts_cam, K_crop, keep=None, compact_to=None):
    """face_data and bbox of the sweep, per-pose compacted as `rasterize`
    does when `keep` is given."""
    from rnnpose_tpu_torch.geometry import projective as proj
    from rnnpose_tpu_torch.render.raster import compact_faces, prepare_face_data

    uv, _ = proj.project(verts_cam, K_crop[:, None, :])
    valid = mesh.face_valid if keep is None else mesh.face_valid & keep
    fd, bb = prepare_face_data(uv, verts_cam[..., 2], mesh.faces, valid)
    if compact_to is not None:
        fd, bb, _ = compact_faces(fd, bb, compact_to)
    return fd, bb


def _raster_case(inputs, pose, crop_pose=None, out_size=None):
    """The refiner's fused crop raster inputs: face_data, bbox and the
    corner RGB + camera-normal attributes (D=6)."""
    import torch

    mesh = inputs.mesh
    verts_cam, K_crop = _crop_view(inputs, pose, crop_pose, out_size)
    face_data, bbox = _sweep_inputs(mesh, verts_cam, K_crop)
    B = pose.shape[0]
    normals = torch.einsum("bij,vj->bvi", pose[:, :3, :3], mesh.normals)
    attrs = torch.cat([mesh.colors[None].expand(B, -1, -1), normals], dim=-1)
    return face_data, bbox, attrs[:, mesh.faces].contiguous()


def _batch(inputs, n):
    """The first n items of a batch."""
    from rnnpose_tpu_torch.models.kpconv_net import PointPyramid
    from rnnpose_tpu_torch.models.rnnpose import RNNPoseInputs

    pyr = inputs.pyramid
    return RNNPoseInputs(
        image=inputs.image[:n], intrinsics=inputs.intrinsics[:n],
        T_init=inputs.T_init[:n], T_gt=inputs.T_gt[:n], mesh=inputs.mesh,
        model_points=inputs.model_points[:n], point_valid=inputs.point_valid[:n],
        pyramid=PointPyramid(*([t[:n] for t in ts] for ts in (
            pyr.points, pyr.masks, pyr.neighbors, pyr.pools, pyr.upsamples))),
        corr=None if inputs.corr is None else type(inputs.corr)(*(t[:n] for t in inputs.corr)),
    )


def _compare(label, out_k, out_p, tol_attr=None):
    """Face-id mismatches, max |dz| over pixels both cover and (with
    attributes) max |dattrs| of a kernel's output against its plain
    version's; raises past the tolerances. Returns the larger error."""
    import torch

    torch.cuda.synchronize()
    zk, fk, zp, fp = out_k[0], out_k[1], out_p[0], out_p[1]
    mism = int((fk != fp).sum())
    both = (fk >= 0) & (fp >= 0)
    dz = float((zk - zp).abs()[both].max()) if both.any() else 0.0
    da = float((out_k[2] - out_p[2]).abs().max()) if tol_attr is not None else 0.0
    print(f"{label}: coverage {float((fk >= 0).float().mean()):.4f} face_id mismatches "
          f"{mism} max|dz| {dz:.3e}" + (f" max|dattrs| {da:.3e}" if tol_attr else ""),
          flush=True)
    if mism != 0 or dz > TOL_Z or (tol_attr is not None and da > tol_attr):
        raise AssertionError(f"{label}: kernel disagrees with the plain version")
    return max(dz, da)


def _check_rigid(label, T, B):
    import torch

    if tuple(T.shape) != (T.shape[0], B, 4, 4) or not bool(torch.isfinite(T).all()):
        raise AssertionError(f"{label}: non-finite or misshaped poses")
    R = T[..., :3, :3]
    rtr = (R.transpose(-1, -2) @ R - torch.eye(3, device=T.device)).abs().max()
    bottom = (T[..., 3, :] - torch.tensor([0.0, 0.0, 0.0, 1.0], device=T.device)).abs().max()
    if float(rtr) > 1e-3 or float(bottom) > 1e-5:
        raise AssertionError(f"{label}: poses are not rigid ({float(rtr):.2e})")


def _tri_rows(P, Z):
    """Sweep rows (N, 16) f32 of triangles with vertices P (N, 3, 2) and
    corner depths Z (N, 3), as `render/raster.prepare_face_data` lays them
    out (area-normalised edges, depth as an affine function), computed in
    f64 and rounded once."""
    import numpy as np

    (x0, y0), (x1, y1), (x2, y2) = (P[:, k].T for k in range(3))
    a = np.stack([y1 - y2, y2 - y0, y0 - y1], -1)
    b = np.stack([x2 - x1, x0 - x2, x1 - x0], -1)
    c = np.stack([x1 * y2 - x2 * y1, x2 * y0 - x0 * y2, x0 * y1 - x1 * y0], -1)
    area = (a[:, 0] * x0 + b[:, 0] * y0 + c[:, 0])[:, None]
    a, b, c = a / area, b / area, c / area
    rows = np.zeros((len(P), 16))
    rows[:, 0:9:3], rows[:, 1:9:3], rows[:, 2:9:3] = a, b, c
    rows[:, 9:12] = np.stack([(a * Z).sum(-1), (b * Z).sum(-1), (c * Z).sum(-1)], -1)
    rows[:, 12] = 1.0
    return rows.astype(np.float32)


BEHIND = (2.0, 3.0)  # depths of the adversarial kinds that cover much of the raster


def adversarial_faces(base, h, w, seed=0, kinds=tuple(range(11))):
    """`base` (B, F, 16) f32 sweep rows with an eighth of each batch item's
    rows (a seeded choice, spread over all chunks) replaced by faces the
    brute-force kernel's reach pass must get right, in 11 kinds (triangles
    1-32 px across, corners within 0.02 of the face's depth, unless said):
    slivers of one depth (near-collinear vertices, 1e-6 to 1e-1 px off the
    line); vertices at +-1e5 px, of one depth; half-integer vertices (edges
    through pixel centres, e = 0 in f32); edges scaled by 1e20-1e37
    (products overflow f32 past ~1e36); an infinite coefficient; a NaN
    coefficient with valid 1; valid 0, -1 or NaN with ordinary
    coefficients; exact copies of base rows from other chunks (depth ties);
    depth exactly at, or one step above, MIN_DEPTH; zero edges (e = 1, 0, 0
    everywhere, no determinant); negated edges. The kinds that can cover
    much of the raster (far vertices, huge or infinite coefficients, zero
    edges) lie at depths 2-3, behind a mesh at the scenes' 0.6, so that the
    base rows still win pixels.
    `kinds` picks among them (0-10 in that order), cycled over the
    replaced rows. Deterministic in `seed`; on `base`'s device."""
    import numpy as np
    import torch

    B, F = base.shape[:2]
    rs = np.random.RandomState(seed)
    out = base.detach().cpu().numpy().copy()
    n = min(F, max(F // 8, len(kinds)))
    span = np.array([w, h], np.float64)

    def tris(k):  # 1 to 32 px across, anywhere on the raster
        centre = rs.uniform(-8.0, 8.0, (k, 1, 2)) + rs.uniform(0.0, 1.0, (k, 1, 2)) * span
        return centre + rs.uniform(-1.0, 1.0, (k, 3, 2)) * 2.0 ** rs.uniform(0, 5, (k, 1, 1))

    def depths(k, tilt=0.02, lo=0.2, hi=1.5):  # corners within +-tilt of the face's depth
        return rs.uniform(lo, hi, (k, 1)) + rs.uniform(-tilt, tilt, (k, 3))

    for bi in range(B):
        idx = rs.choice(F, n, replace=False)
        kind = np.asarray(kinds)[np.arange(n) % len(kinds)]
        rows = _tri_rows(tris(n), depths(n))
        for k in kinds:
            sel = np.nonzero(kind == k)[0]
            m = len(sel)
            if k == 0:    # slivers
                p0, p1 = (rs.uniform(-8.0, 8.0, (m, 2)) + rs.uniform(0, 1, (m, 2)) * span
                          for _ in range(2))
                d = p1 - p0
                nrm = np.stack([-d[:, 1], d[:, 0]], -1) / np.linalg.norm(d, axis=1)[:, None]
                p2 = (p0 + rs.uniform(0, 1, (m, 1)) * d
                      + nrm * 10.0 ** rs.uniform(-6, -1, (m, 1)) * rs.choice([-1, 1], (m, 1)))
                rows[sel] = _tri_rows(np.stack([p0, p1, p2], 1), depths(m, 0.0))
            elif k == 1:  # vertices at +-1e5 px
                P = rs.uniform(0, 1, (m, 3, 2)) * span
                far = rs.rand(m, 3) < 0.7
                P[far] += rs.choice([-1e5, 1e5], (int(far.sum()), 2))
                rows[sel] = _tri_rows(P, depths(m, 0.0, *BEHIND))
            elif k == 2:  # half-integer vertices, some with power-of-two legs
                p0 = rs.randint(0, min(h, w), (m, 2)) + 0.5
                legs = 2.0 ** rs.randint(1, 6, (m, 2)) * rs.choice([-1, 1], (m, 2))
                P = np.stack([p0, p0 + [1, 0] * legs, p0 + [0, 1] * legs], 1)
                odd = rs.rand(m) < 0.5
                P[odd] = rs.randint(0, min(h, w), (int(odd.sum()), 3, 2)) + 0.5
                rows[sel] = _tri_rows(P, depths(m))
            elif k == 3:  # huge edge coefficients (some overflow to inf)
                rows[sel] = _tri_rows(tris(m), depths(m, 0.02, *BEHIND))
                with np.errstate(over="ignore"):
                    rows[sel, :9] *= (10.0 ** rs.uniform(20, 37, (m, 1))).astype(np.float32)
            elif k == 4:  # an infinite coefficient
                rows[sel] = _tri_rows(tris(m), depths(m, 0.02, *BEHIND))
                rows[sel, rs.randint(0, 9, m)] = rs.choice([-np.inf, np.inf], m)
            elif k == 5:  # a NaN coefficient, valid 1
                rows[sel, rs.randint(0, 12, m)] = np.nan
            elif k == 6:  # not valid, ordinary coefficients
                rows[sel, 12] = rs.choice([0.0, -1.0, np.nan], m)
            elif k == 7:  # exact copies of rows from other chunks: depth ties
                rows[sel] = out[bi, (idx[sel] + 128 * rs.randint(1, 4, m)) % F]
            elif k == 8:  # depth at MIN_DEPTH, or the next f32 above it
                at = np.float32(0.01)
                rows[sel, 9:11] = 0.0
                rows[sel, 11] = np.where(rs.rand(m) < 0.5, at, np.nextafter(at, np.float32(1)))
            elif k == 9:  # zero edges: e = 1, 0, 0 everywhere
                rows[sel, :9] = 0.0
                rows[sel, 2] = 1.0
                rows[sel, 9:12] = [0.0, 0.0, BEHIND[1]]
            else:         # negated edges
                rows[sel, :9] *= -1.0
        out[bi, idx] = rows
    return torch.from_numpy(out).to(base.device)


def _adversarial_phase(tag, base, size):
    """Phase 14 at one raster size: `adversarial_faces` over the B=8
    phase-5 rows (an eighth of each item's 4096 replaced), through
    `zbuffer_sweep` on the card against the plain brute-force sweep (face
    ids exact, z within TOL_Z), its reach pass against the plain one (equal),
    and every covered pixel inside its winner's derived box. Returns max|dz|."""
    import torch
    from rnnpose_tpu_torch.ops import raster_kernels as rk

    fd = adversarial_faces(base, size, size, seed=size)
    label = f"{tag} phase 14 adversarial B={fd.shape[0]} F={fd.shape[1]} {size}^2"
    out = rk.zbuffer_sweep(fd, size, size, 128)
    err = _compare(label, out, rk.zbuffer_sweep_tiled_plain(fd, None, size, size, 128))
    fid = out[1]
    reach = _check_reach(label, fd, size)
    hit = fid >= 0
    b, y, x = torch.nonzero(hit, as_tuple=True)
    box = reach[b, fid[hit].long()]
    xc, yc = x.float() + 0.5, y.float() + 0.5
    outside = int(((xc < box[:, 0]) | (xc > box[:, 2]) | (yc < box[:, 1])
                   | (yc > box[:, 3])).sum())
    whole = torch.tensor([-1.0, -1.0, size + 1.0, size + 1.0], device=fd.device)
    print(f"{label}: reach equal to the plain pass; covered pixels outside their winner's "
          f"box {outside} of {int(hit.sum())}; faces given the whole raster "
          f"{int((reach == whole).all(-1).sum())}, an empty box "
          f"{int((reach[..., 0] == rk.FAR).sum())}, winners among the replaced rows "
          f"{int((fd[b, fid[hit].long()] != base[b, fid[hit].long()]).any(-1).sum())}",
          flush=True)
    if outside:
        raise AssertionError(f"{label}: covered pixels outside the derived box")
    return err


def _profile_train_step(trainer, scene, label, step_ms):
    """One warm training step under torch.profiler. Prints, on one line:
    the wall time of the profiled step (host clock, synchronised); device
    busy (`utils/profiling.device_busy`: the sum of the device operations'
    own times, user-annotation spans left out); the idle share against
    that wall and against `step_ms`, the median unprofiled step; the device operations and the kernel-launch
    API calls; the host time of the step's `train_step/forward`,
    `/backward` and `/update` ranges. Then the host ops that own the most
    device time (user-annotation spans left out: a range's span on the
    device covers the gaps between its kernels)."""
    import torch
    from rnnpose_tpu_torch.utils.profiling import annotation_names, device_busy
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.run_step(scene)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    events = prof.events()
    ranges = annotation_names(prof) | {e.name for e in events
                                       if e.name.startswith("train_step/")}
    busy, ops = device_busy(prof)
    api = sum(e.name.startswith(("cudaLaunchKernel", "cuLaunchKernel")) for e in events)
    host = {e.name.split("/")[1]: e.cpu_time_total / 1e3 for e in events
            if e.name.startswith("train_step/") and e.device_type == DeviceType.CPU}
    print(f"{label}: profiled wall {wall:.3f} ms; device busy {busy:.3f} ms; idle share "
          f"{1 - busy / wall:.4f} of the profiled step, {1 - busy / step_ms:.4f} of the "
          f"unprofiled median {step_ms:.3f} ms; device ops {ops}, kernel-launch API calls "
          f"{api}; host ms forward {host.get('forward', 0.0):.3f}, backward "
          f"{host.get('backward', 0.0):.3f}, update {host.get('update', 0.0):.3f}", flush=True)
    host_ops = sorted((e for e in prof.key_averages() if e.device_type == DeviceType.CPU
                       and e.key not in ranges),
                      key=lambda e: e.self_device_time_total, reverse=True)
    print(f"{label} top ops by device time: " + "; ".join(
        f"{e.key} {e.self_device_time_total / 1e3:.3f} ms x{e.count}" for e in host_ops[:12]),
        flush=True)


def _eval_entry_point(tag, dev, reset_counts, counts, build):
    """Phase 12 (see the module docstring). `counts(**expect)` returns the
    launch counts and whether they are as expected."""
    import numpy as np
    import torch
    from rnnpose_tpu_torch.config.defaults import build_model_config, default_config
    from rnnpose_tpu_torch.models.rnnpose import RNNPose, init_random_
    from rnnpose_tpu_torch.tools import eval as eval_cli
    from rnnpose_tpu_torch.tools.make_synthetic_linemod import main as write_linemod
    from rnnpose_tpu_torch.train import checkpoint as ckpt_lib
    from rnnpose_tpu_torch.utils.config_io import merge_cfg

    with tempfile.TemporaryDirectory(dir=build) as root:
        reset_counts()
        t0 = time.perf_counter()
        cfg_path = write_linemod(["--out", os.path.join(root, "lm"), "--device", dev.type]
                                 + EVAL_WRITER_ARGS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        writer_launches, _ = counts()
        renders = -(-EVAL_FRAMES // EVAL_RENDER_BATCH)
        print(f"{tag} phase 12 fixture: {EVAL_FRAMES} eval frames written in {wall:.2f} s; "
              f"kernel launches {writer_launches} (expected rows-attrs {renders})", flush=True)
        if writer_launches["zbuffer_sweep_rows_attrs"] != renders:
            raise AssertionError(f"fixture writer launches {writer_launches}")

        model_cfg = build_model_config(merge_cfg([cfg_path], defaults=default_config()))
        model = init_random_(RNNPose(model_cfg), torch.Generator().manual_seed(12))
        ckpt = ckpt_lib.save_checkpoint(os.path.join(root, "run"), {"model": model.state_dict()},
                                        0)
        R = model_cfg.refiner.render_iters
        encode_calls = []
        encode_3d = RNNPose.encode_3d

        def counted_encode(self, pyramid):
            encode_calls.append(1)
            return encode_3d(self, pyramid)

        def run(label, flags, expect):
            dump = os.path.join(root, label.replace(" ", "_"))
            del encode_calls[:]
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            reset_counts()
            t0 = time.perf_counter()
            overall = eval_cli.main(["--config_path", cfg_path, "--ckpt_path", ckpt,
                                     "--device", dev.type, "--dump_poses", dump] + flags)
            wall = time.perf_counter() - t0
            got, ok = counts(**expect)
            peak = torch.cuda.max_memory_allocated(dev)
            poses = np.load(os.path.join(dump, "cat_pose_preds.npy"))
            print(f"{tag} phase 12 eval {label}: {overall['fps']:.3f} fps, forward "
                  f"{overall['forward_ms']:.3f} ms/frame, host ms/frame reading+cropping "
                  f"{overall['host_read_ms']:.3f} and collation {overall['host_collate_ms']:.3f}, "
                  f"peak device memory {peak / 2**30:.3f} GiB, wall {wall:.2f} s; launches {got} "
                  f"(expected {expect}); encode_3d calls {len(encode_calls)}; ADD(-S) dist "
                  f"{overall['add_dist']:.5f} m, add01 {overall['add01']:.4f}, proj5 "
                  f"{overall['proj5']:.4f} (random weights: printed, not judged)", flush=True)
            missing = [k for k in EVAL_KEYS if k not in overall]
            if not ok or len(encode_calls) != 1 or missing or overall["seq_len"] != EVAL_FRAMES:
                raise AssertionError(f"eval {label}: launches {got}, encode_3d calls "
                                     f"{len(encode_calls)}, missing keys {missing}")
            if poses.shape != (EVAL_FRAMES, 4, 4):
                raise AssertionError(f"eval {label}: dumped poses {poses.shape}")
            _check_rigid(f"eval {label}", torch.from_numpy(poses)[None], EVAL_FRAMES)
            return poses

        RNNPose.encode_3d = counted_encode
        try:
            n1, n8 = EVAL_FRAMES, -(-EVAL_FRAMES // 8)
            run("batch 1", ["--eval_batch", "1"], dict(zbuffer_sweep_rows_attrs=R * n1))
            run("batch 8", ["--eval_batch", "8"], dict(zbuffer_sweep_rows_attrs=R * n8))
            parity = run("parity batch 8", ["--parity", "--eval_batch", "8"],
                         dict(zbuffer_sweep_tiled=R * n8))
            run("icp batch 1", ["--icp", "--eval_batch", "1"],
                dict(zbuffer_sweep_rows_attrs=R * n1))
            plain = run("parity batch 8 plain raster",
                        ["--parity", "--eval_batch", "8", "--plain_raster"], {})
        finally:
            RNNPose.encode_3d = encode_3d
        d_pose = float(np.abs(parity - plain).max())
        print(f"{tag} phase 12 parity batch 8 (f32): max|pose kernel - plain raster| "
              f"{d_pose:.3e} (limit {TOL_POSE})", flush=True)
        if not d_pose <= TOL_POSE:
            raise AssertionError("eval: kernel and plain raster disagree")


def _max_delta(a, b, where="state"):
    """max |a - b| over every tensor of two checkpoints; raises if their
    structure or any non-tensor value differs."""
    import torch

    if isinstance(a, torch.Tensor):
        if a.shape != b.shape or a.dtype != b.dtype:
            raise AssertionError(f"{where}: {a.shape}/{a.dtype} vs {b.shape}/{b.dtype}")
        if a.numel() == 0:
            return 0.0
        return float((a.double() - b.double()).abs().max())
    if isinstance(a, dict):
        if a.keys() != b.keys():
            raise AssertionError(f"{where}: keys differ")
        return max([_max_delta(a[k], b[k], f"{where}.{k}") for k in a], default=0.0)
    if isinstance(a, (list, tuple)):
        if len(a) != len(b):
            raise AssertionError(f"{where}: lengths differ")
        return max([_max_delta(x, y, f"{where}[{i}]") for i, (x, y) in enumerate(zip(a, b))],
                   default=0.0)
    if a != b:
        raise AssertionError(f"{where}: {a!r} vs {b!r}")
    return 0.0


class _HostMeter:
    """Wraps the training data path's host functions while it is on: the
    wall seconds of each part of a training sample in the thread that reads
    it (`time.thread_time` ticks in 10 ms on some hosts), the collation's
    wall time, each step's synchronised wall time, its rows-attrs launches
    and the gap before it, the loop's waits on the `PrefetchLoader`, and the
    launches of each eval forward."""

    PARTS = {  # (module attribute path, part)
        "data.linemod.LinemodSynRealDataset.sample_at": "sample",
        "data.linemod.LinemodSynRealDataset._load_image": "png_rgb",
        "data.linemod.LinemodSynRealDataset._load_depth": "png_depth",
        "data.linemod.LinemodSynRealDataset._paste_voc_background": "voc_paste",
        "data.imageio.read_jpeg": "jpeg",
        "data.preprocess.patch_crop": "crop",
        "data.preprocess.mask_depth_to_points": "corr",
        "data.preprocess.lift_to_model_frame": "corr",
        "data.preprocess.get_correspondences": "corr",
        "data.preprocess.build_correspondence_set": "corr",
    }

    def __init__(self, rows_attrs):
        import threading

        self.rows_attrs = rows_attrs
        self.lock = threading.Lock()
        self.saved = []
        self.reset()

    def reset(self):
        self.cpu = dict.fromkeys(set(self.PARTS.values()), 0.0)
        self.samples = 0
        self.collate_s = 0.0
        self.steps = []          # (ms, launches)
        self.gaps = []           # ms from one step's end to the next one's start
        self.last_end = None
        self.waits = []
        self.eval_launches = []

    def _patch(self, owner, name, wrapper_of):
        orig = getattr(owner, name)
        self.saved.append((owner, name, orig))
        setattr(owner, name, wrapper_of(orig))

    def __enter__(self):
        import functools
        import importlib
        import threading

        import torch
        from rnnpose_tpu_torch.data import loader as loader_mod
        from rnnpose_tpu_torch.data import linemod as lm_mod
        from rnnpose_tpu_torch.models.engine import InferenceEngine
        from rnnpose_tpu_torch.train.loop import Trainer

        meter = self
        inside = threading.local()  # inside a training sample_at (eval reads frames too)

        def cpu_timer(part):
            def wrap(orig):
                @functools.wraps(orig)
                def timed(*a, **k):
                    outer = part == "sample"
                    if not outer and not getattr(inside, "on", False):
                        return orig(*a, **k)
                    inside.on = True
                    t0 = time.perf_counter()
                    try:
                        return orig(*a, **k)
                    finally:
                        inside.on = not outer
                        with meter.lock:
                            meter.cpu[part] += time.perf_counter() - t0
                            meter.samples += outer
                return timed
            return wrap

        for path, part in self.PARTS.items():
            mod_name, *attrs = path.split(".")
            owner = importlib.import_module(f"rnnpose_tpu_torch.{mod_name}.{attrs[0]}")
            for a in attrs[1:-1]:
                owner = getattr(owner, a)
            self._patch(owner, attrs[-1], cpu_timer(part))

        def collate_wrap(orig):
            @functools.wraps(orig)
            def timed(*a, **k):
                t0 = time.perf_counter()
                try:
                    return orig(*a, **k)
                finally:
                    with meter.lock:
                        meter.collate_s += time.perf_counter() - t0
            return timed
        self._patch(lm_mod, "collate_samples", collate_wrap)

        def step_wrap(orig):
            def run_step(trainer, batch):
                n0 = meter.rows_attrs.launches
                t0 = time.perf_counter()
                if meter.last_end is not None:
                    meter.gaps.append((t0 - meter.last_end) * 1e3)
                out = orig(trainer, batch)
                torch.cuda.synchronize()
                meter.last_end = time.perf_counter()
                meter.steps.append(((meter.last_end - t0) * 1e3,
                                    meter.rows_attrs.launches - n0))
                return out
            return run_step
        self._patch(Trainer, "run_step", step_wrap)

        def iter_wrap(orig):
            def it(loader):
                inner = orig(loader)
                while True:
                    t0 = time.perf_counter()
                    try:
                        batch = next(inner)
                    except StopIteration:
                        return
                    meter.waits.append(time.perf_counter() - t0)
                    yield batch
            return it
        self._patch(loader_mod.PrefetchLoader, "__iter__", iter_wrap)

        def refine_wrap(orig):
            def refine(engine, cls, inputs):
                n0 = meter.rows_attrs.launches
                out = orig(engine, cls, inputs)
                meter.eval_launches.append(meter.rows_attrs.launches - n0)
                return out
            return refine
        self._patch(InferenceEngine, "refine", refine_wrap)
        return self

    def __exit__(self, *exc):
        for owner, name, orig in reversed(self.saved):
            setattr(owner, name, orig)
        self.saved.clear()
        return False


def _parts(per):
    """The per-sample split of `_HostMeter` (ms) as text."""
    rest = per["sample"] - sum(v for k, v in per.items() if k not in ("sample", "jpeg"))
    return (f"total {per['sample']:.3f}: PNG decode {per['png_rgb'] + per['png_depth']:.3f} "
            f"(rgb {per['png_rgb']:.3f}, depth {per['png_depth']:.3f}), VOC paste "
            f"{per['voc_paste']:.3f} (JPEG decode {per['jpeg']:.3f}), crop {per['crop']:.3f}, "
            f"correspondences {per['corr']:.3f}, the rest {rest:.3f} (augmentation, poses"
            f"{', the class assets on first use' if rest > 0.5 * per['sample'] else ''})")


def _train_entry_point(tag, dev, reset_counts, counts, root):
    """Phase 13 (see the module docstring). Returns the rows-attrs launches
    of the B=1 run. It writes under `root`, a directory the caller removes:
    `root/b1.json` (the B=1 config) and `root/b1` (that run's checkpoints)
    are phase 24's fixture and checkpoint."""
    import pickle
    import shutil

    import torch
    from rnnpose_tpu_torch.config.defaults import (
        build_dataset, build_model_config, default_config)
    from rnnpose_tpu_torch.cpp import jpeg
    from rnnpose_tpu_torch.data.preprocess import TooFewCorrespondences
    from rnnpose_tpu_torch.ops import raster_kernels as rk
    from rnnpose_tpu_torch.tools import bench_host_pipeline
    from rnnpose_tpu_torch.tools import train as train_cli
    from rnnpose_tpu_torch.tools.make_synthetic_linemod import main as write_linemod
    from rnnpose_tpu_torch.train import checkpoint as ckpt_lib
    from rnnpose_tpu_torch.utils.config_io import merge_cfg

    repo = Path(__file__).resolve().parent
    fixtures = sorted((repo / JPEG_FIXTURES).glob("*.jpg"))
    if not fixtures:
        raise RuntimeError(f"no JPEG fixtures under {JPEG_FIXTURES}")
    reset_counts()
    t0 = time.perf_counter()
    cfg_path = write_linemod(["--out", os.path.join(root, "lm"), "--device", dev.type]
                             + TRAIN_WRITER_ARGS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    writer_launches, _ = counts()
    renders = -(-(TRAIN_FRAMES + TRAIN_EVAL_FRAMES) // 8)
    info = os.path.join(root, "lm", "cat_train.info")
    with open(info, "rb") as f:
        frames = pickle.load(f)
    for i, fr in enumerate(frames["cat"]):
        fr["is_syn"] = i % 2 == 0
    with open(info, "wb") as f:
        pickle.dump(frames, f)
    voc = os.path.join(root, "voc")
    jpgs = os.path.join(voc, "VOCdevkit/VOC2012/JPEGImages")
    os.makedirs(jpgs)
    os.makedirs(os.path.join(voc, "VOCdevkit/VOC2012/ImageSets/Main"))
    for p in fixtures:
        shutil.copy(p, os.path.join(jpgs, p.name))
    with open(os.path.join(voc, "VOCdevkit/VOC2012/ImageSets/Main/"
                                "diningtable_trainval.txt"), "w") as f:
        f.write("".join(f"{p.stem} 1\n" for p in fixtures))
    print(f"{tag} phase 13 fixture: {TRAIN_FRAMES} train ({TRAIN_FRAMES // 2} is_syn) and "
          f"{TRAIN_EVAL_FRAMES} eval frames written in {wall:.2f} s, kernel launches "
          f"{writer_launches} (expected rows-attrs {renders}); VOC tree of "
          f"{len(fixtures)} JPEG fixtures", flush=True)
    if writer_launches["zbuffer_sweep_rows_attrs"] != renders:
        raise AssertionError(f"fixture writer launches {writer_launches}")

    with open(cfg_path) as f:
        base = json.load(f)
    base["train_input_reader"]["dataset"]["kwargs"]["voc_root"] = voc

    def config(name, steps, every, batch):
        cfg = json.loads(json.dumps(base))
        cfg["train_config"] = {"steps": steps, "steps_per_eval": every}
        cfg["train_input_reader"]["batch_size"] = batch
        path = os.path.join(root, f"{name}.json")
        with open(path, "w") as f:
            json.dump(cfg, f)
        return path

    cfg1 = config("b1", B1_STEPS, B1_EVERY, 1)
    render_iters = build_model_config(merge_cfg(
        [cfg1], defaults=default_config())).refiner.render_iters
    meter = _HostMeter(rk.zbuffer_sweep_rows_attrs)

    def run(label, cfg, flags, n_steps, n_evals, run_dir, phase="13"):
        model_dir = os.path.join(root, run_dir)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        meter.reset()
        reset_counts()
        t0 = time.perf_counter()
        train_cli.main(["--config_path", cfg, "--model_dir", model_dir, "--device",
                        dev.type, "--display_step", "1", "--seed", "13"] + flags)
        wall = time.perf_counter() - t0
        expect = render_iters * (len(meter.steps) + len(meter.eval_launches))
        got, ok = counts(zbuffer_sweep_rows_attrs=expect)
        peak = torch.cuda.max_memory_allocated(dev)
        with open(os.path.join(model_dir, "log.json.lst")) as f:
            rows = [json.loads(line) for line in f]
        steps = [r for r in rows if "loss" in r]
        evals = [r for r in rows if "eval/params_l1" in r]
        ms = [m for m, _ in meter.steps]
        med = sorted(ms[1:])[len(ms[1:]) // 2] if len(ms) > 1 else float("nan")
        per = {k: 1e3 * v / max(meter.samples, 1) for k, v in meter.cpu.items()}
        wait = (1e3 * sum(meter.waits[1:]) / (len(meter.waits) - 1)
                if len(meter.waits) > 1 else float("nan"))
        gap = sorted(meter.gaps)[len(meter.gaps) // 2] if meter.gaps else float("nan")
        skipped = sum(r["skipped_nonfinite"] for r in steps)
        print(f"{tag} phase {phase} train {label}: {len(meter.steps)} steps, ms/step "
              f"{', '.join(f'{m:.3f}' for m in ms)} (median after the first {med:.3f}); "
              f"loader wait ms/step {wait:.3f} (threaded runs; after the first); median "
              f"gap between steps {gap:.3f} ms; wall ms/sample where read (the loader threads, "
              f"or the main thread when synchronous) over "
              f"{meter.samples} samples {_parts(per)}; collation ms/batch "
              f"{1e3 * meter.collate_s / max(len(meter.steps), 1):.3f}; rows-attrs "
              f"launches per step {sorted({n for _, n in meter.steps})}, per eval forward "
              f"{meter.eval_launches}; launches {got} (expected rows-attrs {expect}); peak "
              f"device memory {peak / 2**30:.3f} GiB; skipped_nonfinite {skipped}; wall "
              f"{wall:.2f} s", flush=True)
        bad_eval = []
        for r in evals:
            vals = {k: r.get(f"eval/{k}") for k in EVAL_KEYS + ("forward_ms", "params_l1")}
            print(f"{tag} phase {phase} train {label} eval at step {r['step']}: "
                  + ", ".join(f"{k} {v:.5g}" for k, v in vals.items() if v is not None),
                  flush=True)
            bad_eval += [k for k, v in vals.items()
                         if v is None or not math.isfinite(float(v))]
        if (not ok or len(meter.steps) != n_steps or len(evals) != n_evals
                or len(meter.eval_launches) != n_evals or bad_eval or skipped
                or any(n != render_iters for _, n in meter.steps)
                or any(n != render_iters for n in meter.eval_launches)
                or not all(math.isfinite(r["loss"]) for r in steps)):
            raise AssertionError(
                f"train {label}: steps {len(meter.steps)}/{n_steps}, evals {len(evals)}/"
                f"{n_evals}, launches {got}, eval launches {meter.eval_launches}, bad eval "
                f"keys {bad_eval}, skipped {skipped}")
        return model_dir, got["zbuffer_sweep_rows_attrs"]

    with meter:
        torch.use_deterministic_algorithms(True)
        try:
            dir_a, launches = run("B=1 (deterministic)", cfg1,
                                  ["--loader_threads", "4"] + PERIODIC_EVAL,
                                  B1_STEPS, B1_STEPS // B1_EVERY, "b1")
            sync = ["--loader_threads", "0", "--eval_frames", "0"]
            dir_b, _ = run("B=1 stopped (deterministic)", cfg1,
                           sync + ["--stop_after", str(B1_EVERY)], B1_EVERY, 0, "b1_resumed")
            run("B=1 resumed (deterministic)", cfg1,
                sync + ["--resume"], B1_STEPS - B1_EVERY, 0, "b1_resumed")
        finally:
            torch.use_deterministic_algorithms(False)
        a = ckpt_lib.restore_checkpoint(ckpt_lib.latest_checkpoint(dir_a), map_location="cpu")
        b = ckpt_lib.restore_checkpoint(ckpt_lib.latest_checkpoint(dir_b), map_location="cpu")
        delta = _max_delta(a, b)
        print(f"{tag} phase 13 resume: uninterrupted (4 threads, periodic eval) vs stopped at "
              f"{B1_EVERY} and resumed (synchronous, no eval), steps {a['step']} / "
              f"{b['step']}: max |delta| over the model and optimizer state {delta:.3e} "
              "(limit 0)", flush=True)
        if delta != 0.0 or a["step"] != b["step"] or a["step"] != B1_STEPS:
            raise AssertionError("resumed training differs from the uninterrupted run")
        # The same steps without deterministic algorithms (phase 11's
        # mode), and B=8 with and without the loader threads: the step
        # with and without four threads decoding beside it.
        run("B=1", cfg1, ["--loader_threads", "4", "--eval_frames", "0"], B1_STEPS, 0,
            "b1_fast")
        cfg8 = config("b8", B8_STEPS, B8_STEPS, 8)
        run("B=8", cfg8, ["--loader_threads", "4", "--eval_frames", "0"], B8_STEPS, 0, "b8")
        run("B=8 synchronous", cfg8, ["--loader_threads", "0", "--eval_frames", "0"],
            B8_STEPS, 0, "b8_sync")

        # One thread reads training samples alone (class assets built
        # first): the host ms per sample by part.
        ds = build_dataset(merge_cfg([cfg1], defaults=default_config()),
                           build_model_config(merge_cfg([cfg1], defaults=default_config()))
                           .desc_kp, is_train=True)
        ds.class_assets("cat")
        meter.reset()
        for pos in range(SPLIT_SAMPLES):
            try:
                ds.sample_at(pos % len(ds), pos)
            except TooFewCorrespondences:
                pass
        per = {k: 1e3 * v / max(meter.samples, 1) for k, v in meter.cpu.items()}
        print(f"{tag} phase 13 host ms/sample on one thread over {meter.samples} training "
              f"samples (half is_syn): {_parts(per)}", flush=True)

        # 18b. The same deterministic B=1 run as an NCCL world of one: its
        # final checkpoint equal to the uninterrupted run's above.
        t0 = time.perf_counter()
        torch.use_deterministic_algorithms(True)
        try:
            dir_n, _ = run("B=1 nccl world of one (deterministic)", cfg1,
                           ["--loader_threads", "4"] + PERIODIC_EVAL + [
                               "--multihost", "--coordinator_address",
                               f"127.0.0.1:{_free_port()}", "--num_processes", "1",
                               "--process_id", "0", "--dist_backend", "nccl"],
                           B1_STEPS, B1_STEPS // B1_EVERY, "b1_world1", phase="18b")
        finally:
            torch.use_deterministic_algorithms(False)
        n = ckpt_lib.restore_checkpoint(ckpt_lib.latest_checkpoint(dir_n), map_location="cpu")
        delta = _max_delta(a, n)
        print(f"{tag} phase 18b --multihost as an nccl world of one vs phase "
              f"13's uninterrupted B=1 run (the same arguments), steps {n['step']} / "
              f"{a['step']}: max |delta| over the model and optimizer state {delta:.3e} "
              f"(limit 0); wall {time.perf_counter() - t0:.2f} s", flush=True)
        if delta != 0.0 or n["step"] != a["step"]:
            raise AssertionError("a world of one differs from the run without --multihost")
        _two_rank_cli(tag, dev, root, config("dp", DP_CLI_STEPS, DP_CLI_STEPS, 1),
                      render_iters)

    data = (repo / JPEG_FIXTURES / "voc_500x375.jpg").read_bytes()
    jpeg.decode(data)
    times = []
    for _ in range(20):
        t0 = time.perf_counter()
        img = jpeg.decode(data)
        times.append((time.perf_counter() - t0) * 1e3)
    print(f"{tag} phase 13 JPEG decode of voc_500x375.jpg ({len(data)} bytes -> "
          f"{img.shape}): median {sorted(times)[10]:.3f} ms, best {min(times):.3f} ms (host, "
          "20 calls)", flush=True)
    summary = bench_host_pipeline.main(BENCH_ARGS + ["--device", dev.type])
    print(f"{tag} phase 13 bench_host_pipeline: samples/s by threads {summary['per_threads']}, "
          f"single-thread {summary['single_thread_ms']} ms/sample, margin "
          f"{summary['margin']}x over the {summary['device_budget_samples_per_sec']} samples/s "
          "a B=1 step needs (--device_ms default)", flush=True)
    return launches


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _state_digest(state) -> str:
    """sha256 over a state dict's tensors' bytes, in key order."""
    import hashlib

    import torch

    digest = hashlib.sha256()
    for _, v in sorted(state.items()):
        digest.update(v.detach().cpu().contiguous().reshape(-1).view(torch.uint8).numpy())
    return digest.hexdigest()


# One rank of phase 18c: the training CLI as a user runs it, reporting on
# the last line what the run's log cannot show for a rank other than 0: a
# digest of the model at each checkpoint, ms per step (synchronised), the
# eval forwards and the kernel launches of this process.
DP_WORKER = """
import json, sys, time
import torch
import chip_smoke
from rnnpose_tpu_torch.models.engine import InferenceEngine
from rnnpose_tpu_torch.ops import raster_kernels as rk
from rnnpose_tpu_torch.tools import train as cli
from rnnpose_tpu_torch.train import checkpoint as ckpt
from rnnpose_tpu_torch.train.loop import Trainer
report = {"digests": [], "step_ms": [], "eval_forwards": 0}
save, run_step, refine = ckpt.save_checkpoint, Trainer.run_step, InferenceEngine.refine
def digest_then_save(model_dir, state, step, **kw):
    report["digests"].append(chip_smoke._state_digest(state["model"]))
    return save(model_dir, state, step, **kw)
def timed_step(self, batch):
    sync = torch.cuda.synchronize if batch.image.is_cuda else (lambda: None)
    sync()
    t0 = time.perf_counter()
    out = run_step(self, batch)
    sync()
    report["step_ms"].append((time.perf_counter() - t0) * 1e3)
    return out
def counted_refine(self, *args, **kwargs):
    report["eval_forwards"] += 1
    return refine(self, *args, **kwargs)
ckpt.save_checkpoint = digest_then_save
Trainer.run_step = timed_step
InferenceEngine.refine = counted_refine
cli.main(sys.argv[1:])
report["launches"] = {k: getattr(rk, k).launches for k in chip_smoke.KERNELS}
print(json.dumps(report), flush=True)
"""


def _two_rank_cli(tag, dev, root, cfg, render_iters):
    """Phase 18c (see the module docstring)."""
    from rnnpose_tpu_torch.parallel.mesh import launch_local

    model_dir = os.path.join(root, "dp2")
    device = "cpu" if dev.type == "cpu" else f"cuda:{dev.index or 0}"
    t0 = time.perf_counter()
    outs = launch_local(lambda r, addr: [
        sys.executable, "-c", DP_WORKER, "--config_path", cfg, "--model_dir", model_dir,
        "--device", device, "--display_step", "1", "--seed", "13", "--loader_threads", "2"]
        + DP_CLI_EVAL + ["--multihost", "--coordinator_address", addr, "--num_processes", "2",
                         "--process_id", str(r), "--dist_backend", "gloo"],
        2, root, DP_TIMEOUT_S)
    reports = [_last_json(out, f"rank {r}") for r, out in enumerate(outs)]
    wall = time.perf_counter() - t0
    with open(os.path.join(model_dir, "log.json.lst")) as f:
        rows = [json.loads(line) for line in f]
    steps = [r for r in rows if "loss" in r]
    evals = [r for r in rows if "eval/params_l1" in r]
    files = sorted(os.listdir(model_dir))
    want_files = sorted(["checkpoints.json", "config_resolved.yml", "log.json.lst", "log.txt",
                         f"rnnpose-{DP_CLI_STEPS}", "summary"])
    eval_frames = int(DP_CLI_EVAL[1])
    expect = [render_iters * (DP_CLI_STEPS + rep["eval_forwards"]) for rep in reports]
    for r, rep in enumerate(reports):
        ms = rep["step_ms"]
        print(f"{tag} phase 18c train CLI rank {r} of 2 (gloo, {device}): ms/step "
              f"{', '.join(f'{m:.3f}' for m in ms)} (median after the first "
              f"{sorted(ms[1:])[len(ms[1:]) // 2]:.3f}); eval forwards {rep['eval_forwards']}; "
              f"launches {rep['launches']} (expected rows-attrs {expect[r]})", flush=True)
    summary = {k[5:]: v for k, v in evals[-1].items() if k.startswith("eval/")} if evals else {}
    print(f"{tag} phase 18c: files {files}; losses {[round(r['loss'], 6) for r in steps]}; "
          f"model digests equal across the ranks at each checkpoint: "
          f"{reports[0]['digests'] == reports[1]['digests']}; gathered eval summary seq_len "
          f"{summary.get('seq_len')} of {eval_frames} eval frames; wall {wall:.2f} s", flush=True)
    ok = (files == want_files and len(steps) == DP_CLI_STEPS and len(evals) == 1
          and all(math.isfinite(r["loss"]) and r["skipped_nonfinite"] == 0.0 for r in steps)
          and reports[0]["digests"] and reports[0]["digests"] == reports[1]["digests"]
          and summary.get("seq_len") == eval_frames
          and all(math.isfinite(v) for v in summary.values())
          and all(rep["eval_forwards"] > 0 for rep in reports)
          and all(rep["launches"] == dict(dict.fromkeys(KERNELS, 0),
                                          zbuffer_sweep_rows_attrs=e)
                  for rep, e in zip(reports, expect)))
    if not ok:
        raise AssertionError(f"phase 18c: two-rank training CLI run wrong: {reports}")


def _dryrun_phase(tag, dev, train_cfg, scene2, b1_step_ms):
    """Phase 18a (see the module docstring). Returns the rows-attrs
    launches per rank per step."""
    import torch
    from rnnpose_tpu_torch.models.rnnpose import RNNPose, init_random_
    from rnnpose_tpu_torch.parallel.dryrun import dryrun_multichip

    cfg32 = dataclasses.replace(train_cfg, refiner=dataclasses.replace(
        train_cfg.refiner, mixed_precision=False))
    R = cfg32.refiner.render_iters
    model = init_random_(RNNPose(cfg32), torch.Generator().manual_seed(18))
    device = "cpu" if dev.type == "cpu" else f"cuda:{dev.index or 0}"
    t0 = time.perf_counter()
    res = dryrun_multichip(2, device=device, model=model, inputs=scene2, steps=DP_STEPS,
                           timeout_s=DP_TIMEOUT_S)
    wall = time.perf_counter() - t0
    per_step = [x["zbuffer_sweep_rows_attrs"] / DP_STEPS for x in res["launches"]]
    print(f"{tag} phase 18a dryrun_multichip(2, {device!r}) at B=2 (1 per rank), f32, "
          f"deterministic, TF32 off: loss {res['loss_dp']:.9g} vs one process "
          f"{res['loss_single']:.9g} (rel err {res['loss_rel_err']:.3e}, limit 1e-3), vs "
          f"the mean of one process's two B=1 losses {res['loss_split']:.9g} (rel err "
          f"{res['split_rel_err']:.3e}, limit 1e-6); one process's B=2 loss terms vs the "
          f"mean of its B=1 ones, rel err "
          f"{ {k: float(f'{v:.3e}') for k, v in res['batch_rel_err'].items()} }; "
          f"gradient cosine {res['grad_cosine']:.12f} (> 0.9999), norm ratio "
          f"{res['grad_norm_ratio']:.12f} (1 +- 1e-3), |g| {res['grad_norm']:.6g}; parameters "
          f"bitwise equal across the ranks after {DP_STEPS} steps: {res['params_equal']}",
          flush=True)
    print(f"{tag} phase 18a: {res['num_params']} parameters, gradient buffer "
          f"{res['allreduce_bytes']} bytes; gloo all-reduce ms per rank "
          f"{[[round(m, 3) for m in ms] for ms in res['allreduce_ms']]}; launches per rank "
          f"{res['launches']} (rows-attrs per step {per_step}, expected {R}); ms/step per rank "
          f"{[[round(m, 3) for m in ms] for ms in res['ms_per_step']]} beside phase 11's "
          f"single-process B=1 median {b1_step_ms:.3f} (default precision); wall {wall:.2f} s",
          flush=True)
    if any(x != dict(dict.fromkeys(KERNELS, 0), zbuffer_sweep_rows_attrs=R * DP_STEPS)
           for x in res["launches"]):
        raise AssertionError(f"phase 18a launches {res['launches']}")
    return per_step[0]


def _last_json(text, label):
    """The JSON object on the last line of a subprocess's standard output."""
    lines = [line for line in text.splitlines() if line.startswith("{")]
    if not lines:
        raise AssertionError(f"{label}: no JSON line in its output:\n{text[-4000:]}")
    return json.loads(lines[-1])


def _export_phase(tag, dev, model, scenes, desc3d, ctx3d, eager_ms, reset_counts, counts,
                  build, trace_root):
    """Phase 15 (see the module docstring). `scenes` maps B to (scene,
    requests). Returns the rows-attrs launches counted through the serving
    artifacts and the tiled launches counted through the parity artifact.
    After the chains, one warm eager request and one through the loaded
    artifact at each B run under `utils/profiling.trace`, into
    `trace_root/{eager,artifact}_b<B>` (phase 22 reads them)."""
    import torch
    from rnnpose_tpu_torch.geometry.se3 import se3_expm
    from rnnpose_tpu_torch.utils import export as ex
    from rnnpose_tpu_torch.utils.profiling import trace

    repo = Path(__file__).resolve().parent
    R = model.cfg.refiner.render_iters
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=build) as root:
        # In this process, with no other process of this script running, so
        # the export, save and load times are the start-up cost alone.
        runs = {}
        for B, (scene, _) in scenes.items():
            d3, c3 = desc3d[:B], ctx3d[:B]
            t0 = time.perf_counter()
            exported = ex.export_eval_forward(model, scene, d3, c3)
            t1 = time.perf_counter()
            bundle = os.path.join(root, f"b{B}")
            manifest = ex.save_exported(exported, bundle,
                                        ex.serving_leaf_paths(model, scene, d3, c3),
                                        {"batch": B})
            t2 = time.perf_counter()
            program, _ = ex.load_exported(bundle)
            run = program.module()
            t3 = time.perf_counter()
            leaves = ex.serving_args(model, scene, d3, c3)
            nodes = manifest["operators"]["nodes"]
            print(f"{tag} phase 15 export B={B}: export {t1 - t0:.2f} s, save {t2 - t1:.2f} s, "
                  f"load {t3 - t2:.2f} s; bundle {manifest['bundle_bytes']} bytes (program "
                  f"{manifest['bytes']}, libraries {manifest['operators']['libraries']}); "
                  f"{len(leaves)} leaves; operator nodes {nodes}; raster "
                  f"{manifest['raster']['branch']} (grid {manifest['raster']['grid']}, tile "
                  f"preference {manifest['raster']['tile']})", flush=True)
            if nodes != {"zbuffer_sweep_rows_attrs": R}:
                raise AssertionError(f"export B={B}: operator nodes {nodes}")
            got = run(scene.T_init, *leaves)
            want = model(scene, cached_desc3d=d3, cached_ctx3d=c3)["Ti_pred"]
            d_pose = float((got - want).abs().max())
            print(f"{tag} phase 15 B={B}: max|Ti_pred artifact - eager| {d_pose:.3e} "
                  f"(limit {TOL_POSE})", flush=True)
            if not d_pose <= TOL_POSE:
                raise AssertionError(f"export B={B}: the artifact disagrees with the eager "
                                     "forward")
            if B == 1:
                example = os.path.join(root, "b1_example.pt")
                ex.save_example(example, run, scene.T_init, leaves)
            runs[B] = (run, leaves)

        # The tracking chain of phase 4, eagerly and through the artifacts,
        # in turns (eager, artifact, artifact, eager), on the same jitters.
        gen = torch.Generator().manual_seed(15)
        served = 0
        for B, (scene, n_req) in scenes.items():
            run, leaves = runs[B]
            d3, c3 = desc3d[:B], ctx3d[:B]
            T_ins = [se3_expm(torch.randn(B, 6, generator=gen) * 1e-3).to(scene.T_init.device)
                     @ scene.T_init for _ in range(n_req)]

            def chain(fn):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                outs = [fn(T) for T in T_ins]
                torch.cuda.synchronize()
                return torch.stack(outs), (time.perf_counter() - t0) * 1e3 / n_req

            def eager(T):
                return model(scene._replace(T_init=T), cached_desc3d=d3,
                             cached_ctx3d=c3)["Ti_pred"]

            T_e, ms_e1 = chain(eager)
            reset_counts()
            T_a, ms_a1 = chain(lambda T: run(T, *leaves))
            _, ms_a2 = chain(lambda T: run(T, *leaves))
            got, ok = counts(zbuffer_sweep_rows_attrs=2 * R * n_req)
            _, ms_e2 = chain(eager)
            served += got["zbuffer_sweep_rows_attrs"]
            d_pose = float((T_a - T_e).abs().max())
            print(f"{tag} phase 15 serving through the artifact B={B}: {ms_a1:.3f}, {ms_a2:.3f} "
                  f"ms/request against eager {ms_e1:.3f}, {ms_e2:.3f} in turns (phase 4: "
                  f"{eager_ms[B]:.3f}) over {n_req} requests; launches {got} (expected "
                  f"rows-attrs {2 * R * n_req}); max|Ti_pred artifact - eager| {d_pose:.3e}",
                  flush=True)
            _check_rigid(f"artifact serving B={B}", T_a, B)
            if not ok or not d_pose <= TOL_POSE:
                raise AssertionError(f"artifact serving B={B}: launches {got}, max|d| {d_pose}")
            for label, fn in (("eager", eager), ("artifact", lambda T: run(T, *leaves))):
                torch.cuda.synchronize()
                with trace(os.path.join(trace_root, f"{label}_b{B}")):
                    fn(T_ins[0])
                    torch.cuda.synchronize()

        # The CLI, as a user runs it (an f32 artifact and a parity-preset
        # one, each with its selftest), and the standalone consumer on the
        # B=1 bundle: three processes at once, while this one waits.
        argv = {name: ["-m", "rnnpose_tpu_torch.tools.export_model", "--out",
                       os.path.join(root, name), "--platform", dev.type, "--selftest"] + flags
                for name, flags in EXPORT_CLI.items()}
        argv["consumer"] = ["rnnpose_tpu_torch/tools/serve_bundle.py", os.path.join(root, "b1"),
                            example, "--device", dev.type]
        procs, logs, results = {}, {}, {}
        try:
            for name, args in argv.items():
                logs[name] = open(os.path.join(root, f"{name}.log"), "w+")
                procs[name] = subprocess.Popen([sys.executable] + args, cwd=repo,
                                               stdout=logs[name], stderr=subprocess.STDOUT,
                                               text=True)
            for name, proc in procs.items():
                rc = proc.wait(timeout=900)
                logs[name].seek(0)
                text = logs[name].read()
                if rc != 0:
                    raise AssertionError(f"phase 15 {name} exited {rc}:\n{text[-4000:]}")
                results[name] = _last_json(text, name)
        finally:
            for proc in procs.values():
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
            for log in logs.values():
                log.close()
        con = results["consumer"]
        print(f"{tag} phase 15 standalone consumer (no rnnpose_tpu, rnnpose_tpu_torch, jax or "
              f"flax) on the B=1 bundle: max|Ti_pred - expected| {con['max_abs_diff']:.3e} "
              f"(limit {con['tol']}); its launches {con['launches']}; load {con['load_s']:.2f} "
              f"s, run {con['run_s']:.3f} s, beside the two export_model processes", flush=True)
        if con["launches"]["zbuffer_sweep_rows_attrs"] != R or con["leaked"]:
            raise AssertionError(f"standalone consumer: {con}")
        for name, flags in EXPORT_CLI.items():
            got = results[name]
            want = {"zbuffer_sweep_tiled": R} if "--parity" in flags else {
                "zbuffer_sweep_rows_attrs": R}
            launches = {k: v for k, v in got["artifact_launches"].items() if v}
            print(f"{tag} phase 15 export_model {' '.join(flags)} --selftest: max|artifact - "
                  f"direct| {got['selftest_max_abs_diff']:.3e} (limit 1e-05); operator nodes "
                  f"{got['operator_nodes']}; launches through the reloaded artifact {launches} "
                  f"(expected {want}); bundle {got['bundle_bytes']} bytes", flush=True)
            if launches != want or got["operator_nodes"] != want:
                raise AssertionError(f"export_model {flags}: launches {launches}")
    print(f"{tag} phase 15 wall {time.perf_counter() - t_phase:.2f} s", flush=True)
    return served, results["parity"]["artifact_launches"]["zbuffer_sweep_tiled"]


def _profile_phase(tag, dev, trace_root):
    """Phase 16: `tools/profile_components` at full width, B=1 and B=8; at
    B=8 with `--trace trace_root/components_b8` (phase 22 reads it)."""
    from rnnpose_tpu_torch.tools import profile_components

    t0 = time.perf_counter()
    for B in (1, 8):
        trace_flag = ["--trace", os.path.join(trace_root, "components_b8")] if B == 8 else []
        summary = profile_components.main(["--device", dev.type, "--batch", str(B), "--iters",
                                           str(PROFILE_ITERS)] + trace_flag)
        for name, t in summary["components"].items():
            device = t["device_ms"]
            print(f"{tag} phase 16 B={B} {name}: host {t['host_ms']:.3f} ms, events "
                  f"{t['events_ms']:.3f} ms, device "
                  + ("not captured" if device is None else f"{device:.3f} ms"), flush=True)
            # The host and stream times must be real; the profiler's sum is
            # printed as it was read.
            if not (t["host_ms"] > 0 and t["events_ms"] > 0 and (device is None or device > 0)):
                raise AssertionError(f"profile_components B={B} {name}: {t}")
    print(f"{tag} phase 16 wall {time.perf_counter() - t0:.2f} s", flush=True)


def _demo_phase(tag, dev, build):
    """Phase 17: `tools/demo` at its defaults on the card; the six PNGs
    decoded at the expected shapes."""
    from rnnpose_tpu_torch.data.imageio import read_png
    from rnnpose_tpu_torch.tools import demo

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=build) as out:
        paths = demo.main(["--out_dir", out, "--device", dev.type])
        shapes = {os.path.basename(p): read_png(p).shape for p in paths}
    print(f"{tag} phase 17 demo: {len(paths)} PNGs decoded {shapes} (expected "
          f"{DEMO_SHAPES}); wall {time.perf_counter() - t0:.2f} s", flush=True)
    if shapes != DEMO_SHAPES:
        raise AssertionError(f"demo: {shapes}")


def _card_tests_phase(tag):
    """Phase 19: the jax-free card tests, `tests/test_torch_port_cuda.py`,
    in a pytest subprocess (`--noconftest`: `tests/conftest.py` imports
    jax). Every test must run and pass; none may skip."""
    repo = Path(__file__).resolve().parent
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-m", "pytest", "--noconftest", "-p",
                          "no:cacheprovider", "-q", "-rs", CARD_TESTS], cwd=repo,
                         capture_output=True, text=True, timeout=900)
    last = res.stdout.strip().splitlines()[-1] if res.stdout.strip() else ""
    print(f"{tag} phase 19 pytest {CARD_TESTS}: exit {res.returncode}; {last}; wall "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    if res.returncode != 0 or "skipped" in last or f"{CARD_TESTS_N} passed" not in last:
        raise AssertionError(f"phase 19 card tests:\n{res.stdout[-4000:]}\n{res.stderr[-2000:]}")


def _numerics_phase(tag, reset_counts, counts):
    """Phase 20: `tools/numerics_check --full`, the card against the CPU on
    the same inputs at the JAX tool's tolerances; a FAIL exits the script.
    Returns the kernel launches of the card's side."""
    from rnnpose_tpu_torch.tools import numerics_check

    t0 = time.perf_counter()
    reset_counts()
    summary = numerics_check.main(["--full"])
    launches, _ = counts()
    for op, r in summary["ops"].items():
        print(f"{tag} phase 20 numerics {op}: max|cuda - cpu| {r['max_abs']:.3e} (tol "
              f"{r['tol']:g}) {'OK' if r['ok'] else 'FAIL'}", flush=True)
    print(f"{tag} phase 20 TF32 flags before {summary['tf32_before']}, after "
          f"{summary['tf32_after']}; kernel launches {launches}; wall "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    if summary["failures"] or not launches["zbuffer_sweep_tiled"] or not launches[
            "zbuffer_sweep_rows_attrs"]:
        raise AssertionError(f"phase 20: failures {summary['failures']}, launches {launches}")
    return launches


def _ablate_phase(tag):
    """Phase 21: `tools/ablate_inner_step --batch 8`, then `--scan 8`."""
    from rnnpose_tpu_torch.tools import ablate_inner_step

    t0 = time.perf_counter()
    alone = ablate_inner_step.main(["--batch", "8"])
    for name, t in alone["components"].items():
        device = t["device_ms"]
        print(f"{tag} phase 21 B=8 {name}: host {t['host_ms']:.3f} ms, events "
              f"{t['events_ms']:.3f} ms, device "
              + ("not captured" if device is None else f"{device:.3f} ms"), flush=True)
    scan = ablate_inner_step.main(["--batch", "8", "--scan", "8"])
    print(f"{tag} phase 21 --scan 8 per iteration (CUDA events, chain minus floor, / 8): "
          + ", ".join(f"{k} {v:.4f} ms" for k, v in scan["per_iter_ms"].items())
          + f"; sum of parts {scan['sum_of_parts_ms']:.4f} ms vs composed "
          f"{scan['composed_ms']:.4f} ms; wall {time.perf_counter() - t0:.2f} s", flush=True)
    if not all(t["host_ms"] > 0 and t["events_ms"] > 0 for t in alone["components"].values()):
        raise AssertionError(f"phase 21: {alone['components']}")


def _trace_phase(tag, trace_root):
    """Phase 22: `tools/parse_trace` over the traces of phases 15 and 16:
    launches, device ms, host ops and the top 10 families and host ops of
    each."""
    from rnnpose_tpu_torch.tools import parse_trace

    names = sorted(os.listdir(trace_root))
    for name in names:
        for sub in sorted(Path(trace_root, name).rglob("trace.json")):
            agg = parse_trace.aggregate(str(sub))
            label = str(sub.parent.relative_to(trace_root))
            print(f"{tag} phase 22 trace {label}: device {agg['device_ms']:.3f} ms over "
                  f"{agg['device_events']} device events, kernel-launch API calls "
                  f"{agg['launches']}, host ops {agg['host_ops']}, traced span "
                  f"{agg['span_ms']:.3f} ms; top families: "
                  + "; ".join(f"{k} {v:.3f}" for k, v in agg["per_family"].most_common(10))
                  + "; top host ops: "
                  + "; ".join(f"{k} {v:.3f}" for k, v in agg["per_host_op"].most_common(10)),
                  flush=True)
            if agg["device_events"] == 0 or agg["launches"] == 0:
                raise AssertionError(f"phase 22: trace {label} holds no device work")
    if not {"eager_b1", "artifact_b1", "components_b8"} <= set(names):
        raise AssertionError(f"phase 22: traces {names}")


def _overfit_phase(tag, reset_counts, counts):
    """Phase 23: `tools/overfit_check --eval_mode heldout --steps 160` at its
    defaults; ratio < 0.7 and loss_last50 < 0.7 loss_first50, the JAX
    package's checks (tests/test_viewpoint_health.py). Returns the launches."""
    from rnnpose_tpu_torch.tools import overfit_check

    reset_counts()
    t0 = time.perf_counter()
    init_add, ref_add, losses = overfit_check.main(["--eval_mode", "heldout", "--steps",
                                                    str(OVERFIT_STEPS)])
    wall = time.perf_counter() - t0
    # 3 render iterations per step and per held-out eval frame, each through
    # `rasterize` (the full-res LM's barycentrics); the eval forward also
    # renders the fused colour and 1/8-grid features.
    expect = {"zbuffer_sweep_tiled": 3 * (OVERFIT_STEPS + 8), "zbuffer_sweep_rows_attrs": 3 * 8}
    launches, ok = counts(**expect)
    first, last = sum(losses[:50]) / 50, sum(losses[-50:]) / 50
    ratio = ref_add / init_add
    print(f"{tag} phase 23 overfit_check heldout {OVERFIT_STEPS} steps: ADD init "
          f"{init_add * 1e3:.3f} mm, refined {ref_add * 1e3:.3f} mm, ratio {ratio:.4f} (limit "
          f"0.7); loss first50 {first:.4f}, last50 {last:.4f} ({last / first:.4f} of the first, "
          f"limit 0.7); kernel launches {launches} (expected {expect}); wall {wall:.2f} s",
          flush=True)
    if not (ratio < 0.7 and last < 0.7 * first and ok):
        raise AssertionError(f"phase 23: ratio {ratio}, losses {first} -> {last}, launches "
                             f"{launches}")
    return launches


def _fps_phase(tag, reset_counts, counts, fixture):
    """Phase 24: `tools/measure_fps` at B=1 and B=8 (bench.py's protocol and
    operating point), then `tools/budget_frontier` over phase 13's dataset
    and its B=1 run's checkpoint. Returns the launches."""
    from rnnpose_tpu_torch.tools import budget_frontier
    from rnnpose_tpu_torch.tools.measure_fps import measure_fps
    from rnnpose_tpu_torch.train import checkpoint as ckpt_lib

    t0 = time.perf_counter()
    reset_counts()
    for B in (1, 8):
        fps, gflops, reps = measure_fps(B)
        print(f"{tag} phase 24 measure_fps B={B}: best {fps:.3f} fps ({1e3 * B / fps:.3f} ms per "
              f"request), repeats {', '.join(f'{r:.3f}' for r in reps)} fps, spread "
              f"{100 * (max(reps) - min(reps)) / max(reps):.2f}%; FlopCounterMode GFLOPs per "
              f"frame {gflops:.3f}", flush=True)
    # Per B: one render of the synthetic scene, then render_iters (3) per
    # forward: one warm-up, one counted by FlopCounterMode, 8 of warm-up and
    # 3 chains of 40.
    fps_launches, fps_ok = counts(zbuffer_sweep_rows_attrs=2 * (1 + 3 * (2 + 8 + 3 * 40)))
    cfg_path = os.path.join(fixture, "b1.json")
    ckpt = ckpt_lib.latest_checkpoint(os.path.join(fixture, "b1"))
    rows = budget_frontier.main(["--config_path", cfg_path, "--ckpt_path", ckpt, "--grid",
                                 FRONTIER_GRID, "--max_frames", "8", "--fps_frames",
                                 str(FRONTIER_FPS_FRAMES)])
    # Per grid point R x G: R per forward, over the 8 eval frames and both
    # batch sizes' fps chains, and each batch size's scene render.
    expect = fps_launches["zbuffer_sweep_rows_attrs"] + sum(
        int(p.split("x")[0]) * (8 + 2 * (2 + 8 + 3 * FRONTIER_FPS_FRAMES)) + 2
        for p in FRONTIER_GRID.split(","))
    launches, ok = counts(zbuffer_sweep_rows_attrs=expect)
    for row in rows:
        print(f"{tag} phase 24 frontier {row['render_iters']}x{row['gru_iters']}: " + ", ".join(
            f"{k} {row[k]}" for k in ("add01", "add005", "add_dist", "rot_err_deg", "fps",
                                      "fps_b1", "fps_b8", "fps_b1_runs", "fps_b8_runs",
                                      "flop_counter_gflops_per_frame_b1") if k in row),
            flush=True)
    print(f"{tag} phase 24 kernel launches: measure_fps {fps_launches}, with the frontier "
          f"{launches} (expected rows-attrs {expect}); wall {time.perf_counter() - t0:.2f} s",
          flush=True)
    if (len(rows) != 2 or not all(r["fps_b1"] > 0 and r["fps_b8"] > 0 for r in rows)
            or not (fps_ok and ok)):
        raise AssertionError(f"phase 24: {rows}; launches {fps_launches}, {launches}")
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    # cuBLAS is deterministic under torch.use_deterministic_algorithms (phase
    # 11) only with a fixed workspace, set before its first handle.
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    from rnnpose_tpu_torch.cpp import native
    from rnnpose_tpu_torch.data.synthetic import (
        SyntheticConfig, kpconv_config, make_synthetic_inputs)
    from rnnpose_tpu_torch.models.engine import InferenceEngine
    from rnnpose_tpu_torch.geometry.se3 import se3_expm
    from rnnpose_tpu_torch.models.refiner import RefinerConfig, backface_keep
    from rnnpose_tpu_torch.models.rnnpose import (
        RNNPose, RNNPoseConfig, apply_parity_preset, init_random_)
    from rnnpose_tpu_torch.ops import raster_kernels as rk
    from rnnpose_tpu_torch.render import raster as raster_mod
    from rnnpose_tpu_torch.render.raster import rasterize
    from rnnpose_tpu_torch.train import checkpoint as ckpt_lib
    from rnnpose_tpu_torch.train.loop import Trainer
    from rnnpose_tpu_torch.train.optim import OptimizerConfig

    dev = _device()
    name = torch.cuda.get_device_name(0)
    smi = _smi()
    tag = f"[{name} | {smi}]"
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on {tag}", flush=True)
    wrappers = {k: getattr(rk, k) for k in KERNELS}

    def reset_counts():
        for fn in wrappers.values():
            fn.launches = 0

    def counts(**expect):
        """The launch counts; raises unless each is as given (others 0)."""
        got = {k: fn.launches for k, fn in wrappers.items()}
        want = {k: expect.get(k, 0) for k in wrappers}
        return got, got == want

    # 1. Build the three sources and the native host ops at once.
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(rk.KERNEL_SOURCES) + 1) as pool:
        host = pool.submit(native.build)
        libs = list(pool.map(lambda s: rk.build_raster_kernel(s, verbose=True),
                             rk.KERNEL_SOURCES))
        host.result()
    if not native.available():
        raise RuntimeError("the native pyramid ops did not load")
    print(f"{tag} phase 1 build of {len(libs)} sources and the native host ops: "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

    # Scenes at the reference operating point (320^2 image, 2048/4096 mesh).
    syn = SyntheticConfig(batch_size=8, **SCENE)
    t0 = time.perf_counter()
    # The training correspondence set continues the scene's random stream
    # after everything the eval phases read, so they see the same scene.
    scene8 = make_synthetic_inputs(syn, device=dev, with_corr=True)
    scene1 = _batch(scene8, 1)
    pad_scene = make_synthetic_inputs(
        dataclasses.replace(syn, batch_size=1, subdivisions=2),
        device=dev)
    print(f"{tag} scenes built in {time.perf_counter() - t0:.2f} s; "
          f"mesh faces {int(scene8.mesh.face_valid.sum())}/{syn.num_faces} valid, "
          f"padding-heavy mesh {int(pad_scene.mesh.face_valid.sum())}/{syn.num_faces}; "
          f"KPConv pyramid levels {[int(m[0].sum()) for m in scene8.pyramid.masks]} "
          f"real of {[p.shape[1] for p in scene8.pyramid.points]}", flush=True)

    # 2. The rows-attrs kernel vs its plain version at the serving shapes.
    far = scene1.T_init.clone()
    far[:, 2, 3] *= 6.0  # the object 6x further away, in the near pose's crop
    cases = {
        "b1": _raster_case(scene1, scene1.T_init),
        "b8": _raster_case(scene8, scene8.T_init),
        "sparse_b1": _raster_case(scene1, far, crop_pose=scene1.T_init),
        "padding_heavy_b1": _raster_case(pad_scene, pad_scene.T_init),
    }
    times, bounds = {}, {}
    split_fn = rk._split
    max_err = dict.fromkeys(KERNELS, 0.0)
    for cname, (fd, bb, ca) in cases.items():
        args = (fd, bb, ca, CROP, CROP)
        zk, fk, ak = rk.zbuffer_sweep_rows_attrs(*args, chunk=128)
        zp, fp, ap = rk.zbuffer_sweep_rows_attrs_plain(*args, chunk=128)
        torch.cuda.synchronize()
        mism = int((fk != fp).sum())
        both = (fk >= 0) & (fp >= 0)
        dz = float((zk - zp).abs()[both].max()) if both.any() else 0.0
        da = float((ak - ap).abs().max())
        cover = float((fk >= 0).float().mean())
        print(f"{tag} phase 2 {cname}: B={fd.shape[0]} coverage {cover:.4f} "
              f"face_id mismatches {mism} max|dz| {dz:.3e} max|dattrs| {da:.3e}",
              flush=True)
        if mism != 0 or dz > TOL_Z or da > TOL_ATTR:
            raise AssertionError(f"kernel disagrees with the plain version ({cname})")
        max_err["zbuffer_sweep_rows_attrs"] = max(max_err["zbuffer_sweep_rows_attrs"], dz, da)
        work = _work(bb, CROP, CROP)
        for kname in ("zbuffer_sweep_rows_attrs", "zbuffer_sweep_tiled_attrs_batched",
                      "zbuffer_sweep_tiled_attrs"):
            bounds[(kname, cname)] = _bound(kname, *fd.shape[:2], CROP, CROP, ca.shape[-1],
                                            work["in_bbox"])
        nbytes, bound_ms, bound_by = bounds[("zbuffer_sweep_rows_attrs", cname)]
        ms_k = None
        if cname in ("b1", "b8", "sparse_b1"):
            ms_k = _device_ms(lambda: rk.zbuffer_sweep_rows_attrs(*args, chunk=128))
            ms_c = _time_ms(lambda: rk.zbuffer_sweep_rows_attrs(*args, chunk=128), 50)
            ms_p = _time_ms(lambda: rk.zbuffer_sweep_rows_attrs_plain(*args, chunk=128), 5)
            times[("zbuffer_sweep_rows_attrs", cname)] = (ms_k, ms_p)
            print(f"{tag} phase 2 {cname} time: kernel {ms_k:.4f} ms on the device, "
                  f"{ms_c:.4f} ms a call from the host; plain {ms_p:.4f} ms", flush=True)
            # The same launch at every cluster split, against the wrapper's
            # choice (rk._split), each checked against the plain version.
            pick, by_split = rk._split(fd.shape[0], CROP, CROP, dev), []
            try:
                for split in (1, 2, 4, 8):
                    rk._split = lambda *_, s=split: s
                    _compare(f"{tag} phase 2 {cname} split {split}",
                             rk.zbuffer_sweep_rows_attrs(*args, chunk=128), (zp, fp, ap),
                             TOL_ATTR)
                    ms = _device_ms(lambda: rk.zbuffer_sweep_rows_attrs(*args, chunk=128))
                    by_split.append(f"{split}: {ms:.4f}")
            finally:
                rk._split = split_fn
            print(f"{tag} phase 2 {cname} device ms by cluster split: {', '.join(by_split)} "
                  f"(the wrapper picks {pick})", flush=True)
        print(f"{tag} phase 2 {cname} work: "
              + _work_line(work, nbytes, bound_ms, bound_by, ms_k), flush=True)

    # Cached per-class 3D features: seeded, of the shapes the towers emit.
    gen = torch.Generator().manual_seed(0)
    V = scene8.mesh.verts.shape[0]
    desc3d = torch.randn(8, V, 32, generator=gen)
    desc3d = (desc3d / desc3d.norm(dim=-1, keepdim=True)).to(dev)
    ctx3d = torch.randn(8, V, 256, generator=gen).to(dev)

    def kernel_vs_plain(label, cfg, seed):
        """One forward at B=8 through the kernels and through the plain
        sweeps, same weights: max |d Ti_pred|."""
        m_kernel = init_random_(RNNPose(cfg), torch.Generator().manual_seed(seed)).to(dev)
        m_plain = RNNPose(cfg, plain_raster=True).to(dev)
        m_plain.load_state_dict(m_kernel.state_dict())
        T_k = m_kernel(scene8, cached_desc3d=desc3d, cached_ctx3d=ctx3d)["Ti_pred"]
        T_p = m_plain(scene8, cached_desc3d=desc3d, cached_ctx3d=ctx3d)["Ti_pred"]
        d_pose = float((T_k - T_p).abs().max())
        print(f"{tag} {label} B=8: max|Ti_pred kernel - plain| {d_pose:.3e} "
              f"(limit {TOL_POSE}); max|Ti_pred - T_init| "
              f"{float((T_k - scene8.T_init).abs().max()):.3e}", flush=True)
        if not d_pose <= TOL_POSE:
            raise AssertionError(f"{label}: kernel and plain raster disagree")

    # 3. Whole serving forward in f32: kernel raster vs plain raster.
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    cfg32 = RNNPoseConfig(refiner=RefinerConfig(mixed_precision=False, **REFINER))
    kernel_vs_plain("phase 3 f32 slice", cfg32, 1)
    torch.backends.cudnn.deterministic = False

    # 4. Serving with the default (bf16) config.
    cfg = RNNPoseConfig(refiner=RefinerConfig(**REFINER))
    model = init_random_(RNNPose(cfg), torch.Generator().manual_seed(2)).to(dev)
    jit_gen = torch.Generator().manual_seed(3)

    def serve(model, scene, n_req):
        B = scene.image.shape[0]
        d3, c3 = desc3d[:B], ctx3d[:B]
        T_base = scene.T_init
        # Every request starts from the base pose under a fresh small rigid
        # jitter: the tracking chain re-centred on its pose each frame.
        jitters = [se3_expm(torch.randn(B, 6, generator=jit_gen) * 1e-3).to(dev)
                   for _ in range(n_req)]
        outs = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(n_req):
            T_in = jitters[i] @ T_base
            outs.append(model(scene._replace(T_init=T_in), cached_desc3d=d3,
                              cached_ctx3d=c3)["Ti_pred"])
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        return torch.stack(outs), ms / n_req, ms / (n_req * B)

    serve(model, scene1, 1)  # warm-up: first-call allocations and cuDNN setup
    serve(model, scene8, 1)
    reset_counts()
    T1, ms_req1, ms_f1 = serve(model, scene1, N_REQ_B1)
    T8, ms_req8, ms_f8 = serve(model, scene8, N_REQ_B8)
    expect = cfg.refiner.render_iters * (N_REQ_B1 + N_REQ_B8)
    serving_launches, ok = counts(zbuffer_sweep_rows_attrs=expect)
    print(f"{tag} phase 4 serving B=1: {ms_req1:.3f} ms/request, "
          f"{ms_f1:.3f} ms/frame over {N_REQ_B1} requests", flush=True)
    print(f"{tag} phase 4 serving B=8: {ms_req8:.3f} ms/request, "
          f"{ms_f8:.3f} ms/frame over {N_REQ_B8} requests", flush=True)
    print(f"{tag} phase 4 kernel launches {serving_launches} "
          f"(expected rows-attrs {expect}, others 0)", flush=True)
    _check_rigid("serving B=1", T1, 1)
    _check_rigid("serving B=8", T8, 8)
    if not ok:
        raise AssertionError(f"serving launches {serving_launches}, expected {expect}")

    # 5. The z/fid kernels vs the plain sweep, through rasterize and alone.
    mesh8 = scene8.mesh
    keep8, compact8 = backface_keep(scene8.T_init, mesh8, 128)
    vc1, K1 = _crop_view(scene1, scene1.T_init)
    vc8, K8 = _crop_view(scene8, scene8.T_init)
    vcs, Ks = _crop_view(scene1, far, crop_pose=scene1.T_init)
    vcp, Kp = _crop_view(pad_scene, pad_scene.T_init)
    vc_odd, K_odd = _crop_view(scene8, scene8.T_init, out_size=CROP - 8)
    zcases = {  # name -> (mesh, verts_cam, K_crop, size, face_keep, compact_to)
        "b1": (mesh8, vc1, K1, CROP, None, None),
        "b8": (mesh8, vc8, K8, CROP, None, None),
        "backface_b8": (mesh8, vc8, K8, CROP, keep8, compact8),
        "sparse_b1": (mesh8, vcs, Ks, CROP, None, None),
        "padding_heavy_b1": (pad_scene.mesh, vcp, Kp, CROP, None, None),
        f"crop{CROP - 8}_b8": (mesh8, vc_odd, K_odd, CROP - 8, None, None),
    }
    zinputs = {}  # name -> face_data, for phase 14
    for cname, (mesh, vc, K, size, keep, compact_to) in zcases.items():
        kw = dict(face_valid=mesh.face_valid, chunk=128, face_keep=keep,
                  compact_to=compact_to)
        fr_p = rasterize(vc, mesh.faces, K, size, size, use_pallas=False, **kw)
        fd, bb = _sweep_inputs(mesh, vc, K, keep, compact_to)
        zinputs[cname] = fd
        for kname, mode in (("zbuffer_sweep_tiled", "tiled"), ("zbuffer_sweep", True)):
            fr_k = rasterize(vc, mesh.faces, K, size, size, use_pallas=mode, **kw)
            torch.cuda.synchronize()
            mism = int((fr_k.face_id != fr_p.face_id).sum())
            dz = float((fr_k.zbuf - fr_p.zbuf).abs().max())
            db = float((fr_k.bary - fr_p.bary).abs().max())
            print(f"{tag} phase 5 {kname} {cname}: B={vc.shape[0]} F={fd.shape[1]} "
                  f"{size}^2 coverage {float((fr_k.face_id >= 0).float().mean()):.4f} "
                  f"face_id mismatches {mism} max|dz| {dz:.3e} max|dbary| {db:.3e}",
                  flush=True)
            if mism != 0 or dz > TOL_Z or db > TOL_BARY:
                raise AssertionError(f"{kname} disagrees with the plain sweep ({cname})")
            max_err[kname] = max(max_err[kname], dz, db)
        # The brute-force kernel alone, and its reach pass against the plain one.
        plain = rk.zbuffer_sweep_tiled_plain(fd, None, size, size, 128)
        err = _compare(f"{tag} phase 5 zbuffer_sweep {cname} alone",
                       rk.zbuffer_sweep(fd, size, size, 128), plain)
        max_err["zbuffer_sweep"] = max(max_err["zbuffer_sweep"], err)
        reach = _check_reach(f"{tag} phase 5 zbuffer_sweep {cname}", fd, size)
        work = _work(bb, size, size)
        for kname in ("zbuffer_sweep_tiled", "zbuffer_sweep"):
            bounds[(kname, cname)] = _bound(kname, *fd.shape[:2], size, size, 0,
                                            work["in_bbox"])
        ms_t = ms_b = None
        if cname in ("b1", "b8", "backface_b8", "sparse_b1"):
            ms_p = _time_ms(lambda: rk.zbuffer_sweep_tiled_plain(fd, bb, size, size, 128), 5)
            ms_t = _device_ms(lambda: rk.zbuffer_sweep_tiled(fd, bb, size, size, 128))
            ms_c = _time_ms(lambda: rk.zbuffer_sweep_tiled(fd, bb, size, size, 128), 50)
            ms_b = _device_ms(lambda: rk.zbuffer_sweep(fd, size, size, 128))
            ms_r = _device_ms(lambda: rk._launch_reach(fd, size, size))
            ms_s = _device_ms(lambda: rk._launch_tiled(fd, reach, size, size, 128))
            ms_bc = _time_ms(lambda: rk.zbuffer_sweep(fd, size, size, 128), 50)
            times[("zbuffer_sweep_tiled", cname)] = (ms_t, ms_p)
            times[("zbuffer_sweep", cname)] = (ms_b, ms_p)
            print(f"{tag} phase 5 {cname} time (F={fd.shape[1]}): culled kernel "
                  f"{ms_t:.4f} ms on the device, {ms_c:.4f} ms a call from the host; "
                  f"brute-force kernel {ms_b:.4f} ms on the device (reach pass "
                  f"{ms_r:.4f}, sweep on its boxes {ms_s:.4f}), {ms_bc:.4f} ms a call from "
                  f"the host; plain {ms_p:.4f} ms", flush=True)
        print(f"{tag} phase 5 zbuffer_sweep_tiled {cname} work: "
              + _work_line(work, *bounds[("zbuffer_sweep_tiled", cname)], ms_t), flush=True)
        print(f"{tag} phase 5 zbuffer_sweep {cname} work on its derived boxes: "
              + _work_line(_work(reach, size, size), *bounds[("zbuffer_sweep", cname)], ms_b)
              + "; " + _reach_line(reach, bb, size), flush=True)

    # 6. The parity and backface forwards in f32: kernels vs plain sweeps.
    torch.backends.cudnn.deterministic = True
    parity_cfg = apply_parity_preset(cfg)
    kernel_vs_plain("phase 6 parity forward", parity_cfg, 4)
    kernel_vs_plain("phase 6 backface forward", dataclasses.replace(
        cfg32, refiner=dataclasses.replace(cfg32.refiner, backface_cull=True)), 5)
    torch.backends.cudnn.deterministic = False

    # 7. Parity serving, then the brute-force render of its refined poses.
    pmodel = init_random_(RNNPose(parity_cfg), torch.Generator().manual_seed(6)).to(dev)
    serve(pmodel, scene1, 1)
    serve(pmodel, scene8, 1)
    reset_counts()
    torch.cuda.reset_peak_memory_stats(dev)
    P1, pms_req1, pms_f1 = serve(pmodel, scene1, N_PAR_B1)
    peak1 = torch.cuda.max_memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    P8, pms_req8, pms_f8 = serve(pmodel, scene8, N_PAR_B8)
    peak8 = torch.cuda.max_memory_allocated(dev)
    pexpect = parity_cfg.refiner.render_iters * (N_PAR_B1 + N_PAR_B8)
    parity_launches, ok = counts(zbuffer_sweep_tiled=pexpect)
    for B, ms_req, ms_f, n, peak in ((1, pms_req1, pms_f1, N_PAR_B1, peak1),
                                     (8, pms_req8, pms_f8, N_PAR_B8, peak8)):
        print(f"{tag} phase 7 parity serving B={B}: {ms_req:.3f} ms/request, "
              f"{ms_f:.3f} ms/frame over {n} requests; peak device memory "
              f"{peak / 2**30:.3f} GiB", flush=True)
    print(f"{tag} phase 7 kernel launches {parity_launches} "
          f"(expected zbuffer_sweep_tiled {pexpect}, others 0)", flush=True)
    _check_rigid("parity serving B=1", P1, 1)
    _check_rigid("parity serving B=8", P8, 8)
    if not ok:
        raise AssertionError(f"parity launches {parity_launches}, expected {pexpect}")

    renders = [_crop_view(scene8, T) for T in P8]
    reset_counts()
    brute = [rasterize(vc, mesh8.faces, K, CROP, CROP, face_valid=mesh8.face_valid,
                       use_pallas=True) for vc, K in renders]
    brute_launches, ok = counts(zbuffer_sweep=len(renders))
    culled = [rasterize(vc, mesh8.faces, K, CROP, CROP, face_valid=mesh8.face_valid)
              for vc, K in renders]
    torch.cuda.synchronize()
    mism = sum(int((a.face_id != b.face_id).sum()) for a, b in zip(brute, culled))
    print(f"{tag} phase 7 brute-force render of the {len(renders)} refined B=8 "
          f"batches: launches {brute_launches}, face_id mismatches vs culled {mism}",
          flush=True)
    if not ok or mism != 0:
        raise AssertionError("brute-force render: wrong launches or disagreement")

    # 8. The kernels at other tiles and on the per-(b, tile) grid vs plain.
    wide_fd, wide_bb, wide_ca = _raster_case(scene1, scene1.T_init, out_size=WIDE_CROP)
    for cname, (fd, bb, ca) in cases.items():
        B = fd.shape[0]
        tiles = TILES if cname in ("b1", "b8") else (16,)
        args = (fd, bb, ca, CROP, CROP, 128)
        plain = rk.zbuffer_sweep_rows_attrs_plain(*args)
        ms_p = _time_ms(lambda: rk.zbuffer_sweep_rows_attrs_plain(*args), 5) if len(tiles) > 1 \
            else None
        for tile in tiles:
            kname = "zbuffer_sweep_tiled_attrs_batched"
            err = _compare(f"{tag} phase 8 {kname} {cname} B={B} tile {tile}",
                           rk.zbuffer_sweep_tiled_attrs_batched(*args, tile), plain, TOL_ATTR)
            max_err[kname] = max(max_err[kname], err)
            if B == 1:
                kname1 = "zbuffer_sweep_tiled_attrs"
                out1 = rk.zbuffer_sweep_tiled_attrs(fd[0], bb[0], ca[0], CROP, CROP, 128, tile)
                err = _compare(f"{tag} phase 8 {kname1} {cname} tile {tile}",
                               [x[None] for x in out1], plain, TOL_ATTR)
                max_err[kname1] = max(max_err[kname1], err)
            if ms_p is None:
                continue
            ms_k = _device_ms(lambda: rk.zbuffer_sweep_tiled_attrs_batched(*args, tile))
            line = f"{tag} phase 8 {cname} tile {tile} device time: {kname} {ms_k:.4f} ms"
            if tile == 16:
                times[(kname, cname)] = (ms_k, ms_p)
            if B == 1:
                ms_1 = _device_ms(lambda: rk.zbuffer_sweep_tiled_attrs(
                    fd[0], bb[0], ca[0], CROP, CROP, 128, tile))
                line += f", {kname1} {ms_1:.4f} ms"
                if tile == 16:
                    times[(kname1, cname)] = (ms_1, ms_p)
            if B == 8 and tile != 16:
                ms_r = _device_ms(lambda: rk.zbuffer_sweep_rows_attrs(*args, tile))
                ms_z = _device_ms(lambda: rk.zbuffer_sweep_tiled(fd, bb, CROP, CROP, 128, tile))
                ms_zp = _time_ms(lambda: rk.zbuffer_sweep_tiled_plain(fd, bb, CROP, CROP, 128), 5)
                line += (f", zbuffer_sweep_rows_attrs {ms_r:.4f} ms, zbuffer_sweep_tiled "
                         f"{ms_z:.4f} ms (plain z/fid {ms_zp:.4f} ms)")
                _compare(f"{tag} phase 8 zbuffer_sweep_rows_attrs {cname} tile {tile}",
                         rk.zbuffer_sweep_rows_attrs(*args, tile), plain, TOL_ATTR)
                _compare(f"{tag} phase 8 zbuffer_sweep_tiled {cname} tile {tile}",
                         rk.zbuffer_sweep_tiled(fd, bb, CROP, CROP, 128, tile), plain)
            print(line + f"; plain {ms_p:.4f} ms", flush=True)
    out1 = rk.zbuffer_sweep_tiled_attrs(wide_fd[0], wide_bb[0], wide_ca[0], WIDE_CROP,
                                        WIDE_CROP, 128, WIDE_TILE)
    err = _compare(f"{tag} phase 8 zbuffer_sweep_tiled_attrs {WIDE_CROP}^2 crop tile "
                   f"{WIDE_TILE}", [x[None] for x in out1],
                   rk.zbuffer_sweep_rows_attrs_plain(wide_fd, wide_bb, wide_ca, WIDE_CROP,
                                                     WIDE_CROP, 128), TOL_ATTR)
    max_err["zbuffer_sweep_tiled_attrs"] = max(max_err["zbuffer_sweep_tiled_attrs"], err)

    # 9. The per-class entry point at full width: bench.py's KPConv towers.
    kp = kpconv_config(syn)
    tower = dict(first_feats_dim=TOWER_WIDTH, gnn_feats_dim=TOWER_WIDTH)
    towers = dict(
        desc_kp=dataclasses.replace(kp, final_feats_dim=32, **tower),
        ctx_kp=dataclasses.replace(kp, final_feats_dim=256, normalize_output=False, **tower))
    emodel = init_random_(RNNPose(RNNPoseConfig(refiner=RefinerConfig(**REFINER), **towers)),
                          torch.Generator().manual_seed(7)).to(dev)
    for B, scene in ((1, scene1), (8, scene8)):
        d3, c3 = emodel.encode_3d(scene.pyramid)
        real = scene.pyramid.masks[0] > 0
        norm_err = float((d3[real].norm(dim=-1) - 1.0).abs().max())
        if norm_err > 1e-5 or bool((d3[~real] != 0).any()) or not bool(torch.isfinite(c3).all()):
            raise AssertionError(f"encode_3d B={B}: not unit-norm on real points or "
                                 f"non-zero on padding ({norm_err:.2e})")
        ms = _time_ms(lambda: emodel.encode_3d(scene.pyramid), 5, warmup=1)
        print(f"{tag} phase 9 encode_3d B={B}: {ms:.3f} ms (desc {tuple(d3.shape)}, "
              f"ctx {tuple(c3.shape)}; max| |desc| - 1 | on real points {norm_err:.2e})",
              flush=True)

    torch.backends.cudnn.deterministic = True
    cfg32_e = RNNPoseConfig(refiner=RefinerConfig(mixed_precision=False, **REFINER), **towers)
    m_kernel = init_random_(RNNPose(cfg32_e), torch.Generator().manual_seed(8)).to(dev)
    m_plain = RNNPose(cfg32_e, plain_raster=True).to(dev)
    m_plain.load_state_dict(m_kernel.state_dict())
    T_k, T_p = m_kernel(scene8)["Ti_pred"], m_plain(scene8)["Ti_pred"]
    d_pose = float((T_k - T_p).abs().max())
    print(f"{tag} phase 9 f32 uncached forward B=8: max|Ti_pred kernel - plain| "
          f"{d_pose:.3e} (limit {TOL_POSE}); max|Ti_pred - T_init| "
          f"{float((T_k - scene8.T_init).abs().max()):.3e}", flush=True)
    if not d_pose <= TOL_POSE:
        raise AssertionError("uncached forward: kernel and plain raster disagree")
    torch.backends.cudnn.deterministic = False

    grid_pref, tile_pref = raster_mod._GRID_PREF, raster_mod._TILE_PREF
    raster_mod._GRID_PREF = "tile"
    try:
        engine = InferenceEngine(emodel)
        classes = {1: ("ico_b1", scene1, N_ENG_B1), 8: ("ico_b8", scene8, N_ENG_B8)}

        def engine_serve(B, n_req):
            cls, scene, _ = classes[B]
            jitters = [se3_expm(torch.randn(B, 6, generator=jit_gen) * 1e-3).to(dev)
                       for _ in range(n_req)]
            reqs = [scene._replace(T_init=j @ scene.T_init) for j in jitters]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            outs = [engine.refine(cls, r)["Ti_pred"] for r in reqs]
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            return reqs, torch.stack(outs), ms / n_req, ms / (n_req * B)

        engine_serve(1, 1)  # warm-up; computes and caches each class's features
        engine_serve(8, 1)
        reset_counts()
        results = {}
        for B in (1, 8):
            torch.cuda.reset_peak_memory_stats(dev)
            results[B] = engine_serve(B, classes[B][2])
            results[B] += (torch.cuda.max_memory_allocated(dev),)
        eexpect = emodel.cfg.refiner.render_iters * (N_ENG_B1 + N_ENG_B8)
        engine_launches, ok = counts(zbuffer_sweep_tiled_attrs_batched=eexpect)
        for B, (_, T, ms_req, ms_f, peak) in results.items():
            print(f"{tag} phase 9 engine serving (grid tile) B={B}: {ms_req:.3f} ms/request, "
                  f"{ms_f:.3f} ms/frame over {classes[B][2]} requests; peak device memory "
                  f"{peak / 2**30:.3f} GiB", flush=True)
            _check_rigid(f"engine serving B={B}", T, B)
        print(f"{tag} phase 9 kernel launches {engine_launches} (expected "
              f"zbuffer_sweep_tiled_attrs_batched {eexpect}, others 0); encode_3d calls "
              f"{engine.encode_3d_calls} for {len(classes)} classes", flush=True)
        if not ok or engine.encode_3d_calls != len(classes):
            raise AssertionError("engine serving: wrong launches or encode_3d calls")

        # One B=8 request again at tile 16, then at BIG_TILE: the same poses.
        torch.backends.cudnn.deterministic = True
        req8 = results[8][0][0]
        T16 = engine.refine("ico_b8", req8)["Ti_pred"]
        raster_mod._TILE_PREF = str(BIG_TILE)
        reset_counts()
        T40 = engine.refine("ico_b8", req8)["Ti_pred"]
        tile40_launches, ok = counts(
            zbuffer_sweep_tiled_attrs_batched=emodel.cfg.refiner.render_iters)
        d40 = float((T40 - T16).abs().max())
        print(f"{tag} phase 9 B=8 request at tile {BIG_TILE}: launches {tile40_launches}; "
              f"max|Ti_pred tile {BIG_TILE} - tile 16| {d40:.3e}", flush=True)
        if not ok or not d40 <= TOL_POSE:
            raise AssertionError("tile-40 request: wrong launches or disagreement")
        torch.backends.cudnn.deterministic = False
    finally:
        raster_mod._GRID_PREF, raster_mod._TILE_PREF = grid_pref, tile_pref

    # 10. The refined B=1 poses rendered one mesh at a time at BIG_TILE.
    renders = [_raster_case(scene1, T) for T in results[1][1]]
    reset_counts()
    singles = [rk.zbuffer_sweep_tiled_attrs(fd[0], bb[0], ca[0], CROP, CROP, 128, BIG_TILE)
               for fd, bb, ca in renders]
    single_launches, ok = counts(zbuffer_sweep_tiled_attrs=len(renders))
    for (fd, bb, ca), out1 in zip(renders, singles):
        err = _compare(f"{tag} phase 10 one-mesh render at tile {BIG_TILE} vs batched at 16",
                       [x[None] for x in out1],
                       rk.zbuffer_sweep_tiled_attrs_batched(fd, bb, ca, CROP, CROP, 128),
                       TOL_ATTR)
        max_err["zbuffer_sweep_tiled_attrs"] = max(max_err["zbuffer_sweep_tiled_attrs"], err)
    print(f"{tag} phase 10 launches {single_launches}", flush=True)
    if not ok:
        raise AssertionError("one-mesh render: wrong launches")

    # 11. Training at full width: the serving operating point with phase 9's
    # towers and the 256-row correspondence set.
    train_cfg = RNNPoseConfig(refiner=RefinerConfig(**REFINER), **towers)
    R = train_cfg.refiner.render_iters
    train_launches = 0
    trainers = {}
    for B, scene in ((1, scene1), (8, scene8)):
        model_t = init_random_(RNNPose(train_cfg), torch.Generator().manual_seed(9)).to(dev)
        trainer = Trainer(model_t, OptimizerConfig())
        trainer.run_step(scene)  # warm-up: first-call allocations and cuDNN setup
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        reset_counts()
        step_ms = []
        for i in range(N_TRAIN_STEPS):
            t0 = time.perf_counter()
            m = trainer.run_step(scene)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            step_ms.append(ms)
            loss = float(m["loss"])
            print(f"{tag} phase 11 train B={B} step {i + 1}: loss {loss:.6f} grad_norm "
                  f"{float(m['grad_norm']):.6g} skipped {int(m['skipped_nonfinite'])} "
                  f"{ms:.3f} ms/step; peak device memory "
                  f"{torch.cuda.max_memory_allocated(dev) / 2**30:.3f} GiB", flush=True)
            if not math.isfinite(loss):
                raise AssertionError(f"train B={B}: non-finite loss")
        step_launches, ok = counts(zbuffer_sweep_rows_attrs=R * N_TRAIN_STEPS)
        train_launches += step_launches["zbuffer_sweep_rows_attrs"]
        finite = all(bool(torch.isfinite(p).all()) for p in model_t.parameters())
        print(f"{tag} phase 11 train B={B}: kernel launches {step_launches} over "
              f"{N_TRAIN_STEPS} steps (expected rows-attrs {R} per step, others 0); "
              f"parameters finite: {finite}", flush=True)
        if not ok or not finite:
            raise AssertionError(f"train B={B}: wrong launches or non-finite parameters")
        trainers[B] = trainer
        _profile_train_step(trainer, scene, f"{tag} phase 11 profile B={B}",
                            sorted(step_ms)[len(step_ms) // 2])
        if B == 1:
            b1_step_ms = sorted(step_ms)[len(step_ms) // 2]

    # One f32 step at B=2 through the kernel and through the plain raster,
    # under deterministic algorithms: loss, gradients and the updated
    # parameters must be identical.
    torch.use_deterministic_algorithms(True)
    cfg32_t = dataclasses.replace(train_cfg, refiner=dataclasses.replace(
        train_cfg.refiner, mixed_precision=False))
    scene2 = _batch(scene8, 2)
    steps = {}
    for plain in (False, True):
        m32 = init_random_(RNNPose(cfg32_t, plain_raster=plain),
                           torch.Generator().manual_seed(10)).to(dev)
        t32 = Trainer(m32, OptimizerConfig())
        reset_counts()
        met = t32.run_step(scene2)
        # The kernel side must launch the kernel R times, the plain side never.
        got, ok = counts(zbuffer_sweep_rows_attrs=0 if plain else R)
        print(f"{tag} phase 11 f32 train step B=2 {'plain' if plain else 'kernel'} "
              f"raster: launches {got}", flush=True)
        if not ok:
            raise AssertionError(f"f32 train step (plain={plain}): launches {got}")
        steps[plain] = (met, {n: p.grad.clone() for n, p in m32.named_parameters()},
                        {n: p.detach().clone() for n, p in m32.named_parameters()})
    torch.use_deterministic_algorithms(False)
    (mk, gk, pk), (mp, gp, pp) = steps[False], steps[True]
    grads_differ = [n for n in gk if not torch.equal(gk[n], gp[n])]
    params_differ = [n for n in pk if not torch.equal(pk[n], pp[n])]
    print(f"{tag} phase 11 f32 train step B=2 kernel vs plain (deterministic): loss "
          f"{float(mk['loss']):.9g} vs {float(mp['loss']):.9g}, grad_norm "
          f"{float(mk['grad_norm']):.9g} vs {float(mp['grad_norm']):.9g}; gradients "
          f"differing {len(grads_differ)} of {len(gk)}, updated parameters differing "
          f"{len(params_differ)}", flush=True)
    if (not torch.equal(mk["loss"], mp["loss"]) or grads_differ or params_differ
            or float(mk["skipped_nonfinite"]) != 0.0):
        raise AssertionError(f"f32 train step: kernel and plain raster disagree "
                             f"{grads_differ[:5]} {params_differ[:5]}")

    # Checkpoint round trip on the card: save the B=8 trainer, restore into
    # a fresh one, compare every tensor bitwise.
    build = Path(__file__).resolve().parent / "rnnpose_tpu_torch" / "_build"
    build.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as ckpt_dir:
        src = trainers[8]
        path = ckpt_lib.save_checkpoint(ckpt_dir, src.state_dict(), src.state.step)
        fresh = Trainer(init_random_(RNNPose(train_cfg), torch.Generator().manual_seed(11))
                        .to(dev), OptimizerConfig())
        # Loaded on the host: load_state_dict puts each tensor where the
        # trainer keeps it (Adam's step counts stay on the host).
        fresh.load_state_dict(ckpt_lib.try_restore_latest(ckpt_dir, map_location="cpu"))
        a, b = src.state_dict(), fresh.state_dict()
        mismatched = [k for k in a["model"] if not torch.equal(a["model"][k], b["model"][k])]
        sa, sb = a["optimizer"]["adam"]["state"], b["optimizer"]["adam"]["state"]
        mismatched += [f"adam {i} {k}" for i in sa for k in sa[i]
                       if not torch.equal(sa[i][k], sb[i][k])]
        same_counts = (a["step"], a["optimizer"]["count"]) == (b["step"], b["optimizer"]["count"])
        print(f"{tag} phase 11 checkpoint round trip ({os.path.getsize(path) / 2**20:.1f} MiB, "
              f"step {b['step']}): {len(a['model'])} model tensors and {len(sa)} Adam states, "
              f"mismatches {len(mismatched)}; step and update count equal: {same_counts}",
              flush=True)
        if mismatched or len(sa) != len(sb) or not same_counts:
            raise AssertionError(f"checkpoint round trip differs: {mismatched[:5]}")

    # 12. The LINEMOD evaluation entry point at full width.
    _eval_entry_point(tag, dev, reset_counts, counts, build)

    # Phase 13's dataset (read again by phase 24) and the traces of phases
    # 15 and 16 (read by phase 22) stay until the end.
    with tempfile.TemporaryDirectory(dir=build) as keep:
        fixture = os.path.join(keep, "phase13")
        trace_root = os.path.join(keep, "traces")
        os.makedirs(fixture)
        os.makedirs(trace_root)

        # 13. Training on LINEMOD-format data at full width.
        linemod_train_launches = _train_entry_point(tag, dev, reset_counts, counts, fixture)

        # 14. The brute-force kernel on adversarial faces.
        for cname, size in (("b8", CROP), (f"crop{CROP - 8}_b8", CROP - 8)):
            err = _adversarial_phase(tag, zinputs[cname], size)
            max_err["zbuffer_sweep"] = max(max_err["zbuffer_sweep"], err)

        # 15. Serving export at full width: phase 4's model, scenes and features.
        export_launches, parity_export_launches = _export_phase(
            tag, dev, model, {1: (scene1, N_REQ_B1), 8: (scene8, N_REQ_B8)}, desc3d, ctx3d,
            {1: ms_req1, 8: ms_req8}, reset_counts, counts, build, trace_root)

        # 16. profile_components at full width; 17. the demo.
        _profile_phase(tag, dev, trace_root)
        _demo_phase(tag, dev, build)

        # 18a. A data-parallel step in two gloo processes sharing the card.
        launches_dp = _dryrun_phase(tag, dev, train_cfg, _batch(scene8, 2), b1_step_ms)

        # 19-24. The card's jax-free tests, numerics against the CPU, the inner
        # step's ablation, the traces, the learning check, fps and the frontier.
        _card_tests_phase(tag)
        tool_launches = {"numerics_check": _numerics_phase(tag, reset_counts, counts)}
        _ablate_phase(tag)
        _trace_phase(tag, trace_root)
        tool_launches["overfit_check"] = _overfit_phase(tag, reset_counts, counts)
        tool_launches["measure_fps+budget_frontier"] = _fps_phase(tag, reset_counts, counts,
                                                                  fixture)

        launches = {"zbuffer_sweep_rows_attrs": train_launches,
                    "zbuffer_sweep_tiled": parity_launches["zbuffer_sweep_tiled"],
                    "zbuffer_sweep": brute_launches["zbuffer_sweep"],
                    "zbuffer_sweep_tiled_attrs_batched":
                        engine_launches["zbuffer_sweep_tiled_attrs_batched"],
                    "zbuffer_sweep_tiled_attrs": single_launches["zbuffer_sweep_tiled_attrs"]}
        # Launches per serving request (rows-attrs, phase 4) and per parity
        # request (z/fid, phase 7) as counted there; the other kernels are off
        # every default path (the tile grid of phase 9 is an option).
        per_request = dict.fromkeys(KERNELS, 0)
        per_request["zbuffer_sweep_rows_attrs"] = (
            serving_launches["zbuffer_sweep_rows_attrs"] / (N_REQ_B1 + N_REQ_B8))
        per_request["zbuffer_sweep_tiled"] = (
            parity_launches["zbuffer_sweep_tiled"] / (N_PAR_B1 + N_PAR_B8))
        # Launches through the loaded artifacts (phase 15): the serving chains
        # in this process, the parity artifact in the CLI's process.
        launches_export = dict.fromkeys(KERNELS, 0)
        launches_export["zbuffer_sweep_rows_attrs"] = export_launches
        launches_export["zbuffer_sweep_tiled"] = parity_export_launches
        # ms (device time of one launch), plain_ms and the bound at B=8; the
        # one-mesh kernel at B=1. No single PyTorch call computes a z-buffer.
        case = {k: "b1" if k == "zbuffer_sweep_tiled_attrs" else "b8" for k in KERNELS}
        print(json.dumps({"kernels": [{
            "name": k, "route": "cuda", "source": src, "replaces": rep,
            "launches": launches[k], "launches_per_request": per_request[k],
            "launches_train_linemod": (linemod_train_launches
                                       if k == "zbuffer_sweep_rows_attrs" else 0),
            "launches_export": launches_export[k],
            "launches_dp": launches_dp if k == "zbuffer_sweep_rows_attrs" else 0,
            "launches_tools": {tool: got[k] for tool, got in tool_launches.items()},
            "max_abs_err": max_err[k], "ms": times[(k, case[k])][0],
            "plain_ms": times[(k, case[k])][1], "bytes": bounds[(k, case[k])][0],
            "bound_ms": bounds[(k, case[k])][1], "bound_by": bounds[(k, case[k])][2],
            "library_ms": None,
        } for k, (src, rep) in KERNELS.items()]}), flush=True)
        print(smi, flush=True)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}),
            flush=True)
        return 0


if __name__ == "__main__":
    sys.exit(main())
