#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of RNNPose once on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases (each raises on failure, so any failure exits non-zero), in the
order 1, 2, 28, 29, 30, 31, 3-10, 26, 11, 27, 12-14, 16, 21, 18a, then 15, 17, 19, 20,
25 and 22 while phase 23 runs in a process of its own (`--overfit_child`;
the phases beside it check correctness or time two ways in turns), then
24; the script prints its total wall time (the limit it must keep: 1200 s):
  1. build the three CUDA raster sources and the LM step's, the lookup's
     and the instance norm's sources of `rnnpose_tpu_torch/csrc/` (one nvcc
     each, started together, with
     -Xptxas -v) and the host library of the native KPConv pyramid ops;
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
     per-(b, tile) grid (`_GRID_PREF = "tile"`), one class name per batch
     size: the first request of each class computes its features and
     captures its program, `zbuffer_sweep_tiled_attrs_batched` launched
     (WARMUP_RUNS + 1) x render_iters times in it and the rows-attrs kernel
     never; then 4 requests at B=1 and 2 at B=8 replay the graphs (no
     launch from Python), poses finite and rigid; `encode_3d` and a capture
     once per class; ms/request, ms/frame, peak memory; one B=8 request
     again at tile 16 and at `_TILE_PREF = 40`, each captured anew (a
     program keeps the tile of its capture), which must agree;
 10. the refined poses of the B=1 engine requests rendered one mesh at a
     time through `zbuffer_sweep_tiled_attrs` at tile 40: one launch per
     request, equal to the batched render;
 11. training at full width (phase 4's operating point, phase 9's towers,
     the scene's 256-row correspondence set): `Trainer` with the default
     `OptimizerConfig`, WARMUP_RUNS eager steps and the step that captures
     (the rows-attrs kernel launched (WARMUP_RUNS + 1) x render_iters times
     in them), then N_TRAIN_STEPS timed replayed steps at B=1 and at B=8;
     per step the loss, grad_norm, ms/step (synchronised) and peak device
     memory; the loss and the parameters finite and no launch from Python
     in the replays; one f32 step at B=2 (a trainer's first, eager) through the
     kernel (render_iters launches) and through the plain raster (none)
     under `torch.use_deterministic_algorithms(True)`: loss, every gradient
     and every updated parameter identical; the B=8 trainer saved as a
     checkpoint and restored into a fresh one, bitwise; after the timed
     steps of each batch size, one more step, eager (`make_train_step` on
     the trainer's model and optimizer), under torch.profiler with tracing
     off: device busy against wall time, device ops and kernel-launch calls
     per step and the ops that own the most device time; then one more
     eager step with a `Tracer` and no profiler: its stamped device ms of
     forward, backward and update (see `_profile_train_step`);
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
     (WARMUP_RUNS + 1) x render_iters times in the engine's capture of the
     run's one class and shape and never in its replays, and
     `zbuffer_sweep_tiled` never (the reverse under `--parity`), every
     dumped pose (16 rows) finite and
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
     finite, the rows-attrs kernel launched render_iters times in each of
     the trainer's first WARMUP_RUNS + 1 steps (the eager ones and the
     capture) and never in its replays,
     (WARMUP_RUNS + 1) x render_iters times in each periodic eval's capture
     (its runner's `prepare`) and never in its replay, and no other kernel,
     every `eval/*` key present and
     finite; it prints ms per step (and the median of the replayed ones), the
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
     `tools/export_model`, `tools/serve_bundle.py`): phase 4's weights,
     scenes and cached features at the depth EXPORT_DEPTH (2 render
     iterations of 1 GRU step) exported with `torch.export` at B=1 and at
     B=8, each saved as a bundle and loaded back in this process (export,
     save and load seconds, taken beside the processes below, bytes,
     operator nodes: render_iters rows-attrs nodes and one LM step node per
     LM step); Ti_pred of each
     loaded artifact against the eager forward on the same inputs
     (TOL_POSE). Then phase 4's tracking chain through each loaded
     artifact and eagerly at that depth, in turns on the same jitters (8
     requests at B=1, 4 at B=8): ms/request of both, rows-attrs launched
     render_iters times per artifact request, poses finite, rigid and equal
     to the eager chain's within TOL_POSE. Three processes, started in the
     phase: a standalone consumer, `tools/serve_bundle.py`, on the B=1 bundle's
     example (`utils/export.save_example`: computed under deterministic
     algorithms), with `rnnpose_tpu`, `rnnpose_tpu_torch`, `jax` and `flax`
     blocked and the bundle's own module copies and kernel libraries:
     Ti_pred within its bound (1e-6), render_iters launches counted by its
     own operators, its load time (beside the others); and, from the
     phase's start, `tools/export_model` twice at the same depth, an f32
     artifact and a parity-preset one, each with `--selftest` (1e-5):
     render_iters rows-attrs launches through the f32 artifact, render_iters `zbuffer_sweep_tiled` launches and no
     rows-attrs one through the parity artifact; the phase's wall time;
 16. `tools/profile_components --iters 2` at full width, B=1 and B=8: per component
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
     launches ((WARMUP_RUNS + 1) x render_iters rows-attrs, in the
     trainer's eager steps and its capture, no other kernel), the
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
     launches render_iters rows-attrs in each of its trainer's first
     WARMUP_RUNS + 1 steps, none in the replays (the gloo all-reduce runs
     eagerly between the two graphs), and (WARMUP_RUNS + 1) x render_iters
     in its one eval capture; ms/step per rank.
 19. the jax-free card tests: `pytest --noconftest tests/test_torch_port_cuda.py`
     in a subprocess (the kernel-vs-plain tests of the raster files at their
     scenes and bounds, `InferenceEngine`'s replay against the eager
     forward and its capture of a host read, and `Trainer`'s: replayed steps
     against eager ones and a NaN step bitwise, a replay under the profiler
     without a kernel launch from Python, a host read in the loss failing
     the capture; the tracer's: traced graphs hold the untraced nodes plus
     one per mark and give bit-equal outputs, serving and training; the LM
     step kernel against its plain version at B=1 and B=8 on the 1/8 grid
     and B=8 at 240^2, its clamp, its bits across calls and graph replays,
     and the engine's graph with one node per LM step; RAFT through
     `FlowEngine` at 440 x 1024 and 32 iterations against its eager forward,
     and programs of three classes and two RAFT shapes replayed out of
     capture order); all 23 must pass, none skip;
 20. `tools/numerics_check --full`: each pose-critical op, the raster, the
     fused raster and the f32 forward (2 x 2, 64^2 crop) on the card and on
     the CPU on the same inputs, max |cuda - cpu| beside the JAX tool's
     tolerance (5e-6 per pose op, 5e-3 on `Ti_pred`); any FAIL exits;
 21. `tools/ablate_inner_step --batch 8` (240^2, bf16): host, CUDA-event and
     device ms of each inner-step sub-op; then `--scan 8`, per iteration;
 22. `tools/parse_trace` over phase 16's `profile_components --trace` at
     B=1 and B=8 (an eager eval forward and a replayed training step at
     full depth) and phase 15's traces of one eager request and one request
     through the loaded artifact at B=1 and B=8 (at EXPORT_DEPTH): launches
     (kernel and graph), device ms, host ops, the traced span, and the top
     10 families and host ops of each;
 23. `tools/overfit_check --eval_mode heldout --steps 160` at its defaults
     (160 px, 120 crop, 512/1024 mesh), in a process of its own:
     ADD(init), ADD(refined), their ratio, the first and last 50 losses'
     means, the launches counted in that process and its wall time;
     it fails unless ratio < 0.7 and the last-50 loss < 0.7x the first-50
     (the JAX package's checks in tests/test_viewpoint_health.py);
 24. `tools/measure_fps` at B=1 and B=8 (bench.py's chained protocol at its
     operating point, on chains of FPS_FRAMES = 10 frames, not the
     protocol's 40; the chains replay the engine's graph, and the kernel
     launches from Python only in the FLOP count's eager pass, the
     warm-ups and the capture), then `tools/budget_frontier` over phase 13's dataset
     and its B=1 run's checkpoint, `--grid 3x4,2x2 --max_frames 8`, its fps
     points on chains of 4 frames;
 25. the rounding forms (`geometry/precise.py`: a number over a tensor as a
     tensor over a tensor, a division by a constant as a multiply by its f32
     reciprocal, XLA's contracted multiply-adds in f64 rounded once) on the
     card against the CPU on the same inputs: the zoom crop and the face
     setup (its plain watertight form) of the full-budget rehearsal scene,
     `crop_source_coords`, `normalize_coords`, `project` (plain), the se3
     Taylor branches, bilinear
     sampling, the clip factor and `fma` itself (headlight shading's light
     term is an `fma`; its normals' norm is a reduction, summed in another
     order on the card), each bit-equal (max |cuda - cpu| 0, else it
     fails); how torch divides on the
     card (`x / c` against `x * f32(1/c)`, `c / x` against the correctly
     rounded quotient), and phase 20's se3 and LM readings beside the
     earlier 1.192e-07 (PERF.md);
 26. the compiled serving engine (`InferenceEngine`: one CUDA graph per
     class and shape) at phase 4's width with phase 9's towers, the serving
     defaults and the parity preset (f32, the `zbuffer_sweep_tiled`
     branch), each at B=1 and B=8: per key the capture's seconds (after
     WARMUP_RUNS eager warm-ups), its launches ((WARMUP_RUNS + 1) x
     render_iters of the branch's kernel) and the graph pool's bytes;
     GRAPH_REQS distinct requests (a fresh pose jitter and image noise
     each) replayed, every output equal to the eager forward's (max |delta|
     0), the first request's outputs unchanged after the others, no
     launch from Python in a replay; ms/request of the replay and of the
     eager forward in turns (N_GRAPH_B1 requests at B=1, N_GRAPH_B8 at
     B=8); one replayed and one eager request under torch.profiler: device
     events and ms, kernel-launch API calls, graph launches, host ops and
     the traced span, and the raster sweep's device events in the replay,
     which must be render_iters of the branch's kernel, and the LM step
     kernel's in each, which must be render x GRU x LM iterations
     (`lm_steps`); the LM launches from Python, (WARMUP_RUNS + 1) x
     lm_steps in the warm-ups and the capture (the engine's
     `kernel_launches["lm_step"]`, lm_steps a graph) and none in the
     replays; the lookup kernel likewise (render x GRU iterations,
     `lookups`; `kernel_launches["corr_lookup"]`), and the instance norm
     kernel likewise (15 a render iteration and SuperPoint's 3, `norms`;
     `kernel_launches["instance_norm"]`);
 27. the compiled training step (`Trainer`: graphs A, forward and
     backward, and B, the guarded update, per batch key) at phase 11's
     operating point with phase 9's towers, at B=1 and B=8. Under
     deterministic algorithms: WARMUP_RUNS + TRAIN_GRAPH_REPLAYS distinct
     batches (a fresh pose jitter and image noise each) through a trainer
     (WARMUP_RUNS eager steps, then the step that captures and replays,
     then replays) and through `make_train_step` on a deep copy of its
     model from the same state: loss and every metric, every parameter,
     moment and the update count equal (max |delta| 0); then a NaN batch
     through both: skipped_nonfinite 1 and the state unchanged bit for
     bit; the capturing step's seconds, the launches from Python in the
     warm-ups and the capture ((WARMUP_RUNS + 1) x render_iters rows-attrs)
     and none in the replays, the graph pool's bytes. In the default mode,
     a trainer captured in it: ms/step of the replay and of the eager step
     in turns with their spread (N_TRAIN_GRAPH_B1 steps at B=1,
     N_TRAIN_GRAPH_B8 at B=8); one replayed and one eager step under
     torch.profiler: device events (the replay's within 1% of the eager
     step's plus its copies of the batch in and the metrics out, and the
     families whose counts differ) and ms, the idle share, kernel-launch API
     calls (none in the replay), graph launches (2), host ops and the
     traced span, and render_iters rows-attrs device events in each.
 28. the LM step kernel (`csrc/lm_step.cu`) at LM_SHAPES (B=1 and B=8 on
     the serving path's 30^2 grid, B=8 on parity's 240^2 crop) on
     `lm_problem`'s seeded inputs: one launch a call, the new pose within
     LM_TOL of the plain version's (`lm_step_plain`, the chain of PyTorch
     ops it replaces), the kernel's device time a launch beside its bound
     (the bytes it reads once at 3.35 TB/s) and the plain chain's;
 29. the correlation lookup kernel (`csrc/corr_lookup.cu`) at LOOKUP_SHAPES
     (tracking's 30^2 grid at B=1, serving's and parity's at B=8, RAFT's
     55 x 128), 4 levels of radius 4, on every case of `corr_problem`
     (in-range, out-of-range, NaN and inf coordinates, non-finite level
     values, bf16 levels): one launch a call, the plain version's bits
     (`corr_lookup_plain`, the chain of PyTorch ops it replaces), the
     kernel's device time a launch beside its bound (the bytes it writes
     and reads once at 3.35 TB/s), the plain chain's, and the largest gap
     where both are finite;
 30. the instance norm kernel (`csrc/instance_norm.cu`) at NORM_SHAPES (the
     RNNPose encoders' planes at B=2 and B=16, SuperPoint's half and full
     tails, RAFT's `fnet` at 440 x 1024, one plane that takes the second
     mode, NCHW and odd channel counts) on `norm_problem`'s seeded inputs,
     with and without the ReLU: one launch a call, within `norm_gap`'s
     bound of the plain version (`instance_norm_plain`, the chain of
     PyTorch ops it replaces); the kernel's device time a launch beside its
     bound (the input read once and the output written once at 3.35 TB/s)
     and the plain chain's; and, from those, the norms' device ms of a
     served frame, a B=8 request, a RAFT pair and a RAFT-Stereo pair
     (NORM_PATHS);
 31. RAFT-Stereo's 1D correlation lookup kernel (`csrc/corr_lookup.cu`,
     `corr_lookup_1d`) at STEREO_LOOKUP_SHAPES (Middlebury's 504 x 720 grid,
     level widths 720/360/180/90, and a small grid at B=2) on every case of
     `stereo_lookup_problem` (in-range, out-of-range, NaN and inf
     coordinates, bf16 levels): one launch a call, the plain version's bits
     (`corr_lookup_1d_plain`), the kernel's device time a launch beside its
     bound and the plain chain's; then RAFT-Stereo (`models/raft_stereo`,
     bf16) through `FlowEngine` at Middlebury's 2880 x 1988 frames, 32
     iterations: two pairs replayed equal the eager forward bit for bit, its
     capture's launches (`corr_lookup_1d` 32, `instance_norm` 15), the
     pyramid's bytes, the graph's nodes, a replayed pair's ms and the peak
     memory.
Phases 11, 13, 16, 18 and 23 train through `Trainer`'s graphs: their
launch counts are the warm-ups' and the capture's, (WARMUP_RUNS + 1) x
render_iters per trainer and key, none per replayed step.
The launch counters cover the LM step, lookup and instance norm kernels
too: every forward without gradient launches them `lm_steps` (the model's
render x GRU x LM iterations), `lookups` (render x GRU iterations) and
`norms` times (15 a render iteration and SuperPoint's 3), a training step
never (its LM, lookups and norms run under autograd); phases 4, 7,
9, 11, 12, 13, 15, 26 and 27 check their counts, phases 20, 23 and 24
report them.
Then one JSON line on the kernels (the rows-attrs kernel's launches are
the training phase's, the other kernels' those of the phase that drives
them; launches per request on the default paths; `launches_per_replay`,
the kernel's device events per replayed engine request in phase 26's
profile (rows-attrs serving, z/fid under parity); `launches_per_train_replay`,
the rows-attrs kernel's device events per replayed training step in phase
27's profile; `launches_export`, the
launches through the loaded artifacts of phase 15: rows-attrs over the
serving chains, `zbuffer_sweep_tiled` through the parity artifact; at B=8,
the one-mesh kernel at B=1: device ms, plain ms, bytes and the bound;
`launches_dp`, rows-attrs launches per rank in phase 18a (its warm-ups
and capture);
`launches_tools`, the launches of phases 20, 23 and 24 by tool; the
`lm_step` entry: launches in phases 4 and 7, per serving and per parity
request, through phase 15's artifacts and by tool, device events per
phase-26 replay, and phase 28's readings, its ms, bytes and bound those at
B=8 on 240^2; the `corr_lookup` entry likewise, with phase 29's readings,
its ms, bytes and bound those of RAFT's 55 x 128; the `instance_norm`
entry likewise, with phase 30's readings, its ms, bytes and bound those of
RAFT's stem; the `corr_lookup_1d` entry with phase 31's readings, its ms,
bytes and bound those of Middlebury's 504 x 720 grid), the card's name and
power limit from
nvidia-smi, and the final JSON line
{"ok": true, "device": {...}}.

It imports nothing of JAX. Without a CUDA device, or outside the
repository, it exits non-zero and prints no result.
"""
from __future__ import annotations

import contextlib
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
N_TRAIN_STEPS = 5  # replayed training steps timed per batch size, after the capture
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
# The kernels that port no TPU kernel and run on every path without gradient.
NO_GRAD_KERNELS = ("lm_step", "corr_lookup", "instance_norm", "corr_lookup_1d")
TOL_Z, TOL_ATTR, TOL_BARY, TOL_POSE = 1e-5, 1e-4, 1e-5, 1e-3
# Phase 15: the depth of the exported programs (phase 4's widths and
# weights; export, save and load grow with the unrolled inner steps, 3 x 4
# at the defaults), and the CLI artifacts beside the serving ones.
EXPORT_DEPTH = dict(render_iters=2, gru_iters=1)
EXPORT_CLI = {name: flags + [f"--{k}={v}" for k, v in EXPORT_DEPTH.items()]
              for name, flags in (("f32", ["--f32"]), ("parity", ["--parity"]))}
# Phase 16: timed calls per component, at the tool's defaults (full width);
# phase 17: the demo's images at its defaults (160^2 image, 120^2 crop, the
# flow at 1/8).
PROFILE_ITERS = 2
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
# overfit check's steps and the seconds its process may take. Phase 24: the
# frames per timed chain of measure_fps (the protocol's 40, cut to fit the
# script's time), the frontier's grid and the frames per chain of its fps
# points.
CARD_TESTS, CARD_TESTS_N = "tests/test_torch_port_cuda.py", 63
OVERFIT_STEPS, OVERFIT_TIMEOUT_S = 160, 600
FPS_FRAMES = 10
# Phase 26: distinct requests held to the eager forward per key, and the
# requests timed in turns at B=1 and at B=8.
GRAPH_REQS = 4
N_GRAPH_B1, N_GRAPH_B8 = 8, 4
# phase 27: replayed training steps held against eager ones, and the steps
# timed per way in turns
TRAIN_GRAPH_REPLAYS = 3
N_TRAIN_GRAPH_B1, N_TRAIN_GRAPH_B8 = 6, 4
FRONTIER_GRID, FRONTIER_FPS_FRAMES = "3x4,2x2", 4
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
    plain torch (`kernels/raster.tile_face_overlap`, the kernel's cull):
    32 x 32 blocks that list any face, of all blocks; listed (block, face)
    pairs; pixel tests (the listed faces' rectangles); and the pixel-in-bbox
    pairs (pixel centres inside a face's exact bbox, the work the z-buffer
    needs)."""
    import torch
    from rnnpose_tpu_torch.kernels import raster as rk

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
    from rnnpose_tpu_torch.kernels import raster as rk

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
    from rnnpose_tpu_torch.kernels import raster as rk

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
    from rnnpose_tpu_torch.kernels import raster as rk

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


def _profile_train_step(step_fn, scene, label):
    """Two warm eager training steps (`step_fn`, a `make_train_step`). The
    first runs under torch.profiler with tracing off, so its counts compare
    with earlier readings. Prints, on one line: the wall time of the
    profiled step (host clock, synchronised); device busy
    (`utils/profiling.device_busy`: the sum of the device operations' own
    times, user-annotation spans left out); the idle share against that
    wall; the device operations and the kernel-launch API calls; then the
    device ms of the second step's `forward`, `backward` and `update`
    stages, stamped by a `Tracer` active around it, without the profiler
    (`utils/profiling`). Then the host ops that own the most device time in
    the profiled step (user-annotation spans left out: a range's span on
    the device covers the gaps between its kernels)."""
    import torch
    from rnnpose_tpu_torch.utils import profiling
    from rnnpose_tpu_torch.utils.profiling import annotation_names, device_busy
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step_fn(scene)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    events = prof.events()
    ranges = annotation_names(prof)
    busy, ops = device_busy(prof)
    api = sum(e.name.startswith(("cudaLaunchKernel", "cuLaunchKernel")) for e in events)
    tracer = profiling.Tracer(torch.device("cuda", torch.cuda.current_device()))
    with tracer.call("train_step"):
        step_fn(scene)
    dev = {k: v[0] for k, v in profiling.group_ms(
        tracer.export(), ("forward", "backward", "update")).items()}
    print(f"{label}: profiled wall {wall:.3f} ms; device busy {busy:.3f} ms; idle share "
          f"{1 - busy / wall:.4f} of the profiled step; device ops {ops}, kernel-launch API calls "
          f"{api}; the next step stamped, unprofiled: device ms forward {dev['forward']:.3f}, "
          f"backward {dev['backward']:.3f}, update {dev['update']:.3f}", flush=True)
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
    from rnnpose_tpu_torch.models.engine import WARMUP_RUNS
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
            # One class and one batch shape per run: the engine's warm-ups
            # and capture launch the kernel, every forward replays the graph.
            capture = (WARMUP_RUNS + 1) * R
            # The LM steps, lookups and norms likewise (the parity preset
            # keeps them).
            fwd = dict(lm_step=(WARMUP_RUNS + 1) * lm_steps(model_cfg),
                       corr_lookup=(WARMUP_RUNS + 1) * lookups(model_cfg),
                       instance_norm=(WARMUP_RUNS + 1) * norms(model_cfg))
            run("batch 1", ["--eval_batch", "1"], dict(zbuffer_sweep_rows_attrs=capture, **fwd))
            run("batch 8", ["--eval_batch", "8"], dict(zbuffer_sweep_rows_attrs=capture, **fwd))
            parity = run("parity batch 8", ["--parity", "--eval_batch", "8"],
                         dict(zbuffer_sweep_tiled=capture, **fwd))
            run("icp batch 1", ["--icp", "--eval_batch", "1"],
                dict(zbuffer_sweep_rows_attrs=capture, **fwd))
            plain = run("parity batch 8 plain raster",
                        ["--parity", "--eval_batch", "8", "--plain_raster"], fwd)
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

        self.rows_attrs = rows_attrs  # () -> the rows-attrs kernel's launches so far
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
        self.eval_calls = []  # (engine method, rows-attrs launches, programs made)

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
                n0 = meter.rows_attrs()
                t0 = time.perf_counter()
                if meter.last_end is not None:
                    meter.gaps.append((t0 - meter.last_end) * 1e3)
                out = orig(trainer, batch)
                torch.cuda.synchronize()
                meter.last_end = time.perf_counter()
                meter.steps.append(((meter.last_end - t0) * 1e3,
                                    meter.rows_attrs() - n0))
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

        def engine_wrap(orig):
            def call(engine, cls, inputs):
                n0, c0 = meter.rows_attrs(), engine.graph_captures
                out = orig(engine, cls, inputs)
                meter.eval_calls.append((orig.__name__, meter.rows_attrs() - n0,
                                         engine.graph_captures - c0))
                return out
            return call
        for method in ("prepare", "refine"):
            self._patch(InferenceEngine, method, engine_wrap)
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
    from rnnpose_tpu_torch import kernels
    from rnnpose_tpu_torch.models.engine import WARMUP_RUNS
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
    model_cfg1 = build_model_config(merge_cfg([cfg1], defaults=default_config()))
    render_iters = model_cfg1.refiner.render_iters
    meter = _HostMeter(lambda: kernels.LAUNCHES["zbuffer_sweep_rows_attrs"])

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
        # Each periodic eval (one forward) captures its program in the
        # runner's `prepare`, then replays it: no launch from Python. The
        # trainer's one key launches in its WARMUP_RUNS eager steps and in
        # the step that captures, and never in its replays.
        capture = (WARMUP_RUNS + 1) * render_iters
        want_calls = [("prepare", capture, 1), ("refine", 0, 0)] * n_evals
        warm = min(len(meter.steps), WARMUP_RUNS + 1)
        want_steps = [render_iters] * warm + [0] * (len(meter.steps) - warm)
        expect = render_iters * warm + capture * n_evals
        # The LM step, lookup and norm kernels only in the evals' warm-ups
        # and captures: the training steps run them under autograd.
        lm_expect = (WARMUP_RUNS + 1) * lm_steps(model_cfg1) * n_evals
        look_expect = (WARMUP_RUNS + 1) * lookups(model_cfg1) * n_evals
        norm_expect = (WARMUP_RUNS + 1) * norms(model_cfg1) * n_evals
        got, ok = counts(zbuffer_sweep_rows_attrs=expect, lm_step=lm_expect,
                         corr_lookup=look_expect, instance_norm=norm_expect)
        peak = torch.cuda.max_memory_allocated(dev)
        with open(os.path.join(model_dir, "log.json.lst")) as f:
            rows = [json.loads(line) for line in f]
        steps = [r for r in rows if "loss" in r]
        evals = [r for r in rows if "eval/params_l1" in r]
        ms = [m for m, _ in meter.steps]
        replayed = ms[warm:]
        med = sorted(replayed)[len(replayed) // 2] if replayed else float("nan")
        per = {k: 1e3 * v / max(meter.samples, 1) for k, v in meter.cpu.items()}
        wait = (1e3 * sum(meter.waits[1:]) / (len(meter.waits) - 1)
                if len(meter.waits) > 1 else float("nan"))
        gap = sorted(meter.gaps)[len(meter.gaps) // 2] if meter.gaps else float("nan")
        skipped = sum(r["skipped_nonfinite"] for r in steps)
        print(f"{tag} phase {phase} train {label}: {len(meter.steps)} steps, ms/step "
              f"{', '.join(f'{m:.3f}' for m in ms)} (median of the replayed steps "
              f"{med:.3f}); "
              f"loader wait ms/step {wait:.3f} (threaded runs; after the first); median "
              f"gap between steps {gap:.3f} ms; wall ms/sample where read (the loader threads, "
              f"or the main thread when synchronous) over "
              f"{meter.samples} samples {_parts(per)}; collation ms/batch "
              f"{1e3 * meter.collate_s / max(len(meter.steps), 1):.3f}; rows-attrs "
              f"launches per step {[n for _, n in meter.steps]} (expected {want_steps}); "
              f"eval (engine call, "
              f"launches, captures) {meter.eval_calls} (expected {want_calls}); launches "
              f"{got} (expected rows-attrs {expect}, lm_step {lm_expect}, corr_lookup "
              f"{look_expect}); peak "
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
                or meter.eval_calls != want_calls or bad_eval or skipped
                or [n for _, n in meter.steps] != want_steps
                or not all(math.isfinite(r["loss"]) for r in steps)):
            raise AssertionError(
                f"train {label}: steps {len(meter.steps)}/{n_steps}, evals {len(evals)}/"
                f"{n_evals}, launches {got}, eval calls {meter.eval_calls}, bad eval "
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
from rnnpose_tpu_torch import kernels
from rnnpose_tpu_torch.models.engine import InferenceEngine
from rnnpose_tpu_torch.tools import train as cli
from rnnpose_tpu_torch.train import checkpoint as ckpt
from rnnpose_tpu_torch.train.loop import Trainer
report = {"digests": [], "step_ms": [], "eval_forwards": 0, "captures": 0}
save, run_step = ckpt.save_checkpoint, Trainer.run_step
refine, prepare = InferenceEngine.refine, InferenceEngine.prepare
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
def counted_prepare(self, *args, **kwargs):
    c0 = self.graph_captures
    out = prepare(self, *args, **kwargs)
    report["captures"] += self.graph_captures - c0
    return out
ckpt.save_checkpoint = digest_then_save
Trainer.run_step = timed_step
InferenceEngine.refine = counted_refine
InferenceEngine.prepare = counted_prepare
cli.main(sys.argv[1:])
report["launches"] = {k: kernels.LAUNCHES[k] for k in chip_smoke.KERNELS}
print(json.dumps(report), flush=True)
"""


def _two_rank_cli(tag, dev, root, cfg, render_iters):
    """Phase 18c (see the module docstring)."""
    from rnnpose_tpu_torch.models.engine import WARMUP_RUNS
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
    # Each eval forward replays the program its runner's `prepare` captured;
    # the trainer launches in its warm-ups and its capture, not in replays.
    expect = [render_iters * (min(DP_CLI_STEPS, WARMUP_RUNS + 1)
                              + (WARMUP_RUNS + 1) * rep["captures"]) for rep in reports]
    for r, rep in enumerate(reports):
        ms = rep["step_ms"]
        print(f"{tag} phase 18c train CLI rank {r} of 2 (gloo, {device}): ms/step "
              f"{', '.join(f'{m:.3f}' for m in ms)} (median after the first "
              f"{sorted(ms[1:])[len(ms[1:]) // 2]:.3f}); eval forwards {rep['eval_forwards']}, "
              f"captures {rep['captures']}; "
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
          and all(rep["eval_forwards"] > 0 and rep["captures"] == 1 for rep in reports)
          and all(rep["launches"] == dict(dict.fromkeys(KERNELS, 0),
                                          zbuffer_sweep_rows_attrs=e)
                  for rep, e in zip(reports, expect)))
    if not ok:
        raise AssertionError(f"phase 18c: two-rank training CLI run wrong: {reports}")


def _dryrun_phase(tag, dev, train_cfg, scene2, b1_step_ms):
    """Phase 18a (see the module docstring). Returns the rows-attrs
    launches per rank."""
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
    # Each rank's trainer launches in its warm-ups and its capture only.
    from rnnpose_tpu_torch.train.loop import WARMUP_RUNS

    expect = R * min(DP_STEPS, WARMUP_RUNS + 1)
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
          f"{res['launches']} (expected rows-attrs {expect} in the warm-ups and the capture, "
          f"none in replays); ms/step per rank "
          f"{[[round(m, 3) for m in ms] for ms in res['ms_per_step']]} beside phase 11's "
          f"single-process B=1 median {b1_step_ms:.3f} (default precision); wall {wall:.2f} s",
          flush=True)
    if any(x != dict(dict.fromkeys((*KERNELS, *NO_GRAD_KERNELS), 0),
                     zbuffer_sweep_rows_attrs=expect) for x in res["launches"]):
        raise AssertionError(f"phase 18a launches {res['launches']}")
    return expect


def _last_json(text, label):
    """The JSON object on the last line of a subprocess's standard output."""
    lines = [line for line in text.splitlines() if line.startswith("{")]
    if not lines:
        raise AssertionError(f"{label}: no JSON line in its output:\n{text[-4000:]}")
    return json.loads(lines[-1])


@contextlib.contextmanager
def _reaped(procs, logs):
    """On leaving: kill each process of `procs` still running and close each
    file of `logs` (both dicts may fill inside the block)."""
    try:
        yield
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for log in logs.values():
            log.close()


def _export_phase(tag, dev, model, scenes, desc3d, ctx3d, reset_counts, counts, build,
                  trace_root):
    """Phase 15 (see the module docstring): phase 4's `model` at the depth
    EXPORT_DEPTH. `scenes` maps B to (scene, requests). Returns the
    launches counted through the serving artifacts in this process and
    those counted through the parity artifact in the CLI's, each by kernel. After the chains, one
    warm eager request and one through the loaded artifact at each B run
    under `utils/profiling.trace`, into `trace_root/{eager,artifact}_b<B>`
    (phase 22 reads them)."""
    import torch
    from rnnpose_tpu_torch.geometry.se3 import se3_expm
    from rnnpose_tpu_torch.models.rnnpose import RNNPose
    from rnnpose_tpu_torch.utils import export as ex
    from rnnpose_tpu_torch.utils.profiling import trace

    repo = Path(__file__).resolve().parent
    t_phase = time.perf_counter()
    cfg = model.cfg
    shallow = RNNPose(dataclasses.replace(cfg, refiner=dataclasses.replace(
        cfg.refiner, **EXPORT_DEPTH))).to(dev)
    shallow.load_state_dict(model.state_dict())
    model = shallow.train(model.training)
    R = model.cfg.refiner.render_iters
    # One LM step node per render and GRU iteration and LM step, one lookup
    # node per render and GRU iteration, one norm node per instance norm.
    steps, looks, nrms = lm_steps(model.cfg), lookups(model.cfg), norms(model.cfg)
    procs, logs, results = {}, {}, {}
    with tempfile.TemporaryDirectory(dir=build) as root, _reaped(procs, logs):
        def start(name, args):
            logs[name] = open(os.path.join(root, f"{name}.log"), "w+")
            procs[name] = subprocess.Popen([sys.executable] + args, cwd=repo,
                                           stdout=logs[name], stderr=subprocess.STDOUT,
                                           text=True)

        # The CLI, as a user runs it (an f32 artifact and a parity-preset
        # one, each with its selftest), from the phase's start beside this
        # process's exports; the standalone consumer on the B=1 bundle once
        # that is saved. Export, save and load seconds are taken beside them.
        for name, flags in EXPORT_CLI.items():
            start(name, ["-m", "rnnpose_tpu_torch.tools.export_model", "--out",
                         os.path.join(root, name), "--platform", dev.type, "--selftest"]
                  + flags)
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
            if nodes != {"zbuffer_sweep_rows_attrs": R, "lm_step": steps, "corr_lookup": looks,
                         "instance_norm": nrms}:
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
                start("consumer", ["rnnpose_tpu_torch/tools/serve_bundle.py", bundle, example,
                                   "--device", dev.type])
            runs[B] = (run, leaves)

        # The tracking chain of phase 4, eagerly and through the artifacts,
        # in turns (eager, artifact, artifact, eager), on the same jitters.
        gen = torch.Generator().manual_seed(15)
        served = {}
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
            got, ok = counts(zbuffer_sweep_rows_attrs=2 * R * n_req, lm_step=2 * steps * n_req,
                             corr_lookup=2 * looks * n_req, instance_norm=2 * nrms * n_req)
            _, ms_e2 = chain(eager)
            served = {k: served.get(k, 0) + n for k, n in got.items()}
            d_pose = float((T_a - T_e).abs().max())
            print(f"{tag} phase 15 serving through the artifact B={B}: {ms_a1:.3f}, {ms_a2:.3f} "
                  f"ms/request against eager {ms_e1:.3f}, {ms_e2:.3f} in turns, {R} x "
                  f"{model.cfg.refiner.gru_iters} iterations, over {n_req} requests; launches {got} (expected "
                  f"rows-attrs {2 * R * n_req}, lm_step {2 * steps * n_req}, corr_lookup "
                  f"{2 * looks * n_req}, instance_norm {2 * nrms * n_req}); max|Ti_pred artifact "
                  f"- eager| {d_pose:.3e}",
                  flush=True)
            _check_rigid(f"artifact serving B={B}", T_a, B)
            if not ok or not d_pose <= TOL_POSE:
                raise AssertionError(f"artifact serving B={B}: launches {got}, max|d| {d_pose}")
            for label, fn in (("eager", eager), ("artifact", lambda T: run(T, *leaves))):
                torch.cuda.synchronize()
                with trace(os.path.join(trace_root, f"{label}_b{B}")):
                    fn(T_ins[0])
                    torch.cuda.synchronize()

        # The three processes, each to its end.
        for name, proc in procs.items():
            rc = proc.wait(timeout=900)
            logs[name].seek(0)
            text = logs[name].read()
            if rc != 0:
                raise AssertionError(f"phase 15 {name} exited {rc}:\n{text[-4000:]}")
            results[name] = _last_json(text, name)
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
            want.update(lm_step=steps, corr_lookup=looks, instance_norm=nrms)
            launches = {k: v for k, v in got["artifact_launches"].items() if v}
            print(f"{tag} phase 15 export_model {' '.join(flags)} --selftest: max|artifact - "
                  f"direct| {got['selftest_max_abs_diff']:.3e} (limit 1e-05); operator nodes "
                  f"{got['operator_nodes']}; launches through the reloaded artifact {launches} "
                  f"(expected {want}); bundle {got['bundle_bytes']} bytes", flush=True)
            if launches != want or got["operator_nodes"] != want:
                raise AssertionError(f"export_model {flags}: launches {launches}")
    print(f"{tag} phase 15 wall {time.perf_counter() - t_phase:.2f} s", flush=True)
    return served, results["parity"]["artifact_launches"]


# Phase 28: the LM step kernel's shapes, (B, side of the pixel grid): the
# serving path's 1/8 grid at B=1 and B=8, the parity preset's full 240^2
# crop at B=8. Its bound against the plain version, LM_TOL (the card tests
# use it too): the two differ only in rounding (the plain version's
# transform and Jacobian products run through cuBLAS, which may fuse a
# multiply into the add after it, where the kernel rounds each op as the CPU
# does; its f64 normal equations are summed in cuBLAS's order, the kernel's
# per thread, warp, block, then the blocks in order): the twist moves in its
# last bits and the pose, whose entries are at most 1 in size, by a few f32
# ulps (6e-8 each).
LM_SHAPES = ((1, 30), (8, 30), (8, 240))
LM_TOL = 1e-6


def lm_steps(cfg):
    """The LM step kernel's launches in one forward without gradient of a
    model of `cfg` (an `RNNPoseConfig`): render x GRU x LM iterations."""
    r = cfg.refiner
    return r.render_iters * r.gru_iters * r.optim_iters


def lookups(cfg):
    """The correlation lookup kernel's launches in one forward without
    gradient of a model of `cfg` (an `RNNPoseConfig`): render x GRU
    iterations."""
    r = cfg.refiner
    return r.render_iters * r.gru_iters


def norms(cfg):
    """The instance norm kernel's launches in one forward without gradient
    of a model of `cfg` (an `RNNPoseConfig`): the feature encoder's 15 per
    render iteration (the stem, two per residual block and the two
    downsampling norms) and SuperPoint's decoder's 3."""
    return 15 * cfg.refiner.render_iters + 3


def lm_problem(B, size, seed=0, device="cuda"):
    """A seeded LM step at `size`^2 pixels: (T, target, weight, depth, K).
    Poses within a few degrees and centimetres of the identity, depth
    0.4-0.7 m with a band at and below the 0.1 threshold, targets the pixel
    grid plus 1 px of noise, one weight channel broadcast to both (stride
    0, as the refiner passes it), a camera of focal 1.25 `size`. Item 1
    sits 0.55 m nearer (some points behind the camera, some between the
    projection's 0.01 and the 0.1 threshold); from B=4 on, item 2's weights
    are all zero and item 3 has a non-finite weight."""
    import torch

    from rnnpose_tpu_torch.geometry import se3

    g = torch.Generator().manual_seed(seed)
    T = se3.se3_expm(torch.randn(B, 6, generator=g) * torch.tensor([0.01] * 3 + [0.03] * 3))
    depth = 0.4 + 0.3 * torch.rand(B, size, size, generator=g)
    depth[:, : size // 10] = torch.linspace(-0.1, 0.1, size)[None, None, :]
    K = torch.tensor([[1.25 * size, 1.25 * size, size / 2.0, size / 2.0]] * B)
    grid = torch.stack(torch.meshgrid(torch.arange(size, dtype=torch.float32),
                                      torch.arange(size, dtype=torch.float32),
                                      indexing="xy"), -1)
    target = grid[None] + torch.randn(B, size, size, 2, generator=g)
    weight = torch.rand(B, size, size, 1, generator=g)
    if B > 1:
        T[1, 2, 3] -= 0.55
    if B >= 4:
        weight[2] = 0.0
        weight[3, 1, 2] = float("inf")
    T, target, weight, depth, K = (a.to(device) for a in (T, target, weight, depth, K))
    return T, target, weight.expand(B, size, size, 2), depth, K


def _lm_phase(tag):
    """Phase 28 (see the module docstring)."""
    import torch

    from rnnpose_tpu_torch import kernels
    from rnnpose_tpu_torch.kernels import lm as lm_kernel

    t0 = time.perf_counter()
    rows = {}
    for B, size in LM_SHAPES:
        args = lm_problem(B, size, seed=B * 1000 + size)
        launches = kernels.LAUNCHES["lm_step"]
        got = lm_kernel.lm_step(*args)
        want = lm_kernel.lm_step_plain(*args)
        torch.cuda.synchronize()
        gap = float((got - want).abs().max())
        if kernels.LAUNCHES["lm_step"] != launches + 1 or not gap <= LM_TOL:
            raise AssertionError(f"phase 28 LM step B={B} {size}^2: max|kernel - plain| {gap}, "
                                 f"launches {kernels.LAUNCHES['lm_step'] - launches}")
        us = _device_ms(lambda: lm_kernel.lm_step(*args)) * 1e3
        plain_ms = _device_ms(lambda: lm_kernel.lm_step_plain(*args), iters=10)
        # Read once: depth, the target's two channels and the weight's one;
        # T and K in, T out.
        nbytes = B * size * size * (4 + 8 + 4) + B * (16 + 4 + 16) * 4
        bound_us = nbytes / HBM_BYTES_PER_S * 1e6
        rows[f"b{B}_{size}"] = {"us": us, "bound_us": bound_us, "bytes": nbytes,
                                "plain_ms": plain_ms, "max_abs_err": gap}
        print(f"{tag} phase 28 LM step B={B} {size}^2: kernel {us:.3f} us a launch (bound "
              f"{bound_us:.3f} us, {nbytes} bytes, {100 * bound_us / us:.2f}% of it); the plain "
              f"chain {plain_ms:.4f} ms; max|kernel - plain| {gap:.3e} (limit {LM_TOL})",
              flush=True)
    print(f"{tag} phase 28 wall {time.perf_counter() - t0:.2f} s", flush=True)
    return rows


# Phase 29: the correlation lookup kernel's shapes, (B, H, W) of the 1/8
# grid: tracking's 30^2 at B=1, batch serving's and parity's at B=8, RAFT's
# 55 x 128 at Sintel's evaluation shape; 4 levels of radius 4, each on every
# case of `corr_problem`. The kernel gives the plain version's bits
# (`same_bits`; the card tests hold it to them too).
LOOKUP_SHAPES = ((1, 30, 30), (8, 30, 30), (1, 55, 128))
LOOKUP_CASES = ("in_range", "out_of_range", "nan_coords", "nonfinite_element0", "bf16")


def corr_problem(B, H, W, case="in_range", seed=0, levels=4, device="cuda"):
    """A seeded correlation lookup on a B x H x W grid: (levels, coords).
    The levels are `ops/corr.build_corr_pyramid` of two random 32-channel
    feature maps (f32); coords the grid plus 3 px of noise. `case`:
    "in_range", as made; "out_of_range", a third of the positions anywhere
    in [-3, 4] x the grid's size, and a few at the edges (-1e-9, where
    -1e-9 + 4 rounds to 4; the last row and column; +-1e30; half-pixels
    outside); "nan_coords", out_of_range's coords with NaN or +-inf in x,
    y or both at some positions; "nonfinite_element0", out_of_range's
    coords, and some queries' rows hold inf in their first column and NaN or
    inf at element 0 in every level; "bf16", out_of_range's coords on the
    levels in bf16 (the flow check's `bf16_volume` fault)."""
    import numpy as np
    import torch

    from rnnpose_tpu_torch.ops.corr import build_corr_pyramid

    rs = np.random.RandomState(seed)
    f1, f2 = (torch.from_numpy(rs.randn(B, H, W, 32).astype(np.float32)).to(device)
              for _ in range(2))
    lv = list(build_corr_pyramid(f1, f2, levels).levels)
    grid = np.stack(np.meshgrid(np.arange(W), np.arange(H), indexing="xy"), -1)
    xy = (grid[None] + 3.0 * rs.randn(B, H, W, 2)).astype(np.float32).reshape(-1, 2)
    Q = xy.shape[0]
    pick = rs.permutation(Q)
    if case != "in_range":
        n = Q // 3
        xy[pick[:n]] = rs.uniform(-3.0, 4.0, (n, 2)) * np.float32([W, H])
        edges = np.float32([[-1e-9, -1e-9], [W - 1, H - 1], [1e30, -1e30], [W - 0.5, -0.5],
                            [-4.5, H + 3.5], [0.0, 0.0]])[: Q - n]
        xy[pick[n:n + len(edges)]] = edges
        rest = pick[n + len(edges):]
        if case == "nan_coords":
            bad = [np.nan, np.inf, -np.inf]
            for j, q in enumerate(rest[: max(Q // 10, 9)]):
                axes = [[0], [1], [0, 1]][j % 3]
                xy[q, axes] = bad[(j // 3) % 3]
        if case == "nonfinite_element0":
            rows = torch.from_numpy(pick[::7].copy()).to(device)
            for level in lv:
                if level.numel():
                    rows_of = level.view(Q, level.shape[2], level.shape[3])
                    rows_of[rows, :, 0] = float("inf")
                    rows_of[rows[::2], 0, 0] = float("nan")
        if case == "bf16":
            lv = [level.to(torch.bfloat16) for level in lv]
    return lv, torch.from_numpy(xy.reshape(B, H, W, 2)).to(device)


def same_bits(a, b) -> bool:
    """Whether two f32 tensors are equal bit for bit, NaN where NaN (its
    payload aside)."""
    import torch

    nan = a.isnan()
    return bool(torch.equal(nan, b.isnan()) and torch.equal(
        a.masked_fill(nan, 0.0).view(torch.int32), b.masked_fill(nan, 0.0).view(torch.int32)))


def _lookup_phase(tag):
    """Phase 29 (see the module docstring)."""
    import torch

    from rnnpose_tpu_torch import kernels
    from rnnpose_tpu_torch.kernels import corr as corr_kernel

    t0 = time.perf_counter()
    rows = {}
    radius = 4
    for B, H, W in LOOKUP_SHAPES:
        gaps, launches = [], kernels.LAUNCHES["corr_lookup"]
        for i, case in enumerate(LOOKUP_CASES):
            lv, coords = corr_problem(B, H, W, case, seed=B * 1000 + H + i)
            got = corr_kernel.corr_lookup(lv, coords, radius)
            want = corr_kernel.corr_lookup_plain(lv, coords, radius)
            torch.cuda.synchronize()
            both = torch.isfinite(got) & torch.isfinite(want)
            gaps.append(float((got - want)[both].abs().max()))
            if not same_bits(got, want):
                raise AssertionError(f"phase 29 lookup {B}x{H}x{W} {case}: the kernel differs "
                                     f"from the plain version (max|d| where finite {gaps[-1]})")
        if kernels.LAUNCHES["corr_lookup"] != launches + len(LOOKUP_CASES):
            raise AssertionError(f"phase 29 lookup {B}x{H}x{W}: launches "
                                 f"{kernels.LAUNCHES['corr_lookup'] - launches}")
        lv, coords = corr_problem(B, H, W, seed=B * 1000 + H)
        us = _device_ms(lambda: corr_kernel.corr_lookup(lv, coords, radius)) * 1e3
        plain_ms = _device_ms(lambda: corr_kernel.corr_lookup_plain(lv, coords, radius),
                              iters=10)
        # Written once: the output; read once: the coords and each query's
        # (2r+2)^2 window of every level, clipped to the level.
        Q, win = B * H * W, 2 * radius + 2
        nbytes = Q * (len(lv) * (win - 1) ** 2 * 4 + 8 + sum(
            min(win, level.shape[2]) * min(win, level.shape[3]) * 4 for level in lv))
        bound_us = nbytes / HBM_BYTES_PER_S * 1e6
        rows[f"b{B}_{H}x{W}"] = {"us": us, "bound_us": bound_us, "bytes": nbytes,
                                 "plain_ms": plain_ms, "max_abs_err": max(gaps)}
        print(f"{tag} phase 29 lookup B={B} {H}x{W}, {len(lv)} levels, radius {radius}: "
              f"kernel {us:.3f} us a launch (bound {bound_us:.3f} us, {nbytes} bytes, "
              f"{100 * bound_us / us:.2f}% of it); the plain chain {plain_ms:.4f} ms; "
              f"{len(LOOKUP_CASES)} cases {LOOKUP_CASES} bit for bit, max|kernel - plain| "
              f"where finite {max(gaps):.3e}", flush=True)
    print(f"{tag} phase 29 wall {time.perf_counter() - t0:.2f} s", flush=True)
    return rows


# Phase 30: the instance norm kernel's shapes, name -> (B, C, H, W, dtype,
# layout): the RNNPose feature encoder's planes at the 240^2 crop (B=2 a
# tracked frame's pair, B=16 a served B=8 request's, f32 under parity),
# SuperPoint's decoder on the 320^2 image (the half tail at B=1 and B=8, the
# full tail in f32 at B=8), RAFT's `fnet` at 440 x 1024 (both frames),
# RAFT-Stereo's `fnet` at Middlebury's 2016 x 2880 (both frames; its stem's
# plane holds 5.8 M positions, a group of 32 channels 371 MB), a
# plane too large for a cluster's shared memory (the second mode), a
# contiguous NCHW tensor and an odd channel count (narrower vectors).
NORM_SHAPES = {
    **{f"encoder_b{B}_{s}{sfx}": (B, C, s, s, dt, "nhwc")
       for B, sfx, dt in ((2, "", "bf16"), (16, "", "bf16"), (16, "_f32", "f32"))
       for C, s in ((64, 120), (96, 60), (128, 30))},
    **{f"superpoint_b{B}_{s}{sfx}": (B, 128, s, s, dt, "nhwc")
       for B, sfx, dt, sides in ((1, "", "bf16", (80, 160)), (8, "", "bf16", (80, 160)),
                                 (8, "_f32", "f32", (80, 160, 320)))
       for s in sides},
    **{f"raft_{h}x{w}": (2, C, h, w, "bf16", "nhwc")
       for C, h, w in ((64, 220, 512), (96, 110, 256), (128, 55, 128))},
    **{f"stereo_{h}x{w}": (2, C, h, w, "bf16", "nhwc")
       for C, h, w in ((64, 2016, 2880), (96, 1008, 1440), (128, 504, 720))},
    "second_mode": (1, 8, 512, 512, "bf16", "nhwc"),
    "nchw_f32": (2, 64, 60, 60, "f32", "nchw"),
    "odd_channels": (3, 6, 7, 9, "bf16", "nhwc"),
}
# The norms of one request on each path, by shape: a tracked frame and a
# served B=8 request (3 render iterations x 5 norms at each of the encoder's
# three planes, SuperPoint's half tail), a parity B=8 request (its full
# tail), a RAFT pair and a RAFT-Stereo pair (`fnet`'s 5 a plane).
_ENC = ("120", "60", "30")
NORM_PATHS = {
    "track_b1": {**{f"encoder_b2_{s}": 15 for s in _ENC},
                 "superpoint_b1_80": 1, "superpoint_b1_160": 2},
    "serve_b8": {**{f"encoder_b16_{s}": 15 for s in _ENC},
                 "superpoint_b8_80": 1, "superpoint_b8_160": 2},
    "parity_b8": {**{f"encoder_b16_{s}_f32": 15 for s in _ENC},
                  **{f"superpoint_b8_{s}_f32": 1 for s in ("80", "160", "320")}},
    "raft_pair": {name: 5 for name in ("raft_220x512", "raft_110x256", "raft_55x128")},
    "stereo_pair": {name: 5 for name in ("stereo_2016x2880", "stereo_1008x1440",
                                         "stereo_504x720")},
}
# The kernel's bound against the plain chain (`norm_gap`; the card tests use
# it too): both take the statistics in f32, in different orders (the chain's
# reductions, the kernel's per thread, warp, block and cluster), so the
# normalised values differ in their last f32 bits: at most NORM_F32_TOL on
# these inputs, whose normalised values stay under 10.
NORM_F32_TOL = 1e-5


def norm_problem(name, seed=0, device="cuda"):
    """A seeded input of NORM_SHAPES[name]: unit normals scaled by 1 to 4 and
    shifted by N(0, 2) per channel, so the statistics are not 0 and 1, in
    the shape's dtype and layout."""
    import torch

    B, C, H, W, dt, layout = NORM_SHAPES[name]
    g = torch.Generator(device=device).manual_seed(seed)
    scale = 1.0 + 3.0 * torch.rand(1, C, 1, 1, generator=g, device=device)
    shift = 2.0 * torch.randn(1, C, 1, 1, generator=g, device=device)
    x = torch.randn(B, C, H, W, generator=g, device=device) * scale + shift
    x = x.to(torch.bfloat16 if dt == "bf16" else torch.float32)
    return x.contiguous(memory_format=torch.channels_last if layout == "nhwc"
                        else torch.contiguous_format)


def norm_gap(got, want):
    """The kernel's norm against the plain chain's: (the largest |got -
    want|, the elements that differ, whether every one is within the
    bound). f32: NORM_F32_TOL. bf16: one bf16 ulp of the chain's value more
    (the two round f32 values a few bits apart, so one near a rounding edge
    lands an ulp away, and one within NORM_F32_TOL of 0, whose ulp is finer
    than that, may round from the other side)."""
    import torch

    maxes, differing, ok = [], 0, True
    # In slices of 64 rows, so that the f32 temporaries stay small beside
    # the largest planes (RAFT-Stereo's stem: 1.5 GB a bf16 tensor).
    for gs, ws in zip(got.split(64, dim=-2), want.split(64, dim=-2)):
        g, w = gs.float(), ws.float()
        d = (g - w).abs()
        bound = torch.full_like(w, NORM_F32_TOL)
        if got.dtype == torch.bfloat16:
            _, e = torch.frexp(w)
            bound += torch.where(w == 0, 0.0, torch.ldexp(torch.ones_like(w), e - 8))
        maxes.append(d.max())
        differing += int((d > 0).sum())
        ok = ok and bool((d <= bound).all())
    return float(torch.stack(maxes).max()), differing, ok


def _norm_phase(tag):
    """Phase 30 (see the module docstring)."""
    import torch

    from rnnpose_tpu_torch import kernels
    from rnnpose_tpu_torch.kernels import norm as norm_kernel

    t0 = time.perf_counter()
    rows = {}
    for i, name in enumerate(NORM_SHAPES):
        x = norm_problem(name, seed=3000 + i)
        launches, gaps = kernels.LAUNCHES["instance_norm"], []
        for relu in (False, True):
            got = norm_kernel.instance_norm(x, 1e-5, relu)
            want = norm_kernel.instance_norm_plain(x, 1e-5, relu)
            torch.cuda.synchronize()
            gaps.append(norm_gap(got, want))
            if not gaps[-1][2] or got.stride() != x.stride() or got.dtype != x.dtype:
                raise AssertionError(f"phase 30 norm {name} relu={relu}: the kernel differs "
                                     f"from the plain version (max|d|, differing) {gaps[-1][:2]}")
        if kernels.LAUNCHES["instance_norm"] != launches + 2:
            raise AssertionError(f"phase 30 norm {name}: launches "
                                 f"{kernels.LAUNCHES['instance_norm'] - launches}")
        us = _device_ms(lambda: norm_kernel.instance_norm(x, 1e-5, True)) * 1e3
        plain_ms = _device_ms(lambda: norm_kernel.instance_norm_plain(x, 1e-5, True),
                              iters=10)
        # The input read once and the output written once.
        nbytes = 2 * x.numel() * x.element_size()
        bound_us = nbytes / HBM_BYTES_PER_S * 1e6
        p = norm_kernel.launch_params(x, kernels.build.sm_count(x.device.index))
        rows[name] = {"us": us, "bound_us": bound_us, "bytes": nbytes, "plain_ms": plain_ms,
                      "max_abs_err": max(g[0] for g in gaps), "differing": gaps[1][1],
                      "tiles": p["tiles"], "vec": p["vec"], "cached": p["cached"]}
        print(f"{tag} phase 30 norm {name} {tuple(x.shape)} {x.dtype}: kernel {us:.3f} us a "
              f"launch with its ReLU (bound {bound_us:.3f} us, {nbytes} bytes, "
              f"{100 * bound_us / us:.2f}% of it; clusters of {p['tiles']}, {p['vec']}-element "
              f"vectors, {'on chip' if p['cached'] else 're-read'}); the plain chain "
              f"{plain_ms:.4f} ms; max|kernel - plain| {max(g[0] for g in gaps):.3e}, "
              f"{gaps[1][1]} of {x.numel()} elements differ (bound: NORM_F32_TOL "
              f"{NORM_F32_TOL}{' + one bf16 ulp' if x.dtype == torch.bfloat16 else ''})",
              flush=True)
        del x, got, want
    for path, counts in NORM_PATHS.items():
        total = {key: sum(n * rows[s][key] for s, n in counts.items())
                 for key in ("us", "bound_us", "plain_ms")}
        rows[path] = {"norms": sum(counts.values()), "ms": total["us"] / 1e3,
                      "bound_ms": total["bound_us"] / 1e3, "plain_ms": total["plain_ms"]}
        print(f"{tag} phase 30 norms of a {path} request: {sum(counts.values())} launches, "
              f"kernel {total['us'] / 1e3:.4f} ms (bound {total['bound_us'] / 1e3:.4f} ms); "
              f"the plain chains {total['plain_ms']:.4f} ms", flush=True)
    print(f"{tag} phase 30 wall {time.perf_counter() - t0:.2f} s", flush=True)
    return rows


# Phase 31: RAFT-Stereo's 1D lookup at Middlebury's 504 x 720 grid (its
# level widths 720, 360, 180, 90) and at a small grid at B=2, 4 levels of
# radius 4, each on every case of `stereo_lookup_problem` (the card tests
# hold it to the plain version's bits too); the model at Middlebury's frame.
STEREO_LOOKUP_SHAPES = ((1, 504, 720), (2, 24, 40))
STEREO_LOOKUP_CASES = ("in_range", "out_of_range", "nan_coords", "bf16")
STEREO_FRAME, STEREO_ITERS, STEREO_MAX_DISP = (1988, 2880), 32, 256


def stereo_lookup_problem(B, H, W, case="in_range", seed=0, levels=4, device="cuda"):
    """A seeded 1D correlation lookup on a B x H x W grid: (levels, coords).
    The levels are `ops/corr.build_corr_pyramid_1d` of two random
    32-channel feature maps (f32); coords the grid with x moved by a seeded
    flow of up to -W/4 and 3 px of noise. `case`: "in_range", as made;
    "out_of_range", a third of the x anywhere in [-3, 4] x W, and a few at
    the edges (-1e-9, the last column, +-1e30, half-pixels outside);
    "nan_coords", out_of_range's coords with NaN or +-inf in x at some
    positions and in y at others (y is never read); "bf16", out_of_range's
    coords on the levels in bf16."""
    import numpy as np
    import torch

    from rnnpose_tpu_torch.ops.corr import build_corr_pyramid_1d

    rs = np.random.RandomState(seed)
    f1, f2 = (torch.from_numpy(rs.randn(B, H, W, 32).astype(np.float32)).to(device)
              for _ in range(2))
    lv = list(build_corr_pyramid_1d(f1, f2, levels).levels)
    grid = np.stack(np.meshgrid(np.arange(W), np.arange(H), indexing="xy"), -1)
    xy = np.broadcast_to(grid[None], (B, H, W, 2)).astype(np.float32).reshape(-1, 2).copy()
    Q = xy.shape[0]
    xy[:, 0] -= (rs.uniform(0.0, W / 4.0, Q) + 3.0 * rs.randn(Q)).astype(np.float32)
    pick = rs.permutation(Q)
    if case != "in_range":
        n = Q // 3
        xy[pick[:n], 0] = rs.uniform(-3.0, 4.0, n) * W
        edges = np.float32([-1e-9, W - 1, 1e30, -1e30, W - 0.5, -0.5, -4.5, W + 3.5])
        xy[pick[n:n + len(edges)], 0] = edges
        rest = pick[n + len(edges):]
        if case == "nan_coords":
            bad = [np.nan, np.inf, -np.inf]
            for j, q in enumerate(rest[: max(Q // 10, 9)]):
                xy[q, j % 2] = bad[(j // 2) % 3]
        if case == "bf16":
            lv = [level.to(torch.bfloat16) for level in lv]
    return lv, torch.from_numpy(xy.reshape(B, H, W, 2)).to(device)


def lookup1d_bytes(Q, widths, radius=4):
    """One 1D lookup's bytes, each read once and each written once: every
    query's x, the 2r+2 f32 values of its row that its taps reach at each
    level (the level's width at most), its L (2r+1) f32 outputs."""
    return Q * (4 + sum(min(2 * radius + 2, w) * 4 for w in widths)
                + len(widths) * (2 * radius + 1) * 4)


def stereo_model(seed, device="cuda"):
    """RAFT-Stereo in the cell's precision (bf16 convolutions) on seeded
    weights (`benchmark/gen_flow.make_weights`), in eval mode."""
    from benchmark.gen_flow import make_weights
    from rnnpose_tpu_torch.models.raft_stereo import RAFTStereo, RAFTStereoConfig

    model = RAFTStereo(RAFTStereoConfig(mixed_precision=True)).to(device).eval()
    model.load_state_dict(make_weights(model, seed, device), strict=True)
    return model


def _stereo_phase(tag):
    """Phase 31 (see the module docstring)."""
    import torch

    from benchmark.gen_stereo import make_pairs
    from rnnpose_tpu_torch import kernels
    from rnnpose_tpu_torch.kernels import corr as corr_kernel
    from rnnpose_tpu_torch.models.engine import FlowEngine

    t0 = time.perf_counter()
    rows = {}
    radius = 4
    for B, H, W in STEREO_LOOKUP_SHAPES:
        gaps, launches = [], kernels.LAUNCHES["corr_lookup_1d"]
        for i, case in enumerate(STEREO_LOOKUP_CASES):
            lv, coords = stereo_lookup_problem(B, H, W, case, seed=B * 1000 + H + i)
            got = corr_kernel.corr_lookup_1d(lv, coords, radius)
            want = corr_kernel.corr_lookup_1d_plain(lv, coords, radius)
            torch.cuda.synchronize()
            both = torch.isfinite(got) & torch.isfinite(want)
            gaps.append(float((got - want)[both].abs().max()))
            if not same_bits(got, want):
                raise AssertionError(f"phase 31 lookup {B}x{H}x{W} {case}: the kernel differs "
                                     f"from the plain version (max|d| where finite {gaps[-1]})")
        if kernels.LAUNCHES["corr_lookup_1d"] != launches + len(STEREO_LOOKUP_CASES):
            raise AssertionError(f"phase 31 lookup {B}x{H}x{W}: launches "
                                 f"{kernels.LAUNCHES['corr_lookup_1d'] - launches}")
        lv, coords = stereo_lookup_problem(B, H, W, seed=B * 1000 + H)
        us = _device_ms(lambda: corr_kernel.corr_lookup_1d(lv, coords, radius)) * 1e3
        plain_ms = _device_ms(lambda: corr_kernel.corr_lookup_1d_plain(lv, coords, radius),
                              iters=10)
        widths = [level.shape[-1] for level in lv]
        nbytes = lookup1d_bytes(B * H * W, widths, radius)
        bound_us = nbytes / HBM_BYTES_PER_S * 1e6
        rows[f"b{B}_{H}x{W}"] = {"us": us, "bound_us": bound_us, "bytes": nbytes,
                                 "plain_ms": plain_ms, "max_abs_err": max(gaps)}
        print(f"{tag} phase 31 lookup_1d B={B} {H}x{W}, widths {widths}, radius {radius}: "
              f"kernel {us:.3f} us a launch (bound {bound_us:.3f} us, {nbytes} bytes, "
              f"{100 * bound_us / us:.2f}% of it); the plain chain {plain_ms:.4f} ms; "
              f"{len(STEREO_LOOKUP_CASES)} cases {STEREO_LOOKUP_CASES} bit for bit, "
              f"max|kernel - plain| where finite {max(gaps):.3e}", flush=True)
        del lv, coords, got, want

    H, W = STEREO_FRAME
    model = stereo_model(31)
    gen = torch.Generator(device="cuda").manual_seed(31)
    pairs = [make_pairs(1, H, W, STEREO_MAX_DISP, 2.0, gen)[:2] for _ in range(2)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    engine = FlowEngine(model)
    t_cap = time.perf_counter()
    engine.prepare(*pairs[0], STEREO_ITERS)
    torch.cuda.synchronize()
    t_cap = time.perf_counter() - t_cap
    outs = [engine.flow(*p, STEREO_ITERS) for p in pairs]
    label, = engine.graph_nodes
    counters = engine.counters()
    launches = {op: n[label] for op, n in counters["kernel_launches"].items()}
    want = dict(dict.fromkeys(launches, 0), corr_lookup_1d=STEREO_ITERS, instance_norm=15)
    if launches != want:
        raise AssertionError(f"phase 31 stereo capture launches {launches}, expected {want}")
    n_pyr = counters["corr_pyramid_bytes"][label]
    if n_pyr != 4 * 504 * 720 * (720 + 360 + 180 + 90):
        raise AssertionError(f"phase 31 stereo pyramid bytes {n_pyr}")
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    with torch.no_grad():
        for p, out in zip(pairs, outs):
            eager = model(*p, STEREO_ITERS)
            if not (torch.equal(out.flow, eager.flow)
                    and torch.equal(out.flow_history, eager.flow_history)):
                raise AssertionError("phase 31 stereo: a replay differs from the eager forward")
    if (tuple(out.flow.shape) != (1, H, W, 1)
            or tuple(out.flow_history.shape) != (STEREO_ITERS, 1, 504, 720, 1)):
        raise AssertionError(f"phase 31 stereo shapes {tuple(out.flow.shape)} "
                             f"{tuple(out.flow_history.shape)}")
    del eager
    ms = []
    for _ in range(5):
        torch.cuda.synchronize()
        t = time.perf_counter()
        engine.flow(*pairs[0], STEREO_ITERS).flow.cpu()
        ms.append((time.perf_counter() - t) * 1e3)
    rows["engine"] = {"capture_s": t_cap, "request_ms": sorted(ms)[len(ms) // 2],
                      "nodes": engine.graph_nodes[label], "launches": launches,
                      "peak_gib": peak / 2 ** 30, "pyramid_bytes": n_pyr}
    print(f"{tag} phase 31 stereo {W}x{H} through FlowEngine, {STEREO_ITERS} iterations: "
          f"prepare (warm-ups, capture) {t_cap:.2f} s, {engine.graph_nodes[label]} graph nodes, "
          f"capture launches {launches}, pyramid {n_pyr} bytes, peak {peak / 2 ** 30:.3f} GiB; "
          f"two replays bit-equal to eager; request ms (call to host read) "
          f"{[round(m, 2) for m in ms]}", flush=True)
    del engine, model, outs, pairs
    torch.cuda.empty_cache()
    print(f"{tag} phase 31 wall {time.perf_counter() - t0:.2f} s", flush=True)
    return rows


def output_tensors(x, path=""):
    """{path: tensor} of the forward's outputs (nested dicts and
    NamedTuples); the engine tests compare outputs with it too."""
    import torch

    if isinstance(x, torch.Tensor):
        return {path: x}
    items = (x.items() if isinstance(x, dict)
             else zip(x._fields, x) if isinstance(x, tuple) and hasattr(x, "_fields") else ())
    return {k: v for name, sub in items for k, v in output_tensors(sub, f"{path}.{name}").items()}


def _pool_bytes(pool) -> int:
    """Bytes the caching allocator holds in the graph memory pool `pool`."""
    import torch

    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg.get("segment_pool_id", ())) == tuple(pool))


def _traced(fn, log_dir):
    """One call of fn under torch.profiler: parse_trace's summary (with
    `lm_step_events`, `corr_lookup_events` and `instance_norm_events`, the
    LM step, lookup and norm kernels' device events), the raster sweep's device events by kernel name
    and the graph launches."""
    from rnnpose_tpu_torch.tools import parse_trace
    from rnnpose_tpu_torch.utils import profiling

    with profiling.trace(log_dir):
        fn()
    agg = parse_trace.aggregate(log_dir)
    with open(agg["trace"]) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    sweeps = {}
    for e in events:
        if e.get("cat") == "kernel" and "culled_sweep_kernel" in e["name"]:
            key = "attrs" if "culled_sweep_kernel<true>" in e["name"] else "z/fid"
            sweeps[key] = sweeps.get(key, 0) + 1
    for key in NO_GRAD_KERNELS:
        agg[f"{key}_events"] = sum(1 for e in events if e.get("cat") == "kernel"
                                   and f"{key}_kernel" in e["name"])
    return agg, sweeps, agg["graph_launches"]


def _graph_phase(tag, dev, towers, scenes, reset_counts, counts):
    """Phase 26 (see the module docstring). Returns {kernel: its device
    events per replayed request} from the profiled replays."""
    import torch
    from rnnpose_tpu_torch.geometry.se3 import se3_expm
    from rnnpose_tpu_torch.models.engine import WARMUP_RUNS, InferenceEngine
    from rnnpose_tpu_torch.models.refiner import RefinerConfig
    from rnnpose_tpu_torch.models.rnnpose import (
        RNNPose, RNNPoseConfig, apply_parity_preset, init_random_)

    traced = _traced
    t_phase = time.perf_counter()
    cfg = RNNPoseConfig(refiner=RefinerConfig(**REFINER), **towers)
    gen = torch.Generator().manual_seed(26)
    per_replay = {}
    build = Path(__file__).resolve().parent / "rnnpose_tpu_torch" / "_build"
    with tempfile.TemporaryDirectory(dir=build) as trace_root:
        for mode, mcfg, kname, sweep in (
                ("serving", cfg, "zbuffer_sweep_rows_attrs", "attrs"),
                ("parity", apply_parity_preset(cfg), "zbuffer_sweep_tiled", "z/fid")):
            model = init_random_(RNNPose(mcfg), torch.Generator().manual_seed(14)).to(dev)
            engine = InferenceEngine(model)
            R, steps, looks = mcfg.refiner.render_iters, lm_steps(mcfg), lookups(mcfg)
            nrms = norms(mcfg)
            for B, n_time in ((1, N_GRAPH_B1), (8, N_GRAPH_B8)):
                scene, cls = scenes[B], f"{mode}_b{B}"
                label = f"{tag} phase 26 {mode} B={B}"
                # Distinct requests: a fresh small rigid jitter of the pose and
                # seeded noise on the image.
                reqs = [scene._replace(
                    T_init=se3_expm(torch.randn(B, 6, generator=gen) * 1e-3).to(dev)
                    @ scene.T_init,
                    image=(scene.image + 0.02 * torch.rand(scene.image.shape, generator=gen)
                           .to(dev)).clamp(0.0, 1.0)) for _ in range(GRAPH_REQS)]
                d3, c3 = engine.class_features(cls, scene.pyramid)
                torch.cuda.synchronize()
                reset_counts()
                t0 = time.perf_counter()
                engine.prepare(cls, reqs[0])
                torch.cuda.synchronize()
                capture_s = time.perf_counter() - t0
                capture_launches, capture_ok = counts(
                    **{kname: (WARMUP_RUNS + 1) * R, "lm_step": (WARMUP_RUNS + 1) * steps,
                       "corr_lookup": (WARMUP_RUNS + 1) * looks,
                       "instance_norm": (WARMUP_RUNS + 1) * nrms})
                # The LM and lookup launches made while capturing: one graph
                # node each.
                captured = engine.counters()["kernel_launches"]
                captured_lm = list(captured["lm_step"].values())
                captured_look = list(captured["corr_lookup"].values())
                captured_norm = list(captured["instance_norm"].values())
                pool = _pool_bytes(engine._pool)

                reset_counts()
                outs = [engine.refine(cls, reqs[0])]
                first = {k: v.clone() for k, v in output_tensors(outs[0]).items()}
                outs += [engine.refine(cls, r) for r in reqs[1:]]
                torch.cuda.synchronize()
                replay_launches, replay_ok = counts(lm_step=0, corr_lookup=0, instance_norm=0)
                worst, n_keys = 0.0, 0
                for r, out in zip(reqs, outs):
                    got, eager = output_tensors(out), output_tensors(
                        model(r, cached_desc3d=d3, cached_ctx3d=c3))
                    if got.keys() != eager.keys():
                        raise AssertionError(f"{label}: outputs {sorted(got)} vs {sorted(eager)}")
                    n_keys = len(got)
                    for k in got:
                        worst = max(worst, float((got[k].double() - eager[k].double())
                                                 .abs().max()) if got[k].numel() else 0.0)
                kept = all(torch.equal(first[k], v) for k, v in output_tensors(outs[0]).items())
                distinct = all(not torch.equal(outs[i]["Ti_pred"], outs[j]["Ti_pred"])
                               for i in range(len(outs)) for j in range(i))
                print(f"{label}: capture {capture_s:.3f} s (warm-ups {WARMUP_RUNS}; launches "
                      f"{capture_launches}, expected {kname} {(WARMUP_RUNS + 1) * R} and "
                      f"lm_step {(WARMUP_RUNS + 1) * steps}, corr_lookup "
                      f"{(WARMUP_RUNS + 1) * looks}; the engine's lm_step launches per graph "
                      f"{captured_lm}, expected {steps} each, and corr_lookup launches "
                      f"{captured_look}, expected {looks} each, and instance_norm launches "
                      f"{captured_norm}, expected {nrms} each), graph "
                      f"captures {engine.graph_captures}, graph pool {pool / 2**30:.3f} GiB "
                      f"(reserved on the card {torch.cuda.memory_reserved(dev) / 2**30:.3f} "
                      f"GiB); {len(reqs)} distinct requests: replay vs eager max|delta| "
                      f"{worst:.3e} over {n_keys} outputs each (limit 0); request 1's outputs "
                      f"unchanged after the later ones: {kept}; launches in the replays "
                      f"{replay_launches} (expected none)", flush=True)
                if (not capture_ok or not replay_ok or worst != 0.0 or not kept
                        or not distinct or engine.graph_captures != (1 if B == 1 else 2)
                        or captured_lm != [steps] * engine.graph_captures
                        or captured_look != [looks] * engine.graph_captures
                        or captured_norm != [nrms] * engine.graph_captures):
                    raise AssertionError(f"{label}: the replayed program differs from the "
                                         "eager forward, or wrong launches or captures")

                # ms/request of the replay and of the eager forward, in turns.
                times = {"replay": [], "eager": []}
                for i in range(n_time):
                    r = reqs[i % len(reqs)]
                    for way, fn in (("replay", lambda: engine.refine(cls, r)),
                                    ("eager", lambda: model(r, cached_desc3d=d3,
                                                            cached_ctx3d=c3))):
                        torch.cuda.synchronize()
                        t0 = time.perf_counter()
                        fn()
                        torch.cuda.synchronize()
                        times[way].append((time.perf_counter() - t0) * 1e3)
                med = {w: sorted(v)[len(v) // 2] for w, v in times.items()}
                spread = {w: 100 * (max(v) - min(v)) / med[w] for w, v in times.items()}
                print(f"{label}: ms/request over {n_time} requests in turns: replay median "
                      f"{med['replay']:.3f} (spread {spread['replay']:.1f}%), eager median "
                      f"{med['eager']:.3f} (spread {spread['eager']:.1f}%); eager/replay "
                      f"{med['eager'] / med['replay']:.2f}x", flush=True)

                # One replayed request and one eager one under torch.profiler.
                rep, rep_sweeps, rep_graphs = traced(
                    lambda: engine.refine(cls, reqs[1]), os.path.join(trace_root, f"{cls}_r"))
                eag, _, _ = traced(lambda: model(reqs[1], cached_desc3d=d3, cached_ctx3d=c3),
                                   os.path.join(trace_root, f"{cls}_e"))
                print(f"{label} profile of one request, replay vs eager: device events "
                      f"{rep['device_events']} vs {eag['device_events']}, device ms "
                      f"{rep['device_ms']:.3f} vs {eag['device_ms']:.3f}, kernel-launch API "
                      f"calls {rep['launches']} vs {eag['launches']}, cudaGraphLaunch "
                      f"{rep_graphs}, host ops {rep['host_ops']} vs {eag['host_ops']}, traced "
                      f"span ms {rep['span_ms']:.3f} vs {eag['span_ms']:.3f}; raster sweep "
                      f"device events in the replay {rep_sweeps} (expected {sweep} {R}); LM "
                      f"step kernel device events {rep['lm_step_events']} vs "
                      f"{eag['lm_step_events']} (expected {steps} each); lookup kernel "
                      f"device events {rep['corr_lookup_events']} vs "
                      f"{eag['corr_lookup_events']} (expected {looks} each); norm kernel "
                      f"device events {rep['instance_norm_events']} vs "
                      f"{eag['instance_norm_events']} (expected {nrms} each)", flush=True)
                if (rep_sweeps != {sweep: R} or rep_graphs != 1
                        or rep["lm_step_events"] != steps or eag["lm_step_events"] != steps
                        or rep["corr_lookup_events"] != looks
                        or eag["corr_lookup_events"] != looks
                        or rep["instance_norm_events"] != nrms
                        or eag["instance_norm_events"] != nrms):
                    raise AssertionError(f"{label}: the replay ran the raster kernel "
                                         f"{rep_sweeps} times, the LM step kernel "
                                         f"{rep['lm_step_events']}, the lookup kernel "
                                         f"{rep['corr_lookup_events']}, the norm kernel "
                                         f"{rep['instance_norm_events']}, {rep_graphs} graph "
                                         "launches")
                per_replay[kname] = rep_sweeps[sweep]
                per_replay["lm_step"] = rep["lm_step_events"]
                per_replay["corr_lookup"] = rep["corr_lookup_events"]
                per_replay["instance_norm"] = rep["instance_norm_events"]
            del engine, model, outs
            torch.cuda.empty_cache()
    print(f"{tag} phase 26 wall {time.perf_counter() - t_phase:.2f} s", flush=True)
    return per_replay


def _jittered(scene, n, gen):
    """n distinct batches of `scene`: each a fresh small rigid jitter of the
    initial pose and seeded noise on the image."""
    import torch
    from rnnpose_tpu_torch.geometry.se3 import se3_expm

    dev, B = scene.image.device, scene.image.shape[0]
    return [scene._replace(
        T_init=se3_expm(torch.randn(B, 6, generator=gen) * 1e-3).to(dev) @ scene.T_init,
        image=(scene.image + 0.02 * torch.rand(scene.image.shape, generator=gen).to(dev))
        .clamp(0.0, 1.0)) for _ in range(n)]


def _train_state(model, opt):
    """Copies of what a training step updates: parameters, moments, count."""
    return {"params": {n: p.detach().clone() for n, p in model.named_parameters()},
            "m": [m.clone() for m in opt.m], "v": [v.clone() for v in opt.v],
            "count": opt.count.clone()}


def _device_families(trace):
    """Device events of a Chrome trace counted by `parse_trace.family`."""
    import collections

    from rnnpose_tpu_torch.tools import parse_trace

    with open(trace) as f:
        events = json.load(f)["traceEvents"]
    return collections.Counter(parse_trace.family(e["name"]) for e in events
                               if e.get("ph") == "X" and e.get("cat") in parse_trace.DEVICE_CATS)


def _train_graph_phase(tag, dev, towers, scenes, reset_counts, counts):
    """Phase 27 (see the module docstring). Returns the rows-attrs kernel's
    device events per replayed training step."""
    import copy

    import torch
    from rnnpose_tpu_torch.models.refiner import RefinerConfig
    from rnnpose_tpu_torch.models.rnnpose import RNNPose, RNNPoseConfig, init_random_
    from rnnpose_tpu_torch.train.loop import WARMUP_RUNS, Trainer, make_train_step
    from rnnpose_tpu_torch.train.optim import OptimizerConfig, build_optimizer

    t_phase = time.perf_counter()
    cfg = RNNPoseConfig(refiner=RefinerConfig(**REFINER), **towers)
    R = cfg.refiner.render_iters
    gen = torch.Generator().manual_seed(27)
    per_replay = None
    build = Path(__file__).resolve().parent / "rnnpose_tpu_torch" / "_build"

    def pair(seed):
        """A trainer and, on a deep copy of its model, the eager step."""
        model = init_random_(RNNPose(cfg), torch.Generator().manual_seed(seed)).to(dev)
        twin = copy.deepcopy(model)
        opt = build_optimizer(OptimizerConfig(), twin)
        return Trainer(model, OptimizerConfig()), twin, opt, make_train_step(twin, opt)

    with tempfile.TemporaryDirectory(dir=build) as trace_root:
        for B, n_time in ((1, N_TRAIN_GRAPH_B1), (8, N_TRAIN_GRAPH_B8)):
            label = f"{tag} phase 27 B={B}"
            batches = _jittered(scenes[B], WARMUP_RUNS + TRAIN_GRAPH_REPLAYS, gen)

            # Replayed steps against eager ones, bitwise, from the same state.
            torch.use_deterministic_algorithms(True)
            try:
                trainer, twin, opt, eager = pair(27)
                reset_counts()
                got = []
                for i, b in enumerate(batches):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    got.append(trainer.run_step(b))
                    torch.cuda.synchronize()
                    if i == WARMUP_RUNS:
                        capture_s = time.perf_counter() - t0
                        capture_launches, capture_ok = counts(
                            zbuffer_sweep_rows_attrs=(WARMUP_RUNS + 1) * R, lm_step=0,
                            corr_lookup=0)
                        reset_counts()
                replay_launches, replay_ok = counts(lm_step=0, corr_lookup=0)
                pool = _pool_bytes(trainer._pool)
                want = [eager(b) for b in batches]
                d_metrics = max(_max_delta(g, w) for g, w in zip(got, want))
                mine = _train_state(trainer.model, trainer.state.optimizer)
                d_state = _max_delta(mine, _train_state(twin, opt))
                # A NaN batch: both skip it and keep their state bit for bit.
                bad = batches[-1]._replace(image=torch.full_like(batches[-1].image, float("nan")))
                nan_g, nan_e = trainer.run_step(bad), eager(bad)
                skipped = (float(nan_g["skipped_nonfinite"]), float(nan_e["skipped_nonfinite"]))
                d_nan = max(_max_delta(_train_state(trainer.model, trainer.state.optimizer),
                                       mine),
                            _max_delta(_train_state(twin, opt), mine))
                count = int(trainer.state.optimizer.count)
            finally:
                torch.use_deterministic_algorithms(False)
            print(f"{label} (deterministic): {WARMUP_RUNS} eager warm-up steps, then the "
                  f"step that captures and replays: {capture_s:.3f} s; launches in the "
                  f"warm-ups and the capture {capture_launches} (expected rows-attrs "
                  f"{(WARMUP_RUNS + 1) * R}); graph pool {pool / 2**30:.3f} GiB (reserved on "
                  f"the card {torch.cuda.memory_reserved(dev) / 2**30:.3f} GiB); graph captures "
                  f"{trainer.graph_captures}; launches in the {TRAIN_GRAPH_REPLAYS - 1} later "
                  f"replays {replay_launches} (expected none); {len(batches)} distinct batches "
                  f"against make_train_step on a deep copy: max|delta| over loss and metrics "
                  f"{d_metrics:.3e}, over parameters, moments and count {d_state:.3e} (limit "
                  f"0; count {count}); NaN batch: skipped_nonfinite replay/eager {skipped}, "
                  f"state change {d_nan:.3e} (limit 0)", flush=True)
            if (not capture_ok or not replay_ok or d_metrics != 0.0 or d_state != 0.0
                    or skipped != (1.0, 1.0) or d_nan != 0.0 or count != len(batches)
                    or trainer.graph_captures != 1):
                raise AssertionError(f"{label}: the replayed step differs from the eager "
                                     "step, or wrong launches or captures")
            del trainer, twin, opt, eager, got, want, mine, nan_g, nan_e
            torch.cuda.empty_cache()

            # ms/step in the default mode: a trainer captured in it, in turns
            # with the eager step.
            trainer, twin, opt, eager = pair(28)
            for b in batches[:WARMUP_RUNS + 1]:
                trainer.run_step(b)
                eager(b)
            times = {"replay": [], "eager": []}
            for i in range(n_time):
                b = batches[i % len(batches)]
                for way, fn in (("replay", lambda: trainer.run_step(b)),
                                ("eager", lambda: eager(b))):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    fn()
                    torch.cuda.synchronize()
                    times[way].append((time.perf_counter() - t0) * 1e3)
            med = {w: sorted(v)[len(v) // 2] for w, v in times.items()}
            spread = {w: 100 * (max(v) - min(v)) / med[w] for w, v in times.items()}
            print(f"{label}: ms/step over {n_time} steps in turns: replay median "
                  f"{med['replay']:.3f} (spread {spread['replay']:.1f}%), eager median "
                  f"{med['eager']:.3f} (spread {spread['eager']:.1f}%); eager/replay "
                  f"{med['eager'] / med['replay']:.2f}x", flush=True)

            # One replayed step and one eager step under torch.profiler.
            b = batches[1]
            rep, rep_sweeps, rep_graphs = _traced(lambda: trainer.run_step(b),
                                                  os.path.join(trace_root, f"b{B}_r"))
            eag, eag_sweeps, _ = _traced(lambda: eager(b), os.path.join(trace_root, f"b{B}_e"))
            # A replay runs the eager step's device work (a graph may run a
            # copy or a fill as a kernel) plus the copies of the batch into
            # its buffers and of the metrics out; the bitwise check above is
            # what proves every kernel is in the graph, this count is read
            # beside it (within 1%: a graph without the backward would run
            # about half the eager step's events).
            prog, = trainer._programs.values()
            copies = sum(t is not None for t in prog.buffers) + len(prog.metrics)
            by_family = [_device_families(agg["trace"]) for agg in (rep, eag)]
            differ = sorted((f for f in by_family[0].keys() | by_family[1].keys()
                             if by_family[0][f] != by_family[1][f]),
                            key=lambda f: -abs(by_family[0][f] - by_family[1][f]))
            print(f"{label} profile of one step, replay vs eager: device events "
                  f"{rep['device_events']} vs {eag['device_events']} (expected eager + "
                  f"{copies} copies), device ms "
                  f"{rep['device_ms']:.3f} vs {eag['device_ms']:.3f}, idle share of the traced "
                  f"span {1 - rep['device_ms'] / rep['span_ms']:.4f} vs "
                  f"{1 - eag['device_ms'] / eag['span_ms']:.4f}, of the median step "
                  f"{1 - rep['device_ms'] / med['replay']:.4f} vs "
                  f"{1 - eag['device_ms'] / med['eager']:.4f}, kernel-launch API calls "
                  f"{rep['launches']} vs {eag['launches']}, cudaGraphLaunch {rep_graphs}, host "
                  f"ops {rep['host_ops']} vs {eag['host_ops']}, traced span ms "
                  f"{rep['span_ms']:.3f} vs {eag['span_ms']:.3f}; rows-attrs device events "
                  f"{rep_sweeps} vs {eag_sweeps} (expected attrs {R}); device events by "
                  f"family where they differ, replay vs eager: "
                  f"{ {f: (by_family[0][f], by_family[1][f]) for f in differ[:10]} }",
                  flush=True)
            if (rep_sweeps != {"attrs": R} or eag_sweeps != {"attrs": R} or rep_graphs != 2
                    or rep["launches"] != 0 or abs(rep["device_events"] - copies
                                                   - eag["device_events"])
                    > 0.01 * eag["device_events"]):
                raise AssertionError(f"{label}: the replay launched {rep['launches']} kernels "
                                     f"from the host, {rep_graphs} graphs, rows-attrs "
                                     f"{rep_sweeps}, device events {rep['device_events']}")
            per_replay = rep_sweeps["attrs"]
            del trainer, twin, opt, eager
            torch.cuda.empty_cache()
    print(f"{tag} phase 27 wall {time.perf_counter() - t_phase:.2f} s", flush=True)
    return per_replay


def _profile_phase(tag, dev, trace_root):
    """Phase 16: `tools/profile_components` at full width, B=1 and B=8, each
    with `--trace trace_root/components_b<B>` (phase 22 reads them)."""
    from rnnpose_tpu_torch.tools import profile_components

    t0 = time.perf_counter()
    for B in (1, 8):
        trace_flag = ["--trace", os.path.join(trace_root, f"components_b{B}")]
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
    import torch

    # The tests' process shares the card with this one and the learning
    # check's: hand back what this one's allocator keeps cached.
    torch.cuda.empty_cache()
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
    Returns the kernel launches of the card's side and the tool's summary."""
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
    return launches, summary


def _rounding_phase(tag, dev, numerics):
    """Phase 25: the port's rounding forms (`geometry/precise.py`) give the
    same bits on the card `dev` as on the CPU. `numerics` is phase 20's
    summary."""
    import numpy as np
    import torch

    from rnnpose_tpu_torch.geometry import crop as crop_lib
    from rnnpose_tpu_torch.geometry import projective as proj
    from rnnpose_tpu_torch.geometry import se3 as se3_lib
    from rnnpose_tpu_torch.geometry.precise import fma, recip
    from rnnpose_tpu_torch.models.refiner import MeshAssets, zoom_crop
    from rnnpose_tpu_torch.ops.sampler import bilinear_sample
    from rnnpose_tpu_torch.render import raster as raster_mod
    from rnnpose_tpu_torch.tools import full_budget_rehearsal
    from rnnpose_tpu_torch.train.optim import safe_clip_by_global_norm

    t0 = time.perf_counter()
    cpu = torch.device("cpu")
    rs = np.random.RandomState(0)
    sc = full_budget_rehearsal.build_scene(SCENE["image_size"], SCENE["subdivisions"],
                                           SCENE["num_verts"], SCENE["num_faces"])

    def on(d, a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(d)

    def zoom(d):
        mesh = MeshAssets(verts=on(d, sc["verts"]), faces=on(d, sc["faces"].astype(np.int64)),
                          colors=on(d, sc["colors"]), vert_valid=on(d, sc["vert_valid"]),
                          face_valid=on(d, sc["face_valid"]))
        h = sc["image"].shape[1]
        return zoom_crop(on(d, sc["T_init"]), mesh, on(d, sc["K"]), h, h, CROP, 0.4)

    def face_setup(d):
        verts_cam, _, K = zoom(d)
        uv, _ = proj.project(verts_cam, K[:, None, :])
        ec, _, valid, area2, _ = raster_mod._face_screen_data(
            uv, verts_cam[..., 2], on(d, sc["faces"].astype(np.int64)),
            on(d, sc["face_valid"]))
        return uv, ec, valid.float(), area2

    def taylor(d, t2):
        home = sys.modules[se3_lib._A.__module__]  # the switch's (kernels/geometry)
        threshold = home._TAYLOR_THETA2
        home._TAYLOR_THETA2 = 1.0  # seeded small angles take the series
        try:
            return [f(on(d, t2)) for f in (se3_lib._A, se3_lib._B, se3_lib._C)]
        finally:
            home._TAYLOR_THETA2 = threshold

    def clip(d, g):
        grads = [on(d, g)]
        norm = safe_clip_by_global_norm(grads, 10.0)
        return [norm, grads[0]]

    a, b, c = (rs.randn(3, 1 << 16).astype(np.float32) * 100.0)
    coords = (rs.rand(8, 60, 60, 2) * 260 - 10).astype(np.float32)
    crop_params = zoom(cpu)[1].numpy()
    pts = np.concatenate([rs.randn(8, 4096, 2) * 0.05, 0.4 + 0.1 * rs.rand(8, 4096, 1)], -1)
    K8 = np.tile(np.array([[701.8568, 701.8568, 113.843575, 123.654785]], np.float32), (8, 1))
    img = rs.rand(8, 60, 50, 32).astype(np.float32)
    taps = (rs.rand(8, 30, 30, 2) * 70 - 5).astype(np.float32)
    cases = {
        "fma": lambda d: fma(on(d, a), on(d, b), on(d, c)),
        "zoom crop (verts_cam, crop_params, K_crop)": zoom,
        "face setup (uv, a b c, valid, area2)": face_setup,
        "crop_source_coords 240": lambda d: crop_lib.crop_source_coords(on(d, crop_params), 240),
        "crop_source_coords 30": lambda d: crop_lib.crop_source_coords(on(d, crop_params), 30),
        "normalize_coords 240^2": lambda d: proj.normalize_coords(on(d, coords), 240, 240),
        "project + jacobian": lambda d: proj.project(on(d, pts.astype(np.float32)),
                                                     on(d, K8)[:, None], True),
        "se3 Taylor branches A, B, C": lambda d: taylor(
            d, (rs.rand(4096) * 0.5).astype(np.float32)),
        "bilinear_sample": lambda d: bilinear_sample(on(d, img), on(d, taps)),
        "clip factor (max_norm / norm)": lambda d: clip(
            d, (rs.rand(1) * 1e3 + 10).astype(np.float32)),
    }
    failed = []
    for name, fn in cases.items():
        state = rs.get_state()  # the same seeded draws on both devices
        with torch.no_grad():
            ref = [x for x in _flat(fn(cpu))]
            rs.set_state(state)
            got = [x.cpu() for x in _flat(fn(dev))]
        n = sum(x.numel() for x in ref)
        differ = sum(int((r.view(torch.int32) != g.view(torch.int32)).sum()) if r.dtype ==
                     torch.float32 else int((r != g).sum()) for r, g in zip(ref, got))
        err = max(float((r.double() - g.double()).abs().max()) for r, g in zip(ref, got))
        print(f"{tag} phase 25 rounding {name}: max|cuda - cpu| {err:.3e}, elements "
              f"differing {differ} of {n}", flush=True)
        if differ:
            failed.append(name)

    # How torch divides on each device, at the sites the forms replace.
    x = on(cpu, (rs.rand(1 << 20) * 300 + 0.5).astype(np.float32))
    xd = x.to(dev)
    for k in (6.0, 239.0):
        by_recip = int((xd / k != xd * recip(k)).sum())
        vs_cpu = int(((xd / k).cpu() != x / k).sum())
        over = int(((k / xd).cpu() != torch.full_like(x, k) / x).sum())
        print(f"{tag} phase 25 torch division on the card, c = {k:g}: x / c differs from "
              f"x * f32(1/c) at {by_recip}, from the CPU's x / c at {vs_cpu}; c / x differs "
              f"from the correctly rounded quotient at {over} of {x.numel()}", flush=True)
    for op in ("se3_expm", "se3_logm(expm)", "se3_inverse", "se3_increment (expm @ T)",
               "LM reprojection_optim"):
        how = ("the LM step kernel on the card, its plain version on the CPU; the plain "
               "chain on both read" if op.startswith("LM") else "earlier reading")
        print(f"{tag} phase 25 phase 20's {op}: max|cuda - cpu| "
              f"{numerics['ops'][op]['max_abs']:.3e} ({how} at most 1.192e-07, PERF.md)",
              flush=True)
    print(f"{tag} phase 25 wall {time.perf_counter() - t0:.2f} s", flush=True)
    if failed:
        raise AssertionError(f"phase 25: card and CPU round differently in {failed}")


def _flat(x):
    """The tensors of a tensor, or of a (nested) list or tuple of them."""
    import torch

    if isinstance(x, torch.Tensor):
        return [x]
    return [t for item in x if item is not None for t in _flat(item)]


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
                  f"{agg['launches']}, graph launches {agg['graph_launches']}, host ops "
                  f"{agg['host_ops']}, traced span "
                  f"{agg['span_ms']:.3f} ms; top families: "
                  + "; ".join(f"{k} {v:.3f}" for k, v in agg["per_family"].most_common(10))
                  + "; top host ops: "
                  + "; ".join(f"{k} {v:.3f}" for k, v in agg["per_host_op"].most_common(10)),
                  flush=True)
            # A replayed training step (phase 16's `train`) launches graphs.
            if agg["device_events"] == 0 or agg["launches"] + agg["graph_launches"] == 0:
                raise AssertionError(f"phase 22: trace {label} holds no device work")
    if not {"eager_b1", "artifact_b1", "components_b1", "components_b8"} <= set(names):
        raise AssertionError(f"phase 22: traces {names}")


OVERFIT_CHILD = "--overfit_child"


def _overfit_child() -> int:
    """`python3 chip_smoke.py --overfit_child`: phase 23's run of
    `tools/overfit_check`, in a process of its own; its last stdout line is
    a JSON object: the two ADDs, the losses, the wall seconds and the kernel
    launches counted in this process."""
    from rnnpose_tpu_torch import kernels
    from rnnpose_tpu_torch.tools import overfit_check

    kernels.LAUNCHES.clear()
    t0 = time.perf_counter()
    init_add, ref_add, losses = overfit_check.main(["--eval_mode", "heldout", "--steps",
                                                    str(OVERFIT_STEPS)])
    print(json.dumps({"init_add": init_add, "ref_add": ref_add,
                      "losses": [float(x) for x in losses],
                      "wall": time.perf_counter() - t0,
                      "launches": {k: kernels.LAUNCHES[k] for k in (*KERNELS, *NO_GRAD_KERNELS)}}),
          flush=True)
    return 0


def _overfit_start(root):
    """Start phase 23's process; its output goes to a file in `root`.
    Returns (process, log file)."""
    log = open(os.path.join(root, "overfit_check.log"), "w+")
    proc = subprocess.Popen([sys.executable, os.path.abspath(__file__), OVERFIT_CHILD],
                            cwd=Path(__file__).resolve().parent, stdout=log,
                            stderr=subprocess.STDOUT, text=True)
    return proc, log


def _overfit_phase(tag, proc, log):
    """Phase 23: `tools/overfit_check --eval_mode heldout --steps 160` at its
    defaults, in the process `_overfit_start` started; ratio < 0.7 and
    loss_last50 < 0.7 loss_first50, the JAX package's checks
    (tests/test_viewpoint_health.py). Prints the process's output, then the
    result. Returns the launches."""
    rc = proc.wait(timeout=OVERFIT_TIMEOUT_S)
    log.seek(0)
    text = log.read()
    print(text, end="" if text.endswith("\n") else "\n", flush=True)
    if rc != 0:
        raise AssertionError(f"phase 23: overfit_check exited {rc}")
    res = _last_json(text, "overfit_check")
    init_add, ref_add, losses, wall = (res["init_add"], res["ref_add"], res["losses"],
                                       res["wall"])
    # 3 render iterations per training step launched from Python (the
    # trainer's WARMUP_RUNS eager steps and its capture; its replays launch
    # nothing) and per held-out eval frame, each through `rasterize` (the
    # full-res LM's barycentrics); the eval forward also renders the fused
    # colour and 1/8-grid features.
    from rnnpose_tpu_torch.train.loop import WARMUP_RUNS

    expect = {"zbuffer_sweep_tiled": 3 * (min(OVERFIT_STEPS, WARMUP_RUNS + 1) + 8),
              "zbuffer_sweep_rows_attrs": 3 * 8}
    launches = res["launches"]
    ok = {k: launches[k] for k in KERNELS} == {k: expect.get(k, 0) for k in KERNELS}
    first, last = sum(losses[:50]) / 50, sum(losses[-50:]) / 50
    ratio = ref_add / init_add
    print(f"{tag} phase 23 overfit_check heldout {OVERFIT_STEPS} steps: ADD init "
          f"{init_add * 1e3:.3f} mm, refined {ref_add * 1e3:.3f} mm, ratio {ratio:.4f} (limit "
          f"0.7); loss first50 {first:.4f}, last50 {last:.4f} ({last / first:.4f} of the first, "
          f"limit 0.7); kernel launches {launches} (expected {expect}); wall {wall:.2f} s in "
          f"its own process, beside phases 15 and 17-22", flush=True)
    if not (ratio < 0.7 and last < 0.7 * first and ok):
        raise AssertionError(f"phase 23: ratio {ratio}, losses {first} -> {last}, launches "
                             f"{launches}")
    return launches


def _fps_phase(tag, reset_counts, counts, fixture):
    """Phase 24: `tools/measure_fps` at B=1 and B=8 (bench.py's protocol and
    operating point, chains of FPS_FRAMES), then `tools/budget_frontier` over phase 13's dataset
    and its B=1 run's checkpoint. Returns the launches."""
    from rnnpose_tpu_torch.models.engine import WARMUP_RUNS
    from rnnpose_tpu_torch.tools import budget_frontier
    from rnnpose_tpu_torch.tools.measure_fps import measure_fps
    from rnnpose_tpu_torch.train import checkpoint as ckpt_lib

    t0 = time.perf_counter()
    reset_counts()
    for B in (1, 8):
        fps, gflops, reps = measure_fps(B, frames=FPS_FRAMES)
        print(f"{tag} phase 24 measure_fps B={B}: best {fps:.3f} fps ({1e3 * B / fps:.3f} ms per "
              f"request), repeats {', '.join(f'{r:.3f}' for r in reps)} fps, spread "
              f"{100 * (max(reps) - min(reps)) / max(reps):.2f}%; FlopCounterMode GFLOPs per "
              f"frame {gflops:.3f}", flush=True)
    # Per B: one render of the synthetic scene, then render_iters (3) per
    # eager forward: the one FlopCounterMode counts, the engine's warm-ups
    # and its capture; the chains replay the graph and launch nothing.
    per_b = 1 + WARMUP_RUNS + 1  # eager forwards per batch size
    fps_launches, fps_ok = counts(zbuffer_sweep_rows_attrs=2 * (1 + 3 * per_b))
    cfg_path = os.path.join(fixture, "b1.json")
    ckpt = ckpt_lib.latest_checkpoint(os.path.join(fixture, "b1"))
    rows = budget_frontier.main(["--config_path", cfg_path, "--ckpt_path", ckpt, "--grid",
                                 FRONTIER_GRID, "--max_frames", "8", "--fps_frames",
                                 str(FRONTIER_FPS_FRAMES)])
    # Per grid point R x G: R per eager forward, the eval's warm-ups and
    # capture (one class at B=1; its 8 frames replay) and both batch sizes'
    # as above, and each batch size's scene render.
    expect = fps_launches["zbuffer_sweep_rows_attrs"] + sum(
        int(p.split("x")[0]) * (WARMUP_RUNS + 1 + 2 * per_b) + 2
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
    t_start = time.perf_counter()
    from rnnpose_tpu_torch import kernels
    from rnnpose_tpu_torch.cpp import native
    from rnnpose_tpu_torch.data.synthetic import (
        SyntheticConfig, kpconv_config, make_synthetic_inputs)
    from rnnpose_tpu_torch.models.engine import WARMUP_RUNS, InferenceEngine
    from rnnpose_tpu_torch.geometry.se3 import se3_expm
    from rnnpose_tpu_torch.models.refiner import RefinerConfig, backface_keep
    from rnnpose_tpu_torch.models.rnnpose import (
        RNNPose, RNNPoseConfig, apply_parity_preset, init_random_)
    from rnnpose_tpu_torch.kernels import raster as rk
    from rnnpose_tpu_torch.render import raster as raster_mod
    from rnnpose_tpu_torch.render.raster import rasterize
    from rnnpose_tpu_torch.train import checkpoint as ckpt_lib
    from rnnpose_tpu_torch.train.loop import Trainer, make_train_step
    from rnnpose_tpu_torch.train.optim import OptimizerConfig

    dev = _device()
    name = torch.cuda.get_device_name(0)
    smi = _smi()
    tag = f"[{name} | {smi}]"
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on {tag}", flush=True)

    def reset_counts():
        kernels.LAUNCHES.clear()

    def counts(**expect):
        """The launch counts of every kernel, and whether each raster
        kernel's is as given (others 0), and the LM step's and the lookup's
        too where given (the phases that serve or train give them)."""
        got = {k: kernels.LAUNCHES[k] for k in (*KERNELS, *NO_GRAD_KERNELS)}
        want = {k: expect.get(k, 0) for k in KERNELS}
        want.update({k: expect[k] for k in NO_GRAD_KERNELS if k in expect})
        return got, all(got[k] == v for k, v in want.items())

    # 1. Build the three sources and the native host ops at once.
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(kernels.SOURCES) + 1) as pool:
        host = pool.submit(native.build)
        libs = list(pool.map(lambda s: kernels.build.build_kernel(s, verbose=True),
                             kernels.SOURCES))
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

    # 28. The LM step kernel against its plain version, and its time.
    lm_rows = _lm_phase(tag)

    # 29. The correlation lookup kernel against its plain version, and its
    # time.
    lookup_rows = _lookup_phase(tag)

    # 30. The instance norm kernel against its plain version, and its time.
    norm_rows = _norm_phase(tag)

    # 31. RAFT-Stereo's 1D lookup kernel against its plain version, and the
    # model through its engine at Middlebury's frame.
    stereo_rows = _stereo_phase(tag)

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
    lm_expect = lm_steps(cfg) * (N_REQ_B1 + N_REQ_B8)
    look_expect = lookups(cfg) * (N_REQ_B1 + N_REQ_B8)
    norm_expect = norms(cfg) * (N_REQ_B1 + N_REQ_B8)
    serving_launches, ok = counts(zbuffer_sweep_rows_attrs=expect, lm_step=lm_expect,
                                  corr_lookup=look_expect, instance_norm=norm_expect,
                                  corr_lookup_1d=0)
    print(f"{tag} phase 4 serving B=1: {ms_req1:.3f} ms/request, "
          f"{ms_f1:.3f} ms/frame over {N_REQ_B1} requests", flush=True)
    print(f"{tag} phase 4 serving B=8: {ms_req8:.3f} ms/request, "
          f"{ms_f8:.3f} ms/frame over {N_REQ_B8} requests", flush=True)
    print(f"{tag} phase 4 kernel launches {serving_launches} "
          f"(expected rows-attrs {expect}, lm_step {lm_expect}, corr_lookup {look_expect}, "
          f"instance_norm {norm_expect}, corr_lookup_1d 0, others 0)", flush=True)
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
    plm_expect = lm_steps(parity_cfg) * (N_PAR_B1 + N_PAR_B8)
    plook_expect = lookups(parity_cfg) * (N_PAR_B1 + N_PAR_B8)
    pnorm_expect = norms(parity_cfg) * (N_PAR_B1 + N_PAR_B8)
    parity_launches, ok = counts(zbuffer_sweep_tiled=pexpect, lm_step=plm_expect,
                                 corr_lookup=plook_expect, instance_norm=pnorm_expect,
                                 corr_lookup_1d=0)
    for B, ms_req, ms_f, n, peak in ((1, pms_req1, pms_f1, N_PAR_B1, peak1),
                                     (8, pms_req8, pms_f8, N_PAR_B8, peak8)):
        print(f"{tag} phase 7 parity serving B={B}: {ms_req:.3f} ms/request, "
              f"{ms_f:.3f} ms/frame over {n} requests; peak device memory "
              f"{peak / 2**30:.3f} GiB", flush=True)
    print(f"{tag} phase 7 kernel launches {parity_launches} "
          f"(expected zbuffer_sweep_tiled {pexpect}, lm_step {plm_expect}, corr_lookup "
          f"{plook_expect}, instance_norm {pnorm_expect}, corr_lookup_1d 0, others 0)",
          flush=True)
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

        # The first request of each class computes its features and captures
        # its program: the kernel launches from Python in the warm-ups and
        # the capture, and never in a replay.
        capture = (WARMUP_RUNS + 1) * emodel.cfg.refiner.render_iters
        lm_capture = (WARMUP_RUNS + 1) * lm_steps(emodel.cfg)
        look_capture = (WARMUP_RUNS + 1) * lookups(emodel.cfg)
        norm_capture = (WARMUP_RUNS + 1) * norms(emodel.cfg)
        reset_counts()
        engine_serve(1, 1)
        engine_serve(8, 1)
        eexpect = capture * len(classes)
        engine_launches, ok = counts(zbuffer_sweep_tiled_attrs_batched=eexpect,
                                     lm_step=lm_capture * len(classes),
                                     corr_lookup=look_capture * len(classes),
                                     instance_norm=norm_capture * len(classes))
        reset_counts()
        results = {}
        for B in (1, 8):
            torch.cuda.reset_peak_memory_stats(dev)
            results[B] = engine_serve(B, classes[B][2])
            results[B] += (torch.cuda.max_memory_allocated(dev),)
        replay_launches, replay_ok = counts(lm_step=0, corr_lookup=0, instance_norm=0)
        for B, (_, T, ms_req, ms_f, peak) in results.items():
            print(f"{tag} phase 9 engine serving (grid tile) B={B}: {ms_req:.3f} ms/request, "
                  f"{ms_f:.3f} ms/frame over {classes[B][2]} replayed requests; peak device "
                  f"memory {peak / 2**30:.3f} GiB", flush=True)
            _check_rigid(f"engine serving B={B}", T, B)
        print(f"{tag} phase 9 kernel launches in the first request of each class (warm-ups "
              f"and capture) {engine_launches} (expected zbuffer_sweep_tiled_attrs_batched "
              f"{eexpect}, lm_step {lm_capture * len(classes)}, corr_lookup "
              f"{look_capture * len(classes)}, others 0), in the replays {replay_launches} "
              "(expected none); "
              f"encode_3d calls {engine.encode_3d_calls} and graph captures "
              f"{engine.graph_captures} for {len(classes)} classes", flush=True)
        if (not ok or not replay_ok or engine.encode_3d_calls != len(classes)
                or engine.graph_captures != len(classes)):
            raise AssertionError("engine serving: wrong launches, encode_3d calls or captures")

        # One B=8 request again at tile 16, then at BIG_TILE: the same poses.
        # A program keeps the tile and the cuDNN mode of its capture: each
        # is captured anew.
        torch.backends.cudnn.deterministic = True
        req8 = results[8][0][0]
        engine.evict("ico_b8")
        T16 = engine.refine("ico_b8", req8)["Ti_pred"]
        raster_mod._TILE_PREF = str(BIG_TILE)
        engine.evict("ico_b8")
        reset_counts()
        T40 = engine.refine("ico_b8", req8)["Ti_pred"]
        tile40_launches, ok = counts(zbuffer_sweep_tiled_attrs_batched=capture,
                                     lm_step=lm_capture, corr_lookup=look_capture)
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

    # 26. The compiled serving engine against the eager forward.
    launches_per_replay = _graph_phase(tag, dev, towers, {1: scene1, 8: scene8},
                                       reset_counts, counts)

    # 11. Training at full width: the serving operating point with phase 9's
    # towers and the 256-row correspondence set.
    train_cfg = RNNPoseConfig(refiner=RefinerConfig(**REFINER), **towers)
    R = train_cfg.refiner.render_iters
    train_launches = 0
    trainers = {}
    for B, scene in ((1, scene1), (8, scene8)):
        model_t = init_random_(RNNPose(train_cfg), torch.Generator().manual_seed(9)).to(dev)
        trainer = Trainer(model_t, OptimizerConfig())
        # The key's WARMUP_RUNS eager steps and the step that captures its
        # graphs (and replays them): the launches from Python.
        torch.cuda.reset_peak_memory_stats(dev)
        reset_counts()
        t0 = time.perf_counter()
        for _ in range(WARMUP_RUNS + 1):
            trainer.run_step(scene)
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        warm_launches, ok = counts(zbuffer_sweep_rows_attrs=(WARMUP_RUNS + 1) * R, lm_step=0,
                                   corr_lookup=0)
        train_launches += warm_launches["zbuffer_sweep_rows_attrs"]
        print(f"{tag} phase 11 train B={B}: {WARMUP_RUNS} eager steps and the capturing step "
              f"{warm_s:.3f} s, kernel launches {warm_launches} (expected rows-attrs "
              f"{(WARMUP_RUNS + 1) * R}, others 0: training steps under autograd), graph "
              f"captures {trainer.graph_captures}; "
              f"peak device memory {torch.cuda.max_memory_allocated(dev) / 2**30:.3f} GiB",
              flush=True)
        if not ok or trainer.graph_captures != 1:
            raise AssertionError(f"train B={B}: wrong launches or captures in the warm-ups")
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
        step_launches, ok = counts(lm_step=0, corr_lookup=0)
        finite = all(bool(torch.isfinite(p).all()) for p in model_t.parameters())
        print(f"{tag} phase 11 train B={B}: kernel launches {step_launches} over "
              f"{N_TRAIN_STEPS} replayed steps (expected none); parameters finite: {finite}",
              flush=True)
        if not ok or not finite:
            raise AssertionError(f"train B={B}: wrong launches or non-finite parameters")
        trainers[B] = trainer
        # The eager step's breakdown (phase 27 profiles a replay beside one).
        _profile_train_step(make_train_step(model_t, trainer.state.optimizer), scene,
                            f"{tag} phase 11 eager profile B={B}")
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
        got, ok = counts(zbuffer_sweep_rows_attrs=0 if plain else R, lm_step=0, corr_lookup=0)
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
        # Loaded on the host: load_state_dict copies each tensor into the
        # one the trainer keeps (and its graphs read) on the card.
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

    # 27. The compiled training step against the eager one.
    launches_per_train_replay = _train_graph_phase(tag, dev, towers, {1: scene1, 8: scene8},
                                                   reset_counts, counts)

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

        # The phases whose times are the breakdown run alone: 16.
        # profile_components at full width, 21. the inner step's ablation,
        # 18a. a data-parallel step in two gloo processes sharing the card.
        _profile_phase(tag, dev, trace_root)
        _ablate_phase(tag)
        launches_dp = _dryrun_phase(tag, dev, train_cfg, _batch(scene8, 2), b1_step_ms)

        # 23. The learning check, in a process of its own beside the phases
        # that check correctness, or time two ways in turns: 15. serving export
        # at full width and cut depth (phase 4's weights, scenes and
        # features), 17. the demo, 19. the card's jax-free tests, 20.
        # numerics against the CPU, 25. the rounding forms, card against CPU
        # (phase 20's readings beside), 22. the traces.
        overfit, overfit_log = _overfit_start(keep)
        with _reaped({"overfit_check": overfit}, {"overfit_check": overfit_log}):
            export_launches, parity_export_launches = _export_phase(
                tag, dev, model, {1: (scene1, N_REQ_B1), 8: (scene8, N_REQ_B8)}, desc3d,
                ctx3d, reset_counts, counts, build, trace_root)
            _demo_phase(tag, dev, build)
            _card_tests_phase(tag)
            numerics_launches, numerics = _numerics_phase(tag, reset_counts, counts)
            tool_launches = {"numerics_check": numerics_launches}
            _rounding_phase(tag, dev, numerics)
            _trace_phase(tag, trace_root)
            tool_launches["overfit_check"] = _overfit_phase(tag, overfit, overfit_log)

        # 24. fps and the frontier, alone.
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
        launches_export["zbuffer_sweep_rows_attrs"] = export_launches["zbuffer_sweep_rows_attrs"]
        launches_export["zbuffer_sweep_tiled"] = parity_export_launches["zbuffer_sweep_tiled"]
        # ms (device time of one launch), plain_ms and the bound at B=8; the
        # one-mesh kernel at B=1. No single PyTorch call computes a z-buffer.
        case = {k: "b1" if k == "zbuffer_sweep_tiled_attrs" else "b8" for k in KERNELS}
        print(f"{tag} all phases: wall {time.perf_counter() - t_start:.2f} s (limit 1200 s)",
              flush=True)
        print(json.dumps({"kernels": [{
            "name": k, "route": "cuda", "source": src, "replaces": rep,
            "launches": launches[k], "launches_per_request": per_request[k],
            "launches_train_linemod": (linemod_train_launches
                                       if k == "zbuffer_sweep_rows_attrs" else 0),
            "launches_export": launches_export[k],
            "launches_dp": launches_dp if k == "zbuffer_sweep_rows_attrs" else 0,
            "launches_tools": {tool: got[k] for tool, got in tool_launches.items()},
            "launches_per_replay": launches_per_replay.get(k, 0),
            "launches_per_train_replay": (launches_per_train_replay
                                          if k == "zbuffer_sweep_rows_attrs" else 0),
            "max_abs_err": max_err[k], "ms": times[(k, case[k])][0],
            "plain_ms": times[(k, case[k])][1], "bytes": bounds[(k, case[k])][0],
            "bound_ms": bounds[(k, case[k])][1], "bound_by": bounds[(k, case[k])][2],
            "library_ms": None,
        } for k, (src, rep) in KERNELS.items()] + [{
            # The LM step kernel: it ports no TPU kernel; the serving requests
            # of phases 4 and 7, the artifacts of phase 15, phase 26's
            # profiled replays (device events) and phase 28's readings.
            "name": "lm_step", "route": "cuda", "source": f"{CSRC}/lm_step.cu",
            "replaces": None,
            "launches": serving_launches["lm_step"] + parity_launches["lm_step"],
            "launches_per_request": serving_launches["lm_step"] / (N_REQ_B1 + N_REQ_B8),
            "launches_per_parity_request": parity_launches["lm_step"] / (N_PAR_B1 + N_PAR_B8),
            "launches_export": export_launches["lm_step"] + parity_export_launches["lm_step"],
            "launches_tools": {tool: got["lm_step"] for tool, got in tool_launches.items()},
            "launches_per_replay": launches_per_replay["lm_step"],
            "launches_per_train_replay": 0,  # phases 11 and 27 count none in training
            "shapes": lm_rows,
            **{key: lm_rows["b8_240"][key] for key in ("max_abs_err", "plain_ms", "bytes")},
            "ms": lm_rows["b8_240"]["us"] / 1e3, "bound_ms": lm_rows["b8_240"]["bound_us"] / 1e3,
            "bound_by": "bytes", "library_ms": None,
        }, {
            # The correlation lookup kernel: it ports no TPU kernel; launches
            # as the LM step's are counted, and phase 29's readings (its ms,
            # bytes and bound those of RAFT's 55 x 128 grid).
            "name": "corr_lookup", "route": "cuda", "source": f"{CSRC}/corr_lookup.cu",
            "replaces": None,
            "launches": serving_launches["corr_lookup"] + parity_launches["corr_lookup"],
            "launches_per_request": serving_launches["corr_lookup"] / (N_REQ_B1 + N_REQ_B8),
            "launches_per_parity_request": (parity_launches["corr_lookup"]
                                            / (N_PAR_B1 + N_PAR_B8)),
            "launches_export": (export_launches["corr_lookup"]
                                + parity_export_launches["corr_lookup"]),
            "launches_tools": {tool: got["corr_lookup"] for tool, got in tool_launches.items()},
            "launches_per_replay": launches_per_replay["corr_lookup"],
            "launches_per_train_replay": 0,  # phases 11 and 27 count none in training
            "shapes": lookup_rows,
            **{key: lookup_rows["b1_55x128"][key] for key in ("max_abs_err", "plain_ms",
                                                               "bytes")},
            "ms": lookup_rows["b1_55x128"]["us"] / 1e3,
            "bound_ms": lookup_rows["b1_55x128"]["bound_us"] / 1e3,
            "bound_by": "bytes", "library_ms": None,
        }, {
            # The instance norm kernel: it ports no TPU kernel; launches as
            # the LM step's are counted, and phase 30's readings (its ms,
            # bytes and bound those of RAFT's stem, each path's in `shapes`).
            "name": "instance_norm", "route": "cuda", "source": f"{CSRC}/instance_norm.cu",
            "replaces": None,
            "launches": serving_launches["instance_norm"] + parity_launches["instance_norm"],
            "launches_per_request": serving_launches["instance_norm"] / (N_REQ_B1 + N_REQ_B8),
            "launches_per_parity_request": (parity_launches["instance_norm"]
                                            / (N_PAR_B1 + N_PAR_B8)),
            "launches_export": (export_launches["instance_norm"]
                                + parity_export_launches["instance_norm"]),
            "launches_tools": {tool: got["instance_norm"] for tool, got in tool_launches.items()},
            "launches_per_replay": launches_per_replay["instance_norm"],
            "launches_per_train_replay": 0,  # phases 11 and 27 count none in training
            "shapes": norm_rows,
            **{key: norm_rows["raft_220x512"][key] for key in ("max_abs_err", "plain_ms",
                                                                "bytes")},
            "ms": norm_rows["raft_220x512"]["us"] / 1e3,
            "bound_ms": norm_rows["raft_220x512"]["bound_us"] / 1e3,
            "bound_by": "bytes", "library_ms": None,
        }, {
            # RAFT-Stereo's 1D lookup kernel: it ports no TPU kernel; its
            # launches on phases 4 and 7's RNNPose paths (0, which their
            # counts hold), phase 31's readings (its ms, bytes and bound those
            # of Middlebury's 504 x 720 grid) and its stereo capture's launches.
            "name": "corr_lookup_1d", "route": "cuda", "source": f"{CSRC}/corr_lookup.cu",
            "replaces": None,
            "launches_per_request": serving_launches["corr_lookup_1d"] / (N_REQ_B1 + N_REQ_B8),
            "launches_per_parity_request": (parity_launches["corr_lookup_1d"]
                                            / (N_PAR_B1 + N_PAR_B8)),
            "launches_per_stereo_capture": stereo_rows["engine"]["launches"]["corr_lookup_1d"],
            "shapes": stereo_rows,
            **{key: stereo_rows["b1_504x720"][key] for key in ("max_abs_err", "plain_ms",
                                                                "bytes")},
            "ms": stereo_rows["b1_504x720"]["us"] / 1e3,
            "bound_ms": stereo_rows["b1_504x720"]["bound_us"] / 1e3,
            "bound_by": "bytes", "library_ms": None,
        }]}), flush=True)
        print(smi, flush=True)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}),
            flush=True)
        return 0


if __name__ == "__main__":
    sys.exit(_overfit_child() if sys.argv[1:] == [OVERFIT_CHILD] else main())
