"""The plain reference of the benchmark: a frozen copy of the eager modules
of `rnnpose_tpu_torch` (models, geometry, ops, render, the training losses,
optimizer and step, the scene's mesh, pose and pyramid builders), taken at
the commit that added the benchmark, so that a later change to the
program cannot move what judges it. It imports nothing of the program.

Departures from the copied modules:
* the raster runs only its plain sweeps (`ops/raster_plain.py`, the CUDA
  kernels' own reference); no kernel, no environment switch;
* nothing sets the TF32 flags (`geometry/precise.pmatmul`, `RNNPose`'s
  `_exact_f32`): the harness sets them, off for the reference and on for
  the control of a float32 configuration (`benchmark/check.exact_f32`);
* `models/raft.Conv.fp8` rounds a convolution's input and weight to float8,
  for the control of a bf16 configuration;
* the optimizer trains every parameter (no freeze patterns) and the step
  (`train/step.py`) has no process group or profiler ranges;
* the KPConv pyramid is built by its numpy version only.
Everything is computed in float32 by the harness's configuration
(`benchmark/build.model_config(..., f32=True)`)."""
