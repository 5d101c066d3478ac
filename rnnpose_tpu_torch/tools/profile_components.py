"""Component timing: where does a refinement request spend its time? (port
of `rnnpose_tpu/tools/profile_components.py`)

Usage: python -m rnnpose_tpu_torch.tools.profile_components [--device cuda|cpu]
           [--batch 1] [--iters 10] [--trace DIR]

Times, at the shipping operating point (320^2 image, 2048/4096 mesh, 240^2
crop, 4-layer 128-wide KPConv towers, 3 x 4 iterations, the default
precision; the size flags shrink it), with seeded random weights: the
rasterizer (`rasterize`, the culled z/fid kernel on the card), `splat_depth`,
the image encoder on both crops, the correlation pyramid build, one
correlation lookup, one LM step, the full cached eval forward, `encode_3d`
and one training step (`Trainer`'s replayed graphs on the card). After
two warm-up calls (for the training step, its trainer's WARMUP_RUNS eager
steps and the step that captures), per component:

* `host_ms`: the median wall time of one call, synchronised (host clock);
* `events_ms` (card only): CUDA events around `--iters` back-to-back calls,
  per call: the time the stream takes when calls follow each other;
* `device_ms` (card only): the device's own time per call, the sum of the
  device operations' times under `torch.profiler`
  (`utils/profiling.device_busy`, also `chip_smoke.py`'s training profile)
  over as many calls as fill 10 ms of host time; None ("not captured")
  where the profiler recorded no device time in that window. Where
  `device_ms` is far below `host_ms`, the host's launches bound the call.

On the CPU (`--device cpu`, as the tests run it) only `host_ms` is
measured; the device entries are None ("not measured"). `--trace DIR`
writes Chrome traces of the eval forward and the training step
(`utils/profiling.trace`) under `DIR/eval` and `DIR/train`. The last stdout
line is the JSON summary.

`timeit` keeps the JAX tool's chained protocol for a single callable
(perturbed inputs, each call depending on the last, a host read inside the
window); the components above are timed by `time_component`. The JAX
tool's `--remat` and `--train_cost` options are XLA's and are not ported.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time

from .train import positive_int

PROFILE_WINDOW_MS = 10.0


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="rnnpose_tpu_torch component timing")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device (default: cuda; pass cpu to run on the host)")
    p.add_argument("--trace", type=str, default=None)
    p.add_argument("--iters", type=positive_int, default=10)
    p.add_argument("--batch", type=positive_int, default=1)
    p.add_argument("--image_size", type=positive_int, default=320)
    p.add_argument("--verts", type=positive_int, default=2048)
    p.add_argument("--faces", type=positive_int, default=4096)
    p.add_argument("--zoom", type=positive_int, default=240)
    p.add_argument("--kp_layers", type=positive_int, default=4)
    p.add_argument("--tower_width", type=positive_int, default=128)
    p.add_argument("--render_iters", type=positive_int, default=3)
    p.add_argument("--gru_iters", type=positive_int, default=4)
    p.add_argument("--corr_levels", type=positive_int, default=4)
    return p.parse_args(argv)


def _device_busy_ms(fn, calls: int):
    """The device's busy time (`utils/profiling.device_busy`) over `calls`
    calls of `fn` under torch.profiler, per call; None where the profiler
    recorded no device time in the window."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from ..utils.profiling import device_busy

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    busy, _ = device_busy(prof)
    return busy / calls if busy > 0 else None


def _float_leaves(o):
    import torch

    if isinstance(o, torch.Tensor):
        return [o] if o.is_floating_point() else []
    if isinstance(o, dict):
        o = list(o.values())
    if isinstance(o, (list, tuple)):
        return [x for v in o for x in _float_leaves(v)]
    return []


def _perturbed(o, eps):
    import torch

    if isinstance(o, torch.Tensor):
        return o + eps.to(o.dtype) if o.dtype in (torch.float32, torch.bfloat16) else o
    if isinstance(o, dict):
        return {k: _perturbed(v, eps) for k, v in o.items()}
    if isinstance(o, tuple) and hasattr(o, "_fields"):
        return type(o)(*(_perturbed(v, eps) for v in o))
    if isinstance(o, (list, tuple)):
        return type(o)(_perturbed(v, eps) for v in o)
    return o


def timeit(fn, *args, iters=10, name="", vary=0):
    """ms per call of `fn(*args)` by the JAX tool's chained protocol: each
    call perturbs the f32/bf16 tensors of `args[vary]` by a fresh epsilon
    (entropy-seeded) plus 1e-30 times the previous call's output scalar (the
    sum of the means of every float tensor it returns, so no output is
    dead), and the window closes on a host read of the last scalar. Prints
    a line; raises on a non-finite output."""
    import numpy as np
    import torch

    n_pert = sum(x.dtype in (torch.float32, torch.bfloat16) for x in _float_leaves(args[vary]))
    assert n_pert > 0, f"{name}: no float32/bf16 tensors in args[{vary}] to perturb"
    dev = _float_leaves(args[vary])[0].device

    def step(chain, eps0):
        a = list(args)
        a[vary] = _perturbed(a[vary], eps0 + 1e-30 * chain)
        leaves = _float_leaves(fn(*a))
        assert leaves, f"{name}: fn output has no float tensors to reduce"
        total = sum(x.float().mean() for x in leaves)
        finite = torch.stack([torch.isfinite(x).all() for x in leaves]).all()
        return total, finite

    rs = np.random.RandomState(int.from_bytes(os.urandom(4), "little"))
    eps_seq = [torch.tensor(rs.uniform(0.5, 1.5) * 1e-7, dtype=torch.float32, device=dev)
               for _ in range(iters)]
    chain = torch.zeros((), device=dev)
    c0, _ = step(chain, torch.tensor(1e-7, device=dev))
    float(c0)  # warm-up, synchronised by the host read
    finite = None
    t0 = time.perf_counter()
    for i in range(iters):
        chain, finite = step(chain, eps_seq[i])
    final = float(chain)  # the host read, inside the window
    dt = (time.perf_counter() - t0) / iters * 1000
    assert bool(finite) and math.isfinite(final), f"{name}: non-finite output"
    print(f"{name:34s} {dt:8.3f} ms", flush=True)
    return dt


def time_component(name, fn, device, iters, warmup=2):
    """The timings of one component (see the module docstring); prints a
    line and returns them."""
    import torch

    on_card = device.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    for _ in range(warmup):
        fn()
    sync()
    host = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        sync()
        host.append((time.perf_counter() - t0) * 1e3)
    out = {"host_ms": sorted(host)[len(host) // 2], "events_ms": None, "device_ms": None}
    if on_card:
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        stop.record()
        torch.cuda.synchronize()
        out["events_ms"] = start.elapsed_time(stop) / iters
        # Enough calls to fill PROFILE_WINDOW_MS: a window of a fraction of a
        # millisecond can come back with no device time.
        calls = max(1, math.ceil(PROFILE_WINDOW_MS / out["host_ms"]))
        out["device_ms"] = _device_busy_ms(fn, calls)
    line = f"{name:34s} host {out['host_ms']:9.3f} ms"
    if on_card:
        device = out["device_ms"]
        line += f"  events {out['events_ms']:9.3f} ms  device " + (
            "not captured" if device is None else f"{device:9.3f} ms")
    print(line, flush=True)
    return out


def main(argv=None):
    args = parse_args(argv)
    import torch

    from ..data.synthetic import SyntheticConfig, kpconv_config, make_synthetic_inputs
    from ..geometry import lm as lm_lib
    from ..models.cfnet import ImageFeaEncoder
    from ..models.refiner import RefinerConfig
    from ..models.rnnpose import RNNPose, RNNPoseConfig, init_random_
    from ..ops import corr as corr_ops
    from ..render.raster import rasterize
    from ..render.splat import splat_depth
    from ..train.loop import WARMUP_RUNS, Trainer
    from ..train.optim import OptimizerConfig
    from ..utils.profiling import trace

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device}: no CUDA device is visible; pass "
                           "--device cpu to run on the host")
    syn = SyntheticConfig(
        image_size=args.image_size, num_verts=args.verts, num_faces=args.faces,
        subdivisions=4 if args.verts >= 1024 else 3, kp_layers=args.kp_layers,
        kp_dl=0.006, batch_size=args.batch,
    )
    inputs = make_synthetic_inputs(syn, device=device, with_corr=True)
    kp = kpconv_config(syn)
    width = dict(first_feats_dim=args.tower_width, gnn_feats_dim=args.tower_width)
    cfg = RNNPoseConfig(
        desc_kp=dataclasses.replace(kp, final_feats_dim=32, **width),
        ctx_kp=dataclasses.replace(kp, final_feats_dim=256, normalize_output=False, **width),
        refiner=RefinerConfig(zoom_crop_size=args.zoom, render_iters=args.render_iters,
                              gru_iters=args.gru_iters, corr_levels=args.corr_levels),
    )
    model = init_random_(RNNPose(cfg), torch.Generator().manual_seed(0)).to(device)

    S, B, img = args.zoom, args.batch, args.image_size
    mesh = inputs.mesh
    K = inputs.intrinsics
    verts_cam = (mesh.verts[None] + torch.tensor([0.0, 0.0, 0.6], device=device)).expand(
        B, -1, -1)
    enc = ImageFeaEncoder().to(device)
    crops = torch.zeros((B, S, S, 3), device=device)
    f8 = S // 8
    fmap = torch.zeros((B, f8, f8, 256), device=device)
    pyr = corr_ops.build_corr_pyramid(fmap, fmap, args.corr_levels)
    coords = torch.zeros((B, f8, f8, 2), device=device)
    depth = torch.full((B, S, S), 0.6, device=device)
    target = torch.zeros((B, S, S, 2), device=device)
    weight = torch.ones((B, S, S, 2), device=device)
    T_eye = torch.eye(4, device=device).expand(B, 4, 4).contiguous()
    desc3d, ctx3d = model.encode_3d(inputs.pyramid)
    eval_inputs = inputs._replace(corr=None)
    trainer = Trainer(model, OptimizerConfig(total_steps=1000))

    def forward():
        return model(eval_inputs, cached_desc3d=desc3d, cached_ctx3d=ctx3d)["Ti_pred"]

    eval_components = [
        (f"rasterize {args.faces}f @ {S}^2",
         lambda: rasterize(verts_cam, mesh.faces, K, S, S, mesh.face_valid, 128).zbuf),
        (f"splat_depth {args.verts}v @ {img}^2", lambda: splat_depth(verts_cam, K, img, img)),
        (f"image encoder x2 @ {S}^2", lambda: enc(crops, crops)),
        (f"corr pyramid build @ {f8}^2",
         lambda: corr_ops.build_corr_pyramid(fmap, fmap, args.corr_levels).levels[0]),
        ("corr lookup r=4", lambda: corr_ops.corr_lookup(pyr, coords, 4)),
        (f"LM step @ {S}^2",
         lambda: lm_lib.reprojection_optim(T_eye, target, weight, depth, K, 1)),
        ("eval forward (cached 3D)", forward),
        ("encode_3d (KPConv x2)", lambda: model.encode_3d(inputs.pyramid)),
    ]
    components = {}
    print(f"profile_components on {device} (B={B}, {img}^2 image, {S}^2 crop, "
          f"{args.verts}/{args.faces} mesh, {args.render_iters} x {args.gru_iters} iterations)",
          flush=True)
    with torch.no_grad():
        for name, fn in eval_components:
            components[name] = time_component(name, fn, device, args.iters)
    # The trainer's warm-up steps and the step that captures its graphs come
    # before the clock: the timed steps replay them (on the CPU, run eagerly).
    components["train step (fwd+bwd+opt)"] = time_component(
        "train step (fwd+bwd+opt)", lambda: trainer.run_step(inputs), device,
        max(args.iters // 2, 2), warmup=WARMUP_RUNS + 1)

    if args.trace:
        with trace(os.path.join(args.trace, "eval")):
            forward()
        with trace(os.path.join(args.trace, "train")):
            trainer.run_step(inputs)
        print(f"traces written to {args.trace}/{{eval,train}}/trace.json")
    summary = {"device": device.type, "batch": B, "components": components}
    print(json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    main()
